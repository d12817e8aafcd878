"""The port's multi-device build engines against the JAX package's (the
cases of tests/test_parallel.py): ``sharded_kmeans`` from the JAX
package's init equals its ``sharded_kmeans`` on the 8-device CPU mesh,
``kmeans_nodes`` labels are bit-equal with and without a device list,
and the trainer over a device list (expert parallel, and data parallel
for the root) equals the single-device trainer.  The port's device list
is ``["cpu"] * 4`` here."""

import importlib

import jax
import numpy as np
import pytest
import torch

from learnedmetricindex_tpu.data import synthetic_blobs
from learnedmetricindex_tpu.ops.kmeans import kmeans as jax_kmeans
from learnedmetricindex_tpu.ops.quantize import quantize_rows as jax_quantize_rows
from learnedmetricindex_tpu.parallel.distributed import sharded_kmeans as jax_sharded_kmeans
from learnedmetricindex_tpu.parallel.mesh import create_mesh as jax_create_mesh
from learnedmetricindex_tpu_torch.models.train import StackedNodeTrainer, group_rows
from learnedmetricindex_tpu_torch.parallel import sharded_kmeans
from learnedmetricindex_tpu_torch.parallel.distributed import lloyd_blocks, split_rows

# ops/__init__ exports the function kmeans over the module's name
pk = importlib.import_module("learnedmetricindex_tpu_torch.ops.kmeans")

torch.set_num_threads(2)
pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")

CPUS = [torch.device("cpu")] * 4


def _jax_init(seed, k, n):
    """The JAX package's sharded init (distributed.py :88-89)."""
    draw = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (k,), 0, n))
    return (draw + np.arange(k)) % n


def _near_ties_only(x, centroids, la, lb, tol=1e-5):
    """Labels may differ only where the row's two nearest centroids lie
    within ``tol`` of each other."""
    diff = np.nonzero(la != lb)[0]
    if len(diff):
        c2 = (centroids * centroids).sum(1)
        d = c2[None, :] - 2.0 * x[diff] @ centroids.T
        np.testing.assert_allclose(d[np.arange(len(diff)), la[diff]],
                                   d[np.arange(len(diff)), lb[diff]], atol=tol)


@pytest.mark.parametrize("int8", [False, True])
def test_lloyd_from_the_jax_init_equals_jax_sharded_kmeans(int8):
    """Given the JAX package's init rows, the port's Lloyd's over four row
    blocks equals ``sharded_kmeans`` on the JAX package's 8-device mesh:
    centroids to 1e-4, labels except at near ties; int8 rows are read
    through their row scales in both."""
    data, _ = synthetic_blobs(4000, 16, 1, n_clusters=8, seed=0)
    k, seed = 8, 2023
    scales = None
    if int8:
        q, scales = (np.array(a) for a in jax_quantize_rows(data))
        data, x = q, q.astype(np.float32) * scales[:, None]
    else:
        x = data
    jc, jl = jax_sharded_kmeans(data, k, jax_create_mesh(8), seed=seed, row_scales=scales)
    blocks = split_rows(data, CPUS, scales)
    assert blocks.blocks[0].dtype == (torch.int8 if int8 else torch.float32)
    pc, pl = lloyd_blocks(blocks, _jax_init(seed, k, len(data)), n_iters=25)
    pl = torch.cat(pl).numpy()
    np.testing.assert_allclose(pc.numpy(), jc, atol=1e-4)
    _near_ties_only(x, pc.numpy(), pl, np.asarray(jl))


def test_sharded_kmeans_matches_quality():
    """tests/test_parallel.py's bar: every cluster used, inertia within
    1.2× the single-device k-means on all rows."""
    data, _ = synthetic_blobs(4000, 16, 1, n_clusters=8, seed=0)
    centroids, labels = sharded_kmeans(data, 8, CPUS)
    assert centroids.shape == (8, 16) and labels.shape == (4000,) and labels.dtype == np.int32
    assert len(np.unique(labels)) == 8
    _, labels_single = pk.kmeans(data, 8, max_points_per_centroid=0)
    _, labels_jax = jax_kmeans(data, 8, max_points_per_centroid=0)

    def inertia(lbl):
        c = np.stack([data[lbl == i].mean(0) for i in range(8)])
        return np.sum((data - c[lbl]) ** 2)

    assert inertia(labels) <= inertia(labels_single) * 1.2
    assert inertia(labels) <= inertia(np.asarray(labels_jax)) * 1.2


def test_sharded_kmeans_takes_blocks_where_they_lie():
    """A list of per-device row blocks (int8 with their scales) clusters
    as the whole array does, and fewer rows than clusters keeps k = n."""
    data, _ = synthetic_blobs(3000, 12, 1, n_clusters=6, seed=4)
    q, scales = (np.array(a) for a in jax_quantize_rows(data))
    whole = sharded_kmeans(q, 6, CPUS, seed=9, row_scales=scales)
    rows = split_rows(q, CPUS, scales)
    listed = sharded_kmeans(list(rows.blocks), 6, CPUS, seed=9, row_scales=list(rows.scales))
    np.testing.assert_array_equal(whole[0], listed[0])
    np.testing.assert_array_equal(whole[1], listed[1])
    c, lab = sharded_kmeans(data[:5], 8, CPUS)
    assert c.shape == (5, 12) and lab.shape == (5,)


@pytest.mark.parametrize("int8", [False, True])
def test_kmeans_nodes_labels_bit_equal_with_and_without_devices(int8):
    """The node blocks over ``["cpu"] * 4`` (rows read from four row
    blocks) give the same labels, bit for bit, as one device."""
    data, _ = synthetic_blobs(6000, 16, 4, n_clusters=24, seed=8)
    parent = np.random.default_rng(8).integers(0, 12, 6000)
    nodes = np.array([0, 1, 2, 3, 5, 6, 7, 8, 9, 10, 11])  # node 4's rows are not clustered
    seeds = 100 + nodes
    scales = None
    if int8:
        data, scales = (np.array(a) for a in jax_quantize_rows(data))
    one = pk.kmeans_nodes(data, parent, nodes, 5, seeds=seeds, tile=256, row_scales=scales)
    many = pk.kmeans_nodes(data, parent, nodes, 5, seeds=seeds, tile=256, row_scales=scales,
                           devices=CPUS)
    blocks = pk.kmeans_nodes(split_rows(data, CPUS, scales), parent, nodes, 5, seeds=seeds,
                             tile=256, devices=CPUS)
    np.testing.assert_array_equal(one, many)
    np.testing.assert_array_equal(one, blocks)
    assert (one[parent == 4] == -1).all() and (one[parent != 4] >= 0).all()


def _trainer_problem(n_models, seed=0):
    """tests/test_parallel.py's problem: well-separated per-(model, class)
    blobs, 4096×12, 3 classes."""
    rng = np.random.default_rng(seed)
    C, d, n = 3, 12, 4096
    group_ids = rng.integers(0, n_models, size=n)
    centers = rng.normal(size=(n_models, C, d)).astype(np.float32) * 4
    labels = rng.integers(0, C, size=n)
    data = centers[group_ids, labels] + 0.1 * rng.normal(size=(n, d)).astype(np.float32)
    return data, group_ids, labels, C, d, n


def test_expert_parallel_trainer_equals_one_device():
    """4 models over ``["cpu"] * 4``, one a device (test_parallel.py:53-97):
    after ``fit`` the parameters equal the single-device trainer's to
    1e-6, the predictions are identical, every model covers its classes
    and the models separate the blobs."""
    data, group_ids, labels, C, d, n = _trainer_problem(4)
    grouped = group_rows(data, group_ids, 4, labels=labels, tile=512, device="cpu")
    runs = []
    for devices in (None, CPUS):
        trainer = StackedNodeTrainer(4, d, C, model_type="MLP-8", lr=0.05, batch_size=128,
                                     seed=0, device="cpu", devices=devices)
        preds_slots, rounds = trainer.fit(grouped, epochs=3)
        runs.append((trainer, grouped.scatter_to_rows(preds_slots.astype(np.int64), n, fill=-1),
                     rounds))
    (one, p_one, r_one), (many, p_many, r_many) = runs
    assert many.parts is not None and [p.hi - p.lo for p in many.parts] == [1, 1, 1, 1]
    assert r_one == r_many >= 1
    for a, b in zip(one.full_params(), many.full_params()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6)
    np.testing.assert_array_equal(p_many, p_one)
    for m in range(4):
        assert set(p_many[group_ids == m]) == set(range(C))
    assert (p_many == labels).mean() > 0.9
    valid = grouped.slot_rows_np >= 0  # pad slots read another row in each layout
    np.testing.assert_array_equal(many.predict_slots(grouped)[valid],
                                  one.predict_slots(grouped)[valid])


@pytest.mark.parametrize("weighted,rule", [(False, "minibatch"), (True, "minibatch"),
                                           (False, "reference")])
def test_data_parallel_root_equals_one_device(weighted, rule):
    """One model (the root) over ``["cpu"] * 4``: the batch split by the
    row block that holds each row, the gradients added on the first
    device.  After 20 steps the parameters are within 1e-5 of the
    single-device trainer's (the same draws, other sums); after ``fit``
    at least 99% of the predictions are equal."""
    data, _, labels, C, d, n = _trainer_problem(1, seed=3)
    groups = np.zeros(n, np.int64)
    grouped = group_rows(data, groups, 1, labels=labels, tile=512, device="cpu")
    weight = np.array([[0.5, 1.0, 2.0]], np.float32) if weighted else None

    def trainer(devices):
        t = StackedNodeTrainer(1, d, C, model_type="MLP-8", lr=0.05, batch_size=128, seed=0,
                               update_rule=rule, device="cpu", devices=devices)
        t.set_class_weight(weight)
        return t

    one, many = trainer(None), trainer(CPUS)
    assert many.parts is None and many.devices == CPUS
    one.run(grouped, 20, np.ones(1, bool))
    many.run(grouped, 20, np.ones(1, bool))
    for a, b in zip(one.full_params(), many.full_params()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5)
    one, many = trainer(None), trainer(CPUS)
    p_one, _ = one.fit(grouped, epochs=2)
    p_many, _ = many.fit(grouped, epochs=2)
    valid = grouped.slot_rows_np >= 0
    assert (p_one[valid] == p_many[valid]).mean() >= 0.99


def test_trainer_device_arguments():
    """``devices[0]`` must be ``device``; a one-entry list is one device;
    3 models over 2 devices train data parallel."""
    with pytest.raises(ValueError, match="devices"):
        StackedNodeTrainer(2, 4, 2, device="meta", devices=["cpu", "cpu"])
    with pytest.raises(TypeError, match="device"):
        StackedNodeTrainer(2, 4, 2)
    assert StackedNodeTrainer(2, 4, 2, devices=["cpu"]).devices is None
    t = StackedNodeTrainer(3, 4, 2, devices=["cpu", "cpu"])
    assert t.parts is None and t.device == torch.device("cpu")
