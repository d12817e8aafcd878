"""The multi-process runtime over gloo on the CPU (the cases of
tests/test_multiprocess.py): ranks launched as processes of this file,
each with its own row block, give the device-list path's k-means, index,
sub-stores and search results bit for bit, and the JAX package's mesh
search of the same index meets the parity bar.

Each rank is ``python tests/test_torch_multiprocess.py <case> <rank>
<world> <dir> [<categories>]``: it joins the process group through a
file rendezvous in ``<dir>`` (no port to race for), runs one thread and
imports no jax.  Every launch has a time limit and kills what is left.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANK_TIMEOUT = 120  # seconds a launch may take


def _launch(tmp_path, case, world, *extra, env=None):
    """Run ``world`` ranks of ``case``; every rank must exit 0 and print OK."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", **(env or {})}
    procs = [
        subprocess.Popen([sys.executable, __file__, case, str(rank), str(world), str(tmp_path),
                          *extra], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for rank in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        print(out)
        assert p.returncode == 0, out[-3000:]
        assert out.strip().endswith("OK"), out[-3000:]
    return outs


def test_two_ranks_collectives_and_sharded_kmeans(tmp_path):
    """Per-rank rows add up across the ranks, four separated blobs map to
    four clusters, and the centroids and labels are the device list's
    ``sharded_kmeans`` bits; unequal row counts and ``kmeans_nodes`` over
    the world raise."""
    _launch(tmp_path, "collectives", 2)


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    """Launch the full flow once a (world, categories): its directory."""
    done = {}

    def run(world, cats):
        if (world, cats) not in done:
            where = tmp_path_factory.mktemp(f"flow{world}")
            # deeper levels across ranks take the serial per-node path
            env = {"LMI_BATCHED_NODE_KMEANS": "0"} if "," in cats else None
            _launch(where, "flow", world, cats, env=env)
            done[(world, cats)] = where
        return done[(world, cats)]

    return run


@pytest.mark.parametrize("world,cats", [(2, "6"), (2, "3,2"), (4, "6")])
def test_full_build_shard_search(flow, world, cats):
    """build → routed sharded store → search across ``world`` ranks equals
    the device-list path over ``["cpu"] * world``: routers, class masks and
    data_prediction, each rank's sub-store, the search results (the same
    on every rank), the bytes summed over the ranks; full-visit recall is
    1.0."""
    flow(world, cats)


def test_jax_mesh_search_of_the_multi_process_index(flow):
    """The two-rank index, saved as .npz, searched by the JAX package over
    its 8-device CPU mesh with the same data_prediction: the port's
    multi-process results meet the parity bar and recall is equal."""
    import jax

    from learnedmetricindex_tpu.data import synthetic_blobs as jax_blobs
    from learnedmetricindex_tpu.index.serialization import load_index as jax_load_index
    from learnedmetricindex_tpu.ops.knn import exact_knn as jax_exact_knn
    from learnedmetricindex_tpu.ops.knn import recall as jax_recall
    from learnedmetricindex_tpu.parallel import mesh as jmesh

    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    where = flow(2, "6")
    data, queries = jax_blobs(1024, 16, 32, n_clusters=8, seed=7)
    jidx, pred = jax_load_index(str(where / "index.npz"))
    got = np.load(where / "results.npz")
    np.testing.assert_array_equal(pred, got["pred"])
    jstore = jidx.get_sharded_store(data, pred, jmesh.create_mesh(8))
    jd, ji, _ = jidx.search(None, queries, data, queries, pred, n_buckets=int(got["nb"]), k=10,
                            store=jstore, precision="highest")
    jd, ji = np.asarray(jd), np.asarray(ji)
    pd, pi = got["dists"], got["ids"]
    np.testing.assert_allclose(pd, jd, rtol=1e-4, atol=1e-5)
    mism = pi != ji
    if mism.any():  # ids differ only at exact ties
        np.testing.assert_allclose(pd[mism], jd[mism], rtol=1e-6, atol=1e-7)
    _, gt = jax_exact_knn(data, queries, k=10)
    assert jax_recall(pi, gt, 10) == jax_recall(ji, gt, 10) == 1.0


def test_torchrun_variables_and_idempotent_initialize(tmp_path):
    """``initialize`` reads torchrun's MASTER_ADDR, MASTER_PORT, RANK and
    WORLD_SIZE, returns when the group exists, and raises for CUDA on a
    machine without it (nothing falls back to gloo)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    _launch(tmp_path, "torchrun", 1, env={"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                                          "RANK": "0", "WORLD_SIZE": "1"})


def test_a_bare_cuda_device_takes_the_local_rank(monkeypatch):
    """Under torchrun (``LOCAL_RANK`` set) a bare ``"cuda"`` is that card,
    so the ranks of one host do not all land on card 0; an explicit
    index and the CPU stay as given."""
    import torch

    from learnedmetricindex_tpu_torch.parallel import multiprocess as mp

    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mp.rank_device("cuda") == torch.device("cuda", 3)
    assert mp.rank_device("cuda:1") == torch.device("cuda", 1)
    assert mp.rank_device("cpu") == torch.device("cpu")


def test_sharded_dynamic_index_refuses_a_multi_process_store(monkeypatch):
    """tests/test_sharded_mutation.py::test_multiprocess_mesh_rejected:
    with ``is_multiprocess`` true the sharded mutation layer refuses."""
    import torch

    import learnedmetricindex_tpu_torch as lmi
    from learnedmetricindex_tpu_torch.data import synthetic_blobs
    from learnedmetricindex_tpu_torch.parallel import ShardedDynamicIndex
    from learnedmetricindex_tpu_torch.parallel import multiprocess as mp

    torch.set_num_threads(2)
    data, _ = synthetic_blobs(600, 8, 4, n_clusters=4, seed=5)
    cfg = lmi.BuildConfiguration("kmeans", 2, "MLP-8", 0.05, [4], chunk_size=32)
    index, pred, _, _, _ = lmi.LearnedIndexBuilder(data, cfg, device="cpu").build()
    dyn = ShardedDynamicIndex.from_built(index, data, pred, ["cpu"] * 2, chunk=32)
    monkeypatch.setattr(mp, "is_multiprocess", lambda devices: True)
    with pytest.raises(ValueError, match="single-controller"):
        ShardedDynamicIndex(index, dyn.sharded)


# ----------------------------------------------------------------------
# the ranks
# ----------------------------------------------------------------------


def _join(rank, world, where):
    from learnedmetricindex_tpu_torch.parallel import multiprocess as mp

    mp.initialize(f"file://{where}/rdv", world, rank, device="cpu")
    return mp, mp.global_mesh()


def _collectives(rank, world_size, where):
    import torch

    from learnedmetricindex_tpu_torch.ops.kmeans import kmeans_nodes
    from learnedmetricindex_tpu_torch.parallel.distributed import sharded_kmeans

    mp, world = _join(rank, world_size, where)
    assert mp.is_multiprocess(world) and len(world) == 2 and world.rank == rank
    local = np.full((8, 4), float(rank + 1), np.float32)
    glob = mp.from_process_local(local, world)
    assert glob.shape == (16, 4)
    assert float(mp.to_host_replicated(glob.block, world).sum()) == 96.0

    def blobs(r):
        rng = np.random.default_rng(41)
        centers = rng.normal(size=(4, 4)).astype(np.float32) * 10.0
        return np.concatenate([centers[r * 2 + g] + 0.05 * rng.normal(size=(16, 4))
                               for g in range(2)]).astype(np.float32)

    gpts = mp.from_process_local(blobs(rank), world)
    cents, labels = sharded_kmeans(gpts, 4, world, n_iters=10, seed=3)
    assert labels.shape == (64,) and len(set(labels.tolist())) == 4, labels
    for b in range(4):  # the blobs are well separated: one cluster a blob
        assert len(set(labels[b * 16:(b + 1) * 16].tolist())) == 1, (b, labels)
    full = np.concatenate([blobs(r) for r in range(2)])
    ref_c, ref_l = sharded_kmeans(full, 4, ["cpu"] * 2, n_iters=10, seed=3)
    np.testing.assert_array_equal(cents, ref_c)
    np.testing.assert_array_equal(labels, ref_l)

    # an int8 corpus: the routed fill carries each row's scale with it
    from learnedmetricindex_tpu_torch.ops.quantize import quantize_rows
    from learnedmetricindex_tpu_torch.parallel import shard_store

    q, sc = (t.numpy() for t in quantize_rows(torch.as_tensor(full)))
    bucket_ids = np.random.default_rng(9).integers(0, 5, size=64)
    routed = shard_store(mp.from_process_local(q[rank * 32:(rank + 1) * 32], world,
                                               row_scales=sc[rank * 32:(rank + 1) * 32]),
                         bucket_ids, 5, world, chunk=8)
    single = shard_store(q, bucket_ids, 5, ["cpu"] * 2, chunk=8, row_scales=sc)
    for name in ("chunk_data", "chunk_ids", "chunk_scales"):
        assert torch.equal(getattr(routed.shards[0], name), getattr(single.shards[rank], name))
    assert routed.shards[0].chunk_data.dtype == torch.int8
    # exchanges of bounded bytes: one chunk of slots a shard at a time
    from learnedmetricindex_tpu_torch.parallel import sharded_index

    calls = []
    exchange = mp.all_to_all
    mp.all_to_all = lambda *a: calls.append(len(a[0])) or exchange(*a)
    sharded_index.ROUTED_BLOCK_BYTES = 8
    try:
        bounded = shard_store(mp.from_process_local(q[rank * 32:(rank + 1) * 32], world,
                                                    row_scales=sc[rank * 32:(rank + 1) * 32]),
                              bucket_ids, 5, world, chunk=8)
    finally:
        mp.all_to_all = exchange
    assert len(calls) == max(s.n_chunks for s in single.shards) > 1 and max(calls) <= 2 * 8
    for name in ("chunk_data", "chunk_ids", "chunk_scales"):
        assert torch.equal(getattr(bounded.shards[0], name), getattr(single.shards[rank], name))
    for name in ("bucket_chunk_start", "bucket_sizes"):
        np.testing.assert_array_equal(getattr(bounded.shards[0], name),
                                      getattr(single.shards[rank], name))

    with pytest.raises(ValueError, match="equal row counts"):
        mp.from_process_local(np.zeros((3 - rank, 4), np.float32), world)
    with pytest.raises(ValueError, match="single-process only"):
        kmeans_nodes(gpts, np.zeros(64, np.int64), np.zeros(1, np.int64), 2,
                     seeds=np.zeros(1, np.int64), devices=world)
    torch.distributed.destroy_process_group()


def _tie_band(data, centroids, labels, ref_labels):
    """Rows whose labels differ must have their two nearest centroids
    within 1e-6; returns how many differ."""
    differ = np.nonzero(labels != ref_labels)[0]
    if len(differ):
        d = ((data[differ, None, :].astype(np.float64) - centroids[None]) ** 2).sum(-1)
        two = np.sort(d, axis=1)[:, :2]
        assert (two[:, 1] - two[:, 0] <= 1e-6).all(), two
    return len(differ)


def _flow(rank, world_size, where, cats):
    import torch

    import learnedmetricindex_tpu_torch as lmi
    from learnedmetricindex_tpu_torch.data import synthetic_blobs
    from learnedmetricindex_tpu_torch.ops import exact_knn, kmeans, recall
    from learnedmetricindex_tpu_torch.parallel import shard_store, sharded_search

    mp, world = _join(rank, world_size, where)
    cats = [int(c) for c in cats.split(",")]
    data, queries = synthetic_blobs(1024, 16, 32, n_clusters=8, seed=7)
    share = len(data) // world_size
    gdata = mp.from_process_local(data[rank * share:(rank + 1) * share], world)

    # the root's clustering, as the builder calls it, against one device's
    c, lab = kmeans(gdata, cats[0], seed=3)
    ref_c, ref_lab = kmeans(data, cats[0], seed=3)
    np.testing.assert_array_equal(c, ref_c)
    print(f"rank {rank}: {_tie_band(data, c, lab, ref_lab)} root labels differ", flush=True)

    cfg = lmi.BuildConfiguration("kmeans", 20, "MLP", 0.02, cats, seed=3)
    index, pred, nb, _, _ = lmi.LearnedIndexBuilder(gdata, cfg, device="cpu",
                                                    devices=world).build()
    store = index.get_sharded_store(gdata, pred, world)
    assert index.get_sharded_store(gdata, pred, world) is store
    dd, ii, _ = index.search(gdata, queries, gdata, queries, pred, None, n_buckets=nb, k=10,
                             store=store)
    _, gt = exact_knn(data, queries, k=10, device="cpu")
    assert recall(ii, gt, 10) == 1.0, recall(ii, gt, 10)

    # the device-list path over ["cpu"] * W
    ref, ref_pred, ref_nb, _, _ = lmi.LearnedIndexBuilder(
        data, cfg, device="cpu", devices=["cpu"] * world_size).build()
    np.testing.assert_array_equal(pred, ref_pred)
    assert nb == ref_nb
    for lv, rv in zip(index.levels, ref.levels):
        assert torch.equal(lv.class_mask, rv.class_mask)
        for a, b in zip(lv.mlp.parameters(), rv.mlp.parameters(), strict=True):
            assert torch.equal(a, b)
    chunk = store.chunk
    single = shard_store(data, index.bucket_ids_from_prediction(pred), index._n_leaves(),
                         ["cpu"] * world_size, chunk=chunk)
    mine, theirs = store.shards[0], single.shards[rank]
    np.testing.assert_array_equal(store.bucket_device, single.bucket_device)
    for name in ("chunk_data", "chunk_ids"):
        assert torch.equal(getattr(mine, name), getattr(theirs, name)), name
    for name in ("bucket_chunk_start", "bucket_sizes"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(theirs, name))
    nbytes = mp.to_host_replicated(torch.tensor([store.nbytes_device_arrays()]), world)
    assert int(nbytes.sum()) == single.nbytes_device_arrays()
    order, _ = index.compute_bucket_order(queries, nb)
    for precision in ("default", "highest"):
        d, i, _ = index.search(None, queries, None, queries, pred, n_buckets=nb, k=10,
                               store=store, precision=precision)
        sd, si = sharded_search(single, queries, order, k=10, precision=precision, rerank=True)
        np.testing.assert_array_equal(d, sd)
        np.testing.assert_array_equal(i, si)
        every = mp.to_host_replicated(torch.as_tensor(i.astype(np.int64))[None], world)
        assert (every == every[0]).all()
    if rank == 0:
        index.save(os.path.join(where, "index.npz"), pred)
        np.savez(os.path.join(where, "results.npz"), dists=d, ids=i, pred=pred, nb=nb)
    torch.distributed.destroy_process_group()


def _torchrun(rank, world_size, where):
    import torch

    from learnedmetricindex_tpu_torch.parallel import multiprocess as mp

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mp.initialize(device="cuda")
        assert not torch.distributed.is_initialized()
    mp.initialize(device="cpu")
    group = torch.distributed.group.WORLD
    mp.initialize(device="cpu")  # idempotent
    assert torch.distributed.group.WORLD is group
    world = mp.global_mesh()
    assert (world.rank, world.size, torch.distributed.get_backend()) == (0, 1, "gloo")
    assert not mp.is_multiprocess(world)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.modules["jax"] = None  # the ranks import no jax
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)
    case, rank, world, where = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    {"collectives": _collectives, "flow": _flow, "torchrun": _torchrun}[case](
        rank, world, where, *sys.argv[5:])
    assert not any(m == "learnedmetricindex_tpu" or m.startswith("learnedmetricindex_tpu.")
                   for m in sys.modules), "a rank imported the JAX package"
    print(f"rank {rank} OK", flush=True)
