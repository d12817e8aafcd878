"""The port's MLP forward and navigation against the JAX package: the
same parameters and queries give the same logits and bucket orders,
best-first traversal and its budget guards included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import learnedmetricindex_tpu as jlmi
from learnedmetricindex_tpu.data import synthetic_blobs
from learnedmetricindex_tpu.index import navigation as jnav
from learnedmetricindex_tpu.index.navigation import _quantize_visits as jax_quantize_visits
from learnedmetricindex_tpu.models.mlp import init_stacked_mlp, stacked_mlp_apply
from learnedmetricindex_tpu_torch.index import navigation as pnav
from learnedmetricindex_tpu_torch.index.navigation import _quantize_visits
from learnedmetricindex_tpu_torch.index.serialization import index_from_arrays
from learnedmetricindex_tpu_torch.models.mlp import StackedMLP

torch.set_num_threads(2)


def port_of(jidx):
    """The port's index holding the same parameters as a JAX index."""
    return index_from_arrays(
        jidx.config.to_dict(),
        [[{"w": np.asarray(p["w"]), "b": np.asarray(p["b"])} for p in lv.params] for lv in jidx.levels],
        [lv.class_mask for lv in jidx.levels],
        [lv.model_type for lv in jidx.levels],
        jidx.leaf_valid,
        "cpu",
    )


@pytest.fixture(scope="module")
def built():
    data, queries = synthetic_blobs(1800, 16, 60, n_clusters=12, seed=21)
    out = {"queries": queries}
    for name, cats in (("one", [10]), ("two", [3, 2])):
        cfg = jlmi.BuildConfiguration("kmeans", 5, "MLP-2", 0.01, cats, seed=21, chunk_size=64)
        jidx = jlmi.LearnedIndexBuilder(data, cfg).build()[0]
        out[name] = (jidx, port_of(jidx))
    return out


@pytest.mark.parametrize("model_type", ["MLP", "MLP-5", "MLP-9"])
def test_stacked_mlp_matches_jax(model_type):
    params = init_stacked_mlp(jax.random.PRNGKey(3), 4, model_type, 20, 7)
    x = np.random.default_rng(3).normal(size=(33, 20)).astype(np.float32)
    ref = np.asarray(stacked_mlp_apply(params, jnp.asarray(x)))
    mlp = StackedMLP.from_numpy([{k: np.asarray(v) for k, v in p.items()} for p in params], "cpu")
    with torch.no_grad():
        got = mlp(torch.as_tensor(x)).numpy()
    assert got.shape == (4, 33, 7)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    back = mlp.to_numpy()
    for a, b in zip(back, params):
        np.testing.assert_array_equal(a["w"], np.asarray(b["w"]))


def test_init_is_linear_style_and_seeded():
    def make(seed):
        g = torch.Generator().manual_seed(seed)
        return StackedMLP.init(3, "MLP-4", 16, 10, generator=g, device="cpu")

    a, b, c = make(0), make(0), make(1)
    assert [tuple(w.shape) for w in a.weights] == [(3, 16, 512), (3, 512, 10)]
    assert [tuple(x.shape) for x in a.biases] == [(3, 512), (3, 10)]
    for w, fan_in in zip(a.weights, (16, 512)):
        assert w.abs().max() <= fan_in**-0.5
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.weights[0], c.weights[0])
    with pytest.raises(ValueError, match="not supported"):
        StackedMLP.init(1, "MLP-99", 4, 2, generator=torch.Generator(), device="cpu")


@pytest.mark.parametrize("nav_temp", [1.0, 4.0])
def test_single_level_order_matches_jax(built, nav_temp):
    jidx, pidx = built["one"]
    q = built["queries"]
    for n_buckets in (1, 3, 10, 15):
        ref, _ = jidx.compute_bucket_order(q, n_buckets, nav_temp=nav_temp)
        got, _ = pidx.compute_bucket_order(q, n_buckets, nav_temp=nav_temp)
        np.testing.assert_array_equal(got, np.asarray(ref))
    # one level: best_first and joint give the same order
    got_bf, _ = pidx.compute_bucket_order(q, 4, policy="best_first")
    got_j, _ = pidx.compute_bucket_order(q, 4, policy="joint")
    np.testing.assert_array_equal(got_bf, got_j)


@pytest.mark.parametrize("nav_temp", [1.0, (1.0, 4.0)])
def test_two_level_joint_order_matches_jax(built, nav_temp):
    jidx, pidx = built["two"]
    q = built["queries"]
    for n_buckets in (1, 2, 4, 6):
        ref, _ = jidx.compute_bucket_order(q, n_buckets, policy="joint", nav_temp=nav_temp)
        got, _ = pidx.compute_bucket_order(q, n_buckets, policy="joint", nav_temp=nav_temp)
        np.testing.assert_array_equal(got, np.asarray(ref))


def test_masked_classes_match_jax(built):
    jidx, _ = built["one"]
    mask = np.asarray(jidx.levels[0].class_mask).copy()
    mask[0, [1, 6]] = False
    jidx.levels[0].class_mask, saved = mask, jidx.levels[0].class_mask
    try:
        pidx = port_of(jidx)
        ref, _ = jidx.compute_bucket_order(built["queries"], 10)
    finally:
        jidx.levels[0].class_mask = saved
    got, _ = pidx.compute_bucket_order(built["queries"], 10)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert (got[:, -2:] == -1).all() and not np.isin(got, [1, 6]).any()


def test_navigation_guards(built):
    _, pidx = built["two"]
    q = built["queries"]
    # best-first runs on a multi-level index (it is the default policy)
    order, _ = pidx.compute_bucket_order(q, 3, policy="best_first")
    assert order.shape == (len(q), 3) and (order >= 0).all()
    with pytest.raises(ValueError, match="nav_temp"):
        pidx.compute_bucket_order(q, 3, policy="joint", nav_temp=(1.0, 2.0, 3.0))
    with pytest.raises(ValueError, match="policy"):
        pidx.compute_bucket_order(q, 3, policy="greedy")
    order, seconds = pidx.compute_bucket_order(q, 3, policy="joint", keep_on_device=True)
    assert isinstance(order, torch.Tensor) and order.dtype == torch.int32 and seconds >= 0


def test_quantize_visits_matches_jax():
    for n_leaves in (1, 6, 10, 120):
        for n in range(1, n_leaves + 3):
            assert _quantize_visits(n, n_leaves) == jax_quantize_visits(n, n_leaves)


def _random_probs(rng, Q, n_categories, masked=False):
    """Random conditional probabilities for a full tree, optionally with
    some classes masked out, as numpy (probs, valid) per level."""
    probs, valid = [], []
    n_nodes = 1
    for C in n_categories:
        p = np.exp(rng.normal(size=(Q, n_nodes, C)).astype(np.float32) * 3)
        p /= p.sum(axis=-1, keepdims=True)
        v = np.ones((n_nodes, C), bool)
        if masked:
            v[rng.random((n_nodes, C)) < 0.2] = False
            v[:, 0] = True
        probs.append(p)
        valid.append(v)
        n_nodes *= C
    return probs, valid


@pytest.mark.parametrize("cats", [(6,), (4, 3), (3, 2, 4)])
@pytest.mark.parametrize("frontier", [1, 16])
@pytest.mark.parametrize("masked", [False, True])
def test_best_first_order_matches_jax(monkeypatch, cats, frontier, masked):
    monkeypatch.setenv("LMI_NAV_FRONTIER", str(frontier))
    rng = np.random.default_rng(len(cats) * 10 + frontier)
    probs, valid = _random_probs(rng, 40, cats, masked)
    jlayout, playout = jnav.TreeLayout.create(cats), pnav.TreeLayout.create(cats)
    for f in ("child_base", "child_count", "is_leaf"):
        np.testing.assert_array_equal(getattr(playout, f), getattr(jlayout, f))
    assert playout.n_entries == jlayout.n_entries
    jentry = jnav.flatten_entry_probs(jlayout, [jnp.asarray(p) for p in probs], valid)
    pentry = pnav.flatten_entry_probs_device([torch.as_tensor(p) for p in probs],
                                             [torch.as_tensor(v) for v in valid])
    np.testing.assert_array_equal(pentry.numpy(), np.asarray(jentry))
    n_leaves = playout.n_leaves
    for n_buckets in (3, n_leaves):  # a prefix and the full sweep
        ref = jnav.best_first_order(jlayout, jentry, n_buckets)
        got = pnav.best_first_order(playout, pentry, n_buckets)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


def test_ties_go_to_the_lower_entry():
    """Equal probabilities pop in entry order, as lax.top_k orders them."""
    cats = (3, 2)
    probs = [np.full((2, 1, 3), 1 / 3, np.float32), np.full((2, 3, 2), 0.5, np.float32)]
    valid = [np.ones((1, 3), bool), np.ones((3, 2), bool)]
    jlayout, playout = jnav.TreeLayout.create(cats), pnav.TreeLayout.create(cats)
    jentry = jnav.flatten_entry_probs(jlayout, [jnp.asarray(p) for p in probs], valid)
    pentry = pnav.flatten_entry_probs_device([torch.as_tensor(p) for p in probs],
                                             [torch.as_tensor(v) for v in valid])
    got = pnav.best_first_order(playout, pentry, 6).numpy()
    np.testing.assert_array_equal(got, jnav.best_first_order(jlayout, jentry, 6))


def test_budget_guards_match_jax(monkeypatch):
    for budget in ("100000", "1000"):
        monkeypatch.setenv("LMI_MAX_NAV_STATE_BYTES", budget)
        for n_q, n_e in ((8, 64 + 64 * 64), (1, 300), (3, 50)):
            outcomes = []
            for mod in (jnav, pnav):
                try:
                    mod.check_best_first_budget(n_q, n_e)
                    outcomes.append("ok")
                except ValueError as e:
                    assert "joint" in str(e)
                    outcomes.append(str(e))
            assert outcomes[0] == outcomes[1]
        for n_e in (50, 60, 199, 200):
            assert pnav.max_best_first_queries(n_e) == jnav.max_best_first_queries(n_e)
    with pytest.raises(ValueError, match="joint"):
        pnav.max_best_first_queries(n_entries=300)  # 1500 B per query > 1000 B
    cats = (64, 64)
    probs, valid = _random_probs(np.random.default_rng(1), 8, cats)
    entry = pnav.flatten_entry_probs_device([torch.as_tensor(p) for p in probs],
                                            [torch.as_tensor(v) for v in valid])
    monkeypatch.setenv("LMI_MAX_NAV_STATE_BYTES", "100000")
    with pytest.raises(ValueError, match="joint"):
        pnav.best_first_order(pnav.TreeLayout.create(cats), entry, 5)


def test_two_level_best_first_matches_jax_and_slices(built, monkeypatch):
    """The public path: best-first orders of a JAX-built 2-level index equal
    the JAX package's, and navigating in budget-sized query slices gives
    the same order as one pass."""
    jidx, pidx = built["two"]
    q = built["queries"]
    for n_buckets in (1, 2, 4, 6):
        ref, _ = jidx.compute_bucket_order(q, n_buckets, policy="best_first")
        got, _ = pidx.compute_bucket_order(q, n_buckets, policy="best_first")
        np.testing.assert_array_equal(got, np.asarray(ref))
    whole, _ = pidx.compute_bucket_order(q, 4, keep_on_device=True)
    E = pidx.layout.n_entries
    monkeypatch.setenv("LMI_MAX_NAV_STATE_BYTES", str(E * 5 * 8))  # 8 queries per slice
    assert pnav.max_best_first_queries(E) == 8
    sliced, _ = pidx.compute_bucket_order(q, 4, keep_on_device=True)
    assert torch.equal(sliced, whole)
