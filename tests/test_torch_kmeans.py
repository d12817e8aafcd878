"""The port's k-means against the JAX package's: Lloyd's from the same
init rows, the same subsample, the same assignment, and the batched
sibling k-means by outcome (its draws come from another PRNG)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnedmetricindex_tpu.data import synthetic_blobs
from learnedmetricindex_tpu_torch.ops import clustering

# both packages' ops/__init__ export the function kmeans over the module's name
jk = importlib.import_module("learnedmetricindex_tpu.ops.kmeans")
pk = importlib.import_module("learnedmetricindex_tpu_torch.ops.kmeans")

torch.set_num_threads(2)


def _jax_init(seed, k, n):
    """The JAX package's init rows (_kmeans_device :88-91)."""
    draw = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (k,), 0, n))
    return (draw + np.arange(k)) % n


def _near_tie_only(x, centroids, la, lb, tol=1e-4):
    """Labels that differ must be near-ties of the distance to the two
    centroids."""
    diff = la != lb
    if diff.any():
        c2 = (centroids * centroids).sum(1)
        d = c2[None, :] - 2.0 * x[diff] @ centroids.T
        rows = np.arange(diff.sum())
        np.testing.assert_allclose(d[rows, la[diff]], d[rows, lb[diff]], atol=tol)


@pytest.mark.parametrize("n,k,seed", [(3000, 8, 5), (1200, 13, 2)])
def test_lloyd_from_the_jax_init_matches(n, k, seed):
    data, _ = synthetic_blobs(n, 16, 4, n_clusters=12, seed=seed)
    jc, jl = jk._kmeans_device(jnp.asarray(data), jnp.int32(n), jax.random.PRNGKey(seed),
                               n_clusters=k, n_iters=25, tile_rows=n)
    pc, pl = pk.kmeans_device(torch.from_numpy(data), k, n_iters=25,
                              init_idx=torch.as_tensor(_jax_init(seed, k, n)))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-5)
    _near_tie_only(data, pc.numpy(), pl.numpy(), np.asarray(jl))


def test_empty_cluster_resplit_matches():
    """Duplicate init rows leave clusters empty: both packages re-seed
    them from the largest cluster, c_j = c_big · (1 + 1e-4 (1 + j))."""
    rng = np.random.default_rng(0)
    data = np.concatenate([np.zeros((50, 4)), np.ones((50, 4))]).astype(np.float32)
    data += 0.01 * rng.normal(size=data.shape).astype(np.float32)
    n, k = 100, 5
    init = np.array([0, 0, 0, 0, 60])  # four inits on one point: three empty clusters
    # one step: the re-seeded centroids sit 1e-4 apart, so a later step's
    # labels among them are near-ties of the summation order
    pc, pl = pk.kmeans_device(torch.from_numpy(data), k, n_iters=1,
                              init_idx=torch.as_tensor(init))
    # the JAX side from the same init: its Lloyd's step on explicit rows
    cent = jnp.asarray(data[init])
    for _ in range(1):
        c2 = jnp.sum(cent * cent, axis=1)[None, :]
        lab = jnp.argmin(c2 - 2.0 * jnp.dot(jnp.asarray(data), cent.T,
                                            precision=jax.lax.Precision.HIGHEST), axis=1)
        oh = jax.nn.one_hot(lab, k, dtype=jnp.float32)
        sums = jnp.dot(oh.T, jnp.asarray(data), precision=jax.lax.Precision.HIGHEST)
        counts = oh.sum(0)
        new = sums / jnp.maximum(counts, 1.0)[:, None]
        eps = 1e-4 * (1.0 + jnp.arange(k, dtype=jnp.float32))[:, None]
        cent = jnp.where((counts == 0.0)[:, None], new[jnp.argmax(counts)][None, :] * (1.0 + eps), new)
    np.testing.assert_allclose(pc.numpy(), np.asarray(cent), rtol=1e-6, atol=1e-7)
    assert len(np.unique(pc.numpy(), axis=0)) == k  # re-seeded apart


def test_subsample_indices_equal_jax():
    """The faiss subsample is numpy's draw in both packages: the port fits
    on exactly the rows the JAX package fits on."""
    data, _ = synthetic_blobs(5000, 8, 4, n_clusters=6, seed=1)
    k, seed, mppc = 6, 9, 50
    drawn = []
    real = pk.kmeans_device

    def spy(x, n_clusters, **kw):
        drawn.append(x.numpy().copy())
        return real(x, n_clusters, **kw)

    rows = np.arange(0, 5000, 2)
    pk.kmeans_device = spy
    try:
        pk.kmeans(data, k, seed=seed, max_points_per_centroid=mppc)
        # the rows path draws local indices, as the JAX package's does
        pk.kmeans(torch.from_numpy(data), k, seed=seed, max_points_per_centroid=mppc, rows=rows)
    finally:
        pk.kmeans_device = real
    sample = np.sort(np.random.default_rng(seed).choice(5000, size=mppc * k, replace=False))
    np.testing.assert_array_equal(drawn[0], data[sample])
    local = np.sort(np.random.default_rng(seed).choice(len(rows), size=mppc * k, replace=False))
    np.testing.assert_array_equal(drawn[1], data[rows[local]])


@pytest.mark.parametrize("scaled", [False, True])
def test_kmeans_assign_matches_jax(scaled):
    data, _ = synthetic_blobs(4000, 24, 4, n_clusters=10, seed=4)
    centroids = data[:9] + 0.01
    scales = None
    if scaled:
        scales = np.abs(data).max(1) / 127
        data = np.round(data / scales[:, None]).astype(np.int8)
    got = pk.kmeans_assign(centroids, data, tile_rows=1000, row_scales=scales)
    ref = jk.kmeans_assign(centroids, data, tile_rows=1000, row_scales=scales)
    x = data.astype(np.float32) * (1.0 if scales is None else scales[:, None])
    assert got.dtype == np.int32
    _near_tie_only(x, centroids, got, np.asarray(ref))


def test_kmeans_guards_and_registry():
    data, _ = synthetic_blobs(300, 8, 4, n_clusters=4, seed=0)
    c, lab = pk.kmeans(data[:1], 5)
    assert c.shape == (1, 8) and lab.tolist() == [0]
    c, lab = pk.kmeans(data[:7], 20)  # k clamps to n
    assert c.shape == (7, 8) and lab.min() >= 0 and lab.max() < 7
    for name in ("kmeans", "faiss_kmeans", "scikit_kmeans"):
        c, lab = clustering.algorithms[name](data, 4, {"seed": 3, "max_iter": 10})
        assert c.shape == (4, 8) and lab.shape == (300,) and lab.dtype == np.int32
        assert len(np.unique(lab)) == 4
    a = clustering.algorithms["kmeans"](data, 4, {"seed": 3})[1]
    b = clustering.algorithms["kmeans"](torch.from_numpy(data), 4, {"seed": 3})[1]
    np.testing.assert_array_equal(a, b)
    rows = np.arange(100, 300)
    sub = clustering.algorithms["kmeans"](data, 4, {"seed": 3, "rows": rows})[1]
    np.testing.assert_array_equal(sub, pk.kmeans(data[rows], 4, seed=3)[1])


def _inertia(x, parent, labels, nodes, C):
    tot = 0.0
    for g in nodes:
        for c in range(C):
            pts = x[(parent == g) & (labels == c)]
            if len(pts):
                tot += float(((pts - pts.mean(0)) ** 2).sum())
    return tot


def test_kmeans_nodes_by_outcome():
    data, _ = synthetic_blobs(6000, 16, 4, n_clusters=24, seed=8)
    parent = np.random.default_rng(8).integers(0, 4, 6000)
    nodes = np.array([0, 1, 3])  # node 2's rows are not clustered
    seeds = np.array([11, 12, 13])
    C = 5
    lab = pk.kmeans_nodes(data, parent, nodes, C, seeds=seeds, tile=512)
    assert lab.dtype == np.int32 and lab.shape == (6000,)
    assert (lab[parent == 2] == -1).all()
    for g in nodes:
        got = lab[parent == g]
        assert got.min() >= 0 and got.max() < C
        assert (np.bincount(got, minlength=C) > 0).all()  # no empty cluster
    jlab = np.asarray(jk.kmeans_nodes(data, parent, nodes, C, seeds=seeds, tile=512))
    ours, theirs = _inertia(data, parent, lab, nodes, C), _inertia(data, parent, jlab, nodes, C)
    assert abs(ours - theirs) <= 0.02 * theirs, (ours, theirs)
    again = pk.kmeans_nodes(data, parent, nodes, C, seeds=seeds, tile=512)
    np.testing.assert_array_equal(lab, again)
    other = pk.kmeans_nodes(data, parent, nodes, C, seeds=seeds + 100, tile=512)
    assert not np.array_equal(lab, other)


def test_device_free_bytes_is_none_off_the_gpu():
    assert pk.device_free_bytes("cpu") is None
    assert pk.device_free_bytes(torch.device("cpu")) is None
