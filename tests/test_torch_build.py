"""The port's LearnedIndexBuilder against the JAX package's, by outcome
(the two draw k-means inits, samples and batches from different PRNGs):
the same bucket count, no empty bucket, the same prediction layout, a
recall-vs-visit curve within 0.05 of the JAX-built index's, and indices
that load and search across the two packages."""

import numpy as np
import pytest
import torch

import learnedmetricindex_tpu as jlmi
from learnedmetricindex_tpu.data import synthetic_blobs
from learnedmetricindex_tpu.index.serialization import load_index as jax_load_index
from learnedmetricindex_tpu.ops.knn import exact_knn as jax_exact_knn
import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch.ops import quantize
from learnedmetricindex_tpu_torch.ops.knn import recall

torch.set_num_threads(2)

# the curve at 1/8, 1/4 and 1/2 of the leaves: one leaf of a 2-level
# tree at this size depends on which latent clusters the root's k-means
# groups together, and that moves with the PRNG by up to ~0.08 either way
# (six seeds, both packages), more than the bar
VISIT_FRACTIONS = (8, 4, 2)
CASES = [("f32", (8,)), ("f32", (4, 4)), ("int8", (8,)), ("int8", (4, 4))]


@pytest.fixture(scope="module")
def fixture():
    data, queries = synthetic_blobs(2000, 16, 80, n_clusters=16, seed=6, cluster_std=0.17)
    q8, sc = quantize.quantize_rows(torch.from_numpy(data))
    _, gt = jax_exact_knn(data, queries, k=10)
    out = {"data": data, "queries": queries, "gt": gt,
           "int8": (q8.numpy(), sc.numpy())}
    for kind, cats in CASES:
        corpus = data if kind == "f32" else out["int8"]
        cfg = dict(seed=6, chunk_size=64, batch_size=128)
        pcfg = lmi.BuildConfiguration("kmeans", 5, "MLP", 0.01, list(cats), **cfg)
        jcfg = jlmi.BuildConfiguration("kmeans", 5, "MLP", 0.01, list(cats), **cfg)
        out[kind, cats] = (
            lmi.LearnedIndexBuilder(corpus, pcfg, device="cpu").build(),
            jlmi.LearnedIndexBuilder(corpus, jcfg).build(),
        )
    return out


def _curve(idx, corpus, queries, pred, gt, n_leaves):
    return [
        recall(np.asarray(idx.search(None, queries, corpus, queries, pred,
                                     n_buckets=n_leaves // f, k=10)[1]), gt, 10)
        for f in VISIT_FRACTIONS
    ]


@pytest.mark.parametrize("kind,cats", CASES)
def test_build_matches_jax_by_outcome(fixture, kind, cats):
    (pidx, ppred, pnb, pbt, pct), (jidx, jpred, jnb, _, _) = fixture[kind, cats]
    n = len(fixture["data"])
    assert pnb == jnb == int(np.prod(cats))
    assert ppred.shape == np.asarray(jpred).shape == (n, len(cats)) and ppred.dtype == np.int64
    assert ppred.min() >= 0 and (ppred < np.asarray(cats)).all()
    sizes = np.bincount(pidx.bucket_ids_from_prediction(ppred), minlength=pnb)
    assert (sizes > 0).all(), sizes  # the coverage rule: no empty bucket
    assert pbt >= pct >= 0.0
    assert [tuple(lv.class_mask.shape) for lv in pidx.levels] == [
        tuple(lv.class_mask.shape) for lv in jidx.levels]
    corpus = fixture["data"] if kind == "f32" else fixture["int8"]
    q, gt = fixture["queries"], fixture["gt"]
    ours = _curve(pidx, corpus, q, ppred, gt, pnb)
    theirs = _curve(jidx, corpus, q, np.asarray(jpred), gt, pnb)
    assert np.all(np.abs(np.array(ours) - np.array(theirs)) <= 0.05), (ours, theirs)
    assert ours == sorted(ours)


@pytest.mark.parametrize("cats", [(8,), (4, 4)])
def test_npz_crosses_both_ways(fixture, tmp_path, cats):
    """A port-built index searches in the JAX package and a JAX-built one in
    the port, each to the parity bar of ROADMAP.md against the other."""
    data, q = fixture["data"], fixture["queries"]
    (pidx, ppred, *_), (jidx, jpred, *_) = fixture["f32", cats]
    for src, pred, save, load in (
        (pidx, ppred, pidx.save, jax_load_index),
        (jidx, np.asarray(jpred), jidx.save, lambda p: lmi.load_index(p, "cpu")),
    ):
        path = str(tmp_path / f"{len(cats)}-{type(src).__module__.split('.')[0]}.npz")
        save(path, pred)
        other, saved = load(path)
        np.testing.assert_array_equal(np.asarray(saved), pred)
        for policy in ("best_first", "joint"):
            kw = dict(n_buckets=3, k=10, precision="highest", policy=policy)
            d0, i0, _ = src.search(None, q, data, q, pred, **kw)
            d1, i1, _ = other.search(None, q, data, q, np.asarray(saved), **kw)
            d0, i0, d1, i1 = map(np.asarray, (d0, i0, d1, i1))
            np.testing.assert_allclose(d1, d0, rtol=1e-4, atol=1e-5)
            mism = i0 != i1
            if mism.any():
                np.testing.assert_allclose(d1[mism], d0[mism], rtol=1e-6, atol=1e-7)


def test_builder_guards_and_routes(monkeypatch):
    data, _ = synthetic_blobs(400, 8, 4, n_clusters=4, seed=1)
    cfg = lmi.BuildConfiguration("kmeans", 2, "MLP-8", 0.05, [3, 3], seed=1, chunk_size=32)
    with pytest.raises(ValueError, match="lies on"):
        lmi.LearnedIndexBuilder(torch.from_numpy(data).to("meta"), cfg, device="cpu")
    # the serial per-node route gives a working index as well
    monkeypatch.setenv("LMI_BATCHED_NODE_KMEANS", "0")
    idx, pred, nb, _, _ = lmi.LearnedIndexBuilder(data, cfg, device="cpu").build()
    assert nb == 9 and (np.bincount(idx.bucket_ids_from_prediction(pred), minlength=9) > 0).all()
    # a node with fewer rows than classes takes the reference's guard
    tiny = lmi.BuildConfiguration("kmeans", 2, "MLP-8", 0.05, [50], seed=1, chunk_size=32)
    idx, pred, nb, _, _ = lmi.LearnedIndexBuilder(data[:30], tiny, device="cpu").build()
    assert nb == int(idx.leaf_valid.sum()) and nb <= 6
