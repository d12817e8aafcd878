"""The yardstick's own arithmetic: the generator, the schedules and the
scan's work and byte count."""

import numpy as np
import pytest
import torch

from lmibench import generator, inputs, spec
from lmibench.frozen import blobs, handset, work

from lmibench.tests import tiny

SEEDS = [0, 7, 2**31 + 11, 2**40 + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_same_bits_for_same_seed(seed):
    cfg = tiny.config()
    a = [x for _, x in inputs.corpus_blocks(inputs.generator(cfg, seed, "cpu"), cfg)]
    b = [x for _, x in inputs.corpus_blocks(inputs.generator(cfg, seed, "cpu"), cfg)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = next(inputs.corpus_blocks(inputs.generator(cfg, seed + 1, "cpu"), cfg))[1]
    assert not torch.equal(a[0], c)
    assert torch.allclose(a[0].norm(dim=1), torch.ones(len(a[0])), atol=1e-5)


def test_quantization_round_trip():
    x = blobs.BlobGenerator(4, 64, 3, 0.45, device="cpu").rows(100)
    q, s = blobs.quantize_rows(x)
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    assert torch.allclose(blobs.dequantize_rows(q, s), x, atol=float(s.max()) / 2 + 1e-7)


@pytest.mark.parametrize("seed", SEEDS)
def test_open_loop_schedule_same_bits_for_same_seed(seed):
    t = tiny.traffic("serve")
    a = generator.arrivals(t, seed, 5.0)
    assert a == generator.arrivals(t, seed, 5.0)
    assert a != generator.arrivals(t, seed + 1, 5.0)
    due = np.array([x[0] for x in a])
    assert len(a) == round(t["rate_per_s"] * 5.0) and np.all(np.diff(due) >= 0)
    assert due[0] == 0.0 and due[-1] < 5.0
    assert all(0 <= off and off + nq <= t["queries"] for _, off, nq in a)


def test_seeds_share_their_gaps():
    t = spec.traffic("serve")
    gaps = [np.sort(np.diff([x[0] for x in generator.arrivals(t, s, 10.0)] + [10.0]))
            for s in SEEDS]
    for g in gaps[1:]:
        assert np.allclose(g, gaps[0], rtol=0, atol=1e-9)


def test_mutation_schedule():
    t = tiny.traffic("serve")
    due = generator.mutation_times(t, 1.0)
    assert len(due) == 10 and due[1] == pytest.approx(0.1)
    assert generator.insert_rows_needed(t, 1.0) == (len(generator.mutation_times(t, 0.3))
                                                    + 10) * 8


def brute_force(visits, sizes, d, store, precision, k_scan):
    """Loop version of work.scan_work."""
    macs, lists, touched = 0, 0, set()
    for row in visits:
        for b in set(int(v) for v in row if v >= 0):
            macs += sizes[b] * d
            touched.add(b)
            lists += sizes[b] > 0
    row_bytes = d + 4 if store == "int8" else 4 * d
    nbytes = sum(sizes[b] for b in touched) * row_bytes + len(visits) * d * 4 + lists * k_scan * 8
    mode = work.SCAN_MODE[precision]
    passes = {"f32": 6 if store == "float32" else 3}.get(mode, 1)
    peak = work.PEAK_OPS["bf16" if mode == "f32" else mode]
    return macs, 2.0 * passes * macs, nbytes, max(2.0 * passes * macs / peak,
                                                  nbytes / work.HBM_BYTES_PER_S)


@pytest.mark.parametrize("store", ["int8", "float32"])
@pytest.mark.parametrize("precision", ["default", "highest", "int8"])
def test_work_count_equals_brute_force(store, precision):
    r = np.random.default_rng(5)
    sizes = r.integers(0, 50, 9)
    sizes[3] = 0
    visits = r.integers(-1, 9, (17, 4))
    visits[2] = [1, 1, -1, 3]  # a repeated visit counts once, an empty bucket writes nothing
    got = work.scan_work(visits, sizes, 96, store, precision, 16)
    macs, ops, nbytes, bound = brute_force(visits, sizes, 96, store, precision, 16)
    assert (got["macs"], got["ops"], got["bytes"]) == (macs, ops, nbytes)
    assert got["bound_s"] == pytest.approx(bound, rel=1e-12)


def test_handset_index_is_nearest_centroid():
    x = blobs.BlobGenerator(8, 32, 1, 0.45, device="cpu").rows(300)
    c = x[handset.centroid_rows(300, 6, 9)]
    (l1, l2) = handset.mlp4_params(c, 16)
    h = np.maximum(x.numpy() @ l1["w"][0] + l1["b"][0], 0)
    logits = h @ l2["w"][0] + l2["b"][0]
    nearest = torch.cdist(x, c).argmin(1).numpy()
    assert np.array_equal(logits.argmax(1), nearest)
