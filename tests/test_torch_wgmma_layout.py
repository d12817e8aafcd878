"""The wgmma bodies of the scan kernel (bf16 queries over an int8 or an
f32 packed store, f32 queries over an int8 or an f32 packed store, int8
queries over an int8 packed store, at list width 32, and the wide lists)
as far as the CPU can check them: the query layouts their B operand reads
(WGMMA_ORDER, WGMMA_F32_ORDER, WGMMA_S8_ORDER, the three planes of the
f32 mode) against a model of the registers their lanes load, widen or
round and of the resident tiles and sums (held to the JAX package's
Pallas scans in interpret mode), and the split's cost model for their
64- and 32-slot blocks.  Which body a launch takes is the
library's to say (test_torch_cuda.py asks it), and the kernels
themselves are held to the plain version there too."""

import numpy as np
import pytest
import torch

from learnedmetricindex_tpu_torch.ops import scan_kernel

torch.set_num_threads(2)

# the library pads the wgmma body's query rows to a ring stage's depths
# (W_QD_STEP in csrc/scan_pairs.cu): the width lmi_scan_body reports
QD_STEP = 128
# ... and over an f32 store (W_QD_STEP_F: two boxes of 32 f32 depths)
QD_STEP_F32 = 64


def _lane_depths():
    """For k-step j of a ring stage, lane quad index t and the register
    half (k' of the m64nNk16 A fragment), the store depth within the
    64-depth stage that the kernel's lane puts there: lane t reads bytes
    16t .. 16t+15 of its rows, word j widens into k-step j, byte i of the
    word into k' = 2t + i (i < 2) or 2t + 8 + (i - 2)."""
    depth = np.full((4, 16), -1)
    for j in range(4):
        for t in range(4):
            for i in range(4):
                kk = 2 * t + i if i < 2 else 2 * t + 8 + (i - 2)
                depth[j, kk] = 16 * t + 4 * j + i
    return depth


def test_wgmma_order_is_the_lanes_depth_map():
    """Position 16j + k' of each 64-group of the laid-out queries holds
    the depth that the A register at (k-step j, k') holds, and every
    depth of the group appears once."""
    depth = _lane_depths()
    np.testing.assert_array_equal(np.asarray(scan_kernel.WGMMA_ORDER), depth.reshape(-1))
    assert sorted(scan_kernel.WGMMA_ORDER) == list(range(64))


@pytest.mark.parametrize("d", [768, 784, 96, 100, 40])
def test_wgmma_model_contracts_to_the_dot_product(d):
    """The kernel's contraction, modelled lane by lane: for every stage,
    k-step and k', the widened store value (``_lane_depths``) times the B
    value at that place of ``operand_queries(..., wgmma_qd)`` summed
    over all of them is ``q · x`` for random int8 rows and bf16 queries
    (in float64, where every product and sum here is exact)."""
    rng = np.random.default_rng(d)
    x = rng.integers(-128, 128, size=(9, d)).astype(np.int8)
    q = torch.as_tensor(rng.normal(size=(5, d)).astype(np.float32))
    qd = -(-d // QD_STEP) * QD_STEP
    op = scan_kernel.operand_queries(q, "bf16", torch.int8, qd)
    assert op.dtype == torch.bfloat16 and op.shape == (5, qd)
    assert op.is_contiguous() and op.data_ptr() % 16 == 0
    b = op.double().numpy()
    xp = np.zeros((9, qd))
    xp[:, :d] = x  # the TMA box writes zeros past d
    depth = _lane_depths()
    got = np.zeros((9, 5))
    for s in range(qd // 64):
        for j in range(4):
            a = xp[:, 64 * s + depth[j]]  # (rows, k')
            got += a @ b[:, 64 * s + 16 * j : 64 * s + 16 * j + 16].T
    want = x.astype(np.float64) @ q.bfloat16().double().numpy().T
    np.testing.assert_array_equal(got, want)


def test_wgmma_layout_pads_and_keeps_the_other_layouts():
    """The wgmma rows are the bf16 queries zero-padded to the width asked
    for and permuted per 64-group; a width below d or not a multiple of
    64 is refused; without one the layout is the mma.sync body's."""
    q = torch.as_tensor(np.random.default_rng(3).normal(size=(4, 80)).astype(np.float32))
    for bad in (64, 96):
        with pytest.raises(ValueError):
            scan_kernel.operand_queries(q, "bf16", torch.int8, bad)
    op = scan_kernel.operand_queries(q, "bf16", torch.int8, 128)
    flat = torch.zeros((4, 128), dtype=torch.bfloat16)
    flat[:, :80] = q.bfloat16()
    order = list(scan_kernel.WGMMA_ORDER)
    expect = flat.reshape(4, 2, 64)[:, :, order].reshape(4, 128)
    assert torch.equal(op, expect)
    old = scan_kernel.operand_queries(q, "bf16", torch.int8)
    assert old.shape == (4, 80)
    assert torch.equal(old, q.bfloat16().reshape(4, 5, 16)[:, :, list(scan_kernel.WIDEN_ORDER)]
                       .reshape(4, 80))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_length_counts_the_wgmma_blocks_m_tiles(seed):
    """The split's cost model for the wgmma body: a pair's 128 slots are
    two blocks of 64, each computing its m-tiles up to its last live one
    (its wgmma's width); the segment keeps the heaviest block within the
    share of a slot's fair share, and a block with no live slot costs
    nothing."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 60, 25)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    pair_bucket = rng.integers(0, 25, 40)
    live = rng.integers(0, 256, 40)
    live[:5] = [0b1, 0b1000, 0b10000, 0b10000000, 0b10001001]
    slots = 132
    seg = scan_kernel.segment_length(ptr, pair_bucket, live, width=32, slots=slots,
                                     wgmma_block=64)
    blocks = np.zeros((40, 2), np.int64)
    for p in range(40):
        for blk in range(2):
            bits = [(live[p] >> (4 * blk + m)) & 1 for m in range(4)]
            blocks[p, blk] = max((m + 1 for m in range(4) if bits[m]), default=0)
    np.testing.assert_array_equal(blocks[:5], [[1, 0], [4, 0], [0, 1], [0, 4], [4, 4]])
    chunks = counts[pair_bucket]
    fair = (chunks[:, None] * blocks).sum() / slots
    heaviest = blocks[chunks > 0].max()
    assert seg >= 1
    if seg > 1:
        assert seg * heaviest <= scan_kernel.SEGMENT_SHARE * fair
    assert (seg + 1) * heaviest > scan_kernel.SEGMENT_SHARE * fair
    assert scan_kernel.segment_length(ptr, pair_bucket, np.zeros(40, np.int64), width=32,
                                      slots=slots, wgmma_block=64) == chunks.max()


def _f32_lane_depths():
    """For k-step j of a 32-depth f32 box, lane quad index t and the
    register half (k' of the m64nNk16 A fragment), the store depth within
    the box that the kernel's lane rounds into that place: in k-step j
    lane t reads the 16-byte chunk 2t + j of its rows (values 4(2t + j) ..
    4(2t + j) + 3), value i of it into k' = 2t + i (i < 2) or 2t + 8 +
    (i - 2)."""
    depth = np.full((2, 16), -1)
    for j in range(2):
        for t in range(4):
            for i in range(4):
                kk = 2 * t + i if i < 2 else 2 * t + 8 + (i - 2)
                depth[j, kk] = 4 * (2 * t + j) + i
    return depth


def _swizzled_chunk(row, chunk):
    """Where TMA's 128-byte swizzle puts 16-byte chunk ``chunk`` of a box's
    row ``row`` (rows of 128 bytes, the box on 1024 bytes): address bits
    4-6 XOR bits 7-9."""
    return chunk ^ (row % 8)


def test_wgmma_f32_order_is_the_lanes_depth_map():
    """Position 16j + k' of each 32-group of the laid-out queries holds
    the depth that the A register at (k-step j, k') holds; every depth of
    the group appears once; and the chunks a quarter-warp reads (rows g,
    g + 1 of a warp's 16, lanes t = 0..3) in each k-step are eight
    distinct 16-byte chunks of the swizzled box, all 32 banks."""
    depth = _f32_lane_depths()
    np.testing.assert_array_equal(np.asarray(scan_kernel.WGMMA_F32_ORDER), depth.reshape(-1))
    assert sorted(scan_kernel.WGMMA_F32_ORDER) == list(range(32))
    for warp in range(4):
        for j in range(2):
            for half in (0, 8):  # rows g and g + 8 of the lane
                for g0 in range(0, 8, 2):
                    banks = set()
                    for g in (g0, g0 + 1):
                        row = 16 * warp + g + half
                        for t in range(4):
                            banks.add(_swizzled_chunk(row, 2 * t + j))
                    assert banks == set(range(8)), (warp, j, half, g0)


def _bf16_rne(x: np.ndarray) -> np.ndarray:
    """f32 rounded to the nearest bf16, ties to even (cvt.rn.bf16x2.f32),
    by bit arithmetic: the values the kernel's A registers hold."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def test_bf16_rounding_is_round_to_nearest_even():
    """The rounding the kernel applies to f32 rows (cvt.rn.bf16x2.f32,
    modelled by ``_bf16_rne``) is the plain version's ``.to(bfloat16)``,
    ties (exactly halfway, odd and even) included."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=4096).astype(np.float32) * np.float32(2.0) ** rng.integers(-30, 30, 4096)
    halfway = (rng.integers(0, 2**16, 512, dtype=np.uint32) << 16) | 0x8000
    x = np.concatenate([x, halfway.view(np.float32), -halfway.view(np.float32)])
    x = x[np.isfinite(x)]
    want = torch.as_tensor(x).bfloat16().float().numpy()
    np.testing.assert_array_equal(_bf16_rne(x).view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("d", [768, 800, 96, 100, 40, 16, 896])
def test_wgmma_f32_model_contracts_to_the_dot_product(d):
    """The body over f32 rows, modelled lane by lane: for every stage,
    box, k-step and k', the store value at ``_f32_lane_depths``' place,
    rounded to nearest even bf16, times the B value at that place of
    ``operand_queries(..., float32, wgmma_qd)``, summed over all of them,
    is ``bf16(x) · bf16(q)`` (float64, where each product and sum here is
    exact), for f32 rows of several magnitudes and bf16 queries."""
    rng = np.random.default_rng(d)
    x = (rng.normal(size=(9, d)) * 2.0 ** rng.integers(-6, 6, size=(9, 1))).astype(np.float32)
    q = torch.as_tensor(rng.normal(size=(5, d)).astype(np.float32))
    qd = -(-d // QD_STEP_F32) * QD_STEP_F32
    op = scan_kernel.operand_queries(q, "bf16", torch.float32, qd)
    assert op.dtype == torch.bfloat16 and op.shape == (5, qd)
    assert op.is_contiguous() and op.data_ptr() % 16 == 0
    b = op.double().numpy()
    xp = np.zeros((9, qd), np.float32)
    xp[:, :d] = x  # the TMA box writes zeros past d
    xr = _bf16_rne(xp).astype(np.float64)
    depth = _f32_lane_depths()
    got = np.zeros((9, 5))
    for box in range(qd // 32):
        for j in range(2):
            a = xr[:, 32 * box + depth[j]]  # (rows, k')
            got += a @ b[:, 32 * box + 16 * j : 32 * box + 16 * j + 16].T
    want = torch.as_tensor(x).bfloat16().double().numpy() @ q.bfloat16().double().numpy().T
    np.testing.assert_array_equal(got, want)


def test_wgmma_f32_layout_pads_and_keeps_the_other_layouts():
    """Over an f32 store the wgmma rows are the bf16 queries zero-padded
    to the width asked for and permuted per 32-group; a width below d or
    not a multiple of 64 is refused; without one the layout is the
    mma.sync body's (bf16 padded to 16, no permutation), and the int8
    store's wgmma layout keeps its 64-groups."""
    q = torch.as_tensor(np.random.default_rng(4).normal(size=(4, 100)).astype(np.float32))
    for bad in (64, 96):
        with pytest.raises(ValueError):
            scan_kernel.operand_queries(q, "bf16", torch.float32, bad)
    op = scan_kernel.operand_queries(q, "bf16", torch.float32, 128)
    flat = torch.zeros((4, 128), dtype=torch.bfloat16)
    flat[:, :100] = q.bfloat16()
    order = list(scan_kernel.WGMMA_F32_ORDER)
    assert torch.equal(op, flat.reshape(4, 4, 32)[:, :, order].reshape(4, 128))
    old = scan_kernel.operand_queries(q, "bf16", torch.float32)
    assert old.shape == (4, 112) and torch.equal(old[:, :100], q.bfloat16())
    assert not old[:, 100:].any()
    i8 = scan_kernel.operand_queries(q, "bf16", torch.int8, 128)
    assert torch.equal(i8, flat.reshape(4, 2, 64)[:, :, list(scan_kernel.WGMMA_ORDER)]
                       .reshape(4, 128))


# f32 queries over an int8 store (the wgmma body in f32 mode): the bytes of
# one k-step of a block's resident planes (W3_KSTEP in csrc/scan_pairs.cu:
# the three terms of 32 query slots, 16 depths, bf16)
W3_KSTEP = 3 * 32 * 16 * 2


def test_wgmma_f32mode_layout_pads_and_keeps_the_other_layouts():
    """In mode f32 the wgmma rows are the three terms of split_f32, each
    zero-padded to the width asked for and permuted per 64-group in
    WGMMA_ORDER, as planes side by side (hi, mid, lo); a width below d
    or not a multiple of 64 is refused; without one the layout is the
    mma.sync body's (the three terms of each 32-value slice side by side)."""
    q = torch.as_tensor(np.random.default_rng(6).normal(size=(4, 100)).astype(np.float32))
    for bad in (64, 96):
        with pytest.raises(ValueError):
            scan_kernel.operand_queries(q, "f32", torch.int8, bad)
    op = scan_kernel.operand_queries(q, "f32", torch.int8, 128)
    assert op.dtype == torch.bfloat16 and op.shape == (4, 3 * 128)
    assert op.is_contiguous() and op.data_ptr() % 16 == 0
    order = list(scan_kernel.WGMMA_ORDER)
    planes = []
    for term in scan_kernel.split_f32(q):
        flat = torch.zeros((4, 128), dtype=torch.bfloat16)
        flat[:, :100] = term
        planes.append(flat.reshape(4, 2, 64)[:, :, order].reshape(4, 128))
    assert torch.equal(op, torch.cat(planes, dim=1))
    old = scan_kernel.operand_queries(q, "f32", torch.int8)
    assert old.shape == (4, 3 * 128)
    slices = [p.reshape(4, 2, 64)[:, :, list(np.argsort(order))].reshape(4, 4, 32)
              for p in planes]
    widened = torch.stack(slices, dim=2).reshape(4, 4, 3, 2, 16)
    widened = widened[..., list(scan_kernel.WIDEN_ORDER)].reshape(4, 3 * 128)
    assert torch.equal(old, widened)


def _resident_planes(op: torch.Tensor, cols: int, qd: int, kstep: int = W3_KSTEP,
                     dtype=np.float64) -> np.ndarray:
    """A block's resident query tile as the kernel writes it (``wgmma_begin``),
    in bf16 elements: slot n's plane ``term`` (values ``term·qd ..`` of its
    operand row) is column ``c = term·cols + n``, whose 8-depth piece p sits
    at byte (p >> 1)·kstep + (c >> 3)·256 + (p & 1)·128 + (c & 7)·16
    (``kstep``: the bytes of a k-step of the block's three planes)."""
    rows = op.double().numpy().astype(dtype)
    smem = np.zeros(qd // 16 * kstep // 2, dtype)
    for term in range(3):
        for n in range(rows.shape[0]):
            c = term * cols + n
            for piece in range(qd // 8):
                at = ((piece >> 1) * kstep + (c >> 3) * 256 + (piece & 1) * 128
                      + (c & 7) * 16) // 2
                smem[at : at + 8] = rows[n, term * qd + 8 * piece : term * qd + 8 * piece + 8]
    return smem


def _b_tile(smem: np.ndarray, j: int, width: int, kstep: int = W3_KSTEP) -> np.ndarray:
    """The (16, width) B operand that wgmma reads for k-step ``j`` through
    the body's descriptor (K-major, no swizzle: core matrices of 8 columns
    × 8 depths, the two 8-deep halves 128 bytes apart, 8-column groups 256
    bytes apart): the first ``width`` columns of the block's planes."""
    kk = np.arange(16)[:, None]
    c = np.arange(width)[None, :]
    at = (j * kstep + (c >> 3) * 256 + (kk >> 3) * 128 + (c & 7) * 16) // 2 + (kk & 7)
    return smem[at]


def _f32mode_stage_sums(x: np.ndarray, op: torch.Tensor, cols: int, qd: int) -> np.ndarray:
    """The body's wgmma, lane by lane: for each ring stage (two boxes of 64
    int8 depths, 8 k-steps) the products of the rows' A fragments
    (``_lane_depths``: word j of box b widens into k-step 4b + j) with the
    B tile of the block's 3·cols columns, summed over the stage in float64
    (exact here): ``(stages, rows, 3·cols)``, the fresh sums that the body
    folds into its running sum."""
    xp = np.zeros((x.shape[0], qd))
    xp[:, : x.shape[1]] = x  # the TMA box writes zeros past d
    depth = _lane_depths()
    smem = _resident_planes(op, cols, qd)
    out = np.zeros((qd // 128, x.shape[0], 3 * cols))
    for st in range(qd // 128):
        for ks in range(8):
            box, j = 2 * st + ks // 4, ks % 4
            out[st] += xp[:, 64 * box + depth[j]] @ _b_tile(smem, 8 * st + ks, 3 * cols)
    return out


@pytest.mark.parametrize("d,n", [(96, 32), (768, 32), (896, 32), (768, 9), (100, 16)])
def test_wgmma_f32mode_model_contracts_to_the_three_term_product(d, n):
    """The f32-mode body, modelled from the operand rows through the block's
    resident planes to the A and B fragments of each k-step: summed over
    the stages, each term's column of slot n is ``x · term`` and the three
    together are ``x · (hi + mid + lo)``, which is ``x · q`` exactly (the
    split is exact at these magnitudes), for random int8 rows; columns of
    slots past the queries are zero.  ``n`` queries in a block of two
    m-tiles (32 columns a plane) or one (16, wgmma n48)."""
    rng = np.random.default_rng(d + n)
    x = rng.integers(-128, 128, size=(9, d)).astype(np.int8)
    q = torch.as_tensor((rng.normal(size=(n, d)) * 2.0 ** rng.integers(-8, 8, (n, 1)))
                        .astype(np.float32))
    qd = -(-d // QD_STEP) * QD_STEP
    cols = 16 * -(-n // 16)
    op = scan_kernel.operand_queries(q, "f32", torch.int8, qd)
    sums = _f32mode_stage_sums(x, op, cols, qd)
    total = sums.sum(axis=0)
    hi, mid, lo = (t.double().numpy() for t in scan_kernel.split_f32(q))
    xd = x.astype(np.float64)
    for term, plane in enumerate((hi, mid, lo)):
        np.testing.assert_array_equal(total[:, term * cols : term * cols + n], xd @ plane.T)
        assert not total[:, term * cols + n : (term + 1) * cols].any()
    three = sum(total[:, t * cols : t * cols + n] for t in range(3))
    np.testing.assert_array_equal(three, xd @ q.double().numpy().T)


def _f32mode_raw(x: np.ndarray, q: torch.Tensor) -> np.ndarray:
    """raw = x · q as the body rounds it, ``(rows, queries)`` f32: each ring
    stage's sum of each term (128 depths; exact in float64, then f32, where
    the tensor cores truncate: the model rounds) folded into the running
    sum as lo + mid, + hi, + the running sum, each add rounded to the
    nearest f32 (``fold_terms``)."""
    d = x.shape[1]
    terms = [t.double().numpy() for t in scan_kernel.split_f32(q)]
    xd = x.astype(np.float64)
    acc = np.zeros((x.shape[0], q.shape[0]), np.float32)
    for s0 in range(0, d, 128):
        hi, mid, lo = ((xd[:, s0 : s0 + 128] @ t[:, s0 : s0 + 128].T).astype(np.float32)
                       for t in terms)
        acc = acc + ((lo + mid) + hi)
    return acc


@pytest.mark.parametrize("d,k,qtile", [(96, 16, 16), (768, 32, 8), (896, 10, 32)])
def test_wgmma_f32mode_model_matches_pallas_f32_scan(d, k, qtile):
    """The f32-mode body's rounded sums (``_f32mode_raw``), as distances
    ``1 − raw·scale`` in f32 over an int8 packed store, give each real
    query's top-k over its pair's bucket within the parity bar of the JAX
    package's f32 (Precision.HIGHEST) Pallas scan of the same seeded
    inputs in interpret mode: rtol 1e-4, atol 1e-5, slots differing only
    at ties (rtol 1e-6, atol 1e-7), as tests/test_scan_kernel.py holds
    the Pallas kernel to the XLA path."""
    import jax.numpy as jnp

    from learnedmetricindex_tpu.data import synthetic_blobs
    from learnedmetricindex_tpu.index.bucket_store import BucketStore as JaxStore
    from learnedmetricindex_tpu.index.bucket_store import build_scan_plan
    from learnedmetricindex_tpu.ops.scan_kernel import pallas_host_args, pallas_scan_pairs
    from learnedmetricindex_tpu_torch.index.bucket_store import build_plan
    from learnedmetricindex_tpu_torch.ops.select import smallest_k

    n, nb, chunk, nq = 500, 4, 64, 40
    data, queries = synthetic_blobs(n, d, nq, seed=d)
    rng = np.random.default_rng(d)
    store = JaxStore.build_packed_int8(data, rng.integers(0, nb, size=n), nb, chunk=chunk)
    order = np.stack([rng.choice(nb, size=2, replace=False) for _ in range(nq)]).astype(np.int64)
    order[rng.random(nq) < 0.3, -1] = -1
    plan = build_scan_plan(store, order, qtile=qtile)
    n_pairs = len(plan.qidx) // qtile
    im, ic, wr, sf, written = pallas_host_args(store, plan, qtile, n_pairs)
    qidx = jnp.asarray(plan.qidx)
    wq = jnp.where((qidx >= 0)[:, None], jnp.asarray(queries)[jnp.maximum(qidx, 0)], 0.0)
    jd, js = pallas_scan_pairs(
        wq, jnp.asarray(im), jnp.asarray(ic), jnp.asarray(wr), store.chunk_data,
        jnp.asarray(sf), None, k=k, qtile=qtile, chunk=chunk, n_pairs=n_pairs,
        compute="f32", interpret=True)
    jd, js = np.asarray(jd)[:n_pairs], np.asarray(js)[:n_pairs]
    sf = np.asarray(sf)
    raw = _f32mode_raw(np.asarray(store.chunk_data), torch.as_tensor(queries))
    dist = (raw * -sf[:, None]).astype(np.float32) + np.where(sf == 0.0, np.inf, 1.0)[:, None]
    dist = torch.as_tensor(dist.astype(np.float32).T)  # (queries, slots)
    pplan = build_plan(torch.as_tensor(order), nb, qtile)
    assert pplan.n_pairs == n_pairs
    ptr = store.bucket_chunk_start
    pb = pplan.pair_bucket.numpy()
    real = (plan.qidx >= 0).reshape(-1, qtile)
    checked = 0
    for p in range(n_pairs):
        if not written[p]:
            continue
        b = int(pb[p])
        slots = torch.arange(int(ptr[b]) * chunk, int(ptr[b + 1]) * chunk)
        for j in np.nonzero(real[p])[0]:
            qi = int(plan.qidx[p * qtile + j])
            vals, pos = smallest_k(dist[qi, slots][None, :], min(k, len(slots)))
            md = np.full(k, np.inf, np.float32)
            ms = np.full(k, -1, np.int64)
            md[: vals.shape[1]] = vals[0].numpy()
            ms[: vals.shape[1]] = np.where(np.isinf(md[: vals.shape[1]]), -1, slots[pos[0]].numpy())
            o = np.lexsort((js[p, j], jd[p, j]))
            np.testing.assert_allclose(md, jd[p, j][o], rtol=1e-4, atol=1e-5)
            mism = ms != js[p, j][o]
            if mism.any():
                np.testing.assert_allclose(md[mism], jd[p, j][o][mism], rtol=1e-6, atol=1e-7)
            checked += 1
    assert checked > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_length_counts_the_f32mode_blocks_m_tiles(seed):
    """The split's cost model for the f32-mode body: a pair's 128 slots are
    four blocks of 32, each computing its m-tiles up to its last live one
    (its wgmma's width, three planes of them); the segment keeps the
    heaviest block within the share of a slot's fair share, and a block
    with no live slot costs nothing."""
    rng = np.random.default_rng(seed + 10)
    counts = rng.integers(0, 60, 25)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    pair_bucket = rng.integers(0, 25, 40)
    live = rng.integers(0, 256, 40)
    live[:4] = [0b1, 0b10, 0b100, 0b10000010]
    slots = 132
    seg = scan_kernel.segment_length(ptr, pair_bucket, live, width=32, slots=slots,
                                     wgmma_block=32)
    blocks = np.zeros((40, 4), np.int64)
    for p in range(40):
        for blk in range(4):
            bits = [(live[p] >> (2 * blk + m)) & 1 for m in range(2)]
            blocks[p, blk] = max((m + 1 for m in range(2) if bits[m]), default=0)
    np.testing.assert_array_equal(blocks[:4], [[1, 0, 0, 0], [2, 0, 0, 0], [0, 1, 0, 0],
                                               [2, 0, 0, 2]])
    chunks = counts[pair_bucket]
    fair = (chunks[:, None] * blocks).sum() / slots
    heaviest = blocks[chunks > 0].max()
    assert seg >= 1
    if seg > 1:
        assert seg * heaviest <= scan_kernel.SEGMENT_SHARE * fair
    assert (seg + 1) * heaviest > scan_kernel.SEGMENT_SHARE * fair
    assert scan_kernel.segment_length(ptr, pair_bucket, np.zeros(40, np.int64), width=32,
                                      slots=slots, wgmma_block=32) == chunks.max()


# f32 queries over an f32 store (the six-term wgmma body): its block's query
# slots (WQX in csrc/scan_pairs.cu) and the bytes of one k-step of its
# resident planes (WX_KSTEP); its folds span two 32-depth boxes, 64 depths
X_SLOTS = 32
X_KSTEP = 3 * X_SLOTS * 16 * 2
X_FOLD = 64


def test_wgmma_f32x_layout_pads_and_keeps_the_other_layouts():
    """In mode f32 over an f32 store the wgmma rows are the three terms of
    split_f32, each zero-padded to the width asked for and permuted per
    32-group in WGMMA_F32_ORDER, as planes side by side (hi, mid, lo); a
    width below d or not a multiple of 64 is refused; without one the
    layout is the mma.sync body's over an f32 store (the three terms of each
    32-value slice side by side, unpermuted), and the f32-mode layout over
    an int8 store keeps its 64-groups in WGMMA_ORDER."""
    q = torch.as_tensor(np.random.default_rng(8).normal(size=(4, 100)).astype(np.float32))
    for bad in (64, 96, 160):
        with pytest.raises(ValueError):
            scan_kernel.operand_queries(q, "f32", torch.float32, bad)
    for qd in (128, 192):
        op = scan_kernel.operand_queries(q, "f32", torch.float32, qd)
        assert op.dtype == torch.bfloat16 and op.shape == (4, 3 * qd)
        assert op.is_contiguous() and op.data_ptr() % 16 == 0
        order = list(scan_kernel.WGMMA_F32_ORDER)
        planes = []
        for term in scan_kernel.split_f32(q):
            flat = torch.zeros((4, qd), dtype=torch.bfloat16)
            flat[:, :100] = term
            planes.append(flat.reshape(4, qd // 32, 32)[:, :, order].reshape(4, qd))
        assert torch.equal(op, torch.cat(planes, dim=1))
    old = scan_kernel.operand_queries(q, "f32", torch.float32)
    assert old.shape == (4, 3 * 128)
    terms = []
    for term in scan_kernel.split_f32(q):
        flat = torch.zeros((4, 128), dtype=torch.bfloat16)
        flat[:, :100] = term
        terms.append(flat.reshape(4, 4, 32))
    assert torch.equal(old, torch.stack(terms, dim=2).reshape(4, 3 * 128))
    i8 = scan_kernel.operand_queries(q, "f32", torch.int8, 128)
    assert not torch.equal(i8, scan_kernel.operand_queries(q, "f32", torch.float32, 128))
    assert torch.equal(i8[:, :128].reshape(4, 2, 64)[:, :, list(np.argsort(
        scan_kernel.WGMMA_ORDER))].reshape(4, 128)[:, :100], scan_kernel.split_f32(q)[0])


def _truncated_terms(x: np.ndarray):
    """The kernel's split of f32 store values (split_pair, split3): hi the
    top 16 bits of x, mid those of x − hi, lo those of what is left, each
    subtraction exact in f32."""
    def top16(v):
        return (v.astype(np.float32).view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)

    x = x.astype(np.float32)
    hi = top16(x)
    rest = x - hi
    mid = top16(rest)
    return hi, mid, top16(rest - mid)


def _f32x_fold_sums(x: np.ndarray, op: torch.Tensor, cols: int, qd: int, exact: bool):
    """The six-term body, lane by lane, over f32 rows ``x``: for each box (32
    depths; TMA writes zeros past d) and k-step j of it, the A fragments of
    the three store terms at ``_f32_lane_depths``' places (truncation
    split), and per k-step six wgmma m64nNk16 (N = cols), each over one
    plane of the resident B tile (the descriptor ``term·cols / 8`` column
    groups in): x_hi · q_hi into the large sum; x_lo · q_hi, x_mid · q_mid,
    x_mid · q_hi, x_hi · q_lo and x_hi · q_mid into the small sum; a pair of
    sums a fold of two boxes (64 depths).  ``exact``: in Python integers
    (the terms scaled to integers, products and sums exact), else in
    float64.  Returns ``(folds, 2, rows, cols)``: large, small."""
    xp = np.zeros((x.shape[0], qd), np.float32)
    xp[:, : x.shape[1]] = x
    terms = _truncated_terms(xp)
    smem = _resident_planes(op, cols, qd, X_KSTEP)
    if exact:  # every term here is a multiple of 2**-30
        terms = [(t.astype(np.float64) * 2.0**30).astype(np.int64).astype(object) for t in terms]
        smem = (smem * 2.0**30).astype(np.int64).astype(object)
    else:
        terms = [t.astype(np.float64) for t in terms]
    depth = _f32_lane_depths()
    out = np.zeros((qd // X_FOLD, 2, x.shape[0], cols), object if exact else np.float64)
    # (store term, query plane, sum) of each wgmma of a k-step, in issue order
    six = ((0, 0, 0), (2, 0, 1), (1, 1, 1), (1, 0, 1), (0, 2, 1), (0, 1, 1))
    for kk in range(qd // 16):
        box, j = kk // 2, kk % 2
        at = 32 * box + depth[j]
        b = _b_tile(smem, kk, 3 * cols, X_KSTEP)
        for term, plane, which in six:
            out[kk // 4, which] += terms[term][:, at] @ b[:, plane * cols : (plane + 1) * cols]
    return out


def _dyadic(rng, shape):
    """f32 values of random sign, mantissa and exponent (2**-3 .. 2**3), some
    zero: every truncated and rounded bf16 term of them a multiple of 2**-30."""
    v = (rng.integers(2**23, 2**24, shape) * 2.0 ** (rng.integers(-3, 3, shape) - 23.0)
         * rng.choice([-1.0, 1.0], shape))
    v[rng.random(shape) < 0.05] = 0.0
    return v.astype(np.float32)


@pytest.mark.parametrize("d,n", [(768, 32), (896, 32), (100, 16), (16, 9), (768, 20)])
def test_wgmma_f32x_model_contracts_to_the_six_term_product(d, n):
    """The six-term body, modelled from the operand rows through the block's
    resident planes and the lanes' truncation split to the six wgmma of
    each k-step (``_f32x_fold_sums``, exact in integers): summed over the
    folds, the large sum's column of slot n is ``x_hi · q_hi`` and the
    small sum's the other five products of ``mma_six``, ``x_lo · q_hi +
    x_mid · (q_hi + q_mid) + x_hi · (q_mid + q_lo)``; together the six
    products and no others, which are ``x · q`` but for the three dropped
    ones; columns of slots past the queries are zero.  ``n`` queries in a
    block of two m-tiles (32 columns a plane) or one."""
    rng = np.random.default_rng(d + n)
    x = _dyadic(rng, (9, d))
    q = torch.as_tensor(_dyadic(rng, (n, d)))
    qd = -(-d // QD_STEP_F32) * QD_STEP_F32
    cols = 16 * -(-n // 16)
    op = scan_kernel.operand_queries(q, "f32", torch.float32, qd)
    large, small = _f32x_fold_sums(x, op, cols, qd, exact=True).sum(axis=0)

    def ints(t):
        return (np.asarray(t, np.float64) * 2.0**30).astype(np.int64).astype(object)

    xh, xm, xl = (ints(t) for t in _truncated_terms(x))
    qh, qm, ql = (ints(t.double().numpy()) for t in scan_kernel.split_f32(q))
    want_small = xl @ qh.T + xm @ (qh + qm).T + xh @ (qm + ql).T
    np.testing.assert_array_equal(large[:, :n], xh @ qh.T)
    np.testing.assert_array_equal(small[:, :n], want_small)
    assert not large[:, n:].any() and not small[:, n:].any()
    # the six products are x · q but for the three that the body drops
    dropped = xm @ ql.T + xl @ qm.T + xl @ ql.T
    np.testing.assert_array_equal(large[:, :n] + small[:, :n] + dropped,
                                  ints(x) @ ints(q.numpy()).T)
    assert (np.abs(dropped.astype(float)) > 0).any()


def _f32x_raw(x: np.ndarray, q: torch.Tensor) -> np.ndarray:
    """raw = x · q as the six-term body rounds it, ``(rows, queries)`` f32:
    each fold's (64 depths) large and small sums in float64, then f32 (where
    the tensor cores truncate: the model rounds), folded into the running
    sum as small + large, + the running sum, each add rounded to the
    nearest f32 (``fold_two``); the queries in blocks of X_SLOTS."""
    qd = -(-x.shape[1] // QD_STEP_F32) * QD_STEP_F32
    out = []
    for q0 in range(0, q.shape[0], X_SLOTS):
        qb = q[q0 : q0 + X_SLOTS]
        n, cols = qb.shape[0], 16 * -(-qb.shape[0] // 16)
        op = scan_kernel.operand_queries(qb, "f32", torch.float32, qd)
        acc = np.zeros((x.shape[0], n), np.float32)
        for large, small in _f32x_fold_sums(x, op, cols, qd, exact=False):
            acc = acc + (small[:, :n].astype(np.float32) + large[:, :n].astype(np.float32))
        out.append(acc)
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("d,k,qtile", [(96, 16, 16), (768, 32, 8), (100, 10, 32)])
def test_wgmma_f32x_model_matches_pallas_f32_scan(d, k, qtile):
    """The six-term body's rounded sums (``_f32x_raw``), as distances ``1 −
    raw·scale`` in f32 over an f32 packed store, give each real query's
    top-k over its pair's bucket within the parity bar of the JAX package's
    f32 (Precision.HIGHEST) Pallas scan of the same seeded inputs over an
    f32 store in interpret mode: rtol 1e-4, atol 1e-5, slots differing only
    at ties (rtol 1e-6, atol 1e-7), as tests/test_scan_kernel.py holds the
    Pallas kernel to the XLA path."""
    import jax.numpy as jnp

    from learnedmetricindex_tpu.data import synthetic_blobs
    from learnedmetricindex_tpu.index.bucket_store import BucketStore as JaxStore
    from learnedmetricindex_tpu.index.bucket_store import build_scan_plan
    from learnedmetricindex_tpu.ops.scan_kernel import pallas_host_args, pallas_scan_pairs
    from learnedmetricindex_tpu_torch.index.bucket_store import build_plan
    from learnedmetricindex_tpu_torch.ops.select import smallest_k

    n, nb, chunk, nq = 400, 4, 64, 36
    data, queries = synthetic_blobs(n, d, nq, seed=d + 1)
    rng = np.random.default_rng(d + 1)
    store = JaxStore.build(data, rng.integers(0, nb, size=n), nb, chunk=chunk)
    order = np.stack([rng.choice(nb, size=2, replace=False) for _ in range(nq)]).astype(np.int64)
    order[rng.random(nq) < 0.3, -1] = -1
    plan = build_scan_plan(store, order, qtile=qtile)
    n_pairs = len(plan.qidx) // qtile
    im, ic, wr, sf, written = pallas_host_args(store, plan, qtile, n_pairs)
    qidx = jnp.asarray(plan.qidx)
    wq = jnp.where((qidx >= 0)[:, None], jnp.asarray(queries)[jnp.maximum(qidx, 0)], 0.0)
    jd, js = pallas_scan_pairs(
        wq, jnp.asarray(im), jnp.asarray(ic), jnp.asarray(wr), store.chunk_data,
        jnp.asarray(sf), None, k=k, qtile=qtile, chunk=chunk, n_pairs=n_pairs,
        compute="f32", interpret=True)
    jd, js = np.asarray(jd)[:n_pairs], np.asarray(js)[:n_pairs]
    sf = np.asarray(sf)
    raw = _f32x_raw(np.asarray(store.chunk_data), torch.as_tensor(queries))
    dist = (raw * -sf[:, None]).astype(np.float32) + np.where(sf == 0.0, np.inf, 1.0)[:, None]
    dist = torch.as_tensor(dist.astype(np.float32).T)  # (queries, slots)
    pplan = build_plan(torch.as_tensor(order), nb, qtile)
    assert pplan.n_pairs == n_pairs
    ptr = store.bucket_chunk_start
    pb = pplan.pair_bucket.numpy()
    real = (plan.qidx >= 0).reshape(-1, qtile)
    checked = 0
    for p in range(n_pairs):
        if not written[p]:
            continue
        b = int(pb[p])
        slots = torch.arange(int(ptr[b]) * chunk, int(ptr[b + 1]) * chunk)
        for j in np.nonzero(real[p])[0]:
            qi = int(plan.qidx[p * qtile + j])
            vals, pos = smallest_k(dist[qi, slots][None, :], min(k, len(slots)))
            md = np.full(k, np.inf, np.float32)
            ms = np.full(k, -1, np.int64)
            md[: vals.shape[1]] = vals[0].numpy()
            ms[: vals.shape[1]] = np.where(np.isinf(md[: vals.shape[1]]), -1, slots[pos[0]].numpy())
            o = np.lexsort((js[p, j], jd[p, j]))
            np.testing.assert_allclose(md, jd[p, j][o], rtol=1e-4, atol=1e-5)
            mism = ms != js[p, j][o]
            if mism.any():
                np.testing.assert_allclose(md[mism], jd[p, j][o][mism], rtol=1e-6, atol=1e-7)
            checked += 1
    assert checked > 0


@pytest.mark.parametrize("block", [X_SLOTS, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_length_counts_the_f32x_blocks_m_tiles(block, seed):
    """The split's cost model for the six-term body: a pair's 128 slots are
    blocks of its ``block`` query slots (32, four blocks; or 16, eight
    blocks of one m-tile, the other design), each computing its m-tiles up
    to its last live one; the segment keeps the heaviest block within the
    share of a slot's fair share, and a block with no live slot costs
    nothing."""
    rng = np.random.default_rng(seed + 30)
    counts = rng.integers(0, 70, 28)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    pair_bucket = rng.integers(0, 28, 45)
    live = rng.integers(0, 256, 45)
    live[:4] = [0b1, 0b100, 0b10000001, 0]
    slots = 132
    seg = scan_kernel.segment_length(ptr, pair_bucket, live, width=32, slots=slots,
                                     wgmma_block=block)
    tiles = block // 16
    blocks = np.zeros((45, 8 // tiles), np.int64)
    for p in range(45):
        for blk in range(8 // tiles):
            bits = [(live[p] >> (tiles * blk + m)) & 1 for m in range(tiles)]
            blocks[p, blk] = max((m + 1 for m in range(tiles) if bits[m]), default=0)
    if block == 32:
        np.testing.assert_array_equal(blocks[:4], [[1, 0, 0, 0], [0, 1, 0, 0], [1, 0, 0, 2],
                                                   [0, 0, 0, 0]])
    else:
        np.testing.assert_array_equal(blocks[2], [1, 0, 0, 0, 0, 0, 0, 1])
    chunks = counts[pair_bucket]
    fair = (chunks[:, None] * blocks).sum() / slots
    heaviest = blocks[chunks > 0].max()
    assert seg >= 1
    if seg > 1:
        assert seg * heaviest <= scan_kernel.SEGMENT_SHARE * fair
    assert (seg + 1) * heaviest > scan_kernel.SEGMENT_SHARE * fair
    assert scan_kernel.segment_length(ptr, pair_bucket, np.zeros(45, np.int64), width=32,
                                      slots=slots, wgmma_block=block) == chunks.max()


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_length_counts_the_wide_blocks_m_tiles(width, seed):
    """The split's cost model for the wide-list body (list widths 64 and
    128, k_scan 33 to 128): a pair's 128 slots are two blocks of 64, as
    the library reports them (``Body.block_queries``), each computing its
    m-tiles up to its last live one, whatever the list width; the mma.sync
    body those launches took before cost every live m-tile of a pair in
    one block.  The segment keeps the heaviest block within the share of a
    slot's fair share, and a block with no live slot costs nothing."""
    rng = np.random.default_rng(seed + 20)
    counts = rng.integers(0, 90, 30)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    pair_bucket = rng.integers(0, 30, 50)
    live = rng.integers(0, 256, 50)
    live[:4] = [0b1, 0b10000, 0b10001001, 0]
    slots = 132  # the wide bodies take one block an SM
    seg = scan_kernel.segment_length(ptr, pair_bucket, live, width=width, slots=slots,
                                     wgmma_block=64)
    blocks = np.zeros((50, 2), np.int64)
    for p in range(50):
        for blk in range(2):
            bits = [(live[p] >> (4 * blk + m)) & 1 for m in range(4)]
            blocks[p, blk] = max((m + 1 for m in range(4) if bits[m]), default=0)
    np.testing.assert_array_equal(blocks[:4], [[1, 0], [0, 1], [4, 4], [0, 0]])
    chunks = counts[pair_bucket]
    fair = (chunks[:, None] * blocks).sum() / slots
    heaviest = blocks[chunks > 0].max()
    assert seg >= 1
    if seg > 1:
        assert seg * heaviest <= scan_kernel.SEGMENT_SHARE * fair
    assert (seg + 1) * heaviest > scan_kernel.SEGMENT_SHARE * fair
    # the width does not enter the wide body's cost: both widths cut alike
    other = 192 - width
    assert seg == scan_kernel.segment_length(ptr, pair_bucket, live, width=other, slots=slots,
                                             wgmma_block=64)
    # the mma.sync body's one block a pair: its live m-tiles, all eight slots' worth
    mma = scan_kernel.segment_length(ptr, pair_bucket, live, width=width, slots=slots)
    tiles = ((live[:, None] >> np.arange(8)) & 1).sum(axis=1)
    assert mma == max(1, int(scan_kernel.SEGMENT_SHARE * (chunks * tiles).sum()
                             / (slots * tiles[chunks > 0].max())))


# the wide-list body's tiles: 64 store rows, two 32-row groups of marks
WIDE_ROWS, WIDE_GROUP = 64, 32


def _wide_select(dist: np.ndarray, slot: np.ndarray, tiles, k: int, stale: bool):
    """The wide-list body's selection of one query, modelled step by step:
    ``dist``/``slot`` its distances and slots in the bucket's scan order,
    ``tiles`` the (start, rows) of each 64-row tile in that order (chunk by
    chunk; the two consumer warpgroups take them in turns and the
    hand-over keeps them in that order).  A tile's epilogue marks each
    32-row group holding a distance below the list's k-th as the
    epilogue may read it: after the tile before last (``stale``: the other
    warpgroup may not have selected the tile before yet) or after the tile
    before.  The selection packs the marked groups' rows below the list's
    current k-th in scan order, ranks them by (distance, place in the
    buffer), places each after the entries at or below it and moves each
    entry up by the candidates strictly below it; what lands past k - 1
    drops out.  Returns the list (distances f32, slots)."""
    ld = np.full(k, np.inf, np.float32)
    ls = np.full(k, -1, np.int64)
    kth_before = [ld[k - 1]]  # the k-th after each tile selected so far
    for start, rows in tiles:
        v = dist[start : start + rows]
        mark_kth = kth_before[-2] if stale and len(kth_before) > 1 else kth_before[-1]
        cand = []
        for g0 in range(0, WIDE_ROWS, WIDE_GROUP):
            group = v[g0 : g0 + WIDE_GROUP]
            if group.size and (group < mark_kth).any():
                cand += [r for r in range(g0, min(g0 + WIDE_GROUP, rows))
                         if v[r] < ld[k - 1]]
        if cand:
            cv = v[cand]
            rank = np.array([int(((cv < cv[i]) | ((cv == cv[i]) & (np.arange(len(cv)) < i)))
                                 .sum()) for i in range(len(cv))])
            sorted_c = np.empty_like(cv)
            sorted_c[rank] = cv
            new_d = np.full(k, np.inf, np.float32)
            new_s = np.full(k, -1, np.int64)
            for t in range(k):  # entries: up by the candidates strictly below
                to = t + int(np.searchsorted(sorted_c, ld[t], side="left"))
                if to < k:
                    new_d[to], new_s[to] = ld[t], ls[t]
            for i, r in enumerate(cand):  # candidates: after the entries at or below
                place = rank[i] + int(np.searchsorted(ld, cv[i], side="right"))
                if place < k:
                    new_d[place], new_s[place] = cv[i], slot[start + r]
            ld, ls = new_d, new_s
        kth_before.append(ld[k - 1])
    return ld, ls


def _wide_model_lists(dist_rows: np.ndarray, ptr, chunk_of, chunk: int, pair_bucket,
                      qidx, qtile: int, k: int, stale: bool):
    """``(n_pairs, qtile, k)`` lists of the wide-list body's selection
    (``_wide_select``) over the distances ``dist_rows`` ``(queries,
    slots)`` of each pair's bucket, read chunk by chunk in 64-row tiles;
    padding query slots and empty buckets get the fill."""
    n_pairs = len(pair_bucket)
    out_d = np.full((n_pairs, qtile, k), np.inf, np.float32)
    out_s = np.full((n_pairs, qtile, k), -1, np.int64)
    for p, b in enumerate(pair_bucket):
        chunks = chunk_of[ptr[b] : ptr[b + 1]]
        slots = (chunks[:, None].astype(np.int64) * chunk + np.arange(chunk)).reshape(-1)
        tiles = [(c * chunk + r0, min(WIDE_ROWS, chunk - r0))
                 for c in range(len(chunks)) for r0 in range(0, chunk, WIDE_ROWS)]
        for j in range(qtile):
            qi = qidx[p * qtile + j]
            if qi < 0 or not len(slots):
                continue
            out_d[p, j], out_s[p, j] = _wide_select(dist_rows[qi, slots], slots, tiles, k,
                                                    stale)
    return out_d, out_s


@pytest.mark.parametrize("k,qtile", [(64, 37), (106, 128), (33, 8)])
@pytest.mark.parametrize("stale", [False, True])
def test_wide_selection_model_gives_the_plain_lists(k, qtile, stale):
    """The wide-list body's selection order (64-row tiles taken by two
    warpgroups in turn, the marks against a k-th that may be one tile
    stale, the merge rule, the hand-over keeping the tiles in scan order),
    modelled in numpy over the plain version's distances, gives the plain
    version's lists bit for bit: int8 rows and small integer queries make
    every sum exact (so both see the same distances) and tie often, chunks
    of 96 rows are 1.5 tiles, the last chunk of a bucket holds padding
    slots and one bucket is empty."""
    from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore, scan_inputs

    rng = np.random.default_rng(k + qtile)
    n, d, nb, chunk, nq = 1500, 64, 5, 96, 70
    rows = torch.as_tensor(rng.integers(-4, 5, (n, d)), dtype=torch.int8)
    scales = torch.as_tensor(rng.choice([0.25, 0.5, 1.0], n).astype(np.float32))
    bucket = rng.integers(0, nb, n)
    bucket[bucket == 3] = 1  # bucket 3 empty
    store = BucketStore.build_packed_device(rows, bucket, nb, chunk=chunk, row_scales=scales)
    queries = torch.as_tensor(rng.integers(-3, 4, (nq, d)).astype(np.float32))
    order = torch.as_tensor(np.stack([rng.choice(nb, 2, replace=False) for _ in range(nq)]))
    order[-5:, 1] = -1
    plan, args = scan_inputs(store, queries, order, qtile, "bf16")
    q, qidx, pb, ptr, chunk_of, st, sc = args[:7]
    kw = dict(k=k, qtile=qtile, chunk=chunk, mode="bf16")
    rd, rs = scan_kernel.scan_pairs_reference(*args, **kw)
    x = st.double().numpy()
    raw = (q.bfloat16().double().numpy() @ x.T).astype(np.float32)  # exact integers
    s = sc.numpy()
    dist = raw * -s + np.where(s == 0.0, np.float32(np.inf), np.float32(1.0))
    md, ms = _wide_model_lists(dist.astype(np.float32), ptr.numpy(), chunk_of.numpy(), chunk,
                               pb.numpy(), qidx.numpy(), qtile, k, stale)
    assert np.isfinite(md).sum() > 0 and (ms >= 0).any()
    np.testing.assert_array_equal(md.view(np.uint32), rd.numpy().view(np.uint32))
    np.testing.assert_array_equal(ms, rs.numpy())
    # the ties are real: many lists hold equal finite distances side by side
    fin = np.where(np.isfinite(md), md, np.float32(0.0))
    assert ((np.diff(fin, axis=2) == 0.0) & np.isfinite(md[:, :, 1:])).sum() > 100


@pytest.mark.parametrize("k,qtile", [(64, 16), (106, 8)])
def test_wide_selection_model_matches_pallas_scan(k, qtile):
    """The wide-list body's selection (``_wide_model_lists``, one tile
    stale marks) over bf16 distances ``1 − raw·scale`` (raw: the bf16
    queries against the int8 rows, exact in float64, rounded to f32) gives
    each real query's top-k over its pair's bucket within the bar of the
    JAX package's bf16 Pallas scan of the same seeded inputs in interpret
    mode: rtol 1e-4, atol 1e-5, slots differing only at ties (rtol 1e-6,
    atol 1e-7), as tests/test_scan_kernel.py holds the Pallas kernel to the
    XLA path."""
    import jax.numpy as jnp

    from learnedmetricindex_tpu.data import synthetic_blobs
    from learnedmetricindex_tpu.index.bucket_store import BucketStore as JaxStore
    from learnedmetricindex_tpu.index.bucket_store import build_scan_plan
    from learnedmetricindex_tpu.ops.scan_kernel import pallas_host_args, pallas_scan_pairs
    from learnedmetricindex_tpu_torch.index.bucket_store import build_plan

    n, nb, chunk, nq, d = 600, 4, 96, 40, 64
    data, queries = synthetic_blobs(n, d, nq, seed=k)
    rng = np.random.default_rng(k)
    store = JaxStore.build_packed_int8(data, rng.integers(0, nb, size=n), nb, chunk=chunk)
    order = np.stack([rng.choice(nb, size=2, replace=False) for _ in range(nq)]).astype(np.int64)
    order[rng.random(nq) < 0.3, -1] = -1
    plan = build_scan_plan(store, order, qtile=qtile)
    n_pairs = len(plan.qidx) // qtile
    im, ic, wr, sf, written = pallas_host_args(store, plan, qtile, n_pairs)
    qidx = jnp.asarray(plan.qidx)
    wq = jnp.where((qidx >= 0)[:, None], jnp.asarray(queries)[jnp.maximum(qidx, 0)], 0.0)
    jd, js = pallas_scan_pairs(
        wq, jnp.asarray(im), jnp.asarray(ic), jnp.asarray(wr), store.chunk_data,
        jnp.asarray(sf), None, k=k, qtile=qtile, chunk=chunk, n_pairs=n_pairs,
        compute="bf16", interpret=True)
    jd, js = np.asarray(jd)[:n_pairs], np.asarray(js)[:n_pairs]
    sf = np.asarray(sf)
    qb = torch.as_tensor(queries).bfloat16().double().numpy()
    raw = (qb @ np.asarray(store.chunk_data).astype(np.float64).T).astype(np.float32)
    dist = raw * -sf[None, :] + np.where(sf == 0.0, np.float32(np.inf), np.float32(1.0))
    pplan = build_plan(torch.as_tensor(order), nb, qtile)
    assert pplan.n_pairs == n_pairs
    ptr = np.asarray(store.bucket_chunk_start)
    md, ms = _wide_model_lists(dist.astype(np.float32), ptr, np.arange(ptr[-1]), chunk,
                               pplan.pair_bucket.numpy(), plan.qidx, qtile, k, stale=True)
    real = (plan.qidx >= 0).reshape(-1, qtile)
    checked = 0
    for p in range(n_pairs):
        if not written[p]:
            continue
        for j in np.nonzero(real[p])[0]:
            o = np.lexsort((js[p, j], jd[p, j]))
            np.testing.assert_allclose(md[p, j], jd[p, j][o], rtol=1e-4, atol=1e-5)
            mism = ms[p, j] != js[p, j][o]
            if mism.any():
                np.testing.assert_allclose(md[p, j][mism], jd[p, j][o][mism], rtol=1e-6,
                                           atol=1e-7)
            checked += 1
    assert checked > 0


# the int8 body's resident k-step: 64 query slots × 32 int8 depths
S8_KSTEP = 64 * 32


def _s8_lane_depths():
    """For 32-deep k-step s of a 64-depth box and k' of the m64nNk32 s8 A
    fragment, the store depth within the box that the kernel's lane puts
    there: lane t reads bytes 16t .. 16t+15 of its rows as four words, word
    2s + u into register 2u (+1 for row g + 8) of k-step s, whose byte i the
    fragment holds at k' = 4t + 16u + i (no widening)."""
    depth = np.full((2, 32), -1)
    for s in range(2):
        for t in range(4):
            for u in range(2):
                for i in range(4):
                    depth[s, 4 * t + 16 * u + i] = 16 * t + 4 * (2 * s + u) + i
    return depth


def test_wgmma_s8_order_is_the_lanes_depth_map():
    """Position 32s + k' of each 64-group of the laid-out int8 queries holds
    the depth that the A register at (k-step s, k') holds, and every depth
    of the group appears once."""
    depth = _s8_lane_depths()
    np.testing.assert_array_equal(np.asarray(scan_kernel.WGMMA_S8_ORDER), depth.reshape(-1))
    assert sorted(scan_kernel.WGMMA_S8_ORDER) == list(range(64))


def test_wgmma_s8_layout_pads_and_keeps_the_other_layouts():
    """In mode int8 the wgmma rows are the int8 queries zero-padded to the
    width asked for and permuted per 64-group in WGMMA_S8_ORDER; a width
    below d or not a multiple of 64 is refused; without one the layout is
    the mma.sync body's (the int8 rows zero-padded to 16, unpermuted), and
    the bf16 body over the same int8 store keeps WGMMA_ORDER."""
    rng = np.random.default_rng(9)
    q = torch.as_tensor(rng.integers(-128, 128, size=(4, 100)).astype(np.int8))
    for bad in (64, 96, 160):
        with pytest.raises(ValueError):
            scan_kernel.operand_queries(q, "int8", torch.int8, bad)
    for qd in (128, 256):
        op = scan_kernel.operand_queries(q, "int8", torch.int8, qd)
        assert op.dtype == torch.int8 and op.shape == (4, qd)
        assert op.is_contiguous() and op.data_ptr() % 16 == 0
        flat = torch.zeros((4, qd), dtype=torch.int8)
        flat[:, :100] = q
        order = list(scan_kernel.WGMMA_S8_ORDER)
        assert torch.equal(op, flat.reshape(4, qd // 64, 64)[:, :, order].reshape(4, qd))
    old = scan_kernel.operand_queries(q, "int8", torch.int8)
    flat = torch.zeros((4, 112), dtype=torch.int8)
    flat[:, :100] = q
    assert torch.equal(old, flat)
    f = torch.as_tensor(rng.normal(size=(4, 100)).astype(np.float32))
    bf = scan_kernel.operand_queries(f, "bf16", torch.int8, 128)
    flat = torch.zeros((4, 128), dtype=torch.bfloat16)
    flat[:, :100] = f.bfloat16()
    assert torch.equal(bf, flat.reshape(4, 2, 64)[:, :, list(scan_kernel.WGMMA_ORDER)]
                       .reshape(4, 128))


def _s8_resident(op: torch.Tensor, cols: int, qd: int) -> np.ndarray:
    """A block's resident int8 query tile as ``wgmma_begin`` writes it, in
    bytes: slot n's 16-byte piece p (values 16p .. 16p+15 of its operand
    row) at byte (p >> 1)·S8_KSTEP + (n >> 3)·256 + (p & 1)·128 + (n & 7)·16;
    slots past the queries zero."""
    rows = op.numpy().astype(np.int64)
    smem = np.zeros(qd // 32 * S8_KSTEP, np.int64)
    for n in range(rows.shape[0]):
        for piece in range(qd // 16):
            at = (piece >> 1) * S8_KSTEP + (n >> 3) * 256 + (piece & 1) * 128 + (n & 7) * 16
            smem[at : at + 16] = rows[n, 16 * piece : 16 * piece + 16]
    assert cols <= 64
    return smem


def _s8_b_tile(smem: np.ndarray, j: int, width: int) -> np.ndarray:
    """The (32, width) B operand that wgmma m64nNk32 s8 reads for k-step
    ``j`` through the body's descriptor (K-major, no swizzle: core matrices
    of 8 slots × 16 depths, the two 16-deep halves 128 bytes apart (leading
    byte offset), 8-slot groups 256 bytes apart (stride byte offset))."""
    kk = np.arange(32)[:, None]
    c = np.arange(width)[None, :]
    return smem[j * S8_KSTEP + (c >> 3) * 256 + (kk >> 4) * 128 + (c & 7) * 16 + (kk & 15)]


def _s8_sums(x: np.ndarray, op: torch.Tensor, cols: int, qd: int) -> np.ndarray:
    """The body's wgmma, lane by lane, in Python integers (int64, exact):
    for each ring stage (two boxes of 64 depths, four k-steps) the rows'
    A fragments (``_s8_lane_depths``: k-step 2b + s reads box b) against
    the B tile of the block's ``cols`` columns, summed over the stages:
    ``(rows, cols)``, the s32 sums of the epilogue."""
    xp = np.zeros((x.shape[0], qd), np.int64)
    xp[:, : x.shape[1]] = x  # the TMA box writes zeros past d
    depth = _s8_lane_depths()
    smem = _s8_resident(op, cols, qd)
    out = np.zeros((x.shape[0], cols), np.int64)
    for st in range(qd // 128):
        for ks in range(4):
            box, s = 2 * st + ks // 2, ks % 2
            out += xp[:, 64 * box + depth[s]] @ _s8_b_tile(smem, 4 * st + ks, cols)
    return out


@pytest.mark.parametrize("d,n", [(768, 64), (784, 37), (96, 16), (16, 9), (1664, 64)])
def test_wgmma_s8_model_contracts_to_the_dot_product(d, n):
    """The int8 body, modelled from the operand rows through the block's
    resident tile and its descriptor to the A and B fragments of each
    32-deep k-step: the sums are ``x · q`` exactly, in integers, for random
    int8 rows and queries (extremes -128 and 127 among them), from one
    k-step of real depths (d 16) to the widest resident tile (1664); the
    columns of slots past the queries are zero.  ``n`` queries in a block
    of up to four m-tiles (the wgmma's N rounded up to 16)."""
    rng = np.random.default_rng(d + n)
    x = rng.integers(-128, 128, size=(9, d)).astype(np.int8)
    q = rng.integers(-128, 128, size=(n, d)).astype(np.int8)
    x[0], q[0] = -128, -128  # the largest products
    qd = -(-d // QD_STEP) * QD_STEP
    cols = 16 * -(-n // 16)
    op = scan_kernel.operand_queries(torch.as_tensor(q), "int8", torch.int8, qd)
    sums = _s8_sums(x, op, cols, qd)
    np.testing.assert_array_equal(sums[:, :n], x.astype(np.int64) @ q.astype(np.int64).T)
    assert not sums[:, n:].any()
    assert np.abs(sums).max() < 2**31  # an s32 sum holds it


def _s8_dists(rows: np.ndarray, q_int: np.ndarray, q_sc: np.ndarray,
                   sc: np.ndarray) -> np.ndarray:
    """The int8 body's distances as its epilogue computes them: the s8
    wgmma's exact sums of each 64-slot block (``_s8_sums``), each rounded to
    f32, then ``distance<true>``: ·(−row scale), ·query scale, + 1 (+inf on
    a padding slot), each a rounded f32 operation.  ``(queries, slots)``."""
    d = rows.shape[1]
    qd = -(-d // QD_STEP) * QD_STEP
    op = scan_kernel.operand_queries(torch.as_tensor(q_int), "int8", torch.int8, qd)
    nq = op.shape[0]
    raw = np.concatenate([_s8_sums(rows, op[c0 : c0 + 64], 64, qd)[:, : min(64, nq - c0)]
                          for c0 in range(0, nq, 64)], axis=1).astype(np.float32)
    dist = (raw * -sc[:, None].astype(np.float32)).astype(np.float32)
    dist = (dist * q_sc[None, :].astype(np.float32)).astype(np.float32)
    dist = dist + np.where(sc == 0.0, np.float32(np.inf), np.float32(1.0))[:, None]
    return np.ascontiguousarray(dist.astype(np.float32).T)


@pytest.mark.parametrize("d,k,qtile", [(96, 16, 16), (768, 32, 8), (256, 5, 32)])
def test_wgmma_s8_model_matches_pallas_int8_scan(d, k, qtile):
    """The int8 body's sums (``_s8_sums``: exact integers, rounded to f32)
    and its epilogue (``distance<true>``: raw·(−scale), ·qscale, + 1 or +inf
    on padding, each a rounded f32 operation), with each query's top-k in
    scan order, ties to the earlier row: bit-equal, distances and slots, to
    the plain version's lists (the mma.sync body's bits), and each real
    query's list within the parity bar of the JAX package's Pallas int8
    scan (int8×int8→int32 with the same scales) of the same seeded inputs
    in interpret mode, as tests/test_torch_scan_kernel.py holds the plain
    version to it (rtol 1e-4, atol 1e-5; slots differing only at ties):
    XLA on the CPU may fuse the epilogue's multiply and add, an ulp off."""
    import jax.numpy as jnp

    from learnedmetricindex_tpu.data import synthetic_blobs
    from learnedmetricindex_tpu.index.bucket_store import BucketStore as JaxStore
    from learnedmetricindex_tpu.index.bucket_store import build_scan_plan
    from learnedmetricindex_tpu.ops.quantize import quantize_rows
    from learnedmetricindex_tpu.ops.scan_kernel import pallas_host_args, pallas_scan_pairs
    from learnedmetricindex_tpu_torch.index.bucket_store import build_plan
    from learnedmetricindex_tpu_torch.ops.select import smallest_k

    n, nb, chunk, nq = 500, 4, 64, 40
    data, queries = synthetic_blobs(n, d, nq, seed=d + k)
    rng = np.random.default_rng(d + k)
    store = JaxStore.build_packed_int8(data, rng.integers(0, nb, size=n), nb, chunk=chunk)
    order = np.stack([rng.choice(nb, size=2, replace=False) for _ in range(nq)]).astype(np.int64)
    order[rng.random(nq) < 0.3, -1] = -1
    plan = build_scan_plan(store, order, qtile=qtile)
    n_pairs = len(plan.qidx) // qtile
    im, ic, wr, sf, written = pallas_host_args(store, plan, qtile, n_pairs)
    q_int, q_sc = (np.array(a) for a in quantize_rows(jnp.asarray(queries)))
    valid = plan.qidx >= 0
    g = np.maximum(plan.qidx, 0)
    wq = np.where(valid[:, None], q_int[g], 0).astype(np.int8)
    qs2d = np.where(valid, q_sc[g], 0.0).astype(np.float32).reshape(n_pairs, qtile)
    jd, js = pallas_scan_pairs(
        jnp.asarray(wq), jnp.asarray(im), jnp.asarray(ic), jnp.asarray(wr), store.chunk_data,
        jnp.asarray(sf), jnp.asarray(qs2d), k=k, qtile=qtile, chunk=chunk, n_pairs=n_pairs,
        compute="int8", interpret=True)
    jd, js = np.asarray(jd)[:n_pairs], np.asarray(js)[:n_pairs]
    sf = np.array(sf)
    rows = np.array(store.chunk_data)
    dist = torch.as_tensor(_s8_dists(rows, q_int, q_sc, sf))
    pplan = build_plan(torch.as_tensor(order), nb, qtile)
    assert pplan.n_pairs == n_pairs
    ptr = store.bucket_chunk_start
    pb = pplan.pair_bucket.numpy()
    md = np.full((n_pairs, qtile, k), np.inf, np.float32)
    ms = np.full((n_pairs, qtile, k), -1, np.int32)
    for p in range(n_pairs):
        b = int(pb[p])
        slots = torch.arange(int(ptr[b]) * chunk, int(ptr[b + 1]) * chunk)
        if len(slots) == 0:
            continue
        for j in np.nonzero(valid.reshape(-1, qtile)[p])[0]:
            vals, pos = smallest_k(dist[int(plan.qidx[p * qtile + j]), slots][None, :],
                                   min(k, len(slots)))
            kk = vals.shape[1]
            md[p, j, :kk] = vals[0].numpy()
            ms[p, j, :kk] = np.where(np.isinf(md[p, j, :kk]), -1, slots[pos[0]].numpy())
    rd, rs = scan_kernel.scan_pairs_reference(
        torch.as_tensor(q_int), pplan.qidx, pplan.pair_bucket,
        torch.as_tensor(ptr, dtype=torch.int32), torch.arange(len(rows) // chunk, dtype=torch.int32),
        torch.as_tensor(rows), torch.as_tensor(sf), torch.as_tensor(q_sc), k=k, qtile=qtile,
        chunk=chunk, mode="int8")
    np.testing.assert_array_equal(md.view(np.uint32), rd.numpy().view(np.uint32))
    np.testing.assert_array_equal(ms, rs.numpy())
    checked = 0
    for p in range(n_pairs):
        if not written[p]:
            continue
        for j in np.nonzero(valid.reshape(-1, qtile)[p])[0]:
            o = np.lexsort((js[p, j], jd[p, j]))
            np.testing.assert_allclose(md[p, j], jd[p, j][o], rtol=1e-4, atol=1e-5)
            mism = ms[p, j] != js[p, j][o]
            if mism.any():
                np.testing.assert_allclose(md[p, j][mism], jd[p, j][o][mism], rtol=1e-6,
                                           atol=1e-7)
            checked += 1
    assert checked > 0


# the int8 body with wide lists (list widths 64 and 128): its query slots, its
# ring's stages and the widest resident int8 query tile at each width
# (W_WIDE_SLOTS, WS8W_STAGES, S8WideList<64 | 128>::MAX_QD in csrc/scan_pairs.cu)
S8_WIDE_SLOTS, S8_WIDE_STAGES = 64, 4
S8_WIDE_MAX_QD = {64: 1408, 128: 896}


def _w_head_bytes(slots: int, width: int, stages: int, extra: int) -> int:
    """``w_head_bytes`` of csrc/scan_pairs.cu: the ring's barriers, the
    query slots' rows and marks, the lists, two distance tiles of ``slots``
    × 68 f32 and ``extra`` bytes, rounded up to 1024."""
    raw = (2 * 2 * stages * 8 + (slots + 2 * slots) * 4 + 2 * width * slots * 4
           + 2 * slots * 68 * 4 + extra)
    return -(-raw // 1024) * 1024


@pytest.mark.parametrize("width", [64, 128])
def test_s8_wide_body_keeps_its_widest_tile_resident(width):
    """The int8 body with wide lists in one block's 232,448 B: the head (its
    64 slots' lists of the list width, the query scales after the distance
    tiles), the ring (two consumers × four stages of two 64 × 64-byte
    boxes) and the resident int8 queries (64 bytes a depth, d rounded up to
    128).  The widest such tile is 1408 at list width 64 and 896 at 128,
    as the library's scope takes it (the constants here mirror the source's,
    which the test reads); at d 768 and width 128 the block takes 217,088
    B."""
    import re

    from learnedmetricindex_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / "scan_pairs.cu").read_text()
    assert re.search(r"constexpr int WS8W_STAGES = (\d+);", src).group(1) == str(S8_WIDE_STAGES)
    assert re.search(r"constexpr int W_WIDE_SLOTS = (\d+);", src).group(1) == str(S8_WIDE_SLOTS)
    head = _w_head_bytes(S8_WIDE_SLOTS, width, S8_WIDE_STAGES, S8_WIDE_SLOTS * 4)
    ring = 2 * S8_WIDE_STAGES * 2 * 64 * 64

    def block(qd):
        return head + ring + S8_WIDE_SLOTS * qd

    widest = S8_WIDE_MAX_QD[width]
    assert widest % QD_STEP == 0 and block(widest) <= 232448 < block(widest + QD_STEP)
    assert {64: 69632, 128: 102400}[width] == head
    if width == 128:
        assert block(768) == 217088


@pytest.mark.parametrize("k,qtile", [(64, 37), (106, 128), (33, 8), (128, 64)])
@pytest.mark.parametrize("stale", [False, True])
def test_s8_wide_model_gives_the_plain_lists(k, qtile, stale):
    """The int8 body with wide lists, modelled: its sums and epilogue
    (``_s8_dists``, the width-32 int8 body's) and the wide-list selection order
    over them (``_wide_model_lists``: 64-row tiles taken by two warpgroups
    in turn, marks against a k-th that may be one tile stale, entries
    winning ties) give the plain version's int8 lists bit for bit,
    distances and slots: rows drawn from a pool of 40 (so equal rows of
    equal scale tie exactly), chunks of 96 rows (1.5 tiles), padding
    slots, an empty bucket, query tiles of one or two 64-slot blocks."""
    from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore, scan_inputs

    rng = np.random.default_rng(k + qtile + 500)
    n, d, nb, chunk, nq = 1500, 64, 5, 96, 70
    pool = rng.integers(-128, 128, (40, d))
    rows = torch.as_tensor(pool[rng.integers(0, 40, n)], dtype=torch.int8)
    scales = torch.as_tensor(rng.choice([0.25, 0.5, 1.0], n).astype(np.float32))
    bucket = rng.integers(0, nb, n)
    bucket[bucket == 3] = 1  # bucket 3 empty
    store = BucketStore.build_packed_device(rows, bucket, nb, chunk=chunk, row_scales=scales)
    queries = torch.as_tensor(rng.normal(size=(nq, d)).astype(np.float32))
    order = torch.as_tensor(np.stack([rng.choice(nb, 2, replace=False) for _ in range(nq)]))
    order[-5:, 1] = -1
    _, args = scan_inputs(store, queries, order, qtile, "int8")
    q, qidx, pb, ptr, chunk_of, st, sc, qs = args[:8]
    kw = dict(k=k, qtile=qtile, chunk=chunk, mode="int8")
    rd, rs = scan_kernel.scan_pairs_reference(*args, **kw)
    dist = _s8_dists(st.numpy(), q.numpy(), qs.numpy(), sc.numpy())
    md, ms = _wide_model_lists(dist, ptr.numpy(), chunk_of.numpy(), chunk, pb.numpy(),
                               qidx.numpy(), qtile, k, stale)
    assert np.isfinite(md).sum() > 0 and (ms >= 0).any()
    np.testing.assert_array_equal(md.view(np.uint32), rd.numpy().view(np.uint32))
    np.testing.assert_array_equal(ms, rs.numpy())
    # the ties are real: many lists hold equal finite distances side by side
    fin = np.where(np.isfinite(md), md, np.float32(0.0))
    assert ((np.diff(fin, axis=2) == 0.0) & np.isfinite(md[:, :, 1:])).sum() > 100


@pytest.mark.parametrize("d,k,qtile", [(96, 64, 16), (256, 106, 8), (64, 128, 64)])
def test_s8_wide_model_matches_pallas_int8_scan(d, k, qtile):
    """The int8 body with wide lists (``_s8_dists`` and
    ``_wide_model_lists``, one tile stale marks) over the JAX package's
    int8 store and quantized queries: bit-equal to the plain version's
    lists, and each real query's list within the parity bar of the JAX
    package's Pallas int8 scan of the same seeded inputs in interpret mode
    (rtol 1e-4, atol 1e-5; slots differing only at ties, rtol 1e-6, atol
    1e-7), as ``test_wgmma_s8_model_matches_pallas_int8_scan`` holds the
    width-32 body."""
    import jax.numpy as jnp

    from learnedmetricindex_tpu.data import synthetic_blobs
    from learnedmetricindex_tpu.index.bucket_store import BucketStore as JaxStore
    from learnedmetricindex_tpu.index.bucket_store import build_scan_plan
    from learnedmetricindex_tpu.ops.quantize import quantize_rows
    from learnedmetricindex_tpu.ops.scan_kernel import pallas_host_args, pallas_scan_pairs
    from learnedmetricindex_tpu_torch.index.bucket_store import build_plan

    n, nb, chunk, nq = 600, 4, 96, 40
    data, queries = synthetic_blobs(n, d, nq, seed=d + k)
    rng = np.random.default_rng(d + k)
    store = JaxStore.build_packed_int8(data, rng.integers(0, nb, size=n), nb, chunk=chunk)
    order = np.stack([rng.choice(nb, size=2, replace=False) for _ in range(nq)]).astype(np.int64)
    order[rng.random(nq) < 0.3, -1] = -1
    plan = build_scan_plan(store, order, qtile=qtile)
    n_pairs = len(plan.qidx) // qtile
    im, ic, wr, sf, written = pallas_host_args(store, plan, qtile, n_pairs)
    q_int, q_sc = (np.array(a) for a in quantize_rows(jnp.asarray(queries)))
    valid = plan.qidx >= 0
    g = np.maximum(plan.qidx, 0)
    wq = np.where(valid[:, None], q_int[g], 0).astype(np.int8)
    qs2d = np.where(valid, q_sc[g], 0.0).astype(np.float32).reshape(n_pairs, qtile)
    jd, js = pallas_scan_pairs(
        jnp.asarray(wq), jnp.asarray(im), jnp.asarray(ic), jnp.asarray(wr), store.chunk_data,
        jnp.asarray(sf), jnp.asarray(qs2d), k=k, qtile=qtile, chunk=chunk, n_pairs=n_pairs,
        compute="int8", interpret=True)
    jd, js = np.asarray(jd)[:n_pairs], np.asarray(js)[:n_pairs]
    sf = np.array(sf)
    rows = np.array(store.chunk_data)
    dist = _s8_dists(rows, q_int, q_sc, sf)
    pplan = build_plan(torch.as_tensor(order), nb, qtile)
    assert pplan.n_pairs == n_pairs
    ptr = np.asarray(store.bucket_chunk_start)
    md, ms = _wide_model_lists(dist, ptr, np.arange(ptr[-1]), chunk, pplan.pair_bucket.numpy(),
                               plan.qidx, qtile, k, stale=True)
    rd, rs = scan_kernel.scan_pairs_reference(
        torch.as_tensor(q_int), pplan.qidx, pplan.pair_bucket,
        torch.as_tensor(ptr, dtype=torch.int32), torch.arange(len(rows) // chunk, dtype=torch.int32),
        torch.as_tensor(rows), torch.as_tensor(sf), torch.as_tensor(q_sc), k=k, qtile=qtile,
        chunk=chunk, mode="int8")
    np.testing.assert_array_equal(md.view(np.uint32), rd.numpy().view(np.uint32))
    np.testing.assert_array_equal(ms, rs.numpy())
    checked = 0
    for p in range(n_pairs):
        if not written[p]:
            continue
        for j in np.nonzero(valid.reshape(-1, qtile)[p])[0]:
            o = np.lexsort((js[p, j], jd[p, j]))
            np.testing.assert_allclose(md[p, j], jd[p, j][o], rtol=1e-4, atol=1e-5)
            mism = ms[p, j] != js[p, j][o]
            if mism.any():
                np.testing.assert_allclose(md[p, j][mism], jd[p, j][o][mism], rtol=1e-6,
                                           atol=1e-7)
            checked += 1
    assert checked > 0


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_length_counts_the_s8_wide_blocks_m_tiles(width, seed):
    """The split's cost model for the int8 body with wide lists: a pair's
    128 slots are two blocks of its 64 (``Body.block_queries``), each
    computing its m-tiles up to its last live one, at either list width,
    as for the int8 body at width 32, which has the same blocks; the
    int8 mma.sync body those launches took before cost all of a pair's
    live m-tiles in one block, and cuts the same plan otherwise."""
    rng = np.random.default_rng(seed + 40)
    counts = rng.integers(0, 90, 30)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    pair_bucket = rng.integers(0, 30, 50)
    live = rng.integers(0, 256, 50)
    live[:4] = [0b1, 0b10000000, 0b00010001, 0]
    slots = 132  # one block an SM
    seg = scan_kernel.segment_length(ptr, pair_bucket, live, width=width, slots=slots,
                                     wgmma_block=S8_WIDE_SLOTS)
    chunks = counts[pair_bucket]
    blocks = np.zeros((50, 2), np.int64)
    for p in range(50):
        for blk in range(2):
            bits = [(live[p] >> (4 * blk + m)) & 1 for m in range(4)]
            blocks[p, blk] = max((m + 1 for m in range(4) if bits[m]), default=0)
    np.testing.assert_array_equal(blocks[:4], [[1, 0], [0, 4], [1, 1], [0, 0]])
    fair = (chunks[:, None] * blocks).sum() / slots
    heaviest = blocks[chunks > 0].max()
    if seg > 1:
        assert seg * heaviest <= scan_kernel.SEGMENT_SHARE * fair
    assert (seg + 1) * heaviest > scan_kernel.SEGMENT_SHARE * fair
    assert seg == scan_kernel.segment_length(ptr, pair_bucket, live, width=32, slots=slots,
                                             wgmma_block=64)
    tiles = ((live[:, None] >> np.arange(8)) & 1).sum(axis=1)
    mma = scan_kernel.segment_length(ptr, pair_bucket, live, width=width, slots=slots)
    assert mma == max(1, int(scan_kernel.SEGMENT_SHARE * (chunks * tiles).sum()
                             / (slots * tiles[chunks > 0].max())))


# f32 queries over an int8 store at list widths 64 and 128 (the f32-mode
# wgmma body with wide lists): its block's query slots (WQ3), the bytes of
# its three resident planes a depth, and its widest resident query tile at
# each width (F32ModeWideList<64 | 128>::MAX_QD in csrc/scan_pairs.cu)
F32W_SLOTS = 32
F32W_MAX_QD = {64: 768, 128: 768}


def _source_int(src: str, name: str) -> int:
    import re

    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("width", [64, 128])
def test_f32mode_wide_body_keeps_its_widest_tile_resident(width):
    """The f32-mode body with wide lists in one block's 232,448 B: the head
    (its 32 slots' lists of the list width), the ring (two consumers ×
    W_STAGES stages of two 64 × 64-byte boxes, the f32-mode body's) and
    the three resident bf16 planes (192 bytes a depth, d rounded up to
    128).  The widest such tile is 768 at both widths, as the library's
    scope takes it (the constants here mirror the source's, which the test
    reads); at d 768 and width 128 the block takes 231,424 B (head 51,200,
    ring 32,768, planes 147,456), at width 64 a third ring stage would
    still fit at d 768, and three planes of 64 slots would not fit beside
    any head."""
    from learnedmetricindex_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / "scan_pairs.cu").read_text()
    assert _source_int(src, "WQ3") == F32W_SLOTS
    stages = _source_int(src, "W_STAGES")
    head = _w_head_bytes(F32W_SLOTS, width, stages, 0)
    ring = 2 * stages * 2 * 64 * 64

    def block(qd, slots=F32W_SLOTS):
        return head + ring + 3 * slots * 2 * qd

    widest = F32W_MAX_QD[width]
    assert widest % QD_STEP == 0 and block(widest) <= 232448 < block(widest + QD_STEP)
    assert {64: 34816, 128: 51200}[width] == head
    if width == 128:
        assert (stages, block(768)) == (2, 231424)
    else:  # three stages: their barriers fit in the head's rounding
        assert _w_head_bytes(F32W_SLOTS, width, 3, 0) + 3 * ring // 2 + 3 * 32 * 2 * 768 <= 232448
    assert 3 * 64 * 2 * 768 == 294912 > 232448 - head


def _f32mode_wide_dists(rows: np.ndarray, queries: torch.Tensor, sc: np.ndarray) -> np.ndarray:
    """The f32-mode bodies' distances as their epilogue computes them:
    ``_f32mode_raw``'s rounded sums (the width-32 body's arithmetic,
    which the wide body keeps), then ``distance<false>``: raw·(−row scale)
    + 1 (+inf on a padding slot), each a rounded f32 operation.
    ``(queries, slots)``."""
    raw = _f32mode_raw(rows, queries)
    dist = (raw * -sc[:, None].astype(np.float32)).astype(np.float32)
    dist = dist + np.where(sc == 0.0, np.float32(np.inf), np.float32(1.0))[:, None]
    return np.ascontiguousarray(dist.astype(np.float32).T)


def _held_to_f32_bar(md, ms, rd, rs):
    """Lists ``md``/``ms`` against ``rd``/``rs``, each ascending: the f32
    parity bar (rtol 1e-4, atol 1e-5), slots differing only at ties (rtol
    1e-6, atol 1e-7)."""
    np.testing.assert_array_equal(np.isinf(md), np.isinf(rd))
    np.testing.assert_allclose(md, rd, rtol=1e-4, atol=1e-5)
    mism = ms != rs
    if mism.any():
        np.testing.assert_allclose(md[mism], rd[mism], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("k", [33, 64, 106, 128])
@pytest.mark.parametrize("qtile", [8, 37, 128])
def test_f32mode_wide_model_gives_the_plain_lists(k, qtile):
    """The f32-mode body with wide lists, modelled: the width-32 f32-mode
    body's rounded sums and epilogue (``_f32mode_wide_dists``) and the
    wide-list selection order over them (``_wide_model_lists``: 64-row
    tiles taken by two warpgroups in turn, marks against a k-th one tile
    stale, entries winning ties; the selection is each query's own, so
    the block's 32 slots change no list) give the plain version's f32
    lists within the f32 parity bar, slots differing only at ties: int8
    rows of mixed scales, chunks of 96 rows (1.5 tiles), padding slots, an
    empty bucket, query tiles of one to four 32-slot blocks."""
    from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore, scan_inputs

    rng = np.random.default_rng(k + qtile + 900)
    n, d, nb, chunk, nq = 1500, 96, 5, 96, 70
    rows = torch.as_tensor(rng.integers(-128, 128, (n, d)), dtype=torch.int8)
    scales = torch.as_tensor(rng.uniform(0.002, 0.01, n).astype(np.float32))
    bucket = rng.integers(0, nb, n)
    bucket[bucket == 3] = 1  # bucket 3 empty
    store = BucketStore.build_packed_device(rows, bucket, nb, chunk=chunk, row_scales=scales)
    queries = torch.as_tensor(rng.normal(size=(nq, d)).astype(np.float32) * 0.1)
    order = torch.as_tensor(np.stack([rng.choice(nb, 2, replace=False) for _ in range(nq)]))
    order[-5:, 1] = -1
    _, args = scan_inputs(store, queries, order, qtile, "f32")
    q, qidx, pb, ptr, chunk_of, st, sc = args[:7]
    rd, rs = scan_kernel.scan_pairs_reference(*args, k=k, qtile=qtile, chunk=chunk, mode="f32")
    dist = _f32mode_wide_dists(st.numpy(), q, sc.numpy())
    md, ms = _wide_model_lists(dist, ptr.numpy(), chunk_of.numpy(), chunk, pb.numpy(),
                               qidx.numpy(), qtile, k, stale=True)
    assert np.isfinite(md).sum() > 0 and (ms >= 0).any()
    _held_to_f32_bar(md, ms, rd.numpy(), rs.numpy())


@pytest.mark.parametrize("d,k,qtile", [(96, 64, 16), (256, 106, 8), (128, 128, 37)])
def test_f32mode_wide_model_matches_pallas_f32_scan(d, k, qtile):
    """The f32-mode body with wide lists (``_f32mode_wide_dists`` and
    ``_wide_model_lists``, one tile stale marks) over the JAX package's
    int8 store and f32 queries gives each real query's top-k over its
    pair's bucket within the parity bar of the JAX package's f32
    (Precision.HIGHEST) Pallas scan of the same seeded inputs in interpret
    mode (rtol 1e-4, atol 1e-5; slots differing only at ties, rtol 1e-6,
    atol 1e-7), as ``test_wgmma_f32mode_model_matches_pallas_f32_scan``
    holds the width-32 body."""
    import jax.numpy as jnp

    from learnedmetricindex_tpu.data import synthetic_blobs
    from learnedmetricindex_tpu.index.bucket_store import BucketStore as JaxStore
    from learnedmetricindex_tpu.index.bucket_store import build_scan_plan
    from learnedmetricindex_tpu.ops.scan_kernel import pallas_host_args, pallas_scan_pairs
    from learnedmetricindex_tpu_torch.index.bucket_store import build_plan

    n, nb, chunk, nq = 600, 4, 96, 40
    data, queries = synthetic_blobs(n, d, nq, seed=d + k + 1)
    rng = np.random.default_rng(d + k + 1)
    store = JaxStore.build_packed_int8(data, rng.integers(0, nb, size=n), nb, chunk=chunk)
    order = np.stack([rng.choice(nb, size=2, replace=False) for _ in range(nq)]).astype(np.int64)
    order[rng.random(nq) < 0.3, -1] = -1
    plan = build_scan_plan(store, order, qtile=qtile)
    n_pairs = len(plan.qidx) // qtile
    im, ic, wr, sf, written = pallas_host_args(store, plan, qtile, n_pairs)
    qidx = jnp.asarray(plan.qidx)
    wq = jnp.where((qidx >= 0)[:, None], jnp.asarray(queries)[jnp.maximum(qidx, 0)], 0.0)
    jd, js = pallas_scan_pairs(
        wq, jnp.asarray(im), jnp.asarray(ic), jnp.asarray(wr), store.chunk_data,
        jnp.asarray(sf), None, k=k, qtile=qtile, chunk=chunk, n_pairs=n_pairs,
        compute="f32", interpret=True)
    jd, js = np.asarray(jd)[:n_pairs], np.asarray(js)[:n_pairs]
    dist = _f32mode_wide_dists(np.asarray(store.chunk_data), torch.as_tensor(queries),
                               np.asarray(sf))
    pplan = build_plan(torch.as_tensor(order), nb, qtile)
    assert pplan.n_pairs == n_pairs
    ptr = np.asarray(store.bucket_chunk_start)
    md, ms = _wide_model_lists(dist, ptr, np.arange(ptr[-1]), chunk, pplan.pair_bucket.numpy(),
                               plan.qidx, qtile, k, stale=True)
    real = (plan.qidx >= 0).reshape(-1, qtile)
    checked = 0
    for p in range(n_pairs):
        if not written[p]:
            continue
        for j in np.nonzero(real[p])[0]:
            o = np.lexsort((js[p, j], jd[p, j]))
            _held_to_f32_bar(md[p, j], ms[p, j], jd[p, j][o], js[p, j][o])
            checked += 1
    assert checked > 0


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_length_counts_the_f32mode_wide_blocks_m_tiles(width, seed):
    """The split's cost model for the f32-mode body with wide lists: a
    pair's 128 slots are four blocks of its 32 (``Body.block_queries``),
    each computing its m-tiles up to its last live one (its wgmma's width,
    three planes of them), at either list width, as for the width-32
    f32-mode body, which has the same blocks; the f32 mma.sync body those
    launches took before cost all of a pair's live m-tiles in one block.
    The segment keeps the heaviest block within the share of a slot's fair
    share, and a block with no live slot costs nothing."""
    rng = np.random.default_rng(seed + 60)
    counts = rng.integers(0, 90, 30)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    pair_bucket = rng.integers(0, 30, 50)
    live = rng.integers(0, 256, 50)
    live[:4] = [0b1, 0b10000000, 0b00100110, 0]
    slots = 132  # one block an SM
    seg = scan_kernel.segment_length(ptr, pair_bucket, live, width=width, slots=slots,
                                     wgmma_block=F32W_SLOTS)
    chunks = counts[pair_bucket]
    blocks = np.zeros((50, 4), np.int64)
    for p in range(50):
        for blk in range(4):
            bits = [(live[p] >> (2 * blk + m)) & 1 for m in range(2)]
            blocks[p, blk] = max((m + 1 for m in range(2) if bits[m]), default=0)
    np.testing.assert_array_equal(blocks[:4], [[1, 0, 0, 0], [0, 0, 0, 2], [2, 1, 2, 0],
                                               [0, 0, 0, 0]])
    fair = (chunks[:, None] * blocks).sum() / slots
    heaviest = blocks[chunks > 0].max()
    assert seg >= 1
    if seg > 1:
        assert seg * heaviest <= scan_kernel.SEGMENT_SHARE * fair
    assert (seg + 1) * heaviest > scan_kernel.SEGMENT_SHARE * fair
    assert seg == scan_kernel.segment_length(ptr, pair_bucket, live, width=32, slots=slots,
                                             wgmma_block=F32W_SLOTS)
    tiles = ((live[:, None] >> np.arange(8)) & 1).sum(axis=1)
    mma = scan_kernel.segment_length(ptr, pair_bucket, live, width=width, slots=slots)
    assert mma == max(1, int(scan_kernel.SEGMENT_SHARE * (chunks * tiles).sum()
                             / (slots * tiles[chunks > 0].max())))


# bf16 queries over an f32 store at list widths 64 and 128 (the wgmma body
# over f32 rows with wide lists): its block's query slots (W_WIDE_SLOTS),
# the f32 boxes of a ring stage at each width (F32WideList<KMAX>::BOXES:
# two where they fit beside a 768-wide tile) and its widest resident query
# tile (F32WideList<64 | 128>::MAX_QD in csrc/scan_pairs.cu)
F32_WIDE_SLOTS = 64
F32_WIDE_BOXES = {64: 2, 128: 1}
F32_WIDE_MAX_QD = {64: 768, 128: 768}


@pytest.mark.parametrize("width", [64, 128])
def test_f32_wide_body_keeps_its_widest_tile_resident(width):
    """The body over f32 rows with wide lists in one block's 232,448 B: the
    head (its 64 slots' lists of the list width), the ring (two consumers
    × W_STAGES stages of one or two boxes of 64 rows × 128 bytes) and the
    resident bf16 queries (128 bytes a depth, d rounded up to 64).  Two-box
    stages fit beside a 768-wide tile at list width 64 and not at 128
    (265,216 B), so width 128 takes one-box stages; either way the block
    takes exactly 232,448 B at d 768, the widest tile is 768, as the
    library's scope takes it, and the head, a multiple of 1024, puts the
    ring where TMA's 128-byte swizzle needs it (the constants here mirror
    the source's, which the test reads)."""
    from learnedmetricindex_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / "scan_pairs.cu").read_text()
    assert _source_int(src, "W_WIDE_SLOTS") == F32_WIDE_SLOTS
    assert "HEAD + kWRingBytesF + size_t(SLOTS) * 2 * 768 <= 232448 ? W_BOXES : 1;" in src
    stages = _source_int(src, "W_STAGES")
    head = _w_head_bytes(F32_WIDE_SLOTS, width, stages, 0)

    def block(qd, boxes):
        return head + 2 * stages * boxes * 64 * 128 + F32_WIDE_SLOTS * 2 * qd

    boxes = 2 if block(768, 2) <= 232448 else 1
    assert boxes == F32_WIDE_BOXES[width]
    widest = F32_WIDE_MAX_QD[width]
    assert widest % QD_STEP_F32 == 0
    assert block(widest, boxes) <= 232448 < block(widest + QD_STEP_F32, boxes)
    assert block(768, boxes) == 232448
    assert {64: 68608, 128: 101376}[width] == head and head % 1024 == 0
    if width == 128:
        assert block(768, 2) == 265216


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_length_counts_the_f32_wide_blocks_m_tiles(width, seed):
    """The split's cost model for the body over f32 rows with wide lists: a
    pair's 128 slots are two blocks of 64 (``Body.block_queries``), each
    computing its m-tiles up to its last live one, at either list width,
    as for the wide-list body over int8 rows; the mma.sync body those
    launches took before cost every live m-tile of a pair in one block.
    The segment keeps the heaviest block within the share of a slot's fair
    share, and a block with no live slot costs nothing."""
    rng = np.random.default_rng(seed + 80)
    counts = rng.integers(0, 90, 30)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    pair_bucket = rng.integers(0, 30, 50)
    live = rng.integers(0, 256, 50)
    live[:4] = [0b10, 0b100000, 0b11000001, 0]
    slots = 132  # one block an SM
    seg = scan_kernel.segment_length(ptr, pair_bucket, live, width=width, slots=slots,
                                     wgmma_block=F32_WIDE_SLOTS)
    blocks = np.zeros((50, 2), np.int64)
    for p in range(50):
        for blk in range(2):
            bits = [(live[p] >> (4 * blk + m)) & 1 for m in range(4)]
            blocks[p, blk] = max((m + 1 for m in range(4) if bits[m]), default=0)
    np.testing.assert_array_equal(blocks[:4], [[2, 0], [0, 2], [1, 4], [0, 0]])
    chunks = counts[pair_bucket]
    fair = (chunks[:, None] * blocks).sum() / slots
    heaviest = blocks[chunks > 0].max()
    assert seg >= 1
    if seg > 1:
        assert seg * heaviest <= scan_kernel.SEGMENT_SHARE * fair
    assert (seg + 1) * heaviest > scan_kernel.SEGMENT_SHARE * fair
    assert seg == scan_kernel.segment_length(ptr, pair_bucket, live, width=192 - width,
                                             slots=slots, wgmma_block=F32_WIDE_SLOTS)
    mma = scan_kernel.segment_length(ptr, pair_bucket, live, width=width, slots=slots)
    tiles = ((live[:, None] >> np.arange(8)) & 1).sum(axis=1)
    assert mma == max(1, int(scan_kernel.SEGMENT_SHARE * (chunks * tiles).sum()
                             / (slots * tiles[chunks > 0].max())))


def _f32_wide_raw(x: np.ndarray, q: torch.Tensor, width: int) -> np.ndarray:
    """The body over f32 rows with wide lists, modelled lane by lane in its
    ring's stages: stage st of ``F32_WIDE_BOXES[width]`` boxes of 32 f32
    depths, k-step j of box b of it (two a box) the A fragment that the
    lanes round to nearest even bf16 from ``_f32_lane_depths``' places of
    the box, against the B k-step 2·boxes·st + 2·b + j of
    ``operand_queries(q, "bf16", float32, qd)``; every product and sum in
    float64 (exact here).  ``(rows, queries)``."""
    n, d = x.shape
    qd = -(-d // QD_STEP_F32) * QD_STEP_F32
    b = scan_kernel.operand_queries(q, "bf16", torch.float32, qd).double().numpy()
    xp = np.zeros((n, qd), np.float32)
    xp[:, :d] = x  # the TMA box writes zeros past d
    xr = _bf16_rne(xp).astype(np.float64)
    depth = _f32_lane_depths()
    boxes = F32_WIDE_BOXES[width]
    got = np.zeros((n, q.shape[0]))
    for st in range(qd // (32 * boxes)):
        for box in range(boxes):
            at = 32 * (boxes * st + box)
            for j in range(2):
                kstep = 2 * boxes * st + 2 * box + j
                got += xr[:, at + depth[j]] @ b[:, 16 * kstep : 16 * kstep + 16].T
    return got


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("d", [768, 800, 96, 100])
def test_f32_wide_model_contracts_to_the_dot_product(d, width):
    """The body over f32 rows with wide lists reads its A fragments from
    stages of two boxes (list width 64) or one (128): summed over every
    stage, box, k-step and k', the rounded store values at
    ``_f32_lane_depths``' places times the B values of the k-step the
    stage's box names give ``bf16(x) · bf16(q)`` (float64, exact), for f32
    rows of several magnitudes and bf16 queries, d a whole number of
    stages or not."""
    rng = np.random.default_rng(d + width)
    x = (rng.normal(size=(9, d)) * 2.0 ** rng.integers(-6, 6, size=(9, 1))).astype(np.float32)
    q = torch.as_tensor(rng.normal(size=(5, d)).astype(np.float32))
    got = _f32_wide_raw(x, q, width)
    want = torch.as_tensor(x).bfloat16().double().numpy() @ q.bfloat16().double().numpy().T
    np.testing.assert_array_equal(got, want)


def _f32_wide_dists(rows: np.ndarray, queries: torch.Tensor, sc: np.ndarray,
                    width: int) -> np.ndarray:
    """The body's distances as its epilogue computes them: ``_f32_wide_raw``
    rounded to f32, then ``distance<false>``: raw·(−row scale) + 1 (+inf on
    a padding slot), each a rounded f32 operation.  ``(queries, slots)``."""
    raw = _f32_wide_raw(rows, queries, width).astype(np.float32)
    dist = (raw * -sc[:, None].astype(np.float32)).astype(np.float32)
    dist = dist + np.where(sc == 0.0, np.float32(np.inf), np.float32(1.0))[:, None]
    return np.ascontiguousarray(dist.astype(np.float32).T)


@pytest.mark.parametrize("k,qtile", [(64, 37), (106, 128), (33, 8), (128, 64)])
@pytest.mark.parametrize("stale", [False, True])
def test_f32_wide_model_gives_the_plain_lists(k, qtile, stale):
    """The body over f32 rows with wide lists, modelled: its stages' sums
    and epilogue (``_f32_wide_dists``) and the wide-list selection order
    over them (``_wide_model_lists``: 64-row tiles taken by two
    warpgroups in turn, marks against a k-th that may be one tile stale,
    entries winning ties) give the plain version's bf16 lists bit for bit:
    f32 rows of multiples of 2^-7 up to 4 in magnitude (those in [2, 4)
    halfway between two bf16 values, so the rounding to nearest even
    decides them) and small integer queries make every sum exact; the
    second half of the rows copies the first into the same buckets, so
    lists hold exact ties, which the earlier row wins; chunks of 96 rows
    (1.5 tiles), padding slots, an empty bucket."""
    from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore, scan_inputs

    rng = np.random.default_rng(k + qtile + 300)
    n, d, nb, chunk, nq = 1500, 96, 5, 96, 70
    rows = rng.integers(-511, 512, (n, d)).astype(np.float32) / 128
    bucket = rng.integers(0, nb, n)
    bucket[bucket == 3] = 1  # bucket 3 empty
    rows[n // 2 :], bucket[n // 2 :] = rows[: n // 2], bucket[: n // 2]
    rows = torch.as_tensor(rows)
    store = BucketStore.build_packed_device(rows, bucket, nb, chunk=chunk)
    queries = torch.as_tensor(rng.integers(-3, 4, (nq, d)).astype(np.float32))
    order = torch.as_tensor(np.stack([rng.choice(nb, 2, replace=False) for _ in range(nq)]))
    order[-5:, 1] = -1
    _, args = scan_inputs(store, queries, order, qtile, "bf16")
    q, qidx, pb, ptr, chunk_of, st, sc = args[:7]
    assert st.dtype == torch.float32
    rd, rs = scan_kernel.scan_pairs_reference(*args, k=k, qtile=qtile, chunk=chunk, mode="bf16")
    dist = _f32_wide_dists(st.numpy(), q, sc.numpy(), scan_kernel.list_width(k))
    md, ms = _wide_model_lists(dist, ptr.numpy(), chunk_of.numpy(), chunk, pb.numpy(),
                               qidx.numpy(), qtile, k, stale)
    assert np.isfinite(md).sum() > 0 and (ms >= 0).any()
    np.testing.assert_array_equal(md.view(np.uint32), rd.numpy().view(np.uint32))
    np.testing.assert_array_equal(ms, rs.numpy())
    fin = np.where(np.isfinite(md), md, np.float32(0.0))
    assert ((np.diff(fin, axis=2) == 0.0) & np.isfinite(md[:, :, 1:])).sum() > 100


@pytest.mark.parametrize("d,k,qtile", [(96, 64, 16), (128, 106, 8)])
def test_f32_wide_model_matches_pallas_bf16_scan(d, k, qtile):
    """The body over f32 rows with wide lists (``_f32_wide_dists`` and
    ``_wide_model_lists``, one tile stale marks) over the JAX package's f32
    store and queries gives each real query's top-k over its pair's
    bucket within the bar of the JAX package's bf16 Pallas scan of the same
    seeded inputs in interpret mode (rtol 1e-4, atol 1e-5; slots differing
    only at ties, rtol 1e-6, atol 1e-7), as
    ``test_wide_selection_model_matches_pallas_scan`` holds the body over
    int8 rows."""
    import jax.numpy as jnp

    from learnedmetricindex_tpu.data import synthetic_blobs
    from learnedmetricindex_tpu.index.bucket_store import BucketStore as JaxStore
    from learnedmetricindex_tpu.index.bucket_store import build_scan_plan
    from learnedmetricindex_tpu.ops.scan_kernel import pallas_host_args, pallas_scan_pairs
    from learnedmetricindex_tpu_torch.index.bucket_store import build_plan

    n, nb, chunk, nq = 600, 4, 96, 40
    data, queries = synthetic_blobs(n, d, nq, seed=d + k + 2)
    rng = np.random.default_rng(d + k + 2)
    store = JaxStore.build(data, rng.integers(0, nb, size=n), nb, chunk=chunk)
    assert np.asarray(store.chunk_data).dtype == np.float32
    order = np.stack([rng.choice(nb, size=2, replace=False) for _ in range(nq)]).astype(np.int64)
    order[rng.random(nq) < 0.3, -1] = -1
    plan = build_scan_plan(store, order, qtile=qtile)
    n_pairs = len(plan.qidx) // qtile
    im, ic, wr, sf, written = pallas_host_args(store, plan, qtile, n_pairs)
    qidx = jnp.asarray(plan.qidx)
    wq = jnp.where((qidx >= 0)[:, None], jnp.asarray(queries)[jnp.maximum(qidx, 0)], 0.0)
    jd, js = pallas_scan_pairs(
        wq, jnp.asarray(im), jnp.asarray(ic), jnp.asarray(wr), store.chunk_data,
        jnp.asarray(sf), None, k=k, qtile=qtile, chunk=chunk, n_pairs=n_pairs,
        compute="bf16", interpret=True)
    jd, js = np.asarray(jd)[:n_pairs], np.asarray(js)[:n_pairs]
    dist = _f32_wide_dists(np.asarray(store.chunk_data), torch.as_tensor(queries),
                           np.asarray(sf), scan_kernel.list_width(k))
    pplan = build_plan(torch.as_tensor(order), nb, qtile)
    assert pplan.n_pairs == n_pairs
    ptr = np.asarray(store.bucket_chunk_start)
    md, ms = _wide_model_lists(dist, ptr, np.arange(ptr[-1]), chunk, pplan.pair_bucket.numpy(),
                               plan.qidx, qtile, k, stale=True)
    real = (plan.qidx >= 0).reshape(-1, qtile)
    checked = 0
    for p in range(n_pairs):
        if not written[p]:
            continue
        for j in np.nonzero(real[p])[0]:
            o = np.lexsort((js[p, j], jd[p, j]))
            np.testing.assert_allclose(md[p, j], jd[p, j][o], rtol=1e-4, atol=1e-5)
            mism = ms[p, j] != js[p, j][o]
            if mism.any():
                np.testing.assert_allclose(md[p, j][mism], jd[p, j][o][mism], rtol=1e-6,
                                           atol=1e-7)
            checked += 1
    assert checked > 0


# ---------------------------------------------------------------------
# the row-map bodies (csrc/scan_pairs.cu: body 10, bf16 queries, and body
# 11, f32 queries, over a virtual store of an int8 + row-scale corpus at
# list width 32): the packed bf16 and f32-mode bodies' blocks, their int8 rings filled by a
# producer warp a consumer that gathers each slot's row through the id
# grid (wgmma_gather), each row's scale read through the grid by the
# consumers (load_row_meta's rule)
RM_SLOTS = {"bf16": 64, "f32": 32}  # WQ, WQ3
RM_MAX_QD = {"bf16": 896, "f32": 768}  # WRing<RowMap<int8_t> | RowMap<F32Mode>>::MAX_QD
RM_NB, RM_CHUNK, RM_D = 6, 96, 144  # chunks of 96 rows: a chunk's second tile ends past it


@pytest.fixture(scope="module")
def rowmap_built(tmp_path_factory):
    """A 1-level [6] index built by the JAX package over 1500×144 blobs
    (rows of 144 int8 depths: two ring stages, the second past d from
    depth 144), saved and loaded by the port; the corpus as int8 rows with
    f32 row scales (the JAX package's ``quantize_rows``); the buckets of
    the index's prediction with rows 0..9 moved into the empty bucket 5 (a
    bucket smaller than one 64-row tile) and bucket 4 emptied."""
    import jax.numpy as jnp

    import learnedmetricindex_tpu as jlmi
    from learnedmetricindex_tpu.data import synthetic_blobs
    from learnedmetricindex_tpu.index.serialization import save_index as jax_save_index
    from learnedmetricindex_tpu.ops.quantize import quantize_rows as jax_quantize_rows
    import learnedmetricindex_tpu_torch as lmi

    data, queries = synthetic_blobs(1500, RM_D, 50, n_clusters=10, seed=24)
    cfg = jlmi.BuildConfiguration("kmeans", 10, "MLP-2", 0.01, [RM_NB], seed=24,
                                  chunk_size=RM_CHUNK)
    jidx, pred, _, _, _ = jlmi.LearnedIndexBuilder(data, cfg).build()
    path = str(tmp_path_factory.mktemp("rowmap") / "index.npz")
    jax_save_index(jidx, path, pred)
    pidx, ppred = lmi.load_index(path, "cpu")
    q8, sc = jax_quantize_rows(jnp.asarray(data))
    bucket_ids = pidx.bucket_ids_from_prediction(np.asarray(ppred))
    return {"data": data, "queries": queries, "jidx": jidx, "pidx": pidx,
            "pred": np.asarray(ppred), "bucket_ids": bucket_ids, "jax": (q8, sc),
            "torch": (torch.as_tensor(np.array(q8)), torch.as_tensor(np.array(sc)))}


def _rowmap_stores(built, case: str):
    """The port's virtual store of the int8 corpus, the packed store
    ``build_packed_device`` makes of it (the same slots) and the data
    prediction they were made from, for ``case``:
    ``"in order"``; ``"shuffled"``, both stores' chunks moved out of
    physical order alike (each bucket's list keeps its scan order);
    ``"small bucket"``, rows 0..9 alone in one bucket, another empty."""
    from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore

    x8, sc = built["torch"]
    bucket_ids = np.array(built["bucket_ids"])
    if case == "small bucket":
        bucket_ids[bucket_ids == RM_NB - 1] = 0
        bucket_ids[:10] = RM_NB - 1
        bucket_ids[bucket_ids == RM_NB - 2] = 1
    virtual = BucketStore.build_virtual(x8, bucket_ids, RM_NB, chunk=RM_CHUNK, row_scales=sc)
    packed = BucketStore.build_packed_device(x8, bucket_ids, RM_NB, chunk=RM_CHUNK,
                                             row_scales=sc)
    if case == "shuffled":
        perm = np.random.default_rng(7).permutation(virtual.n_chunks)
        inv = torch.as_tensor(np.argsort(perm))
        ptr, clist = virtual.chunk_list()
        moved = dict(bucket_chunk_ptr=ptr, bucket_chunk_list=perm[clist].astype(np.int32))
        virtual = virtual._replace(chunk_ids=virtual.chunk_ids[inv], **moved)
        n, c = packed.n_chunks, RM_CHUNK
        packed = packed._replace(
            chunk_ids=packed.chunk_ids[inv],
            chunk_data=packed.chunk_data.reshape(n, c, -1)[inv].reshape(n * c, -1),
            chunk_scales=packed.chunk_scales.reshape(n, c)[inv].reshape(-1), **moved)
    return virtual, packed, bucket_ids[:, None]


def _ring_tiles(c_lo: int, c_hi: int, chunk_of: np.ndarray, chunk: int, wg: int):
    """The 64-row tiles that consumer warpgroup ``wg`` of a block takes (and
    its producer fills), as ``TileWalk`` walks them: tiles wg, wg + 2, ...
    of the item's chunks in list order; ``(first slot, rows in the
    chunk)`` each."""
    per_chunk = -(-chunk // 64)
    tiles, c, t = [], c_lo, wg
    while True:
        c, t = c + t // per_chunk, t % per_chunk
        if c >= c_hi:
            return tiles
        tiles.append((int(chunk_of[c]) * chunk + 64 * t, min(64, chunk - 64 * t)))
        t += 2


def _gathered_stage(corpus: np.ndarray, row_ids: np.ndarray, slot0: int, nrows: int,
                    st: int) -> np.ndarray:
    """Stage ``st`` of a tile as the gathering producer writes it, (box,
    row, byte) = (2, 64, 64) int8: lane i holds the ids of rows i and
    32 + i (0 past the chunk); lane 8j + c copies piece c (16 bytes) of
    the stage's 128 depths of row 4i + j (i = 0 .. 15, the id shuffled
    from lane (4i + j) % 32) to box c // 4, bytes 16·(c % 4) of the row,
    zeros for id 0 and for depths past d."""
    d = corpus.shape[1]
    ids = [[int(row_ids[slot0 + h * 32 + lane]) if h * 32 + lane < nrows else 0
            for lane in range(32)] for h in range(2)]
    stage = np.full((2, 64, 64), 99, np.int8)  # nothing may stay unwritten
    for lane in range(32):
        c, j = lane & 7, lane >> 3
        depth = st * 128 + 16 * c
        for i in range(16):
            r = 4 * i + j
            rid = ids[i // 8][r & 31]
            ok = rid > 0 and depth < d
            stage[c >> 2, r, 16 * (c & 3) : 16 * (c & 3) + 16] = (
                corpus[rid - 1, depth : depth + 16] if ok else 0)
    return stage


def _tma_stage(chunk_data: np.ndarray, slot0: int, st: int) -> np.ndarray:
    """Stage ``st`` of a tile of the packed store as TMA writes it: two
    boxes of 64 rows (from ``slot0``, on past the chunk) × 64 depths (at
    128·st and 128·st + 64), zeros past the store's rows and past d."""
    n, d = chunk_data.shape
    stage = np.zeros((2, 64, 64), np.int8)
    for box in range(2):
        x0 = st * 128 + box * 64
        rows = chunk_data[slot0 : min(slot0 + 64, n), x0 : min(x0 + 64, d)]
        stage[box, : rows.shape[0], : rows.shape[1]] = rows
    return stage


def _grid_scales(row_ids: np.ndarray, row_scales, slot0: int, nrows: int) -> np.ndarray:
    """A row-map consumer's scale of each tile row (load_row_meta's rule):
    ``row_scales[id − 1]``, 1 without row scales, 0 for id 0 and for a row
    past the chunk."""
    out = np.zeros(64, np.float32)
    for r in range(nrows):
        rid = int(row_ids[slot0 + r])
        if rid:
            out[r] = 1.0 if row_scales is None else row_scales[rid - 1]
    return out


@pytest.mark.parametrize("case", ["in order", "shuffled", "small bucket"])
def test_rowmap_grid_and_ring_stages_are_the_packed_stores(rowmap_built, case):
    """The port's virtual store of a seeded int8 + row-scale corpus has the
    JAX package's ``build_virtual`` grid; each (tile, stage) of each
    consumer's ring that the gathering producer fills through the grid
    holds the packed store's TMA boxes of the same slots (the rows in the
    chunk; the rows past it zeros, which the consumers' scale 0 masks) and
    each row's scale through the grid is the packed store's slot scale,
    for chunk lists in and out of physical order, padding slots and a
    bucket smaller than one tile; without row scales a live row's scale
    is 1."""
    import jax.numpy as jnp

    from learnedmetricindex_tpu.index.bucket_store import BucketStore as JaxStore

    virtual, packed, _ = _rowmap_stores(rowmap_built, case)
    if case == "in order":
        q8 = rowmap_built["jax"][0]
        jstore = JaxStore.build_virtual(jnp.asarray(q8), rowmap_built["bucket_ids"], RM_NB,
                                        chunk=RM_CHUNK)
        np.testing.assert_array_equal(virtual.chunk_ids.numpy(), np.asarray(jstore.chunk_ids))
        np.testing.assert_array_equal(virtual.bucket_chunk_start, jstore.bucket_chunk_start)
    ptr, chunk_of = (np.asarray(a) for a in virtual.chunk_list())
    assert np.array_equal(ptr, packed.chunk_list()[0])
    assert np.array_equal(chunk_of, packed.chunk_list()[1])
    corpus, row_scales = (t.numpy() for t in rowmap_built["torch"])
    row_ids = virtual.chunk_ids.reshape(-1).numpy()
    data, scales = packed.chunk_data.numpy(), packed.scales_flat().numpy()
    nst = -(-RM_D // 128)
    sizes = np.diff(ptr)
    tiles_seen = short = padded = 0
    for b in range(RM_NB):
        for wg in range(2):
            for slot0, nrows in _ring_tiles(ptr[b], ptr[b + 1], chunk_of, RM_CHUNK, wg):
                for st in range(nst):
                    got = _gathered_stage(corpus, row_ids, slot0, nrows, st)
                    want = _tma_stage(data, slot0, st)
                    np.testing.assert_array_equal(got[:, :nrows], want[:, :nrows])
                    assert not got[:, nrows:].any()
                    if st == nst - 1:  # depths 144 .. 255 past d: zeros
                        assert not got[1].any() and not got[0, :, 16:].any()
                sc = _grid_scales(row_ids, row_scales, slot0, nrows)
                np.testing.assert_array_equal(sc[:nrows], scales[slot0 : slot0 + nrows])
                assert not sc[nrows:].any()
                ones = _grid_scales(row_ids, None, slot0, nrows)
                np.testing.assert_array_equal(ones, (sc > 0).astype(np.float32))
                tiles_seen += 1
                short += nrows < 64
                padded += int((row_ids[slot0 : slot0 + nrows] == 0).sum())
    assert tiles_seen and short and padded
    if case == "small bucket":
        assert virtual.bucket_sizes[RM_NB - 1] == 10 and sizes[RM_NB - 2] == 0


def _rowmap_model_scan(queries, qidx, pair_bucket, ptr, chunk_of, store, scales, qscales=None,
                       row_ids=None, *, k, qtile, chunk, mode):
    """``scan_pairs`` over a virtual store of an int8 corpus as the row-map
    bodies compute it, modelled: each block's tiles in scan order, each
    stage gathered through the grid (``_gathered_stage``), the A fragments
    of its k-steps by the lanes' depth map (``_lane_depths``) against the B
    values of ``operand_queries(..., wgmma_qd)``; bf16: one sum over the
    stages (exact here, then f32); f32: each stage's hi, mid and lo sums
    (f32) folded into the running sum with rounded adds, lo + mid, + hi
    (``fold_terms``); the epilogue ``distance<false>`` with the scale
    through the grid; each query's first ``k`` by (distance, scan
    position)."""
    assert row_ids is not None and store.dtype == torch.int8 and qscales is None
    from learnedmetricindex_tpu_torch.ops.select import smallest_k

    d = store.shape[1]
    qd = -(-d // QD_STEP) * QD_STEP
    corpus, ids = store.numpy(), row_ids.numpy()
    rs = None if scales is None else scales.numpy()
    op = scan_kernel.operand_queries(queries, mode, torch.int8, qd).double().numpy()
    depth = _lane_depths()
    ptr_h, cl = ptr.numpy(), chunk_of.numpy()
    n_pairs = pair_bucket.shape[0]
    out_d = torch.full((n_pairs, qtile, k), torch.inf)
    out_s = torch.full((n_pairs, qtile, k), -1, dtype=torch.int32)
    qi = qidx.reshape(n_pairs, qtile).numpy()
    per_chunk = -(-chunk // 64)
    for p, b in enumerate(pair_bucket.numpy()):
        rows_q = np.maximum(qi[p], 0)
        dist, slots = [], []
        n_tiles = (ptr_h[b + 1] - ptr_h[b]) * per_chunk
        tiles = {}
        for wg in range(2):  # tile i is consumer i % 2's: their union in scan order
            for i, tile in enumerate(_ring_tiles(ptr_h[b], ptr_h[b + 1], cl, chunk, wg)):
                tiles[wg + 2 * i] = tile
        assert sorted(tiles) == list(range(n_tiles))
        for i in range(n_tiles):
            slot0, nrows = tiles[i]
            acc = np.zeros((64, qtile), np.float32)
            total = np.zeros((64, qtile))
            for st in range(qd // 128):
                stage = _gathered_stage(corpus, ids, slot0, nrows, st).astype(np.float64)
                fresh = np.zeros((3, 64, qtile))
                for ks in range(8):
                    a = stage[ks // 4][:, depth[ks % 4]]  # (rows, k')
                    for term in range(3 if mode == "f32" else 1):
                        col = term * qd + 128 * st + 16 * ks
                        fresh[term] += a @ op[rows_q, col : col + 16].T
                if mode == "f32":
                    hi, mid, lo = fresh.astype(np.float32)
                    acc = acc + ((lo + mid) + hi)
                else:
                    total += fresh[0]
            raw = acc if mode == "f32" else total.astype(np.float32)
            sc = _grid_scales(ids, rs, slot0, nrows)[:, None]
            v = (raw * -sc).astype(np.float32) + np.where(sc == 0.0, np.inf, 1.0).astype(np.float32)
            dist.append(v[:nrows])
            slots.append(slot0 + np.arange(nrows))
        if not dist:
            continue
        dist_t = torch.as_tensor(np.concatenate(dist).T.copy())  # (qtile, bucket rows)
        slot_t = torch.as_tensor(np.concatenate(slots))
        kk = min(k, dist_t.shape[1])
        vals, pos = smallest_k(dist_t, kk)
        live = torch.as_tensor(qi[p] >= 0)[:, None]
        vals = torch.where(live, vals, torch.inf)
        out_d[p, :, :kk] = vals
        out_s[p, :, :kk] = torch.where(torch.isinf(vals), -1, slot_t[pos]).int()
    return out_d, out_s


@pytest.mark.parametrize("case", ["in order", "shuffled", "small bucket"])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_rowmap_models_match_jax_virtual_search(rowmap_built, monkeypatch, case, precision):
    """The row-map bodies, modelled over the gathered ring stages
    (``_rowmap_model_scan``, bf16 for the default search, f32 for
    ``highest``) in the scan's place, give the port's search over the
    virtual store the JAX package's search over its virtual store of the
    same int8 + row-scale corpus and buckets: ``highest`` at the parity bar
    (rtol 1e-4, atol 1e-5, ids differing only at ties), the default at the
    bf16 bar (atol 3e-3, 99% of the ids); visits 1 and 3, the chunk lists
    in and out of physical order, a bucket smaller than one tile."""
    from learnedmetricindex_tpu_torch.index import bucket_store

    pidx, jidx, queries = (rowmap_built[n] for n in ("pidx", "jidx", "queries"))
    virtual, _, pred = _rowmap_stores(rowmap_built, case)
    calls = []

    def model(*args, **kw):
        calls.append(kw["mode"])
        return _rowmap_model_scan(*args, **kw)

    monkeypatch.setattr(bucket_store, "scan_pairs", model)
    for n_buckets in (1, 3):
        kw = dict(n_buckets=n_buckets, k=10, precision=precision)
        pd, pi, _ = pidx.search(None, queries, None, queries, pred, store=virtual, **kw)
        jd, ji, _ = jidx.search(None, queries, rowmap_built["jax"], queries, pred, **kw)
        jd, ji = np.asarray(jd), np.asarray(ji)
        assert jidx.get_bucket_store(rowmap_built["jax"], pred).chunk_data is None
        if precision == "highest":
            np.testing.assert_allclose(pd, jd, rtol=1e-4, atol=1e-5)
            mism = pi != ji
            if mism.any():
                np.testing.assert_allclose(pd[mism], jd[mism], rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_allclose(pd, jd, atol=3e-3)
            assert (np.sort(pi, axis=1) == np.sort(ji, axis=1)).mean() >= 0.99
    assert calls == ["f32" if precision == "highest" else "bf16"] * 2


@pytest.mark.parametrize("mode", ["bf16", "f32"])
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_length_counts_the_rowmap_blocks_m_tiles(mode, seed):
    """The split's cost model for the row-map bodies (their blocks are the
    packed bodies', 64 query slots for bf16 and 32 for f32, as
    ``lmi_scan_body`` reports them): a pair's 128 slots are two blocks of
    64 or four of 32, each computing its m-tiles up to its last live one;
    the segment keeps the heaviest block within the share of a slot's fair
    share, and a block with no live slot costs nothing."""
    block = RM_SLOTS[mode]
    rng = np.random.default_rng(seed + 40)
    counts = rng.integers(0, 60, 25)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    pair_bucket = rng.integers(0, 25, 40)
    live = rng.integers(0, 256, 40)
    live[:3] = [0b1, 0b10000000, 0b10001001]
    slots = 132
    seg = scan_kernel.segment_length(ptr, pair_bucket, live, width=32, slots=slots,
                                     wgmma_block=block)
    m = block // 16
    blocks = np.zeros((40, 128 // block), np.int64)
    for p in range(40):
        for blk in range(128 // block):
            bits = [(live[p] >> (m * blk + i)) & 1 for i in range(m)]
            blocks[p, blk] = max((i + 1 for i in range(m) if bits[i]), default=0)
    expect = {64: [[1, 0], [0, 4], [4, 4]], 32: [[1, 0, 0, 0], [0, 0, 0, 2], [1, 2, 0, 2]]}
    np.testing.assert_array_equal(blocks[:3], expect[block])
    chunks = counts[pair_bucket]
    fair = (chunks[:, None] * blocks).sum() / slots
    heaviest = blocks[chunks > 0].max()
    assert seg >= 1
    if seg > 1:
        assert seg * heaviest <= scan_kernel.SEGMENT_SHARE * fair
    assert (seg + 1) * heaviest > scan_kernel.SEGMENT_SHARE * fair


@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_rowmap_bodies_keep_their_widest_tile_resident(mode):
    """The row-map bodies' blocks in 232,448 B: the packed bodies' heads
    with the barriers of their own ring depths (RM_STAGES, RM3_STAGES read
    from the source), rings of two consumers × those stages of two 64 ×
    64-byte boxes, and the resident queries (64 slots × 2 bytes a depth,
    or three planes of 32 slots).  The widest tiles are 896 and 768 (d
    rounded up to 128), as the library's scope and ``chip_smoke.py`` take
    them; at d 768 the f32 body could not hold a fourth stage."""
    from learnedmetricindex_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / "scan_pairs.cu").read_text()
    import re

    stages = dict(zip(("bf16", "f32"), map(int, re.search(
        r"constexpr int RM_STAGES = (\d+), RM3_STAGES = (\d+);", src).groups())))[mode]
    slots = RM_SLOTS[mode]
    per_depth = slots * 2 if mode == "bf16" else 3 * slots * 2
    head = _w_head_bytes(slots, 32, stages, 0)

    def block(qd, n=stages):
        return _w_head_bytes(slots, 32, n, 0) + 2 * n * 2 * 64 * 64 + per_depth * qd

    widest = RM_MAX_QD[mode]
    assert widest % QD_STEP == 0 and block(widest) <= 232448 < block(widest + QD_STEP)
    assert head % 1024 == 0 and block(768) <= 232448
    if mode == "f32":
        assert block(768, stages + 1) > 232448
