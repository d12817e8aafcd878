"""The wgmma bodies of the scan kernel (bf16 queries over an int8 or an
f32 packed store at list width 32) as far as the CPU can check them: the
query layouts their B operand reads (WGMMA_ORDER, WGMMA_F32_ORDER)
against a model of the registers their lanes widen or round, and the
split's cost model for their 64-slot blocks.  Which body a launch takes
is the library's to say (test_torch_cuda.py asks it), and the kernels
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
