"""The split scan: each launch cuts the pairs' chunk lists into segments
(``split_pairs``), scans each (pair, segment) item as a pseudo-bucket
and merges each pair's item lists back into one (the merge kernel's
plain version, ``merge_split_lists_reference``).  On the CPU the items
run through the scan's plain version: the split path is held bit for bit
to one scan of each whole bucket, and to the JAX package's Pallas kernel
(interpret mode) at the parity bar.  The CUDA kernels are held to these
in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from learnedmetricindex_tpu_torch.index import mutation as pmut
from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore, scan_inputs
from learnedmetricindex_tpu_torch.ops import quantize, scan_kernel
from test_torch_cuda import _shuffled  # a store with its chunks moved
from test_torch_rounds import CHUNK, QTILE, _jax_pairs, _stores
from test_torch_scan_kernel import _jax_pairs as _jax_case_pairs
from test_torch_scan_kernel import _setup, _torch_inputs

torch.set_num_threads(2)

BIG = 10**6  # a segment longer than any bucket: nothing is cut


def _segment(args, segment, qtile, k, slots=6):
    """``segment``, or for "auto" the wrapper's own choice over ``slots``
    slots (a few, so that these small plans are cut but not all to 1)."""
    if segment != "auto":
        return segment
    ptr_h, pb_h, live = scan_kernel.host_plan(args[3], args[2], args[1], qtile)
    width = scan_kernel.list_width(min(k, scan_kernel.MAX_K))
    return scan_kernel.segment_length(ptr_h, pb_h, live, width=width, slots=slots)


def _split_round(args, segment, *, qtile, chunk, mode):
    """``scan_round(qidx, pair_bucket, k, floor)`` of ``scan_in_rounds``:
    the split path with the scan's plain version on each item and the
    plain merge."""
    queries, _, _, ptr, chunk_of, *rest = args
    ptr_h = ptr.numpy()

    def scan_round(qidx, pair_bucket, w, floor):
        def items(i_qidx, i_bucket, i_ptr, i_floor):
            return scan_kernel.scan_pairs_reference(
                queries, i_qidx, i_bucket, i_ptr, chunk_of, *rest, k=w, qtile=qtile,
                chunk=chunk, mode=mode, floor=i_floor)

        return scan_kernel.scan_split(items, scan_kernel.merge_split_lists_reference, qidx, floor,
                                      ptr_h, pair_bucket.numpy(), segment, qtile=qtile,
                                      chunk=chunk)

    return scan_round


def _split_scan(args, segment, *, k, qtile, chunk, mode, width=scan_kernel.MAX_K):
    """The split path over the plan of ``args``, in rounds of ``width``
    past it (as the CUDA wrapper runs k above 1024)."""
    scan_round = _split_round(args, segment, qtile=qtile, chunk=chunk, mode=mode)
    if k <= width:
        return scan_round(args[1], args[2], k, None)
    store, row_ids = args[5], args[8]
    n_slots = store.shape[0] if row_ids is None else row_ids.shape[0]
    positions = scan_kernel.chunk_positions(args[3], args[4], n_slots // chunk)
    return scan_kernel.scan_in_rounds(scan_round, args[1], args[2], positions, k=k, qtile=qtile,
                                      chunk=chunk, width=width)


# ----------------------------------------------------------------------
# the work list
# ----------------------------------------------------------------------
@pytest.mark.parametrize("segment", [1, 2, 3, 7, BIG])
def test_split_pairs_covers_each_chunk_list_once_in_order(segment):
    """Each pair's items are consecutive and their segments, in item
    order, are its bucket's chunk list exactly, each of at most
    ``segment`` entries; a bucket of at most ``segment`` chunks leaves its
    pairs one item, and an empty one one item with no chunks.  The
    segments refine the bucket CSR, and each item's offset is where its
    segment starts in the bucket's list."""
    rng = np.random.default_rng(segment)
    counts = rng.integers(0, 10, 14)
    counts[[2, 9]] = 0
    ptr = np.concatenate([[0], np.cumsum(counts)])
    pair_bucket = rng.integers(0, 14, 40)
    work = scan_kernel.split_pairs(ptr, pair_bucket, segment)
    seg = work.seg_ptr
    assert seg[0] == 0 and seg[-1] == ptr[-1] and (np.diff(seg) >= 0).all()
    assert set(ptr.tolist()) <= set(seg.tolist())
    assert (np.diff(work.item_pair) >= 0).all()
    np.testing.assert_array_equal(work.pair_items, np.searchsorted(work.item_pair,
                                                                   np.arange(41)))
    for p, b in enumerate(pair_bucket):
        items = np.arange(work.pair_items[p], work.pair_items[p + 1])
        lengths = seg[work.item_segment[items] + 1] - seg[work.item_segment[items]]
        covered = np.concatenate([np.arange(seg[g], seg[g + 1]) for g in work.item_segment[items]])
        np.testing.assert_array_equal(covered, np.arange(ptr[b], ptr[b + 1]))
        assert (lengths <= segment).all()
        assert len(items) == max(1, -(-counts[b] // segment))
        np.testing.assert_array_equal(work.item_offset[items],
                                      seg[work.item_segment[items]] - ptr[b])
        if counts[b] <= segment:
            assert len(items) == 1 and lengths[0] == counts[b]
    with pytest.raises(ValueError, match="segment"):
        scan_kernel.split_pairs(ptr, pair_bucket, 0)


@pytest.mark.parametrize("width", [32, 64, 128, 256, 1024])
def test_segment_length_bounds_every_block(width):
    """The segment is the longest that keeps each block's work (its
    chunks × the m-tiles it computes: all 8 at width 32, else the live
    ones of its own query slots) within the share of a slot's fair share;
    where no block has work nothing is cut."""
    rng = np.random.default_rng(width)
    counts = rng.integers(0, 80, 30)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    pair_bucket = rng.integers(0, 30, 50)
    live = rng.integers(0, 256, 50)
    slots = 264
    seg = scan_kernel.segment_length(ptr, pair_bucket, live, width=width, slots=slots)
    bits = (live[:, None] >> np.arange(8)) & 1
    if width == 32:
        bits[:] = 1
    per_block = scan_kernel.queries_per_block(width) // 16
    blocks = bits.reshape(50, -1, per_block).sum(axis=2)
    chunks = counts[pair_bucket]
    fair = (chunks[:, None] * blocks).sum() / slots
    heaviest = blocks[chunks > 0].max()
    assert seg >= 1
    if seg > 1:
        assert seg * heaviest <= scan_kernel.SEGMENT_SHARE * fair
    assert (seg + 1) * heaviest > scan_kernel.SEGMENT_SHARE * fair
    assert scan_kernel.segment_length(ptr, pair_bucket, live, width=width,
                                      slots=slots, share=0.25) <= seg
    if width != 32:  # no live query anywhere: no block has work
        assert scan_kernel.segment_length(ptr, pair_bucket, np.zeros(50, np.int64), width=width,
                                          slots=slots) == counts.max()


def test_host_plan_reads_live_m_tiles():
    qidx = torch.full((3 * 40,), -1, dtype=torch.int32)
    qidx[0] = 5  # pair 0: m-tile 0
    qidx[40 + 17] = 1  # pair 1: m-tile 1
    qidx[80 + 32:80 + 40] = 2  # pair 2: m-tile 2 (the tile 32..39 of a 40-slot qtile)
    ptr = torch.tensor([0, 3, 5], dtype=torch.int32)
    pb = torch.tensor([1, 0, 1], dtype=torch.int32)
    ptr_h, pb_h, live = scan_kernel.host_plan(ptr, pb, qidx, 40)
    np.testing.assert_array_equal(ptr_h, [0, 3, 5])
    np.testing.assert_array_equal(pb_h, [1, 0, 1])
    np.testing.assert_array_equal(live, [1, 2, 4])


# ----------------------------------------------------------------------
# the merge
# ----------------------------------------------------------------------
def test_merge_keeps_the_tie_rule_across_items():
    """(distance, item order, place in list): equal distances go to the
    earlier item, then the earlier place; a one-item pair is copied; fill
    past what the items hold.  Also random lists against a sort."""
    inf = float("inf")
    d = torch.tensor([[[1.0, 2.0, inf, inf]], [[1.0, 1.0, 2.0, inf]], [[0.5, 2.0, inf, inf]],
                      [[3.0, inf, inf, inf]], [[inf] * 4], [[inf] * 4]])
    s = torch.tensor([[[10, 11, -1, -1]], [[20, 21, 22, -1]], [[30, 31, -1, -1]],
                      [[40, -1, -1, -1]], [[-1] * 4], [[-1] * 4]], dtype=torch.int32)
    pair_items = torch.tensor([0, 3, 4, 6], dtype=torch.int32)
    md, ms = scan_kernel.merge_split_lists(d, s, pair_items)
    assert md.tolist() == [[[0.5, 1.0, 1.0, 1.0]], [[3.0, inf, inf, inf]], [[inf] * 4]]
    assert ms.tolist() == [[[30, 10, 20, 21]], [[40, -1, -1, -1]], [[-1] * 4]]
    md, ms = scan_kernel.merge_split_lists(d[:0], s[:0], pair_items[:1])  # no pairs
    assert md.shape == ms.shape == (0, 1, 4)

    rng = np.random.default_rng(5)
    n_pairs, qtile, k = 7, 3, 6
    per_pair = rng.integers(1, 6, n_pairs)
    pair_items = np.concatenate([[0], np.cumsum(per_pair)])
    n_items = pair_items[-1]
    vals = rng.integers(0, 5, (n_items, qtile, k)).astype(np.float32)  # many exact ties
    vals[rng.random((n_items, qtile, k)) < 0.3] = np.inf
    vals.sort(axis=2)
    slots = np.where(np.isinf(vals), -1, rng.permutation(n_items * qtile * k).reshape(vals.shape))
    md, ms = scan_kernel.merge_split_lists(torch.as_tensor(vals),
                                           torch.as_tensor(slots, dtype=torch.int32),
                                           torch.as_tensor(pair_items, dtype=torch.int32))
    for p in range(n_pairs):
        for q in range(qtile):
            entries = sorted((vals[i, q, j], i, j, slots[i, q, j])
                             for i in range(pair_items[p], pair_items[p + 1]) for j in range(k))
            want_d = [e[0] for e in entries[:k]]
            want_s = [e[3] if np.isfinite(e[0]) else -1 for e in entries[:k]]
            assert md[p, q].tolist() == want_d and ms[p, q].tolist() == want_s


def test_scan_split_merges_only_where_a_pair_splits():
    """Where every pair is one item, ``scan_split`` returns the scan's own
    tensors and never calls ``merge``; a work list that cuts a pair calls
    it once, with the most items a pair has (a host integer)."""
    ptr = np.array([0, 3, 4, 10, 10])  # buckets of 3, 1, 6 and 0 chunks
    qtile, k = 2, 4
    made, calls = [], []

    def scan_items(i_qidx, i_bucket, i_ptr, i_floor):
        assert i_qidx.shape == (i_bucket.shape[0] * qtile,)
        made.append((torch.rand(i_bucket.shape[0], qtile, k),
                     torch.zeros(i_bucket.shape[0], qtile, k, dtype=torch.int32)))
        return made[-1]

    def merge(d, s, pair_items, max_items):
        assert d is made[-1][0] and s is made[-1][1]
        calls.append((pair_items.tolist(), max_items))
        return "merged"

    for pairs, segment in (([0, 2, 3], BIG), ([0, 1, 3], 6), ([0, 1, 1], 3)):
        qidx = torch.arange(len(pairs) * qtile, dtype=torch.int32)
        out = scan_kernel.scan_split(scan_items, merge, qidx, None, ptr, np.array(pairs), segment,
                                     qtile=qtile, chunk=8)
        assert out[0] is made[-1][0] and out[1] is made[-1][1] and not calls
    out = scan_kernel.scan_split(scan_items, merge, torch.arange(6, dtype=torch.int32), None, ptr,
                                 np.array([0, 2, 3]), 2, qtile=qtile, chunk=8)
    assert out == "merged" and calls == [([0, 2, 5, 6], 3)]


@pytest.mark.parametrize("k", [1, 2, 5, 16, 32, 64, 100, 106, 128, 256, 512, 1000, 1024])
def test_merge_plan_fits_every_shape(k):
    """The merge kernel's plan over query tiles 1-128 and 1-80 items a pair
    (and an unknown count): lists of at most 32 merged in a warp's lanes (a
    group of 16 slots, nothing staged); wider, a group of 1 to qtile query
    slots, the widest of at most 8 whose staged lists fit in the target, or
    of one slot past it; the shared memory the source's formula gives, within the
    budget; streamed (cap 0, no shared memory, a warp a slot) only where
    one slot's lists of every item pass the budget: at k 1024 from 24 items
    on."""
    for qtile in (1, 2, 3, 8, 100, 127, 128):
        for items in (None, 1, 2, 3, 7, 16, 23, 24, 25, 40, 80):
            plan = scan_kernel.merge_plan(k, qtile, items)
            assert 1 <= plan.group <= qtile
            cap = scan_kernel.MERGE_DEFAULT_CAP if items is None else items
            if k <= scan_kernel.MERGE_WARP_MAX_K:
                assert plan == (min(qtile, scan_kernel.MERGE_WARP_GROUP), 0, 0)
            elif cap < 2:  # no pair to merge: the blocks copy
                assert plan.cap == cap and plan.smem == 0
            elif plan.cap == 0:
                assert scan_kernel.merge_smem_bytes(1, cap, k) > scan_kernel.MERGE_SMEM_MAX
                assert plan.smem == 0 and plan.group == min(qtile, scan_kernel.MERGE_WARPS)
            else:
                assert plan.cap == cap
                assert plan.smem == scan_kernel.merge_smem_bytes(plan.group, cap, k)
                assert plan.smem <= scan_kernel.MERGE_SMEM_MAX
                assert plan.smem <= scan_kernel.MERGE_SMEM_TARGET or plan.group == 1
                if plan.group < min(qtile, scan_kernel.MERGE_WARPS):
                    assert (scan_kernel.merge_smem_bytes(plan.group + 1, cap, k)
                            > scan_kernel.MERGE_SMEM_TARGET)
    # each run: the group's values, up to 3 ahead of them, whole 16 bytes
    assert scan_kernel.merge_smem_bytes(3, 2, 5) == 6 * 20 * 4  # 15 + 3 values -> 20
    assert scan_kernel.merge_smem_bytes(1, 1, k) == 0
    if k == 1024:
        assert scan_kernel.merge_plan(k, 128, 23).cap == 23
        assert scan_kernel.merge_plan(k, 128, 24).cap == 0


def _merge_model(item_d, item_s, pair_items, plan, offsets=(0, 0, 0, 0)):
    """A numpy model of ``csrc/scan_merge.cu`` under ``plan``: a block a
    (pair, group of query slots); a pair without items written as fill,
    one item copied; lists of k <= 32 merged in a warp's 16 or 32 lanes a
    slot (the running list and each next item padded with +inf to the
    lanes, each entry ranked in their union by the other list's entries
    below it: < for the running list's, <= for the item's; the places
    below k taken back; slot -1 where +inf); wider lists, 2 .. cap items
    staged (each run of the group's lists placed in shared memory at its
    first value's place within 16 bytes, the output run filled with +inf /
    -1 first, each finite entry placed by binary searches over the first
    k - place entries of the other lists: <= in earlier items, < in later
    ones; past k - 1 it drops out; the output run written back); more
    streamed, a warp a slot (the finite count, the same placement, the
    fill past the count).  ``offsets``: where item distances, item slots,
    output distances and output slots start within their 16 bytes.
    Unwritten output stays NaN / -7."""
    n_items, qtile, k = item_d.shape
    n_pairs = len(pair_items) - 1
    o_id, o_is, o_od, o_os = offsets
    gd = np.concatenate([np.zeros(o_id, np.float32), item_d.ravel()])
    gs = np.concatenate([np.zeros(o_is, np.int32), item_s.ravel()])
    out_d = np.full(o_od + n_pairs * qtile * k, np.nan, np.float32)
    out_s = np.full(o_os + n_pairs * qtile * k, -7, np.int32)
    groups = -(-qtile // plan.group)
    run = (plan.group * k + 6) // 4 * 4
    assert plan.smem == (scan_kernel.merge_smem_bytes(plan.group, plan.cap, k))

    def place_of(v, i, j, lists):
        place = i
        for o, other in enumerate(lists):
            if place >= k:
                break
            if o != j:
                place += int(np.searchsorted(other[:k - place], v,
                                             side="right" if o < j else "left"))
        return place

    for block in range(n_pairs * groups):
        pair, s0 = divmod(block, groups)
        s0 *= plan.group
        ns = min(plan.group, qtile - s0)
        size = ns * k
        i0, n = pair_items[pair], pair_items[pair + 1] - pair_items[pair]
        out = (pair * qtile + s0) * k
        at = [((i0 + j) * qtile + s0) * k for j in range(n)]
        if n <= 0:
            out_d[o_od + out:o_od + out + size] = np.inf
            out_s[o_os + out:o_os + out + size] = -1
        elif n == 1:
            out_d[o_od + out:o_od + out + size] = gd[o_id + at[0]:o_id + at[0] + size]
            out_s[o_os + out:o_os + out + size] = gs[o_is + at[0]:o_is + at[0] + size]
        elif k <= scan_kernel.MERGE_WARP_MAX_K:
            lanes = 16 if k <= 16 else 32

            def padded(a, slot, g):
                row = np.full(lanes, np.inf if g is gd else -1, g.dtype)
                start = (o_id if g is gd else o_is) + a + slot * k
                row[:k] = g[start:start + k]
                return row

            for slot in range(ns):
                run_d, run_s = padded(at[0], slot, gd), padded(at[0], slot, gs)
                for a in at[1:]:
                    it_d, it_s = padded(a, slot, gd), padded(a, slot, gs)
                    r_run = np.arange(lanes) + np.searchsorted(it_d, run_d, side="left")
                    r_item = np.arange(lanes) + np.searchsorted(run_d, it_d, side="right")
                    md = np.full(lanes, np.nan, np.float32)
                    ms = np.full(lanes, -9, np.int32)
                    for r, v, sl in zip(np.concatenate([r_run, r_item]),
                                        np.concatenate([run_d, it_d]),
                                        np.concatenate([run_s, it_s])):
                        if r < k:
                            assert np.isnan(md[r])  # no place taken twice
                            md[r], ms[r] = v, sl
                    run_d = np.where(np.arange(lanes) < k, md, np.inf).astype(np.float32)
                    run_s = np.where(np.arange(lanes) < k, ms, -1).astype(np.int32)
                w = out + slot * k
                out_d[o_od + w:o_od + w + k] = run_d[:k]
                out_s[o_os + w:o_os + w + k] = np.where(run_d[:k] < np.inf, run_s[:k], -1)
        elif n <= plan.cap:
            sd = np.full((plan.cap, run), np.nan, np.float32)
            ss = np.full((plan.cap, run), -9, np.int32)
            rd = [(o_id + a) % 4 for a in at]
            rs = [(o_is + a) % 4 for a in at]
            for j, a in enumerate(at):
                sd[j, rd[j]:rd[j] + size] = gd[o_id + a:o_id + a + size]
                ss[j, rs[j]:rs[j] + size] = gs[o_is + a:o_is + a + size]
            r_od, r_os = (o_od + out) % 4, (o_os + out) % 4
            md = np.full(run, np.nan, np.float32)
            ms = np.full(run, -9, np.int32)
            md[r_od:r_od + size], ms[r_os:r_os + size] = np.inf, -1
            for j in range(n):
                for rem in range(size):
                    v = sd[j, rd[j] + rem]
                    if not v < np.inf:
                        continue
                    slot, i = divmod(rem, k)
                    lists = [sd[o, rd[o] + slot * k:rd[o] + slot * k + k] for o in range(n)]
                    place = place_of(v, i, j, lists)
                    if place < k:
                        md[r_od + slot * k + place] = v
                        ms[r_os + slot * k + place] = ss[j, rs[j] + rem]
            out_d[o_od + out:o_od + out + size] = md[r_od:r_od + size]
            out_s[o_os + out:o_os + out + size] = ms[r_os:r_os + size]
        else:
            for slot in range(ns):
                lists = [gd[o_id + a + slot * k:o_id + a + slot * k + k] for a in at]
                slots = [gs[o_is + a + slot * k:o_is + a + slot * k + k] for a in at]
                w = out + slot * k
                n_finite = sum(int(np.searchsorted(lst, np.inf)) for lst in lists)
                for j in range(n):
                    for i in range(k):
                        if not lists[j][i] < np.inf:
                            break
                        place = place_of(lists[j][i], i, j, lists)
                        if place < k:
                            out_d[o_od + w + place] = lists[j][i]
                            out_s[o_os + w + place] = slots[j][i]
                out_d[o_od + w + n_finite:o_od + w + k] = np.inf
                out_s[o_os + w + n_finite:o_os + w + k] = -1
    return (out_d[o_od:].reshape(n_pairs, qtile, k), out_s[o_os:].reshape(n_pairs, qtile, k))


@pytest.mark.parametrize("offsets", [(0, 0, 0, 0), (1, 3, 2, 1)])
@pytest.mark.parametrize("plan_kind", ["staged", "narrow", "default cap", "streamed"])
@pytest.mark.parametrize("k,qtile", [(1, 3), (7, 5), (16, 3), (20, 2), (33, 3), (40, 5)])
def test_merge_model_matches_plain_version(k, qtile, plan_kind, offsets):
    """The kernel's placement, modelled in numpy (``_merge_model``), equals
    ``merge_split_lists_reference`` bit for bit: exact ties across items
    (the earlier item first), all-+inf items, a pair without items,
    one-item pairs among split ones, groups that do not divide the query
    tile, runs that start anywhere within 16 bytes; lists of at most 32 in
    the lanes of a warp (16 or 32 a slot), wider ones under the plan for
    the most items a pair has, a plan of two-slot groups, the default cap
    (pairs past it streamed) and a streamed plan."""
    rng = np.random.default_rng(k * 100 + qtile)
    per_pair = np.array([1, 4, 0, 1, 2, 11, 3, 1, 5])
    pair_items = np.concatenate([[0], np.cumsum(per_pair)])
    n_items = int(pair_items[-1])
    vals = rng.integers(0, 6, (n_items, qtile, k)).astype(np.float32)  # many exact ties
    vals[rng.random(vals.shape) < 0.25] = np.inf
    vals[pair_items[1] + 1] = np.inf  # an empty item inside a split pair
    vals.sort(axis=2)
    slots = np.where(np.isinf(vals), -1, rng.permutation(vals.size).reshape(vals.shape))
    slots = slots.astype(np.int32)
    most = int(per_pair.max())
    plan = {"staged": scan_kernel.merge_plan(k, qtile, most),
            "narrow": scan_kernel.MergePlan(min(2, qtile), most,
                                            scan_kernel.merge_smem_bytes(min(2, qtile), most, k)),
            "default cap": scan_kernel.merge_plan(k, qtile),
            "streamed": scan_kernel.MergePlan(min(qtile, scan_kernel.MERGE_WARPS), 0, 0)}[plan_kind]
    md, ms = _merge_model(vals, slots, pair_items, plan, offsets)
    rd, rs = scan_kernel.merge_split_lists_reference(
        torch.as_tensor(vals), torch.as_tensor(slots),
        torch.as_tensor(pair_items, dtype=torch.int32))
    np.testing.assert_array_equal(md.view(np.int32), rd.numpy().view(np.int32))
    np.testing.assert_array_equal(ms, rs.numpy())


# ----------------------------------------------------------------------
# the split path against one scan of each whole bucket
# ----------------------------------------------------------------------
def _tied_stores(layout, store_type):
    """600×12 rows in 4 buckets of ~150 (5 chunks of 32), every row three
    times in its bucket, so exact ties straddle segment boundaries; in
    ``store_type`` (int8 with its row scales); ``shuffled``: chunks moved
    out of physical order after 30 deletes; ``virtual``: the id grid over
    the corpus."""
    rng = np.random.default_rng(8)
    base = rng.normal(size=(200, 12)).astype(np.float32)
    data = torch.as_tensor(np.concatenate([base, base, base]))
    bucket_ids = np.tile(rng.integers(0, 4, 200), 3)
    rows, scales = data, None
    if store_type == "int8":
        rows, scales = quantize.quantize_rows(data)
    elif store_type == "bf16":
        rows = data.bfloat16()
    if layout == "virtual":
        store = BucketStore.build_virtual(rows, bucket_ids, 4, chunk=32, row_scales=scales)
    else:
        store = BucketStore.build_packed_device(rows, bucket_ids, 4, chunk=32, row_scales=scales)
    if layout == "shuffled":
        store, _ = pmut.delete_ids(pmut.ensure_mutable(store), rng.choice(600, 30, False) + 1)
        store = _shuffled(store, 5)
    queries = data[rng.choice(600, 40)] + 0.01
    order = torch.as_tensor(np.stack([rng.choice(4, 2, replace=False) for _ in range(40)]))
    order[-5:, 1] = -1
    return store, queries, order


@pytest.mark.parametrize("segment", [1, 2, "auto", BIG])
@pytest.mark.parametrize("store_type", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("layout", ["packed", "shuffled", "virtual"])
def test_split_scan_equals_one_scan_of_each_bucket(layout, store_type, segment):
    """Every mode the store takes, list widths 32 to 256 and k past the
    bucket (fill): the split path's lists equal the unsplit plain
    version's bit for bit, with exact ties across segment boundaries (a
    row's earlier copy, in an earlier segment, first)."""
    store, queries, order = _tied_stores(layout, store_type)
    modes = ("bf16", "f32", "int8") if store_type == "int8" else ("bf16", "f32")
    straddled = 0
    for mode in modes:
        for k, qtile in ((10, 16), (60, 8), (200, 16)):
            plan, args = scan_inputs(store, queries, order, qtile, mode)
            kw = dict(k=k, qtile=qtile, chunk=32, mode=mode)
            want = scan_kernel.scan_pairs_reference(*args, **kw)
            got = _split_scan(args, _segment(args, segment, qtile, k), **kw)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            # exact ties between rows of different chunks (segments at S = 1)
            d, s = want
            tie = (d[..., 1:] == d[..., :-1]) & torch.isfinite(d[..., 1:])
            straddled += int((tie & (s[..., 1:] // 32 != s[..., :-1] // 32)).sum())
    assert straddled > 0


@pytest.mark.parametrize("segment", [1, 2])
@pytest.mark.parametrize("layout", ["packed", "shuffled", "virtual"])
@pytest.mark.parametrize("width,k", [(7, 300), (100, 1025)])
def test_split_rounds_equal_one_wide_list(width, k, layout, segment):
    """Rounds of ``width`` over the split path, each round past the first
    under its floor (positions shifted to each segment's start), equal
    the plain version's one list of width k bit for bit: ties straddling
    rounds and segments, padding queries, pairs that run out of rows."""
    store, queries, order = _tied_stores(layout, "f32")
    for mode in ("f32", "bf16"):
        plan, args = scan_inputs(store, queries, order, 16, mode)
        kw = dict(k=k, qtile=16, chunk=32, mode=mode)
        want = scan_kernel.scan_pairs_reference(*args, **kw)
        got = _split_scan(args, segment, width=width, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ----------------------------------------------------------------------
# the split path against the JAX package's Pallas kernel
# ----------------------------------------------------------------------
def _parity(td, ts, jd, js, real):
    """The parity bar: per real query, distances to 1e-4 / 1e-5 and slots
    that differ only at exact distance ties (the Pallas kernel's lists are
    unordered: sorted here by (distance, slot))."""
    o = np.lexsort((js, jd), axis=-1)
    jd, js = np.take_along_axis(jd, o, -1)[real], np.take_along_axis(js, o, -1)[real]
    td, ts = td[real], ts[real]
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-5)
    mism = ts != js
    if mism.any():
        np.testing.assert_allclose(td[mism], jd[mism], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("segment", [1, 2, BIG])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", ["multichunk", "qtile8_empty"])
def test_split_scan_matches_pallas_kernel(case, mode, segment):
    """Multi-chunk buckets (and an empty one), padding queries: the split
    path against the Pallas kernel at the parity bar; pairs the Pallas
    kernel never writes (empty buckets) are fill."""
    store, queries, order, qtile, k, chunk = _setup(case, mode)
    jplan, sf, written, jd, js = _jax_case_pairs(store, queries, order, qtile, k, chunk, mode)
    plan, args = _torch_inputs(store, sf, queries, order, qtile, mode)
    args = (*args, None)
    td, ts = (t.numpy() for t in _split_scan(args, segment, k=k, qtile=qtile, chunk=chunk,
                                             mode=mode))
    real = (jplan.qidx >= 0).reshape(-1, qtile)
    unwritten = real & ~np.asarray(written)[: plan.n_pairs, None]
    assert np.isinf(td[unwritten]).all() and (ts[unwritten] == -1).all()
    _parity(td, ts, jd, js, real & ~unwritten)
    assert np.isinf(td[~real]).all() and (ts[~real] == -1).all()


@pytest.mark.parametrize("segment", [1, 3])
@pytest.mark.parametrize("mutated", [False, True])
@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_split_rounds_match_pallas_at_k_1025(mode, mutated, segment):
    """k_scan 1025 in two rounds of the split path (the second under its
    floors) over fresh stores and stores mutated the same way in both
    packages (chunk lists out of physical order), against the Pallas
    kernel's one list at the parity bar."""
    jstore, store, queries, order = _stores(mode, mutated)
    jplan, jd, js = _jax_pairs(jstore, queries, order, 1025, mode)
    plan, args = scan_inputs(store, torch.as_tensor(queries), torch.as_tensor(order), QTILE, mode)
    assert int((args[3][1:] - args[3][:-1]).max()) > 3  # buckets of several segments
    td, ts = (t.numpy() for t in _split_scan(args, segment, k=1025, qtile=QTILE, chunk=CHUNK,
                                             mode=mode))
    real = (jplan.qidx >= 0).reshape(-1, QTILE)
    assert np.isinf(td[~real]).all() and (ts[~real] == -1).all()
    _parity(td, ts, jd, js, real)
