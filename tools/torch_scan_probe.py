#!/usr/bin/env python3
"""What bounds the scan's default bodies at the flagship, on one NVIDIA GPU.

    python3 tools/torch_scan_probe.py [--body mma|wgmma|mma-f32|wgmma-f32|mma-f32mode|wgmma-f32mode|
                                             mma-wide|wgmma-wide|mma-f32x|wgmma-f32x|mma-s8|
                                             wgmma-s8|mma-s8-wide|wgmma-s8-wide|
                                             mma-f32mode-wide|wgmma-f32mode-wide|
                                             mma-f32-wide|wgmma-f32-wide|wgmma-rowmap|
                                             wgmma-f32mode-rowmap]
                                      [--checkout DIR] [--reference DIR ...]
                                      [--rounds 4] [--only NAME ...]

The card's machine has no ``ncu``, so this splits the time of the bf16
scan at list width 32 (``k_scan`` 16; the wide-list bodies at 106) by
removing work: over the int8
packed store (``--body mma``, ``wgmma``) or over the same rows as an f32
store (``--body mma-f32``, ``wgmma-f32``: ``chip_smoke.dequantized_store``,
31 GB, the default search over ``BuildConfiguration(dtype="float32")``);
and the f32 scan over the int8 store (``mma-f32mode``, ``wgmma-f32mode``)
or over that f32 store (``mma-f32x``, ``wgmma-f32x``), and the int8 scan
over the int8 store (``mma-s8``, ``wgmma-s8``; at ``k_scan`` 106 and 64,
list widths 128 and 64, ``mma-s8-wide``, ``wgmma-s8-wide``), and the f32
scan over the int8 store at those widths (``mma-f32mode-wide``,
``wgmma-f32mode-wide``), and the bf16 scan over the f32 store at those
widths (``mma-f32-wide``, ``wgmma-f32-wide``), and the bf16 and f32 scans
over a virtual store of the int8 corpus (the row map: ``wgmma-rowmap``,
``wgmma-f32mode-rowmap``).
It writes patched copies of ``DIR``'s
``learnedmetricindex_tpu_torch/csrc/scan_pairs.cu`` (default: this
tree's) into ``build/scan_probe/``, builds each (and
``csrc/scan_merge.cu``) with the port's nvcc flags, and times them in one
process, in alternating rounds, split and merged as each source's
wrapper does, on the flagship inputs of ``tools/torch_scan_ab.py``
(10M×768 int8, 120 buckets, 10k queries visiting 4, qtile 128), beside
each ``--reference`` checkout's source as it is.

``--body mma``: the mma.sync body (a checkout without the wgmma body,
for example the commit before it):

* ``tree``: the source as it is;
* ``(a) query tile once``: an item copies its query rows into the ring
  only on its first row tile (later tiles read stale query data);
* ``(b) no widening``: ``widen_s8x4`` reinterprets the int8 bits as bf16;
* ``(c) no selection``: the row tiles are never selected into the lists;
* ``(d) no mma``: the bf16 ``mma.sync`` issues nothing (its operands
  stay live, so the loads and the widening still run);
* ``(a)+(b)+(c)``: all three of those.

``--body wgmma`` (the default): the wgmma body:

* ``tree``;
* ``no wgmma``: the wgmma instructions are comments (operands live);
* ``no widening``: the A registers take the int8 words as they are;
* ``no selection``: ``wgmma_select`` is not called (the hand-over
  between the warpgroups stays);
* ``no hand-over``: neither the hand-over nor the selection;
* ``no TMA``: the producer arrives on the full barriers without copying
  (the consumers read whatever the ring holds);
* ``stages of 1 box, ring 4``: stages of one 64-depth box (four
  k-steps), four a ring, in place of two boxes (eight k-steps, one
  barrier) and two a ring;
* ``bare``: no TMA, no widening, no hand-over: the wgmma and the ring's
  barriers alone;
* ``3 consumers, stages of 1 box, ring 4``: three consumer warpgroups
  (and producer warps) taking the tiles in turn, d <= 768 only;
* ``no wgmma, ...``: the same without the wgmma: what the rest costs.

``--body mma-f32``: the mma.sync body's bf16 instance over an f32 store
(``MmaBody<MODE_BF16, float, 32>``: a checkout where that scan takes it,
for example the commit before the wgmma body over f32 rows):

* ``tree``;
* ``(a) no row stream``: the ring's store rows are written from the
  thread's indices, with no load and no rounding;
* ``(b) no rounding``: each f32 value's top 16 bits in place of
  ``__float2bfloat16_rn`` (the loads kept);
* ``(c) no selection``, ``(d) no mma`` as for ``--body mma``;
* ``(a)+(c)``.

``--body wgmma-f32``: the wgmma body over f32 rows:

* ``tree``, ``no wgmma``, ``no selection``, ``no hand-over``, ``no TMA``,
  ``stages of 1 box, ring 4`` as for ``--body wgmma``;
* ``3 consumers, stages of 1 box, ring 2``: three consumer warpgroups,
  each a ring of two one-box stages (48 KB of rings against the tree's
  64 KB: what fits beside a third distance tile at d 768);
* ``selection: one load a query``: each warp reads its queries' marks one
  after another, as the int8 body does, in place of one load a lane and
  a ballot;
* ``no rounding``: each A register the XOR of the two f32 words it
  would round (the ring's loads kept);
* ``bare``: no TMA, no rounding, no hand-over;
* ``no wgmma, bare``.

``--body mma-f32mode``: the mma.sync body's f32 instance over the int8
packed store (``MmaBody<MODE_F32, int8_t, 32>``, ``precision="highest"``:
the f32 queries as three bf16 terms; a checkout where that scan takes it,
for example the commit before the wgmma body in f32 mode), timed in mode
f32:

* ``tree``;
* ``no mma.sync``, ``no widening``, ``no selection`` as for ``--body mma``;
* ``one query term``: each 16-deep step's mma of the hi term alone (the
  three terms' rows still copied);
* ``no mma.sync, no widening, no selection``.

``--body wgmma-f32mode``: the wgmma body in f32 mode over the int8 packed
store, timed in mode f32:

* ``tree``, ``no wgmma``, ``no widening``, ``no selection``, ``no
  hand-over``, ``no TMA``, ``bare``, ``no wgmma, bare`` as for ``--body
  wgmma``;
* ``one wait a stage``: the next stage's first box widened after the
  stage's fold, not while its second box's wgmma runs;
* ``fold: the hi term alone``: each stage folds only the hi term's sum
  into the running sum (the mid and lo sums computed, not added);
* ``three wgmma m64nNk16 a k-step``: the three planes as three wgmma of
  N columns (each into its own third of the fresh sum) in place of one
  of 3N columns.

``--body mma-wide``: the mma.sync body's bf16 instance over the int8
packed store at list width 128 (``MmaBody<MODE_BF16, int8_t, 128>``: a
checkout where that scan takes it, for example the commit before the
wide-list wgmma body), timed at ``k_scan`` 106 (``search(k=100)``):

* ``tree``, ``(a) query tile once``, ``(b) no widening``, ``(c) no
  selection``, ``(d) no mma``, ``(a)+(b)+(c)`` as for ``--body mma``.

``--body wgmma-wide``: the wide-list wgmma body over the int8 packed
store, timed at ``k_scan`` 106:

* ``tree``, ``no wgmma``, ``no widening``, ``no TMA``, ``bare``, ``no
  wgmma, bare`` as for ``--body wgmma``;
* ``no selection``: ``wgmma_select_wide`` is not called (the hand-over
  stays); ``no hand-over``: neither;
* ``no merge``: the selection finds each marked query's candidates but
  merges none into its list (which stays empty, so every query is marked
  on every tile and every row of it is a candidate; the compiler drops
  the counting that no write reads): the walk over the marks alone;
* ``32 slots a block``: a block keeps 32 query slots (a pair takes four
  blocks) in place of 64.

``--body mma-f32x``: the mma.sync body's six-term instance over an f32
store (``MmaBody<MODE_F32, float, 32>``, ``precision="highest"`` over
``BuildConfiguration(dtype="float32")``: a checkout where that scan takes
it, for example the commit before the six-term wgmma body), timed in mode
f32 over the flagship's rows as an f32 store:

* ``tree``, ``no mma.sync``, ``no selection`` as for ``--body mma``;
* ``no split``: ``split3`` hands on the value's bits (the loads kept);
* ``no mma.sync, no split, no selection``.

``--body wgmma-f32x``: the six-term wgmma body, timed in mode f32 over
that f32 store:

* ``tree``, ``no wgmma``, ``no selection``, ``no hand-over``, ``no TMA``
  as for ``--body wgmma``;
* ``no split``: ``split_pair`` packs the hi term and hands on that word
  with bits flipped as the other two;
* ``16 slots a block``: 16 query slots (a pair in eight blocks) and the
  two-box stages of the body over f32 rows in place of 32 slots and
  one-box stages;
* ``ring of 3 one-box stages (d <= 768)``: three stages a consumer;
* ``x_hi · [q_hi, q_mid] in one m64n(2N)k16``: those two products as one
  wgmma over adjacent planes, a ``wgmma.fence``, then the other four;
* ``one sum for the six products``: the five small products into the
  large sum too (the first design's rounding, for its time);
* ``bare``: no TMA, no split, no hand-over; ``no wgmma, bare``.

``--body mma-s8``: the mma.sync body's int8 instance over the int8 packed
store (``MmaBody<MODE_INT8, int8_t, 32>``, ``precision="int8"``: a
checkout where that scan takes it, for example the commit before the
int8 wgmma body), timed in mode int8:

* ``tree``, ``(a) query tile once``, ``(c) no selection`` as for ``--body
  mma``;
* ``(d) no mma``: the s8 ``mma.sync`` issues nothing;
* ``(a)+(c)+(d)``.

``--body wgmma-s8``: the int8 wgmma body, timed in mode int8:

* ``tree``, ``no wgmma`` (the s8 wgmma instructions are comments), ``no
  selection``, ``no hand-over``, ``no TMA`` as for ``--body wgmma``;
* ``ring of 2 stages``, ``3``, ``5``, ``6``: ``WS8_STAGES`` stages a
  consumer in place of 4;
* ``selection: one load a query``: each warp reads its queries' marks one
  after another, as the bf16 body over int8 rows does;
* ``A from shared memory``: the store rows as wgmma's A operand through a
  descriptor over the TMA box (its tensor map under the 64-byte swizzle
  that the descriptor names, the block's shared memory on 1024 bytes), in
  place of 16 bytes a lane in registers; a stage's ring slot is freed once
  the wgmma that read it is done; its queries laid out in depth order
  (A then holds each row's depths in order); also with a ring of 2;
* ``bare``: no TMA, no hand-over; ``no wgmma, bare``.

``--body mma-s8-wide``: the mma.sync body's int8 instances over the int8
packed store at list widths 128 and 64 (``MmaBody<MODE_INT8, int8_t, 128 |
64>``: a checkout where those scans take them, for example the commit
before the int8 wgmma body with wide lists), timed in mode int8 at
``k_scan`` 106 and 64: the variants of ``--body mma-s8``.

``--body wgmma-s8-wide``: the int8 wgmma body with wide lists, timed in
mode int8 at ``k_scan`` 106 and 64:

* ``tree``, ``no wgmma``, ``no TMA``, ``bare``, ``no wgmma, bare`` as for
  ``--body wgmma-s8``;
* ``no selection``, ``no hand-over``, ``no merge`` as for ``--body
  wgmma-wide``;
* ``ring of 2 stages``, ``3``: ``WS8W_STAGES`` stages a consumer in place
  of 4;
* ``32 slots a block``: a block keeps 32 query slots (a pair takes four
  blocks) in place of 64.

``--body mma-f32mode-wide``: the mma.sync body's three-term instances
over the int8 packed store at list widths 128 and 64
(``MmaBody<MODE_F32, int8_t, 128 | 64>``: a checkout where those scans
take them, for example the commit before the f32-mode wgmma body with
wide lists), timed in mode f32 at ``k_scan`` 106 and 64: the variants of
``--body mma-f32mode``.

``--body wgmma-f32mode-wide``: the f32-mode wgmma body with wide lists,
timed in mode f32 at ``k_scan`` 106 and 64:

* ``tree``, ``no wgmma``, ``no widening``, ``no TMA``, ``bare``, ``no
  wgmma, bare`` as for ``--body wgmma-f32mode``;
* ``no selection``, ``no hand-over``, ``no merge`` as for ``--body
  wgmma-wide``;
* ``ring of 3 stages at width 64``: three stages a consumer in place of
  2 at list width 64 (the width-128 instance is the tree's: at 106 it
  reads the spread between two builds of one source).

``--body mma-f32-wide``: the mma.sync body's bf16 instances over an f32
store at list widths 128 and 64 (``MmaBody<MODE_BF16, float, 128 | 64>``:
a checkout where those scans take them, for example the commit before
the wgmma body over f32 rows with wide lists), timed in mode bf16 over
the flagship's rows as an f32 store at ``k_scan`` 106 and 64: the
variants of ``--body mma-f32``.

``--body wgmma-f32-wide``: the wgmma body over f32 rows with wide lists,
timed in mode bf16 over that f32 store at ``k_scan`` 106 and 64:

* ``tree``, ``no wgmma``, ``no rounding``, ``no TMA``, ``bare``, ``no
  wgmma, bare`` as for ``--body wgmma-f32``;
* ``no selection``, ``no hand-over``, ``no merge`` as for ``--body
  wgmma-wide``;
* ``one-box stages at width 64``: stages of one box (two k-steps) at
  list width 64 too, as at 128, in place of two-box ones (the width-128
  instance is the tree's);
* ``32 slots a block``: a block keeps 32 query slots (a pair takes four
  blocks), whose smaller head leaves room for two-box stages at list
  width 128 too;
* ``48 slots a block at width 128``: at list width 128 a block keeps 48
  query slots (a pair takes three blocks), which leaves room for two-box
  stages (the width-64 instance is the tree's; the split still costs the
  blocks as the library reports them, 64 slots);
* ``L2 prefetch of the next tile``: as a producer warp starts a tile's
  stages, it asks TMA to prefetch every box of its ring's next tile into
  L2 (``cp.async.bulk.prefetch.tensor``), so more bytes are in flight
  than the ring holds.

``--body wgmma-rowmap`` / ``wgmma-f32mode-rowmap``: the row-map bodies
over a virtual store of the flagship's int8 corpus (its id grid), timed
in mode bf16 / f32 at ``k_scan`` 16:

* ``tree``, ``no wgmma``, ``no selection`` as for ``--body wgmma``;
* ``no gather``: the producer warps arrive on the full barriers without
  copying (the consumers read whatever the ring holds);
* ``ring of 2 stages``, ``3`` (bf16; the tree's ring has ``RM_STAGES``,
  4) and ``ring of 2 stages`` (f32; the tree's ``RM3_STAGES``, 3, the most
  that fits beside three planes at d 768);
* ``two producer warps a ring``: the producer warpgroup's two idle warps
  take half of each stage's rows of a ring each (a named barrier of the
  two before the one expected arrival);
* ``row bulk copies``: each row's 64 bytes of each box of a stage by one
  ``cp.async.bulk`` (a one-row TMA copy, ``complete_tx`` on the full
  barrier, lane 0 arriving with the bytes the warp's copies bring), rows
  past the chunk or without an id and depths past d not copied (their
  stale bytes meet a zero scale or zero queries).

The variants of ``--body wgmma-s8``, ``--body wgmma-s8-wide``, ``--body
wgmma-f32mode-wide``, ``--body wgmma-f32-wide`` and the row-map bodies that leave the
arithmetic alone (the rings, A from shared memory, the slots a block)
are held bit-equal to the tree's lists; the other copies' results are wrong and are not read.  Then the card's memory
rates: a ~1 GB device-to-device copy (HBM: bytes read + written) and a
sum over a 20 MB and a 40 MB buffer read again and again (L2).  Prints
one ``[probe]`` line a variant and ``k_scan`` and writes
``chiprun_out/scan_probe_{body}.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import torch_scan_ab as ab  # noqa: E402
from learnedmetricindex_tpu_torch.ops import cuda_build, scan_kernel  # noqa: E402

WORK = ROOT / "build" / "scan_probe"
OUT = ROOT / "chiprun_out"

# (pattern, replacement): each pattern must occur exactly once in the source
QUERY_ONCE = [
    ("  auto load_stage = [&](int step, int buf) {",
     "  bool q_copy = true;\n  auto load_stage = [&](int step, int buf) {"),
    ("      const int row = i / A_PIECES, c16 = i % A_PIECES;\n",
     "      const int row = i / A_PIECES, c16 = i % A_PIECES;\n      if (!q_copy) continue;\n"),
    ("      const int nrows = min(RT, chunk - r0);\n",
     "      const int nrows = min(RT, chunk - r0);\n      q_copy = c == b.c_lo && r0 == 0;\n"),
]
NO_WIDEN = [
    ("  const uint32_t x = v ^ 0x80808080u;\n",
     "  b[0] = v;\n  b[1] = v ^ 0x80808080u;\n  return;\n  const uint32_t x = v ^ 0x80808080u;\n"),
]
NO_SELECTION = [
    ("      select_tile(p, s, nrows, (c - b.c_lo) * chunk + r0);\n", ""),
]
NO_MMA = [
    ('      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "\n'
     '      "{%8, %9}, {%0, %1, %2, %3};\\n"\n',
     '      ""\n'),
]
MMA_VARIANTS = {
    "tree": [],
    "(a) query tile once": QUERY_ONCE,
    "(b) no widening": NO_WIDEN,
    "(c) no selection": NO_SELECTION,
    "(d) no mma": NO_MMA,
    "(a)+(b)+(c)": QUERY_ONCE + NO_WIDEN + NO_SELECTION,
}

# every wgmma shape that the source spells (m64n48k16 in wgmma_rs and in
# wgmma_rs_terms; m64n96k16 only since the f32-mode body)
W_NO_WGMMA = [(f'"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "', '"// "', "all")
              for n in (16, 32, 48, 64)] + [
    ('"wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "', '"// "', "any")]
# the widening, the selection and the hand-over are spelled in wgmma_consume
# and (since the f32-mode body) in wgmma_consume_terms: each of these
# patches takes every occurrence ("all": at least one; one kernel is timed)
W_NO_WIDEN = [("widen_s8x4(wl[j], bl);", "bl[0] = wl[j]; bl[1] = wl[j] ^ 1u;", "all"),
              ("widen_s8x4(wh[j], bh);", "bh[0] = wh[j]; bh[1] = wh[j] ^ 1u;", "all")]
W_SELECT = "    wgmma_select(p, s, wg, N, nrows, slot0);\n"
W_NO_SELECTION = [(W_SELECT, "", "all")]
W_NO_HANDOVER = W_NO_SELECTION + [
    ("    if (i > 0) bar_sync(BAR_HANDOVER + wg, 256);  // the tile before is selected (by the warpgroup before)\n", "", "all"),
    ("    if (i + 1 < ntiles) bar_arrive(BAR_HANDOVER + (wg + 1) % W_CONSUMERS, 256);\n", "", "all")]
W_NO_TMA = [("      mbar_expect_tx(full, R::STAGE);\n#pragma unroll\n      for (int box = 0; box < R::BOXES; ++box)\n"
             "        tma_load_rows(s.stage(wg, slot) + box * WR * R::ROW, map, (st * R::BOXES + box) * R::DEPTHS,\n"
             "                      row, full);\n",
             "      mbar_arrive(full);\n")]
W_BOX1 = [("constexpr int W_STAGES = 2;", "constexpr int W_STAGES = 4;"),
          ("constexpr int W_BOXES = 2;", "constexpr int W_BOXES = 1;")]
W_THREE = [("constexpr int W_CONSUMERS = 2;", "constexpr int W_CONSUMERS = 3;"),
           ("static_assert(W_MAX_QD >= 1024,", "static_assert(W_MAX_QD >= 768,"),
           ("static_assert(W_MAX_QD_F >= 768 &&", "static_assert(W_MAX_QD_F >= 0 &&")]
WGMMA_VARIANTS = {
    "tree": [],
    "no wgmma": W_NO_WGMMA,
    "no widening": W_NO_WIDEN,
    "no selection": W_NO_SELECTION,
    "no hand-over": W_NO_HANDOVER,
    "no TMA": W_NO_TMA,
    "stages of 1 box, ring 4": W_BOX1,
    "bare": W_NO_TMA + W_NO_WIDEN + W_NO_HANDOVER,
    "3 consumers, stages of 1 box, ring 4": W_THREE + W_BOX1,
    "no wgmma, no widening": W_NO_WGMMA + W_NO_WIDEN,
    "no wgmma, no hand-over": W_NO_WGMMA + W_NO_HANDOVER,
    "no wgmma, bare": W_NO_WGMMA + W_NO_TMA + W_NO_WIDEN + W_NO_HANDOVER,
}


F_NO_STREAM = [(
    "        if (CONVERT || p.copy_bytes == 0) {\n"
    "          stage_via_registers<TS, TD>(dst, static_cast<const TS*>(p.store) + slot * d, live, e, d);\n",
    "        if (CONVERT) {\n"
    "          *reinterpret_cast<uint4*>(dst) = make_uint4(e, unsigned(slot), e, unsigned(slot));\n"
    "        } else if (p.copy_bytes == 0) {\n"
    "          stage_via_registers<TS, TD>(dst, static_cast<const TS*>(p.store) + slot * d, live, e, d);\n")]
F_NO_ROUND = [("  return __bfloat16_as_ushort(__float2bfloat16_rn(v));\n",
               "  return uint16_t(__float_as_uint(v) >> 16);\n")]
MMA_F32_VARIANTS = {
    "tree": [],
    "(a) no row stream": F_NO_STREAM,
    "(b) no rounding": F_NO_ROUND,
    "(c) no selection": NO_SELECTION,
    "(d) no mma": NO_MMA,
    "(a)+(c)": F_NO_STREAM + NO_SELECTION,
}
# (in wgmma_consume and, since the body over f32 rows with wide lists, in
# wgmma_consume_f32_wide: every occurrence; one kernel is timed)
WF_NO_ROUND = [("          a[2 * box + j][0] = bf16x2_rn(lo.x, lo.y);\n"
                "          a[2 * box + j][1] = bf16x2_rn(hi.x, hi.y);\n"
                "          a[2 * box + j][2] = bf16x2_rn(lo.z, lo.w);\n"
                "          a[2 * box + j][3] = bf16x2_rn(hi.z, hi.w);\n",
                "          a[2 * box + j][0] = __float_as_uint(lo.x) ^ __float_as_uint(lo.y);\n"
                "          a[2 * box + j][1] = __float_as_uint(hi.x) ^ __float_as_uint(hi.y);\n"
                "          a[2 * box + j][2] = __float_as_uint(lo.z) ^ __float_as_uint(lo.w);\n"
                "          a[2 * box + j][3] = __float_as_uint(hi.z) ^ __float_as_uint(hi.w);\n",
                "all")]
WF_SCAN_EACH = [("  if constexpr (!std::is_same<TS, int8_t>::value) {\n    const int q = q0 + 4 * lane;",
                 "  if constexpr (false) {\n    const int q = q0 + 4 * lane;")]
W_BOX1_RING2 = [("constexpr int W_BOXES = 2;", "constexpr int W_BOXES = 1;")]
WGMMA_F32_VARIANTS = {
    "tree": [],
    "no wgmma": W_NO_WGMMA,
    "no rounding": WF_NO_ROUND,
    "no selection": W_NO_SELECTION,
    "no hand-over": W_NO_HANDOVER,
    "no TMA": W_NO_TMA,
    "bare": W_NO_TMA + WF_NO_ROUND + W_NO_HANDOVER,
    "no wgmma, bare": W_NO_WGMMA + W_NO_TMA + WF_NO_ROUND + W_NO_HANDOVER,
    "stages of 1 box, ring 4": W_BOX1,
    "3 consumers, stages of 1 box, ring 2": W_THREE + W_BOX1_RING2,
    "selection: one load a query": WF_SCAN_EACH,
}
# the three-term body's mma of one 16-deep step: lo, mid and hi into a fresh sum
ONE_TERM = [("      for (int term = NT - 1; term >= 0; --term) {\n",
             "      for (int term = 0; term >= 0; --term) {\n")]
MMA_F32MODE_VARIANTS = {
    "tree": [],
    "no mma.sync": NO_MMA,
    "no widening": NO_WIDEN,
    "no selection": NO_SELECTION,
    "one query term": ONE_TERM,
    "no mma.sync, no widening, no selection": NO_MMA + NO_WIDEN + NO_SELECTION,
}
# the f32-mode body: each stage folded with the hi term's sum alone
WM_HI_ONLY = [("    acc[i] = __fadd_rn(acc[i], __fadd_rn(__fadd_rn(fresh[2 * M + i], fresh[M + i]), "
               "fresh[i]));\n",
               "    acc[i] = __fadd_rn(acc[i], fresh[i]);\n")]


def _in_wgmma_rs(source: str, old: str, new: str):
    """An edit of every ``old`` in the bf16 ``wgmma_rs`` alone (the s8
    wgmma spells the same operands): the function as it is, and as
    edited."""
    start = source.index("__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2]")
    body = source[start : source.index("\n}\n", start) + 3]
    return body, body.replace(old, new)


# ... the three planes as three wgmma m64nNk16 a k-step (each term its own
# accumulator columns, as the one m64n(3N)k16 has them) in place of one
WM_THREE = [
    ("__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], "
     "uint64_t desc) {",
     "__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], "
     "uint64_t desc, int add = 1) {"),
    lambda source: _in_wgmma_rs(source, '"l"(desc), "r"(1));', '"l"(desc), "r"(add));'),
    ("        wgmma_rs_terms<3 * N>(fresh, a[B][j],\n"
     "                              query_desc(q_base + (W_KSTEPS * st + KSTEPS * B + j) * W3_KSTEP),\n"
     "                              B > 0 || j > 0);\n",
     "        for (int term = 0; term < 3; ++term)\n"
     "          wgmma_rs<N>(*reinterpret_cast<float(*)[N / 2]>(&fresh[term * N / 2]), a[B][j],\n"
     "                      query_desc(q_base + (W_KSTEPS * st + KSTEPS * B + j) * W3_KSTEP\n"
     "                                 + term * N / 8 * 256),\n"
     "                      B > 0 || j > 0);\n"),
]
# ... the next stage's first box widened after the fold, not while the
# second box's wgmma runs (one wait a stage)
WM_ONE_WAIT = [("      wgmma_wait<1>();  // the first box is done with a[0]\n      hold(a[0]);\n"
                "      if (st + 1 < nst) take_box(a[0], 0);\n      wgmma_wait<0>();\n"
                "      hold(a[1]);\n      fold_terms(acc, fresh);\n",
                "      wgmma_wait<0>();\n      hold(a[0]);\n      hold(a[1]);\n"
                "      fold_terms(acc, fresh);\n      if (st + 1 < nst) take_box(a[0], 0);\n")]
WGMMA_F32MODE_VARIANTS = {
    "tree": [],
    "one wait a stage": WM_ONE_WAIT,
    "no wgmma": W_NO_WGMMA,
    "no widening": W_NO_WIDEN,
    "no selection": W_NO_SELECTION,
    "no hand-over": W_NO_HANDOVER,
    "no TMA": W_NO_TMA,
    "fold: the hi term alone": WM_HI_ONLY,
    "three wgmma m64nNk16 a k-step": WM_THREE,
    "bare": W_NO_TMA + W_NO_WIDEN + W_NO_HANDOVER,
    "no wgmma, bare": W_NO_WGMMA + W_NO_TMA + W_NO_WIDEN + W_NO_HANDOVER,
}
# the wide-list body: its own selection call, merge and slot count
WW_NO_SELECTION = [("    wgmma_select_wide(p, s, wg, N, nrows, slot0);\n", "", "all")]
WW_NO_HANDOVER = WW_NO_SELECTION + W_NO_HANDOVER[1:]
WW_NO_MERGE = [("    __syncwarp();  // every lane holds its entries: the list is rewritten\n",
                "    continue;\n    __syncwarp();  // every lane holds its entries: the list is rewritten\n")]
WW_SLOTS32 = [("constexpr int W_WIDE_SLOTS = 64;", "constexpr int W_WIDE_SLOTS = 32;")]
WGMMA_WIDE_VARIANTS = {
    "tree": [],
    "no wgmma": W_NO_WGMMA,
    "no widening": W_NO_WIDEN,
    "no selection": WW_NO_SELECTION,
    "no hand-over": WW_NO_HANDOVER,
    "no merge": WW_NO_MERGE,
    "no TMA": W_NO_TMA,
    "bare": W_NO_TMA + W_NO_WIDEN + WW_NO_HANDOVER,
    "no wgmma, bare": W_NO_WGMMA + W_NO_TMA + W_NO_WIDEN + WW_NO_HANDOVER,
    "32 slots a block": WW_SLOTS32,
}
# the six-term mma.sync body (f32 over an f32 store): its split of the store
# values (split3) replaced by the value's bits, the loads kept
X_NO_SPLIT = [("  term[0] = __float_as_uint(x) & 0xffff0000u;\n"
               "  const float rest = __fsub_rn(x, __uint_as_float(term[0]));\n"
               "  term[1] = __float_as_uint(rest) & 0xffff0000u;\n"
               "  term[2] = __float_as_uint(__fsub_rn(rest, __uint_as_float(term[1])));\n",
               "  term[0] = __float_as_uint(x);\n  term[1] = term[0] ^ 1u;\n"
               "  term[2] = term[0] ^ 2u;\n")]
MMA_F32X_VARIANTS = {
    "tree": [],
    "no mma.sync": NO_MMA,
    "no split": X_NO_SPLIT,
    "no selection": NO_SELECTION,
    "no mma.sync, no split, no selection": NO_MMA + X_NO_SPLIT + NO_SELECTION,
}
# the six-term wgmma body: its split (split_pair) reduced to the hi term's
# packing, the other two terms that word with bits flipped
WX_SPLIT = ("  const float r0 = __fsub_rn(x0, __uint_as_float(b0 & 0xffff0000u));\n"
            "  const float r1 = __fsub_rn(x1, __uint_as_float(b1 & 0xffff0000u));\n"
            "  const uint32_t m0 = __float_as_uint(r0), m1 = __float_as_uint(r1);\n"
            "  a[1][r] = __byte_perm(m0, m1, 0x7632);\n"
            "  a[2][r] = __byte_perm(__float_as_uint(__fsub_rn(r0, __uint_as_float(m0 & 0xffff0000u))),\n"
            "                        __float_as_uint(__fsub_rn(r1, __uint_as_float(m1 & 0xffff0000u))), 0x7632);\n")
WX_NO_SPLIT = [(WX_SPLIT, "  a[1][r] = a[0][r] ^ 1u;\n  a[2][r] = a[0][r] ^ 2u;\n")]
# ... 16 query slots a block (a pair in eight blocks) and the two-box stages of the body over
# f32 rows
WX_SLOTS16 = [("constexpr int WQX = 32;", "constexpr int WQX = 16;")]
# ... a ring of three one-box stages a consumer (48 KB: the widest resident
# tile then 768)
WX_STAGES3 = [("constexpr int WX_STAGES = 2;", "constexpr int WX_STAGES = 3;")]
# ... x_hi against the planes hi and mid in one m64n(2N)k16 (the large sum
# and the x_hi · q_mid part of the small one are adjacent columns), then a
# wgmma.fence (another shape over the small sum's registers) and the other
# four m64nNk16
WX_ISSUE = ("        wgmma_rs_sum<N>(large, a[B][j][0], query_desc(q), add);  // x_hi · q_hi\n"
            "        wgmma_rs_sum<N>(small, a[B][j][2], query_desc(q), add);  // x_lo · q_hi\n"
            "        wgmma_rs_sum<N>(small, a[B][j][1], query_desc(q + N / 8 * 256), 1);  // x_mid · q_mid\n"
            "        wgmma_rs_sum<N>(small, a[B][j][1], query_desc(q), 1);  // x_mid · q_hi\n"
            "        wgmma_rs_sum<N>(small, a[B][j][0], query_desc(q + N / 4 * 256), 1);  // x_hi · q_lo\n"
            "        wgmma_rs_sum<N>(small, a[B][j][0], query_desc(q + N / 8 * 256), 1);  // x_hi · q_mid\n")
WX_WIDE = [(WX_ISSUE,
            "        wgmma_rs_sum<2 * N>(fresh, a[B][j][0], query_desc(q), add);  // x_hi · [q_hi, q_mid]\n"
            "        wgmma_fence();\n"
            "        wgmma_rs_sum<N>(small, a[B][j][2], query_desc(q), 1);  // x_lo · q_hi\n"
            "        wgmma_rs_sum<N>(small, a[B][j][1], query_desc(q + N / 8 * 256), 1);  // x_mid · q_mid\n"
            "        wgmma_rs_sum<N>(small, a[B][j][1], query_desc(q), 1);  // x_mid · q_hi\n"
            "        wgmma_rs_sum<N>(small, a[B][j][0], query_desc(q + N / 4 * 256), 1);  // x_hi · q_lo\n")]
# ... the five small products into the large sum too (one sum, the large
# sum's truncation over all six products: the precision it costs)
WX_ONE_SUM = [(WX_ISSUE, WX_ISSUE.replace("wgmma_rs_sum<N>(small, a[B][j][2], query_desc(q), add)",
                                          "wgmma_rs_sum<N>(small, a[B][j][2], query_desc(q), 1)")
               .replace("(small,", "(large,"))]
WX_SELECT = [("    wgmma_select(p, s, wg, N, nrows, slot0);\n", "", "all")]
WGMMA_F32X_VARIANTS = {
    "tree": [],
    "no wgmma": W_NO_WGMMA,
    "no split": WX_NO_SPLIT,
    "no selection": WX_SELECT,
    "no hand-over": W_NO_HANDOVER,
    "no TMA": W_NO_TMA,
    "16 slots a block": WX_SLOTS16,
    "ring of 3 one-box stages (d <= 768)": WX_STAGES3,
    "x_hi · [q_hi, q_mid] in one m64n(2N)k16": WX_WIDE,
    "one sum for the six products": WX_ONE_SUM,
    "bare": W_NO_TMA + WX_NO_SPLIT + W_NO_HANDOVER,
    "no wgmma, bare": W_NO_WGMMA + W_NO_TMA + WX_NO_SPLIT + W_NO_HANDOVER,
}
# the int8 mma.sync body: its s8 mma issues nothing
NO_MMA_S8 = [
    ('      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "\n'
     '      "{%8, %9}, {%0, %1, %2, %3};\\n"\n',
     '      ""\n'),
]
MMA_S8_VARIANTS = {
    "tree": [],
    "(a) query tile once": QUERY_ONCE,
    "(c) no selection": NO_SELECTION,
    "(d) no mma": NO_MMA_S8,
    "(a)+(c)+(d)": QUERY_ONCE + NO_SELECTION + NO_MMA_S8,
}
# the int8 wgmma body: its s8 wgmma shapes, its ring's depth
WS8_NO_WGMMA = [(f'"wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 "', '"// "')
                for n in (16, 32, 48, 64)]
WS8_STAGES = {n: [("constexpr int WS8_STAGES = 4;", f"constexpr int WS8_STAGES = {n};"),
                  ("static_assert(W_MAX_QDS8 >= 1152,", "static_assert(W_MAX_QDS8 >= 768,")]
              for n in (2, 3, 5, 6)}
# ... and A through a descriptor over the TMA box: the int8 tensor map under
# the 64-byte swizzle (canonical K-major SW64: 8-row atoms of 512 bytes,
# the stride byte offset between them; a k-step 32 bytes further in the
# row), the shared memory on 1024 bytes, each stage's ring slot freed once
# the wgmma group that read it is done


def _ss_asm(n: int) -> str:
    m = n // 2
    regs = ", ".join(f"%{i}" for i in range(m))
    outs = ", ".join(f'"+r"(r[{i}])' for i in range(m))
    return (f"  if constexpr (N == {n}) {{\n"
            f'    asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{m + 2}, 0;\\n"\n'
            f'                 "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 {{{regs}}}, '
            f'%{m}, %{m + 1}, p;\\n}}\\n"\n'
            f"                 : {outs}\n"
            f'                 : "l"(adesc), "l"(desc), "r"(1));\n'
            f"  }}\n")


WS8_SS = ("// the int8 body's A from shared memory (probe variant): D += A (at adesc) · B (at desc)\n"
          "template <int N>\n"
          "__device__ __forceinline__ void wgmma_ss_s8(int (&r)[N / 2], uint64_t adesc, "
          "uint64_t desc) {\n" + "".join(_ss_asm(n) for n in (16, 32, 48, 64)) + "}\n")
WS8_A_START = "  // the A fragments of a stage's k-steps, two a box:"
WS8_A_END = "    hold(acc);\n\n    // epilogue as in wgmma_consume, the sums"
WS8_A_SMEM_BODY = """  // A through a descriptor: K-major under the 64-byte swizzle, 8-row atoms
  // of 512 bytes; k-step j of a stage is box j / 2, bytes 32 (j % 2) on
  auto a_desc = [&](int slot, int j) {
    const uint32_t addr = smem_u32(s.stage(wg, slot)) + (j >> 1) * WR * WK + (j & 1) * 32;
    return uint64_t((addr & 0x3ffff) >> 4) | (uint64_t(1) << 16) | (uint64_t(512 >> 4) << 32) |
           (uint64_t(2) << 62);
  };

  for (int i = wg; i < ntiles; i += W_CONSUMERS) {
    const int r0 = w.t * WR;
    const int slot0 = phys * p.chunk + r0, nrows = min(WR, p.chunk - r0);
    w.advance(W_CONSUMERS, per_chunk);  // the next tile's chunk, read while this one runs
    phys = w.c < b.c_hi ? p.chunk_of[w.c] : 0;
    float r_scale[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      r_scale[h] = r < nrows ? p.scales[slot0 + r] : 0.0f;  // → +inf distance
    }
    int acc[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0;
    auto issue = [&](int st) {
      const int slot = cnt % R::STAGES;
      mbar_wait(&s.full[wg * R::STAGES + slot], (cnt / R::STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KSTEPS; ++j)
        wgmma_ss_s8<N>(acc, a_desc(slot, j), query_desc(q_base + (KSTEPS * st + j) * WS8_KSTEP));
      wgmma_commit();
      ++cnt;
    };
    auto release = [&](int c) {  // the ring slot of the warpgroup's c-th stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[wg * R::STAGES + c % R::STAGES]);
    };
    issue(0);
    for (int st = 1; st < nst; ++st) {
      issue(st);
      wgmma_wait<1>();  // stage st - 1 is read
      release(cnt - 2);
    }
    wgmma_wait<0>();
    release(cnt - 1);
    hold(acc);

    // epilogue as in wgmma_consume, the sums"""


def ws8_a_region(source: str):
    """The int8 consumer's A loads through its wgmma loop's end, as an
    edit: replaced by ``WS8_A_SMEM_BODY``."""
    start, end = source.index(WS8_A_START), source.index(WS8_A_END) + len(WS8_A_END)
    return source[start:end], WS8_A_SMEM_BODY


WS8_A_SMEM = [
    ws8_a_region,
    ("template <int N>\n__device__ __forceinline__ void hold(int (&r)[N]) {",
     WS8_SS + "template <int N>\n__device__ __forceinline__ void hold(int (&r)[N]) {"),
    ("F32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE",
     "F32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B"),
    ("    scan_wgmma_s8_kernel(const __grid_constant__ CUtensorMap rows, Params p) {\n"
     "  extern __shared__ __align__(16) unsigned char smem[];\n",
     "    scan_wgmma_s8_kernel(const __grid_constant__ CUtensorMap rows, Params p) {\n"
     "  extern __shared__ __align__(1024) unsigned char smem[];\n"
     "  if (smem_u32(smem) % 1024 != 0) __trap();\n"),
]
WGMMA_S8_VARIANTS = {
    "tree": [],
    "no wgmma": WS8_NO_WGMMA,
    "no selection": W_NO_SELECTION,
    "no hand-over": W_NO_HANDOVER,
    "no TMA": W_NO_TMA,
    "selection: one load a query": WF_SCAN_EACH,
    "ring of 2 stages": WS8_STAGES[2],
    "ring of 3 stages": WS8_STAGES[3],
    "ring of 5 stages": WS8_STAGES[5],
    "ring of 6 stages": WS8_STAGES[6],
    "A from shared memory": WS8_A_SMEM,
    "A from shared memory, ring of 2 stages": WS8_A_SMEM + WS8_STAGES[2],
    "bare": W_NO_TMA + W_NO_HANDOVER,
    "no wgmma, bare": WS8_NO_WGMMA + W_NO_TMA + W_NO_HANDOVER,
}
# the int8 wgmma body with wide lists: its ring's depth
WS8W_STAGES = {n: [("constexpr int WS8W_STAGES = 4;", f"constexpr int WS8W_STAGES = {n};")]
               for n in (2, 3)}
WGMMA_S8_WIDE_VARIANTS = {
    "tree": [],
    "no wgmma": WS8_NO_WGMMA,
    "no selection": WW_NO_SELECTION,
    "no hand-over": WW_NO_HANDOVER,
    "no merge": WW_NO_MERGE,
    "no TMA": W_NO_TMA,
    "ring of 2 stages": WS8W_STAGES[2],
    "ring of 3 stages": WS8W_STAGES[3],
    "32 slots a block": WW_SLOTS32,
    "bare": W_NO_TMA + WW_NO_HANDOVER,
    "no wgmma, bare": WS8_NO_WGMMA + W_NO_TMA + WW_NO_HANDOVER,
}
# the f32-mode wgmma body with wide lists: its ring's depth at width 64
W3W_STAGES3 = [("  static constexpr size_t HEAD = F32ModeWideList<KMAX>::HEAD;\n",
                "  static constexpr int STAGES = KMAX == 64 ? 3 : W_STAGES;\n"
                "  static constexpr size_t HEAD = w_head_bytes(WQ3, KMAX, STAGES),\n"
                "                          BYTES = size_t(W_CONSUMERS) * STAGES * W_STAGE;\n")]
WGMMA_F32MODE_WIDE_VARIANTS = {
    "tree": [],
    "no wgmma": W_NO_WGMMA,
    "no widening": W_NO_WIDEN,
    "no selection": WW_NO_SELECTION,
    "no hand-over": WW_NO_HANDOVER,
    "no merge": WW_NO_MERGE,
    "no TMA": W_NO_TMA,
    "ring of 3 stages at width 64": W3W_STAGES3,
    "bare": W_NO_TMA + W_NO_WIDEN + WW_NO_HANDOVER,
    "no wgmma, bare": W_NO_WGMMA + W_NO_TMA + W_NO_WIDEN + WW_NO_HANDOVER,
}
# the wgmma body over f32 rows with wide lists: one-box stages at width 64 too
WF32W_BOX1 = [("HEAD + kWRingBytesF + size_t(SLOTS) * 2 * 768 <= 232448 ? W_BOXES : 1;",
               "false ? W_BOXES : 1;")]
# ... and 48 query slots a block at width 128 (two-box stages then fit)
WF32W_SLOTS48 = [("struct F32WideList {\n  static constexpr int KMAX = KMAX_, SLOTS = W_WIDE_SLOTS;",
                  "struct F32WideList {\n  static constexpr int KMAX = KMAX_,\n"
                  "                       SLOTS = KMAX <= 64 ? W_WIDE_SLOTS : 48;")]
# ... and the producer's L2 prefetch of its ring's next tile (this body alone)
WF32W_PREFETCH = [("    const int next_phys = next.c < b.c_hi ? p.chunk_of[next.c] : 0;\n",
                   "    const int next_phys = next.c < b.c_hi ? p.chunk_of[next.c] : 0;\n"
                   "    if constexpr (IsF32Wide<TS>::value) {\n"
                   "      if (next.c < b.c_hi)\n"
                   "        for (int x = 0; x < p.qd; x += R::DEPTHS)\n"
                   "          asm volatile(\"cp.async.bulk.prefetch.tensor.2d.L2.global.tile [%0, {%1, %2}];\\n\"\n"
                   "                       ::\"l\"(reinterpret_cast<uint64_t>(map)), \"r\"(x),\n"
                   "                       \"r\"(next_phys * p.chunk + next.t * WR) : \"memory\");\n"
                   "    }\n")]
WGMMA_F32_WIDE_VARIANTS = {
    "tree": [],
    "no wgmma": W_NO_WGMMA,
    "no rounding": WF_NO_ROUND,
    "no selection": WW_NO_SELECTION,
    "no hand-over": WW_NO_HANDOVER,
    "no merge": WW_NO_MERGE,
    "no TMA": W_NO_TMA,
    "one-box stages at width 64": WF32W_BOX1,
    "32 slots a block": WW_SLOTS32,
    "48 slots a block at width 128": WF32W_SLOTS48,
    "L2 prefetch of the next tile": WF32W_PREFETCH,
    "bare": W_NO_TMA + WF_NO_ROUND + WW_NO_HANDOVER,
    "no wgmma, bare": W_NO_WGMMA + W_NO_TMA + WF_NO_ROUND + WW_NO_HANDOVER,
}
# the row-map bodies: the gathering producer's copies left out, rings of
# other depths, two producer warps a ring, and one-row bulk copies
RM_COPY = ("        cp_async16(dst + (4 * i + j) * WK, corpus + (ok ? size_t(id - 1) * p.d + depth : 0), "
           "ok);\n")
RM_NO_GATHER = [(RM_COPY, "        (void)ok;\n")]
RM_RING = "constexpr int RM_STAGES = 4, RM3_STAGES = 3;"
RM_TWO_WARPS = [
    ("    if (threadIdx.x % 128 < 32 * W_CONSUMERS) wgmma_gather(p, s, b, threadIdx.x % 128 / 32);\n",
     "    wgmma_gather(p, s, b, threadIdx.x % 128 / 32 % W_CONSUMERS);\n", 2),
    ("        const int id = __shfl_sync(FULL, i < 8 ? id_lo : id_hi, (4 * i + j) & 31);\n",
     "        if (i % 2 != int(threadIdx.x % 128 / 64)) continue;\n"
     "        const int id = __shfl_sync(FULL, i < 8 ? id_lo : id_hi, (4 * i + j) & 31);\n"),
    ("      __syncwarp();\n      if (lane == 0) mbar_arrive(full);\n",
     "      bar_sync(6 + wg, 64);\n      if (lane == 0 && threadIdx.x % 128 < 64) mbar_arrive(full);\n")]
RM_BULK = [(
    "#pragma unroll\n"
    "      for (int i = 0; i < WR / 4; ++i) {\n"
    "        const int id = __shfl_sync(FULL, i < 8 ? id_lo : id_hi, (4 * i + j) & 31);\n"
    "        const bool ok = id > 0 && depth < p.d;\n" + RM_COPY + "      }\n"
    "      cp_async_arrive(full);\n      __syncwarp();\n      if (lane == 0) mbar_arrive(full);\n",
    "      (void)dst;\n      int bytes = 0;\n"
    "#pragma unroll\n"
    "      for (int q0 = 0; q0 < 2 * WR; q0 += 32) {  // (row, box) pieces of 64 bytes\n"
    "        const int q = q0 + lane, r = q >> 1, box = q & 1;\n"
    "        const int lo = __shfl_sync(FULL, id_lo, r & 31), hi = __shfl_sync(FULL, id_hi, r & 31);\n"
    "        const int id = r < 32 ? lo : hi, dep = st * 128 + box * 64;\n"
    "        if (id > 0 && dep < p.d) {\n"
    "          const int n = min(64, p.d - dep);\n"
    "          asm volatile(\"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes \"\n"
    "                       \"[%0], [%1], %2, [%3];\\n\" ::\"r\"(smem_u32(s.stage(wg, slot) + box * WR * WK + r * WK)),\n"
    "                       \"l\"(corpus + size_t(id - 1) * p.d + dep), \"r\"(n), \"r\"(smem_u32(full))\n"
    "                       : \"memory\");\n"
    "          bytes += n;\n"
    "        }\n"
    "      }\n"
    "      for (int o = 16; o > 0; o >>= 1) bytes += __shfl_xor_sync(FULL, bytes, o);\n"
    "      if (lane == 0) mbar_expect_tx(full, bytes);\n")]
WGMMA_ROWMAP_VARIANTS = {
    "tree": [],
    "no wgmma": W_NO_WGMMA,
    "no selection": W_NO_SELECTION,
    "no gather": RM_NO_GATHER,
    "ring of 2 stages": [(RM_RING, "constexpr int RM_STAGES = 2, RM3_STAGES = 3;")],
    "ring of 3 stages": [(RM_RING, "constexpr int RM_STAGES = 3, RM3_STAGES = 3;")],
    "two producer warps a ring": RM_TWO_WARPS,
    "row bulk copies": RM_BULK,
}
WGMMA_F32MODE_ROWMAP_VARIANTS = {
    "tree": [],
    "no wgmma": W_NO_WGMMA,
    "no selection": W_NO_SELECTION,
    "no gather": RM_NO_GATHER,
    "ring of 2 stages": [(RM_RING, "constexpr int RM_STAGES = 4, RM3_STAGES = 2;")],
    "two producer warps a ring": RM_TWO_WARPS,
    "row bulk copies": RM_BULK,
}
RM_EXACT = {"ring of 2 stages", "ring of 3 stages", "two producer warps a ring",
            "row bulk copies"}
# the variants whose lists must stay the tree's, bit for bit
EXACT = {"selection: one load a query", "ring of 2 stages", "ring of 3 stages",
         "ring of 5 stages", "ring of 6 stages", "A from shared memory",
         "A from shared memory, ring of 2 stages"}
EXACT_S8_WIDE = {"ring of 2 stages", "ring of 3 stages", "32 slots a block"}
EXACT_BY_BODY = {"wgmma-s8-wide": EXACT_S8_WIDE,
                 "wgmma-f32mode-wide": {"ring of 3 stages at width 64"},
                 "wgmma-f32-wide": {"one-box stages at width 64", "32 slots a block",
                                    "48 slots a block at width 128",
                                    "L2 prefetch of the next tile"},
                 "wgmma-rowmap": RM_EXACT, "wgmma-f32mode-rowmap": RM_EXACT}
# ... and those that read the queries in depth order (A from shared memory
# reads each row's depths in order, not in WGMMA_S8_ORDER)
IN_ORDER = {"A from shared memory", "A from shared memory, ring of 2 stages"}
VARIANTS = {"mma": MMA_VARIANTS, "wgmma": WGMMA_VARIANTS, "mma-f32": MMA_F32_VARIANTS,
            "wgmma-f32": WGMMA_F32_VARIANTS, "mma-f32mode": MMA_F32MODE_VARIANTS,
            "wgmma-f32mode": WGMMA_F32MODE_VARIANTS, "mma-wide": MMA_VARIANTS,
            "wgmma-wide": WGMMA_WIDE_VARIANTS, "mma-f32x": MMA_F32X_VARIANTS,
            "wgmma-f32x": WGMMA_F32X_VARIANTS, "mma-s8": MMA_S8_VARIANTS,
            "wgmma-s8": WGMMA_S8_VARIANTS, "mma-s8-wide": MMA_S8_VARIANTS,
            "wgmma-s8-wide": WGMMA_S8_WIDE_VARIANTS, "mma-f32mode-wide": MMA_F32MODE_VARIANTS,
            "wgmma-f32mode-wide": WGMMA_F32MODE_WIDE_VARIANTS, "mma-f32-wide": MMA_F32_VARIANTS,
            "wgmma-f32-wide": WGMMA_F32_WIDE_VARIANTS, "wgmma-rowmap": WGMMA_ROWMAP_VARIANTS,
            "wgmma-f32mode-rowmap": WGMMA_F32MODE_ROWMAP_VARIANTS}
# ptxas's report of the instance each body runs
INSTANCE = {"mma": "scan_mma_kernelILi1EaLi32E", "wgmma": "scan_wgmma_kernel",
            "mma-f32": "scan_mma_kernelILi1EfLi32E", "wgmma-f32": "scan_wgmma_f32_kernel",
            "mma-f32mode": "scan_mma_kernelILi0EaLi32E",
            "wgmma-f32mode": "scan_wgmma_f32mode_kernel", "mma-wide": "scan_mma_kernelILi1EaLi128E",
            "wgmma-wide": "scan_wgmma_wide_kernelILi128E", "mma-f32x": "scan_mma_kernelILi0EfLi32E",
            "wgmma-f32x": "scan_wgmma_f32x_kernel", "mma-s8": "scan_mma_kernelILi2EaLi32E",
            "wgmma-s8": "scan_wgmma_s8_kernel", "mma-s8-wide": "scan_mma_kernelILi2EaLi128E",
            "wgmma-s8-wide": "scan_wgmma_s8_wide_kernel",
            "mma-f32mode-wide": "scan_mma_kernelILi0EaLi128E",
            "wgmma-f32mode-wide": "scan_wgmma_f32mode_wide_kernel",
            "mma-f32-wide": "scan_mma_kernelILi1EfLi128E",
            "wgmma-f32-wide": "scan_wgmma_f32_wide_kernel",
            "wgmma-rowmap": "scan_wgmma_rowmap_kernel",
            "wgmma-f32mode-rowmap": "scan_wgmma_f32mode_rowmap_kernel"}
# the scan mode each body runs in, and the kernel that the checkout must have
# (wgmma bodies) or must not have (the mma.sync body those replace)
BODY_MODE = {"mma": "bf16", "wgmma": "bf16", "mma-f32": "bf16", "wgmma-f32": "bf16",
             "mma-f32mode": "f32", "wgmma-f32mode": "f32", "mma-wide": "bf16",
             "wgmma-wide": "bf16", "mma-f32x": "f32", "wgmma-f32x": "f32", "mma-s8": "int8",
             "wgmma-s8": "int8", "mma-s8-wide": "int8", "wgmma-s8-wide": "int8",
             "mma-f32mode-wide": "f32", "wgmma-f32mode-wide": "f32", "mma-f32-wide": "bf16",
             "wgmma-f32-wide": "bf16", "wgmma-rowmap": "bf16", "wgmma-f32mode-rowmap": "f32"}
# the k_scan each body is timed at: the default search's 16, search(k=100)'s
# 106 (the int8 and f32 wide lists also at 64, list width 64)
BODY_K = {"mma-wide": (106,), "wgmma-wide": (106,), "mma-s8-wide": (106, 64),
          "wgmma-s8-wide": (106, 64), "mma-f32mode-wide": (106, 64),
          "wgmma-f32mode-wide": (106, 64), "mma-f32-wide": (106, 64),
          "wgmma-f32-wide": (106, 64)}
BODY_KERNEL = {"mma": "scan_wgmma_kernel", "wgmma": "scan_wgmma_kernel",
               "mma-f32": "scan_wgmma_f32_kernel", "wgmma-f32": "scan_wgmma_f32_kernel",
               "mma-f32mode": "scan_wgmma_f32mode_kernel",
               "wgmma-f32mode": "scan_wgmma_f32mode_kernel",
               "mma-wide": "scan_wgmma_wide_kernel", "wgmma-wide": "scan_wgmma_wide_kernel",
               "mma-f32x": "scan_wgmma_f32x_kernel", "wgmma-f32x": "scan_wgmma_f32x_kernel",
               "mma-s8": "scan_wgmma_s8_kernel", "wgmma-s8": "scan_wgmma_s8_kernel",
               "mma-s8-wide": "scan_wgmma_s8_wide_kernel",
               "wgmma-s8-wide": "scan_wgmma_s8_wide_kernel",
               "mma-f32mode-wide": "scan_wgmma_f32mode_wide_kernel",
               "wgmma-f32mode-wide": "scan_wgmma_f32mode_wide_kernel",
               "mma-f32-wide": "scan_wgmma_f32_wide_kernel",
               "wgmma-f32-wide": "scan_wgmma_f32_wide_kernel",
               "wgmma-rowmap": "scan_wgmma_rowmap_kernel",
               "wgmma-f32mode-rowmap": "scan_wgmma_f32mode_rowmap_kernel"}


def patched(source: str, edits) -> str:
    """``source`` with each ``(old, new[, count])`` edit applied (or each
    edit a function of the source gives): ``old`` must occur ``count``
    times (default 1), at least once for "all", any number of times for
    "any"."""
    for edit in edits:
        old, new, *count = edit(source) if callable(edit) else edit
        want = count[0] if count else 1
        found = source.count(old)
        cs.check(want == "any" or (found >= 1 if want == "all" else found == want),
                 f"probe patch: {old!r} occurs {found} times, not {want}")
        source = source.replace(old, new)
    return source


def memory_rates(smi: str) -> dict:
    """HBM: a device-to-device copy of 2**30 bytes (read + written); L2: a
    sum over a 20 MB and a 40 MB f32 buffer, read again and again."""
    dev = torch.device("cuda", 0)
    src = torch.empty(2**28, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    ms = cs.cuda_ms(lambda: dst.copy_(src), 20)
    rates = {"hbm_copy_tb_s": 2 * src.numel() * 4 / ms / 1e9}
    del src, dst
    for mb in (20, 40):
        buf = torch.ones(mb * 2**20 // 4, device=dev)
        ms = cs.cuda_ms(lambda: buf.sum(), 200)
        rates[f"l2_read_{mb}mb_tb_s"] = buf.numel() * 4 / ms / 1e9
        del buf
    cs.log("[probe] memory: " + ", ".join(f"{k} {v:.3f}" for k, v in rates.items()) + f"  [{smi}]")
    return rates


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--body", choices=tuple(VARIANTS), default="wgmma",
                   help="the body whose variants are timed")
    p.add_argument("--checkout", type=Path, default=ROOT, help="the checkout whose source is patched")
    p.add_argument("--reference", type=Path, nargs="*", default=[],
                   help="checkouts whose sources are timed as they are")
    p.add_argument("--only", nargs="*", help="the variants to time (default: all)")
    p.add_argument("--rounds", type=int, default=4, help="timed rounds per variant")
    args = p.parse_args()
    smi = cs.phase_device()
    WORK.mkdir(parents=True, exist_ok=True)
    text = (args.checkout.resolve() / ab.SOURCE).read_text()
    kernel = BODY_KERNEL[args.body]
    cs.check((kernel in text) == args.body.startswith("wgmma"),
             f"{args.checkout}: the flagship's scan there does not run the {args.body} body")
    sources = {}
    for i, (name, edits) in enumerate(VARIANTS[args.body].items()):
        if args.only and name not in args.only and name != "tree":
            continue
        path = WORK / f"v{i}.cu"
        path.write_text(patched(text, edits))
        sources[name] = path
    for ref in args.reference:
        sources[f"reference {ref}"] = ref.resolve() / ab.SOURCE
    builds = [(WORK / f"v{i}.so", src) for i, src in enumerate(sources.values())]
    builds.append((WORK / "merge.so", ROOT / ab.MERGE_SOURCE))
    procs = [subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out),
                               str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for out, src in builds]
    for (out, _), proc in zip(builds, procs):
        stdout, err = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed: {err[-2000:]}")
        keep = False  # ptxas's report of the flagship scan's instance
        for line in (stdout + err).splitlines():
            if "Compiling entry function" in line:
                keep = INSTANCE[args.body] in line
            elif ((keep and ("registers" in line or "spill" in line))
                  or ("serialized" in line and INSTANCE[args.body] in line)):
                cs.log(f"[probe] {out.name}: {line.strip()}")
    sides = {name: ab.bind(WORK / f"v{i}.so", src, WORK / "merge.so")
             for i, (name, src) in enumerate(sources.items())}
    rates = memory_rates(smi)
    store, virtual, queries, order = ab.flagship_stores(torch.device("cuda", 0))
    mode = BODY_MODE[args.body]
    what = f"{mode} over the int8 packed store"
    if args.body.endswith("rowmap"):
        store, what = virtual, f"{mode} over a virtual store of the int8 corpus"
    del virtual
    if args.body.endswith(("f32", "f32x", "f32-wide")):
        store = cs.dequantized_store(store)
        what = f"{mode} over an f32 store ({store.chunk_data.numel() * 4 / 1e9:.1f} GB)"
    exact = EXACT_BY_BODY.get(args.body, EXACT)
    by_k = {}
    for k in BODY_K.get(args.body, (16,)):
        runs = {n: ab.launcher(side, store, queries, order, mode, k) for n, side in sides.items()}
        names = list(runs)
        laid_out = scan_kernel.WGMMA_S8_ORDER
        for n in (n for n in names if n in IN_ORDER):  # its queries laid out at its first run
            scan_kernel.WGMMA_S8_ORDER = tuple(range(64))
            try:
                runs[n]()
            finally:
                scan_kernel.WGMMA_S8_ORDER = laid_out
        bits = {}  # the variants that must keep the tree's lists: whether they do
        if any(n in exact for n in names):
            want = tuple(t.clone() for t in runs["tree"]())
            for n in (n for n in names if n in exact):
                bits[n] = all(torch.equal(a, b) for a, b in zip(runs[n](), want))
            del want
        ms = {n: [] for n in names}
        for r in range(args.rounds):
            for n in (names if r % 2 == 0 else names[::-1]):
                ms[n].append(cs.cuda_ms(runs[n], 3))
        med = {n: float(np.median(v)) for n, v in ms.items()}
        for n in names:
            cs.log(f"[probe] {what}, k_scan {k}, {queries.shape[0]} queries "
                   f"(mean of 3 launches a round, {args.rounds} rounds in turns): {n}: "
                   f"{' '.join(f'{t:.3f}' for t in ms[n])} ms, median {med[n]:.3f} ms = "
                   f"{med[n] / med['tree']:.3f} of the tree's"
                   + ("" if n not in bits else "; the tree's lists" if bits[n] else "; OTHER LISTS")
                   + f"  [{smi}]")
        by_k[k] = {"rounds_ms": ms, "median_ms": med, "same_bits": bits}
        del runs
        torch.cuda.empty_cache()
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"scan_probe_{args.body}.json").write_text(json.dumps(
        {"device": smi, "memory_tb_s": rates, "by_k_scan": by_k}, indent=1))


if __name__ == "__main__":
    main()
