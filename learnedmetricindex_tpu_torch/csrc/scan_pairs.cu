// Fused bucket scan for Hopper (sm_90a): for every (bucket, query-tile)
// pair, each query's exact top-k of  1 - <q, x>·scale(·qscale)  over all
// of the bucket's chunks.
//
// Replaces the TPU kernel learnedmetricindex_tpu/ops/scan_kernel.py
// (_kernel, launched by pallas_scan_pairs).  Same function, not the same
// blocks: the Pallas grid walks (bucket, tile-group, chunk, tile) items
// in order and carries each pair's top-k in VMEM scratch from one grid
// step to the next.  CUDA blocks run in no order, so here one block owns
// one pair and loops over the bucket's chunks itself, keeping the
// running top-k in shared memory.  The wrapper (ops/scan_kernel.py)
// hands this kernel *items*, not whole pairs: each bucket's chunk list
// cut into segments (split_pairs), each (pair, segment) fed as a pair of
// a pseudo-bucket (the refined ptr over the same chunk_of, the pair's
// query slots repeated, a floor's position shifted to the segment's
// start), so that no block holds more than half a slot's fair share of
// the launch and no single bucket ends the grid; csrc/scan_merge.cu then
// merges each pair's item lists.  A row's sums run in the same order in
// whichever block computes it, so the merged lists are this kernel's
// lists over whole buckets, bit for bit; the kernel itself does not know
// of the split.
//
// Semantics (held against scan_pairs_reference in ops/scan_kernel.py):
//  * dist = raw·(−scale)(·qscale) + obias, obias = +inf where scale == 0
//    (padding slot), each step one correctly rounded f32 op, as in the
//    Pallas kernel;
//  * per query, the k smallest by (dist, position in the bucket's scan
//    order): rows arrive in scan order and a new row enters only if it
//    is strictly below the current k-th, so among equal distances the
//    earlier row and the earlier chunk win;
//  * output per pair is (qtile, k) ascending; slots −1 and dist +inf fill
//    what no row reached, and a pair whose bucket has no chunks, or a
//    padding query (qidx −1), gets only the fill.
//
// Two optional inputs (both null on the search path over a packed store):
//  * row map: a *virtual* store keeps no copy of the rows.  The store is
//    then the unmoved (n, d) corpus, and slot s of the id grid `row_ids`
//    (1-based, 0 = padding) holds corpus row row_ids[s] − 1, whose scale
//    is row_scales[row] (an int8 corpus) or 1 (`scales` null); a padding
//    slot's scale is 0.  load_row_meta puts each slot's scale in shared
//    memory beside the slot; each thread reads the rows of the pieces it
//    copies once a tile into registers.  Outputs stay slots;
//  * floor: per (pair, query slot) a (distance, scan position) pair; a row
//    enters a query's list only if its (dist, position in the bucket's
//    scan order) is lexicographically above it (applied where selection
//    reads the distance tile, off the epilogue).  The wrapper answers k
//    wider than the widest list (1024) in rounds of at most 1024, each
//    round's floor the last entry of the round before: exact under the
//    tie rule above, and no list wider than 1024.
//
// What bounds it on an H100.  At the flagship shape (10M×768 int8 store,
// 120 buckets, 10k queries visiting 4, k_scan 16) the scan is ~2.7e12
// multiply-adds (3.2e12 with the query-tile padding) over at most the
// 7.7 GB store: in bf16 on the tensor cores 5.4e12 FLOP / 989 TFLOP/s
// ≈ 5.5 ms against ≤ 7.7 GB / 3.35 TB/s ≈ 2.3 ms of memory, so
// compute-bound; int8 ≈ 2.7 ms; f32 over that store, three bf16 passes
// (below), ≈ 16.4 ms.  The first kernel ran all three modes on the CUDA
// cores (FP32 FMA, DP4A for int8): 257–354 ms bf16 and 84–119 ms int8,
// 1.5–3% of their bound, and f32 241–255 ms.
//
// The design.
//  * Every mode over every store type runs on the tensor cores:
//    warp-level mma.sync.m16n8k16 bf16→f32 and m16n8k32 s8→s32 (exact, so
//    int8 stays bit-equal to the plain version).  A block computes a
//    128-query × 128-row distance tile with 8 warps of 64 × 32 (4 m-tiles ×
//    4 n-tiles, 64 accumulators a thread).  64 × 32 rather than 32 × 64:
//    every B fragment (a store row slice, widened from int8 to bf16 in
//    registers in bf16 mode over an int8 store) then feeds four mma, so the widening
//    costs a quarter of what it would with 2 m-tiles.
//  * Operands sit in shared memory in their storage type (bf16, int8; the
//    f32 rows of an f32 store as f32, split after they are read), fed by a cp.async ring of 64-byte depth slices of the query tile
//    and of the row tile (`commit_group`/`wait_group`: the copies for the
//    next steps are in flight while a step computes) and read with
//    ldmatrix.  Rows are padded by 16 bytes (80, 48 or 208 in all) so
//    that the eight 16-byte rows of an ldmatrix land on distinct banks.  A
//    copy past d, past the chunk's last row or of a padding query is
//    zero-filled (src-size 0), never skipped.  Store rows that are not
//    16-byte aligned (d·size % 16 != 0, e.g. d = 100 int8) are copied 8 or
//    4 bytes at a time through the same ring; rows of fewer than 4-byte
//    granules, and f32 rows in bf16 mode (rounded to bf16 with
//    __float2bfloat16_rn), are staged through registers into the ring.
//  * Queries: the wrapper rounds them to bf16 once per call (bits equal
//    to __float2bfloat16_rn) or passes the int8 rows, zero-padded to a
//    multiple of 16 elements.  bf16 over an int8 store (outside the
//    Hopper body's scope, below):
//    the store stays int8 in shared memory; ldmatrix hands each thread 4
//    consecutive int8 values of a row, which widen exactly to two bf16x2
//    B registers holding k' = (2t, 2t+1) and (2t+8, 2t+9) of a 16-deep
//    step.  That is a fixed permutation of the 16 depths, so the wrapper
//    permutes each 16-element group of the bf16 queries the same way
//    (WIDEN_ORDER in ops/scan_kernel.py) and the products pair up.  The
//    queries are never quantized.
//  * f32 over an int8 or bf16 store (precision="highest" on the main
//    path): the wrapper splits each f32 query value exactly into three
//    bf16 terms, hi = bf16(q), mid = bf16(q − hi), lo = bf16(q − hi − mid)
//    (hi + mid + lo == q for 2^-110 <= |q| < bf16's overflow edge; below
//    2^-110 less than 2^-133 is lost), and lays the three terms of each
//    32-value depth slice side by side (zero-padded to a multiple of 32,
//    each 16-group in WIDEN_ORDER over an int8 store).  Store values are
//    exact in bf16, so every product is exact and only the sums round, as
//    in the Pallas kernel's multi-pass f32 (Precision.HIGHEST).  Each B
//    fragment is widened once and feeds the three terms' mma.  The tensor
//    cores truncate the sum they add into, so the running sum is never
//    their accumulator: each 16-deep step sums lo, mid and hi (smallest
//    first) into a fresh fragment, which one round-to-nearest f32 add puts
//    into the running sum.  Three query terms make a stage 2.25× larger,
//    so this body's ring has two stages, not three (two blocks an SM at
//    list width 32 need both to fit).  This is not TF32: no operand is
//    rounded.
//  * f32 over an f32 store (precision="highest" over
//    BuildConfiguration(dtype="float32"), the CLI's store, a virtual store
//    over an f32 corpus; at list width 32 over a packed store the Hopper
//    body of six products below takes it): f32 rows are not exact in
//    bf16, so the kernel splits each store value too, by truncation with
//    bit masks: hi = the top 16 bits of x, mid = the top 16 bits of
//    x − hi, lo = x − hi − mid.
//    Both subtractions are exact, lo has at most 8 significant bits, and
//    hi + mid + lo == x for 2^-110 <= |x| and for 0 (below 2^-110 less than
//    2^-133 is lost); no conversion instruction, and no term rounds up to
//    bf16's infinity (round-to-nearest does from ~3.39e38).  Of the nine
//    products of the two splits the body computes the six that reach f32
//    precision, lo·hi, hi·lo, mid·mid, mid·hi, hi·mid and hi·hi (query term
//    first), summed smallest first into a fresh fragment and added once,
//    rounded, into the running sum, as in the three-term body.  The
//    dropped mid·lo, lo·mid and lo·lo are below ~2^-21.4 of |q_i·x_i|
//    (|q_mid| <= 2^-8|q|, |q_lo| <= 2^-16|q| rounded; |x_mid| < 2^-7|x|,
//    |x_lo| < 2^-14|x| truncated).  The queries are the three-term body's
//    rows (no WIDEN_ORDER).  A stage is 16 depths: the three query terms'
//    32-byte slices side by side, and 16 f32 values of each store row
//    copied with cp.async in value pairs, placed so that lane t of a quad
//    reads the values 2t, 2t+1, 2t+8 and 2t+9 of its B fragment as one
//    16-byte load (rows of 64 bytes: two rows a quarter-warp, no bank
//    conflict); each lane splits the values it loads into the three terms'
//    B fragments, and each fragment feeds four m-tiles.  Three such stages
//    take the distance tile's 67,584 B, so a width-32 block would fit two
//    blocks an SM; it runs one (__launch_bounds__ 256, 1: ~250 registers a
//    thread), because at two the 128-register cap cannot hold the 64
//    accumulators beside the 24 registers of B fragments, the 12 of A and
//    the fresh sums, and spills 204 bytes: 224.8 ms against 154.6 ms at the
//    flagship on an H100.  32-deep stages and deeper rings measured no
//    faster.
//  * The ring shares the distance tile's shared memory and drains at the
//    end of every row tile; at list width 32 a block takes
//    ~104–111 KB, so two blocks share an SM (the six-term body excepted,
//    above) and one block's epilogue and selection overlap the other's mma.  (One block an SM with a deeper
//    ring that never drains was slower: the selection then stalls the
//    tensor cores.)
//  * Selection, the same rule for every mode.  The epilogue writes the
//    f32 distance tile [row][query] and marks, per query and 32-row
//    group, whether any distance lies below the query's current k-th:
//    after the first tiles of a bucket almost nothing does, and unmarked
//    groups are skipped.  Lists live query-major (a query's entries side
//    by side, ascending).  A warp takes one query at a time.  Width 32
//    (k <= 32): the list sits in the lanes, one ballot finds
//    a marked group's candidates and each enters with a ballot (its rank)
//    and two shuffles, in scan order.  Wider lists: the warp packs the
//    tile's candidates of the query into its buffer, ranks them, and
//    merges them into the list in one pass (select_tile_merge).
//
// The wide lists (k_scan 33 to 1024, and every round of a wider k).
// What bounded them: one thread a query inserted each entering row by
// shifting its list in shared memory; the first k rows of every (query,
// bucket) enter and then about k·ln(n/k) more, each moving ~k/2 entries
// one after another, so millions of dependent shared-memory moves a
// query at k 1024 (on an H100, 1.10 s for the 1024-wide round of 256
// queries over the virtual 10M×768 store, against 107 ms for a gather,
// a matmul and a topk a bucket in PyTorch); and above width 128 each of
// a pair's 2, 4 or 8 blocks computed the whole 128-query tile, padding
// blocks included.  The design: a warp merges a tile's candidates (at most 128) with O((k +
// c)/32 · log k) work at 32 lanes (select_tile_merge), and a block
// spends copies, ldmatrix, mma and epilogue only on the m-tiles (16
// query slots) that hold a query it owns; a block that owns none writes
// the fill and leaves before its first tile.
//
// The split (ops/scan_kernel.py::segment_length): a block's work is its
// item's chunks × the 16-query m-tiles it computes (all 8 at width 32;
// the live ones of its own query slots above), the card's slots are the
// SMs × this instance's blocks an SM (lmi_scan_body, the
// occupancy API), and a segment is the longest that keeps every block
// within half a slot's share of the launch.  Items still start largest
// first (pair_order).  Each segment's lists start empty, so a smaller
// segment costs more selection warm-up (its first rows all enter) and
// more merge input.
//
// The Hopper body (scan_wgmma_kernel): bf16 queries over an int8 packed
// store at list width 32, the default search's scan (wgmma_scope picks it;
// lmi_scan_body tells the wrapper, which lays out the queries and splits
// the pairs for the body it names).  What bounded the mma.sync body there (tools/torch_scan_probe.py
// on an H100, 29.2 ms at the flagship): the query tile reloaded from L2
// for every row tile (a fifth of the time), selection (a ninth), the
// widening (an eighth), and what is left with all three gone, 19.7 ms:
// mma.sync issued warp by warp behind a __syncthreads every 32-deep step
// of a ring that drains every row tile.  The design:
//  * a block owns 64 query slots (a pair of more than 64 takes two
//    blocks), and their bf16 rows stay in shared memory for the whole
//    item (d rounded up to 128, 98,304 B at d 768), written once in the
//    layout wgmma's B operand reads (K-major, no swizzle, core matrices
//    of 8 queries × 8 depths);
//  * store rows are wgmma's A operand, from registers: 384 threads, two
//    consumer warpgroups of 64 rows each and a producer warpgroup whose
//    first two warps each feed one consumer's ring of 2 stages of 64
//    rows × 128 depths (two TMA boxes of 64 × 64 bytes a stage) (a 2-D tensor map over the store, boxes
//    that may reach past the chunk, whose rows the epilogue masks, or
//    past the store, which TMA fills with zeros); full and empty
//    mbarriers, and the producer runs ahead across row tiles and chunks,
//    so the ring never drains; setmaxnreg moves the producer's registers
//    to the consumers;
//  * a consumer lane reads 16 bytes of each of its two rows a stage and
//    widens word j into the A registers of k-step j (widen_s8x4, exact),
//    one stage ahead of the tensor cores: the depth map is WGMMA_ORDER
//    (ops/scan_kernel.py), which the wrapper applies to the queries;
//    wgmma.m64nNk16 with N = 16 × the block's m-tiles up to its last live
//    one, so a block of a few queries does not pay for 64;
//  * the two consumer warpgroups take alternate 64-row tiles; after its
//    wgmma a warpgroup writes its own distance tile and marks (against a
//    k-th that can only be stale from above), waits for the other to
//    finish selecting the tile before (a named barrier), and selects with
//    select_tile_warp's rule (wgmma_select) while the other warpgroup's
//    wgmma runs, so selection overlaps the tensor cores and the lists see
//    the tiles in scan order.
// It sums each 16-deep step on the tensor cores in another order than
// mma.sync, so its lists match the plain version to the bf16 bar, not
// the mma.sync body's bits.
//
// The Hopper body over f32 rows (scan_wgmma_f32_kernel): bf16 queries over
// an f32 packed store at list width 32, the default search over
// BuildConfiguration(dtype="float32") (both packages' default store type)
// and the SISAP CLI's scan.  The same block as above (64 resident query
// slots, a producer warp a consumer warpgroup, two consumers taking
// alternate 64-row tiles, the same epilogue and selection); what differs
// is the ring and the A fragments.  What bounded the mma.sync body there:
// it staged f32 rows through registers with scalar loads, each value
// rounded by __float2bfloat16_rn, into a ring that drains every row tile
// (8.5–9% of its bound by bytes at the CLI's shape on an H100).  Bytes
// bound this body, not tensor work: an f32 row gives 32 operations a byte
// against 64 query slots, far below the ~295 the card needs before its
// tensor cores set the pace.  The design:
//  * the ring holds the rows as f32, as TMA writes them: boxes of 64 rows
//    × 32 f32 (128 bytes), two a stage (64 depths, four k-steps, 16 KB),
//    two stages a consumer (64 KB), under TMA's 128-byte swizzle, so the
//    resident query tile fits up to d 896 (W_MAX_QD_F) beside the 52 KB
//    head;
//  * in k-step j of a box lane (g, t) reads chunk 2t + j (16 bytes) of
//    rows g and g+8, which the swizzle puts at chunk (2t + j) ^ g: a
//    quarter-warp's eight loads hit eight distinct chunks, all 32 banks
//    (without the swizzle a 128-byte row pitch puts them on half the
//    banks); cvt.rn.bf16x2.f32 rounds each value pair into one A
//    register, round to nearest even as the plain version's
//    .to(torch.bfloat16); the wrapper permutes each 32-group of the
//    queries to match (WGMMA_F32_ORDER in ops/scan_kernel.py);
//  * a warp finds the queries its selection must visit with one load a
//    lane and a ballot (6% at the flagship's f32 store on an H100).
// What it measured (tools/torch_scan_probe.py --body wgmma-f32, PERF.md):
// 0.50 of the mma.sync body's time at the flagship's 31 GB f32 store; no
// one part bounds it (without the TMA copies 0.64 of its time, without the
// selection 0.82, without the wgmma 0.83, without the rounding 0.99).  The
// pair's two blocks as a cluster with each box multicast into both rings
// was slower (each block then waits on the other's consumers), and so
// were deeper rings of smaller stages and three consumer warpgroups.
// Its lists match the plain version to the bf16 bar, as the int8 body's.
//
// The Hopper body in f32 mode (scan_wgmma_f32mode_kernel): f32 queries over
// an int8 packed store at list width 32, precision="highest" (the
// reference's all-f32 scan; the default of sharded_search and
// scan_buckets).  What bounded the mma.sync body there
// (tools/torch_scan_probe.py --body mma-f32mode, 70.4 ms at the flagship on
// an H100): without any mma.sync 39.3 ms, whatever else was removed: a ring
// of two stages that reloads the three bf16 terms of the tile's 128
// queries from L2 for every row tile, drained every tile, with spills.
// The design: the int8 body's block, ring and producer; the rows widened
// into A registers once (int8 values are exact in bf16, so one A fragment
// serves all three terms); the three terms hi, mid, lo of the block's
// query slots resident as planes side by side in one B tile, so each
// k-step is one wgmma m64n(3N)k16 over the live m-tiles; and the
// rounding of the mma.sync body kept: the tensor cores truncate the sum
// they add into, so each term's products go into a fresh sum for one ring
// stage (8 k-steps, 128 depths; the stage's first k-step does not add),
// and the stage is then folded into the running f32 sum with
// round-to-nearest adds, lo + mid first, then hi, then the running sum
// (fold_terms), once the warpgroup has waited for that stage (the next
// stage's rows are widened while it runs; the other warpgroup's wgmma
// overlaps the fold).  Three planes of 64
// slots would take 294,912 B at d 768, so a block keeps 32 slots (WQ3;
// 147,456 B at d 768 beside a 26,624 B head and the 32 KB ring, d up to
// 896), and a pair of more than 32 queries takes up to four blocks, each
// reading the bucket's rows (L2 serves the blocks of a pair that start
// together).  Its lists match the plain version to the f32 parity bar.
//
// The Hopper body with wide lists (scan_wgmma_wide_kernel<64 | 128>): bf16
// queries over an int8 packed store at list widths 64 and 128 (k_scan 33
// to 128: search(k=100) scans at 106), in place of MmaBody<MODE_BF16,
// int8_t, 64 | 128>.  What bounds the work at the flagship (10k queries
// visiting 4, k_scan 106): the same ~5.47 ms of bf16 tensor work as at
// k_scan 16, and 24.9 GB of int8 rows read once a pair (7.4 ms from
// device memory; L2 serves a pair's two blocks).  What bounded the
// mma.sync body there (60.5 ms on an H100, the library call 54.4): its
// 128-slot blocks, one an SM, reload the query tile from L2 for every
// row tile through a ring that drains every tile, and selection (a warp
// merging each tile's candidates into a query's list with binary
// searches in shared memory, ~22-24 ms by tools/torch_scan_split.py)
// runs while no mma does.  The design:
//  * the width-32 body's block: 64 query slots resident, a producer warp a
//    consumer warpgroup's TMA ring, two consumer warpgroups taking
//    alternate 64-row tiles, the rows widened into A registers, one
//    wgmma a k-step, the hand-over keeping the tiles in scan order; the
//    lists (64 slots × KMAX × 8 B) take the head's room, so at width 128
//    the block takes exactly the 232,448 B it may have at d 768 (d up to
//    768; up to 1024 at width 64), and it keeps no candidate buffer;
//  * selection (wgmma_select_wide) while the other warpgroup's wgmma
//    runs: a warp finds its marked queries with one load a lane and a
//    ballot, and merges a query's candidates with its list in registers,
//    one pass over the candidates by shuffles and ballots, in place of
//    select_tile_merge's packed buffer and binary searches (the first
//    design, that port, took 55.2 ms at the flagship).
// Its lists match the plain version to the bf16 bar, as the width-32
// body's, not the mma.sync body's bits.
//
// The Hopper body of six products (scan_wgmma_f32x_kernel): f32 queries
// over an f32 packed store at list width 32, precision="highest" over
// BuildConfiguration(dtype="float32") (both packages' default store type,
// the CLI's), in place of MmaBody<MODE_F32, float, 32>.  What bounds the
// work at the flagship (its rows as a 31 GB f32 store, 10k queries
// visiting 4, k_scan 16): six bf16 passes, 32.8 ms at the tensor peak, and
// 99.6 GB of f32 rows read once a pair, ~29.7 ms from device memory.  What
// held the mma.sync body (155 ms on an H100): one 256-thread block an SM
// at ~250 registers, the three query terms reloaded from L2 through a
// 3-stage cp.async ring of 16 depths for every row tile, and mma.sync
// issued warp by warp.  The design combines the two bodies above it:
//  * the f32 ring of the body over f32 rows (boxes of 64 rows × 32 f32
//    under the 128-byte swizzle, fed by TMA from producer warps, a lane
//    reading chunk 2t + j of its rows in k-step j, the queries in
//    WGMMA_F32_ORDER), in stages of one box: the three planes of 32 slots take 147,456 B at d 768 beside
//    the 26,624 B head, and the two-box stages' 64 KB would pass the
//    232,448 B a block may have; d up to 896 (W_MAX_QDX);
//  * the f32-mode body's block: 32 query slots (WQX; a pair of more than
//    32 queries takes up to four blocks), the three terms hi, mid, lo
//    resident as planes of one B tile (column term·16·nl + slot);
//  * each store value split in registers by truncation into three bf16
//    terms (split_pair, split3's rule), the A fragments of six wgmma
//    m64nNk16 a k-step, each over one plane: exactly mma_six's six
//    products, x_hi · q_hi into a large sum and the other five (each below
//    ~2^-7 of it) into a small one;
//  * the tensor cores truncate the sum they add into, so the running sum
//    is never theirs: the two sums of two boxes (64 depths) are folded
//    into it with round-to-nearest adds (fold_two), and the rows are split
//    a box ahead of the tensor cores into two sets of A registers in turns
//    (a box is two k-steps of three terms).  With the five small products
//    in the large sum (three wgmma a k-step of 3N, 2N and N columns over
//    the planes' prefixes, a wgmma.fence between the shapes, which add
//    into the same registers) the body's float64 error was twice
//    cuBLAS's: each truncating add into the large sum loses up to an ulp
//    of it, and the small products tripled those adds;
//  * the epilogue, the marks, the hand-over and wgmma_select are the other
//    bodies'.
// What it measured (tools/torch_scan_probe.py --body wgmma-f32x and
// tools/torch_scan_ab.py on an H100, PERF.md): 0.62 of the mma.sync body's
// time at the flagship's 31 GB f32 store; without the wgmma 0.60 of its
// time, without the TMA copies 0.86, without selection 0.99; 16 slots a
// block (two-box stages) 1.46×, three one-box stages a ring 1.03×.  Its
// lists match the plain version to the f32 parity bar, and its float64
// error stays below the plain version's (cuBLAS's SGEMM) and the mma.sync
// body's.
//
// The Hopper body in int8 mode (scan_wgmma_s8_kernel): int8 queries with
// per-query scales over an int8 packed store at list width 32,
// precision="int8" (the reference bench's fast scan mode, a precision of
// the server and of LearnedIndex.search), in place of MmaBody<MODE_INT8,
// int8_t, 32>.  What bounds the work at the flagship (10k queries visiting
// 4, k_scan 16): ~2.7e12 multiply-adds, 2.73 ms at the int8 tensor peak,
// the 7.7 GB store at most ~2.3 ms from device memory.  The design is the
// bf16 body's block with nothing to widen:
//  * PR 15's int8 ring and producer warps, four stages a consumer (two
//    stall the tensor cores on the copies: 1.11× the time at the flagship
//    on an H100, three 1.05×, five 1.03×, six 1.02×), 64 query slots a
//    block (128 would take 236,544 B at d 768);
//  * s8 wgmma m64nNk32 into s32 sums (twice the bf16 rate), A the tile's
//    rows from registers as they are (16 bytes a lane a box: words 2s and
//    2s + 1 are k-step s's A fragment; the queries in WGMMA_S8_ORDER; A
//    from shared memory through a descriptor over the box under the 64-byte
//    swizzle measured 1.02× the time at four stages, 1.21× at two), B
//    the block's int8 queries resident K-major (64 × qd bytes, half the
//    bf16 tile's, so d up to 1664: W_MAX_QDS8), each slot's f32 query scale
//    in the head beside them;
//  * the epilogue, marks, hand-over and selection of the other bodies; the
//    integer sums are exact in any order and the epilogue is the mma.sync
//    body's distance<true>(float(sum), row scale, query scale), so its lists
//    are the mma.sync body's and the plain version's, bit for bit.
//
// The Hopper body in int8 mode with wide lists
// (scan_wgmma_s8_wide_kernel<64 | 128>): int8 queries over an int8 packed
// store at list widths 64 and 128 (k_scan 33 to 128: precision="int8" at
// search(k=100) scans at 106), in place of MmaBody<MODE_INT8, int8_t, 64 |
// 128>.  What bounds the work at the flagship (k_scan 106): the int8 body's
// ~2.7e12 multiply-adds, 2.73 ms at the int8 tensor peak, and the rows
// read once a pair.  What held the mma.sync body there (~45 ms on an H100,
// 6% of that bound): the wide lists' merge of each tile's candidates in shared
// memory while no mma runs, and the query tile reloaded from L2 every row
// tile.  The design is the two bodies above it put together, each part
// unchanged: the int8 body's block (its ring of WS8W_STAGES stages a
// consumer, 64 query slots with the int8 queries resident K-major and their
// scales in the head, s8 wgmma with A the rows from registers, the epilogue
// distance<true>(float(sum), row scale, query scale)) with the wide-list
// body's lists of width KMAX in the head, marks against each list's k-th
// and wgmma_select_wide.  The head takes 102,400 B at width 128 (69,632 B
// at 64), so four stages keep an int8 query tile of up to 896 (1408)
// resident: S8WideList<KMAX>::MAX_QD.  The sums are exact integers, and
// the epilogue and the tie rule (entries, the earlier rows, win ties) are
// the mma.sync body's, so its lists are that body's and the plain
// version's, bit for bit.
// What it measured (tools/torch_scan_ab.py and tools/torch_scan_probe.py
// --body wgmma-s8-wide on an NVIDIA H100 80GB HBM3 at 700.00 W, PERF.md):
// 0.48 of the mma.sync body's time at k_scan 106 (21.6 against 44.8 ms)
// and 0.44 at 64.  Selection bounds it: without it 0.47 of its time at 106
// (the int8 wgmma of a tile is half the bf16 body's, so less of the merge
// hides behind the other warpgroup's wgmma); rings of 2 and 3 stages 1.00
// and 0.97 of four at 106, 1.07 and 1.02 at 64; 32 slots a block 1.18 and
// 1.29.
//
// The Hopper body in f32 mode with wide lists
// (scan_wgmma_f32mode_wide_kernel<64 | 128>): f32 queries over an int8
// packed store at list widths 64 and 128 (k_scan 33 to 128:
// precision="highest" at search(k=100) scans at 106), in place of
// MmaBody<MODE_F32, int8_t, 64 | 128>.  What bounds the work at the
// flagship (k_scan 106): the three bf16 passes of the f32-mode body, 16.4
// ms at the tensor peak.  The design is the two bodies above it put
// together, each part unchanged: the f32-mode body's block (the int8 ring
// and producer warps, 32 query slots with the three terms resident as
// planes of one B tile, the rows widened a box ahead into two sets of A
// registers in turns, one wgmma m64n(3N)k16 a k-step into a fresh sum a
// stage, folded with rounded adds) with the wide-list body's lists of
// width KMAX in the head, marks against each list's k-th and
// wgmma_select_wide (lanes 0 to 7 of a warp hold its marked queries of
// the 32 slots).  Three planes of 64 slots would take 294,912 B at d 768,
// so the block keeps 32; its head takes 51,200 B at width 128 (34,816 B
// at 64), so with the planes (147,456 B at d 768) and a two-stage ring the
// widest resident tile is 768 at both widths: F32ModeWideList<KMAX>.  Each
// (query, row) sum is the width-32 f32-mode body's, bit for bit, so its
// lists hold the same distances; they match the plain version to the f32
// parity bar.
// What it measured (tools/torch_scan_ab.py and tools/torch_scan_probe.py
// --body wgmma-f32mode-wide on an NVIDIA H100 80GB HBM3 at 700.00 W,
// PERF.md): 0.49 of the mma.sync body's time at k_scan 106 (46.0 against
// 94.3 ms) and at 64 (42.9 against 87.0).  The three-plane wgmma bounds
// it (without it 0.40 of its time); selection and hand-over hide behind
// the other warpgroup's wgmma but for ~0.14 of it at 106 (~0.07 at 64);
// no TMA copies 1.00; a ring of three stages at width 64 1.03.
//
// The Hopper body over f32 rows with wide lists
// (scan_wgmma_f32_wide_kernel<64 | 128>): bf16 queries over an f32 packed
// store at list widths 64 and 128 (k_scan 33 to 128: the default
// search(k=100) over BuildConfiguration(dtype="float32"), both packages'
// default store type, scans at 106), in place of MmaBody<MODE_BF16, float,
// 64 | 128>.  What bounds the work at the flagship (its rows as a 31 GB
// f32 store, k_scan 106): 30.8 GB read once, 9.2 ms from device memory (an
// f32 row gives too few operations a byte for the tensor cores to set the
// pace).  What held the mma.sync body there (115.4 ms on an H100, 2.1x the
// library call's 54.0): f32 rows staged through registers into a ring that
// drains every row tile, the query tile reloaded from L2 for every one,
// and the wide lists' merge in shared memory while no mma runs.  The design
// is the two bodies above it put together, each part unchanged: the body
// over f32 rows (the f32 TMA ring under the 128-byte swizzle fed by
// producer warps, a lane reading chunk 2t + j of its rows in k-step j and
// rounding each pair to nearest even into an A register, the queries in
// WGMMA_F32_ORDER) with the wide-list body's 64 query slots, lists of width
// KMAX in the head, marks against each list's k-th, wgmma_select_wide and
// the hand-over that keeps the tiles in scan order.  The head takes 68,608
// B at width 64 and 101,376 B at 128: beside the 98,304 B of 64 resident
// query rows at d 768, the stages keep two boxes at width 64 and one at 128
// (two would make 265,216 B), so the block takes exactly its 232,448 B at
// both widths and the widest resident tile is 768: F32WideList<KMAX>.  Its
// k-steps go into one sum in the width-32 body's order, so each (query, row)
// sum is that body's bits; its lists match the plain version to the bf16
// bar, not the mma.sync body's bits.
// What it measured (tools/torch_scan_ab.py and tools/torch_scan_probe.py
// --body wgmma-f32-wide on an NVIDIA H100 80GB HBM3 at 700.00 W, PERF.md):
// 0.406 of the mma.sync body's time at k_scan 106 (47.3 against 116.5 ms)
// and 0.296 at 64 (32.3 against 109.0).  The one-box stages bound the
// width-128 instance: at width 64 they take 1.36x the time of two-box ones
// (a 32 KB ring keeps too few bytes in flight), and without TMA copies the
// width-128 instance takes 0.60 of its time; the other ways to fit two-box
// stages at width 128 were slower: 48 slots a block 1.05x, 32 slots 1.02x
// (a pair's rows read by three or four blocks); an L2 prefetch of each
// ring's next tile 1.27x.
//
// The Hopper bodies over a row map (scan_wgmma_rowmap_kernel,
// scan_wgmma_f32mode_rowmap_kernel): bf16 and f32 queries over a virtual
// store of an int8 + row-scale corpus at list width 32 (the default and
// precision="highest" searches over LearnedIndex.get_bucket_store of a
// corpus tensor: the id grid, 40.5 MB at the flagship, against the packed
// store's 7.7 GB), in place of MmaBody<MODE_BF16 | MODE_F32, int8_t, 32>
// in row-map mode.  What bounds the work: the packed bodies' (5.5 ms bf16,
// 16.4 ms f32 at the flagship), the rows now scattered over the corpus.
// A slot's int8 bytes, its scale and its place in the scan order are a
// packed store's of the same corpus, so the design is the blocks of
// scan_wgmma_kernel and scan_wgmma_f32mode_kernel with two parts new:
//  * a gathering producer: TMA boxes span contiguous store rows, so each
//    consumer's ring is filled by a whole producer warp (wgmma_gather)
//    that reads the tile's 64 ids once and issues 16-byte cp.async copies
//    of each stage's 128 depths of each row from corpus + (id − 1)·d
//    (64-bit) to the places TMA fills in the packed bodies, zeros for a
//    padding slot, a row past the chunk and depths past d; each lane has
//    the stage's full barrier wait for its copies
//    (cp.async.mbarrier.arrive), lane 0 makes its one expected arrival;
//    the empty side, the walk and running ahead are wgmma_produce's;
//  * the scale through the grid: each consumer reads its rows' ids as a
//    tile starts and their scales (load_row_meta's rule) once the tile's
//    first wgmma is queued (wgmma_consume_rowmap,
//    wgmma_consume_terms_rowmap: the packed consumers spelled out, so the
//    other instances keep their code);
//  * rings of their own depth, RM_STAGES for bf16 and RM3_STAGES for f32
//    (the three planes leave room for three stages at d 768).
// The sums, the epilogue and the tie rule are the packed bodies', so the
// lists are body 1's and body 3's over a packed store of the same corpus,
// bit for bit.  A row map over an f32 or bf16 corpus, lists past 32,
// rounds under floors and rows not of whole 16 bytes keep the mma.sync
// body.
// What they measured (tools/torch_scan_ab.py and tools/torch_scan_probe.py
// --body wgmma-rowmap | wgmma-f32mode-rowmap on an NVIDIA H100 80GB HBM3 at
// 700.00 W, PERF.md): 0.78 of the mma.sync body's time in bf16 (23.3
// against 29.8 ms at the flagship's virtual store) and 0.61 in f32 (46.8
// against 76.2), ~1.09x the packed bodies.  The gather costs ~11% (no
// copies: 0.885 / 0.895 of the time); rings of 2 stages 1.01 / 1.02, of 3
// (bf16) 1.00; the ids read a tile ahead spilled the producer past its 40
// registers (1.09x); the idle producer warps helping 1.16 / 1.20x; one
// 64-byte cp.async.bulk a row and box 4.5 / 4.2x.
// The other bodies keep the mma.sync design.
//
// What is left for later work:
//  * f32 over a bf16 store, f32 over an f32 store at list widths past 32,
//    and bf16 over a bf16 store on the Hopper bodies;
//  * the split's cost: one host read of the plan and one upload of the
//    work list a launch, and a merge pass; a persistent grid that takes
//    items from a device-side queue would need neither the read nor the
//    cut by a fixed share;
//  * the wide lists of the other modes and stores, and widths 256 to
//    1024, on the mma.sync body: a merge costs a few dozen dependent
//    shared-memory steps however few its candidates, and a block of
//    211 KB has its SM alone, so nothing overlaps it;
//  * a block that owns a few queries is bound by its walk of the bucket,
//    24 depth steps a row tile through a two-stage ring; above width 128
//    the split blocks of a pair each read the bucket's rows, and k > 1024
//    walks them once more a round;
//  * the count gate of the Pallas kernel is an optimisation of its
//    selection sweeps; the group marks above play its part here.
//
// Shared memory per list width (KMAX, the smallest of 32/64/128/256/512/
// 1024 that holds k): lists 2·KMAX·QB·4 B + 4,096 B of row and query
// metadata, floors and group marks + above width 32 the warps' candidate
// buffers (8 warps × 128 × (distance, slot) = 8,192 B) + the work area:
// the 67,584 B distance tile, which the rings reuse.  Rings: one query
// term, 3 stages of 128 × (80 + 80) or (80 + 48) B = 61,440 or 49,152 B;
// the three-term body over an int8 store 2 × 128 × (208 + 48) = 65,536 B;
// f32 over an f32 store 3 × 128 × (112 + 64) = 67,584 B; the three-term
// body over a bf16 store 2 × 128 × (208 + 80) = 73,728 B, larger than the
// distance tile, sets the work area at 73,728 B.  With the distance tile:
//   KMAX   32:  32,768 + 4,096 +     0 + 67,584 = 104,448 B (two blocks an SM;
//                                                  the six-term body one)
//   KMAX   64:  65,536 + 4,096 + 8,192 + 67,584 = 145,408 B
//   KMAX  128: 131,072 + 4,096 + 8,192 + 67,584 = 210,944 B
//   KMAX  256: 131,072 + 4,096 + 8,192 + 67,584 = 210,944 B (QB = 64)
//   KMAX  512: 131,072 + 4,096 + 8,192 + 67,584 = 210,944 B (QB = 32)
//   KMAX 1024: 131,072 + 4,096 + 8,192 + 67,584 = 210,944 B (QB = 16)
// (+ 6,144 B where the three-term ring sets the work area; at most
// 217,088 of a block's 232,448 B.)  Up to KMAX 128 a block owns all QT =
// 128 queries of its pair; above, the lists of 128 queries would take
// more than a block's 227 KB, so the pair's queries are split over QT/QB
// = 2, 4 or 8 blocks of QB = 64, 32 or 16, each computing only the
// m-tiles of its own queries.  Each block owns whole queries of its item;
// only an item's segments of one pair are merged (csrc/scan_merge.cu).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int QT = 128;       // query slots per block (qtile <= QT)
constexpr int RT = 128;       // store rows per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// distance tile [RT][DQ], row-major by store row: DQ ≡ 4 (mod 32) banks,
// so both the mma epilogue's stores and the selection's loads (32
// queries of one row) are conflict-free
constexpr int DQ = QT + 4;
constexpr int GROUPS = RT / 32;  // 32-row groups of a tile, one per warp column

// tensor-core bodies: a ring of KB-byte slices of each query term row
// (bf16: 32 values, int8: 64) and of each store row
constexpr int KB = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_K = 1024;  // the widest list
static_assert(THREADS == 8 * 32 && QT == 2 * 64 && RT == 4 * 32, "8 warps of 64 x 32");

enum Mode { MODE_F32 = 0, MODE_BF16 = 1, MODE_INT8 = 2 };
enum StoreType { STORE_F32 = 0, STORE_BF16 = 1, STORE_INT8 = 2 };

struct Params {
  const void* queries;        // (n_queries, nt·qd) bf16 or int8, see lmi_scan_pairs
  const float* qscales;       // (n_queries,) f32, int8 mode only
  const int* qidx;            // (n_pairs*qtile,) query row per slot, -1 = pad
  const int* pair_bucket;     // (n_pairs,)
  const int* pair_order;      // (n_pairs,) pair of each block, largest bucket first
  const int* ptr;             // (n_buckets+1,) chunk CSR
  const int* chunk_of;        // CSR position -> physical chunk
  const void* store;          // (n_slots, d); with row_ids the (n, d) corpus
  const float* scales;        // (n_slots,) f32, 0 = padding slot; with row_ids (n,) row
                              // scales, or null for 1
  const int* row_ids;         // (n_slots,) 1-based corpus row of each slot, 0 = pad; null
                              // for a packed store
  const float* floor_d;       // (n_pairs*qtile,) floor distance, or null for none
  const int* floor_p;         // (n_pairs*qtile,) floor scan position
  float* out_d;               // (n_pairs, qtile, k)
  int* out_s;                 // (n_pairs, qtile, k)
  int qtile, k, d, qd, chunk;
  int copy_bytes;             // cp.async granule of store rows (16/8/4), 0 = via registers
};

// store-row bytes of a stage: KB, or KB/2 where int8 rows meet bf16
// queries (WIDEN: 32 int8 values, widened in registers)
__host__ __device__ constexpr int b_stage_bytes(bool widen) { return widen ? KB / 2 : KB; }
__host__ __device__ constexpr int b_stride(bool widen) { return b_stage_bytes(widen) + 16; }
// query-row bytes of a stage: the nt terms' slices side by side
__host__ __device__ constexpr int a_stride(int nt) { return nt * KB + 16; }
__host__ __device__ constexpr size_t stage_bytes(int nt, bool widen) {
  return size_t(QT) * a_stride(nt) + size_t(RT) * b_stride(widen);
}
// three stages of one query term; two of three terms, or the ring would
// not leave room for two blocks an SM at list width 32
__host__ __device__ constexpr int ring_stages(int nt) { return nt == 1 ? 3 : 2; }
__host__ __device__ constexpr size_t ring_bytes(int nt, bool widen) {
  return ring_stages(nt) * stage_bytes(nt, widen);
}

constexpr size_t kMetaBytes = size_t(5 * QT + 3 * RT) * 4;
// lists wider than 32: each warp's buffer of one tile's candidates of a
// query, (distance, slot) for at most RT rows
constexpr size_t kCandBytes = size_t(WARPS) * RT * 8;
constexpr size_t kDistBytes = size_t(RT) * DQ * 4;
// f32 over an f32 store: stages of KX depths, the three query terms'
// slices (2·KX bytes each) and KX f32 values of each store row (rows of
// 64 bytes, unpadded: a quarter-warp's 16-byte loads read two rows)
constexpr int KX = 16;
constexpr int SX_A = 3 * KX * 2 + 16;
constexpr int SX_B = KX * 4;
constexpr int SX_STAGES = 3;
constexpr size_t kSplitXRingBytes = SX_STAGES * (size_t(QT) * SX_A + size_t(RT) * SX_B);
// the work area: the distance tile, whose memory the ring reuses, or the
// ring where it is larger
__host__ __device__ constexpr size_t work_bytes(size_t ring) {
  return ring > kDistBytes ? ring : kDistBytes;
}
constexpr size_t kMaxWorkBytes = work_bytes(ring_bytes(3, false));
static_assert(ring_bytes(1, false) <= kDistBytes && ring_bytes(1, true) <= kDistBytes &&
                  ring_bytes(3, true) <= kDistBytes && kSplitXRingBytes <= kDistBytes,
              "the rings reuse the distance tile's memory");

// queries whose lists a block keeps, for a list width
__host__ __device__ constexpr int queries_per_block(int kmax) {
  return kmax <= 128 ? QT : QT * 128 / kmax;
}
__host__ __device__ constexpr size_t smem_bytes(int kmax, size_t work) {
  return 2 * size_t(kmax) * queries_per_block(kmax) * 4 + kMetaBytes +
         (kmax == 32 ? 0 : kCandBytes) + work;
}
static_assert(smem_bytes(128, kMaxWorkBytes) <= 232448 && smem_bytes(256, kMaxWorkBytes) <= 232448 &&
                  smem_bytes(512, kMaxWorkBytes) <= 232448 &&
                  smem_bytes(MAX_K, kMaxWorkBytes) <= 232448,
              "lists must fit one block's shared memory");
// blocks an SM at a list width (228 KB an SM, 1 KB of it reserved per block)
__host__ __device__ constexpr int blocks_per_sm(int kmax) { return kmax == 32 ? 2 : 1; }
static_assert(2 * (smem_bytes(32, kMaxWorkBytes) + 1024) <= 233472, "two blocks an SM at list width 32");

template <int KMAX>
struct Smem {
  static constexpr int QB = queries_per_block(KMAX);
  // lists of width 32 take a tile's rows one at a time in a warp's lanes
  // (select_tile_warp); wider ones all of a tile's candidates at once
  // (select_tile_merge)
  static constexpr bool WARP_LISTS = KMAX == 32;
  float* top_d;         // KMAX·QB running top-k distances, entry at(q, i)
  int* top_s;           // KMAX·QB their slots
  int* q_row;           // [QT] query row of compute slot q, -1 = none
  float* q_sc;          // [QT]
  int* r_slot;          // [RT] slot of the tile's row r, -1 = past the chunk
  float* r_sc;          // [RT]
  unsigned* q_grp;      // [QT] byte g set: row group g of this tile may enter q's list
  float* q_fd;          // [QT] floor distance of compute slot q, -inf = none
  int* q_fp;            // [QT] floor scan position
  int* r_src;           // [RT] row of the store the tile's row r is read from, -1 = none
  float* cand_d;        // [WARPS][RT] candidate distances (lists wider than 32)
  int* cand_s;          // [WARPS][RT] their slots
  unsigned char* work;  // distance tile [RT][DQ] | ring
  __device__ explicit Smem(unsigned char* base) {
    top_d = reinterpret_cast<float*>(base);
    top_s = reinterpret_cast<int*>(top_d + KMAX * QB);
    q_row = top_s + KMAX * QB;
    q_sc = reinterpret_cast<float*>(q_row + QT);
    r_slot = reinterpret_cast<int*>(q_sc + QT);
    r_sc = reinterpret_cast<float*>(r_slot + RT);
    q_grp = reinterpret_cast<unsigned*>(r_sc + RT);
    q_fd = reinterpret_cast<float*>(q_grp + QT);
    q_fp = reinterpret_cast<int*>(q_fd + QT);
    r_src = q_fp + QT;
    cand_d = reinterpret_cast<float*>(r_src + RT);
    cand_s = reinterpret_cast<int*>(cand_d + (WARP_LISTS ? 0 : WARPS * RT));
    work = reinterpret_cast<unsigned char*>(cand_s + (WARP_LISTS ? 0 : WARPS * RT));
  }
  __device__ float* dist() const { return reinterpret_cast<float*>(work); }
  // lists are query-major: a warp reads or moves 32 entries of one list at once
  __device__ static int at(int q, int i) { return q * KMAX + i; }
  // the current k-th distance of compute slot q; -inf for a slot this
  // block does not own, so nothing of it is ever a candidate
  __device__ float kth(int k, int q) const { return q < QB ? top_d[at(q, k - 1)] : -CUDART_INF_F; }
  // row group `group` of this tile holds a candidate of compute slot q
  __device__ void mark(int q, int group) const {
    reinterpret_cast<unsigned char*>(q_grp)[q * 4 + group] = 1;
  }
  // v at scan position pos for compute slot q, or +inf where (v, pos) is
  // not above q's floor
  __device__ float above_floor(float v, int q, int pos) const {
    const float f = q_fd[q];
    return (v > f || (v == f && pos > q_fp[q])) ? v : CUDART_INF_F;
  }
};

struct Pair {
  int pair, q0, c_lo, c_hi;
  unsigned live;  // bit m: compute slots 16m .. 16m+15 (an m-tile) hold an owned query
};

// The block's pair, its query slots and empty lists.  Compute slot q
// holds query q0 + q; slots past QB (split blocks) and past qtile hold
// none.  Lists wider than 32 also find the m-tiles that hold an owned
// query (the same in every thread, so the warps can skip the others
// uniformly); where none does, the lists are left unset and the caller
// writes the fill and leaves.
template <int KMAX, bool INT8>
__device__ Pair begin_pair(const Params& p, const Smem<KMAX>& s) {
  constexpr int QB = Smem<KMAX>::QB;
  static_assert(THREADS >= QT, "one query slot a thread");
  const int splits = QB == QT ? 1 : (p.qtile + QB - 1) / QB;
  Pair b;
  b.pair = p.pair_order[blockIdx.x / splits];
  b.q0 = (blockIdx.x % splits) * QB;
  b.live = 0xffu;
  const int bucket = p.pair_bucket[b.pair];
  b.c_lo = p.ptr[bucket];
  b.c_hi = p.ptr[bucket + 1];
  bool live = false;
  for (int q = threadIdx.x; q < QT; q += THREADS) {
    const bool own = q < QB && b.q0 + q < p.qtile;
    const size_t e = (size_t)b.pair * p.qtile + b.q0 + q;
    const int qi = own ? p.qidx[e] : -1;
    live = qi >= 0;
    s.q_row[q] = qi;
    s.q_sc[q] = (INT8 && qi >= 0) ? p.qscales[qi] : 1.0f;
    s.q_grp[q] = 0;
    s.q_fd[q] = (own && p.floor_d != nullptr) ? p.floor_d[e] : -CUDART_INF_F;
    s.q_fp[q] = (own && p.floor_d != nullptr) ? p.floor_p[e] : -1;
  }
  if constexpr (!Smem<KMAX>::WARP_LISTS) {
    b.live = 0;
#pragma unroll
    for (int m = 0; m < QT / 16; ++m)
      if (__syncthreads_or(live && (int)threadIdx.x / 16 == m)) b.live |= 1u << m;
    if (b.live == 0) return b;
  }
  for (int e = threadIdx.x; e < KMAX * QB; e += THREADS) {
    s.top_d[e] = CUDART_INF_F;
    s.top_s[e] = -1;
  }
  return b;
}

// Each tile row's slot, the store row it reads (through the id grid of a
// virtual store) and its scale.
template <int KMAX>
__device__ void load_row_meta(const Params& p, const Smem<KMAX>& s, int phys, int r0, int nrows) {
  for (int r = threadIdx.x; r < RT; r += THREADS) {
    if (r < nrows) {
      const int slot = phys * p.chunk + r0 + r;
      s.r_slot[r] = slot;
      if (p.row_ids != nullptr) {
        const int id = p.row_ids[slot];
        s.r_src[r] = id - 1;
        s.r_sc[r] = id == 0 ? 0.0f : p.scales != nullptr ? p.scales[id - 1] : 1.0f;
      } else {
        s.r_src[r] = slot;
        s.r_sc[r] = p.scales[slot];
      }
    } else {
      s.r_slot[r] = -1;
      s.r_src[r] = -1;
      s.r_sc[r] = 0.0f;  // → +inf distance
    }
  }
}

template <bool INT8>
__device__ __forceinline__ float distance(float raw, float scale, float qscale) {
  float v = __fmul_rn(raw, -scale);
  if (INT8) v = __fmul_rn(v, qscale);
  return __fadd_rn(v, scale == 0.0f ? CUDART_INF_F : 1.0f);
}

// Entries of the ascending a[0, n) that are <= v, or < v.
__device__ __forceinline__ int count_le(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}
__device__ __forceinline__ int count_lt(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Lists wider than 32: each warp takes the block's queries in turn and
// merges all of a tile's candidates of one query into its sorted list at
// once.  The lanes read the marked 32-row groups of the query's column
// (a group is marked iff one of its distances is below the k-th as it
// stood before this tile), and a ballot packs the rows below that k-th
// (and above the floor) into the warp's buffer in scan order: at most
// RT, most tiles none or a few.  Each lane ranks its (up to) four by
// (distance, row) against the buffer and writes the distances back
// sorted.  Then the merge: an entry's new place is its index plus the
// candidates strictly below it (a binary search of the sorted buffer), a
// candidate's its rank plus the entries at or below it (a binary search
// of the list), so entries, which are earlier rows, win ties and the
// list stays the first k by (distance, scan position); what lands past
// k - 1 drops out.  Entries move only up, so they move in blocks of 32
// from the top down to the first candidate's place, each block read
// before it is written.
template <int KMAX>
__device__ void select_tile_merge(const Params& p, const Smem<KMAX>& s, int nrows, int pos0) {
  constexpr int QB = Smem<KMAX>::QB;
  constexpr int PER_LANE = RT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, k = p.k;
  const float* dist = s.dist();
  float* cd = s.cand_d + warp * RT;
  int* cs = s.cand_s + warp * RT;
  for (int q = warp; q < QB; q += WARPS) {
    const unsigned groups = s.q_grp[q];
    if (groups == 0) continue;
    __syncwarp();
    if (lane == 0) s.q_grp[q] = 0;
    if (s.q_row[q] < 0) continue;
    float* ld = s.top_d + s.at(q, 0);
    int* ls = s.top_s + s.at(q, 0);
    const float worst = ld[k - 1];
    int n = 0;
    for (int group = 0; group < GROUPS; ++group) {
      if (((groups >> (8 * group)) & 0xffu) == 0) continue;
      const int r = group * 32 + lane;
      float v = r < nrows ? dist[r * DQ + q] : CUDART_INF_F;
      if (p.floor_d != nullptr) v = s.above_floor(v, q, pos0 + r);
      const unsigned below = __ballot_sync(FULL, v < worst);
      if (v < worst) {
        const int at = n + __popc(below & ((1u << lane) - 1));
        cd[at] = v;
        cs[at] = s.r_slot[r];
      }
      n += __popc(below);
    }
    if (n == 0) continue;
    __syncwarp();
    float v[PER_LANE];
    int sl[PER_LANE], rank[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int j = lane + 32 * i;
      v[i] = j < n ? cd[j] : CUDART_INF_F;
      sl[i] = j < n ? cs[j] : -1;
      rank[i] = 0;
    }
    for (int j = 0; j < n; ++j) {
      const float u = cd[j];
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) rank[i] += u < v[i] || (u == v[i] && j < lane + 32 * i);
    }
    __syncwarp();  // every lane has read the buffer: it is rewritten sorted
    int place[PER_LANE], first = k;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      place[i] = k;
      if (lane + 32 * i < n) {
        cd[rank[i]] = v[i];
        place[i] = rank[i] + count_le(ld, k, v[i]);
        first = min(first, place[i]);
      }
    }
    first = __reduce_min_sync(FULL, first);
    __syncwarp();  // the buffer is sorted, and no lane reads the list any more
    for (int top = k; top > first; top -= 32) {
      const int t = top - 32 + lane;
      float u = 0.0f;
      int us = 0, to = k;
      if (t >= first) {
        u = ld[t];
        us = ls[t];
        to = t + count_lt(cd, n, u);
      }
      __syncwarp();
      if (to < k) {
        ld[to] = u;
        ls[to] = us;
      }
      __syncwarp();
    }
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      if (place[i] < k) {
        ld[place[i]] = v[i];
        ls[place[i]] = sl[i];
      }
  }
}

// Width 32: each warp takes the block's queries in turn, the list of the
// query in its lanes (lane i holds entry i).  The lanes read one marked
// 32-row group at once, a ballot finds the rows below the k-th, and the
// warp inserts them in scan order: the new row goes after every entry
// <= it (popc of a ballot) and the entries behind it move up one lane
// (shfl_up), so ties keep the earlier row first, as in the thread path.
template <int KMAX>
__device__ void select_tile_warp(const Params& p, const Smem<KMAX>& s, int nrows, int pos0) {
  constexpr int QB = Smem<KMAX>::QB;
  const int lane = threadIdx.x & 31, k = p.k;
  const float* dist = s.dist();
  for (int q = threadIdx.x >> 5; q < QB; q += THREADS / 32) {
    const unsigned groups = s.q_grp[q];
    if (groups == 0) continue;
    __syncwarp();
    if (lane == 0) s.q_grp[q] = 0;
    if (s.q_row[q] < 0) continue;
    float dl = s.top_d[s.at(q, lane)];
    int sl = s.top_s[s.at(q, lane)];
    float worst = __shfl_sync(FULL, dl, k - 1);
    bool changed = false;
    for (int group = 0; group < GROUPS; ++group) {
      if (((groups >> (8 * group)) & 0xffu) == 0) continue;
      const int r = group * 32 + lane;
      float v = r < nrows ? dist[r * DQ + q] : CUDART_INF_F;
      if (p.floor_d != nullptr) v = s.above_floor(v, q, pos0 + r);
      unsigned cand = __ballot_sync(FULL, v < worst);
      while (cand != 0) {
        const int j = __ffs(cand) - 1;
        cand &= cand - 1;
        const float vj = __shfl_sync(FULL, v, j);
        if (!(vj < worst)) continue;
        const int pos = __popc(__ballot_sync(FULL, lane < k && dl <= vj));
        const float up_d = __shfl_up_sync(FULL, dl, 1);
        const int up_s = __shfl_up_sync(FULL, sl, 1);
        if (lane > pos) {
          dl = up_d;
          sl = up_s;
        } else if (lane == pos) {
          dl = vj;
          sl = s.r_slot[group * 32 + j];
        }
        worst = __shfl_sync(FULL, dl, k - 1);
        changed = true;
      }
    }
    if (changed && lane < k) {
      s.top_d[s.at(q, lane)] = dl;
      s.top_s[s.at(q, lane)] = sl;
    }
  }
}

// pos0: the scan position in its bucket of the tile's first row
template <int KMAX>
__device__ void select_tile(const Params& p, const Smem<KMAX>& s, int nrows, int pos0) {
  if constexpr (Smem<KMAX>::WARP_LISTS) {
    select_tile_warp(p, s, nrows, pos0);
  } else {
    select_tile_merge(p, s, nrows, pos0);
  }
}

// A block none of whose query slots is live: the fill, and nothing else
template <int KMAX>
__device__ void write_fill(const Params& p, const Pair& b) {
  const int n_own = min(Smem<KMAX>::QB, p.qtile - b.q0);
  const size_t out0 = ((size_t)b.pair * p.qtile + b.q0) * p.k;
  for (int e = threadIdx.x; e < n_own * p.k; e += THREADS) {
    p.out_d[out0 + e] = CUDART_INF_F;
    p.out_s[out0 + e] = -1;
  }
}

template <int KMAX>
__device__ void write_out(const Params& p, const Smem<KMAX>& s, const Pair& b) {
  constexpr int QB = Smem<KMAX>::QB;
  __syncthreads();
  const int n_own = min(QB, p.qtile - b.q0);
  const size_t out0 = ((size_t)b.pair * p.qtile + b.q0) * p.k;
  for (int e = threadIdx.x; e < n_own * p.k; e += THREADS) {
    const int q = e / p.k, j = e % p.k;
    p.out_d[out0 + e] = s.top_d[s.at(q, j)];
    p.out_s[out0 + e] = s.top_s[s.at(q, j)];
  }
}

// ---------------------------------------------------------------------
// the bodies: mma.sync on the tensor cores, cp.async ring
// ---------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global → shared; src-size 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

template <int N>  // 4 or 8 bytes
__device__ __forceinline__ void cp_async_small(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src),
               "n"(N), "r"(ok ? N : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four int8 (bytes of v, lowest first) → two bf16x2, exact: the f32 with
// bits 0x4B0000uu is 2^23 + uu, and uu = byte ^ 0x80 = value + 128.
__device__ __forceinline__ void widen_s8x4(uint32_t v, uint32_t (&b)[2]) {
  const uint32_t x = v ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 | i)) - 8388736.0f;
  const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
  b[0] = *reinterpret_cast<const uint32_t*>(&lo);
  b[1] = *reinterpret_cast<const uint32_t*>(&hi);
}

template <typename T>
__device__ __forceinline__ uint16_t bf16_bits(T v);
template <>
__device__ __forceinline__ uint16_t bf16_bits<float>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <>
__device__ __forceinline__ uint16_t bf16_bits<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// 16 bytes of a stage row (values e .. e+N-1 of store row `row`, zero
// past d or for a dead row) staged through registers: TD is the stage's
// type (bf16 bits or int8), TS the store's
template <typename TS, typename TD>
__device__ __forceinline__ void stage_via_registers(unsigned char* dst, const TS* row, bool live,
                                                    int e, int d) {
  constexpr int N = 16 / sizeof(TD);
  union {
    uint4 v;
    TD t[N];
  } u;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const bool ok = live && e + j < d;
    if constexpr (sizeof(TD) == 2) {
      u.t[j] = ok ? bf16_bits<TS>(row[e + j]) : uint16_t(0);
    } else {
      u.t[j] = ok ? row[e + j] : TD(0);
    }
  }
  *reinterpret_cast<uint4*>(dst) = u.v;
}

// The tensor-core body of a mode over a store type at a list width.
template <int MODE, typename TS, int KMAX>
struct MmaBody {
  static constexpr bool INT8 = MODE == MODE_INT8;
  // f32 queries as three exact bf16 terms hi, mid, lo
  static constexpr bool SPLIT = MODE == MODE_F32;
  // f32 over an f32 store: the store's values split too, six products
  static constexpr bool SPLIT_X = SPLIT && std::is_same<TS, float>::value;
  static constexpr int NT = SPLIT ? 3 : 1;                                      // query terms
  static constexpr bool WIDEN = !INT8 && std::is_same<TS, int8_t>::value;      // int8 rows, bf16 queries
  static constexpr bool CONVERT = !SPLIT && std::is_same<TS, float>::value;    // f32 rows → bf16 stage
  static constexpr int STAGES = SPLIT_X ? SX_STAGES : ring_stages(NT);
  static constexpr size_t WORK = work_bytes(SPLIT_X ? kSplitXRingBytes : ring_bytes(NT, WIDEN));
  // blocks an SM: the six-term body takes one at every width, its
  // registers (~250 a thread) unbounded; at two blocks (128) it spills
  static constexpr int BLOCKS = SPLIT_X ? 1 : blocks_per_sm(KMAX);
  static_assert(!INT8 || std::is_same<TS, int8_t>::value, "int8 mode reads an int8 store");
};

// x == hi + mid + lo, each term the top 16 bits of an f32 (a bf16):
// truncation by bit masks, both subtractions exact (exact for 2^-110 <=
// |x| and 0; see the note at the top)
__device__ __forceinline__ void split3(float x, uint32_t (&term)[3]) {
  term[0] = __float_as_uint(x) & 0xffff0000u;
  const float rest = __fsub_rn(x, __uint_as_float(term[0]));
  term[1] = __float_as_uint(rest) & 0xffff0000u;
  term[2] = __float_as_uint(__fsub_rn(rest, __uint_as_float(term[1])));
}

// The three terms' B fragments of one n-tile (m16n8k16: depths (2t, 2t+1)
// and (2t+8, 2t+9) of store row g, the lower depth in the low half) from
// the lane's four f32 values of those depths
__device__ __forceinline__ void split_fragment(float4 v, uint32_t (&b)[3][4][2], int ni) {
  uint32_t x[4][3];
  split3(v.x, x[0]);
  split3(v.y, x[1]);
  split3(v.z, x[2]);
  split3(v.w, x[3]);
#pragma unroll
  for (int term = 0; term < 3; ++term) {
    b[term][ni][0] = __byte_perm(x[0][term], x[1][term], 0x7632);
    b[term][ni][1] = __byte_perm(x[2][term], x[3][term], 0x7632);
  }
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// One 16-deep step of f32 over an f32 store, a warp's 64 × 32 tile: the
// query terms hi, mid, lo at `a_addr` + term·2·KX against the store terms'
// B fragments bf[term]; six products, smallest first, into a fresh sum,
// then one rounded add into the running sum (as in mma_substep); only the
// m-tiles set in `live`.
template <int SA>
__device__ __forceinline__ void mma_six(float (&acc)[4][4][4], const uint32_t (&bf)[3][4][2],
                                        uint32_t a_addr, unsigned live) {
  // (query term, store term): lo·hi, hi·lo, mid·mid, mid·hi, hi·mid, hi·hi
  constexpr int QTERM[6] = {2, 0, 1, 1, 0, 0};
  constexpr int XTERM[6] = {0, 2, 1, 0, 1, 0};
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    if (!((live >> mi) & 1u)) continue;
    uint32_t af[3][4];
#pragma unroll
    for (int term = 0; term < 3; ++term) ldmatrix_x4(af[term], a_addr + mi * 16 * SA + term * 2 * KX);
    float t[4][4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[ni][e] = 0.0f;
#pragma unroll
    for (int prod = 0; prod < 6; ++prod)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma(t[ni], af[QTERM[prod]], bf[XTERM[prod]][ni]);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], t[ni][e]);
  }
}

// The mma of one 16-deep (bf16) or 32-deep (int8) sub-step of a warp's
// 64 × 32 tile: A at `a_addr` (+ term·KB for the terms of a split query),
// B already in registers; only the m-tiles set in `live`.
template <int NT, int SA, typename Acc>
__device__ __forceinline__ void mma_substep(Acc (&acc)[4][4][4], const uint32_t (&bf)[4][2],
                                            uint32_t a_addr, unsigned live) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    if (!((live >> mi) & 1u)) continue;
    if constexpr (NT == 1) {
      uint32_t af[4];
      ldmatrix_x4(af, a_addr + mi * 16 * SA);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], af, bf[ni]);
    } else {
      // lo, mid, hi (smallest first) into a fresh sum, then one rounded
      // add into the running sum: the tensor cores truncate the sum they
      // add into, and the running sum would take that once per term
      float t[4][4];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[ni][e] = 0.0f;
#pragma unroll
      for (int term = NT - 1; term >= 0; --term) {
        uint32_t af[4];
        ldmatrix_x4(af, a_addr + mi * 16 * SA + term * KB);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(t[ni], af, bf[ni]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], t[ni][e]);
    }
  }
}

template <int MODE, typename TS, int KMAX>
__global__ void __launch_bounds__(THREADS, (MmaBody<MODE, TS, KMAX>::BLOCKS))
    scan_mma_kernel(Params p) {
  using B = MmaBody<MODE, TS, KMAX>;
  constexpr bool INT8 = B::INT8, WIDEN = B::WIDEN, CONVERT = B::CONVERT, SPLIT_X = B::SPLIT_X;
  constexpr int NT = B::NT, STAGES = B::STAGES;
  // the stage's store type: f32 (SPLIT_X), int8 (int8 mode, WIDEN), bf16 bits otherwise
  using TD = std::conditional_t<SPLIT_X, float, std::conditional_t<INT8 || WIDEN, int8_t, uint16_t>>;
  using Acc = std::conditional_t<INT8, int, float>;
  constexpr int A_ELEM = INT8 ? 1 : 2;             // bytes per query value
  constexpr int KE = SPLIT_X ? KX : KB / A_ELEM;   // depth values per stage
  constexpr int KBB = SPLIT_X ? SX_B : b_stage_bytes(WIDEN);
  constexpr int SA = SPLIT_X ? SX_A : a_stride(NT);
  constexpr int SB = SPLIT_X ? SX_B : b_stride(WIDEN);
  constexpr int STAGE = QT * SA + RT * SB;
  constexpr int A_PIECES = NT * KE * A_ELEM / 16;  // 16-byte pieces of a query row's stage
  // store-row pieces of a stage: 16 bytes, or value pairs (SPLIT_X)
  constexpr int B_ROW_PIECES = SPLIT_X ? KX / 2 : KBB / 16;
  constexpr int B_PIECES = RT * B_ROW_PIECES / THREADS;  // store-row pieces a thread copies a stage
  static_assert(KBB == KE * int(sizeof(TD)), "a stage holds the same depths of both operands");
  static_assert(SPLIT_X || STAGE == int(stage_bytes(NT, WIDEN)), "the ring's size");

  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<KMAX> s(smem);
  const Pair b = begin_pair<KMAX, INT8>(p, s);
  if constexpr (!Smem<KMAX>::WARP_LISTS) {
    if (b.live == 0) return write_fill<KMAX>(p, b);
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wq = warp >> 2;  // queries wq*64 ..
  const int wr = warp & 3;   // rows wr*32 ..
  // the warp's m-tiles (16 queries each) that hold an owned query: the
  // others take no copy of their query rows, no ldmatrix, no mma and no
  // epilogue (a split block computes only its own QB queries)
  const unsigned wlive = Smem<KMAX>::WARP_LISTS ? 0xfu : (b.live >> (4 * wq)) & 0xfu;
  const int d = p.d, chunk = p.chunk;
  const int nsteps = (d + KE - 1) / KE;
  const size_t q_row_bytes = size_t(p.qd) * A_ELEM * NT;
  const size_t x_row_bytes = size_t(d) * sizeof(TS);
  const unsigned char* qbytes = static_cast<const unsigned char*>(p.queries);
  const unsigned char* xbytes = static_cast<const unsigned char*>(p.store);
  float* dist = s.dist();

  // The store row of each piece this thread copies, the same in every
  // stage of a tile (-1: past the chunk, or a virtual store's padding
  // slot): set once a tile, in registers, so the copies need no barrier
  // after load_row_meta and a packed store's wait on no load.
  int src[B_PIECES];

  // One stage: the NT·KE depths of each query row and the KE of each
  // store row of depth step `step`, all copies issued by all threads.
  auto load_stage = [&](int step, int buf) {
    unsigned char* a = s.work + buf * STAGE;
    unsigned char* x = a + QT * SA;
    const int e0 = step * KE;
    static_assert((QT * A_PIECES) % THREADS == 0 && (RT * B_ROW_PIECES) % THREADS == 0,
                  "whole rounds");
#pragma unroll
    for (int j = 0; j < QT * A_PIECES / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int row = i / A_PIECES, c16 = i % A_PIECES;
      if (!Smem<KMAX>::WARP_LISTS && !((b.live >> (row / 16)) & 1u)) continue;
      const int qi = s.q_row[row];
      size_t off;
      if constexpr (SPLIT_X) {
        // half `step & 1` of each term's 32-value slice: piece c16 is half
        // c16 & 1 of those 16 depths of term c16 >> 1
        off = size_t(step >> 1) * (NT * KB) + (c16 >> 1) * KB + (step & 1) * 2 * KX + (c16 & 1) * 16;
      } else {
        // = step·NT·KB, in the form that compiles shortest at NT 1
        off = size_t(e0) * A_ELEM * NT + c16 * 16;
      }
      const bool ok = qi >= 0 && off < q_row_bytes;
      cp_async16(a + row * SA + c16 * 16, qbytes + (ok ? size_t(qi) * q_row_bytes + off : 0), ok);
    }
    if constexpr (SPLIT_X) {
      // value pairs (2pr, 2pr+1): pair pr < 4 to bytes 16pr, pr >= 4 to
      // 16(pr - 4) + 8, so lane t of a quad finds the values 2t, 2t+1,
      // 2t+8, 2t+9 of its B fragment in bytes 16t .. 16t+15 of the row
#pragma unroll
      for (int j = 0; j < B_PIECES; ++j) {
        const int i = tid + j * THREADS;
        const int r = i / B_ROW_PIECES, pr = i % B_ROW_PIECES;
        const bool live = src[j] >= 0;
        const size_t slot = live ? size_t(src[j]) : 0;  // the store row read
        float* dst = reinterpret_cast<float*>(x + r * SB + (pr < 4 ? 16 * pr : 16 * pr - 56));
        const int e = e0 + 2 * pr;  // the pair's first value
        const float* row = static_cast<const float*>(p.store) + slot * d;
        if (p.copy_bytes >= 8) {  // d even: the pair lies in the row or past it
          const bool ok = live && e < d;
          cp_async_small<8>(dst, ok ? row + e : p.store, ok);
        } else if (p.copy_bytes == 4) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool ok = live && e + h < d;
            cp_async_small<4>(dst + h, ok ? row + e + h : p.store, ok);
          }
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(live && e < d ? row[e] : 0.0f,
                                                        live && e + 1 < d ? row[e + 1] : 0.0f);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < B_PIECES; ++j) {
        const int i = tid + j * THREADS;
        const int r = i / (KBB / 16), c16 = i % (KBB / 16);
        const bool live = src[j] >= 0;
        const size_t slot = live ? size_t(src[j]) : 0;  // the store row read
        unsigned char* dst = x + r * SB + c16 * 16;
        const int e = e0 + c16 * (16 / int(sizeof(TD)));  // first value of this 16-byte piece
        if (CONVERT || p.copy_bytes == 0) {
          stage_via_registers<TS, TD>(dst, static_cast<const TS*>(p.store) + slot * d, live, e, d);
        } else if (p.copy_bytes == 16) {
          const size_t off = size_t(e) * sizeof(TS);
          const bool ok = live && off < x_row_bytes;
          cp_async16(dst, xbytes + (ok ? slot * x_row_bytes + off : 0), ok);
        } else if (p.copy_bytes == 8) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const size_t off = size_t(e) * sizeof(TS) + 8 * h;
            const bool ok = live && off < x_row_bytes;
            cp_async_small<8>(dst + 8 * h, xbytes + (ok ? slot * x_row_bytes + off : 0), ok);
          }
        } else {
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const size_t off = size_t(e) * sizeof(TS) + 4 * h;
            const bool ok = live && off < x_row_bytes;
            cp_async_small<4>(dst + 4 * h, xbytes + (ok ? slot * x_row_bytes + off : 0), ok);
          }
        }
      }
    }
  };

  // ldmatrix lanes.  A (queries, row-major): matrices (rows 0-7, bytes
  // 0-15), (rows 8-15, 0-15), (rows 0-7, 16-31), (rows 8-15, 16-31) = a0..a3
  // of m16n8k16 bf16 / m16n8k32 s8.  B (store rows = n, depth contiguous =
  // the "col" operand): (n 0-7, 0-15), (n 0-7, 16-31), (n 8-15, 0-15),
  // (n 8-15, 16-31) = b0, b1 of two n-tiles.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 16;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group / column pair

  for (int c = b.c_lo; c < b.c_hi; ++c) {
    const int phys = p.chunk_of[c];
    for (int r0 = 0; r0 < chunk; r0 += RT) {
      const int nrows = min(RT, chunk - r0);
      __syncthreads();  // the previous tile's selection is done with r_slot and
                        // the distance tile, whose memory the ring reuses
      load_row_meta(p, s, phys, r0, nrows);
#pragma unroll
      for (int j = 0; j < B_PIECES; ++j) {
        const int r = (tid + j * THREADS) / B_ROW_PIECES;
        const int slot = phys * chunk + r0 + r;
        src[j] = r >= nrows ? -1 : p.row_ids != nullptr ? p.row_ids[slot] - 1 : slot;
      }
#pragma unroll
      for (int st = 0; st < STAGES - 1; ++st) {
        if (st < nsteps) load_stage(st, st);
        cp_async_commit();  // one group per step, empty or not
      }

      Acc acc[4][4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = Acc(0);

      for (int step = 0; step < nsteps; ++step) {
        cp_async_wait<STAGES - 2>();  // this thread's copies of `step` landed
        __syncthreads();              // everyone's did, and step-1's reads are done
        const int next = step + STAGES - 1;
        if (next < nsteps) load_stage(next, next % STAGES);
        cp_async_commit();

        const unsigned char* a = s.work + (step % STAGES) * STAGE;
        const uint32_t a_base = smem_u32(a) + (wq * 64 + a_row) * SA + a_col;
        const uint32_t b_base = smem_u32(a + QT * SA) + (wr * 32 + b_row) * SB + b_col;
        if (wlive == 0) continue;
        if constexpr (SPLIT_X) {
          // lane (g, t) of each n-tile: store row g's values 2t, 2t+1,
          // 2t+8, 2t+9 in one 16-byte load, split into the three terms
          const uint32_t x_lane = smem_u32(a + QT * SA) + (wr * 32 + g) * SB + t * 16;
          uint32_t bf[3][4][2];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) split_fragment(lds128(x_lane + ni * 8 * SB), bf, ni);
          mma_six<SA>(acc, bf, a_base, wlive);
        } else if constexpr (WIDEN) {
          // per 32 int8 depths of 4 n-tiles: raw[ni][sub] holds 4 values,
          // which widen to the bf16 B fragment of 16-deep sub-step `sub`
#pragma unroll
          for (int h = 0; h < KB / 64; ++h) {
            uint32_t raw[4][2];
#pragma unroll
            for (int nj = 0; nj < 2; ++nj) {
              uint32_t r[4];
              ldmatrix_x4(r, b_base + nj * 16 * SB + h * 32);
              raw[2 * nj][0] = r[0];
              raw[2 * nj][1] = r[1];
              raw[2 * nj + 1][0] = r[2];
              raw[2 * nj + 1][1] = r[3];
            }
#pragma unroll
            for (int sub = 0; sub < 2; ++sub) {
              uint32_t bf[4][2];
#pragma unroll
              for (int ni = 0; ni < 4; ++ni) widen_s8x4(raw[ni][sub], bf[ni]);
              mma_substep<NT, SA>(acc, bf, a_base + (2 * h + sub) * 32, wlive);
            }
          }
        } else {
          // 32-byte sub-steps: 16 bf16 or 32 int8 depths each
#pragma unroll
          for (int sub = 0; sub < KB / 32; ++sub) {
            uint32_t bf[4][2];
#pragma unroll
            for (int nj = 0; nj < 2; ++nj) {
              uint32_t r[4];
              ldmatrix_x4(r, b_base + nj * 16 * SB + sub * 32);
              bf[2 * nj][0] = r[0];
              bf[2 * nj][1] = r[1];
              bf[2 * nj + 1][0] = r[2];
              bf[2 * nj + 1][1] = r[3];
            }
            mma_substep<NT, SA>(acc, bf, a_base + sub * 32, wlive);
          }
        }
      }

      cp_async_wait<0>();
      __syncthreads();  // every warp is done reading the ring: the distance
                        // tile may overwrite it
      // c0, c1: row g, columns 2t, 2t+1; c2, c3: row g+8 (query = row
      // of the mma, store row = column)
      float r_scale[4][2], q_scale[4][2], worst[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) r_scale[ni][e] = s.r_sc[wr * 32 + ni * 8 + 2 * t + e];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = wq * 64 + mi * 16 + g + 8 * h;
          q_scale[mi][h] = s.q_sc[q];
          worst[mi][h] = (wlive >> mi) & 1u ? s.kth(p.k, q) : 0.0f;
        }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!((wlive >> mi) & 1u)) continue;
          const int q = wq * 64 + mi * 16 + g + 8 * h;
          bool hit = false;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = wr * 32 + ni * 8 + 2 * t + e;
              const float v = distance<INT8>(static_cast<float>(acc[mi][ni][2 * h + e]),
                                             r_scale[ni][e], q_scale[mi][h]);
              dist[r * DQ + q] = v;
              hit |= v < worst[mi][h];
            }
          if (hit) s.mark(q, wr);
        }
      __syncthreads();
      select_tile(p, s, nrows, (c - b.c_lo) * chunk + r0);
    }
  }
  write_out(p, s, b);
}

// ---------------------------------------------------------------------
// the Hopper body: bf16 queries over an int8 packed store, list width 32
// (wgmma, TMA, a producer warp a consumer warpgroup; see the note at the top)
// ---------------------------------------------------------------------
constexpr int WQ = 64;          // query slots of a block: the wgmma's N (at most)
constexpr int WR = 64;          // store rows of a tile: one consumer warpgroup's M
constexpr int WK = 64;          // int8 depths of a TMA box (four 16-deep k-steps)
constexpr int W_BOXES = 2;      // boxes of WR × WK bytes a ring stage
constexpr int W_STAGE = W_BOXES * WR * WK;   // bytes of a stage
constexpr int W_KSTEPS = W_BOXES * WK / 16;  // 16-deep k-steps a stage
constexpr int W_QD_STEP = W_BOXES * WK;      // query rows are zero-padded to a multiple
constexpr int W_STAGES = 2;     // ring stages a consumer warpgroup
constexpr int W_CONSUMERS = 2;    // consumer warpgroups, each with its own ring
constexpr int W_THREADS = (W_CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int WDQ = WR + 4;       // distance tile [query][row]: ≡ 4 (mod 32) banks
constexpr int W_KSTEP = WQ * 16 * 2;  // bytes of the resident queries a 16-deep k-step
constexpr int W_LIST = 32;        // list width
// named barriers (0 is __syncthreads): a warpgroup's own, the hand-over of
// the lists to a warpgroup, all consumers
constexpr int BAR_WG = 1, BAR_HANDOVER = BAR_WG + W_CONSUMERS,
              BAR_CONSUMERS = BAR_HANDOVER + W_CONSUMERS;
// registers a thread after setmaxnreg: the producer warpgroup gives up
// what the consumers take (multiples of 8, 64K an SM, at most 232)
constexpr int W_PRODUCER_REGS = 40;
constexpr int W_CONSUMER_REGS_FIT = (65536 / 128 - W_PRODUCER_REGS) / W_CONSUMERS / 8 * 8;
constexpr int W_CONSUMER_REGS = W_CONSUMER_REGS_FIT < 232 ? W_CONSUMER_REGS_FIT : 232;
// barriers, query metadata and marks, lists (of width `list`), the two
// distance tiles of a block of `slots` query slots and `extra` bytes after
// them, rounded up to 1024 bytes (where the ring starts)
constexpr size_t w_head_bytes(int slots, int list = W_LIST, int stages = W_STAGES,
                              size_t extra = 0) {
  return (size_t(2 * W_CONSUMERS * stages) * 8 + size_t(slots + W_CONSUMERS * slots) * 4 +
          size_t(2 * list * slots) * 4 + size_t(W_CONSUMERS * slots * WDQ) * 4 + extra + 1023) /
         1024 * 1024;
}
constexpr size_t kWRingOffset = w_head_bytes(WQ);
constexpr size_t kWRingBytes = size_t(W_CONSUMERS) * W_STAGES * W_STAGE;
// the widest resident query tile (d rounded up to W_QD_STEP) that fits
constexpr int W_MAX_QD =
    int((232448 - kWRingOffset - kWRingBytes) / (size_t(WQ) * 2 * W_QD_STEP)) * W_QD_STEP;
static_assert(W_MAX_QD >= 1024, "a 1024-wide query tile is resident");
// bf16 over an f32 store: boxes of WR rows × 32 f32 (WKF bytes, TMA's
// 128-byte swizzle), two a stage (64 depths, four k-steps), the same ring
// shape a consumer; the widest resident query tile that fits beside it
constexpr int WKF = 128;
constexpr int W_STAGE_F = W_BOXES * WR * WKF;
constexpr int W_KSTEPS_F = W_BOXES * WKF / 4 / 16;
constexpr int W_QD_STEP_F = W_BOXES * WKF / 4;
constexpr size_t kWRingBytesF = size_t(W_CONSUMERS) * W_STAGES * W_STAGE_F;
constexpr int W_MAX_QD_F =
    int((232448 - kWRingOffset - kWRingBytesF) / (size_t(WQ) * 2 * W_QD_STEP_F)) * W_QD_STEP_F;
static_assert(W_MAX_QD_F >= 768 && kWRingOffset % 1024 == 0 && W_STAGE_F % 1024 == 0,
              "a 768-wide query tile is resident; swizzled boxes start on 1024 bytes");

// f32 queries over an int8 packed store (precision="highest"): the int8
// ring, and the three bf16 terms of each query resident, so a block keeps
// 32 query slots (WQ3) and a k-step of the resident planes is hi, mid and
// lo of those slots side by side (W3_KSTEP bytes); the widest query tile
// that fits beside that block's smaller head and the ring
constexpr int WQ3 = 32;
constexpr int W3_KSTEP = 3 * WQ3 * 16 * 2;
constexpr size_t kW3RingOffset = w_head_bytes(WQ3);
constexpr int W_MAX_QD3 =
    int((232448 - kW3RingOffset - kWRingBytes) / (size_t(W3_KSTEP) / 16 * W_QD_STEP)) * W_QD_STEP;
static_assert(W_MAX_QD3 >= 768, "a 768-wide three-term query tile is resident");
// the tag of that body in the templates below (its rows are int8)
struct F32Mode {};

// bf16 queries over an int8 packed store at list widths 64 and 128 (k_scan
// 33 to 128): the int8 body's ring and resident queries, lists of width
// KMAX, W_WIDE_SLOTS query slots a block (at width 128 the block then
// takes exactly the 232,448 B at d 768; 32 slots, d up to 2176, measured
// 1.39x the time at the flagship: tools/torch_scan_probe.py); the tag of
// that body and the widest resident query tile beside its head and the ring
constexpr int W_WIDE_LIST = 128;  // the widest list of the wgmma bodies
constexpr int W_WIDE_SLOTS = 64;
template <int KMAX_>
struct WideList {
  static constexpr int KMAX = KMAX_, SLOTS = W_WIDE_SLOTS;
  static constexpr size_t HEAD = w_head_bytes(SLOTS, KMAX);
  static constexpr int MAX_QD =
      int((232448 - HEAD - kWRingBytes) / (size_t(SLOTS) * 2 * W_QD_STEP)) * W_QD_STEP;
};
static_assert(WideList<64>::MAX_QD >= 1024 && WideList<128>::MAX_QD >= 768,
              "a 1024-wide query tile is resident at width 64, a 768-wide one at width 128");
template <typename TS>
struct IsWide : std::false_type {};
template <int KMAX>
struct IsWide<WideList<KMAX>> : std::true_type {};

// f32 queries over an f32 packed store (precision="highest" over the default
// store type): the three bf16 terms of WQX query slots resident as in the
// f32 mode (WX_KSTEP bytes a k-step), and the f32 ring of boxes of WR rows ×
// 32 f32, WX_BOXES a stage: three planes of 32 slots beside the f32 ring's
// two-box stages would take 239,616 B at d 768, so 32 slots take one-box
// stages (32 KB of ring, 206,848 B at d 768); 16 slots would keep the
// two-box stages.  WX_STAGES stages a consumer.  The widest resident query
// tile that fits
constexpr int WQX = 32;
constexpr int WX_BOXES = WQX == 32 ? 1 : W_BOXES;
constexpr int WX_STAGES = 2;
constexpr int WX_KSTEP = 3 * WQX * 16 * 2;
constexpr int WX_STAGE = WX_BOXES * WR * WKF;
constexpr size_t kWXRingOffset = w_head_bytes(WQX, W_LIST, WX_STAGES);
constexpr size_t kWXRingBytes = size_t(W_CONSUMERS) * WX_STAGES * WX_STAGE;
constexpr int W_MAX_QDX =
    int((232448 - kWXRingOffset - kWXRingBytes) / (size_t(WX_KSTEP) / 16 * W_QD_STEP_F)) * W_QD_STEP_F;
static_assert(W_MAX_QDX >= 768 && kWXRingOffset % 1024 == 0 && WX_STAGE % 1024 == 0,
              "a 768-wide six-term query tile is resident; swizzled boxes start on 1024 bytes");
// the tag of that body in the templates below (its rows are f32)
struct F32X {};

// int8 queries over an int8 packed store (precision="int8"): the int8 ring
// (WS8_STAGES stages a consumer), s8 wgmma of 32 depths a k-step (WS8_KSTEPS
// a two-box stage), the block's 64 query slots resident as int8 (WS8_KSTEP
// bytes a k-step: the bf16 body's bytes, twice its depths) and each slot's
// f32 query scale in the head after the distance tiles; the widest resident
// query tile that fits
constexpr int WS8_DEPTHS = 32;
constexpr int WS8_KSTEPS = W_BOXES * WK / WS8_DEPTHS;
constexpr int WS8_KSTEP = WQ * WS8_DEPTHS;
constexpr int WS8_STAGES = 4;
constexpr size_t kWS8RingOffset = w_head_bytes(WQ, W_LIST, WS8_STAGES, size_t(WQ) * 4);
constexpr size_t kWS8RingBytes = size_t(W_CONSUMERS) * WS8_STAGES * W_STAGE;
constexpr int W_MAX_QDS8 =
    int((232448 - kWS8RingOffset - kWS8RingBytes) / (size_t(WQ) * W_QD_STEP)) * W_QD_STEP;
static_assert(W_MAX_QDS8 >= 1152, "an int8 query tile as wide as the bf16 body's is resident");
// the tag of that body in the templates below (its rows are int8)
struct S8Mode {};

// int8 queries over an int8 packed store at list widths 64 and 128 (k_scan
// 33 to 128: the int8 search(k=100) scans at 106): the int8 body's ring
// (WS8W_STAGES stages a consumer), s8 wgmma and resident int8 queries with
// their scales, and the wide-list body's W_WIDE_SLOTS query slots, lists of
// width KMAX and selection; the tag of that body, its head (the wide lists,
// then the query scales after the distance tiles), its ring and the widest
// resident query tile beside them.  At d 768 and width 128 a block takes
// 217,088 B (head 102,400, ring 65,536, queries 49,152)
constexpr int WS8W_STAGES = 4;
template <int KMAX_>
struct S8WideList {
  static constexpr int KMAX = KMAX_, SLOTS = W_WIDE_SLOTS;
  static constexpr size_t HEAD = w_head_bytes(SLOTS, KMAX, WS8W_STAGES, size_t(SLOTS) * 4);
  static constexpr size_t RING = size_t(W_CONSUMERS) * WS8W_STAGES * W_STAGE;
  static constexpr int MAX_QD =
      int((232448 - HEAD - RING) / (size_t(SLOTS) * W_QD_STEP)) * W_QD_STEP;
};
static_assert(S8WideList<64>::MAX_QD >= 1408 && S8WideList<128>::MAX_QD >= 896,
              "an int8 query tile of 1408 is resident at width 64, of 896 at width 128");
template <typename TS>
struct IsS8Wide : std::false_type {};
template <int KMAX>
struct IsS8Wide<S8WideList<KMAX>> : std::true_type {};
// the int8 bodies: int8 query rows, each with its f32 scale in the head
template <typename TS>
struct IsS8 : IsS8Wide<TS> {};
template <>
struct IsS8<S8Mode> : std::true_type {};

// f32 queries over an int8 packed store at list widths 64 and 128 (k_scan
// 33 to 128: precision="highest" at search(k=100) scans at 106): the
// f32-mode body's block (the int8 ring, WQ3 query slots with the three
// terms resident as planes of one B tile) with lists of width KMAX in its
// head.  Three planes of 64 slots would take 294,912 B at d 768, so the
// block keeps 32.  At width 128 and d 768 it takes 231,424 of its 232,448
// B (head 51,200, ring 32,768, planes 147,456): the widest resident tile is
// 768, and the ring keeps its two stages (at width 64, head 34,816, a
// third stage would fit at d 768; it measured 1.03x the time with
// tools/torch_scan_probe.py).  The tag of that body and the widest
// resident query tile beside its head and the ring
template <int KMAX_>
struct F32ModeWideList {
  static constexpr int KMAX = KMAX_;
  static constexpr size_t HEAD = w_head_bytes(WQ3, KMAX);
  static constexpr int MAX_QD =
      int((232448 - HEAD - kWRingBytes) / (size_t(W3_KSTEP) / 16 * W_QD_STEP)) * W_QD_STEP;
};
static_assert(F32ModeWideList<64>::MAX_QD >= 768 && F32ModeWideList<128>::MAX_QD >= 768,
              "a 768-wide three-term query tile is resident at list widths 64 and 128");
template <typename TS>
struct IsF32ModeWide : std::false_type {};
template <int KMAX>
struct IsF32ModeWide<F32ModeWideList<KMAX>> : std::true_type {};

// bf16 queries over an f32 packed store at list widths 64 and 128 (k_scan
// 33 to 128: the default search(k=100) over BuildConfiguration(dtype=
// "float32") scans at 106): the f32 body's ring (boxes of WR rows × 32 f32
// under the 128-byte swizzle) and the wide-list body's W_WIDE_SLOTS query
// slots, lists of width KMAX in the head.  Its stages hold two boxes where
// those fit beside a 768-wide resident tile, else one (BOXES): at d 768
// and width 64 the block takes exactly its 232,448 B with two-box stages
// (head 68,608, ring 65,536, queries 98,304); at width 128 the head takes
// 101,376 B, two-box stages would make 265,216 B, and one-box stages
// (ring 32,768) again make exactly 232,448 (fewer slots a block would leave
// room for two-box stages at width 128, but 48 and 32 measured 1.05x and
// 1.02x the time: tools/torch_scan_probe.py).  The tag of that body, its
// ring and the widest resident query tile beside them
template <int KMAX_>
struct F32WideList {
  static constexpr int KMAX = KMAX_, SLOTS = W_WIDE_SLOTS;
  static constexpr size_t HEAD = w_head_bytes(SLOTS, KMAX);
  static constexpr int BOXES =
      HEAD + kWRingBytesF + size_t(SLOTS) * 2 * 768 <= 232448 ? W_BOXES : 1;
  static constexpr int STAGE = BOXES * WR * WKF;
  static constexpr size_t RING = size_t(W_CONSUMERS) * W_STAGES * STAGE;
  static constexpr int MAX_QD =
      int((232448 - HEAD - RING) / (size_t(SLOTS) * 2 * W_QD_STEP_F)) * W_QD_STEP_F;
};
static_assert(F32WideList<64>::MAX_QD >= 768 && F32WideList<128>::MAX_QD >= 768 &&
                  F32WideList<64>::HEAD % 1024 == 0 && F32WideList<128>::HEAD % 1024 == 0,
              "a 768-wide query tile is resident at list widths 64 and 128 over f32 rows; "
              "swizzled boxes start on 1024 bytes");
template <typename TS>
struct IsF32Wide : std::false_type {};
template <int KMAX>
struct IsF32Wide<F32WideList<KMAX>> : std::true_type {};

// The ring of the store type TS: int8 rows (WK bytes a box row, 64 depths)
// or f32 rows (WKF bytes, 32 depths), BOXES boxes a stage, STAGES stages a
// consumer; and the block around it: its query slots, where its ring starts
// (after the head), the query terms it keeps resident, the depths of a
// k-step and the resident queries' bytes a k-step
template <typename TS>
struct WRing;
template <>
struct WRing<int8_t> {
  using Row = int8_t;
  static constexpr int ROW = WK, DEPTHS = WK, BOXES = W_BOXES, STAGES = W_STAGES, STAGE = W_STAGE,
                       KSTEPS = W_KSTEPS, QD_STEP = W_QD_STEP, MAX_QD = W_MAX_QD, SLOTS = WQ,
                       TERMS = 1, K_DEPTHS = 16, Q_KSTEP = W_KSTEP, LIST = W_LIST;
  static constexpr size_t BYTES = kWRingBytes, HEAD = kWRingOffset;
};
template <>
struct WRing<float> {
  using Row = float;
  static constexpr int ROW = WKF, DEPTHS = WKF / 4, BOXES = W_BOXES, STAGES = W_STAGES,
                       STAGE = W_STAGE_F, KSTEPS = W_KSTEPS_F, QD_STEP = W_QD_STEP_F,
                       MAX_QD = W_MAX_QD_F, SLOTS = WQ, TERMS = 1, K_DEPTHS = 16, Q_KSTEP = W_KSTEP,
                       LIST = W_LIST;
  static constexpr size_t BYTES = kWRingBytesF, HEAD = kWRingOffset;
};
template <>
struct WRing<F32Mode> : WRing<int8_t> {
  static constexpr int MAX_QD = W_MAX_QD3, SLOTS = WQ3, TERMS = 3, Q_KSTEP = W3_KSTEP;
  static constexpr size_t HEAD = kW3RingOffset;
};
template <int KMAX>
struct WRing<WideList<KMAX>> : WRing<int8_t> {
  static constexpr int MAX_QD = WideList<KMAX>::MAX_QD, SLOTS = W_WIDE_SLOTS, LIST = KMAX,
                       Q_KSTEP = W_WIDE_SLOTS * 16 * 2;
  static constexpr size_t HEAD = WideList<KMAX>::HEAD;
};
template <>
struct WRing<F32X> : WRing<float> {
  static constexpr int BOXES = WX_BOXES, STAGES = WX_STAGES, STAGE = WX_STAGE,
                       KSTEPS = WX_BOXES * WKF / 4 / 16, MAX_QD = W_MAX_QDX, SLOTS = WQX, TERMS = 3,
                       Q_KSTEP = WX_KSTEP;
  static constexpr size_t BYTES = kWXRingBytes, HEAD = kWXRingOffset;
};
template <>
struct WRing<S8Mode> : WRing<int8_t> {
  static constexpr int STAGES = WS8_STAGES, KSTEPS = WS8_KSTEPS, MAX_QD = W_MAX_QDS8,
                       K_DEPTHS = WS8_DEPTHS, Q_KSTEP = WS8_KSTEP;
  static constexpr size_t BYTES = kWS8RingBytes, HEAD = kWS8RingOffset;
};
template <int KMAX>
struct WRing<S8WideList<KMAX>> : WRing<int8_t> {
  static constexpr int STAGES = WS8W_STAGES, KSTEPS = WS8_KSTEPS, MAX_QD = S8WideList<KMAX>::MAX_QD,
                       SLOTS = W_WIDE_SLOTS, K_DEPTHS = WS8_DEPTHS,
                       Q_KSTEP = W_WIDE_SLOTS * WS8_DEPTHS, LIST = KMAX;
  static constexpr size_t BYTES = S8WideList<KMAX>::RING, HEAD = S8WideList<KMAX>::HEAD;
};
template <int KMAX>
struct WRing<F32ModeWideList<KMAX>> : WRing<int8_t> {
  static constexpr int MAX_QD = F32ModeWideList<KMAX>::MAX_QD, SLOTS = WQ3, TERMS = 3,
                       Q_KSTEP = W3_KSTEP, LIST = KMAX;
  static constexpr size_t HEAD = F32ModeWideList<KMAX>::HEAD;
};
template <int KMAX>
struct WRing<F32WideList<KMAX>> : WRing<float> {
  using L = F32WideList<KMAX>;
  static constexpr int BOXES = L::BOXES, STAGE = L::STAGE, KSTEPS = L::BOXES * WKF / 4 / 16,
                       MAX_QD = L::MAX_QD, SLOTS = L::SLOTS, Q_KSTEP = L::SLOTS * 16 * 2,
                       LIST = KMAX;
  static constexpr size_t BYTES = L::RING, HEAD = L::HEAD;
};

// A virtual store over an int8 + row-scale corpus (the row map) at list
// width 32: the int8 ring of the packed bodies (boxes of WR rows × WK
// bytes, no swizzle), filled by producer warps that gather each slot's row
// through the id grid (wgmma_gather), RM_STAGES stages a consumer for bf16
// queries (RowMap<int8_t>: scan_wgmma_kernel's block) and RM3_STAGES for f32
// queries (RowMap<F32Mode>: scan_wgmma_f32mode_kernel's block, whose three
// resident planes leave room for three stages at d 768, not four).  The
// tags of those bodies, their heads and rings and the widest resident query
// tile beside them
constexpr int RM_STAGES = 4, RM3_STAGES = 3;
template <typename TS>
struct RowMap {};
template <>
struct WRing<RowMap<int8_t>> : WRing<int8_t> {
  static constexpr int STAGES = RM_STAGES;
  static constexpr size_t HEAD = w_head_bytes(WQ, W_LIST, RM_STAGES),
                          BYTES = size_t(W_CONSUMERS) * RM_STAGES * W_STAGE;
  static constexpr int MAX_QD =
      int((232448 - HEAD - BYTES) / (size_t(WQ) * 2 * W_QD_STEP)) * W_QD_STEP;
};
template <>
struct WRing<RowMap<F32Mode>> : WRing<F32Mode> {
  static constexpr int STAGES = RM3_STAGES;
  static constexpr size_t HEAD = w_head_bytes(WQ3, W_LIST, RM3_STAGES),
                          BYTES = size_t(W_CONSUMERS) * RM3_STAGES * W_STAGE;
  static constexpr int MAX_QD =
      int((232448 - HEAD - BYTES) / (size_t(W3_KSTEP) / 16 * W_QD_STEP)) * W_QD_STEP;
};
static_assert(WRing<RowMap<int8_t>>::MAX_QD >= 768 && WRing<RowMap<F32Mode>>::MAX_QD >= 768,
              "a 768-wide query tile (three planes of one in f32 mode) is resident over a row map");

// dynamic shared memory at query width qd
template <typename TS>
__host__ __device__ inline size_t wgmma_smem_bytes(int qd) {
  return WRing<TS>::HEAD + WRing<TS>::BYTES +
         size_t(WRing<TS>::Q_KSTEP) * (qd / WRing<TS>::K_DEPTHS);
}

template <typename TS>
struct WSmem {
  static constexpr int SLOTS = WRing<TS>::SLOTS, LIST = WRing<TS>::LIST, STAGES = WRing<TS>::STAGES;
  uint64_t* full;    // [W_CONSUMERS][STAGES] the producer's TMA landed
  uint64_t* empty;   // [W_CONSUMERS][STAGES] the warpgroup's four warps read it
  int* q_row;        // [SLOTS] query row of slot q, -1 = none
  unsigned* q_grp;   // [W_CONSUMERS][SLOTS] byte g: 32-row group g of the tile may enter q's list
  float* top_d;      // [SLOTS][LIST]
  int* top_s;        // [SLOTS][LIST]
  float* dist;       // [W_CONSUMERS][SLOTS][WDQ]
  unsigned char* ring;     // [W_CONSUMERS][STAGES][BOXES][WR][ROW] rows, as TMA writes them
  unsigned char* queries;  // resident bf16 queries, qd / 16 k-steps of Q_KSTEP bytes
  __device__ explicit WSmem(unsigned char* base) {
    full = reinterpret_cast<uint64_t*>(base);
    empty = full + W_CONSUMERS * STAGES;
    q_row = reinterpret_cast<int*>(empty + W_CONSUMERS * STAGES);
    q_grp = reinterpret_cast<unsigned*>(q_row + SLOTS);
    top_d = reinterpret_cast<float*>(q_grp + W_CONSUMERS * SLOTS);
    top_s = reinterpret_cast<int*>(top_d + LIST * SLOTS);
    dist = reinterpret_cast<float*>(top_s + LIST * SLOTS);
    ring = base + WRing<TS>::HEAD;
    queries = ring + WRing<TS>::BYTES;
  }
  __device__ unsigned char* stage(int wg, int slot) const {
    return ring + (wg * STAGES + slot) * WRing<TS>::STAGE;
  }
};

// an int8 body's query scales: [SLOTS] f32 in its head, after the distance tiles
template <typename TS>
__device__ __forceinline__ float* s8_qscales(const WSmem<TS>& s) {
  return s.dist + W_CONSUMERS * WSmem<TS>::SLOTS * WDQ;
}

struct WItem {
  int pair, q0, c_lo, c_hi;
  int nl;  // m-tiles (16 query slots) the block computes: up to its last live one
};

// A walk over an item's 64-row tiles, chunk by chunk (no division)
struct TileWalk {
  int c, t;  // the chunk's place in the CSR, the tile within the chunk
  __device__ void advance(int n, int per_chunk) {
    for (t += n; t >= per_chunk; t -= per_chunk) ++c;
  }
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
// wait for the phase of `parity` to complete; a phase that never does (a
// lost copy) traps, so the launch fails instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// a 64-depth × 64-row box of the store (x: depth, y: slot) into `dst`
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map, int x, int y,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// lo and hi rounded to the nearest even bf16 (as __float2bfloat16_rn), lo
// in the low half
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ uint4 lds128u(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_u32(p)));
  return v;
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // until at most N committed groups are in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep registers that an in-flight wgmma reads or writes where they are
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int J>
__device__ __forceinline__ void hold(uint32_t (&r)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[j][i])::"memory");
}

// The B operand's descriptor: the resident queries of one k-step, K-major
// without swizzle, core matrices of 8 queries × 8 depths (128 contiguous
// bytes); the two 8-deep halves of the k-step 128 bytes apart (leading
// byte offset), the eight 8-query groups 256 bytes apart (stride byte offset)
__device__ __forceinline__ uint64_t query_desc(uint32_t addr) {
  return uint64_t((addr & 0x3ffff) >> 4) | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
}
// byte offset of query slot n's 8 depths (k' 8h .. 8h+7) of k-step j, the
// k-steps KSTEP bytes apart (a block's query slots × 32)
template <int KSTEP = W_KSTEP>
__device__ __forceinline__ int query_at(int j, int h, int n) {
  return j * KSTEP + (n >> 3) * 256 + h * 128 + (n & 7) * 16;
}

// D (64 rows × N query slots, f32) += A (64 rows × 16 depths, bf16, in
// registers) · B (16 depths × N slots, bf16, at desc)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
}

// The three query terms' products at once (B: the planes hi, mid, lo side
// by side, N = 3 × the block's slots up to its last live m-tile): D = A·B,
// or D += A·B where `add` is set
template <int N>
__device__ __forceinline__ void wgmma_rs_terms(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc,
                                               int add) {
  if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add));
  }
  if constexpr (N == 96) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add));
  }
}

// One stage's three-term sums into the running sum, rounded: for each value
// lo + mid (the smallest first), + hi, then one round-to-nearest add into
// acc (the tensor cores truncate the sum they add into, so the running sum
// is never theirs).  fresh: the stage's sums, hi, mid, lo in thirds, each
// in the accumulator order of acc
template <int M>
__device__ __forceinline__ void fold_terms(float (&acc)[M], float (&fresh)[3 * M]) {
  hold(fresh);
#pragma unroll
  for (int i = 0; i < M; ++i)
    acc[i] = __fadd_rn(acc[i], __fadd_rn(__fadd_rn(fresh[2 * M + i], fresh[M + i]), fresh[i]));
}

// The block's item, its query slots, empty lists, the ring's
// barriers and the resident query tile.  Slot q holds query q0 + q; slots
// past qtile hold none.  nl = 0: no slot is live, the block writes the fill.
template <typename TS>
__device__ WItem wgmma_begin(const Params& p, const WSmem<TS>& s) {
  constexpr int SLOTS = WSmem<TS>::SLOTS;
  const int tid = threadIdx.x;
  const int splits = (p.qtile + SLOTS - 1) / SLOTS;
  WItem b;
  b.pair = p.pair_order[blockIdx.x / splits];
  b.q0 = (blockIdx.x % splits) * SLOTS;
  const int bucket = p.pair_bucket[b.pair];
  b.c_lo = p.ptr[bucket];
  b.c_hi = p.ptr[bucket + 1];
  bool live = false;
  if (tid < SLOTS) {
    const bool own = b.q0 + tid < p.qtile;
    const size_t e = (size_t)b.pair * p.qtile + b.q0 + tid;
    const int qi = own ? p.qidx[e] : -1;
    live = qi >= 0;
    s.q_row[tid] = qi;
    if constexpr (IsS8<TS>::value) s8_qscales(s)[tid] = live ? p.qscales[qi] : 1.0f;
  }
  if (tid < W_CONSUMERS * SLOTS) s.q_grp[tid] = 0;
  for (int e = tid; e < WSmem<TS>::LIST * SLOTS; e += W_THREADS) {
    s.top_d[e] = CUDART_INF_F;
    s.top_s[e] = -1;
  }
  if (tid == 0) {
    for (int i = 0; i < W_CONSUMERS * WSmem<TS>::STAGES; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], 4);  // a consumer warpgroup's four warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  b.nl = 0;
#pragma unroll
  for (int m = 0; m < SLOTS / 16; ++m)
    if (__syncthreads_or(live && tid / 16 == m)) b.nl = m + 1;
  if (b.nl == 0) return b;
  // the live m-tiles' query rows, 16 bytes a piece, into the canonical
  // layout (a padding query's rows zero); 8 neighbouring threads write
  // one core matrix
  if constexpr (IsS8<TS>::value) {
    // int8 rows of qd bytes: two pieces a 32-deep k-step
    const int pieces = b.nl * 16 * (p.qd / 16);
    const unsigned char* qbytes = static_cast<const unsigned char*>(p.queries);
    for (int i = tid; i < pieces; i += W_THREADS) {
      const int n = i % (b.nl * 16), piece = i / (b.nl * 16);
      const int qi = s.q_row[n];
      const size_t off = size_t(qi >= 0 ? qi : 0) * p.qd + piece * 16;
      cp_async16(s.queries + query_at<WRing<TS>::Q_KSTEP>(piece >> 1, piece & 1, n), qbytes + off,
                 qi >= 0);
    }
  } else if constexpr (WRing<TS>::TERMS == 1) {
    const int pieces = b.nl * 16 * (p.qd / 8);
    const unsigned char* qbytes = static_cast<const unsigned char*>(p.queries);
    for (int i = tid; i < pieces; i += W_THREADS) {
      const int n = i % (b.nl * 16), piece = i / (b.nl * 16);
      const int qi = s.q_row[n];
      const size_t off = size_t(qi >= 0 ? qi : 0) * p.qd * 2 + piece * 16;
      cp_async16(s.queries + query_at<WRing<TS>::Q_KSTEP>(piece >> 1, piece & 1, n), qbytes + off,
                 qi >= 0);
    }
  } else {
    // three terms: a query row is the planes hi, mid, lo (qd values each);
    // plane `term` of slot n is column term·cols + n of every k-step, so
    // the wgmma of the live m-tiles reads the three planes as one B tile
    const int cols = b.nl * 16, per_term = cols * (p.qd / 8);
    const unsigned char* qbytes = static_cast<const unsigned char*>(p.queries);
    for (int i = tid; i < WRing<TS>::TERMS * per_term; i += W_THREADS) {
      const int term = i / per_term, n = i % cols, piece = i % per_term / cols;
      const int qi = s.q_row[n];
      const size_t off = (size_t(qi >= 0 ? qi : 0) * WRing<TS>::TERMS + term) * p.qd * 2 + piece * 16;
      const int c = term * cols + n;
      cp_async16(s.queries + (piece >> 1) * WRing<TS>::Q_KSTEP + (c >> 3) * 256 + (piece & 1) * 128 +
                     (c & 7) * 16,
                 qbytes + off, qi >= 0);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wgmma reads them
  __syncthreads();
  return b;
}

// The producer (one thread): every 64-row tile of the item that consumer
// warpgroup `wg` takes (tiles wg, wg + 2, ...), each as qd / (the depths of
// a stage) stages through the warpgroup's ring, running ahead across tiles
// and chunks.
// A box may reach past the chunk's last row (the consumers mask those
// rows) or past the store (TMA writes zeros).
template <typename TS>
__device__ void wgmma_produce(const CUtensorMap* map, const Params& p, const WSmem<TS>& s,
                              const WItem& b, int wg) {
  using R = WRing<TS>;
  const int per_chunk = (p.chunk + WR - 1) / WR, nst = p.qd / (R::BOXES * R::DEPTHS);
  TileWalk w{b.c_lo, 0};
  w.advance(wg, per_chunk);
  int phys = w.c < b.c_hi ? p.chunk_of[w.c] : 0;
  int cnt = 0;
  while (w.c < b.c_hi) {
    const int row = phys * p.chunk + w.t * WR;
    TileWalk next = w;  // the chunk of this ring's next tile, read while this one's stages go out
    next.advance(W_CONSUMERS, per_chunk);
    const int next_phys = next.c < b.c_hi ? p.chunk_of[next.c] : 0;
    for (int st = 0; st < nst; ++st, ++cnt) {
      const int slot = cnt % R::STAGES;
      uint64_t* full = &s.full[wg * R::STAGES + slot];
      mbar_wait(&s.empty[wg * R::STAGES + slot], ((cnt / R::STAGES) & 1) ^ 1);
      mbar_expect_tx(full, R::STAGE);
#pragma unroll
      for (int box = 0; box < R::BOXES; ++box)
        tma_load_rows(s.stage(wg, slot) + box * WR * R::ROW, map, (st * R::BOXES + box) * R::DEPTHS,
                      row, full);
    }
    w = next;
    phys = next_phys;
  }
}

// Width-32 selection of a consumer warpgroup's tile: select_tile_warp's
// rule over the tile's [query][row] distances, four warps, the slots the
// block computes (nq): the list in a warp's lanes, a marked 32-row group's
// candidates by ballot, each entering in scan order after every entry <= it.
// Its own copy of that rule (other tile and list layouts), so that the
// mma.sync instances keep their code.  Over f32 rows (and in f32 mode) a
// warp finds its marked queries (most tiles after a bucket's first have
// few) with one load a lane and a ballot, not one load a query in turn
// (measured on the f32 body only; the int8 body keeps its loop and its code).
template <typename TS>
__device__ void wgmma_select(const Params& p, const WSmem<TS>& s, int wg, int nq, int nrows,
                             int slot0) {
  const int lane = threadIdx.x & 31, k = p.k;
  const float* dist = s.dist + wg * WSmem<TS>::SLOTS * WDQ;
  unsigned* grp = s.q_grp + wg * WSmem<TS>::SLOTS;
  // query q's marked 32-row groups (byte g of `groups` for group g)
  auto select_query = [&](int q, unsigned groups) {
    __syncwarp();
    if (lane == 0) grp[q] = 0;
    if (s.q_row[q] < 0) return;
    float dl = s.top_d[q * W_LIST + lane];
    int sl = s.top_s[q * W_LIST + lane];
    float worst = __shfl_sync(FULL, dl, k - 1);
    bool changed = false;
    for (int group = 0; group < WR / 32; ++group) {
      if (((groups >> (8 * group)) & 0xffu) == 0) continue;
      const int r = group * 32 + lane;
      const float v = r < nrows ? dist[q * WDQ + r] : CUDART_INF_F;
      unsigned cand = __ballot_sync(FULL, v < worst);
      while (cand != 0) {
        const int j = __ffs(cand) - 1;
        cand &= cand - 1;
        const float vj = __shfl_sync(FULL, v, j);
        if (!(vj < worst)) continue;
        // the shuffles do not wait for the ballot: the new k-th is the old
        // (k-1)-th unless the row lands last (k == 1: it always does)
        const float up_d = __shfl_up_sync(FULL, dl, 1);
        const int up_s = __shfl_up_sync(FULL, sl, 1);
        const float below = __shfl_sync(FULL, dl, k - 2);
        const int pos = __popc(__ballot_sync(FULL, lane < k && dl <= vj));
        if (lane > pos) {
          dl = up_d;
          sl = up_s;
        } else if (lane == pos) {
          dl = vj;
          sl = slot0 + group * 32 + j;
        }
        worst = pos < k - 1 ? below : vj;
        changed = true;
      }
    }
    if (changed && lane < k) {
      s.top_d[q * W_LIST + lane] = dl;
      s.top_s[q * W_LIST + lane] = sl;
    }
  };
  const int q0 = (threadIdx.x >> 5) & 3;
  if constexpr (!std::is_same<TS, int8_t>::value) {
    const int q = q0 + 4 * lane;  // lane i holds the warp's i-th query (nq <= 4 · 32)
    const unsigned mine = q < nq ? grp[q] : 0u;
    for (unsigned todo = __ballot_sync(FULL, mine != 0); todo != 0; todo &= todo - 1) {
      const int i = __ffs(todo) - 1;
      select_query(q0 + 4 * i, __shfl_sync(FULL, mine, i));
    }
  } else {
    for (int q = q0; q < nq; q += 4) {
      const unsigned groups = grp[q];
      if (groups == 0) continue;
      select_query(q, groups);
    }
  }
}

// A consumer warpgroup: its tiles (wg, wg + 2, ...) of the item.  Per tile,
// the wgmma over qd / 16 k-steps (A: the tile's rows widened from the ring
// into registers, one stage ahead of the tensor cores; B: the resident
// queries), then the epilogue (distances, marks) and, once the other
// warpgroup has selected the tile before, the selection, while the other
// warpgroup's wgmma runs.  N = 16·NL query slots.
template <typename TS, int NL>
__device__ void wgmma_consume(const Params& p, const WSmem<TS>& s, const WItem& b, int wg) {
  constexpr int N = 16 * NL, KSTEPS = WRing<TS>::KSTEPS;
  const int tid = threadIdx.x & 127, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int per_chunk = (p.chunk + WR - 1) / WR, nst = p.qd / WRing<TS>::QD_STEP;
  const int ntiles = (b.c_hi - b.c_lo) * per_chunk;
  const uint32_t q_base = smem_u32(s.queries);
  TileWalk w{b.c_lo, 0};
  w.advance(wg, per_chunk);
  int phys = w.c < b.c_hi ? p.chunk_of[w.c] : 0;
  float* dist = s.dist + wg * WQ * WDQ;
  int cnt = 0;  // stages this warpgroup has taken from its ring
  unsigned live = 0;  // bit 2n + e: the lane's query slot 8n + 2t + e holds a query
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) live |= unsigned(s.q_row[8 * n + 2 * t + e] >= 0) << (2 * n + e);

  // int8 rows: the A fragments of a stage's k-steps, four a box: lane
  // (g, t) reads bytes 16t .. 16t+15 of rows g and g+8 of its warp's 16 in
  // each box; word j widens to the depths the registers of the box's
  // k-step j hold (WGMMA_ORDER in ops/scan_kernel.py).  f32 rows: two
  // k-steps a box; in k-step j lane (g, t) reads the 16-byte chunk 2t + j
  // (depths 8t + 4j .. 8t + 4j + 3) of rows g and g+8, at chunk (2t + j) ^
  // g of the row as TMA's 128-byte swizzle places it (the rows of a box
  // are 128 bytes, the box on 1024), so the eight lanes of a
  // quarter-warp read eight distinct chunks: all 32 banks.  Each pair of
  // values rounds to nearest even into one A register
  // (WGMMA_F32_ORDER in ops/scan_kernel.py)
  int f32_off[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) f32_off[j] = (warp * 16 + g) * WKF + (((2 * t + j) ^ g) << 4);
  auto take_stage = [&](uint32_t(&a)[KSTEPS][4]) {
    const int slot = cnt % W_STAGES;
    mbar_wait(&s.full[wg * W_STAGES + slot], (cnt / W_STAGES) & 1);
    if constexpr (std::is_same<TS, float>::value) {
#pragma unroll
      for (int box = 0; box < W_BOXES; ++box) {
        const uint32_t x = smem_u32(s.stage(wg, slot) + box * WR * WKF);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 lo = lds128(x + f32_off[j]), hi = lds128(x + f32_off[j] + 8 * WKF);
          a[2 * box + j][0] = bf16x2_rn(lo.x, lo.y);
          a[2 * box + j][1] = bf16x2_rn(hi.x, hi.y);
          a[2 * box + j][2] = bf16x2_rn(lo.z, lo.w);
          a[2 * box + j][3] = bf16x2_rn(hi.z, hi.w);
        }
      }
    } else {
#pragma unroll
      for (int box = 0; box < W_BOXES; ++box) {
        const unsigned char* x = s.stage(wg, slot) + box * WR * WK + (warp * 16 + g) * WK + t * 16;
        const uint4 lo = lds128u(x), hi = lds128u(x + 8 * WK);
        const uint32_t wl[4] = {lo.x, lo.y, lo.z, lo.w}, wh[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bl[2], bh[2];
          widen_s8x4(wl[j], bl);
          widen_s8x4(wh[j], bh);
          a[4 * box + j][0] = bl[0];
          a[4 * box + j][1] = bh[0];
          a[4 * box + j][2] = bl[1];
          a[4 * box + j][3] = bh[1];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[wg * W_STAGES + slot]);
    ++cnt;
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
    float acc[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0.0f;
    // stage st's wgmma reads a[st % 2]; stage st + 1's is queued behind it
    // before the warpgroup waits for stage st - 1 and widens stage st + 1
    // into the registers stage st - 1 read
    uint32_t a[2][KSTEPS][4];
    auto issue = [&](auto buf, int st) {
      constexpr int B = decltype(buf)::value;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KSTEPS; ++j)
        wgmma_rs<N>(acc, a[B][j], query_desc(q_base + (KSTEPS * st + j) * W_KSTEP));
      wgmma_commit();
    };
    auto step = [&](auto buf, int st) {  // st >= 1
      constexpr int B = decltype(buf)::value;
      issue(buf, st);
      wgmma_wait<1>();  // stage st - 1 is done with a[B ^ 1]
      hold(a[B ^ 1]);
      if (st + 1 < nst) take_stage(a[B ^ 1]);
    };
    take_stage(a[0]);
    issue(std::integral_constant<int, 0>{}, 0);
    if (nst > 1) take_stage(a[1]);
    for (int st = 1; st < nst; st += 2) {
      step(std::integral_constant<int, 1>{}, st);
      if (st + 1 < nst) step(std::integral_constant<int, 0>{}, st + 1);
    }
    wgmma_wait<0>();
    hold(a[0]);
    hold(a[1]);
    hold(acc);

    // epilogue: acc[4n + 2h + e] is row 16·warp + g + 8h, query slot 8n + 2t + e.
    // The other warpgroup may still be selecting the tile before: a k-th
    // read now is no smaller than the one that selection leaves, so the
    // marks cover every row that can enter (wgmma_select tests each
    // against the list again)
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * n + 2 * t + e;
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[h] = distance<false>(acc[4 * n + 2 * h + e], r_scale[h], 1.0f);
          dist[q * WDQ + warp * 16 + g + 8 * h] = v[h];
        }
        if (((live >> (2 * n + e)) & 1u) &&
            fminf(v[0], v[1]) < *static_cast<volatile const float*>(&s.top_d[q * W_LIST + p.k - 1]))
          reinterpret_cast<unsigned char*>(s.q_grp + wg * WQ)[q * 4 + (warp >> 1)] = 1;
      }
    bar_sync(BAR_WG + wg, 128);
    if (i > 0) bar_sync(BAR_HANDOVER + wg, 256);  // the tile before is selected (by the warpgroup before)
    wgmma_select(p, s, wg, N, nrows, slot0);
    bar_sync(BAR_WG + wg, 128);  // the distance tile is free again
    if (i + 1 < ntiles) bar_arrive(BAR_HANDOVER + (wg + 1) % W_CONSUMERS, 256);
  }
}

// The f32-mode consumer warpgroup (F32Mode): wgmma_consume's walk over its
// tiles, int8 ring, epilogue, hand-over and selection, spelled out so that
// the two bodies above keep their code, with the three query terms'
// planes as one B tile of 3N columns: one wgmma a k-step, into a fresh sum
// for the stage (its first k-step does not add); once the warpgroup has
// waited for the stage, its sums are folded into the running sum
// (fold_terms).  The rows are widened a box (four k-steps) ahead of the
// tensor cores, into two sets of A registers in turns, not a stage: with
// two stages' A registers, or two fresh sums in turns, a thread needs more
// than the 168 registers a 384-thread block allows, and spills (spilled
// accumulators also serialize the wgmma).  N = 16·NL query slots.
template <int NL>
__device__ void wgmma_consume_terms(const Params& p, const WSmem<F32Mode>& s, const WItem& b,
                                    int wg) {
  constexpr int N = 16 * NL, KSTEPS = WK / 16;  // k-steps a box
  static_assert(W_BOXES == 2, "a stage's two boxes take the two sets of A registers in turns");
  const int tid = threadIdx.x & 127, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int per_chunk = (p.chunk + WR - 1) / WR, nst = p.qd / W_QD_STEP;
  const int ntiles = (b.c_hi - b.c_lo) * per_chunk;
  const uint32_t q_base = smem_u32(s.queries);
  TileWalk w{b.c_lo, 0};
  w.advance(wg, per_chunk);
  int phys = w.c < b.c_hi ? p.chunk_of[w.c] : 0;
  float* dist = s.dist + wg * WQ3 * WDQ;
  int cnt = 0;  // stages this warpgroup has taken from its ring
  unsigned live = 0;  // bit 2n + e: the lane's query slot 8n + 2t + e holds a query
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) live |= unsigned(s.q_row[8 * n + 2 * t + e] >= 0) << (2 * n + e);

  // the A fragments of box `box` of the ring's current stage from its int8
  // rows, as in wgmma_consume; the first box waits for the stage, the last
  // frees it
  auto take_box = [&](uint32_t(&a)[KSTEPS][4], int box) {
    const int slot = cnt % W_STAGES;
    if (box == 0) mbar_wait(&s.full[wg * W_STAGES + slot], (cnt / W_STAGES) & 1);
    const unsigned char* x = s.stage(wg, slot) + box * WR * WK + (warp * 16 + g) * WK + t * 16;
    const uint4 lo = lds128u(x), hi = lds128u(x + 8 * WK);
    const uint32_t wl[4] = {lo.x, lo.y, lo.z, lo.w}, wh[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bl[2], bh[2];
      widen_s8x4(wl[j], bl);
      widen_s8x4(wh[j], bh);
      a[j][0] = bl[0];
      a[j][1] = bh[0];
      a[j][2] = bl[1];
      a[j][3] = bh[1];
    }
    if (box == W_BOXES - 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[wg * W_STAGES + slot]);
      ++cnt;
    }
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
    float acc[N / 2], fresh[3 * N / 2];  // the running sum; a stage's sums, hi, mid, lo
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int e = 0; e < 3 * N / 2; ++e) fresh[e] = 0.0f;
    // a stage's first box reads a[0] while its second box is widened into
    // a[1]; the second box reads a[1] while the next stage's first box is
    // widened into a[0], once the first box's wgmma is done with it
    uint32_t a[2][KSTEPS][4];
    auto issue = [&](auto buf, int st) {
      constexpr int B = decltype(buf)::value;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KSTEPS; ++j)
        wgmma_rs_terms<3 * N>(fresh, a[B][j],
                              query_desc(q_base + (W_KSTEPS * st + KSTEPS * B + j) * W3_KSTEP),
                              B > 0 || j > 0);
      wgmma_commit();
    };
    take_box(a[0], 0);
    for (int st = 0; st < nst; ++st) {
      issue(std::integral_constant<int, 0>{}, st);
      take_box(a[1], 1);
      issue(std::integral_constant<int, 1>{}, st);
      wgmma_wait<1>();  // the first box is done with a[0]
      hold(a[0]);
      if (st + 1 < nst) take_box(a[0], 0);
      wgmma_wait<0>();
      hold(a[1]);
      fold_terms(acc, fresh);
    }

    // epilogue, hand-over and selection as in wgmma_consume
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * n + 2 * t + e;
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[h] = distance<false>(acc[4 * n + 2 * h + e], r_scale[h], 1.0f);
          dist[q * WDQ + warp * 16 + g + 8 * h] = v[h];
        }
        if (((live >> (2 * n + e)) & 1u) &&
            fminf(v[0], v[1]) < *static_cast<volatile const float*>(&s.top_d[q * W_LIST + p.k - 1]))
          reinterpret_cast<unsigned char*>(s.q_grp + wg * WQ3)[q * 4 + (warp >> 1)] = 1;
      }
    bar_sync(BAR_WG + wg, 128);
    if (i > 0) bar_sync(BAR_HANDOVER + wg, 256);  // the tile before is selected (by the warpgroup before)
    wgmma_select(p, s, wg, N, nrows, slot0);
    bar_sync(BAR_WG + wg, 128);  // the distance tile is free again
    if (i + 1 < ntiles) bar_arrive(BAR_HANDOVER + (wg + 1) % W_CONSUMERS, 256);
  }
}

// Register r of the three A fragments (a[term][r]: the store terms hi, mid,
// lo) from the value pair (x0, x1), x0 the lower depth: each value split as
// split3 does it, by truncation (both subtractions exact), each term's top
// 16 bits packed in pairs, x0's in the low half
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t (&a)[3][4], int r) {
  const uint32_t b0 = __float_as_uint(x0), b1 = __float_as_uint(x1);
  a[0][r] = __byte_perm(b0, b1, 0x7632);
  const float r0 = __fsub_rn(x0, __uint_as_float(b0 & 0xffff0000u));
  const float r1 = __fsub_rn(x1, __uint_as_float(b1 & 0xffff0000u));
  const uint32_t m0 = __float_as_uint(r0), m1 = __float_as_uint(r1);
  a[1][r] = __byte_perm(m0, m1, 0x7632);
  a[2][r] = __byte_perm(__float_as_uint(__fsub_rn(r0, __uint_as_float(m0 & 0xffff0000u))),
                        __float_as_uint(__fsub_rn(r1, __uint_as_float(m1 & 0xffff0000u))), 0x7632);
}

// D (64 rows × N query slots, f32) = A · B, or D += A · B where `add` is
// set (A: 64 rows × 16 depths, bf16, in registers; B: 16 depths × N slots,
// bf16, at desc), for the six-term body's two sums
template <int N>
__device__ __forceinline__ void wgmma_rs_sum(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc,
                                             int add) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add));
  }
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add));
  }
}

// A fold's two sums into the running sum, rounded: for each value the
// small sum (five products) + the large one (x_hi · q_hi), then one
// round-to-nearest add into acc.  fresh: the large sum, then the small one,
// each in the accumulator order of acc
template <int M>
__device__ __forceinline__ void fold_two(float (&acc)[M], float (&fresh)[2 * M]) {
  hold(fresh);
#pragma unroll
  for (int i = 0; i < M; ++i) acc[i] = __fadd_rn(acc[i], __fadd_rn(fresh[M + i], fresh[i]));
}

// The six-term consumer warpgroup (F32X: f32 queries over an f32 packed
// store): wgmma_consume's walk over its tiles, f32 ring, epilogue,
// hand-over and selection with wgmma_consume_terms' resident planes,
// spelled out so that the other bodies keep their code.  In k-step j of a
// box lane (g, t) reads chunk 2t + j of rows g and g + 8 as wgmma_consume
// does over f32 rows (WGMMA_F32_ORDER), and splits each value into three
// bf16 terms by truncation (split_pair), each term an A fragment.  Six
// wgmma m64nNk16 a k-step, each over one plane of the B tile, give
// mma_six's six products and no others: x_hi · q_hi into the large sum,
// and x_hi · q_mid, x_hi · q_lo, x_mid · q_hi, x_mid · q_mid, x_lo · q_hi
// into the small sum, each below ~2^-7 of the large sum's products, so
// that their truncation in the tensor cores' adds is ~2^-8 of the large
// sum's (with the five in the large sum its float64 error doubled, past
// cuBLAS's).  One shape, so wgmma orders the accumulator accesses itself.
// Two boxes (64 depths, four k-steps) make one fresh pair of sums, folded
// into the running sum with rounded adds (fold_two); the rows are split a
// box ahead of the tensor cores, into two sets of A registers in turns (a
// box is two k-steps of three terms).  N = 16·NL query slots.
template <int NL>
__device__ void wgmma_consume_six(const Params& p, const WSmem<F32X>& s, const WItem& b, int wg) {
  constexpr int N = 16 * NL;
  const int tid = threadIdx.x & 127, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int per_chunk = (p.chunk + WR - 1) / WR, nf = p.qd / W_QD_STEP_F;  // folds a tile
  const int ntiles = (b.c_hi - b.c_lo) * per_chunk;
  const uint32_t q_base = smem_u32(s.queries);
  TileWalk w{b.c_lo, 0};
  w.advance(wg, per_chunk);
  int phys = w.c < b.c_hi ? p.chunk_of[w.c] : 0;
  float* dist = s.dist + wg * WQX * WDQ;
  int cnt = 0;  // stages this warpgroup has taken from its ring
  unsigned live = 0;  // bit 2n + e: the lane's query slot 8n + 2t + e holds a query
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) live |= unsigned(s.q_row[8 * n + 2 * t + e] >= 0) << (2 * n + e);
  int f32_off[2];  // chunk 2t + j of row g, where TMA's 128-byte swizzle puts it
#pragma unroll
  for (int j = 0; j < 2; ++j) f32_off[j] = (warp * 16 + g) * WKF + (((2 * t + j) ^ g) << 4);

  // the three store terms' A fragments of box `box` of the ring's current
  // stage, a[j][term] for its k-steps j; the stage's first box waits for
  // it, its last frees it
  auto take_box = [&](uint32_t(&a)[2][3][4], int box) {
    const int slot = cnt % WX_STAGES;
    if (box == 0) mbar_wait(&s.full[wg * WX_STAGES + slot], (cnt / WX_STAGES) & 1);
    const uint32_t x = smem_u32(s.stage(wg, slot) + box * WR * WKF);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 lo = lds128(x + f32_off[j]), hi = lds128(x + f32_off[j] + 8 * WKF);
      split_pair(lo.x, lo.y, a[j], 0);
      split_pair(hi.x, hi.y, a[j], 1);
      split_pair(lo.z, lo.w, a[j], 2);
      split_pair(hi.z, hi.w, a[j], 3);
    }
    if (box == WX_BOXES - 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[wg * WX_STAGES + slot]);
      ++cnt;
    }
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
    float acc[N / 2], fresh[N];  // the running sum; a fold's large sum, then its small one
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int e = 0; e < N; ++e) fresh[e] = 0.0f;
    float(&large)[N / 2] = *reinterpret_cast<float(*)[N / 2]>(&fresh[0]);
    float(&small)[N / 2] = *reinterpret_cast<float(*)[N / 2]>(&fresh[N / 2]);
    // a fold's first box reads a[0] while its second box is split into
    // a[1]; the second box reads a[1] while the next fold's first box is
    // split into a[0], once the first box's wgmma is done with it
    uint32_t a[2][2][3][4];
    auto issue = [&](auto buf, int kk, int first) {  // k-steps kk, kk + 1
      constexpr int B = decltype(buf)::value;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // plane `term` of the B tile: N / 8 column groups of 256 bytes each
        const uint32_t q = q_base + (kk + j) * WX_KSTEP;
        const int add = !first || j > 0;
        wgmma_rs_sum<N>(large, a[B][j][0], query_desc(q), add);  // x_hi · q_hi
        wgmma_rs_sum<N>(small, a[B][j][2], query_desc(q), add);  // x_lo · q_hi
        wgmma_rs_sum<N>(small, a[B][j][1], query_desc(q + N / 8 * 256), 1);  // x_mid · q_mid
        wgmma_rs_sum<N>(small, a[B][j][1], query_desc(q), 1);  // x_mid · q_hi
        wgmma_rs_sum<N>(small, a[B][j][0], query_desc(q + N / 4 * 256), 1);  // x_hi · q_lo
        wgmma_rs_sum<N>(small, a[B][j][0], query_desc(q + N / 8 * 256), 1);  // x_hi · q_mid
      }
      wgmma_commit();
    };
    take_box(a[0], 0);
    for (int f = 0; f < nf; ++f) {
      issue(std::integral_constant<int, 0>{}, 4 * f, 1);
      take_box(a[1], WX_BOXES - 1);
      issue(std::integral_constant<int, 1>{}, 4 * f + 2, 0);
      wgmma_wait<1>();  // the first box is done with a[0]
#pragma unroll
      for (int j = 0; j < 2; ++j) hold(a[0][j]);
      if (f + 1 < nf) take_box(a[0], 0);
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < 2; ++j) hold(a[1][j]);
      fold_two(acc, fresh);
    }

    // epilogue, hand-over and selection as in wgmma_consume
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * n + 2 * t + e;
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[h] = distance<false>(acc[4 * n + 2 * h + e], r_scale[h], 1.0f);
          dist[q * WDQ + warp * 16 + g + 8 * h] = v[h];
        }
        if (((live >> (2 * n + e)) & 1u) &&
            fminf(v[0], v[1]) < *static_cast<volatile const float*>(&s.top_d[q * W_LIST + p.k - 1]))
          reinterpret_cast<unsigned char*>(s.q_grp + wg * WQX)[q * 4 + (warp >> 1)] = 1;
      }
    bar_sync(BAR_WG + wg, 128);
    if (i > 0) bar_sync(BAR_HANDOVER + wg, 256);  // the tile before is selected (by the warpgroup before)
    wgmma_select(p, s, wg, N, nrows, slot0);
    bar_sync(BAR_WG + wg, 128);  // the distance tile is free again
    if (i + 1 < ntiles) bar_arrive(BAR_HANDOVER + (wg + 1) % W_CONSUMERS, 256);
  }
}

// Wide-list selection of a consumer warpgroup's tile (list widths 64 and
// 128): select_tile_merge's rule over the tile's [query][row] distances, 64
// rows, four warps, the slots the block computes (nq), each warp one query
// at a time, with the list in the warp's registers for the merge (lane l
// holds entries l, l + 32, ...).  A warp finds its marked queries with one
// load a lane and a ballot.  For a marked query the lanes read its marked
// 32-row groups (lane l rows l and 32 + l), and a ballot finds the rows below
// the list's k-th; the warp walks those candidates in scan order, each
// broadcast by a shuffle: every entry counts the candidates strictly below
// it, every candidate the candidates before it in (distance, scan position)
// and, by ballots over the entries, the entries at or below it.  An entry's
// new place is its index plus the candidates below it, a candidate's its
// rank plus the entries at or below it, so the entries, which are earlier
// rows, win ties; what lands past k - 1 drops out.  One pass of the
// candidates, no buffer and no search of the list; its own code (another
// tile and list layout), so that the mma.sync instances keep theirs.  TS:
// any wide body (bf16, int8 or f32 queries; 64 or 32 slots), lists of
// width KMAX.
template <typename TS>
__device__ void wgmma_select_wide(const Params& p, const WSmem<TS>& s, int wg, int nq, int nrows,
                                  int slot0) {
  // PER: list entries a lane holds
  constexpr int KMAX = WSmem<TS>::LIST, PER = KMAX / 32, SLOTS = WSmem<TS>::SLOTS;
  const int lane = threadIdx.x & 31, k = p.k;
  const float* dist = s.dist + wg * SLOTS * WDQ;
  unsigned* grp = s.q_grp + wg * SLOTS;
  const int q0 = (threadIdx.x >> 5) & 3;
  // lane i: the marks of the warp's i-th query q0 + 4i (nq <= 4 · 32),
  // cleared once read (the epilogue marks live query slots only)
  const unsigned mine = q0 + 4 * lane < nq ? grp[q0 + 4 * lane] : 0u;
  if (mine != 0) grp[q0 + 4 * lane] = 0;
  for (unsigned todo = __ballot_sync(FULL, mine != 0); todo != 0; todo &= todo - 1) {
    const int i = __ffs(todo) - 1, q = q0 + 4 * i;
    const unsigned groups = __shfl_sync(FULL, mine, i);
    float* ld = s.top_d + q * KMAX;
    int* ls = s.top_s + q * KMAX;
    const float* row = dist + q * WDQ;
    const float worst = ld[k - 1];
    float v[2];
    unsigned below[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 32 * h + lane;
      v[h] = ((groups >> (8 * h)) & 0xffu) != 0 && r < nrows ? row[r] : CUDART_INF_F;
      below[h] = __ballot_sync(FULL, v[h] < worst);
    }
    if ((below[0] | below[1]) == 0) continue;
    float e[PER];
    int es[PER], lt[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      e[j] = ld[lane + 32 * j];  // past k - 1 never written: +inf
      es[j] = ls[lane + 32 * j];
      lt[j] = 0;
    }
    int rank[2] = {0, 0}, le[2] = {0, 0};
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)  // the candidates in scan order: row 32·h2 + b
      for (unsigned m = below[h2]; m != 0; m &= m - 1) {
        const int b = __ffs(m) - 1;
        const float u = __shfl_sync(FULL, v[h2], b);
        int at_or_below = 0;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          lt[j] += u < e[j];
          at_or_below += __popc(__ballot_sync(FULL, e[j] <= u));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
          rank[h] += u < v[h] || (u == v[h] && (h2 < h || (h2 == h && b < lane)));
        if (lane == b) le[h2] = at_or_below;
      }
    __syncwarp();  // every lane holds its entries: the list is rewritten
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int to = lane + 32 * j + lt[j];
      if (lt[j] != 0 && to < k) {
        ld[to] = e[j];
        ls[to] = es[j];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int place = rank[h] + le[h];
      if (((below[h] >> lane) & 1u) && place < k) {
        ld[place] = v[h];
        ls[place] = slot0 + 32 * h + lane;
      }
    }
    __syncwarp();
  }
}

// The wide-list consumer warpgroup: wgmma_consume's walk over its tiles,
// int8 ring, widening, wgmma and epilogue, spelled out so that the width-32
// bodies keep their code, with lists of width KMAX (the marks against their
// k-th) and wgmma_select_wide.  N = 16·NL query slots.
template <int KMAX, int NL>
__device__ void wgmma_consume_wide(const Params& p, const WSmem<WideList<KMAX>>& s, const WItem& b,
                                   int wg) {
  constexpr int N = 16 * NL, KSTEPS = W_KSTEPS, SLOTS = W_WIDE_SLOTS;
  constexpr int Q_KSTEP = WRing<WideList<KMAX>>::Q_KSTEP;
  const int tid = threadIdx.x & 127, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int per_chunk = (p.chunk + WR - 1) / WR, nst = p.qd / W_QD_STEP;
  const int ntiles = (b.c_hi - b.c_lo) * per_chunk;
  const uint32_t q_base = smem_u32(s.queries);
  TileWalk w{b.c_lo, 0};
  w.advance(wg, per_chunk);
  int phys = w.c < b.c_hi ? p.chunk_of[w.c] : 0;
  float* dist = s.dist + wg * SLOTS * WDQ;
  int cnt = 0;  // stages this warpgroup has taken from its ring
  unsigned live = 0;  // bit 2n + e: the lane's query slot 8n + 2t + e holds a query
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) live |= unsigned(s.q_row[8 * n + 2 * t + e] >= 0) << (2 * n + e);

  // the A fragments of a stage's k-steps from its int8 rows, as in wgmma_consume
  auto take_stage = [&](uint32_t(&a)[KSTEPS][4]) {
    const int slot = cnt % W_STAGES;
    mbar_wait(&s.full[wg * W_STAGES + slot], (cnt / W_STAGES) & 1);
#pragma unroll
    for (int box = 0; box < W_BOXES; ++box) {
      const unsigned char* x = s.stage(wg, slot) + box * WR * WK + (warp * 16 + g) * WK + t * 16;
      const uint4 lo = lds128u(x), hi = lds128u(x + 8 * WK);
      const uint32_t wl[4] = {lo.x, lo.y, lo.z, lo.w}, wh[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bl[2], bh[2];
        widen_s8x4(wl[j], bl);
        widen_s8x4(wh[j], bh);
        a[4 * box + j][0] = bl[0];
        a[4 * box + j][1] = bh[0];
        a[4 * box + j][2] = bl[1];
        a[4 * box + j][3] = bh[1];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[wg * W_STAGES + slot]);
    ++cnt;
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
    float acc[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0.0f;
    // stage st's wgmma reads a[st % 2]; stage st + 1's is queued behind it
    // before the warpgroup waits for stage st - 1 and widens stage st + 1
    // into the registers stage st - 1 read
    uint32_t a[2][KSTEPS][4];
    auto issue = [&](auto buf, int st) {
      constexpr int B = decltype(buf)::value;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KSTEPS; ++j)
        wgmma_rs<N>(acc, a[B][j], query_desc(q_base + (KSTEPS * st + j) * Q_KSTEP));
      wgmma_commit();
    };
    auto step = [&](auto buf, int st) {  // st >= 1
      constexpr int B = decltype(buf)::value;
      issue(buf, st);
      wgmma_wait<1>();  // stage st - 1 is done with a[B ^ 1]
      hold(a[B ^ 1]);
      if (st + 1 < nst) take_stage(a[B ^ 1]);
    };
    take_stage(a[0]);
    issue(std::integral_constant<int, 0>{}, 0);
    if (nst > 1) take_stage(a[1]);
    for (int st = 1; st < nst; st += 2) {
      step(std::integral_constant<int, 1>{}, st);
      if (st + 1 < nst) step(std::integral_constant<int, 0>{}, st + 1);
    }
    wgmma_wait<0>();
    hold(a[0]);
    hold(a[1]);
    hold(acc);

    // epilogue as in wgmma_consume, the marks against the wide list's k-th
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * n + 2 * t + e;
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[h] = distance<false>(acc[4 * n + 2 * h + e], r_scale[h], 1.0f);
          dist[q * WDQ + warp * 16 + g + 8 * h] = v[h];
        }
        if (((live >> (2 * n + e)) & 1u) &&
            fminf(v[0], v[1]) < *static_cast<volatile const float*>(&s.top_d[q * KMAX + p.k - 1]))
          reinterpret_cast<unsigned char*>(s.q_grp + wg * SLOTS)[q * 4 + (warp >> 1)] = 1;
      }
    bar_sync(BAR_WG + wg, 128);
    if (i > 0) bar_sync(BAR_HANDOVER + wg, 256);  // the tile before is selected (by the warpgroup before)
    wgmma_select_wide(p, s, wg, N, nrows, slot0);
    bar_sync(BAR_WG + wg, 128);  // the distance tile is free again
    if (i + 1 < ntiles) bar_arrive(BAR_HANDOVER + (wg + 1) % W_CONSUMERS, 256);
  }
}

// D (64 rows × N query slots, s32) += A (64 rows × 32 depths, s8, in
// registers) · B (32 depths × N slots, s8, at desc): exact integer sums
template <int N>
__device__ __forceinline__ void wgmma_rs_s8(int (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
}
template <int N>
__device__ __forceinline__ void hold(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The int8 consumer warpgroup (S8Mode: int8 queries over an int8 packed
// store): wgmma_consume's walk over its tiles, int8 ring, epilogue,
// hand-over and selection, spelled out so that the other bodies keep their
// code, with s8 wgmma m64nNk32 into s32 sums.  A is the tile's rows as they
// are, no widening: in k-step s of a box lane (g, t) holds words 2s and 2s +
// 1 of its 16 bytes (16t .. 16t+15) of rows g and g + 8, the fragment's
// depths 4t .. 4t+3 and 16 + 4t .. 16 + 4t + 3 (WGMMA_S8_ORDER in
// ops/scan_kernel.py); B the resident int8 queries, K-major.  The integer
// sums are exact in any order, so the epilogue's distance<true>(float(sum),
// row scale, query scale), the mma.sync body's, gives its bits.  N = 16·NL
// query slots.
template <int NL>
__device__ void wgmma_consume_s8(const Params& p, const WSmem<S8Mode>& s, const WItem& b, int wg) {
  using R = WRing<S8Mode>;
  constexpr int N = 16 * NL, KSTEPS = R::KSTEPS;
  const int tid = threadIdx.x & 127, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int per_chunk = (p.chunk + WR - 1) / WR, nst = p.qd / W_QD_STEP;
  const int ntiles = (b.c_hi - b.c_lo) * per_chunk;
  const uint32_t q_base = smem_u32(s.queries);
  TileWalk w{b.c_lo, 0};
  w.advance(wg, per_chunk);
  int phys = w.c < b.c_hi ? p.chunk_of[w.c] : 0;
  float* dist = s.dist + wg * WQ * WDQ;
  int cnt = 0;  // stages this warpgroup has taken from its ring
  unsigned live = 0;  // bit 2n + e: the lane's query slot 8n + 2t + e holds a query
  float q_scale[N / 4];  // [2n + e]: that slot's query scale
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      live |= unsigned(s.q_row[8 * n + 2 * t + e] >= 0) << (2 * n + e);
      q_scale[2 * n + e] = s8_qscales(s)[8 * n + 2 * t + e];
    }

  // the A fragments of a stage's k-steps, two a box: lane (g, t) reads
  // bytes 16t .. 16t+15 of rows g and g+8 of its warp's 16 in each box
  auto take_stage = [&](uint32_t(&a)[KSTEPS][4]) {
    const int slot = cnt % R::STAGES;
    mbar_wait(&s.full[wg * R::STAGES + slot], (cnt / R::STAGES) & 1);
#pragma unroll
    for (int box = 0; box < W_BOXES; ++box) {
      const unsigned char* x = s.stage(wg, slot) + box * WR * WK + (warp * 16 + g) * WK + t * 16;
      const uint4 lo = lds128u(x), hi = lds128u(x + 8 * WK);
      a[2 * box][0] = lo.x;
      a[2 * box][1] = hi.x;
      a[2 * box][2] = lo.y;
      a[2 * box][3] = hi.y;
      a[2 * box + 1][0] = lo.z;
      a[2 * box + 1][1] = hi.z;
      a[2 * box + 1][2] = lo.w;
      a[2 * box + 1][3] = hi.w;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[wg * R::STAGES + slot]);
    ++cnt;
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
    // stage st's wgmma reads a[st % 2]; stage st + 1's is queued behind it
    // before the warpgroup waits for stage st - 1 and loads stage st + 1
    // into the registers stage st - 1 read
    uint32_t a[2][KSTEPS][4];
    auto issue = [&](auto buf, int st) {
      constexpr int B = decltype(buf)::value;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KSTEPS; ++j)
        wgmma_rs_s8<N>(acc, a[B][j], query_desc(q_base + (KSTEPS * st + j) * WS8_KSTEP));
      wgmma_commit();
    };
    auto step = [&](auto buf, int st) {  // st >= 1
      constexpr int B = decltype(buf)::value;
      issue(buf, st);
      wgmma_wait<1>();  // stage st - 1 is done with a[B ^ 1]
      hold(a[B ^ 1]);
      if (st + 1 < nst) take_stage(a[B ^ 1]);
    };
    take_stage(a[0]);
    issue(std::integral_constant<int, 0>{}, 0);
    if (nst > 1) take_stage(a[1]);
    for (int st = 1; st < nst; st += 2) {
      step(std::integral_constant<int, 1>{}, st);
      if (st + 1 < nst) step(std::integral_constant<int, 0>{}, st + 1);
    }
    wgmma_wait<0>();
    hold(a[0]);
    hold(a[1]);
    hold(acc);

    // epilogue as in wgmma_consume, the sums and both scales as the
    // mma.sync body takes them
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * n + 2 * t + e;
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[h] = distance<true>(static_cast<float>(acc[4 * n + 2 * h + e]), r_scale[h],
                                q_scale[2 * n + e]);
          dist[q * WDQ + warp * 16 + g + 8 * h] = v[h];
        }
        if (((live >> (2 * n + e)) & 1u) &&
            fminf(v[0], v[1]) < *static_cast<volatile const float*>(&s.top_d[q * W_LIST + p.k - 1]))
          reinterpret_cast<unsigned char*>(s.q_grp + wg * WQ)[q * 4 + (warp >> 1)] = 1;
      }
    bar_sync(BAR_WG + wg, 128);
    if (i > 0) bar_sync(BAR_HANDOVER + wg, 256);  // the tile before is selected (by the warpgroup before)
    wgmma_select(p, s, wg, N, nrows, slot0);
    bar_sync(BAR_WG + wg, 128);  // the distance tile is free again
    if (i + 1 < ntiles) bar_arrive(BAR_HANDOVER + (wg + 1) % W_CONSUMERS, 256);
  }
}

// The int8 wide-list consumer warpgroup (S8WideList: int8 queries over an
// int8 packed store at list widths 64 and 128): wgmma_consume_s8's walk over
// its tiles, ring of WS8W_STAGES stages, A registers taken from the ring as
// the rows are, s8 wgmma and epilogue, with wgmma_consume_wide's lists of
// width KMAX (the marks against their k-th) and wgmma_select_wide, spelled
// out so that the other bodies keep their code.  The integer sums are exact
// and the epilogue and tie rule are the mma.sync body's, so its lists are
// that body's bits.  N = 16·NL query slots.
template <int KMAX, int NL>
__device__ void wgmma_consume_s8_wide(const Params& p, const WSmem<S8WideList<KMAX>>& s,
                                      const WItem& b, int wg) {
  using R = WRing<S8WideList<KMAX>>;
  constexpr int N = 16 * NL, KSTEPS = R::KSTEPS, SLOTS = R::SLOTS;
  const int tid = threadIdx.x & 127, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int per_chunk = (p.chunk + WR - 1) / WR, nst = p.qd / W_QD_STEP;
  const int ntiles = (b.c_hi - b.c_lo) * per_chunk;
  const uint32_t q_base = smem_u32(s.queries);
  TileWalk w{b.c_lo, 0};
  w.advance(wg, per_chunk);
  int phys = w.c < b.c_hi ? p.chunk_of[w.c] : 0;
  float* dist = s.dist + wg * SLOTS * WDQ;
  int cnt = 0;  // stages this warpgroup has taken from its ring
  unsigned live = 0;  // bit 2n + e: the lane's query slot 8n + 2t + e holds a query
  float q_scale[N / 4];  // [2n + e]: that slot's query scale
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      live |= unsigned(s.q_row[8 * n + 2 * t + e] >= 0) << (2 * n + e);
      q_scale[2 * n + e] = s8_qscales(s)[8 * n + 2 * t + e];
    }

  // a stage's A fragments as in wgmma_consume_s8: lane (g, t) reads bytes
  // 16t .. 16t+15 of rows g and g+8 of its warp's 16 in each box
  auto take_stage = [&](uint32_t(&a)[KSTEPS][4]) {
    const int slot = cnt % R::STAGES;
    mbar_wait(&s.full[wg * R::STAGES + slot], (cnt / R::STAGES) & 1);
#pragma unroll
    for (int box = 0; box < W_BOXES; ++box) {
      const unsigned char* x = s.stage(wg, slot) + box * WR * WK + (warp * 16 + g) * WK + t * 16;
      const uint4 lo = lds128u(x), hi = lds128u(x + 8 * WK);
      a[2 * box][0] = lo.x;
      a[2 * box][1] = hi.x;
      a[2 * box][2] = lo.y;
      a[2 * box][3] = hi.y;
      a[2 * box + 1][0] = lo.z;
      a[2 * box + 1][1] = hi.z;
      a[2 * box + 1][2] = lo.w;
      a[2 * box + 1][3] = hi.w;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[wg * R::STAGES + slot]);
    ++cnt;
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
    // stage st's wgmma reads a[st % 2]; stage st + 1's is queued behind it
    // before the warpgroup waits for stage st - 1 and loads stage st + 1
    // into the registers stage st - 1 read
    uint32_t a[2][KSTEPS][4];
    auto issue = [&](auto buf, int st) {
      constexpr int B = decltype(buf)::value;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KSTEPS; ++j)
        wgmma_rs_s8<N>(acc, a[B][j], query_desc(q_base + (KSTEPS * st + j) * R::Q_KSTEP));
      wgmma_commit();
    };
    auto step = [&](auto buf, int st) {  // st >= 1
      constexpr int B = decltype(buf)::value;
      issue(buf, st);
      wgmma_wait<1>();  // stage st - 1 is done with a[B ^ 1]
      hold(a[B ^ 1]);
      if (st + 1 < nst) take_stage(a[B ^ 1]);
    };
    take_stage(a[0]);
    issue(std::integral_constant<int, 0>{}, 0);
    if (nst > 1) take_stage(a[1]);
    for (int st = 1; st < nst; st += 2) {
      step(std::integral_constant<int, 1>{}, st);
      if (st + 1 < nst) step(std::integral_constant<int, 0>{}, st + 1);
    }
    wgmma_wait<0>();
    hold(a[0]);
    hold(a[1]);
    hold(acc);

    // the int8 body's epilogue, the marks against the wide list's k-th
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * n + 2 * t + e;
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[h] = distance<true>(static_cast<float>(acc[4 * n + 2 * h + e]), r_scale[h],
                                q_scale[2 * n + e]);
          dist[q * WDQ + warp * 16 + g + 8 * h] = v[h];
        }
        if (((live >> (2 * n + e)) & 1u) &&
            fminf(v[0], v[1]) < *static_cast<volatile const float*>(&s.top_d[q * KMAX + p.k - 1]))
          reinterpret_cast<unsigned char*>(s.q_grp + wg * SLOTS)[q * 4 + (warp >> 1)] = 1;
      }
    bar_sync(BAR_WG + wg, 128);
    if (i > 0) bar_sync(BAR_HANDOVER + wg, 256);  // the tile before is selected (by the warpgroup before)
    wgmma_select_wide(p, s, wg, N, nrows, slot0);
    bar_sync(BAR_WG + wg, 128);  // the distance tile is free again
    if (i + 1 < ntiles) bar_arrive(BAR_HANDOVER + (wg + 1) % W_CONSUMERS, 256);
  }
}

// The f32-mode consumer warpgroup with wide lists (F32ModeWideList: f32
// queries over an int8 packed store at list widths 64 and 128):
// wgmma_consume_terms's walk over its tiles, ring, rows widened a box
// ahead into two sets of A registers in turns, one wgmma m64n(3N)k16 a
// k-step into a fresh sum a stage and the fold, with wgmma_consume_wide's
// lists of width KMAX (the marks against their k-th) and
// wgmma_select_wide, spelled out so that the other bodies keep their code.  Each (query, row) sum is wgmma_consume_terms's, bit for
// bit.  N = 16·NL query slots.
template <int KMAX, int NL>
__device__ void wgmma_consume_terms_wide(const Params& p, const WSmem<F32ModeWideList<KMAX>>& s,
                                         const WItem& b, int wg) {
  using R = WRing<F32ModeWideList<KMAX>>;
  constexpr int N = 16 * NL, KSTEPS = WK / 16, SLOTS = R::SLOTS;  // KSTEPS: k-steps a box
  static_assert(W_BOXES == 2, "a stage's two boxes take the two sets of A registers in turns");
  const int tid = threadIdx.x & 127, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int per_chunk = (p.chunk + WR - 1) / WR, nst = p.qd / W_QD_STEP;
  const int ntiles = (b.c_hi - b.c_lo) * per_chunk;
  const uint32_t q_base = smem_u32(s.queries);
  TileWalk w{b.c_lo, 0};
  w.advance(wg, per_chunk);
  int phys = w.c < b.c_hi ? p.chunk_of[w.c] : 0;
  float* dist = s.dist + wg * SLOTS * WDQ;
  int cnt = 0;  // stages this warpgroup has taken from its ring
  unsigned live = 0;  // bit 2n + e: the lane's query slot 8n + 2t + e holds a query
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) live |= unsigned(s.q_row[8 * n + 2 * t + e] >= 0) << (2 * n + e);

  // box `box` of the ring's current stage widened into A fragments, as in
  // wgmma_consume_terms: the first box waits for the stage, the last frees it
  auto take_box = [&](uint32_t(&a)[KSTEPS][4], int box) {
    const int slot = cnt % R::STAGES;
    if (box == 0) mbar_wait(&s.full[wg * R::STAGES + slot], (cnt / R::STAGES) & 1);
    const unsigned char* x = s.stage(wg, slot) + box * WR * WK + (warp * 16 + g) * WK + t * 16;
    const uint4 lo = lds128u(x), hi = lds128u(x + 8 * WK);
    const uint32_t wl[4] = {lo.x, lo.y, lo.z, lo.w}, wh[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bl[2], bh[2];
      widen_s8x4(wl[j], bl);
      widen_s8x4(wh[j], bh);
      a[j][0] = bl[0];
      a[j][1] = bh[0];
      a[j][2] = bl[1];
      a[j][3] = bh[1];
    }
    if (box == W_BOXES - 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[wg * R::STAGES + slot]);
      ++cnt;
    }
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
    float acc[N / 2], fresh[3 * N / 2];  // the running sum; a stage's sums, hi, mid, lo
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int e = 0; e < 3 * N / 2; ++e) fresh[e] = 0.0f;
    // the first box of a stage reads a[0], the second a[1]; the next
    // stage's first box is widened into a[0] while the second box's wgmma runs
    uint32_t a[2][KSTEPS][4];
    auto issue = [&](auto buf, int st) {
      constexpr int B = decltype(buf)::value;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KSTEPS; ++j)
        wgmma_rs_terms<3 * N>(fresh, a[B][j],
                              query_desc(q_base + (W_KSTEPS * st + KSTEPS * B + j) * R::Q_KSTEP),
                              B > 0 || j > 0);
      wgmma_commit();
    };
    take_box(a[0], 0);
    for (int st = 0; st < nst; ++st) {
      issue(std::integral_constant<int, 0>{}, st);
      take_box(a[1], 1);
      issue(std::integral_constant<int, 1>{}, st);
      wgmma_wait<1>();  // a[0] is free: the first box's wgmma is done
      hold(a[0]);
      if (st + 1 < nst) take_box(a[0], 0);
      wgmma_wait<0>();
      hold(a[1]);
      fold_terms(acc, fresh);
    }

    // the f32-mode epilogue, the marks against the wide list's k-th
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * n + 2 * t + e;
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[h] = distance<false>(acc[4 * n + 2 * h + e], r_scale[h], 1.0f);
          dist[q * WDQ + warp * 16 + g + 8 * h] = v[h];
        }
        if (((live >> (2 * n + e)) & 1u) &&
            fminf(v[0], v[1]) < *static_cast<volatile const float*>(&s.top_d[q * KMAX + p.k - 1]))
          reinterpret_cast<unsigned char*>(s.q_grp + wg * SLOTS)[q * 4 + (warp >> 1)] = 1;
      }
    bar_sync(BAR_WG + wg, 128);
    if (i > 0) bar_sync(BAR_HANDOVER + wg, 256);  // the tile before is selected (by the warpgroup before)
    wgmma_select_wide(p, s, wg, N, nrows, slot0);
    bar_sync(BAR_WG + wg, 128);  // the distance tile is free again
    if (i + 1 < ntiles) bar_arrive(BAR_HANDOVER + (wg + 1) % W_CONSUMERS, 256);
  }
}

// The wide-list consumer warpgroup over f32 rows (F32WideList: bf16 queries
// over an f32 packed store at list widths 64 and 128): wgmma_consume_wide's
// walk over its tiles, wgmma, epilogue, lists of width KMAX (the marks
// against their k-th) and wgmma_select_wide, with wgmma_consume's f32
// branch of the ring: in k-step j of a box lane (g, t) reads chunk 2t + j
// of rows g and g + 8 where the 128-byte swizzle puts it and rounds each
// value pair to nearest even into one A register (WGMMA_F32_ORDER), R::BOXES
// boxes a stage.  Spelled out so that the other bodies keep their code.
// Its k-steps go into one sum in the width-32 body's order, whatever the
// stage, so each (query, row) sum is that body's, bit for bit.  N = 16·NL
// query slots.
template <int KMAX, int NL>
__device__ void wgmma_consume_f32_wide(const Params& p, const WSmem<F32WideList<KMAX>>& s,
                                       const WItem& b, int wg) {
  using R = WRing<F32WideList<KMAX>>;
  constexpr int N = 16 * NL, KSTEPS = R::KSTEPS, SLOTS = R::SLOTS;
  const int tid = threadIdx.x & 127, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int per_chunk = (p.chunk + WR - 1) / WR, nst = p.qd / (R::BOXES * R::DEPTHS);
  const int ntiles = (b.c_hi - b.c_lo) * per_chunk;
  const uint32_t q_base = smem_u32(s.queries);
  TileWalk w{b.c_lo, 0};
  w.advance(wg, per_chunk);
  int phys = w.c < b.c_hi ? p.chunk_of[w.c] : 0;
  float* dist = s.dist + wg * SLOTS * WDQ;
  int cnt = 0;  // stages this warpgroup has taken from its ring
  unsigned live = 0;  // bit 2n + e: the lane's query slot 8n + 2t + e holds a query
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) live |= unsigned(s.q_row[8 * n + 2 * t + e] >= 0) << (2 * n + e);
  int f32_off[2];  // chunk 2t + j of row g, where TMA's 128-byte swizzle puts it
#pragma unroll
  for (int j = 0; j < 2; ++j) f32_off[j] = (warp * 16 + g) * WKF + (((2 * t + j) ^ g) << 4);

  // the A fragments of a stage's k-steps from its f32 rows, two a box
  auto take_stage = [&](uint32_t(&a)[KSTEPS][4]) {
    const int slot = cnt % R::STAGES;
    mbar_wait(&s.full[wg * R::STAGES + slot], (cnt / R::STAGES) & 1);
#pragma unroll
    for (int box = 0; box < R::BOXES; ++box) {
      const uint32_t x = smem_u32(s.stage(wg, slot) + box * WR * WKF);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 lo = lds128(x + f32_off[j]), hi = lds128(x + f32_off[j] + 8 * WKF);
        a[2 * box + j][0] = bf16x2_rn(lo.x, lo.y);
        a[2 * box + j][1] = bf16x2_rn(hi.x, hi.y);
        a[2 * box + j][2] = bf16x2_rn(lo.z, lo.w);
        a[2 * box + j][3] = bf16x2_rn(hi.z, hi.w);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[wg * R::STAGES + slot]);
    ++cnt;
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
    float acc[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0.0f;
    // stage st's wgmma reads a[st % 2]; stage st + 1's is queued behind it
    // before the warpgroup waits for stage st - 1 and rounds stage st + 1
    // into the registers stage st - 1 read
    uint32_t a[2][KSTEPS][4];
    auto issue = [&](auto buf, int st) {
      constexpr int B = decltype(buf)::value;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KSTEPS; ++j)
        wgmma_rs<N>(acc, a[B][j], query_desc(q_base + (KSTEPS * st + j) * R::Q_KSTEP));
      wgmma_commit();
    };
    auto step = [&](auto buf, int st) {  // st >= 1
      constexpr int B = decltype(buf)::value;
      issue(buf, st);
      wgmma_wait<1>();  // stage st - 1 is done with a[B ^ 1]
      hold(a[B ^ 1]);
      if (st + 1 < nst) take_stage(a[B ^ 1]);
    };
    take_stage(a[0]);
    issue(std::integral_constant<int, 0>{}, 0);
    if (nst > 1) take_stage(a[1]);
    for (int st = 1; st < nst; st += 2) {
      step(std::integral_constant<int, 1>{}, st);
      if (st + 1 < nst) step(std::integral_constant<int, 0>{}, st + 1);
    }
    wgmma_wait<0>();
    hold(a[0]);
    hold(a[1]);
    hold(acc);

    // epilogue as in wgmma_consume, the marks against the wide list's k-th
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * n + 2 * t + e;
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[h] = distance<false>(acc[4 * n + 2 * h + e], r_scale[h], 1.0f);
          dist[q * WDQ + warp * 16 + g + 8 * h] = v[h];
        }
        if (((live >> (2 * n + e)) & 1u) &&
            fminf(v[0], v[1]) < *static_cast<volatile const float*>(&s.top_d[q * KMAX + p.k - 1]))
          reinterpret_cast<unsigned char*>(s.q_grp + wg * SLOTS)[q * 4 + (warp >> 1)] = 1;
      }
    bar_sync(BAR_WG + wg, 128);
    if (i > 0) bar_sync(BAR_HANDOVER + wg, 256);  // the tile before is selected (by the warpgroup before)
    wgmma_select_wide(p, s, wg, N, nrows, slot0);
    bar_sync(BAR_WG + wg, 128);  // the distance tile is free again
    if (i + 1 < ntiles) bar_arrive(BAR_HANDOVER + (wg + 1) % W_CONSUMERS, 256);
  }
}

template <typename TS>
__device__ void wgmma_write(const Params& p, const WSmem<TS>& s, const WItem& b, bool fill) {
  const int n_own = min(WSmem<TS>::SLOTS, p.qtile - b.q0);
  const size_t out0 = ((size_t)b.pair * p.qtile + b.q0) * p.k;
  const int threads = fill ? W_THREADS : W_CONSUMERS * 128;
  for (int e = threadIdx.x; e < n_own * p.k; e += threads) {
    const int q = e / p.k, j = e % p.k;
    p.out_d[out0 + e] = fill ? CUDART_INF_F : s.top_d[q * WSmem<TS>::LIST + j];
    p.out_s[out0 + e] = fill ? -1 : s.top_s[q * WSmem<TS>::LIST + j];
  }
}

// bf16 queries over an int8 packed store
__global__ void __launch_bounds__(W_THREADS, 1)
    scan_wgmma_kernel(const __grid_constant__ CUtensorMap rows, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WSmem<int8_t> s(smem);
  const WItem b = wgmma_begin(p, s);
  if (b.nl == 0) return wgmma_write(p, s, b, true);
  const int wg = threadIdx.x / 128;
  if (wg == W_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS) : "memory");
    if (threadIdx.x % 128 < 32 * W_CONSUMERS && threadIdx.x % 32 == 0)
      wgmma_produce(&rows, p, s, b, threadIdx.x % 128 / 32);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS) : "memory");
    switch (b.nl) {
      case 1: wgmma_consume<int8_t, 1>(p, s, b, wg); break;
      case 2: wgmma_consume<int8_t, 2>(p, s, b, wg); break;
      case 3: wgmma_consume<int8_t, 3>(p, s, b, wg); break;
      default: wgmma_consume<int8_t, 4>(p, s, b, wg); break;
    }
    bar_sync(BAR_CONSUMERS, W_CONSUMERS * 128);
    wgmma_write(p, s, b, false);
  }
}

// bf16 queries over an f32 packed store: the same block over the f32 ring
// (spelled out beside the kernel above: through a shared wrapper that took
// the parameters by reference, the int8 kernel compiled to other SASS).
// The swizzled boxes need the ring on 1024 bytes (kWRingOffset is), so the
// shared memory must start there
__global__ void __launch_bounds__(W_THREADS, 1)
    scan_wgmma_f32_kernel(const __grid_constant__ CUtensorMap rows, Params p) {
  extern __shared__ __align__(1024) unsigned char wsmem[];
  if (smem_u32(wsmem) % 1024 != 0) __trap();
  const WSmem<float> s(wsmem);
  const WItem b = wgmma_begin(p, s);
  if (b.nl == 0) return wgmma_write(p, s, b, true);
  const int wg = threadIdx.x / 128;
  if (wg == W_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS) : "memory");
    if (threadIdx.x % 128 < 32 * W_CONSUMERS && threadIdx.x % 32 == 0)
      wgmma_produce(&rows, p, s, b, threadIdx.x % 128 / 32);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS) : "memory");
    switch (b.nl) {
      case 1: wgmma_consume<float, 1>(p, s, b, wg); break;
      case 2: wgmma_consume<float, 2>(p, s, b, wg); break;
      case 3: wgmma_consume<float, 3>(p, s, b, wg); break;
      default: wgmma_consume<float, 4>(p, s, b, wg); break;
    }
    bar_sync(BAR_CONSUMERS, W_CONSUMERS * 128);
    wgmma_write(p, s, b, false);
  }
}

// f32 queries (three bf16 terms) over an int8 packed store: the int8
// kernel's block and ring, 32 query slots a block (spelled out beside it,
// as the kernel above is)
__global__ void __launch_bounds__(W_THREADS, 1)
    scan_wgmma_f32mode_kernel(const __grid_constant__ CUtensorMap rows, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WSmem<F32Mode> s(smem);
  const WItem b = wgmma_begin(p, s);
  if (b.nl == 0) return wgmma_write(p, s, b, true);
  const int wg = threadIdx.x / 128;
  if (wg == W_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS) : "memory");
    if (threadIdx.x % 128 < 32 * W_CONSUMERS && threadIdx.x % 32 == 0)
      wgmma_produce(&rows, p, s, b, threadIdx.x % 128 / 32);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS) : "memory");
    if (b.nl == 1) {
      wgmma_consume_terms<1>(p, s, b, wg);
    } else {
      wgmma_consume_terms<2>(p, s, b, wg);
    }
    bar_sync(BAR_CONSUMERS, W_CONSUMERS * 128);
    wgmma_write(p, s, b, false);
  }
}

// bf16 queries over an int8 packed store at list widths 64 and 128: the
// int8 kernel's block, ring and resident queries, with wide lists and their
// selection (spelled out beside it, as the kernels above are)
template <int KMAX>
__global__ void __launch_bounds__(W_THREADS, 1)
    scan_wgmma_wide_kernel(const __grid_constant__ CUtensorMap rows, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WSmem<WideList<KMAX>> s(smem);
  const WItem b = wgmma_begin(p, s);
  if (b.nl == 0) return wgmma_write(p, s, b, true);
  const int wg = threadIdx.x / 128;
  if (wg == W_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS) : "memory");
    if (threadIdx.x % 128 < 32 * W_CONSUMERS && threadIdx.x % 32 == 0)
      wgmma_produce(&rows, p, s, b, threadIdx.x % 128 / 32);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS) : "memory");
    switch (b.nl) {  // up to W_WIDE_SLOTS / 16
      case 1: wgmma_consume_wide<KMAX, 1>(p, s, b, wg); break;
      case 2: wgmma_consume_wide<KMAX, 2>(p, s, b, wg); break;
      case 3: wgmma_consume_wide<KMAX, 3>(p, s, b, wg); break;
      default: wgmma_consume_wide<KMAX, 4>(p, s, b, wg); break;
    }
    bar_sync(BAR_CONSUMERS, W_CONSUMERS * 128);
    wgmma_write(p, s, b, false);
  }
}

// f32 queries (three bf16 terms) over an f32 packed store: the f32 kernel's
// ring of one-box stages, WQX query slots a block with the three terms
// resident, six products a k-step (spelled out beside the kernels above).
// The swizzled boxes need the ring on 1024 bytes (kWXRingOffset is)
__global__ void __launch_bounds__(W_THREADS, 1)
    scan_wgmma_f32x_kernel(const __grid_constant__ CUtensorMap rows, Params p) {
  extern __shared__ __align__(1024) unsigned char wsmem[];
  if (smem_u32(wsmem) % 1024 != 0) __trap();
  const WSmem<F32X> s(wsmem);
  const WItem b = wgmma_begin(p, s);
  if (b.nl == 0) return wgmma_write(p, s, b, true);
  const int wg = threadIdx.x / 128;
  if (wg == W_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS) : "memory");
    if (threadIdx.x % 128 < 32 * W_CONSUMERS && threadIdx.x % 32 == 0)
      wgmma_produce(&rows, p, s, b, threadIdx.x % 128 / 32);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS) : "memory");
    if constexpr (WQX == 16) {
      wgmma_consume_six<1>(p, s, b, wg);
    } else if (b.nl == 1) {
      wgmma_consume_six<1>(p, s, b, wg);
    } else {
      wgmma_consume_six<2>(p, s, b, wg);
    }
    bar_sync(BAR_CONSUMERS, W_CONSUMERS * 128);
    wgmma_write(p, s, b, false);
  }
}

// int8 queries over an int8 packed store: the int8 kernel's block and ring,
// s8 wgmma with the int8 queries and their scales resident (spelled out
// beside the kernels above)
__global__ void __launch_bounds__(W_THREADS, 1)
    scan_wgmma_s8_kernel(const __grid_constant__ CUtensorMap rows, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WSmem<S8Mode> s(smem);
  const WItem b = wgmma_begin(p, s);
  if (b.nl == 0) return wgmma_write(p, s, b, true);
  const int wg = threadIdx.x / 128;
  if (wg == W_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS) : "memory");
    if (threadIdx.x % 128 < 32 * W_CONSUMERS && threadIdx.x % 32 == 0)
      wgmma_produce(&rows, p, s, b, threadIdx.x % 128 / 32);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS) : "memory");
    switch (b.nl) {
      case 1: wgmma_consume_s8<1>(p, s, b, wg); break;
      case 2: wgmma_consume_s8<2>(p, s, b, wg); break;
      case 3: wgmma_consume_s8<3>(p, s, b, wg); break;
      default: wgmma_consume_s8<4>(p, s, b, wg); break;
    }
    bar_sync(BAR_CONSUMERS, W_CONSUMERS * 128);
    wgmma_write(p, s, b, false);
  }
}

// int8 queries over an int8 packed store at list widths 64 and 128: the
// int8 kernel's ring, s8 wgmma and resident queries with the wide-list
// kernel's slots, lists and selection (spelled out beside the kernels above)
template <int KMAX>
__global__ void __launch_bounds__(W_THREADS, 1)
    scan_wgmma_s8_wide_kernel(const __grid_constant__ CUtensorMap rows, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WSmem<S8WideList<KMAX>> s(smem);
  const WItem b = wgmma_begin(p, s);
  if (b.nl == 0) return wgmma_write(p, s, b, true);
  const int wg = threadIdx.x / 128;
  if (wg == W_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS) : "memory");
    if (threadIdx.x % 128 < 32 * W_CONSUMERS && threadIdx.x % 32 == 0)
      wgmma_produce(&rows, p, s, b, threadIdx.x % 128 / 32);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS) : "memory");
    switch (b.nl) {  // up to W_WIDE_SLOTS / 16
      case 1: wgmma_consume_s8_wide<KMAX, 1>(p, s, b, wg); break;
      case 2: wgmma_consume_s8_wide<KMAX, 2>(p, s, b, wg); break;
      case 3: wgmma_consume_s8_wide<KMAX, 3>(p, s, b, wg); break;
      default: wgmma_consume_s8_wide<KMAX, 4>(p, s, b, wg); break;
    }
    bar_sync(BAR_CONSUMERS, W_CONSUMERS * 128);
    wgmma_write(p, s, b, false);
  }
}

// f32 queries (three bf16 terms) over an int8 packed store at list widths
// 64 and 128: the f32-mode kernel's block, ring and resident planes with
// the wide-list kernels' lists and selection (spelled out beside the
// kernels above)
template <int KMAX>
__global__ void __launch_bounds__(W_THREADS, 1)
    scan_wgmma_f32mode_wide_kernel(const __grid_constant__ CUtensorMap rows, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WSmem<F32ModeWideList<KMAX>> s(smem);
  const WItem b = wgmma_begin(p, s);
  if (b.nl == 0) return wgmma_write(p, s, b, true);
  const int wg = threadIdx.x / 128;
  if (wg == W_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS) : "memory");
    if (threadIdx.x % 128 < 32 * W_CONSUMERS && threadIdx.x % 32 == 0)
      wgmma_produce(&rows, p, s, b, threadIdx.x % 128 / 32);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS) : "memory");
    if (b.nl == 1) {  // up to WQ3 / 16
      wgmma_consume_terms_wide<KMAX, 1>(p, s, b, wg);
    } else {
      wgmma_consume_terms_wide<KMAX, 2>(p, s, b, wg);
    }
    bar_sync(BAR_CONSUMERS, W_CONSUMERS * 128);
    wgmma_write(p, s, b, false);
  }
}

// bf16 queries over an f32 packed store at list widths 64 and 128: the f32
// kernel's ring and rounding with the wide-list kernel's slots, lists and
// selection (spelled out beside the kernels above).  The swizzled boxes
// need the ring on 1024 bytes (F32WideList<KMAX>::HEAD is)
template <int KMAX>
__global__ void __launch_bounds__(W_THREADS, 1)
    scan_wgmma_f32_wide_kernel(const __grid_constant__ CUtensorMap rows, Params p) {
  extern __shared__ __align__(1024) unsigned char wsmem[];
  if (smem_u32(wsmem) % 1024 != 0) __trap();
  const WSmem<F32WideList<KMAX>> s(wsmem);
  const WItem b = wgmma_begin(p, s);
  if (b.nl == 0) return wgmma_write(p, s, b, true);
  const int wg = threadIdx.x / 128;
  if (wg == W_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS) : "memory");
    if (threadIdx.x % 128 < 32 * W_CONSUMERS && threadIdx.x % 32 == 0)
      wgmma_produce(&rows, p, s, b, threadIdx.x % 128 / 32);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS) : "memory");
    switch (b.nl) {  // up to W_WIDE_SLOTS / 16
      case 1: wgmma_consume_f32_wide<KMAX, 1>(p, s, b, wg); break;
      case 2: wgmma_consume_f32_wide<KMAX, 2>(p, s, b, wg); break;
      case 3: wgmma_consume_f32_wide<KMAX, 3>(p, s, b, wg); break;
      default: wgmma_consume_f32_wide<KMAX, 4>(p, s, b, wg); break;
    }
    bar_sync(BAR_CONSUMERS, W_CONSUMERS * 128);
    wgmma_write(p, s, b, false);
  }
}

// ---------------------------------------------------------------------
// the row-map bodies: a virtual store's rows gathered through the id grid
// into the int8 ring (see the note at the top)
// ---------------------------------------------------------------------
// an arrive-on `bar` once this thread's cp.async copies so far have
// landed: the barrier's pending count rises by one now and falls at that
// arrival, so the phase waits for the copies without counting them
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The gathering producer (a whole warp) of consumer warpgroup `wg`:
// wgmma_produce's walk over the item's tiles (wg, wg + 2, ...) and its
// ring, each stage's bytes where TMA puts a packed store's, but each
// slot's row read through the id grid.  The lanes hold a tile's 64 ids
// (lane i: rows i and 32 + i, read as the tile starts: read during the
// tile before, they took registers past the producer's 40 and spilled, and
// the scans took 1.09x the time); in a
// stage, lane 8j + c copies piece c (16 bytes) of the stage's 128 depths
// of rows 4i + j, i = 0 .. 15 (four rows' 128 contiguous bytes a copy
// instruction), from corpus + (id − 1)·d (64-bit: the flagship corpus is
// 7.7 GB) to box c / 4, bytes 16·(c % 4) of the row.  A padding slot (id
// 0), a row past the chunk and depths past d are written as zeros
// (src-size 0), never skipped.  Each lane then has the stage's full
// barrier wait for its copies, and once the warp has, lane 0 makes the
// barrier's one expected arrival.
template <typename TS>
__device__ void wgmma_gather(const Params& p, const WSmem<TS>& s, const WItem& b, int wg) {
  using R = WRing<TS>;
  static_assert(R::BOXES * R::DEPTHS == 128 && R::ROW == WK, "a stage: 128 int8 depths, two boxes");
  const int lane = threadIdx.x & 31, c = lane & 7, j = lane >> 3;
  const int per_chunk = (p.chunk + WR - 1) / WR, nst = p.qd / (R::BOXES * R::DEPTHS);
  const int8_t* corpus = static_cast<const int8_t*>(p.store);
  TileWalk w{b.c_lo, 0};
  w.advance(wg, per_chunk);
  int cnt = 0;
  while (w.c < b.c_hi) {
    const int r0 = w.t * WR, slot0 = p.chunk_of[w.c] * p.chunk + r0, nrows = min(WR, p.chunk - r0);
    const int id_lo = lane < nrows ? p.row_ids[slot0 + lane] : 0;
    const int id_hi = lane + 32 < nrows ? p.row_ids[slot0 + lane + 32] : 0;
    for (int st = 0; st < nst; ++st, ++cnt) {
      const int slot = cnt % R::STAGES;
      uint64_t* full = &s.full[wg * R::STAGES + slot];
      mbar_wait(&s.empty[wg * R::STAGES + slot], ((cnt / R::STAGES) & 1) ^ 1);
      const int depth = st * 128 + 16 * c;
      unsigned char* dst = s.stage(wg, slot) + (c >> 2) * WR * WK + (c & 3) * 16;
#pragma unroll
      for (int i = 0; i < WR / 4; ++i) {
        const int id = __shfl_sync(FULL, i < 8 ? id_lo : id_hi, (4 * i + j) & 31);
        const bool ok = id > 0 && depth < p.d;
        cp_async16(dst + (4 * i + j) * WK, corpus + (ok ? size_t(id - 1) * p.d + depth : 0), ok);
      }
      cp_async_arrive(full);
      __syncwarp();
      if (lane == 0) mbar_arrive(full);
    }
    w.advance(W_CONSUMERS, per_chunk);
  }
  cp_async_wait_all();
}

// The row-map consumer warpgroup for bf16 queries (RowMap<int8_t>):
// wgmma_consume's int8 path spelled out (so that the packed bodies keep
// their code) over its own ring of RM_STAGES stages, each row's scale read
// through the id grid by load_row_meta's rule (row_scales[id − 1], 1 with
// none, 0 for a padding slot or a row past the chunk): the id as the tile
// starts, its scale once the tile's first wgmma is queued.  The stage bytes
// and scales are a packed store's of the same corpus, so the sums, the
// epilogue and the lists are body 1's, bit for bit.  N = 16·NL query slots.
template <int NL>
__device__ void wgmma_consume_rowmap(const Params& p, const WSmem<RowMap<int8_t>>& s,
                                     const WItem& b, int wg) {
  using R = WRing<RowMap<int8_t>>;
  constexpr int N = 16 * NL, KSTEPS = R::KSTEPS;
  const int tid = threadIdx.x & 127, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int per_chunk = (p.chunk + WR - 1) / WR, nst = p.qd / R::QD_STEP;
  const int ntiles = (b.c_hi - b.c_lo) * per_chunk;
  const uint32_t q_base = smem_u32(s.queries);
  TileWalk w{b.c_lo, 0};
  w.advance(wg, per_chunk);
  int phys = w.c < b.c_hi ? p.chunk_of[w.c] : 0;
  float* dist = s.dist + wg * WQ * WDQ;
  int cnt = 0;  // stages this warpgroup has taken from its ring
  unsigned live = 0;  // bit 2n + e: the lane's query slot 8n + 2t + e holds a query
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) live |= unsigned(s.q_row[8 * n + 2 * t + e] >= 0) << (2 * n + e);

  // the A fragments of a stage's k-steps, four a box, widened as in wgmma_consume
  auto take_stage = [&](uint32_t(&a)[KSTEPS][4]) {
    const int slot = cnt % R::STAGES;
    mbar_wait(&s.full[wg * R::STAGES + slot], (cnt / R::STAGES) & 1);
#pragma unroll
    for (int box = 0; box < R::BOXES; ++box) {
      const unsigned char* x = s.stage(wg, slot) + box * WR * WK + (warp * 16 + g) * WK + t * 16;
      const uint4 lo = lds128u(x), hi = lds128u(x + 8 * WK);
      const uint32_t wl[4] = {lo.x, lo.y, lo.z, lo.w}, wh[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bl[2], bh[2];
        widen_s8x4(wl[j], bl);
        widen_s8x4(wh[j], bh);
        a[4 * box + j][0] = bl[0];
        a[4 * box + j][1] = bh[0];
        a[4 * box + j][2] = bl[1];
        a[4 * box + j][3] = bh[1];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[wg * R::STAGES + slot]);
    ++cnt;
  };

  for (int i = wg; i < ntiles; i += W_CONSUMERS) {
    const int r0 = w.t * WR;
    const int slot0 = phys * p.chunk + r0, nrows = min(WR, p.chunk - r0);
    w.advance(W_CONSUMERS, per_chunk);  // the next tile's chunk, read while this one runs
    phys = w.c < b.c_hi ? p.chunk_of[w.c] : 0;
    int id[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      id[h] = r < nrows ? p.row_ids[slot0 + r] : 0;  // 0 → scale 0 → +inf distance
    }
    float acc[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0.0f;
    uint32_t a[2][KSTEPS][4];
    auto issue = [&](auto buf, int st) {
      constexpr int B = decltype(buf)::value;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KSTEPS; ++j)
        wgmma_rs<N>(acc, a[B][j], query_desc(q_base + (KSTEPS * st + j) * W_KSTEP));
      wgmma_commit();
    };
    auto step = [&](auto buf, int st) {  // st >= 1
      constexpr int B = decltype(buf)::value;
      issue(buf, st);
      wgmma_wait<1>();  // stage st - 1 is done with a[B ^ 1]
      hold(a[B ^ 1]);
      if (st + 1 < nst) take_stage(a[B ^ 1]);
    };
    take_stage(a[0]);
    issue(std::integral_constant<int, 0>{}, 0);
    float r_scale[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      r_scale[h] = id[h] == 0 ? 0.0f : p.scales != nullptr ? p.scales[id[h] - 1] : 1.0f;
    if (nst > 1) take_stage(a[1]);
    for (int st = 1; st < nst; st += 2) {
      step(std::integral_constant<int, 1>{}, st);
      if (st + 1 < nst) step(std::integral_constant<int, 0>{}, st + 1);
    }
    wgmma_wait<0>();
    hold(a[0]);
    hold(a[1]);
    hold(acc);

    // epilogue, hand-over and selection as in wgmma_consume
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * n + 2 * t + e;
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[h] = distance<false>(acc[4 * n + 2 * h + e], r_scale[h], 1.0f);
          dist[q * WDQ + warp * 16 + g + 8 * h] = v[h];
        }
        if (((live >> (2 * n + e)) & 1u) &&
            fminf(v[0], v[1]) < *static_cast<volatile const float*>(&s.top_d[q * W_LIST + p.k - 1]))
          reinterpret_cast<unsigned char*>(s.q_grp + wg * WQ)[q * 4 + (warp >> 1)] = 1;
      }
    bar_sync(BAR_WG + wg, 128);
    if (i > 0) bar_sync(BAR_HANDOVER + wg, 256);  // the tile before is selected (by the warpgroup before)
    wgmma_select(p, s, wg, N, nrows, slot0);
    bar_sync(BAR_WG + wg, 128);  // the distance tile is free again
    if (i + 1 < ntiles) bar_arrive(BAR_HANDOVER + (wg + 1) % W_CONSUMERS, 256);
  }
}

// The row-map consumer warpgroup for f32 queries (RowMap<F32Mode>):
// wgmma_consume_terms spelled out over its own ring of RM3_STAGES stages,
// each row's scale read through the id grid as in wgmma_consume_rowmap.
// Its sums and lists are body 3's over a packed store of the same corpus,
// bit for bit.  N = 16·NL query slots.
template <int NL>
__device__ void wgmma_consume_terms_rowmap(const Params& p, const WSmem<RowMap<F32Mode>>& s,
                                           const WItem& b, int wg) {
  using R = WRing<RowMap<F32Mode>>;
  constexpr int N = 16 * NL, KSTEPS = WK / 16;  // k-steps a box
  static_assert(R::BOXES == 2, "a stage's two boxes take the two sets of A registers in turns");
  const int tid = threadIdx.x & 127, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int per_chunk = (p.chunk + WR - 1) / WR, nst = p.qd / R::QD_STEP;
  const int ntiles = (b.c_hi - b.c_lo) * per_chunk;
  const uint32_t q_base = smem_u32(s.queries);
  TileWalk w{b.c_lo, 0};
  w.advance(wg, per_chunk);
  int phys = w.c < b.c_hi ? p.chunk_of[w.c] : 0;
  float* dist = s.dist + wg * WQ3 * WDQ;
  int cnt = 0;  // stages this warpgroup has taken from its ring
  unsigned live = 0;  // bit 2n + e: the lane's query slot 8n + 2t + e holds a query
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) live |= unsigned(s.q_row[8 * n + 2 * t + e] >= 0) << (2 * n + e);

  // the A fragments of box `box` of the ring's current stage, as in
  // wgmma_consume_terms; the first box waits for the stage, the last frees it
  auto take_box = [&](uint32_t(&a)[KSTEPS][4], int box) {
    const int slot = cnt % R::STAGES;
    if (box == 0) mbar_wait(&s.full[wg * R::STAGES + slot], (cnt / R::STAGES) & 1);
    const unsigned char* x = s.stage(wg, slot) + box * WR * WK + (warp * 16 + g) * WK + t * 16;
    const uint4 lo = lds128u(x), hi = lds128u(x + 8 * WK);
    const uint32_t wl[4] = {lo.x, lo.y, lo.z, lo.w}, wh[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bl[2], bh[2];
      widen_s8x4(wl[j], bl);
      widen_s8x4(wh[j], bh);
      a[j][0] = bl[0];
      a[j][1] = bh[0];
      a[j][2] = bl[1];
      a[j][3] = bh[1];
    }
    if (box == R::BOXES - 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[wg * R::STAGES + slot]);
      ++cnt;
    }
  };

  for (int i = wg; i < ntiles; i += W_CONSUMERS) {
    const int r0 = w.t * WR;
    const int slot0 = phys * p.chunk + r0, nrows = min(WR, p.chunk - r0);
    w.advance(W_CONSUMERS, per_chunk);  // the next tile's chunk, read while this one runs
    phys = w.c < b.c_hi ? p.chunk_of[w.c] : 0;
    int id[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      id[h] = r < nrows ? p.row_ids[slot0 + r] : 0;  // 0 → scale 0 → +inf distance
    }
    float acc[N / 2], fresh[3 * N / 2];  // the running sum; a stage's sums, hi, mid, lo
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int e = 0; e < 3 * N / 2; ++e) fresh[e] = 0.0f;
    uint32_t a[2][KSTEPS][4];
    auto issue = [&](auto buf, int st) {
      constexpr int B = decltype(buf)::value;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KSTEPS; ++j)
        wgmma_rs_terms<3 * N>(fresh, a[B][j],
                              query_desc(q_base + (W_KSTEPS * st + KSTEPS * B + j) * W3_KSTEP),
                              B > 0 || j > 0);
      wgmma_commit();
    };
    // stage st once its first box's wgmma is queued
    auto finish = [&](int st) {
      take_box(a[1], 1);
      issue(std::integral_constant<int, 1>{}, st);
      wgmma_wait<1>();  // the first box is done with a[0]
      hold(a[0]);
      if (st + 1 < nst) take_box(a[0], 0);
      wgmma_wait<0>();
      hold(a[1]);
      fold_terms(acc, fresh);
    };
    take_box(a[0], 0);
    issue(std::integral_constant<int, 0>{}, 0);
    float r_scale[2];  // the ids' scales, read while the first box's wgmma runs
#pragma unroll
    for (int h = 0; h < 2; ++h)
      r_scale[h] = id[h] == 0 ? 0.0f : p.scales != nullptr ? p.scales[id[h] - 1] : 1.0f;
    finish(0);
    for (int st = 1; st < nst; ++st) {
      issue(std::integral_constant<int, 0>{}, st);
      finish(st);
    }

    // epilogue, hand-over and selection as in wgmma_consume
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * n + 2 * t + e;
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[h] = distance<false>(acc[4 * n + 2 * h + e], r_scale[h], 1.0f);
          dist[q * WDQ + warp * 16 + g + 8 * h] = v[h];
        }
        if (((live >> (2 * n + e)) & 1u) &&
            fminf(v[0], v[1]) < *static_cast<volatile const float*>(&s.top_d[q * W_LIST + p.k - 1]))
          reinterpret_cast<unsigned char*>(s.q_grp + wg * WQ3)[q * 4 + (warp >> 1)] = 1;
      }
    bar_sync(BAR_WG + wg, 128);
    if (i > 0) bar_sync(BAR_HANDOVER + wg, 256);  // the tile before is selected (by the warpgroup before)
    wgmma_select(p, s, wg, N, nrows, slot0);
    bar_sync(BAR_WG + wg, 128);  // the distance tile is free again
    if (i + 1 < ntiles) bar_arrive(BAR_HANDOVER + (wg + 1) % W_CONSUMERS, 256);
  }
}

// bf16 queries over a virtual store of an int8 + row-scale corpus: the int8
// kernel's block, its gathering producer warps and row-map consumers
// (spelled out beside the kernels above); no tensor map: no box spans rows
__global__ void __launch_bounds__(W_THREADS, 1) scan_wgmma_rowmap_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WSmem<RowMap<int8_t>> s(smem);
  const WItem b = wgmma_begin(p, s);
  if (b.nl == 0) return wgmma_write(p, s, b, true);
  const int wg = threadIdx.x / 128;
  if (wg == W_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS) : "memory");
    if (threadIdx.x % 128 < 32 * W_CONSUMERS) wgmma_gather(p, s, b, threadIdx.x % 128 / 32);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS) : "memory");
    switch (b.nl) {
      case 1: wgmma_consume_rowmap<1>(p, s, b, wg); break;
      case 2: wgmma_consume_rowmap<2>(p, s, b, wg); break;
      case 3: wgmma_consume_rowmap<3>(p, s, b, wg); break;
      default: wgmma_consume_rowmap<4>(p, s, b, wg); break;
    }
    bar_sync(BAR_CONSUMERS, W_CONSUMERS * 128);
    wgmma_write(p, s, b, false);
  }
}

// f32 queries (three bf16 terms) over a virtual store of an int8 +
// row-scale corpus: the f32-mode kernel's block, the gathering producer
// warps and its row-map consumers (spelled out beside the kernels above)
__global__ void __launch_bounds__(W_THREADS, 1) scan_wgmma_f32mode_rowmap_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WSmem<RowMap<F32Mode>> s(smem);
  const WItem b = wgmma_begin(p, s);
  if (b.nl == 0) return wgmma_write(p, s, b, true);
  const int wg = threadIdx.x / 128;
  if (wg == W_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PRODUCER_REGS) : "memory");
    if (threadIdx.x % 128 < 32 * W_CONSUMERS) wgmma_gather(p, s, b, threadIdx.x % 128 / 32);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CONSUMER_REGS) : "memory");
    if (b.nl == 1) {  // up to WQ3 / 16
      wgmma_consume_terms_rowmap<1>(p, s, b, wg);
    } else {
      wgmma_consume_terms_rowmap<2>(p, s, b, wg);
    }
    bar_sync(BAR_CONSUMERS, W_CONSUMERS * 128);
    wgmma_write(p, s, b, false);
  }
}

// The store as a 2-D tensor of n_rows × d values for TMA (boxes of WR rows
// × WK int8 depths, or × 32 f32 depths under the 128-byte swizzle; zeros
// past its edges), by cuTensorMapEncodeTiled looked up at run time, so the
// library needs no link to libcuda.
template <typename TS>
cudaError_t row_tensor_map(CUtensorMap* map, const void* store, int n_rows, int d) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                              const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  constexpr bool F32 = std::is_same<TS, float>::value;
  const cuuint64_t dims[2] = {cuuint64_t(d), cuuint64_t(n_rows)};
  const cuuint64_t strides[1] = {cuuint64_t(d) * sizeof(TS)};
  const cuuint32_t box[2] = {cuuint32_t(WRing<TS>::DEPTHS), WR}, elem[2] = {1, 1};
  const CUresult r = encode(map, F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                            2, const_cast<void*>(store), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            F32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The bodies: the mma.sync body, or one of the eleven wgmma bodies
enum Body {
  BODY_MMA = 0,
  BODY_WGMMA_INT8 = 1,
  BODY_WGMMA_F32 = 2,
  BODY_WGMMA_F32MODE = 3,
  BODY_WGMMA_WIDE = 4,
  BODY_WGMMA_F32X = 5,
  BODY_WGMMA_S8 = 6,
  BODY_WGMMA_S8_WIDE = 7,
  BODY_WGMMA_F32MODE_WIDE = 8,
  BODY_WGMMA_F32_WIDE = 9,
  BODY_WGMMA_INT8_ROWMAP = 10,
  BODY_WGMMA_F32MODE_ROWMAP = 11
};

// The wgmma bodies' scope: bf16 or f32 queries over an int8 or f32 packed
// store, or int8 queries over an int8 packed store (no row map), lists of
// width 32 and no floor, rows of whole 16 bytes at a 16-byte aligned store,
// and a resident query tile that fits (d rounded up to W_QD_STEP over an
// int8 store or W_QD_STEP_F over an f32 store, within W_MAX_QD, W_MAX_QD3,
// W_MAX_QDS8, W_MAX_QD_F or W_MAX_QDX); and bf16, int8 or f32 queries
// over an int8 packed store and bf16 queries over an f32 packed store at
// list widths 64 and 128 (k 33 to 128) on the same terms, the tile within
// WideList<64 or 128>::MAX_QD, S8WideList<64 or 128>::MAX_QD,
// F32ModeWideList<64 or 128>::MAX_QD or F32WideList<64 or 128>::MAX_QD; and
// over a row map (a virtual store) bf16 or f32 queries over an int8 corpus
// at list width 32 on the same terms (a 16-byte aligned corpus), the tile
// within WRing<RowMap<int8_t>>::MAX_QD or WRing<RowMap<F32Mode>>::MAX_QD.  A
// round under a floor (k past 1024) keeps the mma.sync body of the rounds before it: every round
// sums a row the same way, or a row at the boundary could be listed twice
// or not at all.
int wgmma_scope(int mode, int store_type, int k, int d, const void* store, const void* row_ids,
                bool floored) {
  if (floored || k > W_WIDE_LIST || reinterpret_cast<uintptr_t>(store) % 16 != 0) return BODY_MMA;
  const int qd = (d + W_QD_STEP - 1) / W_QD_STEP * W_QD_STEP;
  if (row_ids != nullptr) {
    if (k > W_LIST || store_type != STORE_INT8 || d % 16 != 0) return BODY_MMA;
    if (mode == MODE_BF16 && qd <= WRing<RowMap<int8_t>>::MAX_QD) return BODY_WGMMA_INT8_ROWMAP;
    if (mode == MODE_F32 && qd <= WRing<RowMap<F32Mode>>::MAX_QD) return BODY_WGMMA_F32MODE_ROWMAP;
    return BODY_MMA;
  }
  if (mode == MODE_INT8) {
    if (store_type != STORE_INT8 || d % 16 != 0) return BODY_MMA;
    if (k <= W_LIST) return qd <= W_MAX_QDS8 ? BODY_WGMMA_S8 : BODY_MMA;
    return qd <= (k <= 64 ? S8WideList<64>::MAX_QD : S8WideList<128>::MAX_QD) ? BODY_WGMMA_S8_WIDE
                                                                              : BODY_MMA;
  }
  if (k > W_LIST) {
    if (mode == MODE_BF16 && store_type == STORE_F32 && d % 4 == 0) {
      const int qd_f = (d + W_QD_STEP_F - 1) / W_QD_STEP_F * W_QD_STEP_F;
      return qd_f <= (k <= 64 ? F32WideList<64>::MAX_QD : F32WideList<128>::MAX_QD)
                 ? BODY_WGMMA_F32_WIDE
                 : BODY_MMA;
    }
    if (store_type != STORE_INT8 || d % 16 != 0) return BODY_MMA;
    if (mode == MODE_BF16)
      return qd <= (k <= 64 ? WideList<64>::MAX_QD : WideList<128>::MAX_QD) ? BODY_WGMMA_WIDE
                                                                          : BODY_MMA;
    return qd <= (k <= 64 ? F32ModeWideList<64>::MAX_QD : F32ModeWideList<128>::MAX_QD)
               ? BODY_WGMMA_F32MODE_WIDE
               : BODY_MMA;
  }
  if (store_type == STORE_INT8 && d % 16 == 0) {
    if (mode == MODE_BF16 && qd <= W_MAX_QD) return BODY_WGMMA_INT8;
    if (mode == MODE_F32 && qd <= W_MAX_QD3) return BODY_WGMMA_F32MODE;
  }
  if (store_type == STORE_F32 && d % 4 == 0) {
    const int qd_f = (d + W_QD_STEP_F - 1) / W_QD_STEP_F * W_QD_STEP_F;
    if (mode == MODE_BF16 && qd_f <= W_MAX_QD_F) return BODY_WGMMA_F32;
    if (mode == MODE_F32 && qd_f <= W_MAX_QDX) return BODY_WGMMA_F32X;
  }
  return BODY_MMA;
}

// Launches a wgmma body over n_pairs pairs (a block a pair's 64 query
// slots, or WQ3 / WQX in f32 mode, at every list width), or reports its
// blocks an SM
template <typename TS>
cudaError_t launch_wgmma(const Params& p, int n_pairs, int n_rows, cudaStream_t stream,
                         int* blocks_per_sm) {
  void (*kernel)(const CUtensorMap, Params) = nullptr;
  if constexpr (IsWide<TS>::value) {
    kernel = scan_wgmma_wide_kernel<TS::KMAX>;
  } else if constexpr (IsS8Wide<TS>::value) {
    kernel = scan_wgmma_s8_wide_kernel<TS::KMAX>;
  } else if constexpr (IsF32ModeWide<TS>::value) {
    kernel = scan_wgmma_f32mode_wide_kernel<TS::KMAX>;
  } else if constexpr (IsF32Wide<TS>::value) {
    kernel = scan_wgmma_f32_wide_kernel<TS::KMAX>;
  } else {
    kernel = std::is_same<TS, float>::value     ? scan_wgmma_f32_kernel
             : std::is_same<TS, F32Mode>::value ? scan_wgmma_f32mode_kernel
             : std::is_same<TS, F32X>::value    ? scan_wgmma_f32x_kernel
             : std::is_same<TS, S8Mode>::value  ? scan_wgmma_s8_kernel
                                                : scan_wgmma_kernel;
  }
  if (p.qd % WRing<TS>::QD_STEP != 0 || p.qd > WRing<TS>::MAX_QD) return cudaErrorInvalidValue;
  const size_t smem = wgmma_smem_bytes<TS>(p.qd);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (blocks_per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, W_THREADS, smem);
  CUtensorMap map;
  err = row_tensor_map<typename WRing<TS>::Row>(&map, p.store, n_rows, p.d);
  if (err != cudaSuccess) return err;
  const int splits = (p.qtile + WRing<TS>::SLOTS - 1) / WRing<TS>::SLOTS;
  kernel<<<n_pairs * splits, W_THREADS, smem, stream>>>(map, p);
  return cudaGetLastError();
}

// Launches the instance over n_pairs pairs, or where blocks_per_sm is
// set, reports how many of its blocks one SM holds at once instead
template <int MODE, typename TS, int KMAX>
cudaError_t launch_width(const Params& p, int n_pairs, cudaStream_t stream, int* blocks_per_sm) {
  void (*kernel)(Params) = scan_mma_kernel<MODE, TS, KMAX>;
  constexpr int QB = queries_per_block(KMAX);
  const int splits = QB == QT ? 1 : (p.qtile + QB - 1) / QB;
  const size_t smem = smem_bytes(KMAX, MmaBody<MODE, TS, KMAX>::WORK);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // all of the unified L1/shared memory as shared, so two blocks fit on an SM
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (blocks_per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, THREADS, smem);
  kernel<<<n_pairs * splits, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// Launches a row-map body (RowMap<int8_t> or RowMap<F32Mode>) over n_pairs
// pairs, or reports its blocks an SM; no tensor map: its producer gathers
template <typename TS>
cudaError_t launch_wgmma_rowmap(const Params& p, int n_pairs, cudaStream_t stream,
                                int* blocks_per_sm) {
  void (*kernel)(Params) = WRing<TS>::TERMS == 3 ? scan_wgmma_f32mode_rowmap_kernel
                                                 : scan_wgmma_rowmap_kernel;
  if (p.qd % WRing<TS>::QD_STEP != 0 || p.qd > WRing<TS>::MAX_QD) return cudaErrorInvalidValue;
  const size_t smem = wgmma_smem_bytes<TS>(p.qd);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (blocks_per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, W_THREADS, smem);
  if (p.row_ids == nullptr || reinterpret_cast<uintptr_t>(p.store) % 16 != 0 || p.d % 16 != 0)
    return cudaErrorInvalidValue;
  const int splits = (p.qtile + WRing<TS>::SLOTS - 1) / WRing<TS>::SLOTS;
  kernel<<<n_pairs * splits, W_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// the narrowest list that holds k
template <int MODE, typename TS>
cudaError_t launch(const Params& p, int n_pairs, cudaStream_t stream, int* blocks_per_sm) {
  if (p.k <= 32) return launch_width<MODE, TS, 32>(p, n_pairs, stream, blocks_per_sm);
  if (p.k <= 64) return launch_width<MODE, TS, 64>(p, n_pairs, stream, blocks_per_sm);
  if (p.k <= 128) return launch_width<MODE, TS, 128>(p, n_pairs, stream, blocks_per_sm);
  if (p.k <= 256) return launch_width<MODE, TS, 256>(p, n_pairs, stream, blocks_per_sm);
  if (p.k <= 512) return launch_width<MODE, TS, 512>(p, n_pairs, stream, blocks_per_sm);
  return launch_width<MODE, TS, MAX_K>(p, n_pairs, stream, blocks_per_sm);
}

// the body and instance of a mode over a store type: a wgmma body where
// the call is in its scope (wgmma_scope), else the mma.sync body's instance
cudaError_t dispatch(const Params& p, int mode, int store_type, int body, int n_pairs, int n_rows,
                     cudaStream_t s, int* blocks_per_sm) {
  if (body == BODY_WGMMA_INT8) return launch_wgmma<int8_t>(p, n_pairs, n_rows, s, blocks_per_sm);
  if (body == BODY_WGMMA_F32) return launch_wgmma<float>(p, n_pairs, n_rows, s, blocks_per_sm);
  if (body == BODY_WGMMA_F32MODE) return launch_wgmma<F32Mode>(p, n_pairs, n_rows, s, blocks_per_sm);
  if (body == BODY_WGMMA_F32X) return launch_wgmma<F32X>(p, n_pairs, n_rows, s, blocks_per_sm);
  if (body == BODY_WGMMA_S8) return launch_wgmma<S8Mode>(p, n_pairs, n_rows, s, blocks_per_sm);
  if (body == BODY_WGMMA_WIDE)
    return p.k <= 64 ? launch_wgmma<WideList<64>>(p, n_pairs, n_rows, s, blocks_per_sm)
                     : launch_wgmma<WideList<128>>(p, n_pairs, n_rows, s, blocks_per_sm);
  if (body == BODY_WGMMA_S8_WIDE)
    return p.k <= 64 ? launch_wgmma<S8WideList<64>>(p, n_pairs, n_rows, s, blocks_per_sm)
                     : launch_wgmma<S8WideList<128>>(p, n_pairs, n_rows, s, blocks_per_sm);
  if (body == BODY_WGMMA_F32MODE_WIDE)
    return p.k <= 64 ? launch_wgmma<F32ModeWideList<64>>(p, n_pairs, n_rows, s, blocks_per_sm)
                     : launch_wgmma<F32ModeWideList<128>>(p, n_pairs, n_rows, s, blocks_per_sm);
  if (body == BODY_WGMMA_F32_WIDE)
    return p.k <= 64 ? launch_wgmma<F32WideList<64>>(p, n_pairs, n_rows, s, blocks_per_sm)
                     : launch_wgmma<F32WideList<128>>(p, n_pairs, n_rows, s, blocks_per_sm);
  if (body == BODY_WGMMA_INT8_ROWMAP)
    return launch_wgmma_rowmap<RowMap<int8_t>>(p, n_pairs, s, blocks_per_sm);
  if (body == BODY_WGMMA_F32MODE_ROWMAP)
    return launch_wgmma_rowmap<RowMap<F32Mode>>(p, n_pairs, s, blocks_per_sm);
  if (mode == MODE_INT8 && store_type == STORE_INT8)
    return launch<MODE_INT8, int8_t>(p, n_pairs, s, blocks_per_sm);
  if (mode == MODE_F32) {
    if (store_type == STORE_F32) return launch<MODE_F32, float>(p, n_pairs, s, blocks_per_sm);
    if (store_type == STORE_BF16) return launch<MODE_F32, __nv_bfloat16>(p, n_pairs, s, blocks_per_sm);
    if (store_type == STORE_INT8) return launch<MODE_F32, int8_t>(p, n_pairs, s, blocks_per_sm);
  }
  if (mode == MODE_BF16) {
    if (store_type == STORE_F32) return launch<MODE_BF16, float>(p, n_pairs, s, blocks_per_sm);
    if (store_type == STORE_BF16) return launch<MODE_BF16, __nv_bfloat16>(p, n_pairs, s, blocks_per_sm);
    if (store_type == STORE_INT8) return launch<MODE_BF16, int8_t>(p, n_pairs, s, blocks_per_sm);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  mode: 0 f32, 1 bf16, 2 int8;
// store_type: 0 f32, 1 bf16, 2 int8.  row_ids (a virtual store: `store`
// is then the corpus and `scales` its row scales or null) and floor_d /
// floor_p (per (pair, query slot) floors) may each be null.  Queries,
// (n, nt·qd), zero-padded past d and 16-byte aligned:
//  * f32 mode over any store: bf16, nt 3, qd a multiple of 32 >= d: per
//    32-value depth slice the terms hi, mid, lo side by side
//    (ops/scan_kernel.py::operand_queries); where the call takes a wgmma
//    body in f32 mode (over an int8 packed store, k <= 128, an f32
//    packed store or a row map of an int8 corpus, k <= 32, ...), a
//    row is the three terms' planes hi, mid, lo, qd values each: qd is d
//    rounded up to W_QD_STEP (128) over an int8 store, each group of 64 in
//    WGMMA_ORDER, or to W_QD_STEP_F (64) over an f32 store, each group of
//    32 in WGMMA_F32_ORDER;
//  * bf16 mode: bf16, int8 mode: int8, nt 1, qd a multiple of 16 >= d;
//    where the call takes a wgmma body (wgmma_scope: bf16 over an int8
//    or an f32 packed store, k <= 128, or a row map of an int8 corpus,
//    k <= 32, int8
//    over an int8 packed store, k <= 128, ...), qd is d rounded up to
//    W_QD_STEP (128) over an int8 store, each group of 64 values in
//    WGMMA_ORDER (bf16) or WGMMA_S8_ORDER (int8), or
//    to W_QD_STEP_F (64) over an f32 store, each group of 32 values in
//    WGMMA_F32_ORDER (ops/scan_kernel.py).
// n_rows: the store's rows (the edge of its TMA tensor map; a row map's
// bodies read none).  *body: in,
// the body the queries are laid out for (enum Body: 0 the mma.sync body,
// 1 the wgmma body over an int8 store, 2 over an f32 store, 3 in f32 mode
// over an int8 store, 4 over an int8 store at list widths 64 and 128, 5 in
// f32 mode over an f32 store, 6 in int8 mode, 7 in int8 mode at list
// widths 64 and 128, 8 in f32 mode over an int8 store at list widths 64
// and 128, 9 over an f32 store at list widths 64 and 128, 10 over a row
// map of an int8 corpus, 11 in f32 mode over a row map of an int8 corpus,
// as lmi_scan_body named it);
// out, the body the call's scope picks.
// Where the two differ nothing launches and the call returns
// cudaErrorInvalidValue.  All other pointers are device pointers; nothing
// is allocated and nothing synchronizes.
int lmi_scan_pairs(const void* queries, const void* qscales, const void* qidx,
                   const void* pair_bucket, const void* pair_order, const void* ptr,
                   const void* chunk_of,
                   const void* store, const void* scales, const void* row_ids,
                   const void* floor_d, const void* floor_p, void* out_d, void* out_s,
                   int n_pairs, int qtile, int k, int d, int qd, int chunk, int mode,
                   int store_type, int n_rows, int* body, void* stream) {
  if (body == nullptr) return cudaErrorInvalidValue;
  const int laid_out = *body;
  *body = wgmma_scope(mode, store_type, k, d, store, row_ids, floor_d != nullptr);
  if (*body != laid_out) return cudaErrorInvalidValue;
  if (n_pairs <= 0) return cudaSuccess;
  if (qtile < 1 || qtile > QT || k < 1 || k > MAX_K || d < 1 || chunk < 1 || n_rows < 1)
    return cudaErrorInvalidValue;
  if (mode == MODE_INT8 && store_type != STORE_INT8) return cudaErrorInvalidValue;
  if ((floor_d == nullptr) != (floor_p == nullptr) || (row_ids == nullptr && scales == nullptr))
    return cudaErrorInvalidValue;
  const int q_group = mode == MODE_F32 ? 32 : 16;
  if (qd < d || qd % q_group != 0 || reinterpret_cast<uintptr_t>(queries) % 16 != 0)
    return cudaErrorInvalidValue;
  const size_t elem = store_type == STORE_F32 ? 4 : store_type == STORE_BF16 ? 2 : 1;
  const size_t row_bytes = size_t(d) * elem;
  int granule = 16;
  while (granule >= 4 &&
         (row_bytes % granule != 0 || reinterpret_cast<uintptr_t>(store) % granule != 0))
    granule /= 2;
  Params p{queries,
           static_cast<const float*>(qscales),
           static_cast<const int*>(qidx),
           static_cast<const int*>(pair_bucket),
           static_cast<const int*>(pair_order),
           static_cast<const int*>(ptr),
           static_cast<const int*>(chunk_of),
           store,
           static_cast<const float*>(scales),
           static_cast<const int*>(row_ids),
           static_cast<const float*>(floor_d),
           static_cast<const int*>(floor_p),
           static_cast<float*>(out_d),
           static_cast<int*>(out_s),
           qtile,
           k,
           d,
           qd,
           chunk,
           granule >= 4 ? granule : 0};
  return dispatch(p, mode, store_type, *body, n_pairs, n_rows, static_cast<cudaStream_t>(stream),
                  nullptr);
}

// What the wrapper needs to know of a launch at k, mode, store_type and d
// over `store` (and `row_ids`, null for a packed store; `floored`, under
// floors), the one place that decides it: *body the body the launch takes
// (wgmma_scope, enum Body), *qd the width of the query rows that body
// reads (d rounded up to W_QD_STEP or W_QD_STEP_F for a wgmma body, else
// to 16, or 32 in f32 mode; a row of an f32-mode body holds three terms
// of that width), *block_queries the query slots one
// of its blocks keeps, and *blocks how many of its blocks one SM holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor, with its shared
// memory): the card's slots for the split of the pairs into items.
// Returns a cudaError_t.
int lmi_scan_body(int k, int mode, int store_type, int d, const void* store, const void* row_ids,
                  int floored, int* body, int* qd, int* block_queries, int* blocks) {
  if (k < 1 || k > MAX_K || d < 1 || body == nullptr || qd == nullptr ||
      block_queries == nullptr || blocks == nullptr)
    return cudaErrorInvalidValue;
  *body = wgmma_scope(mode, store_type, k, d, store, row_ids, floored != 0);
  const bool wgmma = *body != BODY_MMA;
  const int q_group =
      *body == BODY_WGMMA_F32 || *body == BODY_WGMMA_F32X || *body == BODY_WGMMA_F32_WIDE
          ? W_QD_STEP_F
      : wgmma            ? W_QD_STEP
      : mode == MODE_F32 ? 32
                         : 16;
  *qd = (d + q_group - 1) / q_group * q_group;
  int width = 32;
  while (width < k) width *= 2;
  const bool wide =
      *body == BODY_WGMMA_WIDE || *body == BODY_WGMMA_S8_WIDE || *body == BODY_WGMMA_F32_WIDE;
  *block_queries = *body == BODY_WGMMA_F32MODE || *body == BODY_WGMMA_F32MODE_WIDE ||
                           *body == BODY_WGMMA_F32MODE_ROWMAP
                       ? WQ3
                   : *body == BODY_WGMMA_F32X  ? WQX
                   : wide                      ? W_WIDE_SLOTS
                   : wgmma                     ? WQ
                                               : queries_per_block(width);
  Params p{};
  p.k = k;
  p.qtile = QT;
  p.d = d;
  p.qd = *qd;
  return dispatch(p, mode, store_type, *body, 0, 1, nullptr, blocks);
}

}  // extern "C"
