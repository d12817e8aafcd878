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
// running top-k in shared memory.
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
// What bounds it on an H100.  At the flagship shape (10M×768 int8 store,
// 120 buckets, 10k queries visiting 4, k_scan 16) the scan is ~2.6e12
// multiply-adds (3.2e12 with the query-tile padding) over at most the
// 7.7 GB store: in bf16 on the tensor cores 5.2e12 FLOP / 989 TFLOP/s
// ≈ 5.3 ms against ≤ 7.7 GB / 3.35 TB/s ≈ 2.3 ms of memory, so
// compute-bound; int8 ≈ 2.6 ms; f32 must stay IEEE on the CUDA cores,
// 5.2e12 / 67 TFLOP/s ≈ 78 ms.  The first kernel ran all three modes on
// the CUDA cores (FP32 FMA, DP4A for int8): 257–354 ms bf16 and 84–119 ms
// int8, 1.5–3% of their bound.
//
// The design.
//  * bf16 and int8 run on the tensor cores: warp-level
//    mma.sync.m16n8k16 bf16→f32 and m16n8k32 s8→s32 (exact, so int8 stays
//    bit-equal to the plain version).  A block computes a 128-query ×
//    128-row distance tile with 8 warps of 64 × 32 (4 m-tiles × 4
//    n-tiles, 64 accumulators a thread).  64 × 32 rather than 32 × 64:
//    every B fragment (a store row slice, widened from int8 to bf16 in
//    registers on the main path) then feeds four mma, so the widening
//    costs a quarter of what it would with 2 m-tiles.
//  * Operands sit in shared memory in their storage type (bf16 or int8),
//    fed by a 3-stage cp.async ring of 64-byte depth slices of the query
//    tile and of the row tile (`commit_group`/`wait_group`: the copies
//    for step s+1 and s+2 are in flight while step s computes) and read
//    with ldmatrix.  Rows are padded to 80 (48) bytes so that the eight
//    16-byte rows of an ldmatrix land on distinct banks.  A copy past d,
//    past the chunk's last row or of a padding query is zero-filled
//    (src-size 0), never skipped.  Store rows that are not 16-byte
//    aligned (d·size % 16 != 0, e.g. d = 100 int8) are copied 8 or 4
//    bytes at a time through the same ring; rows of fewer than 4-byte
//    granules, and f32 rows in bf16 mode (rounded to bf16 with
//    __float2bfloat16_rn), are staged through registers into the ring.
//  * Queries: the wrapper rounds them to bf16 once per call (bits equal
//    to __float2bfloat16_rn) or passes the int8 rows, zero-padded to a
//    multiple of 16 elements.  bf16 over an int8 store (the main path):
//    the store stays int8 in shared memory; ldmatrix hands each thread 4
//    consecutive int8 values of a row, which widen exactly to two bf16x2
//    B registers holding k' = (2t, 2t+1) and (2t+8, 2t+9) of a 16-deep
//    step.  That is a fixed permutation of the 16 depths, so the wrapper
//    permutes each 16-element group of the bf16 queries the same way
//    (WIDEN_ORDER in ops/scan_kernel.py) and the products pair up.  The
//    queries are never quantized.
//  * The ring shares the distance tile's shared memory and drains at the
//    end of every row tile; at list width 32 (the flagship) a block takes
//    ~100 KB, so two blocks share an SM and one block's epilogue and
//    selection overlap the other's mma.  (One block an SM with a deeper
//    ring that never drains was slower: the selection then stalls the
//    tensor cores.)
//  * f32 keeps the CUDA-core body (IEEE FMA, 8 × 8 outputs a thread,
//    operands staged as f32): the tensor cores have no IEEE f32, and TF32
//    is not allowed on this path.
//  * Selection, the same rule for every mode.  The epilogue writes the
//    f32 distance tile [row][query] and marks, per query and 32-row
//    group, whether any distance lies below the query's current k-th:
//    after the first tiles of a bucket almost nothing does, and unmarked
//    groups are skipped.  Lists of width 32 (k <= 32, the flagship) live
//    query-major; a warp takes one query at a time with its list in the
//    lanes, finds a marked group's candidates with one ballot and inserts
//    each with a ballot (its rank) and two shuffles, in scan order.  One
//    thread per query, inserting by shifting its list in shared memory,
//    serialises a warp on every row where any of its 32 queries inserts,
//    a large share of the int8 scan's time at the flagship; it is kept
//    only for the wider lists (k > 32).
//
// What is left for later work:
//  * wgmma with TMA loads from a producer warp (mma.sync does not reach
//    the card's dense tensor rate), and a persistent or resident query
//    tile (it is reloaded from L2 for every row tile, half of the bytes a
//    tile moves in int8 mode);
//  * splitting buckets over blocks: one block per pair, started largest
//    bucket first (pair_order), but the largest bucket (~157k–162k rows
//    at the flagship) still sets the tail; a split needs a merge pass;
//  * k > 128 computes the distance tile twice (see below);
//  * the count gate of the Pallas kernel is an optimisation of its
//    selection sweeps; the group marks above play its part here.
//
// Shared memory per list width (KMAX, the smallest of 32/64/128/256 that
// holds k): lists 2·KMAX·QB·4 B + 2,560 B of row and query metadata and
// group marks + the 67,584 B distance tile, which the ring (3 × 20,480 B
// at most) and the f32 body's operand tiles (33,792 B) reuse:
//   KMAX  32:  32,768 + 2,560 + 67,584 = 102,912 B (two blocks an SM)
//   KMAX  64:  65,536 + 2,560 + 67,584 = 135,680 B
//   KMAX 128: 131,072 + 2,560 + 67,584 = 201,216 B
//   KMAX 256: 131,072 + 2,560 + 67,584 = 201,216 B (QB = 64)
// Up to KMAX 128 a block owns all QT = 128 queries of its pair; at 256
// the lists of 128 queries would take 256 KB, more than a block's 227 KB,
// so the pair's queries are split over QT/QB = 2 blocks of QB = 64.  Each
// block still computes the full 128-wide distance tile (the queries it
// does not own read as zeros and are never selected), so k > 128 costs
// twice the multiply-adds; each block owns whole queries, so nothing is
// merged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int QT = 128;       // query slots per block (qtile <= QT)
constexpr int RT = 128;       // store rows per tile
constexpr int THREADS = 256;
// distance tile [RT][DQ], row-major by store row: DQ ≡ 4 (mod 32) banks,
// so both the mma epilogue's stores and the selection's loads (32
// queries of one row) are conflict-free
constexpr int DQ = QT + 4;
constexpr int GROUPS = RT / 32;  // 32-row groups of a tile, one per warp column

// f32 body: 8 × 8 outputs a thread, 32-deep steps of f32 operands
constexpr int MQ = 8;
constexpr int MR = 8;
constexpr int KT = 32;
constexpr int QS = QT + 4;    // padded smem strides, 16-byte aligned rows
constexpr int XS = RT + 4;

// tensor-core bodies: a STAGES-deep ring of KB-byte slices of each query
// row (bf16: 32 values, int8: 64) and of each store row
constexpr int KB = 64;
constexpr int STAGES = 3;
constexpr int SA = KB + 16;   // query row stride in a stage (bytes)
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS == 8 * 32 && QT == 2 * 64 && RT == 4 * 32, "8 warps of 64 x 32");

enum Mode { MODE_F32 = 0, MODE_BF16 = 1, MODE_INT8 = 2 };
enum StoreType { STORE_F32 = 0, STORE_BF16 = 1, STORE_INT8 = 2 };

struct Params {
  const void* queries;        // (n_queries, qd): f32 (f32 mode), bf16 or int8
  const float* qscales;       // (n_queries,) f32, int8 mode only
  const int* qidx;            // (n_pairs*qtile,) query row per slot, -1 = pad
  const int* pair_bucket;     // (n_pairs,)
  const int* pair_order;      // (n_pairs,) pair of each block, largest bucket first
  const int* ptr;             // (n_buckets+1,) chunk CSR
  const int* chunk_of;        // CSR position -> physical chunk
  const void* store;          // (n_slots, d)
  const float* scales;        // (n_slots,) f32, 0 = padding slot
  float* out_d;               // (n_pairs, qtile, k)
  int* out_s;                 // (n_pairs, qtile, k)
  int qtile, k, d, qd, chunk;
  int copy_bytes;             // cp.async granule of store rows (16/8/4), 0 = via registers
};

// store-row bytes of a stage: KB, or KB/2 where int8 rows meet bf16
// queries (WIDEN: 32 int8 values, widened in registers)
__host__ __device__ constexpr int b_stage_bytes(bool widen) { return widen ? KB / 2 : KB; }
__host__ __device__ constexpr int b_stride(bool widen) { return b_stage_bytes(widen) + 16; }
__host__ __device__ constexpr size_t stage_bytes(bool widen) {
  return size_t(QT) * SA + size_t(RT) * b_stride(widen);
}

constexpr size_t kMetaBytes = size_t(3 * QT + 2 * RT) * 4;
constexpr size_t kDistBytes = size_t(RT) * DQ * 4;
constexpr size_t kF32OperandBytes = size_t(KT) * (QS + XS) * 4;
static_assert(STAGES * stage_bytes(false) <= kDistBytes && kF32OperandBytes <= kDistBytes,
              "the ring and the f32 operand tiles reuse the distance tile's memory");

// queries whose lists a block keeps, for a list width
__host__ __device__ constexpr int queries_per_block(int kmax) { return kmax <= 128 ? QT : QT / 2; }
__host__ __device__ constexpr size_t smem_bytes(int kmax) {
  return 2 * size_t(kmax) * queries_per_block(kmax) * 4 + kMetaBytes + kDistBytes;
}
static_assert(smem_bytes(256) <= 232448 && smem_bytes(128) <= 232448,
              "lists must fit one block's shared memory");
// blocks an SM at a list width (228 KB an SM, 1 KB of it reserved per block)
__host__ __device__ constexpr int blocks_per_sm(int kmax) { return kmax == 32 ? 2 : 1; }
static_assert(2 * (smem_bytes(32) + 1024) <= 233472, "two blocks an SM at list width 32");

template <int KMAX>
struct Smem {
  static constexpr int QB = queries_per_block(KMAX);
  float* top_d;         // KMAX·QB running top-k distances, entry at(q, i)
  int* top_s;           // KMAX·QB their slots
  int* q_row;           // [QT] query row of compute slot q, -1 = none
  float* q_sc;          // [QT]
  int* r_slot;          // [RT] slot of the tile's row r, -1 = past the chunk
  float* r_sc;          // [RT]
  unsigned* q_grp;      // [QT] byte g set: row group g of this tile may enter q's list
  unsigned char* work;  // distance tile [RT][DQ] | ring | f32 operand tiles
  __device__ explicit Smem(unsigned char* base) {
    top_d = reinterpret_cast<float*>(base);
    top_s = reinterpret_cast<int*>(top_d + KMAX * QB);
    q_row = top_s + KMAX * QB;
    q_sc = reinterpret_cast<float*>(q_row + QT);
    r_slot = reinterpret_cast<int*>(q_sc + QT);
    r_sc = reinterpret_cast<float*>(r_slot + RT);
    q_grp = reinterpret_cast<unsigned*>(r_sc + RT);
    work = reinterpret_cast<unsigned char*>(q_grp + QT);
  }
  __device__ float* dist() const { return reinterpret_cast<float*>(work); }
  // lists of width 32 are kept query-major, one list per warp's lanes
  // (select_tile_warp); wider ones entry-major, one list per thread
  static constexpr bool WARP_LISTS = KMAX == 32;
  __device__ static int at(int q, int i) { return WARP_LISTS ? q * KMAX + i : i * QB + q; }
  // the current k-th distance of compute slot q; -inf for a slot this
  // block does not own, so nothing of it is ever a candidate
  __device__ float kth(int k, int q) const { return q < QB ? top_d[at(q, k - 1)] : -CUDART_INF_F; }
  // row group `group` of this tile holds a candidate of compute slot q
  __device__ void mark(int q, int group) const {
    reinterpret_cast<unsigned char*>(q_grp)[q * 4 + group] = 1;
  }
};

struct Pair {
  int pair, q0, c_lo, c_hi;
};

// The block's pair, its query slots and empty lists.  Compute slot q
// holds query q0 + q; slots past QB (split blocks) and past qtile hold
// none.
template <int KMAX, bool INT8>
__device__ Pair begin_pair(const Params& p, const Smem<KMAX>& s) {
  constexpr int QB = Smem<KMAX>::QB;
  const int splits = QB == QT ? 1 : (p.qtile + QB - 1) / QB;
  Pair b;
  b.pair = p.pair_order[blockIdx.x / splits];
  b.q0 = (blockIdx.x % splits) * QB;
  const int bucket = p.pair_bucket[b.pair];
  b.c_lo = p.ptr[bucket];
  b.c_hi = p.ptr[bucket + 1];
  for (int q = threadIdx.x; q < QT; q += THREADS) {
    const int qi =
        (q < QB && b.q0 + q < p.qtile) ? p.qidx[(size_t)b.pair * p.qtile + b.q0 + q] : -1;
    s.q_row[q] = qi;
    s.q_sc[q] = (INT8 && qi >= 0) ? p.qscales[qi] : 1.0f;
    s.q_grp[q] = 0;
  }
  for (int e = threadIdx.x; e < KMAX * QB; e += THREADS) {
    s.top_d[e] = CUDART_INF_F;
    s.top_s[e] = -1;
  }
  return b;
}

template <int KMAX>
__device__ void load_row_meta(const Params& p, const Smem<KMAX>& s, int phys, int r0, int nrows) {
  for (int r = threadIdx.x; r < RT; r += THREADS) {
    if (r < nrows) {
      const int slot = phys * p.chunk + r0 + r;
      s.r_slot[r] = slot;
      s.r_sc[r] = p.scales[slot];
    } else {
      s.r_slot[r] = -1;
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

// One thread per query, the tile's rows in scan order, only in the row
// groups that the epilogue marked: a group holds a candidate of query q
// iff one of its distances is below q's k-th as it stood before this
// tile, and the k-th only falls during selection, so an unmarked group
// has no row that could enter.  Distances are read 16 at a time into
// registers first: the list updates are shared-memory stores, and reads
// issued one row at a time behind them would each wait their full
// latency.
template <int KMAX>
__device__ void select_tile_thread(const Params& p, const Smem<KMAX>& s, int nrows) {
  constexpr int QB = Smem<KMAX>::QB;
  constexpr int BATCH = 16;
  const int q = threadIdx.x;
  if (q >= QB) return;
  const unsigned groups = s.q_grp[q];
  if (groups == 0) return;
  s.q_grp[q] = 0;
  if (s.q_row[q] < 0) return;
  const int k = p.k;
  const float* dist = s.dist();
  float worst = s.top_d[s.at(q, k - 1)];
  for (int group = 0; group < GROUPS; ++group) {
    if (((groups >> (8 * group)) & 0xffu) == 0) continue;
    for (int r0 = group * 32; r0 < group * 32 + 32; r0 += BATCH) {
      float v[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) v[j] = r0 + j < nrows ? dist[(r0 + j) * DQ + q] : CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        if (v[j] < worst) {
          int i = k - 1;
          while (i > 0) {
            const float u = s.top_d[s.at(q, i - 1)];
            if (u <= v[j]) break;
            s.top_d[s.at(q, i)] = u;
            s.top_s[s.at(q, i)] = s.top_s[s.at(q, i - 1)];
            --i;
          }
          s.top_d[s.at(q, i)] = v[j];
          s.top_s[s.at(q, i)] = s.r_slot[r0 + j];
          worst = s.top_d[s.at(q, k - 1)];
        }
      }
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
__device__ void select_tile_warp(const Params& p, const Smem<KMAX>& s, int nrows) {
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
      const float v = r < nrows ? dist[r * DQ + q] : CUDART_INF_F;
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

template <int KMAX>
__device__ void select_tile(const Params& p, const Smem<KMAX>& s, int nrows) {
  if constexpr (Smem<KMAX>::WARP_LISTS) {
    select_tile_warp(p, s, nrows);
  } else {
    select_tile_thread(p, s, nrows);
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
// f32 mode: the CUDA-core IEEE FMA body
// ---------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ float load_as_float(const T* p, size_t i);
template <>
__device__ __forceinline__ float load_as_float<float>(const float* p, size_t i) {
  return p[i];
}
template <>
__device__ __forceinline__ float load_as_float<__nv_bfloat16>(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
template <>
__device__ __forceinline__ float load_as_float<int8_t>(const int8_t* p, size_t i) {
  return static_cast<float>(p[i]);
}

template <typename TS, int KMAX>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(KMAX)) scan_f32_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<KMAX> s(smem);
  const Pair b = begin_pair<KMAX, false>(p, s);
  const int tid = threadIdx.x;
  const int tq = tid / (RT / MR);  // query group: queries tq*MQ ..
  const int tr = tid % (RT / MR);  // row group: rows tr*MR ..
  const int d = p.d, chunk = p.chunk;
  float* qs = reinterpret_cast<float*>(s.work);  // [KT][QS]
  float* xs = qs + KT * QS;                      // [KT][XS]
  float* dist = s.dist();
  const float* qf = static_cast<const float*>(p.queries);
  const TS* xf = static_cast<const TS*>(p.store);

  for (int c = b.c_lo; c < b.c_hi; ++c) {
    const int phys = p.chunk_of[c];
    for (int r0 = 0; r0 < chunk; r0 += RT) {
      const int nrows = min(RT, chunk - r0);
      __syncthreads();  // previous tile's selection is done with r_slot/dist
      load_row_meta(p, s, phys, r0, nrows);
      __syncthreads();  // the loads below read every row's slot

      float acc[MQ][MR];
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int j = 0; j < MR; ++j) acc[i][j] = 0.0f;

      for (int k0 = 0; k0 < d; k0 += KT) {
        // every load of the step is issued before the first store, so
        // their latencies overlap instead of adding up
        constexpr int LQ = QT * KT / THREADS, LX = RT * KT / THREADS;
        const int kk = tid % KT, row0 = tid / KT;  // row = row0 + i*(THREADS/KT)
        const bool in_d = k0 + kk < d;
        float vq[LQ], vx[LX];
#pragma unroll
        for (int i = 0; i < LQ; ++i) {
          const int qi = s.q_row[row0 + i * (THREADS / KT)];
          vq[i] = (qi >= 0 && in_d) ? __ldg(&qf[(size_t)qi * d + k0 + kk]) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < LX; ++i) {
          const int slot = s.r_slot[row0 + i * (THREADS / KT)];
          vx[i] = (slot >= 0 && in_d) ? load_as_float<TS>(xf, (size_t)slot * d + k0 + kk) : 0.0f;
        }
        __syncthreads();  // the previous step's compute is done with qs/xs
#pragma unroll
        for (int i = 0; i < LQ; ++i) qs[kk * QS + row0 + i * (THREADS / KT)] = vq[i];
#pragma unroll
        for (int i = 0; i < LX; ++i) xs[kk * XS + row0 + i * (THREADS / KT)] = vx[i];
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < KT; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(&qs[kk * QS + tq * MQ]);
          const float4 a1 = *reinterpret_cast<const float4*>(&qs[kk * QS + tq * MQ + 4]);
          const float4 b0 = *reinterpret_cast<const float4*>(&xs[kk * XS + tr * MR]);
          const float4 b1 = *reinterpret_cast<const float4*>(&xs[kk * XS + tr * MR + 4]);
          const float a[MQ] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bb[MR] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < MQ; ++i)
#pragma unroll
            for (int j = 0; j < MR; ++j) acc[i][j] = __fmaf_rn(a[i], bb[j], acc[i][j]);
        }
      }

      __syncthreads();  // operand tiles share memory with the distance tile
#pragma unroll
      for (int i = 0; i < MQ; ++i) {
        const int q = tq * MQ + i;
        const float worst = s.kth(p.k, q);
        bool hit = false;
#pragma unroll
        for (int j = 0; j < MR; ++j) {
          const int r = tr * MR + j;
          const float v = distance<false>(acc[i][j], s.r_sc[r], 1.0f);
          dist[r * DQ + q] = v;
          hit |= v < worst;
        }
        if (hit) s.mark(q, tr * MR / 32);
      }
      __syncthreads();
      select_tile(p, s, nrows);
    }
  }
  write_out(p, s, b);
}

// ---------------------------------------------------------------------
// bf16 and int8 modes: mma.sync on the tensor cores, cp.async ring
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

template <int MODE, typename TS, int KMAX>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(KMAX)) scan_mma_kernel(Params p) {
  constexpr bool INT8 = MODE == MODE_INT8;
  constexpr bool WIDEN = !INT8 && std::is_same<TS, int8_t>::value;   // int8 rows, bf16 queries
  constexpr bool CONVERT = std::is_same<TS, float>::value;           // f32 rows → bf16 stage
  // the stage's store type: int8 (int8 mode, WIDEN), bf16 bits otherwise
  using TD = std::conditional_t<INT8 || WIDEN, int8_t, uint16_t>;
  using Acc = std::conditional_t<INT8, int, float>;
  constexpr int A_ELEM = INT8 ? 1 : 2;  // bytes per query value
  constexpr int KE = KB / A_ELEM;       // depth values per stage
  constexpr int KBB = b_stage_bytes(WIDEN);
  constexpr int SB = b_stride(WIDEN);
  constexpr int STAGE = int(stage_bytes(WIDEN));
  static_assert(KBB == KE * int(sizeof(TD)), "a stage holds the same depths of both operands");
  static_assert(!INT8 || std::is_same<TS, int8_t>::value, "int8 mode reads an int8 store");

  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<KMAX> s(smem);
  const Pair b = begin_pair<KMAX, INT8>(p, s);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wq = warp >> 2;  // queries wq*64 ..
  const int wr = warp & 3;   // rows wr*32 ..
  const int d = p.d, chunk = p.chunk;
  const int nsteps = (d + KE - 1) / KE;
  const size_t q_row_bytes = size_t(p.qd) * A_ELEM;
  const size_t x_row_bytes = size_t(d) * sizeof(TS);
  const unsigned char* qbytes = static_cast<const unsigned char*>(p.queries);
  const unsigned char* xbytes = static_cast<const unsigned char*>(p.store);
  float* dist = s.dist();

  // One stage: KB bytes of each query row and KBB bytes of each store row
  // of depth step `step`, all copies issued by all threads.
  auto load_stage = [&](int step, int buf, int phys, int r0, int nrows) {
    unsigned char* a = s.work + buf * STAGE;
    unsigned char* x = a + QT * SA;
    const int e0 = step * KE;
    static_assert((QT * KB / 16) % THREADS == 0 && (RT * KBB / 16) % THREADS == 0, "whole rounds");
#pragma unroll
    for (int j = 0; j < QT * KB / 16 / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int row = i / (KB / 16), c16 = i % (KB / 16);
      const int qi = s.q_row[row];
      const size_t off = size_t(e0) * A_ELEM + c16 * 16;
      const bool ok = qi >= 0 && off < q_row_bytes;
      cp_async16(a + row * SA + c16 * 16, qbytes + (ok ? size_t(qi) * q_row_bytes + off : 0), ok);
    }
#pragma unroll
    for (int j = 0; j < RT * KBB / 16 / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int r = i / (KBB / 16), c16 = i % (KBB / 16);
      const bool live = r < nrows;
      const size_t slot = size_t(phys) * chunk + r0 + r;
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
      for (int st = 0; st < STAGES - 1; ++st) {
        if (st < nsteps) load_stage(st, st, phys, r0, nrows);
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
        if (next < nsteps) load_stage(next, next % STAGES, phys, r0, nrows);
        cp_async_commit();

        const unsigned char* a = s.work + (step % STAGES) * STAGE;
        const uint32_t a_base = smem_u32(a) + (wq * 64 + a_row) * SA + a_col;
        const uint32_t b_base = smem_u32(a + QT * SA) + (wr * 32 + b_row) * SB + b_col;
        if constexpr (WIDEN) {
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
#pragma unroll
              for (int mi = 0; mi < 4; ++mi) {
                uint32_t af[4];
                ldmatrix_x4(af, a_base + mi * 16 * SA + (2 * h + sub) * 32);
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], af, bf[ni]);
              }
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
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) {
              uint32_t af[4];
              ldmatrix_x4(af, a_base + mi * 16 * SA + sub * 32);
#pragma unroll
              for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], af, bf[ni]);
            }
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
          worst[mi][h] = s.kth(p.k, q);
        }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
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
      select_tile(p, s, nrows);
    }
  }
  write_out(p, s, b);
}

template <int MODE, typename TS, int KMAX>
cudaError_t launch_width(const Params& p, int n_pairs, cudaStream_t stream) {
  void (*kernel)(Params);
  if constexpr (MODE == MODE_F32) {
    kernel = scan_f32_kernel<TS, KMAX>;
  } else {
    kernel = scan_mma_kernel<MODE, TS, KMAX>;
  }
  constexpr int QB = queries_per_block(KMAX);
  const int splits = QB == QT ? 1 : (p.qtile + QB - 1) / QB;
  constexpr size_t smem = smem_bytes(KMAX);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // all of the unified L1/shared memory as shared, so two blocks fit on an SM
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<n_pairs * splits, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// the narrowest list that holds k
template <int MODE, typename TS>
cudaError_t launch(const Params& p, int n_pairs, cudaStream_t stream) {
  if (p.k <= 32) return launch_width<MODE, TS, 32>(p, n_pairs, stream);
  if (p.k <= 64) return launch_width<MODE, TS, 64>(p, n_pairs, stream);
  if (p.k <= 128) return launch_width<MODE, TS, 128>(p, n_pairs, stream);
  return launch_width<MODE, TS, 256>(p, n_pairs, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  mode: 0 f32, 1 bf16, 2 int8;
// store_type: 0 f32, 1 bf16, 2 int8.  Queries: (n, qd) f32 with qd == d
// in f32 mode; bf16 (bf16 mode) or int8 (int8 mode) rows zero-padded to
// qd, a multiple of 16, 16-byte aligned.  All pointers are device
// pointers; nothing is allocated and nothing synchronizes.
int lmi_scan_pairs(const void* queries, const void* qscales, const void* qidx,
                   const void* pair_bucket, const void* pair_order, const void* ptr,
                   const void* chunk_of,
                   const void* store, const void* scales, void* out_d, void* out_s,
                   int n_pairs, int qtile, int k, int d, int qd, int chunk, int mode,
                   int store_type, void* stream) {
  if (n_pairs <= 0) return cudaSuccess;
  if (qtile < 1 || qtile > QT || k < 1 || k > 256 || d < 1 || chunk < 1)
    return cudaErrorInvalidValue;
  if (mode == MODE_INT8 && (store_type != STORE_INT8 || d % 4 != 0)) return cudaErrorInvalidValue;
  if (mode == MODE_F32 ? qd != d
                       : (qd < d || qd % 16 != 0 || reinterpret_cast<uintptr_t>(queries) % 16 != 0))
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
           static_cast<float*>(out_d),
           static_cast<int*>(out_s),
           qtile,
           k,
           d,
           qd,
           chunk,
           granule >= 4 ? granule : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == MODE_INT8) return launch<MODE_INT8, int8_t>(p, n_pairs, s);
  if (mode == MODE_F32) {
    if (store_type == STORE_F32) return launch<MODE_F32, float>(p, n_pairs, s);
    if (store_type == STORE_BF16) return launch<MODE_F32, __nv_bfloat16>(p, n_pairs, s);
    if (store_type == STORE_INT8) return launch<MODE_F32, int8_t>(p, n_pairs, s);
  }
  if (mode == MODE_BF16) {
    if (store_type == STORE_F32) return launch<MODE_BF16, float>(p, n_pairs, s);
    if (store_type == STORE_BF16) return launch<MODE_BF16, __nv_bfloat16>(p, n_pairs, s);
    if (store_type == STORE_INT8) return launch<MODE_BF16, int8_t>(p, n_pairs, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
