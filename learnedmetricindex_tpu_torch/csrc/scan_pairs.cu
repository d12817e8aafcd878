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
//    Pallas kernel (scan_kernel.py:209-225);
//  * per query, the k smallest by (dist, position in the bucket's scan
//    order): rows arrive in scan order and a new row enters only if it
//    is strictly below the current k-th, so among equal distances the
//    earlier row and the earlier chunk win;
//  * output per pair is (qtile, k) ascending; slots −1 and dist +inf fill
//    what no row reached, and a pair whose bucket has no chunks, or a
//    padding query (qidx −1), gets only the fill.
//
// Compute modes: f32 (plain IEEE FMA, no TF32), bf16 (operands rounded
// with __float2bfloat16_rn, products summed in f32), int8 (int8 queries
// and store, __dp4a into int32 — exact).
//
// What bounds it on an H100: at the flagship shape (10M×768 int8 store,
// 120 buckets, 10k queries visiting 4) the scan is ~2.6e12 multiply-adds
// (3.2e12 with the query-tile padding) over the 7.7 GB of slabs read once
// per query tile of a bucket (~25 GB): 128 MAC per slab byte, far above
// the ~10 MAC/byte at which FP32 FMA on the CUDA cores meets 3.35 TB/s,
// so compute-bound.  This body runs on the CUDA cores (FP32 FMA, or DP4A
// for int8), a few % of the tensor-core rate.
//
// What the simple design leaves on the table, for later work:
//  * wgmma on the tensor cores (bf16, and int8 at 2x) instead of FMA/DP4A;
//  * TMA + an mbarrier ring so loads overlap the math: here a depth
//    step issues all of its global loads at once, then waits at a
//    barrier, stores them to shared memory and computes, so only the
//    other resident block hides the load latency;
//  * the query tile is reloaded from L2 for every row tile; a persistent
//    block holding it (int8/bf16 fit in shared memory) would not;
//  * one block per pair leaves the grid unbalanced when bucket sizes
//    differ: blocks start largest bucket first (pair_order), but the
//    largest bucket still sets the tail; splitting a bucket's chunks
//    over blocks needs a second merge pass;
//  * the count gate of the Pallas kernel (scan_kernel.py:279-309) is an
//    optimisation of its selection sweeps and has no counterpart here:
//    selection is a compare per element against the running k-th;
//  * the 128-wide query tile is padded for smaller qtile.
//
// List width: the running top-k lives in shared memory as KMAX x QB
// (dist, slot) pairs, KMAX the smallest of 32/64/128/256 that holds k.
// Up to KMAX 128 a block owns all QT = 128 queries of its pair (128 KB of
// lists at KMAX 128); at KMAX 256 the lists of 128 queries would take
// 256 KB, more than a block's 227 KB, so the pair's queries are split
// over QT/QB = 2 blocks of QB = 64 queries each.  Each block still
// computes the full 128-wide distance tile (the queries it does not own
// read as zeros and are never selected), so k > 128 costs twice the
// multiply-adds; each block owns whole queries, so nothing is merged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int QT = 128;       // query slots per block (qtile <= QT)
constexpr int RT = 128;       // store rows per tile
constexpr int MQ = 8;         // queries per thread
constexpr int MR = 8;         // rows per thread
constexpr int THREADS = (QT / MQ) * (RT / MR);  // 256
constexpr int KT = 32;        // depth step, f32/bf16 modes (floats)
constexpr int KW = 16;        // depth step, int8 mode (int8x4 words)
constexpr int QS = QT + 4;    // padded smem strides, 16-byte aligned rows
constexpr int XS = RT + 4;
constexpr int DS = RT + 1;    // distance tile stride: conflict-free rows

enum Mode { MODE_F32 = 0, MODE_BF16 = 1, MODE_INT8 = 2 };
enum StoreType { STORE_F32 = 0, STORE_BF16 = 1, STORE_INT8 = 2 };

struct Params {
  const void* queries;        // (n_queries, d) f32, or int8 in int8 mode
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
  int qtile, k, d, chunk;
};

// shared memory: [top-k dists][top-k slots][query rows][query scales]
//                [row slots][row scales][work: operand tiles | dist tile]
constexpr size_t kMetaBytes = size_t(2 * QT + 2 * RT) * 4;
constexpr size_t kOperandBytesF = size_t(KT) * (QS + XS) * 4;
constexpr size_t kOperandBytesI = size_t(KW) * (QS + XS) * 4;
constexpr size_t kDistBytes = size_t(QT) * DS * 4;
__host__ __device__ constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }
// queries whose lists a block keeps, for a list width
__host__ __device__ constexpr int queries_per_block(int kmax) { return kmax <= 128 ? QT : QT / 2; }
__host__ __device__ constexpr size_t smem_bytes(int kmax) {
  return 2 * size_t(kmax) * queries_per_block(kmax) * 4 + kMetaBytes +
         cmax(cmax(kOperandBytesF, kOperandBytesI), kDistBytes);
}
static_assert(smem_bytes(256) <= 232448, "lists must fit one block's shared memory");
static_assert(smem_bytes(128) <= 232448, "lists must fit one block's shared memory");

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

template <bool ROUND>
__device__ __forceinline__ float operand(float v) {
  return ROUND ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <int MODE, typename TS, int KMAX>
__global__ void __launch_bounds__(THREADS, KMAX == 32 ? 2 : 1) scan_pairs_kernel(Params p) {
  constexpr int QB = queries_per_block(KMAX);  // queries whose lists this block keeps
  constexpr int SPLITS = QT / QB;
  extern __shared__ __align__(16) unsigned char smem[];
  float* top_d = reinterpret_cast<float*>(smem);            // [KMAX][QB]
  int* top_s = reinterpret_cast<int*>(top_d + KMAX * QB);   // [KMAX][QB]
  int* q_row = top_s + KMAX * QB;                           // [QT]
  float* q_sc = reinterpret_cast<float*>(q_row + QT);       // [QT]
  int* r_slot = reinterpret_cast<int*>(q_sc + QT);          // [RT]
  float* r_sc = reinterpret_cast<float*>(r_slot + RT);      // [RT]
  unsigned char* work = reinterpret_cast<unsigned char*>(r_sc + RT);
  float* dist = reinterpret_cast<float*>(work);             // [QT][DS]

  const int tid = threadIdx.x;
  const int tq = tid / (RT / MR);  // query group: queries tq*MQ ..
  const int tr = tid % (RT / MR);  // row group: rows tr*MR ..
  const int qtile = p.qtile, k = p.k, d = p.d, chunk = p.chunk;
  const int splits = SPLITS == 1 ? 1 : (qtile + QB - 1) / QB;
  const int pair = p.pair_order[blockIdx.x / splits];
  const int q0 = (blockIdx.x % splits) * QB;  // first query this block owns
  const int bucket = p.pair_bucket[pair];
  const int c_lo = p.ptr[bucket], c_hi = p.ptr[bucket + 1];

  // compute slot q holds query q0 + q; slots past QB (split blocks) and
  // past qtile hold none
  for (int q = tid; q < QT; q += THREADS) {
    const int qi = (q < QB && q0 + q < qtile) ? p.qidx[(size_t)pair * qtile + q0 + q] : -1;
    q_row[q] = qi;
    q_sc[q] = (MODE == MODE_INT8 && qi >= 0) ? p.qscales[qi] : 1.0f;
  }
  for (int e = tid; e < k * QB; e += THREADS) {
    top_d[e] = CUDART_INF_F;
    top_s[e] = -1;
  }

  for (int c = c_lo; c < c_hi; ++c) {
    const int phys = p.chunk_of[c];
    for (int r0 = 0; r0 < chunk; r0 += RT) {
      const int nrows = min(RT, chunk - r0);
      __syncthreads();  // previous tile's selection is done with r_slot/dist
      for (int r = tid; r < RT; r += THREADS) {
        if (r < nrows) {
          const int slot = phys * chunk + r0 + r;
          r_slot[r] = slot;
          r_sc[r] = p.scales[slot];
        } else {
          r_slot[r] = -1;
          r_sc[r] = 0.0f;  // → +inf distance
        }
      }
      __syncthreads();  // the loads below read every row's slot

      float accf[MQ][MR];
      int acci[MQ][MR];
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int j = 0; j < MR; ++j) {
          accf[i][j] = 0.0f;
          acci[i][j] = 0;
        }

      if constexpr (MODE == MODE_INT8) {
        int* qs = reinterpret_cast<int*>(work);  // [KW][QS] int8x4 words
        int* xs = qs + KW * QS;                  // [KW][XS]
        const int dw = d / 4;
        const int* qwords = static_cast<const int*>(p.queries);
        const int* xwords = static_cast<const int*>(p.store);
        for (int w0 = 0; w0 < dw; w0 += KW) {
          // every load of the step is issued before the first store, so
          // their latencies overlap instead of adding up
          constexpr int LQ = QT * KW / THREADS, LX = RT * KW / THREADS;
          const int w = tid % KW, row0 = tid / KW;  // row = row0 + i*(THREADS/KW)
          const bool in_d = w0 + w < dw;
          int vq[LQ], vx[LX];
#pragma unroll
          for (int i = 0; i < LQ; ++i) {
            const int qi = q_row[row0 + i * (THREADS / KW)];
            vq[i] = (qi >= 0 && in_d) ? __ldg(&qwords[(size_t)qi * dw + w0 + w]) : 0;
          }
#pragma unroll
          for (int i = 0; i < LX; ++i) {
            const int slot = r_slot[row0 + i * (THREADS / KW)];
            vx[i] = (slot >= 0 && in_d) ? __ldg(&xwords[(size_t)slot * dw + w0 + w]) : 0;
          }
          __syncthreads();  // the previous step's compute is done with qs/xs
#pragma unroll
          for (int i = 0; i < LQ; ++i) qs[w * QS + row0 + i * (THREADS / KW)] = vq[i];
#pragma unroll
          for (int i = 0; i < LX; ++i) xs[w * XS + row0 + i * (THREADS / KW)] = vx[i];
          __syncthreads();
#pragma unroll 4
          for (int w = 0; w < KW; ++w) {
            const int4 a0 = *reinterpret_cast<const int4*>(&qs[w * QS + tq * MQ]);
            const int4 a1 = *reinterpret_cast<const int4*>(&qs[w * QS + tq * MQ + 4]);
            const int4 b0 = *reinterpret_cast<const int4*>(&xs[w * XS + tr * MR]);
            const int4 b1 = *reinterpret_cast<const int4*>(&xs[w * XS + tr * MR + 4]);
            const int a[MQ] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const int b[MR] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < MQ; ++i)
#pragma unroll
              for (int j = 0; j < MR; ++j) acci[i][j] = __dp4a(a[i], b[j], acci[i][j]);
          }
        }
      } else {
        constexpr bool ROUND = MODE == MODE_BF16;
        float* qs = reinterpret_cast<float*>(work);  // [KT][QS]
        float* xs = qs + KT * QS;                    // [KT][XS]
        const float* qf = static_cast<const float*>(p.queries);
        const TS* xf = static_cast<const TS*>(p.store);
        for (int k0 = 0; k0 < d; k0 += KT) {
          constexpr int LQ = QT * KT / THREADS, LX = RT * KT / THREADS;
          const int kk = tid % KT, row0 = tid / KT;  // row = row0 + i*(THREADS/KT)
          const bool in_d = k0 + kk < d;
          float vq[LQ], vx[LX];
#pragma unroll
          for (int i = 0; i < LQ; ++i) {
            const int qi = q_row[row0 + i * (THREADS / KT)];
            vq[i] = (qi >= 0 && in_d) ? __ldg(&qf[(size_t)qi * d + k0 + kk]) : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < LX; ++i) {
            const int slot = r_slot[row0 + i * (THREADS / KT)];
            vx[i] = (slot >= 0 && in_d) ? load_as_float<TS>(xf, (size_t)slot * d + k0 + kk) : 0.0f;
          }
          __syncthreads();  // the previous step's compute is done with qs/xs
#pragma unroll
          for (int i = 0; i < LQ; ++i) qs[kk * QS + row0 + i * (THREADS / KT)] = operand<ROUND>(vq[i]);
#pragma unroll
          for (int i = 0; i < LX; ++i) xs[kk * XS + row0 + i * (THREADS / KT)] = operand<ROUND>(vx[i]);
          __syncthreads();
#pragma unroll 4
          for (int kk = 0; kk < KT; ++kk) {
            const float4 a0 = *reinterpret_cast<const float4*>(&qs[kk * QS + tq * MQ]);
            const float4 a1 = *reinterpret_cast<const float4*>(&qs[kk * QS + tq * MQ + 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(&xs[kk * XS + tr * MR]);
            const float4 b1 = *reinterpret_cast<const float4*>(&xs[kk * XS + tr * MR + 4]);
            const float a[MQ] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[MR] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < MQ; ++i)
#pragma unroll
              for (int j = 0; j < MR; ++j) accf[i][j] = __fmaf_rn(a[i], b[j], accf[i][j]);
          }
        }
      }

      __syncthreads();  // operand tiles share memory with the distance tile
#pragma unroll
      for (int i = 0; i < MQ; ++i) {
        const int q = tq * MQ + i;
#pragma unroll
        for (int j = 0; j < MR; ++j) {
          const int r = tr * MR + j;
          const float s = r_sc[r];
          const float raw = MODE == MODE_INT8 ? static_cast<float>(acci[i][j]) : accf[i][j];
          float v = __fmul_rn(raw, -s);
          if (MODE == MODE_INT8) v = __fmul_rn(v, q_sc[q]);
          dist[q * DS + r] = __fadd_rn(v, s == 0.0f ? CUDART_INF_F : 1.0f);
        }
      }
      __syncthreads();

      // selection: one thread per query, rows in scan order
      if (tid < QB && q_row[tid] >= 0) {
        const int q = tid;
        float worst = top_d[(k - 1) * QB + q];
        for (int r = 0; r < nrows; ++r) {
          const float v = dist[q * DS + r];
          if (v < worst) {
            int j = k - 1;
            while (j > 0) {
              const float u = top_d[(j - 1) * QB + q];
              if (u <= v) break;
              top_d[j * QB + q] = u;
              top_s[j * QB + q] = top_s[(j - 1) * QB + q];
              --j;
            }
            top_d[j * QB + q] = v;
            top_s[j * QB + q] = r_slot[r];
            worst = top_d[(k - 1) * QB + q];
          }
        }
      }
    }
  }

  __syncthreads();
  const int n_own = min(QB, qtile - q0);
  const size_t out0 = ((size_t)pair * qtile + q0) * k;
  for (int e = tid; e < n_own * k; e += THREADS) {
    const int q = e / k, j = e % k;
    p.out_d[out0 + e] = top_d[j * QB + q];
    p.out_s[out0 + e] = top_s[j * QB + q];
  }
}

template <int MODE, typename TS, int KMAX>
cudaError_t launch_width(const Params& p, int n_pairs, cudaStream_t stream) {
  auto kernel = scan_pairs_kernel<MODE, TS, KMAX>;
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
// store_type: 0 f32, 1 bf16, 2 int8.  All pointers are device pointers;
// nothing is allocated and nothing synchronizes.
int lmi_scan_pairs(const void* queries, const void* qscales, const void* qidx,
                   const void* pair_bucket, const void* pair_order, const void* ptr,
                   const void* chunk_of,
                   const void* store, const void* scales, void* out_d, void* out_s,
                   int n_pairs, int qtile, int k, int d, int chunk, int mode, int store_type,
                   void* stream) {
  if (n_pairs <= 0) return cudaSuccess;
  if (qtile < 1 || qtile > QT || k < 1 || k > 256 || d < 1 || chunk < 1)
    return cudaErrorInvalidValue;
  if (mode == MODE_INT8 && (store_type != STORE_INT8 || d % 4 != 0)) return cudaErrorInvalidValue;
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
           chunk};
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
