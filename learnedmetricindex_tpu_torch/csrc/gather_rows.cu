// Row gathers for Hopper (sm_90a), bit for bit (the copies move words, so
// f32 NaN payloads and -0.0 survive):
//  * lmi_gather_rows:  out[i, :] = table[clamp(idx[i], 0, n-1), :] for any
//    row type whose rows are a whole number of 4-byte words;
//  * lmi_gather_pairs: the search merge's gather of the scan's (n, k)
//    candidate tables, distances (f32) and slots (int32) in one pass:
//    out_d[i, :], out_s[i, :] = cand_d[r, :], cand_s[r, :] with r =
//    clamp(rows[i], 0, n-1), or +inf and -1 where rows[i] < 0.  out_* are
//    (Q, V·k) row-major, i.e. (m, k) with m = Q·V.
//
// Replaces the TPU kernels of learnedmetricindex_tpu/ops/gather_kernel.py
// (_gather_rows_impl with the bodies _vmem_gather_kernel and
// _hbm_gather_kernel, entry gather_rows), which the JAX package calls for
// its work queries and for the merge (_merge_pairs_dense, one gather of
// both tables interleaved through an int32 bit view).  Those work around
// Mosaic: a VMEM-resident table under a 64 MB budget or a ring of 8-row
// aligned block DMAs with a one-hot row extraction, packed dtypes through
// an int32 bit view, indices scalar-prefetched into SMEM and padded to
// whole 512-row blocks.  None of that carries over: here each group of
// lanes reads its own index, clamps it and copies one row with vector
// loads, straight from device memory to device memory.  The port's scan
// reads the work queries through its index, so the search gathers only
// the merge's candidates (lmi_gather_pairs); the mask is written in the
// same pass rather than by two more elementwise launches.
//
// What bounds it on an H100: it is a pure copy, 2·m·row_bytes bytes (plus
// the indices) against 3.35 TB/s; no arithmetic, no reuse, so no shared
// memory.  At the search's merge (40,000 rows of 16 candidates) that is
// 10 MB, ~3 µs: the launch and the host's call cost more.  The design
// keeps every load 16 bytes wide where the row bytes and the pointers
// allow (4-byte words otherwise), and sizes the lanes per row to the row
// so a narrow row (a 16-wide candidate list is 4 vectors) does not leave
// most of a warp idle: LANES is the smallest power of two >= the row's
// vectors, at most 32, and a block of 256 threads copies 256/LANES rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename V, typename I>
__global__ void __launch_bounds__(THREADS) gather_rows_kernel(
    const V* __restrict__ table, const I* __restrict__ idx, V* __restrict__ out,
    long long m, int n, int row_vecs, int lanes) {
  const int rows_per_block = THREADS / lanes;
  const long long row = (long long)blockIdx.x * rows_per_block + threadIdx.x / lanes;
  if (row >= m) return;
  const int lane = threadIdx.x % lanes;
  const long long i = __ldg(&idx[row]);  // clamped in 64 bits: nothing wraps
  const int r = i < 0 ? 0 : (i >= n ? n - 1 : static_cast<int>(i));
  const V* src = table + (size_t)r * row_vecs;
  V* dst = out + (size_t)row * row_vecs;
  for (int w = lane; w < row_vecs; w += lanes) dst[w] = __ldg(&src[w]);
}

// the (query, visit) rows of the merge: both tables' row r, or the fill
template <typename V, typename I>
__global__ void __launch_bounds__(THREADS) gather_pairs_kernel(
    const V* __restrict__ cand_d, const V* __restrict__ cand_s, const I* __restrict__ rows,
    V* __restrict__ out_d, V* __restrict__ out_s, long long m, int n, int row_vecs, int lanes,
    V fill_d, V fill_s) {
  const int rows_per_block = THREADS / lanes;
  const long long row = (long long)blockIdx.x * rows_per_block + threadIdx.x / lanes;
  if (row >= m) return;
  const int lane = threadIdx.x % lanes;
  const long long i = __ldg(&rows[row]);
  V* dd = out_d + (size_t)row * row_vecs;
  V* ds = out_s + (size_t)row * row_vecs;
  if (i < 0) {
    for (int w = lane; w < row_vecs; w += lanes) {
      dd[w] = fill_d;
      ds[w] = fill_s;
    }
    return;
  }
  const int r = i >= n ? n - 1 : static_cast<int>(i);
  const V* sd = cand_d + (size_t)r * row_vecs;
  const V* ss = cand_s + (size_t)r * row_vecs;
  for (int w = lane; w < row_vecs; w += lanes) {
    dd[w] = __ldg(&sd[w]);
    ds[w] = __ldg(&ss[w]);
  }
}

// lanes per row and blocks for m rows of row_vecs vectors
inline int lanes_for(int row_vecs) {
  int lanes = 1;
  while (lanes < row_vecs && lanes < 32) lanes *= 2;
  return lanes;
}

inline long long blocks_for(long long m, int lanes) {
  const long long rows_per_block = THREADS / lanes;
  return (m + rows_per_block - 1) / rows_per_block;
}

template <typename V, typename I>
int launch(const void* table, const void* idx, void* out, long long m, int n, int row_vecs,
           cudaStream_t stream) {
  const int lanes = lanes_for(row_vecs);
  const long long blocks = blocks_for(m, lanes);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gather_rows_kernel<V, I><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const V*>(table), static_cast<const I*>(idx), static_cast<V*>(out), m, n,
      row_vecs, lanes);
  return cudaGetLastError();
}

template <typename V, typename I>
int launch_pairs(const void* cand_d, const void* cand_s, const void* rows, void* out_d,
                 void* out_s, long long m, int n, int row_vecs, V fill_d, V fill_s,
                 cudaStream_t stream) {
  const int lanes = lanes_for(row_vecs);
  const long long blocks = blocks_for(m, lanes);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gather_pairs_kernel<V, I><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const V*>(cand_d), static_cast<const V*>(cand_s), static_cast<const I*>(rows),
      static_cast<V*>(out_d), static_cast<V*>(out_s), m, n, row_vecs, lanes, fill_d, fill_s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  table (n, row_bytes) and out
// (m, row_bytes) are device pointers to rows of row_bytes bytes, idx (m,)
// int32, or int64 when idx_64 is nonzero.  row_bytes must be a multiple
// of 4 and both row pointers 4-byte aligned; 16-byte vectors are used
// when row_bytes and both pointers allow.  Nothing is allocated and
// nothing synchronizes.
int lmi_gather_rows(const void* table, const void* idx, int idx_64, void* out, long long m,
                    int n, long long row_bytes, void* stream) {
  if (m <= 0) return cudaSuccess;
  if (n < 1 || row_bytes < 4 || row_bytes % 4 != 0 || row_bytes > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
  const bool v16 = row_bytes % 16 == 0 && align % 16 == 0;
  if (!v16 && align % 4 != 0) return cudaErrorInvalidValue;
  const int vecs = (int)(row_bytes / (v16 ? 16 : 4));
  if (v16) {
    return idx_64 ? launch<int4, long long>(table, idx, out, m, n, vecs, s)
                  : launch<int4, int>(table, idx, out, m, n, vecs, s);
  }
  return idx_64 ? launch<int, long long>(table, idx, out, m, n, vecs, s)
                : launch<int, int>(table, idx, out, m, n, vecs, s);
}

// Returns a cudaError_t (0 = launched).  cand_d (n, k) f32 and cand_s
// (n, k) int32 are the scan's candidate tables, rows (m,) int32, or int64
// when rows_64 is nonzero (-1 = no candidates), out_d (m, k) f32 and out_s
// (m, k) int32; all device pointers, 4-byte aligned.  16-byte vectors are
// used when k % 4 == 0 and all four tables are 16-byte aligned.  Nothing
// is allocated and nothing synchronizes.
int lmi_gather_pairs(const void* cand_d, const void* cand_s, const void* rows, int rows_64,
                     void* out_d, void* out_s, long long m, int n, int k, void* stream) {
  if (m <= 0) return cudaSuccess;
  if (n < 1 || k < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(cand_d) | reinterpret_cast<uintptr_t>(cand_s) |
      reinterpret_cast<uintptr_t>(out_d) | reinterpret_cast<uintptr_t>(out_s);
  if (align % 4 != 0) return cudaErrorInvalidValue;
  const int inf_bits = 0x7f800000, none = -1;
  if (k % 4 == 0 && align % 16 == 0) {
    const int4 fd = make_int4(inf_bits, inf_bits, inf_bits, inf_bits);
    const int4 fs = make_int4(none, none, none, none);
    return rows_64 ? launch_pairs<int4, long long>(cand_d, cand_s, rows, out_d, out_s, m, n, k / 4,
                                                   fd, fs, s)
                   : launch_pairs<int4, int>(cand_d, cand_s, rows, out_d, out_s, m, n, k / 4, fd,
                                             fs, s);
  }
  return rows_64 ? launch_pairs<int, long long>(cand_d, cand_s, rows, out_d, out_s, m, n, k,
                                                inf_bits, none, s)
                 : launch_pairs<int, int>(cand_d, cand_s, rows, out_d, out_s, m, n, k, inf_bits,
                                          none, s);
}

}  // extern "C"
