// Row gather for Hopper (sm_90a):  out[i, :] = table[clamp(idx[i], 0, n-1), :]
// for any row type whose rows are a whole number of 4-byte words, bit for
// bit (the copy moves words, so f32 NaN payloads and -0.0 survive).
//
// Replaces the TPU kernels of learnedmetricindex_tpu/ops/gather_kernel.py
// (_gather_rows_impl with the bodies _vmem_gather_kernel and
// _hbm_gather_kernel, entry gather_rows).  Those work around Mosaic: a
// VMEM-resident table under a 64 MB budget or a ring of 8-row aligned
// block DMAs with a one-hot row extraction, packed dtypes through an
// int32 bit view, indices scalar-prefetched into SMEM and padded to
// whole 512-row blocks.  None of that carries over: here each group of
// lanes reads its own index, clamps it and copies one row with vector
// loads, straight from device memory to device memory.
//
// What bounds it on an H100: it is a pure copy, 2·M·row_bytes bytes (plus
// 4·M of indices) against 3.35 TB/s; no arithmetic, no reuse, so no
// shared memory.  The design keeps every load 16 bytes wide where the
// row bytes and both pointers allow (4-byte words otherwise), and sizes
// the lanes per row to the row so a narrow row (a 16-wide f32 candidate
// list is 4 vectors) does not leave most of a warp idle: LANES is the
// smallest power of two >= the row's vectors, at most 32, and a block of
// 256 threads copies 256/LANES rows.

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

template <typename V, typename I>
int launch(const void* table, const void* idx, void* out, long long m, int n, int row_vecs,
           cudaStream_t stream) {
  int lanes = 1;
  while (lanes < row_vecs && lanes < 32) lanes *= 2;
  const long long rows_per_block = THREADS / lanes;
  const long long blocks = (m + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gather_rows_kernel<V, I><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const V*>(table), static_cast<const I*>(idx), static_cast<V*>(out), m, n,
      row_vecs, lanes);
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

}  // extern "C"
