// Merge of a split bucket scan for Hopper (sm_90a): for each (pair, query
// slot), the first k of the sorted lists that the pair's items (segments
// of its bucket's chunk list, scanned by csrc/scan_pairs.cu as
// pseudo-buckets) left, in one list.
//
// Replaces the cross-chunk part of the TPU kernel's running top-k
// (learnedmetricindex_tpu/ops/scan_kernel.py, `insert` in _kernel): the
// Pallas grid carries each pair's list in VMEM from one chunk to the
// next, in order.  Here the chunks of one pair may be scanned by several
// blocks at once (ops/scan_kernel.py::split_pairs), and nothing carries
// over between blocks, so their lists meet in this second pass.
//
// Semantics (held against merge_split_lists_reference in
// ops/scan_kernel.py): each item's list is ascending by (distance, scan
// position), its unfilled tail +inf / slot -1; the output is the first k
// of the union by (distance, item order, place in its list).  Items
// follow their pair's scan order, so that is the bucket-wide rule
// (distance, scan position): the merged list is bit for bit the list of
// one scan of the whole bucket.
//
// The design: one warp a (pair, query slot).  A pair of one item is
// copied.  Otherwise each lane takes entries of the items' lists and
// ranks each: its place in the output is its place in its own list, plus
// the entries of earlier items at or below it, plus those of later items
// strictly below it (binary searches of the other lists, the rule of
// select_tile_merge in csrc/scan_pairs.cu); a rank past k - 1 stops the
// searches, and the entry drops out.  Only finite entries are ranked;
// the ranks of the finite entries are 0 .. n_finite - 1, so the lanes
// write the fill past them.  No entry moves twice and no two lanes write
// one place.
//
// What bounds it on an H100: the bytes of the item lists it reads and of
// the lists it writes (8 bytes an entry each); the binary searches read
// the lists of one (pair, slot) again, from L1.  At the flagship (371
// pairs, k 16, a few items a split pair) that is ~10 MB, a few µs at
// 3.35 TB/s, against a scan of ~20-30 ms.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// Entries of the ascending a[0, n) that are <= v, or < v.
__device__ __forceinline__ int count_le(const float* __restrict__ a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}
__device__ __forceinline__ int count_lt(const float* __restrict__ a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
    merge_kernel(const float* __restrict__ item_d, const int* __restrict__ item_s,
                 const int* __restrict__ pair_items, float* __restrict__ out_d,
                 int* __restrict__ out_s, long long n_lists, int qtile, int k) {
  const long long w = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (w >= n_lists) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const long long pair = w / qtile;
  const int slot = (int)(w % qtile);
  const int i0 = pair_items[pair], n_items = pair_items[pair + 1] - i0;
  float* od = out_d + w * k;
  int* os = out_s + w * k;
  // list j of the pair: item i0 + j's entries for this query slot
  auto list = [&](int j) { return ((size_t)(i0 + j) * qtile + slot) * k; };
  if (n_items == 1) {
    const size_t at = list(0);
    for (int i = lane; i < k; i += 32) {
      od[i] = __ldg(item_d + at + i);
      os[i] = __ldg(item_s + at + i);
    }
    return;
  }
  int n_finite = 0;
  for (int j = lane; j < n_items; j += 32) n_finite += count_lt(item_d + list(j), k, CUDART_INF_F);
  n_finite = __reduce_add_sync(FULL, n_finite);
  for (int j = 0; j < n_items; ++j) {
    const size_t at = list(j);
    for (int i = lane; i < k; i += 32) {
      const float v = __ldg(item_d + at + i);
      if (!(v < CUDART_INF_F)) break;  // ascending: the rest of the list is fill
      int place = i;
      for (int o = 0; o < n_items && place < k; ++o) {
        if (o == j) continue;
        const float* other = item_d + list(o);
        place += o < j ? count_le(other, k, v) : count_lt(other, k, v);
      }
      if (place < k) {
        od[place] = v;
        os[place] = __ldg(item_s + at + i);
      }
    }
  }
  for (int i = n_finite + lane; i < k; i += 32) {
    od[i] = CUDART_INF_F;
    os[i] = -1;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  item_d / item_s: (n_items, qtile,
// k) f32 / int32 lists, each ascending with a +inf / -1 tail; pair_items:
// (n_pairs + 1,) int32, pair p's items pair_items[p] .. pair_items[p+1] - 1
// (at least one); out_d / out_s: (n_pairs, qtile, k).  All pointers are
// device pointers, the outputs apart from the inputs; nothing is
// allocated and nothing synchronizes.
int lmi_scan_merge(const void* item_d, const void* item_s, const void* pair_items, void* out_d,
                   void* out_s, int n_pairs, int qtile, int k, void* stream) {
  if (n_pairs <= 0) return cudaSuccess;
  if (qtile < 1 || k < 1) return cudaErrorInvalidValue;
  const long long n_lists = (long long)n_pairs * qtile;
  const long long blocks = (n_lists + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  merge_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(item_d), static_cast<const int*>(item_s),
      static_cast<const int*>(pair_items), static_cast<float*>(out_d), static_cast<int*>(out_s),
      n_lists, qtile, k);
  return cudaGetLastError();
}

}  // extern "C"
