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
// over between blocks, so their lists meet in this second pass.  A launch
// whose pairs are all one item needs no second pass: the wrapper
// (ops/scan_kernel.py::scan_split) returns the scan's lists and launches
// nothing.
//
// Semantics (held against merge_split_lists_reference in
// ops/scan_kernel.py): each item's list is ascending by (distance, scan
// position), its unfilled tail +inf / slot -1; the output is the first k
// of the union by (distance, item order, place in its list).  Items
// follow their pair's scan order, so that is the bucket-wide rule
// (distance, scan position): the merged list is bit for bit the list of
// one scan of the whole bucket.
//
// The design: a block a (pair, group of query slots); the host picks the
// group (ops/scan_kernel.py::merge_plan) from k, the query tile and the
// most items a pair has (cap), so that cap items' lists of the group fit
// in the block's shared memory.  The block reads the pair's item count
// once and then:
// * one item: copies the group's lists, contiguous in both tensors, with
//   16-byte loads and stores;
// * lists of k <= 32 (the searches' k_scan 16 and 32), any number of
//   items: 16 or 32 lanes of a warp a query slot hold its running list and
//   merge the items into it one after another, ranking each entry of the
//   two lists by binary searches over shuffles (warp_merge): no staging,
//   each item's lists read once, coalesced;
// * 2 .. cap items of wider lists: stages the group's lists of every item into shared
//   memory with 16-byte cp.async (each run placed where its 16-byte chunks
//   fall in device memory), fills an output run with +inf / -1 meanwhile,
//   then places each finite entry (a warp a list) by binary searches in
//   shared memory:
//   its place in the output is its place in its own list, plus the entries
//   of earlier items at or below it, plus those of later items strictly
//   below it (the rule of select_tile_merge in csrc/scan_pairs.cu).  Each
//   search covers only the first k - place entries, and a place past
//   k - 1 stops the searches: the entry drops out, and so does the rest
//   of its list; an entry that k - i entries of one other list precede
//   drops out before any search.  The ranks of the
//   finite entries are 0 .. n_finite - 1, so what no entry takes keeps the
//   fill.  The output run leaves with 16-byte stores;
// * more than cap items of wider lists (a caller that did not say how
//   many, or lists too wide to stage: k 1024 at 24 items and more): a warp
//   a query slot
//   places the entries by the same rule with binary searches over device
//   memory, and writes the fill past the finite count.
// No entry moves twice and no two threads write one place.
//
// What bounds it on an H100: the bytes of the item lists it reads and of
// the lists it writes (8 bytes an entry each).  At the serving dispatch's
// plan (139 pairs, 538 items, k 16, query tile 128) that is 11.1 MB, 3.3
// µs at 3.35 TB/s.  The searches are chains of dependent reads, so the
// design keeps many of them in flight: a warp's lanes a slot's whole list
// at k <= 32, a warp a list in the staged blocks.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_MAX_K = 32;  // lists of at most this many merge in a warp's lanes
// a block's shared memory on an H100, less warp_merge's buffers (two instances)
constexpr long long SMEM_MAX = 232448 - 2 * WARPS * 2 * 32 * 4;
constexpr uint32_t INF_BITS = 0x7f800000u;
constexpr uint32_t NONE = 0xffffffffu;  // slot -1

// Shared memory elements of one staged run of `group` slots' lists: up to
// 3 ahead of it, so that its 16-byte chunks fall where they fall in device
// memory, rounded up to whole 16 bytes (ops/scan_kernel.py::merge_smem_bytes).
__host__ __device__ inline long long run_elems(long long group, long long k) {
  return (group * k + 6) / 4 * 4;
}

// Where a 4-byte value lies within its 16 bytes of device memory.
__device__ __forceinline__ int residue(const void* p) {
  return (int)(((uintptr_t)p >> 2) & 3);
}

__device__ __forceinline__ void cp_async16(uint32_t* s, const uint32_t* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t* s, const uint32_t* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g)
               : "memory");
}

// The 16-byte body and the ragged ends of n values starting at residue r:
// head values, then body 16-byte chunks, then the tail; t < head + tail
// names the t-th ragged value.
struct Span {
  long long head, body, ragged;
  __device__ Span(int r, long long n) {
    head = min((long long)((4 - r) & 3), n);
    body = (n - head) >> 2;
    ragged = n - (body << 2);
  }
  __device__ long long ragged_at(long long t) const { return t < head ? t : t + (body << 2); }
};

// dst[r + e] = src[e] for e < n, r = residue(src), dst 16-byte aligned:
// every thread of the block issues copies, none waits.
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* src, int n) {
  const int r = residue(src);
  const Span sp(r, n);
  dst += r;
  for (int c = threadIdx.x; c < sp.body; c += THREADS)
    cp_async16(dst + sp.head + 4 * c, src + sp.head + 4 * c);
  for (int t = threadIdx.x; t < sp.ragged; t += THREADS) {
    const long long e = sp.ragged_at(t);
    cp_async4(dst + e, src + e);
  }
}

// dst[e] = src[r + e] for e < n, r = residue(dst): the layout of stage.
__device__ __forceinline__ void unstage(uint32_t* dst, const uint32_t* src, int n) {
  const int r = residue(dst);
  const Span sp(r, n);
  src += r;
  for (int c = threadIdx.x; c < sp.body; c += THREADS)
    *reinterpret_cast<uint4*>(dst + sp.head + 4 * c) =
        *reinterpret_cast<const uint4*>(src + sp.head + 4 * c);
  for (int t = threadIdx.x; t < sp.ragged; t += THREADS) {
    const long long e = sp.ragged_at(t);
    dst[e] = src[e];
  }
}

// dst[0, n) = src[0, n) in device memory, 16 bytes a load and store where
// the two lie alike within their 16 bytes.
__device__ __forceinline__ void copy(uint32_t* dst, const uint32_t* src, long long n) {
  const int r = residue(src);
  if (r != residue(dst)) {
    for (long long t = threadIdx.x; t < n; t += THREADS) dst[t] = __ldg(src + t);
    return;
  }
  const Span sp(r, n);
  for (long long c = threadIdx.x; c < sp.body; c += THREADS)
    *reinterpret_cast<uint4*>(dst + sp.head + 4 * c) =
        __ldg(reinterpret_cast<const uint4*>(src + sp.head + 4 * c));
  for (long long t = threadIdx.x; t < sp.ragged; t += THREADS) {
    const long long e = sp.ragged_at(t);
    dst[e] = __ldg(src + e);
  }
}

// Entries of the ascending a[0, n) that are <= v (LE) or < v; GLOBAL: a
// lies in device memory, else in shared memory.
template <bool LE, bool GLOBAL>
__device__ __forceinline__ int below(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float x = GLOBAL ? __ldg(a + mid) : a[mid];
    if (LE ? x <= v : x < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Place in the merged list of entry v at place i of list j, against the
// n lists list(o) of k entries: k or more when it drops out.  First one
// read a list (independent reads): an entry that k - i entries of a
// single other list precede drops out without a search.
template <bool GLOBAL, typename List>
__device__ __forceinline__ int place_of(float v, int i, int j, int n, int k, List list) {
  for (int o = 0; o < n; ++o) {
    if (o == j) continue;
    const float x = GLOBAL ? __ldg(list(o) + k - 1 - i) : list(o)[k - 1 - i];
    if (o < j ? x <= v : x < v) return k;
  }
  int place = i;
  for (int o = 0; o < n && place < k; ++o) {
    if (o == j) continue;
    place += o < j ? below<true, GLOBAL>(list(o), k - place, v)
                   : below<false, GLOBAL>(list(o), k - place, v);
  }
  return place;
}

// Entries of the ascending list that the W lanes of this lane's group
// hold, one a lane (`mine`), that are <= x (LE) or < x: a binary search by
// shuffles, log2(W) + 1 of them.
template <bool LE, int W>
__device__ __forceinline__ int count_lanes(float mine, float x) {
  int pos = 0;
#pragma unroll
  for (int step = W / 2; step >= 1; step >>= 1) {
    const float y = __shfl_sync(FULL, mine, pos + step - 1, W);
    if (LE ? y <= x : y < x) pos += step;
  }
  const float y = __shfl_sync(FULL, mine, pos, W);
  return pos + (LE ? y <= x : y < x);
}

// Lists of at most W <= 32 entries (k <= W): W lanes a query slot hold its
// running list, one entry a lane, and merge the pair's items into it one
// after another.  Each step ranks every entry of the running list (the
// earlier items) and of the next item in their union: its place in its
// own list plus the other list's entries strictly below it (for the
// running list's) or at or below it (for the item's), the rule of
// place_of for two lists.  Lanes past k hold +inf, which no place below k
// takes before a real entry.  The entries placed below k go through the
// warp's buffer in shared memory back into the lanes.
template <int W>
__device__ __forceinline__ void warp_merge(const float* __restrict__ item_d,
                                           const int* __restrict__ item_s, float* out_d,
                                           int* out_s, size_t out_at, int i0, int n, int qtile,
                                           int s0, int ns, int k) {
  constexpr int PER = 32 / W;  // query slots a warp
  __shared__ uint32_t buf[WARPS][2][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int li = lane % W;  // the entry this lane holds
  uint32_t* md = buf[warp][0] + lane / W * W;
  uint32_t* ms = buf[warp][1] + lane / W * W;
  for (int first = warp * PER; first < ns; first += WARPS * PER) {
    const int slot = first + lane / W;
    const bool real = slot < ns && li < k;
    // this lane's entry of item j's list, and the stride from one item to the next
    const size_t first_at = ((size_t)i0 * qtile + s0 + slot) * k + li;
    const size_t stride = (size_t)qtile * k;
    auto dist = [&](int j) { return real ? __ldg(item_d + first_at + j * stride) : CUDART_INF_F; };
    auto slot_of = [&](int j) { return real ? __ldg(item_s + first_at + j * stride) : -1; };
    // the running list's entry, item j's, item j+1's
    float run_d = dist(0), item_dv = dist(1), next_d = CUDART_INF_F;
    int run_s = slot_of(0), item_sv = slot_of(1), next_s = -1;
    for (int j = 1; j < n; ++j) {
      if (j + 1 < n) {  // in flight meanwhile
        next_d = dist(j + 1);
        next_s = slot_of(j + 1);
      }
      const int r_run = li + count_lanes<false, W>(item_dv, run_d);
      const int r_item = li + count_lanes<true, W>(run_d, item_dv);
      if (r_run < k) {
        md[r_run] = __float_as_uint(run_d);
        ms[r_run] = (uint32_t)run_s;
      }
      if (r_item < k) {
        md[r_item] = __float_as_uint(item_dv);
        ms[r_item] = (uint32_t)item_sv;
      }
      __syncwarp();
      run_d = li < k ? __uint_as_float(md[li]) : CUDART_INF_F;
      run_s = li < k ? (int)ms[li] : -1;
      __syncwarp();
      item_dv = next_d;
      item_sv = next_s;
    }
    if (real) {
      out_d[out_at + (size_t)slot * k + li] = run_d;
      out_s[out_at + (size_t)slot * k + li] = run_d < CUDART_INF_F ? run_s : -1;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    merge_kernel(const float* __restrict__ item_d, const int* __restrict__ item_s,
                 const int* __restrict__ pair_items, float* __restrict__ out_d,
                 int* __restrict__ out_s, int qtile, int k, int group, int groups, int cap) {
  extern __shared__ __align__(16) uint32_t smem[];
  const long long pair = blockIdx.x / (unsigned)groups;
  const int s0 = (int)(blockIdx.x % (unsigned)groups) * group;
  const int ns = min(group, qtile - s0);
  const int i0 = __ldg(pair_items + pair), n = __ldg(pair_items + pair + 1) - i0;
  const long long len = (long long)ns * k;  // entries of the group's lists in one item
  const size_t out_at = ((size_t)pair * qtile + s0) * k;
  const uint32_t* id = reinterpret_cast<const uint32_t*>(item_d);
  const uint32_t* is = reinterpret_cast<const uint32_t*>(item_s);
  uint32_t* od = reinterpret_cast<uint32_t*>(out_d) + out_at;
  uint32_t* os = reinterpret_cast<uint32_t*>(out_s) + out_at;
  // item j of the pair: where its list of the group's first slot starts
  auto at = [&](int j) { return ((size_t)(i0 + j) * qtile + s0) * k; };

  if (n <= 0) {  // a pair without items: the fill
    for (long long t = threadIdx.x; t < len; t += THREADS) {
      od[t] = INF_BITS;
      os[t] = NONE;
    }
    return;
  }
  if (n == 1) {
    copy(od, id + at(0), len);
    copy(os, is + at(0), len);
    return;
  }
  if (k <= WARP_MAX_K) {  // short lists: merged in the lanes of a warp
    if (k <= WARP_MAX_K / 2)
      warp_merge<WARP_MAX_K / 2>(item_d, item_s, out_d, out_s, out_at, i0, n, qtile, s0, ns, k);
    else
      warp_merge<WARP_MAX_K>(item_d, item_s, out_d, out_s, out_at, i0, n, qtile, s0, ns, k);
    return;
  }

  if (n <= cap) {  // staged: the group's lists of every item in shared memory
    const int L = (int)len, R = (int)run_elems(group, k);
    uint32_t* sd = smem;               // item j's distances from sd + j·R
    uint32_t* ss = smem + cap * R;     // its slots from ss + j·R
    uint32_t* md = ss + cap * R;       // the merged lists' distances
    uint32_t* ms = md + R;             // and slots
    for (int j = 0; j < n; ++j) {
      stage(sd + j * R, id + at(j), L);
      stage(ss + j * R, is + at(j), L);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int rd = residue(od), rs = residue(os);
    for (int t = threadIdx.x; t < L; t += THREADS) {
      md[rd + t] = INF_BITS;
      ms[rs + t] = NONE;
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    // residues of item j's runs, as stage placed them (mod 4, so in 32 bits)
    const unsigned bd = residue(id), bs = residue(is);
    auto off = [&](int j) { return ((unsigned)(i0 + j) * (unsigned)qtile + s0) * (unsigned)k; };
    const float* fd = reinterpret_cast<const float*>(sd);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int t = warp; t < n * ns; t += WARPS) {  // a warp a list: item j's of one slot
      const int j = t / ns, slot = t - j * ns;
      auto list = [&](int o) { return fd + o * R + ((bd + off(o)) & 3) + slot * k; };
      const float* lj = list(j);
      for (int i = lane; i < k; i += 32) {
        const float v = lj[i];
        if (!(v < CUDART_INF_F)) break;  // ascending: the rest of the list is fill
        const int place = place_of<false>(v, i, j, n, k, list);
        if (place >= k) break;  // and every later entry of the list places after it
        md[rd + slot * k + place] = __float_as_uint(v);
        ms[rs + slot * k + place] = ss[j * R + ((bs + off(j)) & 3) + slot * k + i];
      }
    }
    __syncthreads();
    unstage(od, md, L);
    unstage(os, ms, L);
    return;
  }

  // streamed: a warp a query slot, the lists read from device memory
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int slot = warp; slot < ns; slot += WARPS) {
    auto list = [&](int j) { return item_d + at(j) + (size_t)slot * k; };
    float* wd = out_d + out_at + (size_t)slot * k;
    int* ws = out_s + out_at + (size_t)slot * k;
    int n_finite = 0;
    for (int j = lane; j < n; j += 32) n_finite += below<false, true>(list(j), k, CUDART_INF_F);
    n_finite = __reduce_add_sync(FULL, n_finite);
    for (int j = 0; j < n; ++j) {
      const float* lj = list(j);
      for (int i = lane; i < k; i += 32) {
        const float v = __ldg(lj + i);
        if (!(v < CUDART_INF_F)) break;  // ascending: the rest of the list is fill
        const int place = place_of<true>(v, i, j, n, k, list);
        if (place >= k) break;  // and every later entry of the list places after it
        wd[place] = v;
        ws[place] = __ldg(item_s + (lj - item_d) + i);
      }
    }
    for (int i = n_finite + lane; i < k; i += 32) {
      wd[i] = CUDART_INF_F;
      ws[i] = -1;
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  item_d / item_s: (n_items, qtile,
// k) f32 / int32 lists, each ascending with a +inf / -1 tail (4-byte
// aligned); pair_items: (n_pairs + 1,) int32, pair p's items
// pair_items[p] .. pair_items[p+1] - 1 (none: the fill); out_d / out_s:
// (n_pairs, qtile, k).  The plan (ops/scan_kernel.py::merge_plan): `group`
// query slots a block (1 .. qtile), pairs of 2 .. `cap` items staged in
// `smem` bytes of shared memory, which must be (2·cap + 2) runs of
// run_elems(group, k) values (0 for cap < 2); pairs of more items are
// streamed.  Any item count is merged right under any plan.  All pointers
// are device pointers, the outputs apart from the inputs; nothing is
// allocated and nothing synchronizes.
int lmi_scan_merge(const void* item_d, const void* item_s, const void* pair_items, void* out_d,
                   void* out_s, int n_pairs, int qtile, int k, int group, int cap, int smem,
                   void* stream) {
  if (n_pairs <= 0) return cudaSuccess;
  if (qtile < 1 || k < 1 || group < 1 || group > qtile || cap < 0)
    return cudaErrorInvalidValue;
  const long long want = cap < 2 ? 0 : (2LL * cap + 2) * run_elems(group, k) * 4;
  if (smem != want || want > SMEM_MAX) return cudaErrorInvalidValue;
  const long long groups = (qtile + group - 1) / group;
  const long long blocks = n_pairs * groups;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  merge_kernel<<<(unsigned)blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(item_d), static_cast<const int*>(item_s),
      static_cast<const int*>(pair_items), static_cast<float*>(out_d), static_cast<int*>(out_s),
      qtile, k, group, (int)groups, cap);
  return cudaGetLastError();
}

}  // extern "C"
