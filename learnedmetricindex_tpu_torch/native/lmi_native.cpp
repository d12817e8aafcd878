// Native host-side layout engine of the PyTorch port (the port's own copy
// of learnedmetricindex_tpu/native/lmi_native.cpp, same functions).
//
// The reference delegates its host-side data movement to pandas
// (groupby/sort) and numpy argsorts; O(n log n) argsorts over 10M-row id
// arrays are slow on a host with few cores.  These routines do the
// grouped-layout fills as single O(n) stable counting-sort passes.
//
// Exposed via ctypes (no pybind11 dependency); every buffer is caller-
// allocated numpy memory.

#include <cstdint>

extern "C" {

// Stable grouped fill: slot_rows[seg_starts[g] + rank_within_group] = row.
// seg_starts must be tile-aligned slot offsets per group; slot_rows is
// pre-filled with -1 (padding).  Optionally scatters labels alongside.
// cursors is scratch of n_groups int64, zero-initialized by the caller.
void lmi_fill_slots(const int64_t* group_ids,
                    int64_t n,
                    const int64_t* seg_starts,
                    int64_t* cursors,
                    int32_t* slot_rows,
                    const int32_t* labels,     // may be null
                    int32_t* labels_out) {     // may be null
  for (int64_t i = 0; i < n; ++i) {
    const int64_t g = group_ids[i];
    const int64_t slot = seg_starts[g] + cursors[g]++;
    slot_rows[slot] = static_cast<int32_t>(i);
    if (labels != nullptr && labels_out != nullptr) {
      labels_out[slot] = labels[i];
    }
  }
}

// Grouped fill writing 1-based row ids (the bucket store's chunk-id
// grid): ids_out[slot] = row + 1.  ids_out pre-filled with 0 (padding).
void lmi_fill_slots_1based(const int64_t* group_ids,
                           int64_t n,
                           const int64_t* seg_starts,
                           int64_t* cursors,
                           int32_t* ids_out) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t g = group_ids[i];
    ids_out[seg_starts[g] + cursors[g]++] = static_cast<int32_t>(i) + 1;
  }
}

// Histogram (np.bincount for int64 ids -> int64 counts).
void lmi_bincount(const int64_t* group_ids,
                  int64_t n,
                  int64_t n_groups,
                  int64_t* counts) {
  for (int64_t g = 0; g < n_groups; ++g) counts[g] = 0;
  for (int64_t i = 0; i < n; ++i) ++counts[group_ids[i]];
}

// Row-major multi-index ravel: out[i] = sum_l pred[i, l] * stride[l]
// (the data_prediction -> dense bucket id map).  pred is (n, L) int64,
// row-major.
void lmi_ravel_rows(const int64_t* pred,
                    int64_t n,
                    int64_t n_levels,
                    const int64_t* strides,
                    int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t acc = 0;
    const int64_t* row = pred + i * n_levels;
    for (int64_t l = 0; l < n_levels; ++l) acc += row[l] * strides[l];
    out[i] = acc;
  }
}

}  // extern "C"
