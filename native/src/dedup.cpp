// Host-side embedding-ID dedup plan for recommender_tpu.
//
// Zipf-skewed CTR traffic makes a DLRM batch's 213k lookup ids collapse to
// ~36k unique rows (measured on the synthetic Criteo generator, zipf 1.2).
// The device backward pays per scatter ROW, so the input pipeline precomputes
// a dedup plan per batch and the device backward segment-sums cotangents into
// unique rows before the (now ~6x smaller) table scatter — see
// ops/embedding_kernels.py::embedding_lookup_dedup (chip_smoke.py phase
// "kernels" checks and times it on the device).
//
// A radix sort instead of np.unique's comparison sort, so the producer
// thread can build plans ahead of the device step.
//
// Build: make -C native  (libdedup.so, loaded via ctypes from
// recommender_tpu/data/dedup.py; numpy fallback there mirrors the output).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ids[n] (non-negative, < 2^30) ->
//   perm[n]        positions of the original array sorted ascending by id
//                  (stable: equal ids keep original order)
//   slot_sorted[n] unique-slot index per sorted position (nondecreasing)
//   uniq[u_cap]    ascending unique ids, padded with pad_id
// Returns the number of unique ids, or -1 if it exceeds u_cap (outputs are
// then undefined and the caller must fall back to the non-dedup path).
int64_t dedup_plan(const int32_t* ids, int64_t n, int32_t* perm,
                   int32_t* slot_sorted, int32_t* uniq, int64_t u_cap,
                   int32_t pad_id) {
  // LSD radix sort of (id, position) pairs, 4 passes of 8 bits.
  std::vector<uint32_t> key_a(n), key_b(n);
  std::vector<int32_t> val_a(n), val_b(n);
  for (int64_t i = 0; i < n; ++i) {
    key_a[i] = static_cast<uint32_t>(ids[i]);
    val_a[i] = static_cast<int32_t>(i);
  }
  uint32_t max_key = 0;
  for (int64_t i = 0; i < n; ++i) max_key = key_a[i] > max_key ? key_a[i] : max_key;

  uint32_t* src_k = key_a.data();
  int32_t* src_v = val_a.data();
  uint32_t* dst_k = key_b.data();
  int32_t* dst_v = val_b.data();
  int64_t count[256];
  for (int shift = 0; shift < 32; shift += 8) {
    if (shift > 0 && (max_key >> shift) == 0) break;  // higher bytes all zero
    std::memset(count, 0, sizeof(count));
    for (int64_t i = 0; i < n; ++i) count[(src_k[i] >> shift) & 0xff]++;
    int64_t pos = 0;
    for (int b = 0; b < 256; ++b) {
      const int64_t c = count[b];
      count[b] = pos;
      pos += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      const int64_t p = count[(src_k[i] >> shift) & 0xff]++;
      dst_k[p] = src_k[i];
      dst_v[p] = src_v[i];
    }
    std::swap(src_k, dst_k);
    std::swap(src_v, dst_v);
  }

  // One pass over the sorted stream: slots, uniques, permutation.
  int64_t n_uniq = 0;
  uint32_t prev = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t k = src_k[i];
    if (i == 0 || k != prev) {
      if (n_uniq >= u_cap) return -1;
      uniq[n_uniq++] = static_cast<int32_t>(k);
      prev = k;
    }
    slot_sorted[i] = static_cast<int32_t>(n_uniq - 1);
    perm[i] = src_v[i];
  }
  for (int64_t u = n_uniq; u < u_cap; ++u) uniq[u] = pad_id;
  return n_uniq;
}

}  // extern "C"
