// Native host-side graph sampling for recommender_tpu.
//
// Replacement for the DGL C++ kernels the reference depends on
// (SURVEY.md §2.7 item 3): weighted random walks (eges), metapath walks and
// the PinSAGE importance sampler (pinsage). The Python/numpy fallbacks in
// recommender_tpu/graph/ are the behavioural reference; these functions are
// the production hot path keeping the device fed (host sampling is the
// throughput limiter flagged in SURVEY.md §7).
//
// Build: make -C native   (produces libgraph_sampler.so, loaded via ctypes)
//
// All arrays are caller-allocated numpy buffers; no ownership transfer.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <unordered_map>
#include <vector>

extern "C" {

// Walker alias-table construction over CSR segments.
// indptr[n+1], weights[E] -> prob[E] (f32), alias[E] (i32, segment-local).
void build_alias_tables(const int64_t* indptr, int64_t num_nodes,
                        const float* weights, float* prob, int32_t* alias) {
  std::vector<int32_t> small, large;
  std::vector<double> p;
  for (int64_t v = 0; v < num_nodes; ++v) {
    const int64_t s = indptr[v], e = indptr[v + 1];
    const int64_t d = e - s;
    if (d == 0) continue;
    double total = 0.0;
    for (int64_t i = s; i < e; ++i) total += weights[i];
    if (total <= 0.0) {
      for (int64_t i = s; i < e; ++i) {
        prob[i] = 1.0f;
        alias[i] = static_cast<int32_t>(i - s);
      }
      continue;
    }
    p.assign(d, 0.0);
    small.clear();
    large.clear();
    for (int64_t i = 0; i < d; ++i) {
      p[i] = weights[s + i] * d / total;
      (p[i] < 1.0 ? small : large).push_back(static_cast<int32_t>(i));
    }
    while (!small.empty() && !large.empty()) {
      const int32_t sm = small.back();
      small.pop_back();
      const int32_t lg = large.back();
      large.pop_back();
      prob[s + sm] = static_cast<float>(p[sm]);
      alias[s + sm] = lg;
      p[lg] -= (1.0 - p[sm]);
      (p[lg] < 1.0 ? small : large).push_back(lg);
    }
    for (int32_t i : large) {
      prob[s + i] = 1.0f;
      alias[s + i] = i;
    }
    for (int32_t i : small) {
      prob[s + i] = 1.0f;
      alias[s + i] = i;
    }
  }
}

static inline int32_t sample_neighbor(const int64_t* indptr,
                                      const int32_t* indices,
                                      const float* prob, const int32_t* alias,
                                      int64_t v, std::mt19937_64& rng) {
  const int64_t s = indptr[v], e = indptr[v + 1];
  const int64_t d = e - s;
  if (d == 0) return -1;
  const uint64_t r = rng();
  const int64_t j = static_cast<int64_t>(r % static_cast<uint64_t>(d));
  const double u = (rng() >> 11) * (1.0 / 9007199254740992.0);
  const int64_t pos = s + j;
  return (u < prob[pos]) ? indices[pos] : indices[s + alias[pos]];
}

// Weighted random walks via alias tables.
// seeds[S] -> out[S * (length+1)], -1 after dead ends.
void weighted_random_walks(const int64_t* indptr, const int32_t* indices,
                           const float* prob, const int32_t* alias,
                           const int32_t* seeds, int64_t num_seeds,
                           int64_t length, uint64_t seed, int32_t* out) {
  std::mt19937_64 rng(seed);
  for (int64_t i = 0; i < num_seeds; ++i) {
    int32_t cur = seeds[i];
    out[i * (length + 1)] = cur;
    for (int64_t t = 1; t <= length; ++t) {
      if (cur >= 0)
        cur = sample_neighbor(indptr, indices, prob, alias, cur, rng);
      out[i * (length + 1) + t] = cur;
    }
  }
}

static inline int64_t uniform_neighbor(const int64_t* indptr,
                                       const int32_t* indices, int64_t v,
                                       std::mt19937_64& rng) {
  const int64_t s = indptr[v], e = indptr[v + 1];
  const int64_t d = e - s;
  if (d <= 0) return -1;
  return indices[s + static_cast<int64_t>(rng() % static_cast<uint64_t>(d))];
}

// PinSAGE importance sampling on a bipartite graph.
// For each of N items: num_walks random walks of walk_length item->user->item
// hops (per-hop termination after the visit), visit counts -> top
// num_neighbors neighbors + counts as weights. Padding slots carry the item
// itself with weight 0. exclude[N * num_exclude] (or nullptr) lists node ids
// whose visits are discarded (leakage-edge removal).
void pinsage_importance_neighbors(
    const int64_t* i2u_indptr, const int32_t* i2u_indices,
    const int64_t* u2i_indptr, const int32_t* u2i_indices,
    const int64_t* items, int64_t num_items, int64_t num_neighbors,
    int64_t num_walks, int64_t walk_length, double termination_prob,
    const int32_t* exclude, int64_t num_exclude, uint64_t seed,
    int32_t* out_nbr, float* out_w) {
  std::mt19937_64 rng(seed);
  // Visit counts live in a small flat array: a walk budget of
  // num_walks*walk_length distinct visits (4*2=8 at PinSage defaults) makes
  // hash-map clear/insert/alloc the dominant cost per item — a linear
  // scan over <=budget slots is far cheaper and, with
  // the same rng draw order and the same (count desc, id asc) tie-break,
  // bit-identical to the map version. NOTE: the count lookup is a linear
  // scan over the distinct-visit slots, so per-item cost grows
  // O(budget^2) if num_walks*walk_length is raised far beyond the
  // reference 4x2 default — at budget ~1000+ a hash map wins again.
  const int64_t budget = num_walks * walk_length;
  std::vector<int32_t> cnt_ids(static_cast<size_t>(budget));
  std::vector<int32_t> cnt_vals(static_cast<size_t>(budget));
  for (int64_t i = 0; i < num_items; ++i) {
    const int64_t item = items[i];
    int64_t n_distinct = 0;
    for (int64_t w = 0; w < num_walks; ++w) {
      int64_t cur = item;
      for (int64_t hop = 0; hop < walk_length; ++hop) {
        const int64_t user = uniform_neighbor(i2u_indptr, i2u_indices, cur, rng);
        if (user < 0) break;
        const int64_t nxt = uniform_neighbor(u2i_indptr, u2i_indices, user, rng);
        if (nxt < 0) break;
        if (nxt != item) {
          const int32_t v = static_cast<int32_t>(nxt);
          int64_t s = 0;
          for (; s < n_distinct; ++s)
            if (cnt_ids[s] == v) { cnt_vals[s]++; break; }
          if (s == n_distinct) {
            cnt_ids[n_distinct] = v;
            cnt_vals[n_distinct] = 1;
            ++n_distinct;
          }
        }
        cur = nxt;
        if (hop + 1 < walk_length && termination_prob > 0.0) {
          const double u = (rng() >> 11) * (1.0 / 9007199254740992.0);
          if (u < termination_prob) break;
        }
      }
    }
    if (exclude != nullptr) {
      for (int64_t e = 0; e < num_exclude; ++e) {
        const int32_t ex = exclude[i * num_exclude + e];
        for (int64_t s = 0; s < n_distinct; ++s)
          if (cnt_ids[s] == ex) {  // drop by swap-with-last
            cnt_ids[s] = cnt_ids[n_distinct - 1];
            cnt_vals[s] = cnt_vals[n_distinct - 1];
            --n_distinct;
            break;
          }
      }
    }
    // top-k selection by (count desc, id asc), k = num_neighbors (tiny)
    for (int64_t j = 0; j < num_neighbors; ++j) {
      int64_t best = -1;
      for (int64_t s = j; s < n_distinct; ++s)
        if (best < 0 || cnt_vals[s] > cnt_vals[best] ||
            (cnt_vals[s] == cnt_vals[best] && cnt_ids[s] < cnt_ids[best]))
          best = s;
      if (best >= 0) {
        std::swap(cnt_ids[j], cnt_ids[best]);
        std::swap(cnt_vals[j], cnt_vals[best]);
        out_nbr[i * num_neighbors + j] = cnt_ids[j];
        out_w[i * num_neighbors + j] = static_cast<float>(cnt_vals[j]);
      } else {
        out_nbr[i * num_neighbors + j] = static_cast<int32_t>(item);
        out_w[i * num_neighbors + j] = 0.0f;
      }
    }
  }
}

// Item->user->item metapath step for a batch (uniform), -1 for dead ends.
void metapath_i2u2i(const int64_t* i2u_indptr, const int32_t* i2u_indices,
                    const int64_t* u2i_indptr, const int32_t* u2i_indices,
                    const int64_t* items, int64_t n, uint64_t seed,
                    int64_t* out) {
  std::mt19937_64 rng(seed);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t user = uniform_neighbor(i2u_indptr, i2u_indices, items[i], rng);
    out[i] = (user < 0) ? -1 : uniform_neighbor(u2i_indptr, u2i_indices, user, rng);
  }
}

}  // extern "C"
