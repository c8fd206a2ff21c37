// Shared-slot (symmetric) neighbor-list re-coloring.
//
// Re-slots a symmetric padded neighbor list (idx, mask) of shape (N, K_in)
// so every undirected edge (i, j) occupies the SAME slot c in both
// endpoint lists: out_idx[i*K_out + c] == j and out_idx[j*K_out + c] == i.
// Each slot's i -> idx[i, c] map is then an involution on its valid
// entries, so the message-passing backward needs no scatter-add: it is a
// sum of per-slot row gathers (newtonnet_tpu_torch/ops/nlist.py:
// inv_gather / inv_scatter_sum; the inverse list IS the list).
//
// Greedy edge coloring in descending-degree order: pick the lowest color
// free at both endpoints. On liquid-like radius graphs this needs only a
// few more slots than the max degree (a Konig/Vizing construction would
// reach max degree + 1, not worth the complexity). Runs at ~10 ns/edge --
// amortizable at MD skin-rebuild time.
//
// C ABI loaded with ctypes by newtonnet_tpu_torch/ops/nlist.py, built by
// g++ at first use (newtonnet_tpu_torch/ops/_build.py: load_host).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Returns the number of slots actually used (<= k_out), or -1 if k_out is
// insufficient for the greedy coloring.
int64_t symmetrize_slots(const int32_t* idx, const uint8_t* mask, int64_t n,
                         int32_t k_in, int32_t k_out, int32_t* idx_out,
                         uint8_t* mask_out) {
  // collect undirected edges (deduplicated: keep i < j)
  std::vector<std::pair<int32_t, int32_t>> edges;
  edges.reserve(static_cast<size_t>(n) * k_in / 2);
  std::vector<int32_t> deg(n, 0);
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t k = 0; k < k_in; ++k) {
      if (!mask[i * k_in + k]) continue;
      int32_t j = idx[i * k_in + k];
      if (i < j) edges.emplace_back(static_cast<int32_t>(i), j);
    }
  }
  for (auto& e : edges) {
    ++deg[e.first];
    ++deg[e.second];
  }
  // hardest (highest combined-degree) edges first
  std::vector<int64_t> order(edges.size());
  for (size_t e = 0; e < edges.size(); ++e) order[e] = static_cast<int64_t>(e);
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    int32_t da = deg[edges[a].first] + deg[edges[a].second];
    int32_t db = deg[edges[b].first] + deg[edges[b].second];
    return da != db ? da > db : a < b;
  });

  const int32_t words = (k_out + 63) / 64;
  std::vector<uint64_t> used(static_cast<size_t>(n) * words, 0);
  std::memset(idx_out, 0, sizeof(int32_t) * static_cast<size_t>(n) * k_out);
  std::memset(mask_out, 0, static_cast<size_t>(n) * k_out);

  int32_t max_used = 0;
  for (int64_t e : order) {
    int32_t i = edges[e].first, j = edges[e].second;
    const uint64_t* ui = &used[static_cast<size_t>(i) * words];
    const uint64_t* uj = &used[static_cast<size_t>(j) * words];
    int32_t c = -1;
    for (int32_t w = 0; w < words; ++w) {
      uint64_t free_bits = ~(ui[w] | uj[w]);
      if (w == words - 1 && (k_out & 63))
        free_bits &= (uint64_t(1) << (k_out & 63)) - 1;
      if (free_bits) {
        c = w * 64 + __builtin_ctzll(free_bits);
        break;
      }
    }
    if (c < 0) return -1;
    used[static_cast<size_t>(i) * words + c / 64] |= uint64_t(1) << (c & 63);
    used[static_cast<size_t>(j) * words + c / 64] |= uint64_t(1) << (c & 63);
    idx_out[static_cast<size_t>(i) * k_out + c] = j;
    idx_out[static_cast<size_t>(j) * k_out + c] = i;
    mask_out[static_cast<size_t>(i) * k_out + c] = 1;
    mask_out[static_cast<size_t>(j) * k_out + c] = 1;
    max_used = std::max(max_used, c + 1);
  }
  return max_used;
}

}  // extern "C"
