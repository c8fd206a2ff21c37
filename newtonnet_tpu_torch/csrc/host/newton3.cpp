// Newton's-third-law half-list construction.
//
// Orients + slot-colors a symmetric padded neighbor list (idx, mask) of
// shape (N, K_in) into a HALF list: each undirected edge (i, j) is stored
// exactly once, on the row of one chosen endpoint. The message-passing
// layer then computes every per-edge quantity once and aggregates it onto
// BOTH endpoints (newtonnet_tpu_torch/models/xla_stack.py, newton3), which
// halves gather rows, pair-MLP FLOPs, and backward traffic.
//
// Two phases (the numpy newton3_half_list of the JAX package is the
// tests' reference):
//   1. Eulerian orientation: odd-degree vertices are paired with virtual
//      edges (making every component Eulerian), then Eulerian circuits
//      are walked -- each visit enters and leaves a node, so out-degree
//      == in-degree == deg'/2 exactly; dropping the virtual edges leaves
//      both <= ceil(deg/2). (Plain trails without the augmentation can
//      restart at a node and pile up out-edges there.)
//   2. Konig bipartite edge coloring of the oriented edges under the
//      constraint that no two out-edges of i and no two in-edges of j
//      share a slot. The in-side constraint makes each slot's
//      n -> idx[k, n] map injective, which is what inv_scatter_sum needs
//      for the scatter-free in-side aggregation. Konig's theorem bounds
//      the slot count at max(out-degree, in-degree) exactly: when no slot
//      is free at both endpoints, flip an alternating two-colored chain.
//
// The orientation/coloring machinery lives in graphcolor.h, shared with
// the staircase builder (staircase.cpp).
//
// C ABI loaded with ctypes by newtonnet_tpu_torch/ops/nlist.py, built by
// g++ at first use (newtonnet_tpu_torch/ops/_build.py: load_host).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "graphcolor.h"

extern "C" {

// Returns the number of slots used (== max(out-degree, in-degree) of the
// orientation, the Konig optimum), or -1 if k_out is insufficient.
int64_t newton3_half_list(const int32_t* idx, const uint8_t* mask, int64_t n,
                          int32_t k_in, int32_t k_out, int32_t* idx_out,
                          uint8_t* mask_out) {
  std::vector<std::pair<int32_t, int32_t>> edges;
  graphcolor::collect_edges(idx, mask, n, k_in, &edges);
  const int64_t m = static_cast<int64_t>(edges.size());
  std::vector<int32_t> src, dst;
  graphcolor::euler_orient(edges, n, &src, &dst);

  std::vector<int32_t> out_deg(n, 0), in_deg(n, 0);
  for (int64_t e = 0; e < m; ++e) {
    ++out_deg[src[e]];
    ++in_deg[dst[e]];
  }
  int32_t delta = 1;
  for (int64_t i = 0; i < n; ++i)
    delta = std::max(delta, std::max(out_deg[i], in_deg[i]));
  if (delta > k_out) return -1;

  graphcolor::KonigState st;
  st.init(src, dst, n, delta);
  if (!st.color_all()) return -1;  // cannot happen (Konig)

  std::memset(idx_out, 0, sizeof(int32_t) * static_cast<size_t>(n) * k_out);
  std::memset(mask_out, 0, static_cast<size_t>(n) * k_out);
  for (int64_t e = 0; e < m; ++e) {
    idx_out[static_cast<size_t>(src[e]) * k_out + st.color[e]] = dst[e];
    mask_out[static_cast<size_t>(src[e]) * k_out + st.color[e]] = 1;
  }
  return delta;
}

}  // extern "C"
