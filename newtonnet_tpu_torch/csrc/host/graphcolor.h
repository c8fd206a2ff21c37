// Shared edge-orientation + Konig-coloring machinery for the half-list
// builders (newton3.cpp: rectangular slot grid; staircase.cpp: dual-side
// compacted colors for the staircase layout -- see
// newtonnet_tpu_torch/ops/staircase.py for the algorithm rationale).
//
// Header-only (inline): each of the two sources that include it builds
// into its own library (newtonnet_tpu_torch/ops/_build.py: load_host).

#ifndef NEWTONNET_NATIVE_GRAPHCOLOR_H_
#define NEWTONNET_NATIVE_GRAPHCOLOR_H_

#include <algorithm>
#include <cstdint>
#include <utility>
#include <vector>

namespace graphcolor {

// Eulerian-circuit orientation over a CSR adjacency (odd-degree vertices
// paired with virtual edges first, so out-degree == in-degree == deg'/2
// exactly on every circuit; dropping the virtual edges leaves both
// <= ceil(deg/2)). Fills src/dst for the m real edges.
inline void euler_orient(
    const std::vector<std::pair<int32_t, int32_t>>& edges, int64_t n,
    std::vector<int32_t>* src, std::vector<int32_t>* dst) {
  const int64_t m = static_cast<int64_t>(edges.size());
  std::vector<int32_t> deg(n, 0);
  for (const auto& e : edges) {
    ++deg[e.first];
    ++deg[e.second];
  }
  std::vector<std::pair<int32_t, int32_t>> all(edges);
  {
    int32_t prev = -1;
    for (int64_t v = 0; v < n; ++v) {
      if (deg[v] % 2 == 0) continue;
      if (prev < 0) {
        prev = static_cast<int32_t>(v);
      } else {
        all.emplace_back(prev, static_cast<int32_t>(v));
        prev = -1;
      }
    }
  }
  const int64_t m_all = static_cast<int64_t>(all.size());
  std::vector<int64_t> ptr(n + 1, 0);
  for (const auto& e : all) {
    ++ptr[e.first + 1];
    ++ptr[e.second + 1];
  }
  for (int64_t i = 0; i < n; ++i) ptr[i + 1] += ptr[i];
  std::vector<int64_t> adj(2 * m_all);
  {
    std::vector<int64_t> cur(ptr.begin(), ptr.end() - 1);
    for (int64_t e = 0; e < m_all; ++e) {
      adj[cur[all[e].first]++] = e;
      adj[cur[all[e].second]++] = e;
    }
  }
  std::vector<int64_t> cursor(ptr.begin(), ptr.end() - 1);
  std::vector<uint8_t> used(m_all, 0);
  std::vector<int32_t> asrc(m_all), adst(m_all);
  auto next_edge = [&](int32_t u) -> int64_t {
    int64_t c = cursor[u], end = ptr[u + 1];
    while (c < end && used[adj[c]]) ++c;
    cursor[u] = c;
    return c < end ? adj[c] : -1;
  };
  for (int64_t s = 0; s < n; ++s) {
    for (;;) {  // all degrees even: every walk is a circuit back to s
      int64_t e = next_edge(static_cast<int32_t>(s));
      if (e < 0) break;
      int32_t u = static_cast<int32_t>(s);
      while (e >= 0) {
        used[e] = 1;
        int32_t v = all[e].first == u ? all[e].second : all[e].first;
        asrc[e] = u;
        adst[e] = v;
        u = v;
        e = next_edge(u);
      }
    }
  }
  src->assign(asrc.begin(), asrc.begin() + m);
  dst->assign(adst.begin(), adst.begin() + m);
}

// Konig bipartite edge-coloring state: slot_out[i*cap + c] /
// slot_in[j*cap + c] hold the edge id occupying slot c on that side, or
// -1. The same state is kept live by the staircase compaction pass.
struct KonigState {
  int64_t n = 0;
  int32_t cap = 0;
  std::vector<int64_t> slot_out, slot_in;
  std::vector<int32_t> color;
  const std::vector<int32_t>* src = nullptr;
  const std::vector<int32_t>* dst = nullptr;
  std::vector<int64_t> chain;  // scratch

  void init(const std::vector<int32_t>& s, const std::vector<int32_t>& d,
            int64_t n_, int32_t cap_) {
    n = n_;
    cap = cap_;
    src = &s;
    dst = &d;
    slot_out.assign(static_cast<size_t>(n) * cap, -1);
    slot_in.assign(static_cast<size_t>(n) * cap, -1);
    color.assign(s.size(), -1);
  }

  // Free color a at v's in-row (a free at u's out-row, b free at v's
  // in-row) by swapping a/b along the maximal alternating chain from v.
  // Returns false if the chain ended occupying a at u -- impossible for
  // the construction's lowest-free choice (Konig's theorem), possible
  // for the compaction's mid-palette targets.
  bool chain_flip(int32_t u, int32_t v, int32_t a, int32_t b) {
    chain.clear();
    int32_t node = v, col = a;
    bool side_in = true;
    for (;;) {
      const int64_t e2 =
          side_in ? slot_in[static_cast<size_t>(node) * cap + col]
                  : slot_out[static_cast<size_t>(node) * cap + col];
      if (e2 < 0) break;
      chain.push_back(e2);
      col = (col == a) ? b : a;
      node = side_in ? (*src)[e2] : (*dst)[e2];
      side_in = !side_in;
    }
    auto toggle = [&]() {
      for (int64_t e2 : chain) {
        const int32_t old = color[e2];
        slot_out[static_cast<size_t>((*src)[e2]) * cap + old] = -1;
        slot_in[static_cast<size_t>((*dst)[e2]) * cap + old] = -1;
      }
      for (int64_t e2 : chain) {
        const int32_t nw = (color[e2] == a) ? b : a;
        color[e2] = nw;
        slot_out[static_cast<size_t>((*src)[e2]) * cap + nw] = e2;
        slot_in[static_cast<size_t>((*dst)[e2]) * cap + nw] = e2;
      }
    };
    toggle();
    if (slot_out[static_cast<size_t>(u) * cap + a] >= 0 ||
        slot_in[static_cast<size_t>(v) * cap + a] >= 0) {
      // provably unreachable when the caller lifted its edge off both
      // rows first; if it ever fires, the per-edge a/b swap is an
      // involution, so re-toggling the SAME recorded chain restores the
      // exact pre-call state -- False never leaves corruption behind
      toggle();
      return false;
    }
    return true;
  }

  // Greedy lowest-shared-slot coloring with Konig chain flips. Returns
  // false only on the (theorem-impossible) construction flip failure.
  bool color_all() {
    const int64_t m = static_cast<int64_t>(src->size());
    for (int64_t e = 0; e < m; ++e) {
      const int32_t u = (*src)[e], v = (*dst)[e];
      int64_t* su = &slot_out[static_cast<size_t>(u) * cap];
      int64_t* sv = &slot_in[static_cast<size_t>(v) * cap];
      int32_t c = -1, a = -1, b = -1;
      for (int32_t w = 0; w < cap; ++w) {
        const bool fu = su[w] < 0, fv = sv[w] < 0;
        if (fu && fv) {
          c = w;
          break;
        }
        if (a < 0 && fu) a = w;
        if (b < 0 && fv) b = w;
      }
      if (c < 0) {
        if (!chain_flip(u, v, a, b)) return false;
        c = a;
      }
      color[e] = c;
      su[c] = e;
      sv[c] = e;
    }
    return true;
  }
};

// Collect deduplicated undirected edges (i < j) from a padded symmetric
// neighbor list.
inline void collect_edges(const int32_t* idx, const uint8_t* mask, int64_t n,
                          int32_t k_in,
                          std::vector<std::pair<int32_t, int32_t>>* edges) {
  edges->clear();
  edges->reserve(static_cast<size_t>(n) * k_in / 2);
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t k = 0; k < k_in; ++k) {
      if (!mask[i * k_in + k]) continue;
      int32_t j = idx[i * k_in + k];
      if (i < j) edges->emplace_back(static_cast<int32_t>(i), j);
    }
  }
}

}  // namespace graphcolor

#endif  // NEWTONNET_NATIVE_GRAPHCOLOR_H_
