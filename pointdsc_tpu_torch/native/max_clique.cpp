// Exact maximum-clique solver (native C++ component).
//
// Drop-in replacement for the reference's prebuilt utils/libpmc.so (Rossi et
// al.'s PMC, consumed through ctypes in /root/reference/utils/max_clique.py:
// 29-36 and used by the PMC baseline, baseline_scripts/baseline_3DMatch.py:
// 56-77). Same C ABI:
//
//     int max_clique(int ne, const int* ei, const int* ej,
//                    int offset, int outsize, int* out);
//
// Algorithm: branch and bound with greedy-coloring upper bounds (Tomita-style
// MCS), on top of a degeneracy-ordered vertex sequence. The outer loop over
// root vertices runs under OpenMP with a shared atomic incumbent so threads
// prune against the global best.
//
// Build: make -C pointdsc_tpu/native   (g++ -O3 -fopenmp -shared -fPIC)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Graph {
  int n = 0;
  std::vector<std::vector<int>> adj;       // sorted neighbor lists
  std::vector<std::vector<uint64_t>> bits; // adjacency bitsets, n x ceil(n/64)
  int words = 0;

  bool connected(int u, int v) const {
    return (bits[u][v >> 6] >> (v & 63)) & 1ULL;
  }
};

Graph build_graph(int ne, const int* ei, const int* ej) {
  Graph g;
  int maxv = -1;
  for (int e = 0; e < ne; ++e) maxv = std::max(maxv, std::max(ei[e], ej[e]));
  g.n = maxv + 1;
  g.words = (g.n + 63) / 64;
  g.adj.assign(g.n, {});
  g.bits.assign(g.n, std::vector<uint64_t>(g.words, 0));
  for (int e = 0; e < ne; ++e) {
    int u = ei[e], v = ej[e];
    if (u == v) continue;
    if (!g.connected(u, v)) {
      g.bits[u][v >> 6] |= 1ULL << (v & 63);
      g.bits[v][u >> 6] |= 1ULL << (u & 63);
      g.adj[u].push_back(v);
      g.adj[v].push_back(u);
    }
  }
  for (auto& a : g.adj) std::sort(a.begin(), a.end());
  return g;
}

// Degeneracy (smallest-last) ordering: repeatedly remove the minimum-degree
// vertex. Returns the removal order; the k-core bound it yields tightens the
// root-level pruning.
std::vector<int> degeneracy_order(const Graph& g, int& degeneracy) {
  int n = g.n;
  std::vector<int> deg(n), order;
  order.reserve(n);
  std::vector<char> removed(n, 0);
  int maxdeg = 0;
  for (int v = 0; v < n; ++v) {
    deg[v] = static_cast<int>(g.adj[v].size());
    maxdeg = std::max(maxdeg, deg[v]);
  }
  std::vector<std::vector<int>> buckets(maxdeg + 1);
  for (int v = 0; v < n; ++v) buckets[deg[v]].push_back(v);
  degeneracy = 0;
  int cur = 0;
  for (int it = 0; it < n; ++it) {
    while (cur <= maxdeg && buckets[cur].empty()) ++cur;
    // vertices may appear in stale buckets; skip removed or out-of-date
    while (cur <= maxdeg) {
      if (buckets[cur].empty()) { ++cur; continue; }
      int v = buckets[cur].back();
      buckets[cur].pop_back();
      if (removed[v] || deg[v] != cur) continue;
      removed[v] = 1;
      order.push_back(v);
      degeneracy = std::max(degeneracy, cur);
      for (int u : g.adj[v]) {
        if (!removed[u]) {
          --deg[u];
          buckets[deg[u]].push_back(u);
          if (deg[u] < cur) cur = deg[u];
        }
      }
      break;
    }
  }
  return order;
}

// Greedy coloring of candidate set P (vector of vertices): returns vertices
// reordered so colors are nondecreasing, with parallel color numbers.
// color[i] is an upper bound on the clique size within {P[0..i]}.
void color_sort(const Graph& g, std::vector<int>& P, std::vector<int>& colors) {
  const int np = static_cast<int>(P.size());
  colors.resize(np);
  // color classes as bitsets over P indices is overkill; track per-class lists
  static thread_local std::vector<std::vector<int>> classes;
  classes.clear();
  for (int idx = 0; idx < np; ++idx) {
    int v = P[idx];
    int c = 0;
    for (;; ++c) {
      if (c == static_cast<int>(classes.size())) {
        classes.emplace_back();
        break;
      }
      bool clash = false;
      for (int u : classes[c]) {
        if (g.connected(v, u)) { clash = true; break; }
      }
      if (!clash) break;
    }
    classes[c].push_back(v);
  }
  int k = 0;
  for (int c = 0; c < static_cast<int>(classes.size()); ++c) {
    for (int v : classes[c]) {
      P[k] = v;
      colors[k] = c + 1;
      ++k;
    }
  }
}

struct Searcher {
  const Graph& g;
  std::atomic<int>& best_size;
  std::vector<int> best_clique;   // thread-local best
  std::vector<int> current;

  explicit Searcher(const Graph& gg, std::atomic<int>& bs) : g(gg), best_size(bs) {}

  void expand(std::vector<int>& P) {
    std::vector<int> colors;
    color_sort(g, P, colors);
    for (int i = static_cast<int>(P.size()) - 1; i >= 0; --i) {
      int bound = static_cast<int>(current.size()) + colors[i];
      if (bound <= best_size.load(std::memory_order_relaxed)) return;
      int v = P[i];
      current.push_back(v);
      std::vector<int> Pv;
      Pv.reserve(i);
      for (int j = 0; j < i; ++j)
        if (g.connected(v, P[j])) Pv.push_back(P[j]);
      if (Pv.empty()) {
        int sz = static_cast<int>(current.size());
        int prev = best_size.load(std::memory_order_relaxed);
        while (sz > prev &&
               !best_size.compare_exchange_weak(prev, sz,
                                                std::memory_order_relaxed)) {
        }
        if (sz > static_cast<int>(best_clique.size())) best_clique = current;
      } else {
        expand(Pv);
      }
      current.pop_back();
    }
  }
};

}  // namespace

extern "C" {

// Same signature as the reference libpmc.so entry point.
// ei/ej: edge list (0-based, ne edges). offset: index base (0 in practice).
// out/outsize: output buffer for clique member indices.
// Returns the clique size (clamped to outsize entries written).
int max_clique(int ne, const int* ei, const int* ej, int offset, int outsize,
               int* out) {
  if (ne <= 0) return 0;
  std::vector<int> ei_adj(ne), ej_adj(ne);
  for (int e = 0; e < ne; ++e) {
    ei_adj[e] = ei[e] - offset;
    ej_adj[e] = ej[e] - offset;
  }
  Graph g = build_graph(ne, ei_adj.data(), ej_adj.data());

  int degeneracy = 0;
  std::vector<int> order = degeneracy_order(g, degeneracy);
  // position of each vertex in the degeneracy order (later = higher)
  std::vector<int> pos(g.n);
  for (int i = 0; i < g.n; ++i) pos[order[i]] = i;

  std::atomic<int> best_size(0);
  std::vector<int> best;

#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    Searcher s(g, best_size);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 8)
#endif
    for (int i = 0; i < g.n; ++i) {
      int v = order[i];
      if (static_cast<int>(g.adj[v].size()) + 1 <=
          best_size.load(std::memory_order_relaxed))
        continue;
      // candidates: neighbors of v that come after v in degeneracy order
      std::vector<int> P;
      for (int u : g.adj[v])
        if (pos[u] > i) P.push_back(u);
      if (static_cast<int>(P.size()) + 1 <=
          best_size.load(std::memory_order_relaxed))
        continue;
      s.current.assign(1, v);
      if (P.empty()) {
        int prev = best_size.load(std::memory_order_relaxed);
        while (1 > prev && !best_size.compare_exchange_weak(prev, 1)) {
        }
        if (s.best_clique.empty()) s.best_clique = s.current;
      } else {
        s.expand(P);
      }
    }
#ifdef _OPENMP
#pragma omp critical
#endif
    {
      if (static_cast<int>(s.best_clique.size()) >
          static_cast<int>(best.size()))
        best = s.best_clique;
    }
  }

  int sz = static_cast<int>(best.size());
  int nwrite = std::min(sz, outsize);
  for (int i = 0; i < nwrite; ++i) out[i] = best[i] + offset;
  return nwrite;
}

}  // extern "C"
