// Exact s-t mincut for binary pairwise MRFs (native C++ component).
//
// Closes the gap between our GC-RANSAC's device-side ICM labeling and the
// reference's true graph-cut (pygcransac's local optimization; consumed in
// /root/reference/baseline_scripts/baseline_3DMatch.py:101-123). The energy
//
//   E(L) = sum_i [ L_i * c_in_i + (1-L_i) * c_out_i ]
//        + sum_{(i,j)} w_ij * [L_i != L_j]
//
// with w_ij >= 0 (Potts) is submodular, so its global minimum is an s-t
// mincut on the standard construction: cap(s->i) = c_in_i (paid when
// L_i = 1, i.e. i on the sink side), cap(i->t) = c_out_i, and a pair of
// residual-coupled arcs i<->j with capacity w_ij.
//
// Algorithm: Dinic's blocking-flow maxflow with double capacities. The
// graphs here are sparse kNN graphs (E ~ 8N, N up to a few 10k), where
// Dinic runs in milliseconds; BK would be faster still but the simplicity
// and exactness matter more than the constant.
//
//     double mincut_labels(int n, int ne, const int* ei, const int* ej,
//                          const double* w, const double* c_in,
//                          const double* c_out, unsigned char* labels_out);
//
// Returns the minimum energy; labels_out[i] = 1 for nodes on the sink side
// (label "inlier"). Ties (zero-residual-capacity plateaus) resolve to the
// source side, matching the convention that unreachable == inlier.
//
// Build: make -C pointdsc_tpu/native

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Dinic {
  struct Edge {
    int to;
    double cap;
    int rev;  // index of reverse edge in graph[to]
  };
  int n;
  std::vector<std::vector<Edge>> g;
  std::vector<int> level, iter;

  explicit Dinic(int n_) : n(n_), g(n_), level(n_), iter(n_) {}

  void add_edge(int from, int to, double cap, double rcap = 0.0) {
    g[from].push_back({to, cap, static_cast<int>(g[to].size())});
    g[to].push_back({from, rcap, static_cast<int>(g[from].size()) - 1});
  }

  bool bfs(int s, int t) {
    std::fill(level.begin(), level.end(), -1);
    std::queue<int> q;
    level[s] = 0;
    q.push(s);
    while (!q.empty()) {
      int v = q.front();
      q.pop();
      for (const Edge& e : g[v]) {
        if (e.cap > 1e-12 && level[e.to] < 0) {
          level[e.to] = level[v] + 1;
          q.push(e.to);
        }
      }
    }
    return level[t] >= 0;
  }

  double dfs(int v, int t, double f) {
    if (v == t) return f;
    for (int& i = iter[v]; i < static_cast<int>(g[v].size()); ++i) {
      Edge& e = g[v][i];
      if (e.cap > 1e-12 && level[v] < level[e.to]) {
        double d = dfs(e.to, t, std::min(f, e.cap));
        if (d > 0) {
          e.cap -= d;
          g[e.to][e.rev].cap += d;
          return d;
        }
      }
    }
    return 0.0;
  }

  double max_flow(int s, int t) {
    double flow = 0.0;
    while (bfs(s, t)) {
      std::fill(iter.begin(), iter.end(), 0);
      double f;
      while ((f = dfs(s, t, 1e300)) > 0) flow += f;
    }
    return flow;
  }

  // nodes reachable from s in the residual graph (source side of the cut)
  void min_cut_side(int s, std::vector<uint8_t>& in_source) const {
    in_source.assign(n, 0);
    std::queue<int> q;
    in_source[s] = 1;
    q.push(s);
    while (!q.empty()) {
      int v = q.front();
      q.pop();
      for (const Edge& e : g[v]) {
        if (e.cap > 1e-12 && !in_source[e.to]) {
          in_source[e.to] = 1;
          q.push(e.to);
        }
      }
    }
  }
};

}  // namespace

extern "C" {

// n nodes; ne undirected edges (ei[k], ej[k]) with Potts weight w[k] >= 0
// (duplicate (i,j) entries accumulate). Unary costs c_in (cost of label 1)
// and c_out (cost of label 0) per node; non-finite/huge c_in forces label 0.
// labels_out: n bytes, 1 = label "inlier". Returns the exact minimum energy.
double mincut_labels(int n, int ne, const int* ei, const int* ej,
                     const double* w, const double* c_in, const double* c_out,
                     unsigned char* labels_out) {
  const int S = n, T = n + 1;
  const double kBig = 1e15;
  Dinic din(n + 2);
  // constant offset: subtracting min(c_in, c_out) per node keeps one
  // terminal arc per node and the flow value equal to E - offset
  double offset = 0.0;
  for (int i = 0; i < n; ++i) {
    double ci = c_in[i], co = c_out[i];
    if (!(ci < kBig)) ci = kBig;  // also catches inf/nan: force label 0
    if (!(co < kBig)) co = kBig;
    double m = std::min(ci, co);
    offset += m;
    if (ci - m > 0) din.add_edge(S, i, ci - m);  // severed when L_i = 1
    if (co - m > 0) din.add_edge(i, T, co - m);  // severed when L_i = 0
  }
  for (int k = 0; k < ne; ++k) {
    if (w[k] <= 0) continue;
    // one residual-coupled arc pair carries the Potts cost in both
    // directions: forward cap w with reverse cap w
    din.add_edge(ei[k], ej[k], w[k], w[k]);
  }
  double flow = din.max_flow(S, T);
  std::vector<uint8_t> in_source;
  din.min_cut_side(S, in_source);
  for (int i = 0; i < n; ++i) labels_out[i] = in_source[i] ? 0 : 1;
  return flow + offset;
}

}  // extern "C"
