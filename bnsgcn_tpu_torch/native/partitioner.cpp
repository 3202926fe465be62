// Native graph partitioner — the framework's METIS replacement.
//
// The reference delegates partitioning to METIS via
// dgl.distributed.partition_graph (reference helper/utils.py:94-95) with
// objtype 'vol' (communication volume) or 'cut' (edge cut). This is a
// self-contained C++ equivalent built around the same goals:
//
//   1. greedy streaming assignment in BFS order (LDG-style: maximize
//      neighbors already in the part, discounted by part fill) — gives
//      locality-coherent balanced parts;
//   2. FM-lite boundary refinement: passes over boundary vertices, moving a
//      vertex to the neighboring part with the best objective gain subject
//      to a balance cap. For 'cut' the gain is the (undirected) edge-cut
//      delta. For 'vol' the gain is the TRUE communication-volume delta on
//      the directed graph: the change in |{(u, j) : j != part(u), u has an
//      out-edge into j}| — v's own halo-part set plus the halo-set changes
//      of every in-neighbor of v (the dominant term), evaluated against a
//      per-pass snapshot of out-neighbor part counts;
//   3. multi-seed best-of: the whole pipeline runs n_seeds times and the
//      partition with the best true objective (directed comm volume for
//      'vol', edge cut for 'cut') wins.
//
// Exposed as a C ABI for ctypes (no pybind11 in this toolchain).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <vector>

namespace {

// Adjacency stores node IDS, which fit int32 (the entry point rejects
// n_nodes > INT32_MAX): halving adj memory is what lets the multilevel
// pipeline fit a 1B-edge graph on a 125 GB host (measured: int64 CSRs
// alone were 36 GB there — union + out + in for the vol objective —
// and the 1.0B-edge multilevel run OOM'd). indptr stays int64: edge
// COUNTS exceed 2^31 at this scale.
struct Csr {
  std::vector<int64_t> indptr;
  std::vector<int32_t> adj;
};

// Undirected CSR over the union of both edge directions, self-loops dropped.
// Templated on the edge-id type: int32 edge lists (any graph under 2^31
// nodes, incl. papers100M) come straight from numpy with no int64 copy —
// the copies were ~25.6 GB of the 1.6B-edge rehearsal's partition peak.
template <class T>
Csr build_csr_union(int64_t n, int64_t m, const T* src,
                    const T* dst) {
  std::vector<int64_t> deg(n, 0);
  for (int64_t e = 0; e < m; ++e) {
    if (src[e] == dst[e]) continue;
    ++deg[src[e]];
    ++deg[dst[e]];
  }
  Csr g;
  g.indptr.assign(n + 1, 0);
  for (int64_t v = 0; v < n; ++v) g.indptr[v + 1] = g.indptr[v] + deg[v];
  g.adj.resize(g.indptr[n]);
  std::vector<int64_t> fill(g.indptr.begin(), g.indptr.end() - 1);
  for (int64_t e = 0; e < m; ++e) {
    if (src[e] == dst[e]) continue;
    g.adj[fill[src[e]]++] = static_cast<int32_t>(dst[e]);
    g.adj[fill[dst[e]]++] = static_cast<int32_t>(src[e]);
  }
  return g;
}

// Directed CSR (rows = src if by_src else dst), self-loops dropped.
template <class T>
Csr build_csr_directed(int64_t n, int64_t m, const T* src,
                       const T* dst, bool by_src) {
  const T* row = by_src ? src : dst;
  const T* col = by_src ? dst : src;
  std::vector<int64_t> deg(n, 0);
  for (int64_t e = 0; e < m; ++e)
    if (src[e] != dst[e]) ++deg[row[e]];
  Csr g;
  g.indptr.assign(n + 1, 0);
  for (int64_t v = 0; v < n; ++v) g.indptr[v + 1] = g.indptr[v] + deg[v];
  g.adj.resize(g.indptr[n]);
  std::vector<int64_t> fill(g.indptr.begin(), g.indptr.end() - 1);
  for (int64_t e = 0; e < m; ++e)
    if (src[e] != dst[e])
      g.adj[fill[row[e]]++] = static_cast<int32_t>(col[e]);
  return g;
}

// Per-vertex (part -> count) lists over out-neighbors: the snapshot the vol
// refinement queries. CSR layout; lists are short (<= min(out_deg, P)).
struct PartCounts {
  std::vector<int64_t> indptr;
  std::vector<int32_t> part;
  std::vector<int32_t> cnt;

  int32_t count(int64_t u, int32_t p) const {
    for (int64_t i = indptr[u]; i < indptr[u + 1]; ++i)
      if (part[i] == p) return cnt[i];
    return 0;
  }
};

PartCounts build_part_counts(int64_t n, const Csr& out, const int32_t* part,
                             int32_t n_parts) {
  PartCounts pc;
  pc.indptr.assign(n + 1, 0);
  std::vector<int32_t> scratch(n_parts, 0);
  std::vector<int32_t> touched;
  // sizing pass
  for (int64_t v = 0; v < n; ++v) {
    touched.clear();
    for (int64_t i = out.indptr[v]; i < out.indptr[v + 1]; ++i) {
      int32_t p = part[out.adj[i]];
      if (scratch[p]++ == 0) touched.push_back(p);
    }
    pc.indptr[v + 1] = pc.indptr[v] + static_cast<int64_t>(touched.size());
    for (int32_t p : touched) scratch[p] = 0;
  }
  pc.part.resize(pc.indptr[n]);
  pc.cnt.resize(pc.indptr[n]);
  int64_t w = 0;
  for (int64_t v = 0; v < n; ++v) {
    touched.clear();
    for (int64_t i = out.indptr[v]; i < out.indptr[v + 1]; ++i) {
      int32_t p = part[out.adj[i]];
      if (scratch[p]++ == 0) touched.push_back(p);
    }
    for (int32_t p : touched) {
      pc.part[w] = p;
      pc.cnt[w++] = scratch[p];
      scratch[p] = 0;
    }
  }
  return pc;
}

int64_t comm_volume_of(int64_t n, const Csr& out, const int32_t* part,
                       int32_t n_parts) {
  int64_t vol = 0;
  std::vector<uint8_t> seen(n_parts, 0);
  std::vector<int32_t> touched;
  for (int64_t v = 0; v < n; ++v) {
    touched.clear();
    for (int64_t i = out.indptr[v]; i < out.indptr[v + 1]; ++i) {
      int32_t p = part[out.adj[i]];
      if (!seen[p]) { seen[p] = 1; touched.push_back(p); }
    }
    for (int32_t p : touched) {
      if (p != part[v]) ++vol;
      seen[p] = 0;
    }
  }
  return vol;
}

int64_t edge_cut_of(const Csr& uni, const int32_t* part) {
  int64_t cut = 0;
  for (int64_t v = 0; v + 1 < static_cast<int64_t>(uni.indptr.size()); ++v)
    for (int64_t i = uni.indptr[v]; i < uni.indptr[v + 1]; ++i)
      if (part[v] != part[uni.adj[i]]) ++cut;
  return cut / 2;  // union CSR holds both directions
}

// ---------------------------------------------------------------------------
// multilevel machinery: HEM coarsening + weighted LDG/FM. The classic
// multilevel scheme (coarsen, partition the small graph where FM moves are
// global, project back, refine locally at each level) sees community
// structure the single-level streaming pass cannot: a whole cluster is one
// coarse vertex, so the initial partition never splits it by accident.
// ---------------------------------------------------------------------------

// Weighted undirected graph. Empty wgt/vwgt mean "all ones".
struct WGraph {
  std::vector<int64_t> indptr;
  std::vector<int32_t> adj;   // node ids (int32 — see Csr)
  std::vector<int32_t> wgt;   // edge weights (parallel to adj)
  std::vector<int32_t> vwgt;  // vertex weights
};

// Non-owning view: level 0 is the caller's union CSR with implicit unit
// weights — at papers100M scale a deep copy would cost GBs.
struct WView {
  const int64_t* indptr;
  const int32_t* adj;
  const int32_t* wgt;    // nullptr = all ones
  const int32_t* vwgt;   // nullptr = all ones
  int64_t n_v;

  int64_t n() const { return n_v; }
  int32_t ew(int64_t i) const { return wgt ? wgt[i] : 1; }
  int32_t vw(int64_t v) const { return vwgt ? vwgt[v] : 1; }
};

WView view_of(const WGraph& g) {
  return {g.indptr.data(), g.adj.data(),
          g.wgt.empty() ? nullptr : g.wgt.data(),
          g.vwgt.empty() ? nullptr : g.vwgt.data(),
          static_cast<int64_t>(g.indptr.size()) - 1};
}

WView view_of(const Csr& g) {
  return {g.indptr.data(), g.adj.data(), nullptr, nullptr,
          static_cast<int64_t>(g.indptr.size()) - 1};
}

// Heavy-edge matching: each unmatched vertex (random visit order) pairs with
// its heaviest unmatched neighbor whose combined weight stays under
// max_vwgt; singletons self-match. Returns the coarse graph and fills
// cmap[fine] = coarse id.
WGraph hem_coarsen(const WView& g, std::vector<int32_t>& cmap,
                   int32_t max_vwgt, std::mt19937_64& rng) {
  const int64_t n = g.n();
  cmap.assign(n, -1);
  std::vector<int64_t> order(n);
  for (int64_t v = 0; v < n; ++v) order[v] = v;
  std::shuffle(order.begin(), order.end(), rng);
  int64_t nc = 0;
  std::vector<int64_t> match(n, -1);
  for (int64_t v : order) {
    if (match[v] >= 0) continue;
    int64_t best_u = -1;
    int32_t best_w = 0;
    for (int64_t i = g.indptr[v]; i < g.indptr[v + 1]; ++i) {
      int64_t u = g.adj[i];
      if (u == v || match[u] >= 0) continue;
      if (g.vw(v) + g.vw(u) > max_vwgt) continue;
      if (g.ew(i) > best_w) { best_w = g.ew(i); best_u = u; }
    }
    match[v] = v;
    if (best_u >= 0) match[best_u] = v;
    cmap[v] = static_cast<int32_t>(nc);
    if (best_u >= 0) cmap[best_u] = static_cast<int32_t>(nc);
    ++nc;
  }

  WGraph c;
  c.indptr.assign(nc + 1, 0);
  c.vwgt.assign(nc, 0);
  for (int64_t v = 0; v < n; ++v) c.vwgt[cmap[v]] += g.vw(v);
  // counting-sort membership (coarse id -> fine members): flat arrays, no
  // per-vertex vector allocations
  std::vector<int64_t> moff(nc + 1, 0), morder(n);
  for (int64_t v = 0; v < n; ++v) ++moff[cmap[v] + 1];
  for (int64_t cv = 0; cv < nc; ++cv) moff[cv + 1] += moff[cv];
  {
    std::vector<int64_t> fill(moff.begin(), moff.end() - 1);
    for (int64_t v = 0; v < n; ++v) morder[fill[cmap[v]]++] = v;
  }
  // accumulate coarse adjacency with a scratch map (touched-list trick)
  std::vector<int32_t> scratch(nc, 0);
  std::vector<int64_t> touched;
  for (int64_t cv = 0; cv < nc; ++cv) {        // sizing pass
    touched.clear();
    for (int64_t k = moff[cv]; k < moff[cv + 1]; ++k) {
      int64_t v = morder[k];
      for (int64_t i = g.indptr[v]; i < g.indptr[v + 1]; ++i) {
        int64_t cu = cmap[g.adj[i]];
        if (cu == cv) continue;
        if (scratch[cu] == 0) touched.push_back(cu);
        scratch[cu] += g.ew(i);
      }
    }
    c.indptr[cv + 1] = c.indptr[cv] + static_cast<int64_t>(touched.size());
    for (int64_t cu : touched) scratch[cu] = 0;
  }
  c.adj.resize(c.indptr[nc]);
  c.wgt.resize(c.indptr[nc]);
  int64_t w = 0;
  for (int64_t cv = 0; cv < nc; ++cv) {
    touched.clear();
    for (int64_t k = moff[cv]; k < moff[cv + 1]; ++k) {
      int64_t v = morder[k];
      for (int64_t i = g.indptr[v]; i < g.indptr[v + 1]; ++i) {
        int64_t cu = cmap[g.adj[i]];
        if (cu == cv) continue;
        if (scratch[cu] == 0) touched.push_back(cu);
        scratch[cu] += g.ew(i);
      }
    }
    for (int64_t cu : touched) {
      c.adj[w] = static_cast<int32_t>(cu);
      c.wgt[w++] = scratch[cu];
      scratch[cu] = 0;
    }
  }
  return c;
}

// Weighted LDG streaming assignment (BFS order) — phase-1 analog on a
// weighted (coarse) graph: score = edge weight into part x fill discount,
// balance on vertex weight.
void ldg_assign_weighted(const WView& g, int32_t n_parts, int64_t cap,
                         std::mt19937_64& rng, int32_t* part) {
  const int64_t n = g.n();
  std::vector<int64_t> size(n_parts, 0);
  std::vector<int64_t> order(n);
  for (int64_t v = 0; v < n; ++v) order[v] = v;
  std::shuffle(order.begin(), order.end(), rng);
  std::vector<int64_t> nbr_w(n_parts, 0);
  std::vector<int32_t> touched;
  std::queue<int64_t> bfs;
  std::vector<uint8_t> queued(n, 0);
  int64_t cursor = 0, assigned = 0;
  std::fill_n(part, n, -1);
  while (assigned < n) {
    if (bfs.empty()) {
      while (cursor < n && part[order[cursor]] >= 0) ++cursor;
      if (cursor >= n) break;
      queued[order[cursor]] = 1;
      bfs.push(order[cursor]);
    }
    int64_t v = bfs.front();
    bfs.pop();
    if (part[v] >= 0) continue;
    touched.clear();
    for (int64_t i = g.indptr[v]; i < g.indptr[v + 1]; ++i) {
      int32_t p = part[g.adj[i]];
      if (p >= 0) {
        if (nbr_w[p] == 0) touched.push_back(p);
        nbr_w[p] += g.ew(i);
      }
    }
    double best_score = -1.0;
    int32_t best_p = -1;
    for (int32_t p : touched) {
      if (size[p] + g.vw(v) > cap) continue;
      double score = static_cast<double>(nbr_w[p]) *
                     (1.0 - static_cast<double>(size[p]) / cap);
      if (score > best_score) { best_score = score; best_p = p; }
    }
    if (best_p < 0) {
      int64_t min_sz = INT64_MAX;
      for (int32_t p = 0; p < n_parts; ++p)
        if (size[p] < min_sz) { min_sz = size[p]; best_p = p; }
    }
    for (int32_t p : touched) nbr_w[p] = 0;
    part[v] = best_p;
    size[best_p] += g.vw(v);
    for (int64_t i = g.indptr[v]; i < g.indptr[v + 1]; ++i) {
      int64_t u = g.adj[i];
      if (part[u] < 0 && !queued[u]) { queued[u] = 1; bfs.push(u); }
    }
    ++assigned;
  }
}

// Weighted FM cut refinement (boundary moves, weighted gain, vwgt balance).
void fm_refine_weighted(const WView& g, int32_t n_parts, int64_t soft_cap,
                        int32_t passes, int32_t* part,
                        std::vector<int64_t>& size) {
  const int64_t n = g.n();
  std::vector<int64_t> adj_w(n_parts, 0);
  std::vector<int32_t> touched;
  for (int32_t pass = 0; pass < passes; ++pass) {
    int64_t moves = 0;
    for (int64_t v = 0; v < n; ++v) {
      int32_t pv = part[v];
      touched.clear();
      bool boundary = false;
      for (int64_t i = g.indptr[v]; i < g.indptr[v + 1]; ++i) {
        int32_t p = part[g.adj[i]];
        if (adj_w[p] == 0) touched.push_back(p);
        adj_w[p] += g.ew(i);
        if (p != pv) boundary = true;
      }
      if (boundary && size[pv] > g.vw(v)) {
        int64_t best_gain = 0;
        int32_t best_p = -1;
        for (int32_t q : touched) {
          if (q == pv || size[q] + g.vw(v) > soft_cap) continue;
          int64_t gain = adj_w[q] - adj_w[pv];
          if (gain > best_gain) { best_gain = gain; best_p = q; }
        }
        if (best_p >= 0) {
          part[v] = best_p;
          size[pv] -= g.vw(v);
          size[best_p] += g.vw(v);
          ++moves;
        }
      }
      for (int32_t p : touched) adj_w[p] = 0;
    }
    if (moves == 0) break;
  }
}

// Push vertices out of over-cap parts (least-cut-harm boundary moves first,
// then any vertex) until every part is under hard_cap. Unit weights — runs
// at the finest level only.
void rebalance(const Csr& g, int32_t n_parts, int64_t hard_cap,
               int32_t* part, std::vector<int64_t>& size) {
  const int64_t n = static_cast<int64_t>(g.indptr.size()) - 1;
  std::vector<int64_t> adj_in_part(n_parts, 0);
  std::vector<int32_t> touched;
  for (int32_t round = 0; round < 64; ++round) {
    bool over = false;
    for (int32_t p = 0; p < n_parts; ++p) over |= (size[p] > hard_cap);
    if (!over) return;
    for (int64_t v = 0; v < n; ++v) {
      int32_t pv = part[v];
      if (size[pv] <= hard_cap) continue;
      touched.clear();
      for (int64_t i = g.indptr[v]; i < g.indptr[v + 1]; ++i) {
        int32_t p = part[g.adj[i]];
        if (adj_in_part[p] == 0) touched.push_back(p);
        ++adj_in_part[p];
      }
      int64_t best_gain = INT64_MIN;
      int32_t best_p = -1;
      for (int32_t q = 0; q < n_parts; ++q) {
        if (q == pv || size[q] >= hard_cap) continue;
        int64_t gain = adj_in_part[q] - adj_in_part[pv];
        if (gain > best_gain) { best_gain = gain; best_p = q; }
      }
      for (int32_t p : touched) adj_in_part[p] = 0;
      if (best_p >= 0) {
        part[v] = best_p;
        --size[pv];
        ++size[best_p];
      }
    }
  }
}

// hubs fall back to the cut gain: their exact vol delta costs
// O(in_deg * candidates) lookups and they rarely move profitably
constexpr int64_t kVolScanCap = 512;

void refine_true(int64_t n_nodes, const Csr& g, const Csr* out_csr,
                 const Csr* in_csr, int32_t n_parts, int32_t objective,
                 int32_t refine_passes, int32_t* part_p,
                 std::vector<int64_t>& size, int64_t cap);

void partition_once(int64_t n_nodes, const Csr& g, const Csr* out_csr,
                    const Csr* in_csr, int32_t n_parts, int32_t objective,
                    uint64_t seed, int32_t refine_passes, int32_t* part_out) {
  std::mt19937_64 rng(seed);
  const int64_t cap = (n_nodes + n_parts - 1) / n_parts;  // hard balance cap
  std::vector<int32_t> part(n_nodes, -1);
  std::vector<int64_t> size(n_parts, 0);

  // ---- phase 1: BFS-ordered LDG streaming assignment ----
  std::vector<int64_t> order(n_nodes);
  for (int64_t v = 0; v < n_nodes; ++v) order[v] = v;
  std::shuffle(order.begin(), order.end(), rng);

  std::vector<int64_t> nbr_count(n_parts, 0);
  std::vector<int32_t> touched;
  std::queue<int64_t> bfs;
  int64_t cursor = 0;
  std::vector<uint8_t> queued(n_nodes, 0);

  auto assign = [&](int64_t v) {
    touched.clear();
    for (int64_t i = g.indptr[v]; i < g.indptr[v + 1]; ++i) {
      int32_t p = part[g.adj[i]];
      if (p >= 0) {
        if (nbr_count[p] == 0) touched.push_back(p);
        ++nbr_count[p];
      }
    }
    double best_score = -1.0;
    int32_t best_p = -1;
    for (int32_t p : touched) {
      if (size[p] >= cap) continue;
      double score = static_cast<double>(nbr_count[p]) *
                     (1.0 - static_cast<double>(size[p]) / cap);
      if (score > best_score) { best_score = score; best_p = p; }
    }
    if (best_p < 0) {
      int64_t min_sz = INT64_MAX;
      for (int32_t p = 0; p < n_parts; ++p)
        if (size[p] < min_sz) { min_sz = size[p]; best_p = p; }
    }
    for (int32_t p : touched) nbr_count[p] = 0;
    part[v] = best_p;
    ++size[best_p];
    for (int64_t i = g.indptr[v]; i < g.indptr[v + 1]; ++i) {
      int64_t u = g.adj[i];
      if (part[u] < 0 && !queued[u]) { queued[u] = 1; bfs.push(u); }
    }
  };

  int64_t assigned = 0;
  while (assigned < n_nodes) {
    if (bfs.empty()) {
      while (cursor < n_nodes && part[order[cursor]] >= 0) ++cursor;
      if (cursor >= n_nodes) break;
      queued[order[cursor]] = 1;
      bfs.push(order[cursor]);
    }
    int64_t v = bfs.front();
    bfs.pop();
    if (part[v] >= 0) continue;
    assign(v);
    ++assigned;
  }

  // ---- phase 2: FM-lite boundary refinement ----
  refine_true(n_nodes, g, out_csr, in_csr, n_parts, objective, refine_passes,
              part.data(), size, cap);
  std::memcpy(part_out, part.data(), sizeof(int32_t) * n_nodes);
}

// FM-lite refinement against the TRUE objective (directed comm volume for
// 'vol' with exact own+neighbor halo-set deltas, weighted only by the
// unit-weight finest graph; edge cut otherwise). Shared by the flat and
// multilevel pipelines.
void refine_true(int64_t n_nodes, const Csr& g, const Csr* out_csr,
                 const Csr* in_csr, int32_t n_parts, int32_t objective,
                 int32_t refine_passes, int32_t* part_p,
                 std::vector<int64_t>& size, int64_t cap) {
  std::vector<int32_t> part(part_p, part_p + n_nodes);
  std::vector<int32_t> touched;
  std::vector<int64_t> adj_in_part(n_parts, 0);
  const double slack = 1.02;  // allow 2% imbalance during refinement
  const int64_t soft_cap = static_cast<int64_t>(cap * slack);
  const bool vol = (objective == 0) && out_csr && in_csr;

  for (int32_t pass = 0; pass < refine_passes; ++pass) {
    PartCounts pc;
    if (vol) pc = build_part_counts(n_nodes, *out_csr, part.data(), n_parts);
    int64_t moves = 0;
    for (int64_t v = 0; v < n_nodes; ++v) {
      int32_t pv = part[v];
      touched.clear();
      bool boundary = false;
      for (int64_t i = g.indptr[v]; i < g.indptr[v + 1]; ++i) {
        int32_t p = part[g.adj[i]];
        if (adj_in_part[p] == 0) touched.push_back(p);
        ++adj_in_part[p];
        if (p != pv) boundary = true;
      }
      if (boundary && size[pv] > 1) {
        const int64_t in_deg =
            in_csr ? in_csr->indptr[v + 1] - in_csr->indptr[v] : 0;
        const bool vol_exact = vol && in_deg <= kVolScanCap;
        // common removal term: every in-neighbor u for which v is u's ONLY
        // out-neighbor in pv stops treating pv as halo (snapshot counts)
        int64_t gain_remove = 0;
        if (vol_exact) {
          for (int64_t i = in_csr->indptr[v]; i < in_csr->indptr[v + 1]; ++i) {
            int64_t u = in_csr->adj[i];
            if (part[u] != pv && pc.count(u, pv) == 1) ++gain_remove;
          }
        }
        int64_t best_gain = 0;
        int32_t best_p = -1;
        for (int32_t q : touched) {
          if (q == pv || size[q] >= soft_cap) continue;
          int64_t gain;
          if (!vol) {                                 // cut
            gain = adj_in_part[q] - adj_in_part[pv];
          } else if (!vol_exact) {                    // hub: cut proxy
            gain = adj_in_part[q] - adj_in_part[pv];
          } else {
            // own halo-set term: O = v's out-neighbor parts (snapshot)
            gain = gain_remove;
            gain += (pc.count(v, q) > 0 ? 1 : 0) - (pc.count(v, pv) > 0 ? 1 : 0);
            // addition term: in-neighbors that did not see q before now do
            for (int64_t i = in_csr->indptr[v]; i < in_csr->indptr[v + 1]; ++i) {
              int64_t u = in_csr->adj[i];
              if (part[u] != q && pc.count(u, q) == 0) --gain;
            }
          }
          if (gain > best_gain) { best_gain = gain; best_p = q; }
        }
        if (best_p >= 0) {
          part[v] = best_p;
          --size[pv];
          ++size[best_p];
          ++moves;
        }
      }
      for (int32_t p : touched) adj_in_part[p] = 0;
    }
    if (moves == 0) break;
  }

  std::memcpy(part_p, part.data(), sizeof(int32_t) * n_nodes);
}

// Multilevel pipeline: HEM-coarsen to ~max(256, 24*P) vertices, weighted
// LDG + weighted FM on the coarsest graph, project up with per-level
// weighted FM, then the true-objective refinement + hard rebalance at the
// finest level. Same output contract as partition_once (balance cap
// ceil(n/P)*1.02 is enforced by rebalance()).
void partition_multilevel(int64_t n_nodes, const Csr& uni, const Csr* out_csr,
                          const Csr* in_csr, int32_t n_parts,
                          int32_t objective, uint64_t seed,
                          int32_t refine_passes, int32_t* part_out) {
  std::mt19937_64 rng(seed);
  // level 0 borrows the union CSR as a view (unit weights, zero copies);
  // coarse levels own their graphs
  std::vector<WGraph> coarse;
  std::vector<WView> levels = {view_of(uni)};
  std::vector<std::vector<int32_t>> cmaps;
  const int64_t target = std::max<int64_t>(256, 24 * n_parts);
  const int32_t max_vwgt = static_cast<int32_t>(std::max<int64_t>(
      1, n_nodes / (8 * n_parts)));
  while (levels.back().n() > target) {
    std::vector<int32_t> cmap;
    const int64_t fine_edges = levels.back().indptr[levels.back().n()];
    WGraph c = hem_coarsen(levels.back(), cmap, max_vwgt, rng);
    if (c.indptr.size() - 1 >
        static_cast<size_t>(levels.back().n()) * 95 / 100)
      break;                                           // matching stalled
    // EDGE-shrink stall: every retained level costs 8 bytes/coarse-edge
    // (int32 adj + wgt) until uncoarsening finishes. On weakly-clustered
    // graphs HEM merges vertices but few parallel edges consolidate, so
    // near-full-size levels pile up — the exact regime where multilevel
    // adds no quality over the flat pipeline anyway (measured: the 1.0B-
    // edge synthetic power-law OOM'd a 125 GB host on retained levels).
    // Clustered graphs consolidate edges geometrically and never trip it.
    const bool edge_stall =
        c.indptr[c.indptr.size() - 1] > fine_edges * 85 / 100;
    cmaps.push_back(std::move(cmap));
    coarse.push_back(std::move(c));
    levels.push_back(view_of(coarse.back()));
    if (edge_stall) break;                             // one level, then stop
  }

  // initial partition on the coarsest level: weighted LDG + deep weighted
  // FM. The deep 16-pass FM is sized for a ~target-vertex coarsest graph;
  // after an edge-shrink stall the "coarsest" level is near-full-size and
  // each pass scans most of the graph — cap the depth there (quality in
  // that regime comes from the flat-style LDG + true-objective refinement).
  const WView& coarsest = levels.back();
  const int64_t cap = (n_nodes + n_parts - 1) / n_parts;
  const int64_t soft_cap = static_cast<int64_t>(cap * 1.02);
  std::vector<int32_t> part(coarsest.n());
  ldg_assign_weighted(coarsest, n_parts, soft_cap, rng, part.data());
  std::vector<int64_t> size(n_parts, 0);
  for (int64_t v = 0; v < coarsest.n(); ++v) size[part[v]] += coarsest.vw(v);
  const int32_t deep_passes = coarsest.n() <= 16 * target ? 16 : 3;
  fm_refine_weighted(coarsest, n_parts, soft_cap, deep_passes, part.data(),
                     size);

  // uncoarsen: project, then local weighted FM at every level
  for (int64_t lvl = static_cast<int64_t>(levels.size()) - 2; lvl >= 0;
       --lvl) {
    const std::vector<int32_t>& cmap = cmaps[lvl];
    const WView& g = levels[lvl];
    std::vector<int32_t> fine(g.n());
    for (int64_t v = 0; v < g.n(); ++v) fine[v] = part[cmap[v]];
    part.swap(fine);
    std::fill(size.begin(), size.end(), 0);
    for (int64_t v = 0; v < g.n(); ++v) size[part[v]] += g.vw(v);
    fm_refine_weighted(g, n_parts, soft_cap, lvl == 0 ? 1 : 3, part.data(),
                       size);
  }

  // finest level: hard balance, then the true-objective refinement
  rebalance(uni, n_parts, soft_cap, part.data(), size);
  refine_true(n_nodes, uni, out_csr, in_csr, n_parts, objective,
              refine_passes, part.data(), size, cap);
  rebalance(uni, n_parts, soft_cap, part.data(), size);
  std::memcpy(part_out, part.data(), sizeof(int32_t) * n_nodes);
}

}  // namespace

// Returns 0 on success. out_part must hold n_nodes int32. n_seeds > 1 runs
// the pipeline per seed and keeps the partition with the best true
// objective. multilevel != 0 selects the HEM-coarsen pipeline (better
// quality on clustered graphs); 0 the flat LDG+FM one.
template <class T>
int partition_v2_impl(int64_t n_nodes, int64_t n_edges, const T* src,
                      const T* dst, int32_t n_parts, int32_t objective,
                      uint64_t seed, int32_t refine_passes, int32_t n_seeds,
                      int32_t multilevel, int32_t* out_part) {
  if (n_parts <= 0 || n_nodes <= 0) return 1;
  if (n_nodes > INT32_MAX) return 3;   // adj stores int32 node ids; the
                                       // Python binding falls back to the
                                       // pure-Python partitioner on any
                                       // nonzero rc
  if (n_parts == 1) {
    std::memset(out_part, 0, sizeof(int32_t) * n_nodes);
    return 0;
  }
  Csr g = build_csr_union(n_nodes, n_edges, src, dst);
  Csr out_csr, in_csr;
  const bool vol = (objective == 0);
  if (vol) {
    out_csr = build_csr_directed(n_nodes, n_edges, src, dst, true);
    in_csr = build_csr_directed(n_nodes, n_edges, src, dst, false);
  }
  if (n_seeds < 1) n_seeds = 1;
  std::vector<int32_t> cand(n_nodes);
  int64_t best_obj = INT64_MAX;
  for (int32_t s = 0; s < n_seeds; ++s) {
    const uint64_t sd =
        seed + static_cast<uint64_t>(s) * 0x9e3779b97f4a7c15ULL;
    // multilevel mode keeps one flat candidate (the last seed) in the
    // best-of pool: on structure-free graphs coarsening has nothing to
    // exploit and the flat streaming pass can win by a few percent
    const bool use_ml = multilevel && (n_seeds == 1 || s < n_seeds - 1);
    if (use_ml) {
      partition_multilevel(n_nodes, g, vol ? &out_csr : nullptr,
                           vol ? &in_csr : nullptr, n_parts, objective, sd,
                           refine_passes, cand.data());
    } else {
      partition_once(n_nodes, g, vol ? &out_csr : nullptr,
                     vol ? &in_csr : nullptr, n_parts, objective, sd,
                     refine_passes, cand.data());
    }
    int64_t obj = vol ? comm_volume_of(n_nodes, out_csr, cand.data(), n_parts)
                      : edge_cut_of(g, cand.data());
    if (obj < best_obj) {
      best_obj = obj;
      std::memcpy(out_part, cand.data(), sizeof(int32_t) * n_nodes);
    }
  }
  return 0;
}

extern "C" {

int bns_partition_v2(int64_t n_nodes, int64_t n_edges, const int64_t* src,
                     const int64_t* dst, int32_t n_parts, int32_t objective,
                     uint64_t seed, int32_t refine_passes, int32_t n_seeds,
                     int32_t multilevel, int32_t* out_part) {
  return partition_v2_impl(n_nodes, n_edges, src, dst, n_parts, objective,
                           seed, refine_passes, n_seeds, multilevel,
                           out_part);
}

// int32 edge lists: zero-copy from numpy for any graph under 2^31 nodes.
int bns_partition_v2_i32(int64_t n_nodes, int64_t n_edges, const int32_t* src,
                         const int32_t* dst, int32_t n_parts,
                         int32_t objective, uint64_t seed,
                         int32_t refine_passes, int32_t n_seeds,
                         int32_t multilevel, int32_t* out_part) {
  return partition_v2_impl(n_nodes, n_edges, src, dst, n_parts, objective,
                           seed, refine_passes, n_seeds, multilevel,
                           out_part);
}

// Back-compat entry: the flat pipeline.
int bns_partition(int64_t n_nodes, int64_t n_edges, const int64_t* src,
                  const int64_t* dst, int32_t n_parts, int32_t objective,
                  uint64_t seed, int32_t refine_passes, int32_t n_seeds,
                  int32_t* out_part) {
  return bns_partition_v2(n_nodes, n_edges, src, dst, n_parts, objective,
                          seed, refine_passes, n_seeds, 0, out_part);
}

// Quality metrics for tests/logging (directed edge list).
int64_t bns_edge_cut(int64_t n_edges, const int64_t* src, const int64_t* dst,
                     const int32_t* part) {
  int64_t cut = 0;
  for (int64_t e = 0; e < n_edges; ++e)
    if (part[src[e]] != part[dst[e]]) ++cut;
  return cut;
}

// Directed communication volume: |{(u, j) : j != part(u), u has out-edge
// into j}| — the full-rate halo payload (what BNS compresses; matches
// data/partitioner.comm_volume).
int64_t bns_comm_volume(int64_t n_nodes, int64_t n_edges, const int64_t* src,
                        const int64_t* dst, int32_t n_parts,
                        const int32_t* part) {
  if (n_nodes > INT32_MAX) return -1;  // int32 adj (binding treats <0 as
                                       // "unavailable" and falls back)
  Csr out_csr = build_csr_directed(n_nodes, n_edges, src, dst, true);
  int64_t vol = comm_volume_of(n_nodes, out_csr, part, n_parts);
  // comm_volume in data/partitioner.py counts self-loop-free out-edges only,
  // which build_csr_directed already guarantees.
  return vol;
}

}  // extern "C"
