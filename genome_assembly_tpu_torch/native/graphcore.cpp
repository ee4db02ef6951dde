// C++ graph runtime for the overlap-graph assembler.
//
// Implements the greedy weakest-edge cycle-removal loop (reference
// overlapGraphs.py:106-130: repeat { find first cycle via edge-DFS; delete
// its minimum-weight edge } until acyclic) with semantics identical to the
// Python engine in genome_assembly_tpu/graph/cycles.py, which itself
// reproduces NetworkX find_cycle(orientation='original') iteration order. This loop is the
// reference's documented 48-hour scaling wall (report p.4 footnote ii) —
// the C++ engine is typically 100-1000x the Python/NetworkX loop.
//
// Exposed via a C ABI for ctypes (see graphcore.py). Six entry points,
// the ones this package calls: gc_remove_cycles_v2 (cycle removal) and
// gc_remove_cycles (the same removals by the full-restart loop, selected
// by remove_cycles(legacy=True) or GA_TPU_CYCLES_LEGACY=1),
// gc_overlap_nogap_pairs (host pair scoring on a CPU device),
// gc_local_align_batch and gc_local_align_banded_batch (the metrics pass's
// full-width and banded Smith-Waterman on a CPU device) and gc_greedy_chain
// (the accept loop of the fast greedy layout).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define RESTRICT __restrict__

namespace {

// Inclusive running max: rn[j] = max(init, max(ky[lo..j])) for j in
// [lo, hi] — the one serial dependency of the prefix-scan SW rows.
// An AVX-512 in-register log-step scan (4 alignr+max per 16 lanes,
// reduce-max carry) was tried and MEASURED SLOWER (1.08 vs 1.35
// Gcells/s end-to-end on this host): the cross-iteration carry's
// broadcast->reduce latency chain is longer than 16 pipelined scalar
// cmov/max ops, and 512-bit shuffles pay their own toll. Scalar wins.
inline void prefix_max_i32(const int32_t* RESTRICT ky,
                           int32_t* RESTRICT rn, int64_t lo, int64_t hi,
                           int32_t init) {
  int32_t running = init;
  for (int64_t j = lo; j <= hi; ++j) {
    running = ky[j] > running ? ky[j] : running;
    rn[j] = running;
  }
}

}  // namespace

namespace {

struct Graph {
  int64_t num_nodes;
  int64_t num_edges;
  const int32_t* src;
  const int32_t* dst;
  const int32_t* weight;
  uint8_t* alive;
  // CSR adjacency in edge-insertion order
  std::vector<int64_t> adj_start;  // size num_nodes+1
  std::vector<int64_t> adj_edges;  // size num_edges (edge indices)

  void build_adjacency() {
    std::vector<int64_t> counts(num_nodes + 1, 0);
    for (int64_t e = 0; e < num_edges; ++e) counts[src[e] + 1]++;
    adj_start.assign(num_nodes + 1, 0);
    for (int64_t v = 0; v < num_nodes; ++v)
      adj_start[v + 1] = adj_start[v] + counts[v + 1];
    adj_edges.assign(num_edges, 0);
    std::vector<int64_t> cursor(adj_start.begin(), adj_start.end() - 1);
    for (int64_t e = 0; e < num_edges; ++e) adj_edges[cursor[src[e]]++] = e;
  }
};

// Scratch for repeated cycle searches; epoch-stamped to avoid O(V) clears.
struct Scratch {
  std::vector<int64_t> iter_pos;       // per-node adjacency cursor
  std::vector<uint32_t> visited_mark;  // edge-DFS visited stamp
  std::vector<uint32_t> active_mark;   // active-path stamp
  std::vector<uint32_t> explored_mark; // fully-explored stamp (per search)
  std::vector<int32_t> stack;
  std::vector<int64_t> path;           // active path edge indices
  uint32_t epoch = 0;

  void init(int64_t n) {
    iter_pos.assign(n, 0);
    visited_mark.assign(n, 0);
    active_mark.assign(n, 0);
    explored_mark.assign(n, 0);
  }
};

// Find the first cycle under NetworkX find_cycle('original') semantics.
// Returns true and fills `cycle` (edge indices, trimmed) if found.
bool find_first_cycle(const Graph& g, Scratch& s, std::vector<int64_t>& cycle) {
  const uint32_t explored_epoch = ++s.epoch;  // persists across start nodes
  for (int64_t start = 0; start < g.num_nodes; ++start) {
    if (s.explored_mark[start] == explored_epoch) continue;
    const uint32_t ep = ++s.epoch;  // per-start-node stamps
    s.stack.clear();
    s.path.clear();
    s.stack.push_back((int32_t)start);
    s.active_mark[start] = ep;
    int32_t prev_head = -1;
    int64_t final_node = -1;

    // `seen` = nodes with active_mark/visited... track separately: the
    // reference adds every non-explored head plus the start to `seen` and
    // promotes them to explored if no cycle is found. We stamp them with ep
    // in visited_mark when pushed, and promote below.
    std::vector<int32_t> seen;
    seen.push_back((int32_t)start);

    while (!s.stack.empty()) {
      int32_t node = s.stack.back();
      if (s.visited_mark[node] != ep) {
        s.visited_mark[node] = ep;
        s.iter_pos[node] = g.adj_start[node];
      }
      int64_t pos = s.iter_pos[node];
      int64_t eidx = -1;
      const int64_t end = g.adj_start[node + 1];
      while (pos < end) {
        int64_t e = g.adj_edges[pos];
        ++pos;
        if (g.alive[e]) { eidx = e; break; }
      }
      s.iter_pos[node] = pos;
      if (eidx < 0) { s.stack.pop_back(); continue; }
      const int32_t tail = g.src[eidx];
      const int32_t head = g.dst[eidx];
      s.stack.push_back(head);
      if (s.explored_mark[head] == explored_epoch) continue;
      if (prev_head != -1 && tail != prev_head) {
        // backtracked: pop path until its last head == tail
        while (true) {
          if (s.path.empty()) {
            // active set becomes exactly {tail}: every path-edge head was
            // already unmarked on pop, so the only possible survivor is the
            // start node — clear it before marking tail.
            s.active_mark[start] = 0;
            s.active_mark[tail] = ep;
            break;
          }
          int64_t popped = s.path.back();
          s.path.pop_back();
          s.active_mark[g.dst[popped]] = 0;
          if (!s.path.empty() && g.dst[s.path.back()] == tail) break;
        }
      }
      s.path.push_back(eidx);
      if (s.active_mark[head] == ep) {
        final_node = head;
        break;
      }
      seen.push_back(head);
      s.active_mark[head] = ep;
      prev_head = head;
    }

    if (final_node >= 0) {
      // trim leading edges before the cycle entry
      size_t i = 0;
      for (; i < s.path.size(); ++i)
        if (g.src[s.path[i]] == final_node) break;
      if (i == s.path.size()) i = 0;  // defensive; mirrors nx fallthrough
      cycle.assign(s.path.begin() + i, s.path.end());
      return true;
    }
    for (int32_t v : seen) s.explored_mark[v] = explored_epoch;
  }
  return false;
}

// ---------------------------------------------------------------------------
// Incremental cycle removal (round 3).
//
// The legacy loop (gc_remove_cycles) restarts the whole NetworkX-order
// edge-DFS after every deletion: O(cycles x E) — 50 s at k=0/C=10 and ~80
// min at C=30. Key exactness argument for doing better: `find_first_cycle`
// returns at the FIRST cycle, so every earlier start-node search that completed cycle-free
// could not reach any cycle — in particular it never scanned any edge of the
// cycle eventually found (had a cycle been reachable, that search would have
// ended the call). Deleting the found cycle's weakest edge therefore leaves
// every completed search's traversal and explored set bit-identical, and the
// current search's state up to the weakest edge's scan-point is also
// untouched by that edge (an edge-DFS scans each edge at most once per
// search, and the scan advanced the cursor past it already). So: keep an
// undo log of every scratch mutation, roll state back to the weakest edge's
// scan-point, mark it dead, and resume the DFS loop — bit-exact with a full
// restart, but the long prefix of the call is paid once, not per cycle.
// Found cycles are simple (an active node repeat would have been detected at
// its first revisit), which is what makes the "never scanned by an earlier
// completed search" argument airtight for every cycle edge.
//
// Cost: one full DFS pass per completed search, plus per removal only the
// segment between the weakest edge's scan and the cycle detection.

struct IncrementalRemover {
  const Graph& g;
  std::vector<int64_t> iter_pos;
  std::vector<uint32_t> visited_mark, active_mark, explored_mark;
  std::vector<int32_t> stack;
  std::vector<int64_t> path;
  std::vector<int32_t> seen;
  uint32_t epoch = 0;
  uint32_t explored_epoch = 0;
  uint32_t ep = 0;          // current search epoch
  int64_t start_cursor = 0;
  int32_t prev_head = -1;
  bool in_search = false;

  enum Op : uint8_t { ITER, VISIT, ACT, SPUSH, SPOP, PPUSH, PPOP };
  struct LogE {
    uint8_t op;
    int32_t a;     // node (ITER/VISIT/ACT/SPOP)
    int64_t b;     // old iter_pos (ITER/VISIT) / old mark (ACT) / edge (PPOP)
    uint32_t c;    // old visited_mark (VISIT)
  };
  struct Snap {
    int64_t log_len, stack_len, path_len, seen_len;
    int32_t prev_head;
  };
  std::vector<LogE> log;
  std::vector<Snap> snaps;         // parallel to `path`
  std::vector<Snap> popped_snaps;  // snaps discarded by forward path pops

  explicit IncrementalRemover(const Graph& graph) : g(graph) {
    iter_pos.assign(g.num_nodes, 0);
    visited_mark.assign(g.num_nodes, 0);
    active_mark.assign(g.num_nodes, 0);
    explored_mark.assign(g.num_nodes, 0);
    explored_epoch = ++epoch;
  }

  void set_active(int32_t v, uint32_t val) {
    log.push_back({ACT, v, (int64_t)active_mark[v], 0});
    active_mark[v] = val;
  }

  void begin_search(int64_t start) {
    ep = ++epoch;
    stack.clear();
    path.clear();
    seen.clear();
    log.clear();
    snaps.clear();
    popped_snaps.clear();
    prev_head = -1;
    stack.push_back((int32_t)start);
    active_mark[start] = ep;  // pre-log-watermark: never rolled back
    seen.push_back((int32_t)start);
    in_search = true;
  }

  // Runs the DFS until a cycle is found (true; state kept for resume) or the
  // search completes cycle-free (false; explored marks promoted).
  bool run(std::vector<int64_t>& cycle) {
    const int64_t start = stack.empty() ? -1 : stack.front();
    while (!stack.empty()) {
      int32_t node = stack.back();
      if (visited_mark[node] != ep) {
        log.push_back({VISIT, node, iter_pos[node], visited_mark[node]});
        visited_mark[node] = ep;
        iter_pos[node] = g.adj_start[node];
      }
      int64_t pos = iter_pos[node];
      const int64_t old_pos = pos;
      int64_t eidx = -1;
      const int64_t end = g.adj_start[node + 1];
      while (pos < end) {
        int64_t e = g.adj_edges[pos];
        ++pos;
        if (g.alive[e]) { eidx = e; break; }
      }
      if (pos != old_pos) {
        log.push_back({ITER, node, old_pos, 0});
        iter_pos[node] = pos;
      }
      if (eidx < 0) {
        log.push_back({SPOP, node, 0, 0});
        stack.pop_back();
        continue;
      }
      const int32_t tail = g.src[eidx];
      const int32_t head = g.dst[eidx];
      // scan-point snapshot: state BEFORE any processing of edge eidx (the
      // cursor is already past it, which is exactly the post-deletion state)
      Snap snap{(int64_t)log.size(), (int64_t)stack.size(),
                (int64_t)path.size(), (int64_t)seen.size(), prev_head};
      log.push_back({SPUSH, 0, 0, 0});
      stack.push_back(head);
      if (explored_mark[head] == explored_epoch) continue;
      if (prev_head != -1 && tail != prev_head) {
        // backtracked: pop path until its last head == tail
        while (true) {
          if (path.empty()) {
            set_active((int32_t)start, 0);
            set_active(tail, ep);
            break;
          }
          int64_t popped = path.back();
          log.push_back({PPOP, 0, popped, 0});
          popped_snaps.push_back(snaps.back());
          snaps.pop_back();
          path.pop_back();
          set_active(g.dst[popped], 0);
          if (!path.empty() && g.dst[path.back()] == tail) break;
        }
      }
      log.push_back({PPUSH, 0, 0, 0});
      snaps.push_back(snap);
      path.push_back(eidx);
      if (active_mark[head] == ep) {
        // cycle: trim leading edges before the first occurrence of head
        size_t i = 0;
        for (; i < path.size(); ++i)
          if (g.src[path[i]] == head) break;
        if (i == path.size()) i = 0;
        cycle.assign(path.begin() + i, path.end());
        return true;
      }
      seen.push_back(head);
      set_active(head, ep);
      prev_head = head;
    }
    for (int32_t v : seen) explored_mark[v] = explored_epoch;
    in_search = false;
    ++start_cursor;
    return false;
  }

  // Restore all scratch state to the scan-point of path entry `i`.
  void rollback_to(size_t i) {
    const Snap snap = snaps[i];
    while ((int64_t)log.size() > snap.log_len) {
      const LogE e = log.back();
      log.pop_back();
      switch (e.op) {
        case VISIT:
          iter_pos[e.a] = e.b;
          visited_mark[e.a] = e.c;
          break;
        case ITER: iter_pos[e.a] = e.b; break;
        case ACT: active_mark[e.a] = (uint32_t)e.b; break;
        case SPUSH: stack.pop_back(); break;
        case SPOP: stack.push_back(e.a); break;
        case PPUSH:
          path.pop_back();
          snaps.pop_back();
          break;
        case PPOP:
          path.push_back(e.b);
          snaps.push_back(popped_snaps.back());
          popped_snaps.pop_back();
          break;
      }
    }
    prev_head = snap.prev_head;
    seen.resize(snap.seen_len);
  }

  int64_t remove_all(uint8_t* alive) {
    std::vector<int64_t> cycle;
    int64_t removed = 0;
    while (true) {
      if (!in_search) {
        while (start_cursor < g.num_nodes &&
               explored_mark[start_cursor] == explored_epoch)
          ++start_cursor;
        if (start_cursor >= g.num_nodes) return removed;
        begin_search(start_cursor);
      }
      if (!run(cycle)) continue;
      // weakest edge of the cycle, first minimum
      int64_t weakest = cycle[0];
      int32_t wmin = g.weight[weakest];
      for (size_t i = 1; i < cycle.size(); ++i) {
        if (g.weight[cycle[i]] < wmin) {
          wmin = g.weight[cycle[i]];
          weakest = cycle[i];
        }
      }
      // its position in the path (cycle is a path suffix)
      size_t p = path.size();
      while (p > 0 && path[p - 1] != weakest) --p;
      --p;  // path[p] == weakest
      rollback_to(p);
      alive[weakest] = 0;
      ++removed;
      cycle.clear();
    }
  }
};

}  // namespace

extern "C" {

// Removes cycles by deleting the first-minimum-weight edge of each found
// cycle until acyclic, resuming the search instead of restarting it (see
// IncrementalRemover). Mutates `alive`. Returns the number of edges removed.
int64_t gc_remove_cycles_v2(int64_t num_nodes, int64_t num_edges,
                            const int32_t* src, const int32_t* dst,
                            const int32_t* weight, uint8_t* alive) {
  Graph g{num_nodes, num_edges, src, dst, weight, alive};
  g.build_adjacency();
  IncrementalRemover r(g);
  return r.remove_all(alive);
}

// Removes cycles by deleting the first-minimum-weight edge of each found
// cycle until acyclic. Mutates `alive`. Returns the number of edges removed.
int64_t gc_remove_cycles(int64_t num_nodes, int64_t num_edges,
                         const int32_t* src, const int32_t* dst,
                         const int32_t* weight, uint8_t* alive) {
  Graph g{num_nodes, num_edges, src, dst, weight, alive};
  g.build_adjacency();
  Scratch s;
  s.init(num_nodes);
  std::vector<int64_t> cycle;
  int64_t removed = 0;
  while (find_first_cycle(g, s, cycle)) {
    int64_t weakest = cycle[0];
    int32_t wmin = weight[weakest];
    for (size_t i = 1; i < cycle.size(); ++i) {
      if (weight[cycle[i]] < wmin) {
        wmin = weight[cycle[i]];
        weakest = cycle[i];
      }
    }
    alive[weakest] = 0;
    ++removed;
    cycle.clear();
  }
  return removed;
}

// Reference-faithful overlap-alignment DP (reference aligners.py:6-82),
// compiled C++ standing in for the Numba-JIT baseline (Numba lowers the same
// loop through LLVM, so -O2/-O3 C++ is a fair cost model). Full
// (n+1)x(m+1) table, three-way move with tie-break diag >= up >= left,
// int64 arithmetic (the reference's int64-promotion semantics under
// indel = -2^31), best = first max over the last row (strict >). A fast
// host oracle for the tests.
int64_t gc_overlap_baseline_batch(int64_t B, int64_t L, const int8_t* a,
                                  const int32_t* a_len, const int8_t* b,
                                  const int32_t* b_len, int64_t match,
                                  int64_t mismatch, int64_t indel,
                                  int32_t* score_out, int32_t* end_out) {
  std::vector<int64_t> dp((L + 1) * (L + 1));
  const int64_t stride = L + 1;
  for (int64_t p = 0; p < B; ++p) {
    const int64_t n = a_len[p], m = b_len[p];
    const int8_t* s = a + p * L;
    const int8_t* t = b + p * L;
    for (int64_t j = 0; j <= m; ++j) dp[j] = 0;
    for (int64_t i = 1; i <= n; ++i) dp[i * stride] = 0;
    for (int64_t i = 1; i <= n; ++i) {
      const int64_t* prev = &dp[(i - 1) * stride];
      int64_t* cur = &dp[i * stride];
      const int8_t si = s[i - 1];
      for (int64_t j = 1; j <= m; ++j) {
        const int64_t diag = prev[j - 1] + (si == t[j - 1] ? match : mismatch);
        const int64_t up = prev[j] + indel;
        const int64_t left = cur[j - 1] + indel;
        int64_t v;
        if (diag >= up && diag >= left) v = diag;
        else if (up >= left) v = up;
        else v = left;
        cur[j] = v;
      }
    }
    const int64_t* last = &dp[n * stride];
    int64_t best = last[0];
    int64_t bj = 0;
    for (int64_t j = 1; j <= m; ++j)
      if (last[j] > best) { best = last[j]; bj = j; }
    score_out[p] = (int32_t)best;
    end_out[p] = (int32_t)bj;
  }
  return B;
}

// Reference-faithful Smith-Waterman local alignment (reference
// aligners.py:85-167): dp clamped at 0 via the exact selection cascade
// (diag >= up >= left, each additionally >= 0; nothing passing -> cell 0),
// global best tracked with strict > in row-major order (first max wins),
// traceback from the best cell until a zero cell / matrix edge. Emits the
// path as a backwards op stream (1=diag, 2=up/gap-in-ref, 3=left/gap-in-
// query) — the same compact encoding as the Smith-Waterman kernels' op
// streams (ops/smith_waterman.py) — so the Python caller rebuilds the
// aligned strings with the shared replay helper. Characters are int8
// codes; only equality matters.
//
// Used as the fast exact oracle for full-scale parity tests (the pure-
// Python oracle needs ~0.4 s per 100x5386 contig; this runs it in ~2 ms)
// and as the reference-side kernel substitution when running the actual
// reference pipeline at experiment scale.
int64_t gc_local_align(int64_t n, int64_t m, const int8_t* q, const int8_t* r,
                       int64_t match, int64_t mismatch, int64_t indel,
                       int32_t* out_score, int32_t* out_bi, int32_t* out_bj,
                       uint8_t* ops_out /* capacity >= n + m */) {
  std::vector<int64_t> prev(m + 1, 0), cur(m + 1, 0);
  std::vector<uint8_t> tb((n + 1) * (m + 1), 0);
  const int64_t stride = m + 1;
  int64_t best = 0, bi = 0, bj = 0;
  for (int64_t i = 1; i <= n; ++i) {
    cur[0] = 0;
    const int8_t qi = q[i - 1];
    uint8_t* tbrow = &tb[i * stride];
    for (int64_t j = 1; j <= m; ++j) {
      const int64_t diag = prev[j - 1] + (qi == r[j - 1] ? match : mismatch);
      const int64_t up = prev[j] + indel;
      const int64_t left = cur[j - 1] + indel;
      int64_t v = 0;
      uint8_t code = 0;
      if (diag >= up && diag >= left && diag >= 0) { v = diag; code = 1; }
      else if (up >= left && up >= 0) { v = up; code = 2; }
      else if (left >= 0) { v = left; code = 3; }
      cur[j] = v;
      tbrow[j] = v > 0 ? code : 0;  // dp==0 cells stop the traceback
      if (v > best) { best = v; bi = i; bj = j; }
    }
    std::swap(prev, cur);
  }
  *out_score = (int32_t)best;
  *out_bi = (int32_t)bi;
  *out_bj = (int32_t)bj;
  int64_t i = bi, j = bj, steps = 0;
  while (i > 0 && j > 0) {
    const uint8_t code = tb[i * stride + j];
    if (code == 0) break;
    ops_out[steps++] = code;
    if (code == 1) { --i; --j; }
    else if (code == 2) { --i; }
    else { --j; }
  }
  return steps;
}

// No-gap overlap scoring over candidate index pairs — the CPU-backend
// executor for graph/build.py score_pairs (the XLA:CPU path runs the
// one-hot matmul formulation at ~20k pairs/s on this host class; this
// loop runs it >100x faster). Semantics identical to
// ops/overlap.py::overlap_scores (SURVEY §2.2-C1 no-gap degeneration of
// the reference DP, aligners.py:6-82): for j in 0..len(b), with
// d = min(len(a), j), score = match*eq + mismatch*(d - eq) over a's last
// d chars vs b[j-d..j); first strict maximum over j wins (j=0 scores 0).
int64_t gc_overlap_nogap_pairs(int64_t n_pairs, int64_t stride,
                               const int8_t* reads, const int32_t* lens,
                               const int32_t* ia, const int32_t* ib,
                               int64_t match, int64_t mismatch,
                               int32_t* score_out, int32_t* end_out,
                               int64_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> cursor{0};
  const int64_t diff = match - mismatch;
  auto worker = [&]() {
    for (;;) {
      const int64_t p = cursor.fetch_add(256);
      if (p >= n_pairs) return;
      const int64_t hi = p + 256 < n_pairs ? p + 256 : n_pairs;
      for (int64_t q = p; q < hi; ++q) {
        const int8_t* a = reads + (int64_t)ia[q] * stride;
        const int8_t* b = reads + (int64_t)ib[q] * stride;
        const int64_t n = lens[ia[q]], m = lens[ib[q]];
        int64_t best = 0, bj = 0;  // j = 0 always scores 0
        for (int64_t j = 1; j <= m; ++j) {
          const int64_t d = n < j ? n : j;
          const int8_t* sa = a + (n - d);
          const int8_t* sb = b + (j - d);
          int64_t eq = 0;
          for (int64_t u = 0; u < d; ++u) eq += (sa[u] == sb[u]);
          const int64_t v = diff * eq + mismatch * d;
          if (v > best) { best = v; bj = j; }
        }
        score_out[q] = (int32_t)best;
        end_out[q] = (int32_t)bj;
      }
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return n_pairs;
}

// Batched Smith-Waterman local alignment (reference aligners.py:85-167):
// dp clamped at 0 via the selection cascade diag >= up >= left, global best
// with strict > in row-major order, traceback to a zero cell emitted as a
// backwards op stream (1=diag, 2=up/gap-in-ref, 3=left/gap-in-query), for
// the host metrics pass (contig -> genome alignment). Every reference
// window the metrics use (aligners.py:170-202) is a SUFFIX of the genome:
// the full genome (w_len == m) or the tail window genome[-n:] for contigs
// shorter than the read length — so one shared genome buffer plus a
// per-item window length covers both cases. Items are distributed over
// `n_threads` worker threads via an atomic cursor (dynamic load balance:
// contig lengths are highly skewed). Per item the op stream is written to
// ops_out[p * ops_stride ...] and its length to out_steps[p].
//
// This is the full-width executor of align_contigs_to_reference on a CPU
// device; its results are bit-identical to the row scan
// (ops/smith_waterman.py) and to the card's kernel.
int64_t gc_local_align_batch(int64_t B, int64_t q_stride, const int8_t* q,
                             const int32_t* q_len, int64_t m,
                             const int8_t* genome, const int32_t* w_len,
                             int64_t match, int64_t mismatch, int64_t indel,
                             int64_t ops_stride, int32_t* out_score,
                             int32_t* out_bi, int32_t* out_bj,
                             int32_t* out_steps, uint8_t* ops_out,
                             int64_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> cursor{0};
  auto worker = [&]() {
    std::vector<int64_t> prev, cur;
    std::vector<int32_t> prev32, diag32, key32, run32, cur32;
    std::vector<uint8_t> tb;
    for (;;) {
      const int64_t p = cursor.fetch_add(1);
      if (p >= B) return;
      const int64_t n = q_len[p];
      const int64_t w = w_len[p];
      const int8_t* qp = q + p * q_stride;
      const int8_t* rp = genome + (m - w);  // window = genome suffix
      if ((int64_t)tb.size() < (n + 1) * (w + 1)) tb.resize((n + 1) * (w + 1));
      const int64_t stride = w + 1;
      int64_t best = 0, bi = 0, bj = 0;
      // int32-range guard for the vectorized row: every intermediate
      // (dp <= hi*(n+w), key = c0 - indel*j) must fit comfortably
      const int64_t hi =
          std::max(std::max(match, -mismatch), -indel) + 1;
      const bool fast = hi * (n + w + 2) + (-indel) * (w + 2) < (1 << 30);
      if (fast) {
        // Vectorizable 3-pass row (bit-identical values and codes to
        // the scalar cascade — the cascade's value IS
        // max(diag, up, left, 0), and the left chain
        // dp[j] = max(c0[j], dp[j-1] + indel) is a max-plus prefix
        // scan: dp[j] = cummax(c0[j'] - indel*j')[j] + indel*j, the
        // same trick the TPU row-scan kernel uses
        // (ops/smith_waterman.py). Passes 1 and 3 are branchless
        // element-wise loops over j (auto-vectorized, int32 lanes);
        // only the trivial cummax in pass 2 is serial.
        if ((int64_t)prev32.size() < w + 1) {
          prev32.resize(w + 1);
          diag32.resize(w + 1);
          key32.resize(w + 1);
          run32.resize(w + 1);
          cur32.resize(w + 1);
        }
        const int32_t ma = (int32_t)match, mi = (int32_t)mismatch,
                      in = (int32_t)indel;
        std::fill(prev32.begin(), prev32.begin() + w + 1, 0);
        for (int64_t i = 1; i <= n; ++i) {
          const int8_t qi = qp[i - 1];
          uint8_t* tbrow = &tb[i * stride];
          int32_t* RESTRICT pv = prev32.data();
          int32_t* RESTRICT dg = diag32.data();
          int32_t* RESTRICT ky = key32.data();
          int32_t* RESTRICT rn = run32.data();
          int32_t* RESTRICT cu = cur32.data();
          // pass 1: diag, c0 = max(diag, up, 0), carry key
          for (int64_t j = 1; j <= w; ++j) {
            const int32_t d = pv[j - 1] + (qi == rp[j - 1] ? ma : mi);
            const int32_t u = pv[j] + in;
            int32_t c0 = d > u ? d : u;
            c0 = c0 > 0 ? c0 : 0;
            dg[j] = d;
            ky[j] = c0 - in * (int32_t)j;
          }
          // pass 2: prefix max (dp[0] = 0 contributes key 0)
          prefix_max_i32(ky, rn, 1, w, 0);
          // pass 3: dp values + traceback codes (cascade priorities on
          // the final neighbor values) + fused row-max reduction
          cu[0] = 0;
          int32_t rowmax = 0;
          for (int64_t j = 1; j <= w; ++j) {
            const int32_t dp = rn[j] + in * (int32_t)j;
            const int32_t d = dg[j];
            const int32_t u = pv[j] + in;
            const int32_t ldp =
                (j == 1 ? 0 : rn[j - 1] + in * (int32_t)(j - 1));
            const int32_t l = ldp + in;
            uint8_t code = 0;
            if (d >= u && d >= l && d >= 0) code = 1;
            else if (u >= l && u >= 0) code = 2;
            else if (l >= 0) code = 3;
            cu[j] = dp;
            tbrow[j] = dp > 0 ? code : 0;
            rowmax = dp > rowmax ? dp : rowmax;
          }
          // first attaining column (strict > keeps the reference's
          // row-major first-max semantics)
          if (rowmax > best) {
            for (int64_t j = 1; j <= w; ++j) {
              if (cu[j] == rowmax) { best = rowmax; bi = i; bj = j; break; }
            }
          }
          std::swap(prev32, cur32);
        }
        goto traceback;
      }
      if ((int64_t)prev.size() < w + 1) {
        prev.resize(w + 1);
        cur.resize(w + 1);
      }
      std::fill(prev.begin(), prev.begin() + w + 1, 0);
      for (int64_t i = 1; i <= n; ++i) {
        cur[0] = 0;
        const int8_t qi = qp[i - 1];
        uint8_t* tbrow = &tb[i * stride];
        for (int64_t j = 1; j <= w; ++j) {
          const int64_t diag =
              prev[j - 1] + (qi == rp[j - 1] ? match : mismatch);
          const int64_t up = prev[j] + indel;
          const int64_t left = cur[j - 1] + indel;
          int64_t v = 0;
          uint8_t code = 0;
          if (diag >= up && diag >= left && diag >= 0) { v = diag; code = 1; }
          else if (up >= left && up >= 0) { v = up; code = 2; }
          else if (left >= 0) { v = left; code = 3; }
          cur[j] = v;
          tbrow[j] = v > 0 ? code : 0;
          if (v > best) { best = v; bi = i; bj = j; }
        }
        std::swap(prev, cur);
      }
    traceback:
      out_score[p] = (int32_t)best;
      out_bi[p] = (int32_t)bi;
      out_bj[p] = (int32_t)bj;
      uint8_t* op = ops_out + p * ops_stride;
      int64_t i = bi, j = bj, steps = 0;
      while (i > 0 && j > 0) {
        const uint8_t code = tb[i * stride + j];
        if (code == 0) break;
        op[steps++] = code;
        if (code == 1) { --i; --j; }
        else if (code == 2) { --i; }
        else { --j; }
      }
      out_steps[p] = (int32_t)steps;
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return B;
}


// Diagonal-banded Smith-Waterman over one shared genome — the CPU-backend
// executor for the banded metrics path (ops/smith_waterman.py
// local_align_batch_banded semantics, bit for bit): the DP is restricted
// to |j - i - d0| <= band around a per-item seeded center diagonal; SW's
// 0 clamp makes the band boundary behave exactly like a fresh local
// start, so this is full SW restricted to in-band paths. Emits the same
// backwards op stream as gc_local_align_batch; i/j returned in GLOBAL
// genome coordinates. Row work is O(band), so a G-length genome costs
// O(n * band) per contig instead of O(n * G).
int64_t gc_local_align_banded_batch(
    int64_t B, int64_t q_stride, const int8_t* q, const int32_t* q_len,
    int64_t m, const int8_t* genome, const int32_t* d0, int64_t band,
    int64_t match, int64_t mismatch, int64_t indel, int64_t ops_stride,
    int32_t* out_score, int32_t* out_bi, int32_t* out_bj,
    int32_t* out_steps, uint8_t* ops_out, int64_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  const int64_t wb = 2 * band + 1;
  std::atomic<int64_t> cursor{0};
  auto worker = [&]() {
    std::vector<int64_t> prev, cur;
    std::vector<int32_t> prev32, diag32, key32, run32, cur32;
    std::vector<uint8_t> tb;
    for (;;) {
      const int64_t p = cursor.fetch_add(1);
      if (p >= B) return;
      const int64_t n = q_len[p];
      const int8_t* qp = q + p * q_stride;
      const int64_t c0 = d0[p];
      if ((int64_t)tb.size() < (n + 1) * wb) tb.resize((n + 1) * wb);
      int64_t best = 0, bi = 0, bt = 0;
      // band coordinates: t in [0, wb), global j = c0 - band + i + t;
      // moves: diag (i-1, t), up (i-1, t+1), left (i, t-1). Out-of-
      // genome slots (j < 1 or j > m) are neg-inf walls; within a row
      // they form a contiguous PREFIX and/or SUFFIX (j = jlo + t is
      // monotone in t), so the valid interior is one interval and the
      // left-chain max-plus prefix scan over it is exact (it never has
      // to bridge an interior wall).
      const int64_t hi_g =
          std::max(std::max(match, -mismatch), -indel) + 1;
      const bool fast = hi_g * (n + wb + 2) + (-indel) * (wb + 2) < (1 << 29);
      if (fast) {
        // vectorizable 3-pass row in band coordinates (bit-identical to
        // the scalar cascade below; see gc_local_align_batch)
        const int32_t NEG32 = INT32_MIN / 4;
        const int32_t ma = (int32_t)match, mi = (int32_t)mismatch,
                      in = (int32_t)indel;
        if ((int64_t)prev32.size() < wb + 2) {
          prev32.resize(wb + 2);
          diag32.resize(wb + 2);
          key32.resize(wb + 2);
          run32.resize(wb + 2);
          cur32.resize(wb + 2);
        }
        for (int64_t t = 0; t < wb + 2; ++t) prev32[t] = NEG32;
        for (int64_t i = 1; i <= n; ++i) {
          const int8_t qi = qp[i - 1];
          const int64_t jlo = c0 - band + i;
          uint8_t* tbrow = &tb[i * wb];
          // valid slots [t0, t1], kept inside [0, wb) and empty (t1 =
          // t0 - 1) when the row's band lies wholly outside the genome
          // (the JAX package's copy writes out of bounds there)
          const int64_t t0 = std::min<int64_t>(wb, std::max<int64_t>(0, 1 - jlo));
          const int64_t t1 =
              std::max<int64_t>(t0 - 1, std::min<int64_t>(wb - 1, m - jlo));
          int32_t* RESTRICT pv = prev32.data();
          int32_t* RESTRICT dg = diag32.data();
          int32_t* RESTRICT ky = key32.data();
          int32_t* RESTRICT rn = run32.data();
          int32_t* RESTRICT cu = cur32.data();
          cu[0] = NEG32;
          cu[wb + 1] = NEG32;
          for (int64_t t = 0; t < t0; ++t) {
            cu[t + 1] = NEG32;
            tbrow[t] = 0;
          }
          for (int64_t t = t1 + 1; t < wb; ++t) {
            cu[t + 1] = NEG32;
            tbrow[t] = 0;
          }
          const int8_t* RESTRICT gj = genome + jlo - 1;  // genome[j-1] at t
          // pass 1: diag (NEGI diag source maps to 0 — device parity),
          // c0 = max(diag, up, 0), max-plus key
          for (int64_t t = t0; t <= t1; ++t) {
            const int32_t pd = pv[t + 1];
            const int32_t d =
                (pd == NEG32 ? 0 : pd) + (qi == gj[t] ? ma : mi);
            const int32_t u = pv[t + 2] + in;  // NEG32-ish stays huge-neg
            int32_t cc = d > u ? d : u;
            cc = cc > 0 ? cc : 0;
            dg[t] = d;
            ky[t] = cc - in * (int32_t)t;
          }
          // pass 2: prefix max; the wall left of t0 contributes nothing
          prefix_max_i32(ky, rn, t0, t1, NEG32 / 2);
          // pass 3: dp + cascade codes
          for (int64_t t = t0; t <= t1; ++t) {
            const int32_t dp = rn[t] + in * (int32_t)t;
            const int32_t d = dg[t];
            const int32_t u = pv[t + 2] + in;
            const int32_t ldp =
                (t == t0 ? NEG32 : rn[t - 1] + in * (int32_t)(t - 1));
            const int32_t l = ldp + in;
            uint8_t code = 0;
            if (d >= u && d >= l && d >= 0) code = 1;
            else if (u >= l && u >= 0) code = 2;
            else if (l >= 0) code = 3;
            cu[t + 1] = dp;
            tbrow[t] = dp > 0 ? code : 0;
          }
          // pass 4: row max + first attaining slot
          int32_t rowmax = 0;
          for (int64_t t = t0; t <= t1; ++t)
            rowmax = cu[t + 1] > rowmax ? cu[t + 1] : rowmax;
          if (rowmax > best) {
            for (int64_t t = t0; t <= t1; ++t) {
              if (cu[t + 1] == rowmax) {
                best = rowmax; bi = i; bt = t;
                break;
              }
            }
          }
          std::swap(prev32, cur32);
        }
        goto banded_traceback;
      }
      if ((int64_t)prev.size() < wb + 2) {
        prev.resize(wb + 2);
        cur.resize(wb + 2);
      }
      {
        const int64_t NEGI = INT64_MIN / 4;
        for (int64_t t = 0; t < wb + 2; ++t) prev[t] = NEGI;
        for (int64_t i = 1; i <= n; ++i) {
          const int8_t qi = qp[i - 1];
          const int64_t jlo = c0 - band + i;     // global j at t = 0
          uint8_t* tbrow = &tb[i * wb];
          cur[0] = NEGI;
          cur[wb + 1] = NEGI;
          for (int64_t t = 0; t < wb; ++t) {
            const int64_t j = jlo + t;
            if (j < 1 || j > m) {               // outside the genome
              cur[t + 1] = NEGI;
              tbrow[t] = 0;
              continue;
            }
            // in-band predecessors; NEGI marks both the band walls and
            // out-of-genome slots. The device kernel stores 0 at
            // out-of-genome slots and lets the local-alignment 0 clamp
            // absorb them; mapping NEGI -> 0 for the diag move
            // reproduces that exactly, and gap moves from NEGI sources
            // can never win the >= 0 cascade either way
            // (selection-equivalent).
            const int64_t pd = prev[t + 1];
            const int64_t diag = (pd == NEGI ? 0 : pd)
                + (qi == genome[j - 1] ? match : mismatch);
            const int64_t up =
                (prev[t + 2] == NEGI ? NEGI : prev[t + 2] + indel);
            const int64_t left =
                (cur[t] == NEGI ? NEGI : cur[t] + indel);
            int64_t v = 0;
            uint8_t code = 0;
            if (diag >= up && diag >= left && diag >= 0) {
              v = diag; code = 1;
            } else if (up >= left && up >= 0) { v = up; code = 2; }
            else if (left >= 0) { v = left; code = 3; }
            cur[t + 1] = v;
            tbrow[t] = v > 0 ? code : 0;
            if (v > best) { best = v; bi = i; bt = t; }
          }
          std::swap(prev, cur);
        }
      }
    banded_traceback:
      if (best <= 0) {
        out_score[p] = 0;
        out_bi[p] = 0;
        out_bj[p] = 0;
        out_steps[p] = 0;
        continue;
      }
      out_score[p] = (int32_t)best;
      out_bi[p] = (int32_t)bi;
      out_bj[p] = (int32_t)(c0 - band + bi + bt);
      uint8_t* op = ops_out + p * ops_stride;
      int64_t i = bi, t = bt, steps = 0;
      while (i > 0) {
        const int64_t j = c0 - band + i + t;
        if (j <= 0) break;
        const uint8_t code = tb[i * wb + t];
        if (code == 0) break;
        op[steps++] = code;
        if (code == 1) { --i; }            // diag: (i-1, t)
        else if (code == 2) { --i; ++t; }  // up:   (i-1, t+1)
        else { --t; }                      // left: (i, t-1)
      }
      out_steps[p] = (int32_t)steps;
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return B;
}

// Greedy best-overlap chain acceptance (the fast non-parity layout mode,
// graph/greedy.py): edges arrive via `order` (score-desc, stable); accept
// (u -> v) iff u has no successor, v has no predecessor, and u, v are on
// different chains (union-find with path halving), so accepted edges form
// simple chains. One linear pass replaces the reference's whole
// cycle-removal / topo / walk stack (overlapGraphs.py:106-193) when exact
// parity is not required. Returns the number of accepted edges; fills
// succ[u] (successor node or -1) and chain_edge[u] (the accepted edge).
int64_t gc_greedy_chain(int64_t n_nodes, int64_t n_edges, const int32_t* src,
                        const int32_t* dst, const int64_t* order,
                        int32_t* succ, int32_t* pred, int64_t* chain_edge) {
  std::vector<int64_t> parent(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i) parent[i] = i;
  for (int64_t i = 0; i < n_nodes; ++i) succ[i] = -1;
  for (int64_t i = 0; i < n_nodes; ++i) pred[i] = -1;
  for (int64_t i = 0; i < n_nodes; ++i) chain_edge[i] = -1;
  auto find = [&](int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  };
  int64_t accepted = 0;
  for (int64_t i = 0; i < n_edges; ++i) {
    const int64_t e = order[i];
    const int64_t u = src[e], v = dst[e];
    if (succ[u] != -1 || pred[v] != -1 || u == v) continue;
    const int64_t ru = find(u), rv = find(v);
    if (ru == rv) continue;
    parent[ru] = rv;
    succ[u] = (int32_t)v;
    pred[v] = (int32_t)u;
    chain_edge[u] = e;
    ++accepted;
  }
  return accepted;
}

}  // extern "C"
