// Native host compiler for ahocorasick_tpu_torch (the port's copy of
// ahocorasick_tpu/native/src/ac_native.cpp): keywords -> dense automaton
// tables, byte-identical to the Python compiler in core/compiler.py (which
// mirrors the reference construction pipeline, AhoCorasickSet.java:20-191).
//
// Python remains the semantic spec; this C++ path exists because the host
// compile of very large dictionaries (1M+ keywords, millions of states) is
// the one part of the framework where interpreter overhead dominates.  It is
// exercised by parity tests that compare every output array bit-for-bit
// against the Python compiler.
//
// Two-phase C ABI (loaded with ctypes): ac_build inserts the trie and
// reports sizes; ac_finalize writes every large table *directly into
// caller-provided (numpy) buffers* — each output page is touched exactly
// once, which matters because compile cost on big dictionaries is dominated
// by page-fault/first-touch bandwidth, not CPU.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <vector>

namespace {

inline double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}
inline bool debug_timing() {
  static int v = -1;
  if (v < 0) v = getenv("AC_NATIVE_DEBUG") ? 1 : 0;
  return v == 1;
}
#define AC_PHASE(name)                                            \
  if (debug_timing()) {                                           \
    double t = now_s();                                           \
    fprintf(stderr, "[ac_native] %-18s %+8.2fs\n", name, t - t0); \
    t0 = t;                                                       \
  }

constexpr int KIND_AC = 0;
constexpr int KIND_LONGEST = 1;
constexpr int KIND_SHORTEST = 2;
constexpr int KIND_WW = 3;       // whole_word (AC-like closure + emits)
constexpr int KIND_WWL = 4;      // whole_word_longest (closure, no emits)

// Flat open-addressing hash map over (node, unit) -> child. One table for
// the whole trie: cache-friendly, no per-node allocation.
struct EdgeMap {
  std::vector<uint64_t> keys;  // packed (node << 16) | unit; EMPTY = ~0
  std::vector<int32_t> vals;
  size_t mask = 0;
  size_t count = 0;
  static constexpr uint64_t EMPTY = ~0ull;

  explicit EdgeMap(size_t cap_hint) {
    size_t cap = 1024;
    while (cap < cap_hint * 2) cap <<= 1;
    keys.assign(cap, EMPTY);
    vals.assign(cap, -1);
    mask = cap - 1;
  }

  static inline size_t hash(uint64_t k) {
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33;
    return (size_t)k;
  }

  void grow() {
    std::vector<uint64_t> ok = std::move(keys);
    std::vector<int32_t> ov = std::move(vals);
    size_t cap = (mask + 1) * 2;
    keys.assign(cap, EMPTY);
    vals.assign(cap, -1);
    mask = cap - 1;
    for (size_t i = 0; i < ok.size(); ++i) {
      if (ok[i] != EMPTY) {
        size_t j = hash(ok[i]) & mask;
        while (keys[j] != EMPTY) j = (j + 1) & mask;
        keys[j] = ok[i];
        vals[j] = ov[i];
      }
    }
  }

  int32_t find_or_insert(uint64_t k, int32_t next_id, bool* inserted) {
    if (count * 10 >= (mask + 1) * 7) grow();
    size_t j = hash(k) & mask;
    while (true) {
      if (keys[j] == k) {
        *inserted = false;
        return vals[j];
      }
      if (keys[j] == EMPTY) {
        keys[j] = k;
        vals[j] = next_id;
        ++count;
        *inserted = true;
        return next_id;
      }
      j = (j + 1) & mask;
    }
  }
};

struct Trie {
  int kind = KIND_AC;
  int64_t S = 0;
  int32_t A = 0;
  EdgeMap edges{16};
  std::vector<int32_t> own_len, own_val, depth;  // [S]
  std::vector<int32_t> parent;                   // [S]
  std::vector<uint16_t> parent_unit;             // [S]
  std::vector<int32_t> first_child, last_child;  // [S]
  std::vector<int32_t> next_sibling;             // [S-1], node id - 1
  std::vector<int32_t> order;                    // BFS order, [S]
  std::vector<int32_t> class_of_unit;            // [65536]
  std::vector<uint8_t> accepted;                 // [n_keywords]
  std::vector<int32_t> emit_len, emit_val;       // built in finalize
};

}  // namespace

extern "C" {

// kind: 0=ac 1=longest 2=shortest.  `units`/`offsets`: keyword i occupies
// units[offsets[i] .. offsets[i+1]), already case-folded by the caller.
// with_values: value ids are assigned to accepted keywords in order
// (duplicate keywords overwrite, reference AhoCorasickMap.java:50).
void* ac_build(const uint16_t* units, const int64_t* offsets,
               int64_t n_keywords, int kind, int with_values) {
  double t0 = now_s();
  Trie* r = new Trie();
  r->kind = kind;

  int64_t total_units = n_keywords ? offsets[n_keywords] : 0;
  r->edges = EdgeMap((size_t)(total_units ? total_units : 16));
  r->own_len.assign(1, 0);
  r->own_val.assign(1, -1);
  r->depth.assign(1, 0);
  r->parent.assign(1, 0);
  r->parent_unit.assign(1, 0);
  r->first_child.assign(1, -1);
  r->last_child.assign(1, -1);
  r->accepted.assign((size_t)n_keywords, 0);

  int32_t value_counter = 0;
  for (int64_t i = 0; i < n_keywords; ++i) {
    int64_t b = offsets[i], e = offsets[i + 1];
    if (b == e) continue;  // empty keyword silently skipped
    int32_t node = 0;
    bool skipped = false;
    for (int64_t p = b; p < e; ++p) {
      uint16_t u = units[p];
      uint64_t key = ((uint64_t)(uint32_t)node << 16) | u;
      bool inserted = false;
      int32_t next_id = (int32_t)r->own_len.size();
      int32_t child = r->edges.find_or_insert(key, next_id, &inserted);
      if (inserted) {
        r->own_len.push_back(0);
        r->own_val.push_back(-1);
        r->depth.push_back(r->depth[(size_t)node] + 1);
        r->parent.push_back(node);
        r->parent_unit.push_back(u);
        r->first_child.push_back(-1);
        r->last_child.push_back(-1);
        r->next_sibling.push_back(-1);
        if (r->first_child[(size_t)node] < 0) {
          r->first_child[(size_t)node] = child;
        } else {
          r->next_sibling[(size_t)r->last_child[(size_t)node] - 1] = child;
        }
        r->last_child[(size_t)node] = child;
      }
      node = child;
      if (kind == KIND_SHORTEST && r->own_len[(size_t)node] != 0) {
        // A previously inserted keyword terminates on this path: this
        // keyword can never match (ShortestMatchSet.java:23-42).
        skipped = true;
        break;
      }
    }
    if (skipped) continue;
    r->own_len[(size_t)node] = (int32_t)(e - b);
    if (with_values) r->own_val[(size_t)node] = value_counter++;
    r->accepted[(size_t)i] = 1;
  }
  AC_PHASE("trie insert");

  r->S = (int64_t)r->own_len.size();

  // Alphabet compaction: sorted distinct edge units.
  std::vector<uint8_t> is_edge(65536, 0);
  for (size_t j = 0; j <= r->edges.mask; ++j) {
    if (r->edges.keys[j] != EdgeMap::EMPTY)
      is_edge[r->edges.keys[j] & 0xffff] = 1;
  }
  r->class_of_unit.assign(65536, 0);
  // Whole-word kinds reserve TWO catch-all classes (0: other non-word,
  // 1: other word — compiler.py::_build_alphabet base=2); the caller
  // rewrites non-edge units' classes by wordness afterwards.
  int32_t A = (r->kind >= KIND_WW) ? 2 : 1;  // class 0: any non-keyword char
  for (int u = 0; u < 65536; ++u) {
    if (is_edge[(size_t)u]) r->class_of_unit[(size_t)u] = A++;
  }
  r->A = A;

  // BFS order (children in insertion order — Python dict-order parity).
  r->order.reserve((size_t)r->S);
  r->order.push_back(0);
  for (size_t h = 0; h < r->order.size(); ++h) {
    for (int32_t c = r->first_child[(size_t)r->order[h]]; c >= 0;
         c = r->next_sibling[(size_t)c - 1]) {
      r->order.push_back(c);
    }
  }
  AC_PHASE("alphabet+bfs");
  return r;
}

int64_t ac_num_states(void* h) { return ((Trie*)h)->S; }
int32_t ac_num_classes(void* h) { return ((Trie*)h)->A; }

void ac_get_build_meta(void* h, int32_t* class_of_unit, uint8_t* accepted) {
  Trie* r = (Trie*)h;
  std::memcpy(class_of_unit, r->class_of_unit.data(), 65536 * sizeof(int32_t));
  if (!r->accepted.empty())
    std::memcpy(accepted, r->accepted.data(), r->accepted.size());
}

// Fill caller buffers: trie_next[(S+1)*A], dfa_next[S*A], fail[S],
// own_len/own_val/match_len/match_val/depth[S+1],
// emit_start/emit_count[S+1] (null for shortest).  Returns E (emit table
// length; 0 when emits not built).
// ``build_closure`` = 0 skips the fail-link + goto-closure pass (dfa_next
// and fail may be null then): mixed-wordness WHOLE_WORD_LONGEST
// dictionaries never consult the closure (the scan engine is gated off),
// so the dense S*A fill and its first-touch page faults are skipped.
int64_t ac_finalize(void* h, int32_t* trie_next, int32_t* dfa_next,
                    int32_t* fail, int32_t* own_len, int32_t* own_val,
                    int32_t* match_len, int32_t* match_val, int32_t* depth,
                    int32_t* emit_start, int32_t* emit_count,
                    int build_closure) {
  double t0 = now_s();
  Trie* r = (Trie*)h;
  const int64_t S = r->S;
  const int32_t A = r->A;
  const int32_t DEAD = (int32_t)S;
  const int kind = r->kind;

  // trie_next: DEAD-fill then scatter edges.
  std::fill(trie_next, trie_next + (size_t)(S + 1) * (size_t)A, DEAD);
  for (size_t j = 0; j <= r->edges.mask; ++j) {
    if (r->edges.keys[j] == EdgeMap::EMPTY) continue;
    int32_t node = (int32_t)(r->edges.keys[j] >> 16);
    int32_t cls = r->class_of_unit[r->edges.keys[j] & 0xffff];
    trie_next[(size_t)node * (size_t)A + (size_t)cls] = r->edges.vals[j];
  }
  AC_PHASE("trie_next");

  std::memcpy(own_len, r->own_len.data(), (size_t)S * sizeof(int32_t));
  own_len[S] = 0;
  std::memcpy(own_val, r->own_val.data(), (size_t)S * sizeof(int32_t));
  own_val[S] = -1;
  std::memcpy(depth, r->depth.data(), (size_t)S * sizeof(int32_t));
  depth[S] = 0;
  std::memcpy(match_len, own_len, (size_t)(S + 1) * sizeof(int32_t));
  std::memcpy(match_val, own_val, (size_t)(S + 1) * sizeof(int32_t));

  // BFS pass: fail links + goto closure (+ shortest pruning).
  if (!build_closure) return 0;
  fail[0] = 0;  // root (the Python path zero-fills; buffers here are empty)
  for (int32_t c = 0; c < A; ++c) {
    int32_t t = trie_next[(size_t)c];
    dfa_next[(size_t)c] = (t != DEAD) ? t : 0;  // root loops to itself
  }
  for (size_t hh = 1; hh < r->order.size(); ++hh) {
    int32_t node = r->order[hh];
    int32_t pcls = r->class_of_unit[r->parent_unit[(size_t)node]];
    int32_t f;
    if (r->depth[(size_t)node] == 1) {
      f = 0;
    } else {
      f = dfa_next[(size_t)fail[(size_t)r->parent[(size_t)node]] * (size_t)A +
                   (size_t)pcls];
    }
    fail[(size_t)node] = f;
    if (kind == KIND_SHORTEST && r->depth[(size_t)node] > 1) {
      // Inherit the first match down the fail chain, then prune matching
      // nodes to leaves (ShortestMatchSet.java:95-110).
      if (match_len[(size_t)node] == 0) {
        int32_t g = f;
        while (g != 0 && match_len[(size_t)g] == 0) g = fail[(size_t)g];
        match_len[(size_t)node] = match_len[(size_t)g];
        match_val[(size_t)node] = match_val[(size_t)g];
      }
      if (match_len[(size_t)node] != 0) {
        for (int32_t c = 0; c < A; ++c)
          trie_next[(size_t)node * (size_t)A + (size_t)c] = DEAD;
        fail[(size_t)node] = 0;
        f = 0;
      }
    }
    {
      const int32_t* trow = &trie_next[(size_t)node * (size_t)A];
      const int32_t* frow = &dfa_next[(size_t)f * (size_t)A];
      int32_t* drow = &dfa_next[(size_t)node * (size_t)A];
      for (int32_t c = 0; c < A; ++c) {
        drow[c] = (trow[c] != DEAD) ? trow[c] : frow[c];
      }
    }
  }
  AC_PHASE("closure");

  // Emit lists (ac / longest / whole_word): Java output() order.
  int64_t E = 0;
  if (kind == KIND_AC || kind == KIND_LONGEST || kind == KIND_WW) {
    std::vector<int32_t> fm((size_t)S + 1, -1);
    for (size_t hh = 0; hh < r->order.size(); ++hh) {
      int32_t node = r->order[hh];
      if (node == 0) continue;
      fm[(size_t)node] =
          (own_len[(size_t)node] > 0) ? node : fm[(size_t)fail[(size_t)node]];
    }
    std::vector<int32_t> seg_start((size_t)S + 1, -1),
        seg_count((size_t)S + 1, 0);
    std::vector<int32_t>& elen = r->emit_len;
    std::vector<int32_t>& eval = r->emit_val;
    std::vector<int32_t> stack;
    auto build_L = [&](int32_t t) {
      stack.clear();
      while (t != -1 && seg_start[(size_t)t] < 0) {
        stack.push_back(t);
        t = fm[(size_t)fail[(size_t)t]];
      }
      while (!stack.empty()) {
        int32_t u = stack.back();
        stack.pop_back();
        int32_t nxt = fm[(size_t)fail[(size_t)u]];
        int32_t start = (int32_t)elen.size();
        elen.push_back(own_len[(size_t)u]);
        eval.push_back(own_val[(size_t)u]);
        int32_t cnt = 1;
        if (nxt != -1) {
          int32_t ss = seg_start[(size_t)nxt], sc = seg_count[(size_t)nxt];
          for (int32_t k = 0; k < sc; ++k) {
            elen.push_back(elen[(size_t)(ss + k)]);
            eval.push_back(eval[(size_t)(ss + k)]);
          }
          cnt += sc;
        }
        seg_start[(size_t)u] = start;
        seg_count[(size_t)u] = cnt;
      }
    };
    for (size_t hh = 0; hh < r->order.size(); ++hh) {
      int32_t node = r->order[hh];
      int32_t anchor = fm[(size_t)node];
      if (anchor != -1) {
        build_L(anchor);
        emit_start[(size_t)node] = seg_start[(size_t)anchor];
        emit_count[(size_t)node] = seg_count[(size_t)anchor];
      } else {
        emit_start[(size_t)node] = 0;
        emit_count[(size_t)node] = 0;
      }
    }
    emit_start[S] = 0;
    emit_count[S] = 0;
    if (elen.empty()) {
      elen.push_back(0);
      eval.push_back(-1);
    }
    E = (int64_t)elen.size();
    // Post-inheritance match_len/value mirror (AhoCorasickSet.java:114-121).
    for (size_t hh = 0; hh < r->order.size(); ++hh) {
      int32_t node = r->order[hh];
      if (own_len[(size_t)node] == 0 && fm[(size_t)node] != -1) {
        match_len[(size_t)node] = own_len[(size_t)fm[(size_t)node]];
        match_val[(size_t)node] = own_val[(size_t)fm[(size_t)node]];
      }
    }
    AC_PHASE("emit");
  }
  return E;
}

void ac_get_emits(void* h, int32_t* emit_len, int32_t* emit_val) {
  Trie* r = (Trie*)h;
  if (!r->emit_len.empty()) {
    std::memcpy(emit_len, r->emit_len.data(),
                r->emit_len.size() * sizeof(int32_t));
    std::memcpy(emit_val, r->emit_val.data(),
                r->emit_val.size() * sizeof(int32_t));
  }
}

void ac_free(void* h) { delete (Trie*)h; }

// Whole-word-longest carried fail matches: the last completed
// word-boundary match above each node (WholeWordLongestMatchSet.java:
// 224-247; mirror of the Python pass in compiler.py::_finalize).
// `is_word_unit`: wordness per folded UTF-16 unit (65536 bytes).
// Outputs are [S+1] (index S = DEAD: 0/0/-1).
void ac_fill_wwl(void* h, const uint8_t* is_word_unit, int32_t* fail_len,
                 int32_t* fail_off, int32_t* fail_val) {
  Trie* r = (Trie*)h;
  const int64_t S = r->S;
  std::fill(fail_len, fail_len + S + 1, 0);
  std::fill(fail_off, fail_off + S + 1, 0);
  std::fill(fail_val, fail_val + S + 1, -1);
  for (size_t hh = 1; hh < r->order.size(); ++hh) {
    int32_t node = r->order[hh];
    int32_t p = r->parent[(size_t)node];
    bool edge_is_word = is_word_unit[r->parent_unit[(size_t)node]] != 0;
    if (r->own_len[(size_t)p] != 0 && !edge_is_word) {
      fail_len[(size_t)node] = r->own_len[(size_t)p];
      fail_off[(size_t)node] = 1;
      fail_val[(size_t)node] = r->own_val[(size_t)p];
    } else {
      fail_len[(size_t)node] = fail_len[(size_t)p];
      fail_off[(size_t)node] = fail_off[(size_t)p] + 1;
      fail_val[(size_t)node] = fail_val[(size_t)p];
    }
  }
}

// Restart-chain follower for the whole-word-longest engine
// (resolve/wholeword.py): per word-start walk outcomes -> emitted triples.
int64_t ac_follow_chain(const int64_t* die_pos, const uint8_t* has,
                        const int64_t* m_start, const int64_t* m_end,
                        const int64_t* m_val, const int64_t* ws, int64_t n_ws,
                        int64_t n, int64_t* out_start, int64_t* out_end,
                        int64_t* out_val) {
  int64_t out = 0;
  int64_t i = 0;
  while (i < n) {
    if (has[i]) {
      out_start[out] = m_start[i];
      out_end[out] = m_end[i];
      out_val[out] = m_val[i];
      ++out;
    }
    int64_t p = die_pos[i];
    // First word start strictly greater than p (binary search).
    int64_t lo = 0, hi = n_ws;
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (ws[mid] <= p) lo = mid + 1; else hi = mid;
    }
    if (lo >= n_ws) break;
    i = ws[lo];
  }
  return out;
}

// Leftmost-longest overlap resolution over end-sorted candidates —
// identical algorithm to resolve/queue.py::resolve_longest (which is the
// parity oracle); semantics pinned to SetMatchQueue.java:59-94.
int64_t ac_resolve_longest(const int64_t* starts, const int64_t* ends,
                           const int64_t* vals, int64_t n, int64_t* out_s,
                           int64_t* out_e, int64_t* out_v) {
  int64_t top = -1;
  for (int64_t i = 0; i < n; ++i) {
    int64_t s = starts[i], e = ends[i], v = vals[i];
    int64_t j = top;
    while (j >= 0 && out_s[j] > s) --j;
    if (j < 0) {
      top = 0;  // new leftmost: displace the whole queue
    } else if (s >= out_e[j]) {
      top = j + 1;  // non-overlapping: append, dropping contained tail
    } else if (s == out_s[j] && e > out_e[j]) {
      top = j;  // same start, longer: replace (and drop tail)
    } else {
      continue;  // overlapping later start: leftmost wins
    }
    out_s[top] = s;
    out_e[top] = e;
    out_v[top] = v;
  }
  return top + 1;
}

// Leftmost-shortest (min-end) greedy over end-sorted candidates — mirror of
// resolve/queue.py::resolve_shortest_py (the parity oracle); reproduces the
// lagged restart loop ShortestMatchSet.java:182-260 (equivalence argument
// on resolve/queue.py::resolve_shortest).
int64_t ac_resolve_shortest(const int64_t* starts, const int64_t* ends,
                            const int64_t* vals, int64_t n, int64_t* out_s,
                            int64_t* out_e, int64_t* out_v) {
  int64_t cursor = 0, out = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (starts[i] >= cursor) {
      out_s[out] = starts[i];
      out_e[out] = cursor = ends[i];
      out_v[out] = vals[i];
      ++out;
    }
  }
  return out;
}

// Fused END-indexed bitplane extraction + greedy resolve: candidates stream
// straight from the device emit planes into the resolver, never
// materialized (the numpy extract+lexsort path in ops/emit.py is the
// adversarial-input bottleneck: 'aaaa' torture makes nearly every position
// carry several candidate bits).
//
// bits: uint32[planes][stride], plane-major; logical text length n
// (stride >= n; positions beyond n are padding and ignored).  Bit b of
// plane p at position j => a keyword of length L = 32*p + b + 1 ends at
// j+1 (starts at j+1-L).  Within a position, candidates must feed the
// resolver longest-first (= start ascending at equal end), so planes and
// bits are walked high-to-low.  mode: 0 = leftmost-longest
// (SetMatchQueue.java:59-94), 1 = leftmost-shortest (min-end restart),
// 2 = ALL candidates unresolved, already in the reference emission order
// (end asc; longest-first at equal end, AhoCorasickSet.java:522-535) --
// the AC-kind fast path that replaces the numpy unpack + lexsort.
// out_s/out_e must hold n+1 entries (modes 0/1) or the total candidate
// popcount (mode 2).  Values for the accepted spans are
// recovered afterwards by re-walking the trie over just those spans
// (ops/emit.py::walk_values) — acceptance never depends on values.
// Sparse variant: candidates come as (position, plane-masks) pairs for the
// hot positions only (device-side compaction strips the zero positions
// before download).  idx must be ascending; masks is hot-major
// uint32[n_hot][planes].  Same streaming resolve as ac_extract_resolve.
int64_t ac_extract_resolve_sparse(const int64_t* idx, const uint32_t* masks,
                                  int64_t n_hot, int64_t planes,
                                  int64_t max_depth, int mode, int64_t* out_s,
                                  int64_t* out_e) {
  int64_t top = -1;
  int64_t cursor = 0;
  int64_t out = 0;
  for (int64_t h = 0; h < n_hot; ++h) {
    int64_t j = idx[h];
    for (int64_t p = planes - 1; p >= 0; --p) {
      uint32_t w = masks[h * planes + p];
      while (w) {
        int b = 31 - __builtin_clz(w);
        w &= ~(1u << b);
        int64_t L = 32 * p + b + 1;
        if (L > max_depth) continue;
        int64_t s = j + 1 - L, e = j + 1;
        if (mode == 2) {  // all candidates, emission order
          out_s[out] = s;
          out_e[out] = e;
          ++out;
          continue;
        }
        if (mode == 1) {
          if (s >= cursor) {
            out_s[out] = s;
            out_e[out] = cursor = e;
            ++out;
          }
          continue;
        }
        int64_t q = top;
        while (q >= 0 && out_s[q] > s) --q;
        if (q < 0) {
          top = 0;
        } else if (s >= out_e[q]) {
          top = q + 1;
        } else if (s == out_s[q] && e > out_e[q]) {
          top = q;
        } else {
          continue;
        }
        out_s[top] = s;
        out_e[top] = e;
      }
    }
  }
  return mode == 0 ? top + 1 : out;
}

int64_t ac_extract_resolve(const uint32_t* bits, int64_t planes,
                           int64_t stride, int64_t n, int64_t max_depth,
                           int mode, int64_t* out_s, int64_t* out_e) {
  int64_t top = -1;    // longest-mode queue top
  int64_t cursor = 0;  // shortest-mode restart cursor
  int64_t out = 0;
  for (int64_t j = 0; j < n; ++j) {
    for (int64_t p = planes - 1; p >= 0; --p) {
      uint32_t w = bits[p * stride + j];
      while (w) {
        int b = 31 - __builtin_clz(w);  // highest bit first: length desc
        w &= ~(1u << b);
        int64_t L = 32 * p + b + 1;
        if (L > max_depth) continue;
        int64_t s = j + 1 - L, e = j + 1;
        if (mode == 2) {  // all candidates, emission order
          out_s[out] = s;
          out_e[out] = e;
          ++out;
          continue;
        }
        if (mode == 1) {
          if (s >= cursor) {
            out_s[out] = s;
            out_e[out] = cursor = e;
            ++out;
          }
          continue;
        }
        int64_t q = top;  // SetMatchQueue push (ac_resolve_longest body)
        while (q >= 0 && out_s[q] > s) --q;
        if (q < 0) {
          top = 0;
        } else if (s >= out_e[q]) {
          top = q + 1;
        } else if (s == out_s[q] && e > out_e[q]) {
          top = q;
        } else {
          continue;
        }
        out_s[top] = s;
        out_e[top] = e;
      }
    }
  }
  return mode == 0 ? top + 1 : out;
}

}  // extern "C"
