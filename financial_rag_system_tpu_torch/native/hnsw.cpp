// Host-side HNSW graph builder — native counterpart of index/hnsw.py.
//
// The reference delegates graph-index construction to Qdrant's server
// (Rust HNSW; reached via upsert, reference ingest.py:171-175).  Graph
// *construction* is sequential pointer-chasing — a host workload — while
// the *query* walk is batched on the TPU (index/hnsw.py).  This library
// owns construction: standard HNSW insertion (Malkov & Yashunin 2016,
// public algorithm) with geometric level sampling, efConstruction beam
// search per layer, and heuristic neighbor selection, specialized to
// inner-product similarity over L2-normalized vectors (cosine).
//
// Build parallelism: insertions run on a thread pool with striped
// per-node mutexes guarding neighbor lists (reads copy under the lock)
// and atomics for the entry point — the standard concurrent-HNSW
// scheme.  Million-row builds are minutes, not hours.
//
// The device consumes two flat exports: the level-0 fixed-degree
// adjacency (n, 2M) int32 (pad = -1) and the >=1-level entry nodes
// (descending by level) that seed the batched beam walk.
//
// C ABI for ctypes; no external dependencies.
//
// Build: g++ -O3 -shared -fPIC -o libfrs_hnsw.so hnsw.cpp

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr int kLockStripes = 4096;  // power of two

struct Hnsw {
  int n = 0, d = 0, m = 0, efc = 0;
  int lmax = 0;  // level-array bound fixed at build
  std::atomic<int> max_level{-1};
  std::atomic<int> entry{-1};
  std::vector<float> owned;
  std::vector<int> levels;  // node -> top level (written once per node)
  // adjacency[level][node] -> neighbor list (level 0 cap 2M, else M)
  std::vector<std::vector<std::vector<int>>> adj;
  std::vector<std::mutex> locks{kLockStripes};
  std::mutex global;
  // incremental-insert support: the level-sampling RNG continues the
  // build's deterministic stream, and dirty tracks level-0 rows whose
  // neighbor lists changed since the last export (so the caller patches
  // only those device rows instead of re-shipping the whole adjacency)
  std::mt19937 level_rng;
  bool track_dirty = false;
  std::mutex dirty_mu;
  std::vector<int> dirty;

  std::mutex& lock_for(int node) { return locks[node & (kLockStripes - 1)]; }

  void mark_dirty(int node) {
    if (!track_dirty) return;
    std::lock_guard<std::mutex> g(dirty_mu);
    dirty.push_back(node);
  }

  // The build's hot path: efConstruction beam search is hundreds of
  // dot products per insert.  Sixteen explicit accumulators make the
  // reduction reassociation-free for the compiler, so -O3 vectorizes it
  // (two independent 8-lane FMA chains under -mavx2 -mfma, hiding FMA
  // latency) WITHOUT -ffast-math — a scalar `s += x[i]*y[i]` loop
  // cannot legally vectorize under strict FP.  Measured on this rig,
  // 60k-row m=16/efc=100 single-thread build: scalar 189 s -> 44 s.
  float sim(int a, int b) const {
    const float* __restrict x = owned.data() + (size_t)a * d;
    const float* __restrict y = owned.data() + (size_t)b * d;
    float acc[16] = {0.f};
    int i = 0;
    for (; i + 16 <= d; i += 16)
      for (int j = 0; j < 16; j++) acc[j] += x[i + j] * y[i + j];
    float s = 0.f;
    for (int j = 0; j < 16; j++) s += acc[j];
    for (; i < d; i++) s += x[i] * y[i];
    return s;
  }

  int cap(int level) const { return level == 0 ? 2 * m : m; }

  std::vector<int> neighbors(int level, int node) {
    std::lock_guard<std::mutex> g(lock_for(node));
    return adj[level][node];
  }
};

// max-heap on similarity = best-first expansion queue
using SimNode = std::pair<float, int>;

// Greedy single-path descent on one layer (ef = 1).
int greedy_step(Hnsw& h, int start, int q, int level) {
  int cur = start;
  float cur_s = h.sim(cur, q);
  bool improved = true;
  while (improved) {
    improved = false;
    for (int nb : h.neighbors(level, cur)) {
      float s = h.sim(nb, q);
      if (s > cur_s) {
        cur_s = s;
        cur = nb;
        improved = true;
      }
    }
  }
  return cur;
}

// Beam search on one layer; returns up to ef (sim, node) results,
// unsorted.
//
// Memory behavior is the million-row bottleneck: each expansion gathers
// up to 2M neighbor vectors (d floats each) from random heap offsets,
// and past ~LLC-sized corpora every gather is a DRAM miss chain the
// 16-accumulator FMA loop then stalls on (measured: the AVX2 dot is
// 4.3x at 60k rows but only 1.6x at 1M).  The split below overlaps that
// traffic with compute: pass 1 dedups against the visit stamp and
// issues a first-line prefetch per fresh neighbor (starts the DRAM row
// activations early); pass 2 streams the FULL next vector while the
// current dot product runs, so the FMA chains read warm lines.
std::vector<SimNode> search_layer(
    Hnsw& h, int q, int start, int ef, int level,
    std::vector<int>& visit_mark, int stamp) {
  std::priority_queue<SimNode> cand;                 // best first
  std::priority_queue<SimNode, std::vector<SimNode>,
                      std::greater<SimNode>> best;   // worst on top
  float s0 = h.sim(start, q);
  cand.push({s0, start});
  best.push({s0, start});
  visit_mark[start] = stamp;
  const float* base = h.owned.data();
  const size_t dd = (size_t)h.d;
  std::vector<int> fresh;
  fresh.reserve(2 * (size_t)h.m + 1);
  while (!cand.empty()) {
    auto [cs, c] = cand.top();
    cand.pop();
    if (cs < best.top().first && (int)best.size() >= ef) break;
    fresh.clear();
    for (int nb : h.neighbors(level, c)) {
      if (visit_mark[nb] == stamp) continue;
      visit_mark[nb] = stamp;
      fresh.push_back(nb);
      __builtin_prefetch(base + (size_t)nb * dd, 0, 3);
    }
    for (size_t t = 0; t < fresh.size(); t++) {
      if (t + 1 < fresh.size()) {
        const float* nx = base + (size_t)fresh[t + 1] * dd;
        for (size_t off = 0; off < dd; off += 16)
          __builtin_prefetch(nx + off, 0, 3);
      }
      int nb = fresh[t];
      float s = h.sim(nb, q);
      if ((int)best.size() < ef || s > best.top().first) {
        cand.push({s, nb});
        best.push({s, nb});
        if ((int)best.size() > ef) best.pop();
      }
    }
  }
  std::vector<SimNode> out;
  out.reserve(best.size());
  while (!best.empty()) {
    out.push_back(best.top());
    best.pop();
  }
  return out;
}

// Heuristic neighbor selection (keep a candidate only if it is closer
// to the query than to every already-kept neighbor) — preserves graph
// navigability versus plain top-M.
std::vector<int> select_heuristic(const Hnsw& h, std::vector<SimNode> cand,
                                  int m_out) {
  std::sort(cand.begin(), cand.end(),
            [](const SimNode& a, const SimNode& b) { return a.first > b.first; });
  std::vector<int> kept;
  for (const auto& [s, node] : cand) {
    if ((int)kept.size() >= m_out) break;
    bool ok = true;
    for (int kn : kept) {
      if (h.sim(node, kn) > s) {  // closer to a kept neighbor than to q
        ok = false;
        break;
      }
    }
    if (ok) kept.push_back(node);
  }
  // backfill with nearest rejects so degree stays full
  for (const auto& [s, node] : cand) {
    if ((int)kept.size() >= m_out) break;
    if (std::find(kept.begin(), kept.end(), node) == kept.end())
      kept.push_back(node);
  }
  return kept;
}

void connect(Hnsw& h, int node, int nb, int level) {
  {
    std::lock_guard<std::mutex> g(h.lock_for(nb));
    auto& nbrs = h.adj[level][nb];
    nbrs.push_back(node);
    int c = h.cap(level);
    if ((int)nbrs.size() > c) {
      // same gather pattern as search_layer: start every row's DRAM
      // fetch before the dot-product loop consumes them in order
      for (int x : nbrs)
        __builtin_prefetch(h.owned.data() + (size_t)x * h.d, 0, 3);
      std::vector<SimNode> cand;
      cand.reserve(nbrs.size());
      for (int x : nbrs) cand.push_back({h.sim(nb, x), x});
      nbrs = select_heuristic(h, std::move(cand), c);
    }
  }
  if (level == 0) h.mark_dirty(nb);
}

void insert(Hnsw& h, int q, std::vector<int>& visit_mark, int& stamp,
            int level) {
  for (int l = 0; l <= level; l++) h.adj[l][q] = {};

  int ep = h.entry.load(std::memory_order_acquire);
  if (ep < 0) {
    std::lock_guard<std::mutex> g(h.global);
    if (h.entry.load() < 0) {
      h.max_level.store(level);
      h.entry.store(q, std::memory_order_release);
      return;
    }
    ep = h.entry.load();
  }

  int ml = h.max_level.load(std::memory_order_acquire);
  int cur = ep;
  for (int l = ml; l > level; l--) cur = greedy_step(h, cur, q, l);

  for (int l = std::min(level, ml); l >= 0; l--) {
    ++stamp;
    auto found = search_layer(h, q, cur, h.efc, l, visit_mark, stamp);
    auto nbrs = select_heuristic(h, found, h.m);
    {
      std::lock_guard<std::mutex> g(h.lock_for(q));
      h.adj[l][q] = nbrs;
    }
    if (l == 0) h.mark_dirty(q);
    for (int nb : nbrs) connect(h, q, nb, l);
    // best found seeds the next (lower) layer
    float bs = -1e30f;
    for (const auto& [s, node] : found)
      if (s > bs) {
        bs = s;
        cur = node;
      }
  }

  if (level > h.max_level.load()) {
    std::lock_guard<std::mutex> g(h.global);
    if (level > h.max_level.load()) {
      h.max_level.store(level);
      h.entry.store(q, std::memory_order_release);
    }
  }
}

}  // namespace

extern "C" {

void* frs_hnsw_build(const float* vecs, int n, int d, int m,
                     int ef_construction, unsigned seed, int n_threads) {
  if (n <= 0 || d <= 0 || m < 2) return nullptr;
  auto* h = new Hnsw();
  h->n = n;
  h->d = d;
  h->m = m;
  h->efc = ef_construction;
  h->owned.assign(vecs, vecs + (size_t)n * d);
  h->levels.assign(n, 0);
  // generous level bound; vectors beyond max observed level stay empty
  int lmax = (int)(std::log((double)n) / std::log(std::max(2, m))) + 2;
  h->lmax = lmax;
  h->adj.assign(lmax + 1, std::vector<std::vector<int>>(n));

  // pre-sample levels (deterministic given seed, independent of thread
  // interleaving)
  std::mt19937 rng(seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  double ml = 1.0 / std::log(std::max(2, m));
  std::vector<int> node_level(n);
  for (int q = 0; q < n; q++) {
    int level = (int)(-std::log(std::max(1e-12, unif(rng))) * ml);
    node_level[q] = std::min(level, lmax);
  }

  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  n_threads = std::min(n_threads, std::max(1, n / 1024));

  if (n_threads <= 1) {
    std::vector<int> visit_mark(n, -1);
    int stamp = 0;
    for (int q = 0; q < n; q++) insert(*h, q, visit_mark, stamp, node_level[q]);
  } else {
    std::atomic<int> next{0};
    auto worker = [&]() {
      std::vector<int> visit_mark(n, -1);
      int stamp = 0;
      for (;;) {
        int q = next.fetch_add(1, std::memory_order_relaxed);
        if (q >= n) break;
        insert(*h, q, visit_mark, stamp, node_level[q]);
      }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  for (int q = 0; q < n; q++) h->levels[q] = node_level[q];
  // hand the exhausted sampling stream to the incremental path and only
  // start dirty tracking now (the full build is exported wholesale)
  h->level_rng = rng;
  h->track_dirty = true;
  return h;
}

// Insert `count` new vectors into an existing graph (same concurrent
// scheme as the build).  New node ids are [old_n, old_n+count).  Level
// sampling continues the build's deterministic RNG stream.  Returns the
// new node count, or -1 on error.
int frs_hnsw_add(void* hp, const float* vecs, int count, int n_threads) {
  auto* h = (Hnsw*)hp;
  if (!h || count <= 0) return -1;
  int old_n = h->n;
  int new_n = old_n + count;
  h->owned.resize((size_t)new_n * h->d);
  std::memcpy(h->owned.data() + (size_t)old_n * h->d, vecs,
              sizeof(float) * (size_t)count * h->d);
  h->levels.resize(new_n, 0);
  for (auto& level_adj : h->adj) level_adj.resize(new_n);

  std::uniform_real_distribution<double> unif(0.0, 1.0);
  double ml = 1.0 / std::log(std::max(2, h->m));
  std::vector<int> node_level(count);
  for (int i = 0; i < count; i++) {
    int level = (int)(-std::log(std::max(1e-12, unif(h->level_rng))) * ml);
    node_level[i] = std::min(level, h->lmax);
  }
  h->n = new_n;

  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  n_threads = std::min(n_threads, std::max(1, count / 256));

  if (n_threads <= 1) {
    std::vector<int> visit_mark(new_n, -1);
    int stamp = 0;
    for (int i = 0; i < count; i++) {
      insert(*h, old_n + i, visit_mark, stamp, node_level[i]);
      h->levels[old_n + i] = node_level[i];
    }
  } else {
    std::atomic<int> next{0};
    auto worker = [&]() {
      std::vector<int> visit_mark(new_n, -1);
      int stamp = 0;
      for (;;) {
        int i = next.fetch_add(1, std::memory_order_relaxed);
        if (i >= count) break;
        insert(*h, old_n + i, visit_mark, stamp, node_level[i]);
        h->levels[old_n + i] = node_level[i];
      }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  return new_n;
}

int frs_hnsw_size(void* hp) { return ((Hnsw*)hp)->n; }

// Deduplicated level-0 rows whose neighbor lists changed since the last
// drain.  Call with cap=0 to size the buffer; a second call with
// cap >= count drains (clears) the list.  Returns the deduped count.
int frs_hnsw_dirty(void* hp, int32_t* out, int cap) {
  auto* h = (Hnsw*)hp;
  std::lock_guard<std::mutex> g(h->dirty_mu);
  std::sort(h->dirty.begin(), h->dirty.end());
  h->dirty.erase(std::unique(h->dirty.begin(), h->dirty.end()),
                 h->dirty.end());
  int cnt = (int)h->dirty.size();
  if (cap < cnt) return cnt;  // sizing call: nothing drained
  for (int i = 0; i < cnt; i++) out[i] = h->dirty[i];
  h->dirty.clear();
  return cnt;
}

// Level-0 adjacency for an explicit row list: out is (count, 2m) int32,
// -1 padded.  Returns 2m.
int frs_hnsw_rows(void* hp, const int32_t* rows, int count, int32_t* out) {
  auto* h = (Hnsw*)hp;
  int w = 2 * h->m;
  for (int i = 0; i < count; i++) {
    int node = rows[i];
    std::vector<int> nb = h->neighbors(0, node);
    int j = 0;
    for (; j < (int)nb.size() && j < w; j++) out[(size_t)i * w + j] = nb[j];
    for (; j < w; j++) out[(size_t)i * w + j] = -1;
  }
  return w;
}

int frs_hnsw_max_level(void* hp) { return ((Hnsw*)hp)->max_level.load(); }

// Per-node top level: out (n,) int32.  Returns n.
int frs_hnsw_levels(void* hp, int32_t* out) {
  auto* h = (Hnsw*)hp;
  for (int i = 0; i < h->n; i++) out[i] = h->levels[i];
  return h->n;
}

// Adjacency at `level` for an explicit node list: out (count, m) int32,
// -1 padded, neighbor ids GLOBAL.  Nodes below `level` get all-pad rows.
// Returns m (the per-level degree cap above level 0).
int frs_hnsw_adjacency_l(void* hp, int level, const int32_t* nodes,
                         int count, int32_t* out) {
  auto* h = (Hnsw*)hp;
  if (level < 1 || level > h->lmax) return -1;
  int w = h->m;
  for (int i = 0; i < count; i++) {
    int node = nodes[i];
    int j = 0;
    if (node >= 0 && node < h->n && h->levels[node] >= level) {
      std::vector<int> nb = h->neighbors(level, node);
      for (; j < (int)nb.size() && j < w; j++) out[(size_t)i * w + j] = nb[j];
    }
    for (; j < w; j++) out[(size_t)i * w + j] = -1;
  }
  return w;
}

// out: (n, 2m) int32, row-major, -1 padded. Returns 2m.
int frs_hnsw_adjacency0(void* hp, int32_t* out) {
  auto* h = (Hnsw*)hp;
  int w = 2 * h->m;
  for (int i = 0; i < h->n; i++) {
    const auto& nb = h->adj[0][i];
    int j = 0;
    for (; j < (int)nb.size() && j < w; j++) out[(size_t)i * w + j] = nb[j];
    for (; j < w; j++) out[(size_t)i * w + j] = -1;
  }
  return w;
}

// Entry nodes for the device walk: all nodes with level >= 1, sorted by
// level descending (global entry first).  Returns count written (<= cap).
int frs_hnsw_entries(void* hp, int32_t* out, int cap) {
  auto* h = (Hnsw*)hp;
  std::vector<SimNode> hi;  // (level, node)
  for (int i = 0; i < h->n; i++)
    if (h->levels[i] >= 1) hi.push_back({(float)h->levels[i], i});
  std::sort(hi.begin(), hi.end(),
            [](const SimNode& a, const SimNode& b) { return a.first > b.first; });
  int cnt = 0;
  for (const auto& [lvl, node] : hi) {
    if (cnt >= cap) break;
    out[cnt++] = node;
  }
  if (cnt == 0 && h->n > 0 && cap > 0) {
    int e = h->entry.load();
    out[cnt++] = e >= 0 ? e : 0;
  }
  return cnt;
}

void frs_hnsw_destroy(void* hp) { delete (Hnsw*)hp; }

}  // extern "C"
