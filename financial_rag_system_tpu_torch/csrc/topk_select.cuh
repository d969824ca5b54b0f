// The select path of kernels 1 and 3: the top k for a k above the lists'
// 32 (kListK, topk_common.cuh), any k, by an exact threshold on the scores
// in place of best lists.  Launches, on the caller's stream:
//  1. The walk (masked_topk.cu / ivf_probe.cu's pass-1 kernel with
//     kSelect): the same producer, ring and tensor-core products as the
//     lists' pass 1 (score_tile), so the scores keep their bits; each
//     consumer warp writes its four queries' scores of a tile to their
//     rows of a (B, cols) f32 score table in device memory, -inf where a
//     row fails the query's filter or is not live.  A tile's 64 columns
//     are its rows for kernel 1 (column = row id), and for kernel 3 its
//     64-row piece's place in the walk of the probe list (`pieces` keeps
//     each piece's first packed position, -1 for a piece the producer
//     skipped).  Column order is the order `before` breaks ties by: the
//     row id, or the probe list's order (the packed order of an ascending
//     list, and the plain version's stable order of any list); kernel 3
//     maps a column to its gid only when the result is written.  The walk
//     also zeroes the histograms and the state.
//  2. One digit pass a digit of the 32-bit order key (order_key: the f32
//     mapped to a u32 of the same order, -0 with +0 as `before` ties
//     them), most significant first: `sweeps` blocks a query each take an
//     even contiguous share of the row's chunks of kChunk columns and
//     count the next kDigitBits bits of the finite keys whose higher
//     digits equal the prefix found so far into a histogram in shared
//     memory, then add it to the query's in device memory; the last block to finish (a
//     ticket) finds the bin that holds the k-th entry.  The prefix grows
//     by that digit and `above` by the entries of the bins above it.
//     After the last digit, or once a bin holds just the entries still
//     wanted, the threshold T is exact: the `above` entries whose key's
//     prefix is higher are taken, and the first `ties` of T's bin in
//     column order.  With fewer finite scores than k every finite score is
//     taken.  The last digit's pass also keeps each block's histogram.
//  3. collect_kernel, on the same shares, writes the survivors (key,
//     column): those above T's bin at slots taken by atomics, T's bin's
//     first `ties` at their rank in column order, from the entries equal
//     to T in the blocks before (their last-digit histograms) and a scan
//     over the block.  Only a full key can split T's bin, so only the last
//     digit's histograms are needed.  No buffer depends on how many
//     entries tie.
//  4. sort_kernel sorts each run of kSortCap survivors in shared memory by
//     (key desc, column asc) with a bitonic network; runs merge pairwise in
//     device memory (merge_runs_kernel: an entry's place is its index plus
//     its rank in the other run).  The last step writes the scores, read
//     back from the table with their own bits, and the ids; slots past the
//     survivors are -inf / -1.
// Every count is an integer and (key, column) a total order, so the result
// does not depend on which block runs when: relaunches are bit-identical.
// Bound: the walk's (the lists' pass 1), plus the table: at B 32 x 131,072
// rows it is 16.8 MB written once and read by each digit pass and the
// collection.

#pragma once

#include "topk_common.cuh"

namespace topk {

constexpr int kDigitBits = 11;                 // bits a digit pass settles: 11, 11, 10
constexpr int kBins = 1 << kDigitBits;         // a query's histogram
constexpr int kLastBits = 32 - kDigitBits * (31 / kDigitBits);  // the last digit's bits
constexpr int kChunk = 4096;                   // columns a block of passes 2-3 loads at once
constexpr int kSelThreads = 256;
constexpr int kSweepsAnSm = 8;                 // blocks of passes 2-3 an SM holds
constexpr int kSortCap = 4096;                 // survivors a block sorts in shared memory
constexpr int kSortThreads = 1024;
constexpr int kStateWords = 8;                 // a query's selection state
constexpr unsigned kKeyNegInf = 0x007fffffu;   // order_key(-inf)
static_assert(kDigitBits >= 8 && kDigitBits <= 12, "a histogram of 256-4096 bins");
static_assert(kChunk % (4 * kSelThreads) == 0, "whole float4 sweeps a chunk");
constexpr int kIter = kChunk / (4 * kSelThreads);  // float4 loads a thread a chunk

// a query's state words: the prefix's bits (32: T is exact) and value,
// entries above its bin, the bin's entries taken and held, whether T is
// settled, the pass's ticket and the survivors' atomic cursor
enum : int { kDepth, kPrefix, kAbove, kTies, kBin, kDone, kTicket, kCursor };

// the select path's views of the scratch (carve_select)
struct Select {
  float* table;       // (B, stride) masked scores
  unsigned* hist;     // (B, kBins), then the state: zeroed by the walk
  int* state;         // (B, kStateWords)
  int* n_cols;        // columns the walk scored
  unsigned* counts;   // (B, sweeps, 2^kLastBits) the last digit's histogram a block
  int2* surv;         // (B, k) survivors: (key, column)
  int2* surv2;        // (B, k) the merges' other buffer (more than one run)
  int* pieces;        // kernel 3: a piece's first packed position, or -1
  long long stride;   // columns a row of the table
  int sweeps;         // blocks a query of passes 2-3
  int runs;           // runs of kSortCap survivors
};

inline long long round4(long long words) { return (words + 3) & ~3LL; }

// blocks a query of passes 2-3: kSweepsAnSm an SM over the card's SMs
// (reckoned as if the walk's grid were two blocks an SM; the wide
// kernel's one an SM gets half as many), at most a chunk each
inline int select_sweeps(int B, long long cols, int walk_blocks) {
  const long long chunks = (cols + kChunk - 1) / kChunk;
  const long long fill = ((long long)kSweepsAnSm / 2 * walk_blocks + B - 1) / B;
  return (int)(chunks < fill ? chunks : (fill > 1 ? fill : 1));
}

// int32 words of scratch the select path takes (ops/topk.py select_scratch
// mirrors it): the table; histograms, state and column count; the blocks'
// last-digit histograms; the survivors (twice with more than one run);
// kernel 3's pieces
inline long long select_words(int B, long long cols, int k, int sweeps, bool ivf) {
  const long long runs = (k + kSortCap - 1) / kSortCap;
  return (long long)B * cols + round4((long long)B * (kBins + kStateWords) + 1) +
         round4((long long)B * sweeps << kLastBits) + 2LL * B * k * (runs > 1 ? 2 : 1) +
         (ivf ? round4(cols / kRows) : 0);
}

inline Select carve_select(void* scratch, int B, long long cols, int k, int sweeps, bool ivf) {
  Select s;
  int* w = static_cast<int*>(scratch);
  s.stride = cols;
  s.sweeps = sweeps;
  s.runs = (k + kSortCap - 1) / kSortCap;
  s.table = reinterpret_cast<float*>(w);
  w += (size_t)B * cols;
  s.hist = reinterpret_cast<unsigned*>(w);
  s.state = w + (size_t)B * kBins;
  s.n_cols = s.state + (size_t)B * kStateWords;
  w += round4((long long)B * (kBins + kStateWords) + 1);
  s.counts = reinterpret_cast<unsigned*>(w);
  w += round4((long long)B * sweeps << kLastBits);
  s.surv = reinterpret_cast<int2*>(w);
  w += 2LL * B * k;
  s.surv2 = nullptr;
  if (s.runs > 1) {
    s.surv2 = reinterpret_cast<int2*>(w);
    w += 2LL * B * k;
  }
  s.pieces = ivf ? w : nullptr;
  return s;
}

// -- the walk ----------------------------------------------------------------

// every thread of the walk's grid zeroes a strided share of the
// histograms and the state
__device__ __forceinline__ void clear_select(const Select& sel, int B) {
  const long long n = (long long)B * (kBins + kStateWords);
  const long long threads = (long long)gridDim.x * gridDim.y * blockDim.x;
  for (long long i = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += threads)
    reinterpret_cast<int*>(sel.hist)[i] = 0;
}

// A consumer warp's walk on the select path: score each tile as consume
// does (kWide: take its scores from the scoring warpgroup's buffer), then
// write its queries' scores of the tile's 64 rows to their rows of the
// table from the tile's column, -inf where the row is not a candidate
// (consume's rule).
template <typename T, bool kIvf, bool kWide = false>
__device__ __forceinline__ void store_walk(const Smem& m, int nbox, int row_bytes, int stages,
                                           int B, int qb0, int n, int n_valid,
                                           const int32_t* __restrict__ qf, const Select& sel,
                                           int warp, int lane) {
  constexpr int Q = kQueries<kWide>;
  int tq[Q], dq[Q];
#pragma unroll
  for (int qq = 0; qq < Q; ++qq) {
    const int q = qb0 + warp * Q + qq;
    tq[qq] = q < B ? qf[2 * q] : 0;
    dq[qq] = q < B ? qf[2 * q + 1] : 0;
  }
  mbar_wait(m.qbar, 0);
  int s = 0, ph = 0;
  for (int tile = 0;; ++tile) {
    const int slot = tile % kSlots;
    mbar_wait(&m.sfull[slot], (tile / kSlots) & 1);
    const unsigned char* sl = m.slots + slot * kSlotBytes;
    const int base = *reinterpret_cast<const volatile int*>(sl + kSlotBase);
    if (base < 0) break;
    const int col = *reinterpret_cast<const volatile int*>(sl + kSlotCol);
    int buf = 0;
    const float* sc;
    if constexpr (kWide) sc = wide_scores(m, tile, buf);
    else sc = score_tile<T>(m, nbox, row_bytes, stages, tile, s, ph, warp, lane);

    const int32_t* codes0 = reinterpret_cast<const int32_t*>(sl);
    const int32_t* codes1 = reinterpret_cast<const int32_t*>(sl + kSlotCodes1) + (n & 3);
    const int32_t* gids = reinterpret_cast<const int32_t*>(sl + kSlotGids);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      const int tc = codes0[r], dc = codes1[r];
      const bool row_ok = kIvf ? gids[r] >= 0 : base + r < n_valid;
#pragma unroll
      for (int qq = 0; qq < Q; ++qq) {
        const int q = qb0 + warp * Q + qq;
        const bool ok = row_ok && (tq[qq] == -1 || tq[qq] == tc) && (dq[qq] == -1 || dq[qq] == dc);
        if (q < B)
          sel.table[(size_t)q * sel.stride + col + r] =
              ok ? sc[(warp * Q + qq) * kScStride + r] : -INFINITY;
      }
    }
    __syncwarp();
    if (lane == 0) {
      if constexpr (kWide) mbar_arrive(&m.scempty[buf]);
      mbar_arrive(&m.sempty[slot]);
    }
  }
}

// -- passes over the table -----------------------------------------------------

// a u32 whose order is the score's; -0 maps with +0, which `before` ties
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned u = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (key a, column a) ranks before (key b, column b)
__device__ __forceinline__ bool ranks_before(unsigned ka, int ca, unsigned kb, int cb) {
  return ka > kb || (ka == kb && ca < cb);
}

// columns c..c+3 of a query's row (c a multiple of 4, so one piece), -inf
// past the scored columns and in a piece the walk skipped
__device__ __forceinline__ float4 load4(const Select& sel, const float* row, int c, int n_cols) {
  if (c >= n_cols || (sel.pieces != nullptr && sel.pieces[c / kRows] < 0))
    return make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
  return *reinterpret_cast<const float4*>(row + c);
}

// chunk `chunk` of a query's row, every load issued before any is used:
// v[it] holds columns chunk * kChunk + 4 (threadIdx.x + it * kSelThreads) on
__device__ __forceinline__ void load_chunk(const Select& sel, const float* row, int chunk,
                                           int n_cols, float4 (&v)[kIter]) {
#pragma unroll
  for (int it = 0; it < kIter; ++it)
    v[it] = load4(sel, row, chunk * kChunk + 4 * ((int)threadIdx.x + it * kSelThreads), n_cols);
}

__device__ __forceinline__ float part(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// this block's share of the chunks the walk scored, [c0, c1): the same in
// every pass over the table
__device__ __forceinline__ void my_chunks(int n_cols, int& c0, int& c1) {
  const long long chunks = (n_cols + kChunk - 1) / kChunk;
  c0 = (int)(chunks * blockIdx.x / gridDim.x);
  c1 = (int)(chunks * (blockIdx.x + 1) / gridDim.x);
}

// exclusive sum of v over the block's threads in order (kSelThreads of
// them); total receives the block's sum
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned& total, unsigned* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(~0u, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  unsigned before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kSelThreads / 32; ++w) {
    const unsigned b = buf[w];
    before += w < warp ? b : 0;
    total += b;
  }
  __syncthreads();  // buf is free again
  return before + x - v;
}

// The last block of a digit pass: thread t holds the histogram's bins
// from the top, `per` of them; a scan finds the bin where the count from
// the top reaches the entries still wanted, and the state takes its digit.
// The histogram is left zero and the ticket 0 for the next pass.
__device__ __forceinline__ void settle(unsigned* gh, int* st, int k, int depth, int width,
                                       unsigned prefix, unsigned* buf) {
  constexpr int kPer = kBins / kSelThreads > 1 ? kBins / kSelThreads : 1;
  const int nb = 1 << width, per = max(1, nb / kSelThreads), t = threadIdx.x;
  const int top = nb - 1 - t * per;
  const int above = st[kAbove];
  const unsigned need = (unsigned)(k - above);
  unsigned mine[kPer], sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    mine[j] = 0;
    if (j < per && top - j >= 0) {
      mine[j] = __ldcg(gh + top - j);
      gh[top - j] = 0;
      sum += mine[j];
    }
  }
  unsigned total;
  const unsigned before = block_scan(sum, total, buf);
  if (total < need) {  // fewer finite scores than wanted (the first digit only): all of them
    if (t == 0) {
      st[kDepth] = 32;
      st[kPrefix] = (int)kKeyNegInf;
      st[kAbove] = above + (int)total;
      st[kTies] = 0;
      st[kBin] = 0;
      st[kDone] = 1;
    }
  } else if (before < need && need <= before + sum) {
    unsigned acc = before;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (acc + mine[j] >= need) {  // bin top - j holds the entry wanted last
        const int d = depth + width;
        const unsigned rem = need - acc;
        st[kAbove] = above + (int)acc;
        st[kPrefix] = (int)((prefix << width) | (unsigned)(top - j));
        st[kDepth] = d;
        if (d == 32 || rem == mine[j]) {
          st[kTies] = (int)rem;
          st[kBin] = (int)mine[j];
          st[kDone] = 1;
        }
        break;
      }
      acc += mine[j];
    }
  }
  if (t == 0) st[kTicket] = 0;
}

// One digit pass, grid (sweeps, B): the next `width` bits below `depth`.
__global__ void __launch_bounds__(kSelThreads)
digit_kernel(const Select sel, int k, int depth, int width) {
  __shared__ unsigned h[kBins];
  __shared__ unsigned buf[kSelThreads / 32];
  __shared__ int last;
  const int q = blockIdx.y, t = threadIdx.x;
  int* st = sel.state + (size_t)q * kStateWords;
  if (st[kDone]) return;
  const unsigned prefix = (unsigned)st[kPrefix];
  const int nb = 1 << width, shift = 32 - depth - width;
  for (int i = t; i < nb; i += kSelThreads) h[i] = 0;
  __syncthreads();
  const int n_cols = *sel.n_cols;
  int c0, c1;
  my_chunks(n_cols, c0, c1);
  const float* row = sel.table + (size_t)q * sel.stride;
  for (int chunk = c0; chunk < c1; ++chunk) {
    float4 v[kIter];
    load_chunk(sel, row, chunk, n_cols, v);
#pragma unroll
    for (int it = 0; it < kIter; ++it) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s = part(v[it], j);
        const unsigned key = order_key(s);
        if (s != -INFINITY && (depth == 0 || (key >> (32 - depth)) == prefix))
          atomicAdd(&h[(key >> shift) & (unsigned)(nb - 1)], 1u);
      }
    }
  }
  __syncthreads();
  unsigned* gh = sel.hist + (size_t)q * kBins;
  for (int i = t; i < nb; i += kSelThreads)
    if (h[i] != 0) atomicAdd(&gh[i], h[i]);
  if (depth + width == 32) {  // collect ranks T's ties from these
    unsigned* mine = sel.counts + ((size_t)q * gridDim.x + blockIdx.x) * nb;
    for (int i = t; i < nb; i += kSelThreads) mine[i] = h[i];
  }
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(&st[kTicket], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  settle(gh, st, k, depth, width, prefix, buf);
}

// the survivors of the block's chunks: above T's bin (and all of T's bin
// where all of it is taken) at slots taken by atomics, a warp's at once;
// T's bin's entries in column order, the first `ties` of the query at
// `above` + rank
__global__ void __launch_bounds__(kSelThreads) collect_kernel(const Select sel, int k) {
  __shared__ unsigned buf[kSelThreads / 32];
  const int q = blockIdx.y, t = threadIdx.x, lane = t & 31;
  int* st = sel.state + (size_t)q * kStateWords;
  const int n_cols = *sel.n_cols;
  int c0, c1;
  my_chunks(n_cols, c0, c1);
  if (c0 >= c1) return;
  const unsigned prefix = (unsigned)st[kPrefix];
  const int shift = 32 - st[kDepth], above = st[kAbove], ties = st[kTies], bin = st[kBin];
  const bool ordered = ties > 0 && ties < bin, whole = ties > 0 && ties == bin;
  int2* out = sel.surv + (size_t)q * k;
  unsigned rank = 0;  // entries equal to T in the blocks before (only a full key splits a bin)
  if (ordered) {
    const unsigned tb = prefix & ((1u << kLastBits) - 1);
    unsigned mine = 0;
    for (int g = t; g < (int)blockIdx.x; g += kSelThreads)
      mine += sel.counts[(((size_t)q * gridDim.x + g) << kLastBits) + tb];
    block_scan(mine, rank, buf);
  }
  const float* row = sel.table + (size_t)q * sel.stride;
  for (int chunk = c0; chunk < c1; ++chunk) {
    float4 v[kIter];
    load_chunk(sel, row, chunk, n_cols, v);
#pragma unroll
    for (int it = 0; it < kIter; ++it) {
      const int c = chunk * kChunk + 4 * (t + it * kSelThreads);
      unsigned key[4], tied = 0;
      bool up[4], tie[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s = part(v[it], j);
        key[j] = order_key(s);
        const unsigned hi = key[j] >> shift;
        const bool fin = s != -INFINITY;
        up[j] = fin && (hi > prefix || (whole && hi == prefix));
        tie[j] = fin && ordered && hi == prefix;
        tied += tie[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned m = __ballot_sync(~0u, up[j]);
        if (m == 0) continue;
        const int lead = __ffs(m) - 1;
        int at = 0;
        if (lane == lead) at = atomicAdd(&st[kCursor], __popc(m));
        at = __shfl_sync(~0u, at, lead);
        if (up[j]) out[at + __popc(m & ((1u << lane) - 1))] = make_int2((int)key[j], c + j);
      }
      if (ordered) {  // the same for every thread of the block
        unsigned total;
        unsigned r = rank + block_scan(tied, total, buf);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (tie[j]) {
            if (r < (unsigned)ties) out[above + r] = make_int2((int)key[j], c + j);
            ++r;
          }
        }
        rank += total;
      }
    }
  }
}

// result slot j of query q: the survivor at `col` (real), else empty
__device__ __forceinline__ void emit(const Select& sel, int q, int k, int j, bool real, int col,
                                     const int32_t* __restrict__ gids, float* __restrict__ out_s,
                                     int32_t* __restrict__ out_i) {
  const size_t at = (size_t)q * k + j;
  if (!real) {
    out_s[at] = -INFINITY;
    out_i[at] = -1;
    return;
  }
  out_s[at] = sel.table[(size_t)q * sel.stride + col];
  out_i[at] = gids != nullptr ? gids[sel.pieces[col / kRows] + col % kRows] : col;
}

// Sort run blockIdx.x of query blockIdx.y's survivors, best first (a
// bitonic network over the run padded to a power of two with entries that
// rank last); one run is the result, more go back for the merges.
__global__ void __launch_bounds__(kSortThreads)
sort_kernel(const Select sel, int k, const int32_t* __restrict__ gids, float* __restrict__ out_s,
            int32_t* __restrict__ out_i) {
  __shared__ unsigned sk[kSortCap];
  __shared__ int sc[kSortCap];
  const int q = blockIdx.y, t = threadIdx.x;
  const int* st = sel.state + (size_t)q * kStateWords;
  const int m = st[kAbove] + st[kTies];
  const int r0 = blockIdx.x * kSortCap, n = max(0, min(m - r0, kSortCap));
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  int2* run = sel.surv + (size_t)q * k + r0;
  for (int i = t; i < n2; i += kSortThreads) {
    const int2 e = i < n ? run[i] : make_int2(0, INT_MAX);
    sk[i] = (unsigned)e.x;
    sc[i] = e.y;
  }
  __syncthreads();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < n2 / 2; i += kSortThreads) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        if (ranks_before(sk[hi], sc[hi], sk[lo], sc[lo]) == ((lo & size) == 0)) {
          const unsigned ks = sk[lo];
          const int cs = sc[lo];
          sk[lo] = sk[hi];
          sc[lo] = sc[hi];
          sk[hi] = ks;
          sc[hi] = cs;
        }
      }
      __syncthreads();
    }
  }
  if (sel.runs == 1) {
    for (int j = t; j < k; j += kSortThreads) emit(sel, q, k, j, j < n, sc[j], gids, out_s, out_i);
  } else {
    for (int i = t; i < n; i += kSortThreads) run[i] = make_int2((int)sk[i], sc[i]);
  }
}

// One merge of sorted runs of w survivors into runs of 2w: entry i's place
// is its index in its run plus the entries of the other run that rank
// before it.  The last merge (dst null) writes the result.
__global__ void __launch_bounds__(kSelThreads)
merge_runs_kernel(const Select sel, int k, int w, const int2* __restrict__ src,
                  int2* __restrict__ dst, const int32_t* __restrict__ gids,
                  float* __restrict__ out_s, int32_t* __restrict__ out_i) {
  const int q = blockIdx.y, i = blockIdx.x * kSelThreads + threadIdx.x;
  if (i >= k) return;
  const int* st = sel.state + (size_t)q * kStateWords;
  const int m = st[kAbove] + st[kTies];
  if (i >= m) {
    if (dst == nullptr) emit(sel, q, k, i, false, 0, gids, out_s, out_i);
    return;
  }
  const int2* run = src + (size_t)q * k;
  const int r = i / w, start = (r & ~1) * w;
  const int lo0 = (r & 1) ? start : start + w;
  const int hi0 = (r & 1) ? start + w : min(start + 2 * w, m);
  const int2 e = run[i];
  int lo = lo0, hi = max(lo0, hi0);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int2 p = run[mid];
    if (ranks_before((unsigned)p.x, p.y, (unsigned)e.x, e.y)) lo = mid + 1;
    else hi = mid;
  }
  const int at = start + (i - r * w) + (lo - lo0);
  if (dst == nullptr) emit(sel, q, k, at, true, e.y, gids, out_s, out_i);
  else dst[(size_t)q * k + at] = e;
}

// passes 2-4 on `stream`, after the walk; gids maps kernel 3's columns
// (null for kernel 1); out_s / out_i are (B, k)
inline int select_rest(const Select& sel, int B, int k, const int32_t* gids, float* out_s,
                       int32_t* out_i, cudaStream_t stream) {
  const dim3 grid(sel.sweeps, B);
  for (int depth = 0; depth < 32; depth += kDigitBits) {
    digit_kernel<<<grid, kSelThreads, 0, stream>>>(sel, k, depth, min(kDigitBits, 32 - depth));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  collect_kernel<<<grid, kSelThreads, 0, stream>>>(sel, k);
  sort_kernel<<<dim3(sel.runs, B), kSortThreads, 0, stream>>>(sel, k, gids, out_s, out_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int2* src = sel.surv;
  int2* other = sel.surv2;
  for (int w = kSortCap; w < k; w *= 2) {
    const bool last = 2LL * w >= k;
    merge_runs_kernel<<<dim3((k + kSelThreads - 1) / kSelThreads, B), kSelThreads, 0, stream>>>(
        sel, k, w, src, last ? nullptr : other, gids, out_s, out_i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    int2* next = other;
    other = const_cast<int2*>(src);
    src = next;
  }
  return (int)cudaSuccess;
}

}  // namespace topk
