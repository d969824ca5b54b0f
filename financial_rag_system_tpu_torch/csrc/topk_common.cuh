// Pieces shared by the two masked top-k kernels: masked_topk.cu (kernel 1,
// a contiguous corpus) and ivf_probe.cu (kernel 3, the probed tiles of the
// IVF packing).  Each is two launches sized by a host plan (ops/topk.py
// topk_plan, index/ivf.py probe_plan):
//  - pass 1, a persistent grid of (blocks) x (query blocks of 32) blocks
//    of nine warps, two an SM.  The producer warp loads the block's 32
//    queries by TMA, then walks the block's share of 64-row tiles (kernel
//    3: the live 64-row pieces of the active probe entries) and loads
//    each by TMA: the tile's codes (kernel 3: and gids) and its first
//    row's position into one of kSlots tile slots, its rows in boxes of
//    64 rows x 128 bytes (128-byte swizzle) into a ring of `stages`
//    boxes, all completing on mbarriers.  Eight consumer warps score each
//    tile on the tensor cores, box by box (warp w: the 32 queries x rows
//    8w..8w+7, mma.sync m16n8k16 bf16 or m16n8k32 s8, fragments by
//    ldmatrix from the swizzled boxes), write the scores to shared memory,
//    and then select.  Warp w owns queries 4w..4w+3, and each query's best
//    list lies across the warp's lanes: lane j holds entry j of k.  A
//    tile's rows are two candidates a lane; a ballot of "ranks before the
//    list's entry k - 1" finds the few that enter, and each is placed by a
//    ballot of `before` and moved in with __shfl_up_sync; a batch where
//    more than kBulk enter (a block's first tiles) is sorted by a bitonic
//    network and merged with the list in one pass instead (or becomes the
//    list, while it is empty).  The warp's four queries take these steps
//    side by side, so their shuffle chains overlap.  Each block writes its
//    lists to a (B, k, blocks) scratch.
//  - pass 2, one block of four warps a query: warp w merges the lists of
//    blocks w, w + 4, ... with the same list, round j offering entry j of
//    each list still in the running (a list whose entry j does not enter
//    leaves, since its later entries rank lower still), and the four
//    warps' lists merge pairwise through shared memory.
// A k above 32 (any k) runs in rounds of at most 32 (kRoundK): each
// round is the two launches above, and round r > 0 offers only the rows
// that rank after round r - 1's last entry, its floor, which the round
// reads from the result so far.  The lists hold one entry a lane, so a
// round finds the next 32 of the order, and the rounds laid end to end are
// the top k.  (Lists of k entries, ceil(k / 32) a lane, would not fit: a
// consumer warp keeps the lists of four queries, 256 registers a lane at
// k 1024, and a block's 32 lists of 1024 entries are 256 KB, above the
// 227 KB of shared memory a block may take.)  The floor is the only thing
// a round carries, so k bounds nothing but the output: ceil(k / 32)
// rounds, each a full pass over the rows or the probed tiles.  Rounds past
// the last live row find nothing (a floor of -inf admits no row) and
// leave -inf / -1.
// The query block's boxes stay in shared memory for the whole walk, 4 KB
// a box of 128 bytes (64 bf16 or 128 int8 values): up to 1,024 bf16
// values a row two blocks share an SM with a ring of 3-8 boxes; wider
// rows, up to kMaxRowBytes (49 boxes: D 3,136 in bf16, 6,272 in int8),
// take one block an SM and the ring its remaining shared memory holds
// (ops/topk.py plan_for).
// Every comparison is on (score, id) with `before`, never on the score
// alone, so the result is the top k by (score desc, id asc) whatever order
// rows are visited in: relaunches are bit-identical.  The id is the row
// for kernel 1 and the packed position for kernel 3, which maps it to a
// row id only when the result is written.
// Scores: each (query, row) sum runs over D in the same 32-byte k-steps,
// with the same instruction and from zero, as the kernels of the design
// before this one did, so bf16 scores keep their bits; an int8 score is an
// s32 sum cast to f32, as the JAX kernel's int8 branch computes it.  The
// s32 sum is exact (|sum| <= 127^2 * D < 2^31); up to D 1040, 127^2 * D <
// 2^24 and the cast is exact too, above it the cast rounds to the nearest
// f32 once (the plain versions sum in f64 and round the same way).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace topk {

constexpr int kQB = 32;                          // queries a block
constexpr int kConsumers = 8;                    // consumer warps
constexpr int kQPW = kQB / kConsumers;           // queries a consumer warp owns
constexpr int kThreads = (kConsumers + 1) * 32;  // and the producer warp
constexpr int kRows = 64;                        // rows a tile (kernel 3: a piece)
constexpr int kBoxBytes = 128;                   // bytes of a row in one box
constexpr int kBox = kRows * kBoxBytes;          // a ring stage: 8 KB
constexpr int kQBox = kQB * kBoxBytes;           // a box of the query block: 4 KB
constexpr int kSlots = 4;                        // tile slots
constexpr int kSlotBytes = 1152;                 // codes [2][68], gids [64], position
constexpr int kCodeBox = kRows + 4;              // codes a box: row 1 starts 4-aligned
constexpr int kScStride = kRows + 4;             // floats a query's row of scores
constexpr int kRoundK = 32;                      // entries a round finds: one a lane
constexpr int kMaxRowBytes = 6272;               // 49 boxes: the widest row a plan takes
constexpr int kMaxStages = 16;
constexpr int kMergeWarps = 4;                   // pass 2: warps a query
constexpr int kMaxChunks = 3;                    // pass 2: lists a lane
constexpr int kMaxBlocks = kMergeWarps * 32 * kMaxChunks;
constexpr int kBulk = 4;                         // entering candidates a batch sorts above
constexpr int kNoId = 0x7fffffff;
constexpr int kSmemLimit = 232448;

// (s1, i1) ranks before (s2, i2): higher score, then lower id
__device__ __forceinline__ bool before(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// d += a (16x32, row) * b (32x8, col), s8 in, s32 accumulate
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The element type of the queries and the corpus: the D a k-step covers
// (32 bytes either way) and the tensor-core product of one step.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kDimStep = 16;  // one m16n8k16 step
  using Acc = float;
  __device__ static void mma(Acc (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    mma_bf16(d, a, b0, b1);
  }
};

template <>
struct Elem<int8_t> {
  static constexpr int kDimStep = 32;  // one m16n8k32 step
  using Acc = int;
  __device__ static void mma(Acc (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    mma_s8(d, a, b0, b1);
  }
};

// four (x4) or two (x2) 8x8 matrices of 16-byte rows from shared memory:
// lanes 8i..8i+7 give the addresses of matrix i's rows, and r[i] receives
// word (lane % 4) of row (lane / 4) of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// -- shared memory ---------------------------------------------------------

__host__ __device__ inline int boxes_for(int row_bytes) {
  return (row_bytes + kBoxBytes - 1) / kBoxBytes;
}

// Dynamic shared memory a block takes (ops/topk.py topk_smem mirrors it):
// 1024 bytes of alignment slack, the query block's boxes, the ring, the
// tile slots, two buffers of scores and the mbarriers.
__host__ __device__ inline size_t smem_bytes(int nbox, int stages) {
  return 1024 + (size_t)nbox * kQBox + (size_t)stages * kBox + kSlots * kSlotBytes +
         sizeof(float) * 2 * kQB * kScStride + sizeof(uint64_t) * (2 * stages + 2 * kSlots + 1);
}

struct Smem {
  unsigned char* q;      // [nbox][32 rows][128 B], 128-byte swizzle
  unsigned char* ring;   // [stages][64 rows][128 B], 128-byte swizzle
  unsigned char* slots;  // [kSlots][kSlotBytes]
  float* sc;             // [2][kQB][kScStride]
  uint64_t* full;        // [stages] a box has landed
  uint64_t* empty;       // [stages] the consumers have read a box
  uint64_t* sfull;       // [kSlots] a slot has landed
  uint64_t* sempty;      // [kSlots] the consumers are done with a slot's tile
  uint64_t* qbar;        // the query block has landed
};

// a tile slot: ticker codes, doc-type codes, gids (kernel 3), position;
// each TMA destination 128-byte aligned
constexpr int kSlotCodes1 = 384;
constexpr int kSlotGids = 768;
constexpr int kSlotBase = 1024;

__device__ __forceinline__ Smem carve(unsigned char* raw, int nbox, int stages) {
  Smem m;
  unsigned char* p = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  m.q = p;
  p += nbox * kQBox;
  m.ring = p;
  p += stages * kBox;
  m.slots = p;
  p += kSlots * kSlotBytes;
  m.sc = reinterpret_cast<float*>(p);
  p += sizeof(float) * 2 * kQB * kScStride;
  m.full = reinterpret_cast<uint64_t*>(p);
  m.empty = m.full + stages;
  m.sfull = m.empty + stages;
  m.sempty = m.sfull + kSlots;
  m.qbar = m.sempty + kSlots;
  return m;
}

__device__ __forceinline__ void init_barriers(const Smem& m, int stages) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(&m.full[s], 1);
    mbar_init(&m.empty[s], kConsumers);
  }
  for (int s = 0; s < kSlots; ++s) {
    mbar_init(&m.sfull[s], 1);
    mbar_init(&m.sempty[s], kConsumers);
  }
  mbar_init(m.qbar, 1);
  mbar_init_fence();
}

// -- the producer (one thread) -------------------------------------------------

struct Producer {
  Smem m;
  int stages, nbox;
  int s = 0, ph = 0;      // the ring's next stage and its pass parity
  int slot = 0, sph = 0;  // the next tile slot and its pass parity

  __device__ Producer(const Smem& sm, int n_stages, int boxes)
      : m(sm), stages(n_stages), nbox(boxes) {}

  // the 32 queries from row qb0 (rows past B arrive as zeros)
  __device__ void queries(const CUtensorMap* qmap, int qb0) {
    mbar_arrive_expect_tx(m.qbar, nbox * kQBox);
    for (int b = 0; b < nbox; ++b) tma_load_2d(m.q + b * kQBox, qmap, m.qbar, b * kBoxBytes, qb0);
  }

  // The tile of rows [base, base + 64): its codes, its gids when `gmap`
  // is given, then its boxes; rows past the tensor arrive as zeros.  The
  // (2, n) codes are one flat map of 2n values, and a box must start at a
  // 16-byte aligned address: row 0's at base (a multiple of 64), row 1's
  // at n + base rounded down to a multiple of 4, so the box of 68 holds
  // the tile's 64 from (n % 4) on.
  __device__ void tile(const CUtensorMap* rmap, const CUtensorMap* cmap, const CUtensorMap* gmap,
                       int base, int n) {
    mbar_wait(&m.sempty[slot], sph ^ 1);
    unsigned char* sl = m.slots + slot * kSlotBytes;
    *reinterpret_cast<volatile int*>(sl + kSlotBase) = base;
    mbar_arrive_expect_tx(&m.sfull[slot], 2 * kCodeBox * 4 + (gmap != nullptr ? kRows * 4 : 0));
    tma_load_1d(sl, cmap, &m.sfull[slot], base);
    tma_load_1d(sl + kSlotCodes1, cmap, &m.sfull[slot], (n + base) & ~3);
    if (gmap != nullptr) tma_load_1d(sl + kSlotGids, gmap, &m.sfull[slot], base);
    if (++slot == kSlots) { slot = 0; sph ^= 1; }
    for (int b = 0; b < nbox; ++b) {
      mbar_wait(&m.empty[s], ph ^ 1);
      mbar_arrive_expect_tx(&m.full[s], kBox);
      tma_load_2d(m.ring + s * kBox, rmap, &m.full[s], b * kBoxBytes, base);
      if (++s == stages) { s = 0; ph ^= 1; }
    }
  }

  // no more tiles: a slot whose position is -1
  __device__ void end() {
    mbar_wait(&m.sempty[slot], sph ^ 1);
    *reinterpret_cast<volatile int*>(m.slots + slot * kSlotBytes + kSlotBase) = -1;
    mbar_arrive(&m.sfull[slot]);
  }
};

// -- scoring ---------------------------------------------------------------

// One box of the (32 queries) x (this warp's 8 rows) product: `steps`
// k-steps of 32 bytes, from the query box at `qbox` and the ring stage at
// `cbox` (shared addresses; 16-byte chunk c of row r sits at chunk c ^ (r % 8)).
template <typename T>
__device__ __forceinline__ void score_box(typename Elem<T>::Acc (&acc)[2][4], uint32_t qbox,
                                          uint32_t cbox, int steps, int warp, int lane) {
  const uint32_t x = lane & 7;
  const uint32_t arow = qbox + (x + ((lane >> 3) & 1) * 8) * kBoxBytes;
  const uint32_t brow = cbox + (warp * 8 + x) * kBoxBytes;
  const uint32_t ahi = lane >> 4, bhi = (lane >> 3) & 1;
#pragma unroll
  for (int st = 0; st < 4; ++st) {
    if (st < steps) {
      uint32_t b0, b1;
      ldsm_x2(b0, b1, brow + (((2 * st + bhi) ^ x) << 4));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, arow + mt * 16 * kBoxBytes + (((2 * st + ahi) ^ x) << 4));
        Elem<T>::mma(acc[mt], a, b0, b1);
      }
    }
  }
}

template <typename Acc>
__device__ __forceinline__ void store_scores(float* sc, const Acc (&acc)[2][4], int warp,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float* s0 = sc + (mt * 16 + g) * kScStride + warp * 8 + 2 * t;
    *reinterpret_cast<float2*>(s0) = make_float2((float)acc[mt][0], (float)acc[mt][1]);
    *reinterpret_cast<float2*>(s0 + 8 * kScStride) =
        make_float2((float)acc[mt][2], (float)acc[mt][3]);
  }
}

// -- best lists across a warp ----------------------------------------------
// Q lists side by side (pass 1: a warp's four queries; pass 2: one), so
// their shuffle chains overlap: every step runs for all Q, a no-op where
// a list has nothing to take.

// Insert (cs, ci) if it ranks before entry k - 1: the entries before it
// are a prefix of the lanes, so a ballot gives its place, and the entries
// from there move down one lane.  (-inf, kNoId) changes nothing.
__device__ __forceinline__ void insert(float& ls, int& li, float cs, int ci, int lane, int k) {
  const unsigned kmask = k == 32 ? ~0u : (1u << k) - 1;
  const int pos = __popc(__ballot_sync(~0u, before(ls, li, cs, ci)) & kmask);
  const float us = __shfl_up_sync(~0u, ls, 1);
  const int ui = __shfl_up_sync(~0u, li, 1);
  if (pos < k) {
    if (lane == pos) {
      ls = cs;
      li = ci;
    } else if (lane > pos) {
      ls = us;
      li = ui;
    }
  }
}

// compare-exchange with lane ^ stride: keep the better entry, or the worse
__device__ __forceinline__ void cmpx(float& s, int& i, int stride, bool keep_better) {
  const float os = __shfl_xor_sync(~0u, s, stride);
  const int oi = __shfl_xor_sync(~0u, i, stride);
  if (before(os, oi, s, i) == keep_better) {
    s = os;
    i = oi;
  }
}

// each of Q batches of 32 entries (one a lane) sorted best first (bitonic)
template <int Q>
__device__ __forceinline__ void sort32(float (&s)[Q], int (&i)[Q], int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool keep = ((lane & stride) == 0) == ((lane & size) == 0);
#pragma unroll
      for (int q = 0; q < Q; ++q) cmpx(s[q], i[q], stride, keep);
    }
  }
}

// list q := the best 32 of its first k entries and sorted batch q, where
// take[q]: the better of entry j and batch entry 31 - j is a bitonic
// sequence holding them, which five exchanges sort
template <int Q>
__device__ __forceinline__ void merge_sorted(float (&ls)[Q], int (&li)[Q], const float (&bs)[Q],
                                             const int (&bi)[Q], const bool (&take)[Q], int lane,
                                             int k) {
  float ms[Q];
  int mi[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    ms[q] = lane < k ? ls[q] : -INFINITY;
    mi[q] = lane < k ? li[q] : kNoId;
    const float rs = __shfl_sync(~0u, bs[q], 31 - lane);
    const int ri = __shfl_sync(~0u, bi[q], 31 - lane);
    if (before(rs, ri, ms[q], mi[q])) {
      ms[q] = rs;
      mi[q] = ri;
    }
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
#pragma unroll
    for (int q = 0; q < Q; ++q) cmpx(ms[q], mi[q], stride, (lane & stride) == 0);
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (take[q]) {
      ls[q] = ms[q];
      li[q] = mi[q];
    }
  }
}

// Offer each lane's candidate (cs[q], ci[q]), taken where ok[q], to list
// q; (ts[q], ti[q]) is the list's entry k - 1, kept current, and fresh[q]
// whether the list has taken nothing yet.  enter[q]: whether the
// candidate ranked before entry k - 1 when offered.  The batches that
// take the bulk path sort side by side, then each merges into its list
// (or becomes it, where every such list is fresh); the single inserts run
// the Q lists side by side.
template <int Q>
__device__ __forceinline__ void offer(float (&ls)[Q], int (&li)[Q], float (&ts)[Q], int (&ti)[Q],
                                      bool (&fresh)[Q], const float (&cs)[Q], const int (&ci)[Q],
                                      const bool (&ok)[Q], bool (&enter)[Q], int lane, int k) {
  unsigned m[Q], any = 0;
  bool bulk[Q], took[Q], any_bulk = false, all_fresh = true;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    enter[q] = ok[q] && before(cs[q], ci[q], ts[q], ti[q]);
    m[q] = __ballot_sync(~0u, enter[q]);
    took[q] = m[q] != 0;
    bulk[q] = __popc(m[q]) > kBulk;
    any_bulk |= bulk[q];
    all_fresh &= !bulk[q] || fresh[q];
    any |= m[q];
  }
  if (any == 0) return;
  if (any_bulk) {
    float bs[Q];
    int bi[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      bs[q] = bulk[q] && enter[q] ? cs[q] : -INFINITY;
      bi[q] = bulk[q] && enter[q] ? ci[q] : kNoId;
    }
    sort32<Q>(bs, bi, lane);
    if (!all_fresh) merge_sorted<Q>(ls, li, bs, bi, bulk, lane, k);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (bulk[q]) {
        if (all_fresh) {  // the sorted batch is the list
          ls[q] = bs[q];
          li[q] = bi[q];
        }
        m[q] = 0;
      }
    }
  }
  for (;;) {
    unsigned left = 0;
#pragma unroll
    for (int q = 0; q < Q; ++q) left |= m[q];
    if (left == 0) break;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int src = m[q] != 0 ? __ffs(m[q]) - 1 : 0;
      const float s = __shfl_sync(~0u, cs[q], src);
      const int i = __shfl_sync(~0u, ci[q], src);
      insert(ls[q], li[q], m[q] != 0 ? s : -INFINITY, m[q] != 0 ? i : kNoId, lane, k);
      m[q] &= m[q] - 1;
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    fresh[q] &= !took[q];
    ts[q] = __shfl_sync(~0u, ls[q], k - 1);
    ti[q] = __shfl_sync(~0u, li[q], k - 1);
  }
}

// -- the consumers -----------------------------------------------------------

// A consumer warp's walk over the tiles the producer sends, until the
// slot whose position is -1: score each tile, then offer its rows to the
// lists of the warp's four queries, side by side.  A row is a candidate
// when it passes the query's [ticker, doc_type] filter (-1 is the
// wildcard) and is live:
// below n_valid (kernel 1) or with a gid >= 0 (kernel 3, kIvf).  n is the
// codes' row length (Producer::tile).
// floor_s / floor_i, when given, are each query's floor at q * floor_ld:
// only rows ranking after it are candidates (a round past the first).
template <typename T, bool kIvf>
__device__ __forceinline__ void consume(const Smem& m, int nbox, int row_bytes, int stages,
                                        int B, int qb0, int n, int n_valid, int k,
                                        const int32_t* __restrict__ qf,
                                        const float* __restrict__ floor_s,
                                        const int32_t* __restrict__ floor_i, int floor_ld,
                                        int warp, int lane, float (&ls)[kQPW], int (&li)[kQPW]) {
  using Acc = typename Elem<T>::Acc;
  bool live[kQPW], fresh[kQPW];
  int tq[kQPW], dq[kQPW];
  float ts[kQPW], fs[kQPW];
  int ti[kQPW], fi[kQPW];
#pragma unroll
  for (int qq = 0; qq < kQPW; ++qq) {
    const int q = qb0 + warp * kQPW + qq;
    live[qq] = q < B;
    tq[qq] = live[qq] ? qf[2 * q] : 0;
    dq[qq] = live[qq] ? qf[2 * q + 1] : 0;
    fs[qq] = live[qq] && floor_s != nullptr ? floor_s[(size_t)q * floor_ld] : INFINITY;
    fi[qq] = live[qq] && floor_s != nullptr ? floor_i[(size_t)q * floor_ld] : INT_MIN;
    ls[qq] = ts[qq] = -INFINITY;
    li[qq] = ti[qq] = kNoId;
    fresh[qq] = true;
  }
  const uint32_t qs = smem_addr(m.q), ring = smem_addr(m.ring);
  mbar_wait(m.qbar, 0);
  int s = 0, ph = 0;
  for (int tile = 0;; ++tile) {
    const int slot = tile % kSlots;
    mbar_wait(&m.sfull[slot], (tile / kSlots) & 1);
    const unsigned char* sl = m.slots + slot * kSlotBytes;
    const int base = *reinterpret_cast<const volatile int*>(sl + kSlotBase);
    if (base < 0) break;
    Acc acc[2][4] = {};
    for (int b = 0; b < nbox; ++b) {
      mbar_wait(&m.full[s], ph);
      score_box<T>(acc, qs + b * kQBox, ring + s * kBox, min(4, (row_bytes - b * kBoxBytes) / 32),
                   warp, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&m.empty[s]);
      if (++s == stages) { s = 0; ph ^= 1; }
    }
    // two score buffers: a warp writes this one again only after every
    // warp has passed the next tile's barrier, so is done reading it
    float* sc = m.sc + (tile & 1) * kQB * kScStride;
    store_scores(sc, acc, warp, lane);
    named_barrier(1, kConsumers * 32);

    const int32_t* codes0 = reinterpret_cast<const int32_t*>(sl);
    const int32_t* codes1 = reinterpret_cast<const int32_t*>(sl + kSlotCodes1) + (n & 3);
    const int32_t* gids = reinterpret_cast<const int32_t*>(sl + kSlotGids);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      const int tc = codes0[r], dc = codes1[r], id = base + r;
      const bool row_ok = kIvf ? gids[r] >= 0 : id < n_valid;
      float cs[kQPW];
      int ci[kQPW];
      bool ok[kQPW], enter[kQPW];
#pragma unroll
      for (int qq = 0; qq < kQPW; ++qq) {
        cs[qq] = sc[(warp * kQPW + qq) * kScStride + r];
        ci[qq] = id;
        ok[qq] = live[qq] && row_ok && (tq[qq] == -1 || tq[qq] == tc) &&
                 (dq[qq] == -1 || dq[qq] == dc) && before(fs[qq], fi[qq], cs[qq], id);
      }
      offer<kQPW>(ls, li, ts, ti, fresh, cs, ci, ok, enter, lane, k);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&m.sempty[slot]);
  }
}

// the block's lists: entry j of block g's list for query q at
// ((q * k + j) * G + g) of the scratch
__device__ __forceinline__ void write_lists(const float (&ls)[kQPW], const int (&li)[kQPW], int B,
                                            int qb0, int k, float* __restrict__ part_s,
                                            int32_t* __restrict__ part_i, int warp, int lane) {
  const int g = blockIdx.x, G = gridDim.x;
#pragma unroll
  for (int qq = 0; qq < kQPW; ++qq) {
    const int q = qb0 + warp * kQPW + qq;
    if (q < B && lane < k) {
      const size_t at = ((size_t)q * k + lane) * G + g;
      part_s[at] = ls[qq];
      part_i[at] = li[qq];
    }
  }
}

// -- pass 2 --------------------------------------------------------------------

// One block a query: warp w merges the lists of blocks g = w + 4 (32 c +
// lane) in rounds, round j offering entry j of each list still in the
// running; the four warps' lists then merge pairwise through shared
// memory, and warp 0 writes the result, query q's entry j at q * ld + j.
// id_map (kernel 3), when not null, maps each winning id to the id
// written; empty slots are -inf / -1.  raw_i, when not null, receives the
// ids before the map (kNoId for an empty slot): the next round's floor.
__global__ void __launch_bounds__(kMergeWarps * 32)
merge_kernel(const float* __restrict__ part_s, const int32_t* __restrict__ part_i, int G, int k,
             const int32_t* __restrict__ id_map, float* __restrict__ out_s,
             int32_t* __restrict__ out_i, int ld, int32_t* __restrict__ raw_i) {
  __shared__ float ms[kMergeWarps][32];
  __shared__ int mi[kMergeWarps][32];
  const int q = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float ls[1] = {-INFINITY}, ts[1] = {-INFINITY};
  int li[1] = {kNoId}, ti[1] = {kNoId};
  bool fresh[1] = {true};
  const int mine = (G - warp + kMergeWarps - 1) / kMergeWarps;  // this warp's lists
  const int chunks = (mine + 31) / 32;
  unsigned alive = 0;  // bit c: list warp + 4 (32 c + lane) is still in the running
  for (int c = 0; c < chunks; ++c)
    if (32 * c + lane < mine) alive |= 1u << c;
  for (int j = 0; j < k && __any_sync(~0u, alive != 0); ++j) {
    const size_t row = ((size_t)q * k + j) * G + warp + kMergeWarps * lane;
    float cs[kMaxChunks][1];
    int ci[kMaxChunks][1];
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const bool on = (alive >> c) & 1;
      cs[c][0] = on ? __ldg(part_s + row + 32 * kMergeWarps * c) : -INFINITY;
      ci[c][0] = on ? __ldg(part_i + row + 32 * kMergeWarps * c) : kNoId;
    }
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c < chunks) {
        const bool ok[1] = {((alive >> c) & 1) != 0};
        bool enter[1];
        offer<1>(ls, li, ts, ti, fresh, cs[c], ci[c], ok, enter, lane, k);
        if (!enter[0]) alive &= ~(1u << c);
      }
    }
  }
  for (int half = kMergeWarps / 2; half > 0; half >>= 1) {
    if (warp >= half && warp < 2 * half) {
      ms[warp][lane] = lane < k ? ls[0] : -INFINITY;
      mi[warp][lane] = lane < k ? li[0] : kNoId;
    }
    __syncthreads();
    if (warp < half) {
      const float bs[1] = {ms[warp + half][lane]};
      const int bi[1] = {mi[warp + half][lane]};
      const bool take[1] = {true};
      merge_sorted<1>(ls, li, bs, bi, take, lane, k);
    }
    __syncthreads();
  }
  if (warp == 0 && lane < k) {
    const size_t at = (size_t)q * ld + lane;
    out_s[at] = ls[0];
    out_i[at] = ls[0] > -INFINITY ? (id_map != nullptr ? id_map[li[0]] : li[0]) : -1;
    if (raw_i != nullptr) raw_i[at] = li[0];
  }
}

// -- host ----------------------------------------------------------------------

// A map is a function of its arguments alone (address, extents, box), so
// a map encoded once serves every later tensor with the same ones: the
// last kMaps encoded are kept, and a corpus that moves (an upsert that
// grows the index) is only a new key.
constexpr int kMaps = 16;

struct MapKey {
  const void* ptr;
  long long extent;
  int row_bytes, box;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && extent == o.extent && row_bytes == o.row_bytes && box == o.box;
  }
};

template <typename Encode>
inline bool cached_map(CUtensorMap* map, const MapKey& key, Encode encode) {
  static std::mutex mu;
  static MapKey keys[kMaps];
  static CUtensorMap maps[kMaps];
  static int used = 0, next = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used; ++i) {
      if (keys[i] == key) {
        *map = maps[i];
        return true;
      }
    }
  }
  if (!encode(map)) return false;
  std::lock_guard<std::mutex> lock(mu);
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % kMaps;
  used = used < kMaps ? used + 1 : used;
  return true;
}

// rows of `row_bytes` bytes as a 2-D byte tensor map with boxes of 128
// bytes x `box_rows` rows and 128-byte swizzle
inline bool rows_map(CUtensorMap* map, const void* ptr, long long rows, int row_bytes,
                     int box_rows) {
  return cached_map(map, MapKey{ptr, rows, row_bytes, box_rows}, [&](CUtensorMap* m) {
    EncodeTiled encode = encode_tiled();
    const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
    const cuuint32_t box[2] = {(cuuint32_t)kBoxBytes, (cuuint32_t)box_rows};
    const cuuint32_t unit[2] = {1, 1};
    return encode != nullptr &&
           encode(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
                  unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  });
}

// n int32 values as a 1-D tensor map with boxes of `box_len`
inline bool ints_map(CUtensorMap* map, const void* ptr, long long n, int box_len) {
  return cached_map(map, MapKey{ptr, n, 4, box_len}, [&](CUtensorMap* m) {
    EncodeTiled encode = encode_tiled();
    const cuuint64_t dims[1] = {(cuuint64_t)n};
    const cuuint64_t strides[1] = {4};  // unused at rank 1
    const cuuint32_t box[1] = {(cuuint32_t)box_len};
    const cuuint32_t unit[1] = {1};
    return encode != nullptr &&
           encode(m, CU_TENSOR_MAP_DATA_TYPE_INT32, 1, const_cast<void*>(ptr), dims, strides, box,
                  unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  });
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace topk
