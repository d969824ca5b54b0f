// Segment-masked flash attention for BERT encoders, built for Hopper
// (sm_90a): the forward of the encoder's RAG_TPU_FLASH path.
//
// Replaces financial_rag_system_tpu/models/bert.py:160 _flash_attention,
// which calls jax's bundled TPU flash kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py: the pallas_call in
// _flash_attention_impl, the bodies _flash_attention_kernel_single_batch
// and _flash_attention_kernel_single_batch_single_step), and computes what
// it computes as bert.py configures it (128-key blocks, no bias, not
// causal, the key-padding mask as the segment ids of both q and kv):
//  - s = (q . k^T) of bf16 values summed in f32, times sm_scale; a key
//    whose segment id differs from the query's takes no weight (jax adds
//    its finite -0.7 * FLT_MAX, whose weight reaches the context as
//    exactly 0, see the liberties);
//  - S 128, jax's single-step kernel: p = exp(s - max), p / sum(p) rounded
//    to bf16, P.V summed in f32;
//  - S above 128: an online softmax over 128-key blocks, in jax's order:
//    m_next = max(m, rowmax(s)), p = exp(s - m_next), l_corr = exp(m -
//    m_next) * l, l_next = sum(p) + l_corr, inv = 1 / l_next (1 where
//    l_next is 0), acc = acc * (l_corr * inv) + (bf16(p) . V) * inv;
//  - every row, pad rows included (a pad row attends the pad keys only),
//    and the context rounded to bf16.
//
// Layout: q, k, v and the output are (B, S, H, D) bf16 as the encoder's
// projections give them (no transpose), D 32, 64, 128 or 256 (the wrapper
// zero-pads every other width up to 128 to the next of these); the segment
// ids (B, S) int32, any values; S a multiple of 128 up to 512.
//
// What bounds it on the H100, at the served shape (P 480 pairs, S 512,
// 12 heads of 32, the rerank mask padded to 512):
//  - bytes: q, k, v in and the context out, 755 MB of bf16: 0.226 ms at
//    3.35 TB/s;
//  - tensor cores: QK^T and P.V over every (query, key) pair, 4 P H S^2 D
//    = 1.9e11 FLOP: 0.196 ms at 989 TFLOP/s;
//  - exponentials, and the softmax's other per-score work (an FFMA, a
//    max, a sum, half a bf16 pack, the segment test where a block mixes
//    ids): P H S^2 = 1.5e9 scores, 0.41 ms of MUFU.EX2 alone at 16 a clock
//    an SM.  Over the (query, key) pairs that share a segment only, 0.19
//    ms.  This is the floor the design works against.
// What the design does about each:
//  - bytes: a persistent grid of one block an SM walks the P * H (pair,
//    head) items, item blockIdx.x + i * gridDim.x.  A producer warp (of a
//    warpgroup whose other warps exit) stages each item's K and V by TMA
//    (3-D (B, S, H * D) tensor maps, boxes of
//    128 keys at column head * D, 64- or 128-byte swizzle) into a ring of
//    128-key stages behind full and empty mbarriers, and each stage
//    serves a unit of the item's 64-row tiles, one tile to each consumer
//    warpgroup (3 at D 32, 2 at D 64 and 128): K and V come from device
//    memory once per item and from L2 once per unit (at D 32 and S 512
//    three times an item, against eight times, once a row tile, before).
//    The consumers' registers (setmaxnreg: 152 a thread at D 32, 232 at
//    D 64, 240 at D 128; the producer warpgroup 40, 24 at D 128) hold the
//    64 f32 scores of a 128-key block beside the context without spilling.
//    Each
//    warpgroup's q tiles come by TMA into two buffers, a tile ahead.  The
//    context is stored from registers.
//  - tensor cores: QK^T on wgmma m64n128k16 with q and the K block both
//    K-major in shared memory as TMA swizzles them.  P.V on mma.sync
//    m16n8k16, P straight from the QK^T accumulator (its 16-key steps are
//    mma.sync's A fragments) and V's B fragments by ldmatrix.trans from
//    the swizzled stage: kernel 2 measured this faster than a P.V wgmma at
//    d 32, and it needs no MN-major descriptor.  A 16-row warp's P.V runs
//    32 context columns at a time over the block's 128 keys into a fresh
//    accumulator, so the block's product is whole in f32 before it is
//    scaled and added, as jax adds it.
//  - exponentials: each is one FFMA (s sm_scale log2e - m sm_scale log2e,
//    the second term folded per row) and one MUFU.EX2 (ex2.approx); a
//    (tile, block) pair in which no query row shares a segment id with
//    any key is skipped whole (no QK^T, softmax or P.V; no load at all
//    when no tile of the unit needs the block).  The test is exact for any
//    int32 ids: the producer keeps a 32-bit presence mask of the ids in
//    [0, 32) of each 32 positions, and a tile or block holding any other
//    id skips nothing.  A block whose keys all carry one id needs no test
//    a score: a row attends all of it or none of it.
// Measured on the card (PERF.md, tools/flash_attention_variants.py): the
// kernel is bound by latency, not by one unit.  Cutting out the MUFU work,
// the segment test or P.V saves a tenth or so each; the warpgroups of a
// unit take each stage's QK^T, softmax and P.V at the same time, so the
// tensor cores, MUFU and the issue slots wait on each other.  Two consumer
// warpgroups ran slower than three; four (at 112 registers) spilled and
// ran slower.  Tried and dropped: skipping the 16-key steps of a block
// that none of a warp's rows attends (exact, a third of the served mask's
// scores against a tenth for whole blocks) ran slower, its branches
// cutting the softmax and P.V into blocks the scheduler cannot overlap;
// the row sums on the tensor core (P . 1, of the bf16 p) ran a little
// faster but doubled the difference from the plain version, to half the
// tolerance.
//
// Liberties against jax's arithmetic, all inside the kernel-vs-plain
// tolerance (atol 1e-2):
//  - exp is ex2.approx of one FFMA (a few f32 ulps);
//  - a masked key takes exactly zero weight (a select on the score, and a
//    row with no key of its segment in the block so far keeps m = -inf,
//    l = 0, acc = 0) in place of the additive mask value.  jax gives it
//    exactly zero weight too: exp(mask - m) = 0 once the row has a key of
//    its segment, and before that the l_corr = exp(mask - m) * l = 0
//    product wipes what the wholly masked blocks added.  Every row has
//    such a key (its own), so the contexts agree;
//  - a skipped (tile, block) pair leaves acc as it was, where jax scales it
//    by l_corr * inv = l * (1 / l): at most one f32 ulp a skipped block;
//  - the accumulator update is one FMA, S 128's p / sum(p) a product with
//    the reciprocal, and the f32 sums are taken in another order.
//
// D 256 keeps the kernel's first, simple design (flash_wide_kernel, at the end):
// its 128 f32 of context a thread beside the 64 of scores exceed what two
// consumer warpgroups may hold, and one 128-key stage of its K and V is
// 128 KB, which leaves no ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

constexpr int kKeys = 128;    // jax's block_k: a stage, and QK^T's wgmma N
constexpr int kRows = 64;     // query rows of a tile: one wgmma M
constexpr int kMaxS = 512;
constexpr int kMaxStages = 8;
constexpr size_t kSmemLimit = 232448;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kWg = D == 32 ? 3 : 2;          // consumer warpgroups
  static constexpr int kThreads = 128 * (kWg + 1);     // and a producer warpgroup
  // registers a thread after setmaxnreg, within the launch's pool
  static constexpr int kProducerRegs = D == 128 ? 24 : 40;
  static constexpr int kConsumerRegs = D == 32 ? 152 : D == 64 ? 232 : 240;
  static constexpr int kCw = D == 32 ? 32 : 64;  // values in a swizzled row of a column chunk
  static constexpr int kRowB = 2 * kCw;          // its bytes, the swizzle: 64 or 128
  static constexpr int kChunks = D / kCw;
  static constexpr int kQChunk = kRows * kRowB;  // bytes of a column chunk of a q tile
  static constexpr int kKChunk = kKeys * kRowB;  // of a K or V block
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKvBytes = kChunks * kKChunk;  // one of K, V in a stage
};

// setmaxnreg moves registers within the pool a block is given at launch:
// its threads times the count __launch_bounds__ leaves each (65,536 over
// the threads, in steps of 8).  A budget past the pool never returns.
template <int D>
constexpr bool regs_fit() {
  using C = Cfg<D>;
  return 128 * (C::kProducerRegs + C::kWg * C::kConsumerRegs) <=
         C::kThreads * (65536 / C::kThreads / 8 * 8);
}
static_assert(regs_fit<32>() && regs_fit<64>() && regs_fit<128>(),
              "the register budgets exceed the block's pool");

struct StageHead {
  uint32_t need;   // bit i: tile i of the unit attends this block
  int uniform;     // every key of the block carries the id `id`
  int id;
  int pad;        // ids 8-byte aligned for the consumers' int2 loads
  int ids[kKeys];  // the block's segment ids
};

// 1 KB to align the stages to the swizzle's atoms; per stage K, V, its
// head and its full and empty barriers; two q tiles and their barriers a
// consumer warpgroup
template <int D>
constexpr size_t smem_bytes(int stages) {
  using C = Cfg<D>;
  return 1024 + stages * (2 * (size_t)C::kKvBytes + sizeof(StageHead) + 2 * sizeof(uint64_t)) +
         C::kWg * 2 * ((size_t)C::kQBytes + sizeof(uint64_t));
}

// as many stages as fit, up to kMaxStages: 8 at D 32, 6 at D 64, 2 at D 128
template <int D>
constexpr int ring_stages() {
  int n = kMaxStages;
  while (n > 2 && smem_bytes<D>(n) > kSmemLimit) --n;
  return n;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int RowB>
__device__ __forceinline__ uint64_t desc(const void* p) {
  if constexpr (RowB == 64) return wgmma_desc_sw64(p);
  else return wgmma_desc_sw128(p);
}

// s = q K^T for one 128-key block (64 rows x 128 keys, f32), waited for:
// s[4j + 2h + e] is row 16 warp + g + 8h, key 8j + 2t + e
template <int D>
__device__ __forceinline__ void qk(float (&s)[64], const unsigned char* qs,
                                   const unsigned char* ks) {
  using C = Cfg<D>;
  // q's descriptors are the same for every block of a tile: left to
  // itself the compiler keeps all D / 16 of them live across the tile,
  // which heads of 128 cannot afford
  if constexpr (D == 128) {
    uintptr_t qa = reinterpret_cast<uintptr_t>(qs);
    asm volatile("" : "+l"(qa));
    qs = reinterpret_cast<const unsigned char*>(qa);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / (C::kCw / 16), o = (kk % (C::kCw / 16)) * 32;
    wgmma_ss(s, desc<C::kRowB>(qs + c * C::kQChunk + o), desc<C::kRowB>(ks + c * C::kKChunk + o),
             kk > 0 ? 1u : 0u);
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin(s);
}

// One consumer warp's 16 rows of one tile: the online-softmax state.
template <int D>
struct Rows {
  float acc[D / 8][4];  // context tile dn: rows g, g + 8, columns 8dn + 2t, + 1
  float m[2], l[2];     // running max (of the unscaled scores) and sum
  int seg[2];           // the rows' segment ids
};

// The warp's rows against one staged block: softmax and P.V into r.
// SINGLE: S 128, jax's single-step kernel.
template <int D, bool SINGLE>
__device__ __forceinline__ void attend(Rows<D>& r, float (&s)[64], const StageHead& h,
                                       const unsigned char* vs, float c2, int lane) {
  using C = Cfg<D>;
  const int t = lane & 3;
  // the segment test: none[h] when row h attends no key of the block
  bool none[2] = {false, false};
  if (h.uniform) {
    none[0] = r.seg[0] != h.id;
    none[1] = r.seg[1] != h.id;
  } else {
    const int* ids = h.ids + 2 * t;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      // at heads of 128, four ids' loads in flight, not all sixteen
      if constexpr (D == 128)
        if (j % 4 == 0) asm volatile("" ::: "memory");
      const int2 kid = *reinterpret_cast<const int2*>(ids + 8 * j);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        s[4 * j + 2 * hh] = kid.x == r.seg[hh] ? s[4 * j + 2 * hh] : -INFINITY;
        s[4 * j + 2 * hh + 1] = kid.y == r.seg[hh] ? s[4 * j + 2 * hh + 1] : -INFINITY;
      }
    }
  }
  float cr[2], nm[2], alpha[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // four chains a row, not one of 32 dependent FMNMX
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = fmaxf(s[4 * u + 2 * hh], s[4 * u + 2 * hh + 1]);
#pragma unroll
    for (int j = 4; j < kKeys / 8; ++j)
      x[j & 3] = fmaxf(x[j & 3], fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
    float mx = quad_max(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])));
    if (none[hh]) mx = -INFINITY;
    const float mn = fmaxf(r.m[hh], mx);
    const bool empty = mn == -INFINITY;  // no key of the row's segment yet
    alpha[hh] = empty ? 1.f : ex2((r.m[hh] - mn) * c2);
    // p = ex2(s c2 - mn c2); 0 for every key of a row that attends none
    cr[hh] = none[hh] ? 0.f : c2;
    nm[hh] = none[hh] ? -INFINITY : (empty ? 0.f : -mn * c2);
    r.m[hh] = mn;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1;
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], cr[hh], nm[hh]));
      ls[hh] += s[4 * j + e];
    }
  }
  float corr[2], inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    ls[hh] = quad_sum(ls[hh]);
    if constexpr (SINGLE) {  // p / l, then the product alone
      const float rl = 1.f / ls[hh];
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        s[4 * j + 2 * hh] *= rl;
        s[4 * j + 2 * hh + 1] *= rl;
      }
      corr[hh] = 0.f;
      inv[hh] = 1.f;
    } else {
      const float l_corr = alpha[hh] * r.l[hh];
      const float l_next = ls[hh] + l_corr;
      inv[hh] = l_next == 0.f ? 1.f : 1.f / l_next;
      corr[hh] = l_corr * inv[hh];
      r.l[hh] = l_next;
    }
  }
  uint32_t pa[kKeys / 16][4];  // P's A fragments, a 16-key step each
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);          // row g, keys 2t, 2t + 1
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);      // row g + 8
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);      // row g, keys 2t + 8, 2t + 9
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);      // row g + 8
  }
  // V's B fragments by ldmatrix.trans: lane's matrix mi = lane / 8 is keys
  // 8 (mi & 1) .. of the step, column granule (mi >> 1) of the 16 columns;
  // granule gi of key row k sits at gi ^ ((k >> 1) & 3) (64-byte swizzle)
  // or gi ^ (k & 7) (128-byte), the same for the lane's row in every step
  const int mi = lane >> 3;
  const int key = (lane & 7) + 8 * (mi & 1);
  const int swh = (C::kRowB == 64 ? (key >> 1) & 3 : key & 7) ^ (mi >> 1);
  const unsigned char* vrow = vs + key * C::kRowB;
#pragma unroll
  for (int c32 = 0; c32 < D / 32; ++c32) {  // context columns 32 c32 ..
    float pv[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // the step's even granule g0 of the row, in column chunk g0 / (kCw / 8);
        // the lane's is g0 + (mi >> 1), and (g0 + (mi >> 1)) ^ sw = g0 ^ swh
        const int g0 = 4 * c32 + 2 * half;
        const int chunk = g0 / (C::kCw / 8), gl = g0 % (C::kCw / 8);
        uint32_t vf[4];
        ldsm_x4_trans(vf, vrow + chunk * C::kKChunk + 16 * kk * C::kRowB + ((gl ^ swh) << 4));
        mma_bf16(pv[2 * half], pa[kk], vf[0], vf[1]);
        mma_bf16(pv[2 * half + 1], pa[kk], vf[2], vf[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& a = r.acc[4 * c32 + n][e];
        a = fmaf(pv[n][e], inv[e >> 1], a * corr[e >> 1]);
      }
    }
  }
}

// The producer warp: for each unit (an item's row tiles, one a consumer
// warpgroup) and each 128-key block, the block's segment ids, which of the
// unit's tiles attend it, and its K and V by TMA where any does.
template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        const int32_t* __restrict__ seg, unsigned char* kv,
                                        StageHead* head, uint64_t* full, uint64_t* empty,
                                        int n_items, int S, int H, int nst, int lane) {
  using C = Cfg<D>;
  constexpr uint32_t kAll = 0xffffffffu;
  const int T = S / kRows, nb = S / kKeys;
  int n = 0;  // stages filled
  for (int i = 0; i < n_items; ++i) {
    const int item = blockIdx.x + i * gridDim.x;
    const int pair = item / H, hd = item - pair * H;
    const int32_t* srow = seg + (size_t)pair * S;
    // lane j: the ids in [0, 32) of positions 32j .. 32j + 31 as bits, and
    // whether they hold any other id
    uint32_t gp = 0, go = 0;
    constexpr int kBatch = C::kProducerRegs >= 40 ? kMaxS / 32 : 4;  // loads in flight
#pragma unroll
    for (int j0 = 0; j0 < kMaxS / 32; j0 += kBatch) {
      int v[kBatch];  // this lane's ids: position lane + 32j
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj)
        v[jj] = j0 + jj < S / 32 ? srow[lane + 32 * (j0 + jj)] : 0;
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        if (j0 + jj >= S / 32) break;
        const uint32_t p = __reduce_or_sync(kAll, (unsigned)v[jj] < 32u ? 1u << v[jj] : 0u);
        const uint32_t o = __any_sync(kAll, (unsigned)v[jj] >= 32u);
        if (lane == j0 + jj) gp = p, go = o;
      }
    }
    for (int t0 = 0; t0 < T; t0 += C::kWg) {  // a unit: tiles t0 .. t0 + kWg - 1
      for (int kb = 0; kb < nb; ++kb) {
        // the block: its ids (lane's keys lane + 32u), their presence bits,
        // any other id, whether one id fills it
        int x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] = srow[kb * kKeys + lane + 32 * u];
        const int lo = __reduce_min_sync(kAll, min(min(x[0], x[1]), min(x[2], x[3])));
        const int hi = __reduce_max_sync(kAll, max(max(x[0], x[1]), max(x[2], x[3])));
        uint32_t bp = 0, bo = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          bp |= __shfl_sync(kAll, gp, 4 * kb + u);
          bo |= __shfl_sync(kAll, go, 4 * kb + u);
        }
        uint32_t need = 0;
#pragma unroll
        for (int w = 0; w < C::kWg; ++w) {
          const int tt = min(t0 + w, T - 1);
          const uint32_t tp = __shfl_sync(kAll, gp, 2 * tt) | __shfl_sync(kAll, gp, 2 * tt + 1);
          const uint32_t to = __shfl_sync(kAll, go, 2 * tt) | __shfl_sync(kAll, go, 2 * tt + 1);
          if (t0 + w < T && (to || bo || (tp & bp))) need |= 1u << w;
        }
        const int s = n % nst;
        mbar_wait(&empty[s], ((n / nst) & 1) ^ 1);  // the first round passes
        StageHead& h = head[s];
#pragma unroll
        for (int u = 0; u < 4; ++u) h.ids[lane + 32 * u] = x[u];
        if (lane == 0) {
          h.need = need;
          h.uniform = lo == hi;
          h.id = lo;
        }
        if (lane == 0 && need) {
          mbar_arrive_expect_tx(&full[s], 2 * C::kKvBytes);
          unsigned char* ks = kv + (size_t)s * 2 * C::kKvBytes;
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c) {
            tma_load_3d(ks + c * C::kKChunk, kmap, &full[s], hd * D + c * C::kCw, kb * kKeys, pair);
            tma_load_3d(ks + C::kKvBytes + c * C::kKChunk, vmap, &full[s], hd * D + c * C::kCw,
                        kb * kKeys, pair);
          }
        } else {
          mbar_arrive(&full[s]);
        }
        ++n;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, const int32_t* __restrict__ seg,
             __nv_bfloat16* __restrict__ out, int P, int S, int H, float scale, int nst) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kv = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qtiles = kv + (size_t)nst * 2 * C::kKvBytes;  // [kWg][2][kQBytes]
  StageHead* head = reinterpret_cast<StageHead*>(qtiles + C::kWg * 2 * C::kQBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(head + nst);
  uint64_t* empty = full + nst;
  uint64_t* qfull = empty + nst;  // [kWg][2]

  const int items = P * H;
  const int n_items = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int T = S / kRows, nb = S / kKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 32);             // every producer lane, after its head writes
      mbar_init(&empty[s], 4 * C::kWg);    // every consumer warp, when done with the block
    }
    for (int b = 0; b < 2 * C::kWg; ++b) mbar_init(&qfull[b], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * C::kWg) {  // the producer warpgroup: one warp works
    setmaxnreg_dec<C::kProducerRegs>();
    if (warp == 4 * C::kWg)
      produce<D>(&kmap, &vmap, seg, kv, head, full, empty, n_items, S, H, nst, lane);
    return;
  }
  setmaxnreg_inc<C::kConsumerRegs>();

  // Consumer warpgroup wg takes the tile positions wg, wg + kWg, ... of the
  // block's items' row tiles laid end to end: one in each unit, whose
  // stages it works through in lockstep with the others; it passes through
  // the stages of a unit where it has no tile.  One thread of it loads each
  // tile's q by TMA into one of its two q buffers, a tile ahead.
  const int wg = warp >> 2, wl = warp & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  unsigned char* my_q = qtiles + wg * 2 * C::kQBytes;
  uint64_t* my_qfull = qfull + 2 * wg;
  const int positions = n_items * T;
  auto load_q = [&](int pos, int b) {
    const int item = blockIdx.x + (pos / T) * gridDim.x;
    const int pair = item / H, hd = item - pair * H;
    mbar_arrive_expect_tx(&my_qfull[b], C::kQBytes);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      tma_load_3d(my_q + b * C::kQBytes + c * C::kQChunk, &qmap, &my_qfull[b],
                  hd * D + c * C::kCw, (pos % T) * kRows, pair);
  };
  const size_t tok = (size_t)H * D;  // stride of one token
  const float c2 = scale * kLog2e;
  const bool single = nb == 1;
  int pos = wg, k = 0, n = 0;  // k: tiles this warpgroup has taken; n: stages passed
  if (leader && pos < positions) load_q(pos, 0);
  for (int i = 0; i < n_items; ++i) {
    const int item = blockIdx.x + i * gridDim.x;
    const int pair = item / H;
    const size_t base = (size_t)pair * S * tok + (size_t)(item - pair * H) * D;
    for (int t0 = 0; t0 < T; t0 += C::kWg) {
      const int upos = i * T + t0;
      const bool has = pos < upos + min(C::kWg, T - t0);
      const int mine = pos - upos;  // the tile's index in the unit
      const int ra = (has ? (pos - i * T) * kRows : 0) + 16 * wl + (lane >> 2), rb = ra + 8;
      const unsigned char* qs = my_q + (k & 1) * C::kQBytes;
      Rows<D> r;
      if (has) {
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) r.acc[dn][0] = r.acc[dn][1] = r.acc[dn][2] = r.acc[dn][3] = 0.f;
        r.m[0] = r.m[1] = -INFINITY;
        r.l[0] = r.l[1] = 0.f;
        r.seg[0] = seg[(size_t)pair * S + ra];
        r.seg[1] = seg[(size_t)pair * S + rb];
        // every warp is past the last tile's wgmmas, which read the other buffer
        named_barrier(1 + wg, 128);
        if (leader && pos + C::kWg < positions) load_q(pos + C::kWg, (k + 1) & 1);
        mbar_wait(&my_qfull[k & 1], (k >> 1) & 1);
      }
      for (int kb = 0; kb < nb; ++kb) {
        const int s = n % nst;
        mbar_wait(&full[s], (n / nst) & 1);
        if (has) {
          const StageHead& h = head[s];
          const bool need = (h.need >> mine) & 1u;
          const unsigned char* ks = kv + (size_t)s * 2 * C::kKvBytes;
          if (need) {
            float sc[64];
            qk<D>(sc, qs, ks);
            if (single)
              attend<D, true>(r, sc, h, ks + C::kKvBytes, c2, lane);
            else
              attend<D, false>(r, sc, h, ks + C::kKvBytes, c2, lane);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
        ++n;
      }
      if (has) {
        const int t = lane & 3;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const int col = 8 * dn + 2 * t;
          *reinterpret_cast<uint32_t*>(out + base + (size_t)ra * tok + col) =
              pack_bf16(r.acc[dn][0], r.acc[dn][1]);
          *reinterpret_cast<uint32_t*>(out + base + (size_t)rb * tok + col) =
              pack_bf16(r.acc[dn][2], r.acc[dn][3]);
        }
        pos += C::kWg;
        ++k;
      }
    }
  }
}

// (B, S, H * D) bf16 as a 3-D tensor map with boxes of `cw` values x
// `rows` tokens of one pair, swizzled by the box's row bytes; false if
// cuTensorMapEncodeTiled refuses it
bool tile_map(CUtensorMap* map, const void* ptr, int P, int S, int H, int D, int cw, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)H * D, (cuuint64_t)S, (cuuint64_t)P};
  const cuuint64_t strides[2] = {(cuuint64_t)H * D * 2, (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cw, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                cw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* seg, void* out, int P, int S,
           int H, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap qmap, kmap, vmap;
  if (!tile_map(&qmap, q, P, S, H, D, C::kCw, kRows) ||
      !tile_map(&kmap, k, P, S, H, D, C::kCw, kKeys) ||
      !tile_map(&vmap, v, P, S, H, D, C::kCw, kKeys))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  constexpr int nst = ring_stages<D>();
  constexpr size_t smem = smem_bytes<D>(nst);
  static_assert(smem <= kSmemLimit, "the ring does not fit");
  // SMs of each device, 0 until a launch there has raised the kernel's
  // shared-memory limit; host threads may launch at once (the server's
  // batches run in worker threads), and each may do that first step
  static std::atomic<int> sms[64];
  int n_sm = sms[dev & 63].load(std::memory_order_acquire);
  if (n_sm == 0) {
    err = cudaFuncSetAttribute(flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms[dev & 63].store(n_sm, std::memory_order_release);
  }
  const int ctas = P * H < n_sm ? P * H : n_sm;  // one block an SM
  flash_kernel<D><<<ctas, C::kThreads, smem, stream>>>(qmap, kmap, vmap, (const int32_t*)seg,
                                                       (__nv_bfloat16*)out, P, S, H, scale, nst);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// D 256: the kernel's first, simple design.  One block of four warps takes one
// 64-row tile of one (pair, head); the grid is every (pair, head, row
// tile).  The block stages its q tile once, then for each 128-key block
// the keys' K and V rows and segment ids, in shared memory with 16-byte
// loads (rows padded by 16 bytes, so ldmatrix reads them without bank
// conflicts).  Each warp owns 16 query rows: QK^T on mma.sync m16n8k16,
// the softmax on the f32 accumulator in registers with jax's additive
// mask value -0.7 * FLT_MAX, the accurate expf and each product and sum
// rounded on its own, and P.V on mma.sync with P straight from that
// accumulator and V's B fragments by ldmatrix.trans.  It reads K and V
// once per row tile, waits for each block's loads and computes every key.

constexpr int kWideWarps = 4;
constexpr int kWideRows = 16 * kWideWarps;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideD = 256;
constexpr float kMaskValue = (float)(-0.7 * (double)FLT_MAX);  // jax's DEFAULT_MASK_VALUE

static_assert(kWideThreads == kKeys, "one thread stages each key's segment id");

struct Wide {
  static constexpr int kStride = kWideD * 2 + 16;  // bytes of a staged row
  static constexpr int kNt = kWideD / 8;           // 8-wide column tiles of the context
  static constexpr int kGran = kWideD / 8;         // 16-byte granules of a row
  static constexpr size_t kSmem = (size_t)(kWideRows + 2 * kKeys) * kStride + kKeys * sizeof(int);
};

// rows [row0, row0 + n) of one (pair, head) of x into shared memory
__device__ __forceinline__ void stage_rows(unsigned char* dst, const __nv_bfloat16* __restrict__ x,
                                           size_t base, size_t tok, int row0, int n) {
  for (int i = threadIdx.x; i < n * Wide::kGran; i += kWideThreads) {
    const int r = i / Wide::kGran, gi = i - r * Wide::kGran;
    *reinterpret_cast<uint4*>(dst + r * Wide::kStride + gi * 16) =
        *reinterpret_cast<const uint4*>(x + base + (size_t)(row0 + r) * tok + gi * 8);
  }
}

__global__ void __launch_bounds__(kWideThreads)
flash_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ seg,
                  __nv_bfloat16* __restrict__ out, int S, int H, float scale) {
  using F = Wide;
  constexpr int D = kWideD;
  extern __shared__ __align__(16) unsigned char flash_smem[];
  unsigned char* qs = flash_smem;
  unsigned char* ks = qs + kWideRows * F::kStride;
  unsigned char* vs = ks + kKeys * F::kStride;
  int* segk = reinterpret_cast<int*>(vs + kKeys * F::kStride);

  const int T = S / kWideRows;
  const int tile = blockIdx.x % T, item = blockIdx.x / T;
  const int pair = item / H, hd = item - pair * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t tok = (size_t)H * D;
  const size_t base = (size_t)pair * S * tok + (size_t)hd * D;
  const int32_t* srow = seg + (size_t)pair * S;

  stage_rows(qs, q, base, tok, tile * kWideRows, kWideRows);
  const int ra = tile * kWideRows + 16 * warp + g, rb = ra + 8;  // this thread's two rows
  const int seg_a = srow[ra], seg_b = srow[rb];
  // ldmatrix row addresses: q's A fragments (matrix i = lane / 8: rows 8 (i
  // & 1) .., columns 8 (i >> 1) ..); K's B fragments (lanes 0-7 a key's
  // first 8 values of a 16-value step, lanes 8-15 its second 8); V's
  // transposed B fragments (matrix i: keys 8 (i & 1) .., columns 8 (i >> 1) ..)
  const int mi = lane >> 3;
  const unsigned char* qrow = qs + (16 * warp + (lane & 7) + 8 * (mi & 1)) * F::kStride + (mi >> 1) * 16;
  const unsigned char* krow = ks + (lane & 7) * F::kStride + (mi & 1) * 16;
  const unsigned char* vrow = vs + ((lane & 7) + 8 * (mi & 1)) * F::kStride + (mi >> 1) * 16;

  const bool single = S == kKeys;  // jax's single-step kernel
  float o[F::kNt][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kb = 0; kb < S / kKeys; ++kb) {
    __syncthreads();  // every warp is done with the last block
    stage_rows(ks, k, base, tok, kb * kKeys, kKeys);
    stage_rows(vs, v, base, tok, kb * kKeys, kKeys);
    segk[threadIdx.x] = srow[kb * kKeys + threadIdx.x];
    __syncthreads();

    // s: row g keys 8j + 2t, 8j + 2t + 1 in s[j][0..1], row g + 8 in s[j][2..3]
    float s[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int k16 = 0; k16 < D / 16; ++k16) {
      uint32_t qa[4];
      ldsm_x4(qa, qrow + k16 * 32);
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        uint32_t b0, b1;
        ldsm_x2(b0, b1, krow + 8 * j * F::kStride + k16 * 32);
        mma_bf16(s[j], qa, b0, b1);
      }
    }
    float mc[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const int s0 = segk[8 * j + 2 * t], s1 = segk[8 * j + 2 * t + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sq = e < 2 ? seg_a : seg_b;
        const int sk = e & 1 ? s1 : s0;
        s[j][e] = __fadd_rn(__fmul_rn(s[j][e], scale), sq == sk ? 0.f : kMaskValue);
        mc[e >> 1] = fmaxf(mc[e >> 1], s[j][e]);
      }
    }
    float corr[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_next = fmaxf(m[r], quad_max(mc[r]));
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        s[j][2 * r] = expf(s[j][2 * r] - m_next);
        s[j][2 * r + 1] = expf(s[j][2 * r + 1] - m_next);
        ls += s[j][2 * r] + s[j][2 * r + 1];
      }
      ls = quad_sum(ls);
      if (single) {  // p / l, then the product alone
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          s[j][2 * r] = __fdiv_rn(s[j][2 * r], ls);
          s[j][2 * r + 1] = __fdiv_rn(s[j][2 * r + 1], ls);
        }
        corr[r] = 0.f;
        inv[r] = 1.f;
      } else {
        const float l_corr = __fmul_rn(expf(m[r] - m_next), l[r]);
        const float l_next = __fadd_rn(ls, l_corr);
        inv[r] = l_next == 0.f ? 1.f : __fdiv_rn(1.f, l_next);
        corr[r] = __fmul_rn(l_corr, inv[r]);
        m[r] = m_next;
        l[r] = l_next;
      }
    }
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int half = 0; half < F::kNt / 2; ++half) {  // context columns 16 half ..
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vrow + 16 * kk * F::kStride + half * 32);
        mma_bf16(c0, pa[kk], vf[0], vf[1]);
        mma_bf16(c1, pa[kk], vf[2], vf[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        o[2 * half][e] = __fadd_rn(__fmul_rn(o[2 * half][e], corr[r]), __fmul_rn(c0[e], inv[r]));
        o[2 * half + 1][e] =
            __fadd_rn(__fmul_rn(o[2 * half + 1][e], corr[r]), __fmul_rn(c1[e], inv[r]));
      }
    }
  }
#pragma unroll
  for (int dn = 0; dn < F::kNt; ++dn) {
    const int col = 8 * dn + 2 * t;
    *reinterpret_cast<uint32_t*>(out + base + (size_t)ra * tok + col) = pack_bf16(o[dn][0], o[dn][1]);
    *reinterpret_cast<uint32_t*>(out + base + (size_t)rb * tok + col) = pack_bf16(o[dn][2], o[dn][3]);
  }
}

int launch_wide(const void* q, const void* k, const void* v, const void* seg, void* out, int B,
                int S, int H, float scale, cudaStream_t stream) {
  const long long blocks = (long long)B * H * (S / kWideRows);
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // whether this device has raised the kernel's shared-memory limit
  static std::atomic<bool> raised[64];
  if (!raised[dev & 63].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(flash_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Wide::kSmem);
    if (err != cudaSuccess) return (int)err;
    raised[dev & 63].store(true, std::memory_order_release);
  }
  flash_wide_kernel<<<(unsigned)blocks, kWideThreads, Wide::kSmem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int32_t*)seg, (__nv_bfloat16*)out, S, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v and out (B, S, H, head_dim) bf16, 16-byte aligned; seg (B, S)
// int32; head_dim 32, 64, 128 or 256; S a multiple of 128 up to 512.
// Returns a cudaError_t: 1 (cudaErrorInvalidValue) for shapes the kernel
// does not take, else the launch's own status.
extern "C" int flash_attention(const void* q, const void* k, const void* v, const void* seg,
                               void* out, int B, int S, int H, int head_dim, float scale,
                               void* stream) {
  if (S < kKeys || S > kMaxS || S % kKeys != 0 || B < 1 || H < 1 ||
      (long long)B * H > INT32_MAX ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (head_dim) {
    case 32: return launch<32>(q, k, v, seg, out, B, S, H, scale, st);
    case 64: return launch<64>(q, k, v, seg, out, B, S, H, scale, st);
    case 128: return launch<128>(q, k, v, seg, out, B, S, H, scale, st);
    case 256: return launch_wide(q, k, v, seg, out, B, S, H, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
