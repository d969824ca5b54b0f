// The backward of kernel 7 (segment-masked flash attention), built for
// Hopper (sm_90a): the gradients of the encoder's RAG_TPU_FLASH path in a
// graded forward (ops/flash_attention.py, the autograd function
// _FlashAttention).
//
// Replaces jax's two backward kernels of its bundled TPU flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py), which the VJP of
// financial_rag_system_tpu/models/bert.py:160 _flash_attention reaches:
//  - _flash_attention_bwd_dkv (:941, pallas_call :1121, body
//    _flash_attention_dkv_kernel :796): dK and dV, per (pair, head) and
//    key block, over every q block;
//  - _flash_attention_bwd_dq (:1287, pallas_call :1456, body
//    _flash_attention_dq_kernel :1146): dQ, per q block over every key
//    block.  Its second output, dS as the gradient of the bias `ab`, is
//    not computed: bert.py passes no bias.
// Both recompute, for each (query, key) pair, jax's arithmetic:
//  - s = sm_scale (bf16 q . bf16 k summed in f32); a key whose segment id
//    differs from the query's takes p = 0 (jax adds its finite -0.7 *
//    FLT_MAX, and exp(s + mask - m) is exactly 0: the same value);
//  - p = exp(s - m) (1 / l), m and l the forward's saved residuals
//    (flash_attention.cu, flash_attention_res);
//  - dV += bf16(p)^T . dO;  dP = dO . V^T;  dS = (dP - di) p sm_scale;
//    dK += bf16(dS)^T . q;  dQ += bf16(dS) . K; every product sums in f32,
//    and dQ, dK and dV are stored as bf16, the dtype of q.
//  di = rowsum(f32(o) f32(dO)) comes in from the wrapper: jax computes it
//  in XLA outside its kernels (flash_attention.py:272-275), the port in
//  torch.
//
// Layout: q, k, v, dO and the gradients (B, S, H, D) bf16 as the forward
// takes them (no transpose); the segment ids (B, S) int32; m, l and di
// (B, H, S) f32; D 32 or a multiple of 64 (the forward's widths: 32, 64,
// 128, 256 and every multiple of 128 from 384; the wrapper pads others as
// the forward pads them); S a multiple of 128.
//
// What bounds it on the H100, at the cross-encoder trainer's shape (B 32,
// S 512, 12 heads of 32), over every (query, key) pair:
//  - dK/dV: 8 S^2 D operations an item (QK^T, dP, dV, dK), 2.6e10: 0.026
//    ms at 989 TFLOP/s; q, k, v, dO in, dK and dV out and m, l, di, 78 MB:
//    0.023 ms at 3.35 TB/s;
//  - dQ: 6 S^2 D (QK^T, dP, dQ), 1.9e10: 0.020 ms; 65 MB: 0.019 ms;
//  - each recomputes 1.0e8 exponentials: 0.03 ms of MUFU.EX2.
// At the wide trainer's B 32, S 512 and 3 heads of 256 (H D 768 again) the
// bytes are the same, 151 MB (0.045 ms) and 126 MB (0.038 ms), the dense
// products 5.2e10 (0.052 ms) and 3.9e10, and the exponentials a quarter.
// At a (64-row tile, 64-row block) step of D 32 each product is 0.26
// MFLOP, so what a step waits on (a load's latency, a product's) is what
// sets the time.  Heads of 32 and 64 run unit::walk_kernel<D, DKV>:
//  - persistent blocks, one an SM, each taking units of U own row tiles
//    of one (pair, head) item (64 keys a tile for dK/dV, 64 queries for
//    dQ; U = 4 at D 32, 2 at D 64, Cfg::kUnit); an item's units dealt round
//    the blocks in order (unit w to block w mod grid), so the units of one
//    item run at once on neighbouring SMs and share its walked side in L2;
//  - a producer warpgroup (setmaxnreg 32; its four warps take every fourth
//    block, so their loads of the rows' values wait at once) walks the
//    item's blocks of the other side once a unit and stages each by TMA
//    (64- or 128-byte swizzle) into a ring with full / empty mbarriers:
//    blocks of 32 rows in sixteen stages for dK/dV at D 32 (64 rows spilled
//    four warpgroups' registers), of 64 rows in eight otherwise;
//    q and dO with their rows' m log2e, 1 / l, di and segment ids (each
//    computed once, when the row is staged) for dK/dV; K and V with their
//    segment ids for dQ; a block that no tile of the unit shares a
//    segment id with is not loaded (the forward's presence masks);
//  - U consumer warpgroups (setmaxnreg within the launch's pool: 112
//    registers at U 4, 232 at 2), one own tile each, its two tiles (K and V, or q and
//    dO) loaded by TMA a unit ahead into one of two buffers; each stage
//    serves all U tiles, so a walked block crosses L2 -> shared once a
//    unit and not once a tile;
//  - per (tile, block): S (S^T for dK/dV) and dP (dP^T) on wgmma m64n32k16
//    or m64n64k16 with both operands in shared memory; p and dS made in the
//    accumulators' registers, whose layout is the next wgmma's A fragment;
//    dV += bf16(p^T) . dO and dK += bf16(dS^T) . q (or dQ += bf16(dS) . K)
//    on wgmma with A from registers and the stage's row-major block as an
//    MN-major B (N = D); the gradients stay in registers for the walk and
//    are stored as bf16 once.  No atomics and nothing summed across
//    blocks: two runs give the same bits.
// Heads of 128 and every wider multiple of 64 run wide::wide_kernel<W,
// DKV>, where a tile's products over the whole head (QK^T and dP: 4 S^2 D
// of the 8 S^2 D) would not fit one warpgroup's registers beside its
// gradients (64 rows x D f32, twice for dK/dV):
//  - persistent clusters of two blocks, one block an SM, each cluster
//    taking units of two own 64-row tiles (one a block) and one column
//    group of their gradients (up to 256 columns for dK/dV, 512 for dQ:
//    one group at heads of 128 and 256, two for dK/dV at 384 and 512), an
//    item's units dealt round the clusters in order;
//  - a producer warp (of a producer warpgroup) stages each walked block of
//    W rows (64 up to heads of
//    256, 32 up to 384 and above 512, 16 at 448 and 512) by TMA over the
//    whole head, 64-column chunks with 128-byte swizzle, into a ring of up
//    to four stages, with each walked row's values written once beside it;
//    each block of the cluster loads half the block's chunks for both
//    (TMA multicast), so a walked block is read from L2 once for two tiles;
//    a consumer thread loads the unit's own tile (both tensors, the whole
//    head) once a unit, when both warpgroups are done with the last
//    unit's.  Above heads of 512 the own tile does not
//    fit beside a stage: a stage then holds a window of four chunks of the
//    own tile and of the walked block, the windows walked in turn with the
//    unit's own group's window last, so that its walked chunks serve the
//    gradient products;
//  - two consumer warpgroups (224 registers a thread after setmaxnreg,
//    the producer warpgroup's 56) compute S^T and dP^T
//    (S and dP for dQ) once a (tile, block) over the whole head on wgmma
//    m64nXk16, each over half the walked rows (N = W / 2), so nothing is
//    computed twice; p and dS are made in the accumulators and written to
//    shared memory as bf16, and each warpgroup
//    takes its chunks of the group (every other one) of dV += bf16(p^T) .
//    dO and dK += bf16(dS^T) . q, or dQ += bf16(dS) . K, on wgmma with A
//    from shared memory (wgmma's core matrices, unswizzled) and the walked
//    chunk as an MN-major B; two named barriers a step keep p and dS whole
//    while they are read (a software pipeline, block ob + 1's S and dP
//    issued before block ob's gradient products, measured slower: the
//    variants tool).
//  The work is the function's own at heads of 128 and 256, and S and dP
//  twice for dK/dV at 384 and 512 (two column groups); the gradients stay
//  in registers for the walk and are stored as bf16 once.
// Both skip a (tile, block) pair whose rows share no segment id (every p
// is 0, so it adds exactly 0), by the forward's presence masks of the ids
// in [0, 32) (any other id sets every bit).
// Liberties against jax's arithmetic, inside the tolerance the tests hold
// the kernels to (2^-7 of a gradient's largest value): exp as ex2.approx of
// one FFMA (s sm_scale log2e - m log2e), the zero select in place of the
// additive mask, and the f32 sums in another order (jax adds 128-row
// blocks in turn; here blocks of 16-64 rows, and chunks of the head: the
// windows' in turn above heads of 512).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The skip rule's view of 64 segment ids (lane's ids x, x2): bit i when
// some row holds id i in [0, 32), every bit when some row holds any other
// id (flash_attention.cu's presence)
__device__ __forceinline__ uint32_t presence(int x, int x2) {
  constexpr uint32_t kAll = 0xffffffffu;
  const bool other = (unsigned)x >= 32u || (unsigned)x2 >= 32u;
  uint32_t bits = ((unsigned)x < 32u ? 1u << x : 0u) | ((unsigned)x2 < 32u ? 1u << x2 : 0u);
  return __any_sync(kAll, other) ? ~0u : __reduce_or_sync(kAll, bits);
}

// ---------------------------------------------------------------------------
// Heads of 32 and 64 (unit::walk_kernel<D, DKV>): persistent blocks, a TMA
// ring of walked blocks serving units of own row tiles, every product on
// wgmma (see the file's header).

namespace unit {

constexpr int kRows = 64;      // an own tile's rows: one wgmma M
constexpr int kProducers = 4;  // warps of the producer warpgroup, each a fourth of the blocks
constexpr size_t kSmemLimit = 232448;

template <int D, bool DKV>
struct Cfg {
  static_assert(D == 32 || D == 64, "heads of 32 and 64");
  // own row tiles a unit: one a consumer warpgroup
  static constexpr int kUnit = D == 32 ? 4 : 2;
  // a walked block's rows, S's and dP's N and the gradient products' K:
  // at D 32 dK/dV takes 32 (half the scores a thread: four warpgroups fit
  // their registers), dQ 64
  static constexpr int kWalk = D == 32 && DKV ? 32 : 64;
  // ring stages at most: eight 64-row blocks ahead
  static constexpr int kMaxStages = 8 * 64 / kWalk;
  static constexpr int kThreads = 128 * (kUnit + 1);  // and a producer warpgroup
  // registers a thread after setmaxnreg (the producer holds its rows' m,
  // l and di across the wait: at 24 it spilled)
  static constexpr int kProducerRegs = 32;
  // the consumers' share of the launch's pool (its threads times 65,536 /
  // threads in steps of 8), in steps of 8, at most 240
  static constexpr int kPool = kThreads * (65536 / kThreads / 8 * 8);
  static constexpr int kConsumerRegs =
      (kPool / 128 - kProducerRegs) / kUnit / 8 * 8 < 240
          ? (kPool / 128 - kProducerRegs) / kUnit / 8 * 8
          : 240;
  static constexpr int kRowB = 2 * D;               // a row's bytes, the swizzle: 64 or 128
  static constexpr int kTileB = kRows * kRowB;      // an own tile of q, dO, K or V: 64 rows x D
  static constexpr int kWalkB = kWalk * kRowB;      // a walked block's q, dO, K or V
  static constexpr int kStageB = 2 * kWalkB;        // a walked block: (q, dO) or (K, V)
};
template <int D, bool DKV>
constexpr bool regs_fit() {
  using C = Cfg<D, DKV>;
  return 128 * (C::kProducerRegs + C::kUnit * C::kConsumerRegs) <= C::kPool;
}
static_assert(regs_fit<32, true>() && regs_fit<32, false>() && regs_fit<64, true>() &&
                  regs_fit<64, false>(),
              "the register budgets exceed the block's pool");

// A stage's head: which of the unit's tiles share an id with the block,
// and its rows' values as the consumers read them: for dK/dV (the walked
// rows are queries) each row's m log2e, 1 / l, di and segment id (bits),
// for dQ (keys) each row's segment id
template <int W>
struct Head {
  uint32_t need;  // bit w: tile w of the unit shares a segment id with the block
  int pad[3];
  int ids[W];
  float4 rows[W];
};

// 1 KB to align the stages to the swizzle's atoms; per stage its walked
// block, its head and its full and empty barriers; a consumer warpgroup's
// own tiles, two buffers of two, and a barrier a buffer
// (ops/flash_attention.py bwd_plan mirrors this)
template <int D, bool DKV>
constexpr size_t smem_bytes(int stages) {
  using C = Cfg<D, DKV>;
  return 1024 + stages * ((size_t)C::kStageB + sizeof(Head<C::kWalk>) + 2 * sizeof(uint64_t)) +
         C::kUnit * 2 * (2 * (size_t)C::kTileB + sizeof(uint64_t));
}

template <int D, bool DKV>
constexpr int ring_stages() {
  int n = Cfg<D, DKV>::kMaxStages;
  while (n > 2 && smem_bytes<D, DKV>(n) > kSmemLimit) --n;
  return n;
}

// the stages as a constant the device code may read
template <int D, bool DKV>
struct Ring {
  static constexpr int kStages = ring_stages<D, DKV>();
};
static_assert(sizeof(Head<64>) == 1296 && sizeof(Head<32>) == 656 &&
                  Cfg<32, true>::kConsumerRegs == 112 && Cfg<32, false>::kConsumerRegs == 112 &&
                  Cfg<64, true>::kConsumerRegs == 232 && ring_stages<32, true>() == 16 &&
                  smem_bytes<32, true>(16) == 142912 && ring_stages<32, false>() == 8 &&
                  smem_bytes<32, false>(8) == 142656 && ring_stages<64, true>() == 8 &&
                  smem_bytes<64, true>(8) == 208160,
              "at D 32 units of four (112 registers), dK/dV walking 32-row blocks in sixteen "
              "stages and dQ 64-row blocks in eight; at D 64 units of two (232), eight stages");

// x as lane 0 of the warp holds it: a value the compiler then knows to be
// the same in every lane, so a branch on it around wgmmas is no divergent
// path (ptxas would otherwise serialise them)
__device__ __forceinline__ bool warp_uniform(bool x) {
  return __shfl_sync(0xffffffffu, (int)x, 0) != 0;
}

template <int RowB>
__device__ __forceinline__ uint64_t desc(const void* p) {
  if constexpr (RowB == 64) return wgmma_desc_sw64(p);
  else return wgmma_desc_sw128(p);
}

// presence over a lane's N ids (the forward's rule)
template <int N>
__device__ __forceinline__ uint32_t presence_of(const int (&x)[N]) {
  constexpr uint32_t kAll = 0xffffffffu;
  uint32_t bits = 0;
  bool other = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    bits |= (unsigned)x[i] < 32u ? 1u << x[i] : 0u;
    other = other || (unsigned)x[i] >= 32u;
  }
  return __any_sync(kAll, other) ? ~0u : __reduce_or_sync(kAll, bits);
}

// the block's k-th unit: its item and its unit in the item (unit w of the
// launch goes to block w % gridDim.x, so an item's units run together)
__device__ __forceinline__ void unit_of(int k, int units, int& item, int& u) {
  const int w = blockIdx.x + k * gridDim.x;
  item = w / units;
  u = w - item * units;
}

// The producer warpgroup: for each unit and each kWalk-row block of the
// item's other side, the block's head (which tiles need it; the rows'
// values) and its two tiles by TMA where any tile needs it.  Block n of the
// walk (unit n / nb, block n % nb) is warp n % 4's, so the four warps'
// global loads of ids, m, l and di wait in four chains at once (one warp
// waited on each block's loads in turn: the consumers waited on it); each
// warp reads its rows before it waits for the stage.
template <int D, bool DKV>
__device__ __forceinline__ void produce(const CUtensorMap* w0map, const CUtensorMap* w1map,
                                        const int32_t* __restrict__ seg,
                                        const float* __restrict__ res_m,
                                        const float* __restrict__ res_l,
                                        const float* __restrict__ di, unsigned char* stages,
                                        Head<Cfg<D, DKV>::kWalk>* head, uint64_t* full,
                                        uint64_t* empty, int n_units, int units, int S, int H,
                                        int pw, int lane) {
  using C = Cfg<D, DKV>;
  constexpr int nst = Ring<D, DKV>::kStages;
  static_assert(nst % kProducers == 0, "a stage is always the same warp's");
  constexpr int U = C::kUnit;
  constexpr int kLane = C::kWalk / 32;  // a lane's rows of a block
  const int T = S / kRows, nb = S / C::kWalk, N = n_units * nb;
  int k_tp = -1;  // the unit whose tiles' presence tp holds
  uint32_t tp[U];
  for (int n = pw; n < N; n += kProducers) {
    const int k = n / nb, ob = n - k * nb;
    int item, u;
    unit_of(k, units, item, u);
    const int pair = item / H, hd = item - pair * H;
    const int32_t* srow = seg + (size_t)pair * S;
    const size_t rows = (size_t)item * S;  // the item's rows of m, l, di
    int x[kLane];
    float rm[kLane], rs[kLane], rd[kLane];
#pragma unroll
    for (int i = 0; i < kLane; ++i) {
      const int r = ob * C::kWalk + lane + 32 * i;
      x[i] = srow[r];
      if constexpr (DKV) {
        rm[i] = res_m[rows + r];
        rs[i] = res_l[rows + r];
        rd[i] = di[rows + r];
      }
    }
    if (k != k_tp) {  // a new unit: its tiles' presence
      int t[2 * U];
#pragma unroll
      for (int w = 0; w < U; ++w) {
        const int tile = u * U + w;
        t[2 * w] = tile < T ? srow[tile * kRows + lane] : 0;
        t[2 * w + 1] = tile < T ? srow[tile * kRows + 32 + lane] : 0;
      }
#pragma unroll
      for (int w = 0; w < U; ++w) tp[w] = u * U + w < T ? presence(t[2 * w], t[2 * w + 1]) : 0u;
      k_tp = k;
    }
    const uint32_t bp = presence_of(x);
    uint32_t need = 0;
#pragma unroll
    for (int w = 0; w < U; ++w)
      if (tp[w] & bp) need |= 1u << w;
    const int s = n % nst;
    mbar_wait(&empty[s], ((n / nst) & 1) ^ 1);  // the first round passes
    Head<C::kWalk>& h = head[s];
    if (need) {
#pragma unroll
      for (int i = 0; i < kLane; ++i) {
        if constexpr (DKV)
          h.rows[lane + 32 * i] = make_float4(rm[i] * kLog2e, 1.f / rs[i], rd[i],
                                              __int_as_float(x[i]));
        else
          h.ids[lane + 32 * i] = x[i];
      }
    }
    if (lane == 0) h.need = need;
    if (lane == 0 && need) {
      unsigned char* st = stages + (size_t)s * C::kStageB;
      mbar_arrive_expect_tx(&full[s], C::kStageB);
      tma_load_3d(st, w0map, &full[s], hd * D, ob * C::kWalk, pair);
      tma_load_3d(st + C::kWalkB, w1map, &full[s], hd * D, ob * C::kWalk, pair);
    } else {
      mbar_arrive(&full[s]);
    }
  }
}

// A consumer thread's two own rows (16 warp + g and + 8 of its tile):
// their segment ids and, for dQ, m log2e, 1 / l and di
struct OwnRows {
  int seg[2];
  float m2[2], rl[2], di[2];
};

// One (tile, block) step for the warpgroup.  o0, o1: the own tile's K and
// V (dK/dV) or q and dO (dQ); w0, w1: the stage's q and dO, or K and V.
// ga, gb: dK and dV, or dQ; ga[4j + 2h + e] is own row 16 warp + g + 8h,
// column 8j + 2t + e.
template <int D, bool DKV>
__device__ __forceinline__ void step(float (&ga)[D / 2], float (&gb)[D / 2],
                                     const unsigned char* o0, const unsigned char* o1,
                                     const unsigned char* w0, const unsigned char* w1,
                                     const Head<Cfg<D, DKV>::kWalk>& h, const OwnRows& own,
                                     float c2, float scale, int lane) {
  using C = Cfg<D, DKV>;
  const int t = lane & 3;
  // x = own . w0^T (S^T for dK/dV, S for dQ) and y = own1 . w1^T (dP^T or
  // dP), 64 own rows x kWalk walked rows: x[4j + 2h + e] is own row g + 8h,
  // walked row 8j + 2t + e
  float x[C::kWalk / 2], y[C::kWalk / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(x, desc<C::kRowB>(o0 + 32 * kk), desc<C::kRowB>(w0 + 32 * kk), kk > 0 ? 1u : 0u);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(y, desc<C::kRowB>(o1 + 32 * kk), desc<C::kRowB>(w1 + 32 * kk), kk > 0 ? 1u : 0u);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin(x);
  wgmma_pin(y);
  // p = ex2(s c2 - m log2e) (1 / l), 0 where the ids differ, into x;
  // dS = (dP - di) p sm_scale into y
#pragma unroll
  for (int j = 0; j < C::kWalk / 8; ++j) {
    if constexpr (DKV) {  // the walked rows are the columns
      const float4 ra = h.rows[8 * j + 2 * t], rb = h.rows[8 * j + 2 * t + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float& xa = x[4 * j + 2 * hh];
        float& xb = x[4 * j + 2 * hh + 1];
        xa = __float_as_int(ra.w) == own.seg[hh] ? ex2(fmaf(xa, c2, -ra.x)) * ra.y : 0.f;
        xb = __float_as_int(rb.w) == own.seg[hh] ? ex2(fmaf(xb, c2, -rb.x)) * rb.y : 0.f;
        y[4 * j + 2 * hh] = (y[4 * j + 2 * hh] - ra.z) * xa * scale;
        y[4 * j + 2 * hh + 1] = (y[4 * j + 2 * hh + 1] - rb.z) * xb * scale;
      }
    } else {  // the own rows are the rows
      const int2 kid = *reinterpret_cast<const int2*>(h.ids + 8 * j + 2 * t);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float& xa = x[4 * j + 2 * hh];
        float& xb = x[4 * j + 2 * hh + 1];
        const float nm = -own.m2[hh];
        xa = kid.x == own.seg[hh] ? ex2(fmaf(xa, c2, nm)) * own.rl[hh] : 0.f;
        xb = kid.y == own.seg[hh] ? ex2(fmaf(xb, c2, nm)) * own.rl[hh] : 0.f;
        y[4 * j + 2 * hh] = (y[4 * j + 2 * hh] - own.di[hh]) * xa * scale;
        y[4 * j + 2 * hh + 1] = (y[4 * j + 2 * hh + 1] - own.di[hh]) * xb * scale;
      }
    }
  }
  // bf16(p) and bf16(dS) as A fragments of the gradient products, a
  // 16-row step of the walked block each: row g cols 2t, 2t + 1; row g +
  // 8; row g cols 2t + 8, 2t + 9; row g + 8
  uint32_t pa[C::kWalk / 16][4], da[C::kWalk / 16][4];
#pragma unroll
  for (int kk = 0; kk < C::kWalk / 16; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      if constexpr (DKV) pa[kk][f] = pack_bf16(x[8 * kk + 2 * f], x[8 * kk + 2 * f + 1]);
      da[kk][f] = pack_bf16(y[8 * kk + 2 * f], y[8 * kk + 2 * f + 1]);
    }
  }
  // the stage's blocks as MN-major B: rows are the product's K, 8 rows an
  // atom (8 RowB bytes apart), the D columns one atom wide
  wgmma_fence();
  if constexpr (DKV) {
#pragma unroll
    for (int kk = 0; kk < C::kWalk / 16; ++kk)  // dV += bf16(p^T) . dO
      wgmma_rs_mn(gb, pa[kk], wgmma_desc_mn<C::kRowB>(w1 + kk * 16 * C::kRowB, C::kWalkB), 1u);
  }
#pragma unroll
  for (int kk = 0; kk < C::kWalk / 16; ++kk)  // dK += bf16(dS^T) . q, or dQ += bf16(dS) . K
    wgmma_rs_mn(ga, da[kk], wgmma_desc_mn<C::kRowB>(w0 + kk * 16 * C::kRowB, C::kWalkB), 1u);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin(ga);
  if constexpr (DKV) wgmma_pin(gb);
}

// A gradient's rows ra, ra + 8 (step's layout) to a (B, S, H, D) bf16 tensor
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out, const float (&g)[D / 2],
                                           size_t base, size_t tok, int ra, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(out + base + (size_t)ra * tok + col) = pack_bf16(g[4 * j], g[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(out + base + (size_t)(ra + 8) * tok + col) =
        pack_bf16(g[4 * j + 2], g[4 * j + 3]);
  }
}

// DKV: own tiles of 64 keys (K, V), the walk over q blocks (q, dO), the
// outputs dK (g0) and dV (g1); otherwise own tiles of 64 queries (q, dO),
// the walk over key blocks (K, V), the output dQ (g0).  own0/own1/walk0/
// walk1: 3-D tensor maps of (B, S, H D) with boxes of D columns x 64 rows.
template <int D, bool DKV>
__global__ void __launch_bounds__(Cfg<D, DKV>::kThreads, 1)
walk_kernel(const __grid_constant__ CUtensorMap own0, const __grid_constant__ CUtensorMap own1,
            const __grid_constant__ CUtensorMap walk0, const __grid_constant__ CUtensorMap walk1,
            const int32_t* __restrict__ seg, const float* __restrict__ res_m,
            const float* __restrict__ res_l, const float* __restrict__ di,
            __nv_bfloat16* __restrict__ g0, __nv_bfloat16* __restrict__ g1, int P, int S, int H,
            float scale) {
  using C = Cfg<D, DKV>;
  constexpr int nst = Ring<D, DKV>::kStages;
  constexpr int U = C::kUnit;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* owns = stages + (size_t)nst * C::kStageB;  // [U][2 buffers][2 tiles]
  Head<C::kWalk>* head = reinterpret_cast<Head<C::kWalk>*>(owns + (size_t)U * 2 * 2 * C::kTileB);
  uint64_t* full = reinterpret_cast<uint64_t*>(head + nst);
  uint64_t* empty = full + nst;
  uint64_t* ownfull = empty + nst;  // [U][2]

  const int T = S / kRows, nb = S / C::kWalk, units = (T + U - 1) / U;
  const int n_units = (P * H * units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 32);        // every lane of the stage's producer warp, after its writes
      mbar_init(&empty[s], 4 * U);    // every consumer warp, when done with the block
    }
    for (int b = 0; b < 2 * U; ++b) mbar_init(&ownfull[b], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * U) {  // the producer warpgroup: its warps take every fourth block
    setmaxnreg_dec<C::kProducerRegs>();
    produce<D, DKV>(&walk0, &walk1, seg, res_m, res_l, di, stages, head, full, empty, n_units,
                    units, S, H, warp - 4 * U, lane);
    return;
  }
  setmaxnreg_inc<C::kConsumerRegs>();

  // Consumer warpgroup wg takes tile u U + wg of each of the block's units
  // (none where that is past the item's T tiles: it passes through the
  // unit's stages).  Its leader loads the tile's two own tiles by TMA into
  // one of its two buffers, a unit ahead; each thread reads its own rows'
  // ids (and values) a unit ahead too.
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2;
  const bool leader = (threadIdx.x & 127) == 0;
  unsigned char* my_own = owns + (size_t)wg * 2 * 2 * C::kTileB;
  uint64_t* my_full = ownfull + 2 * wg;
  const CUtensorMap* omap0 = &own0;
  const CUtensorMap* omap1 = &own1;
  auto load_own = [&](int k, int b) {  // unit k's tile into buffer b
    int item, u;
    unit_of(k, units, item, u);
    const int tile = u * U + wg;
    if (tile < T) {
      const int pair = item / H, hd = item - pair * H;
      unsigned char* dst = my_own + (size_t)b * 2 * C::kTileB;
      mbar_arrive_expect_tx(&my_full[b], 2 * C::kTileB);
      tma_load_3d(dst, omap0, &my_full[b], hd * D, tile * kRows, pair);
      tma_load_3d(dst + C::kTileB, omap1, &my_full[b], hd * D, tile * kRows, pair);
    } else {
      mbar_arrive(&my_full[b]);
    }
  };
  // unit k's own rows, as read from memory (m, l, di raw: their values
  // are made when the unit starts)
  struct Rows {
    int seg[2];
    float m[2], l[2], di[2];
  };
  auto read_rows = [&](int k, Rows& r) {
    int item, u;
    unit_of(k, units, item, u);
    const int tile = u * U + wg;
    const int pair = item / H;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = (tile < T ? tile * kRows : 0) + 16 * wl + g + 8 * hh;
      r.seg[hh] = seg[(size_t)pair * S + row];
      if constexpr (!DKV) {
        r.m[hh] = res_m[(size_t)item * S + row];
        r.l[hh] = res_l[(size_t)item * S + row];
        r.di[hh] = di[(size_t)item * S + row];
      }
    }
  };
  const size_t tok = (size_t)H * D;  // stride of one token
  const float c2 = scale * kLog2e;
  const uint32_t bit = 1u << wg;
  auto release = [&](int s) {  // this warp is done with stage s
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  Rows next = {};
  if (n_units > 0) {
    if (leader) load_own(0, 0);
    read_rows(0, next);
  }
  int n = 0;  // stages passed
  for (int k = 0; k < n_units; ++k) {
    int item, u;
    unit_of(k, units, item, u);
    const int tile = u * U + wg;
    OwnRows own = {};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      own.seg[hh] = next.seg[hh];
      if constexpr (!DKV) {  // once a tile
        own.m2[hh] = next.m[hh] * kLog2e;
        own.rl[hh] = 1.f / next.l[hh];
        own.di[hh] = next.di[hh];
      }
    }
    if (k + 1 < n_units) read_rows(k + 1, next);
    float ga[D / 2], gb[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) ga[i] = gb[i] = 0.f;
    // every warp is past the last unit's wgmmas, which read the other buffer
    named_barrier(1 + wg, 128);
    if (leader && k + 1 < n_units) load_own(k + 1, (k + 1) & 1);
    mbar_wait(&my_full[k & 1], (k >> 1) & 1);
    const unsigned char* o0 = my_own + (size_t)(k & 1) * 2 * C::kTileB;
    for (int ob = 0; ob < nb; ++ob, ++n) {
      const int s = n % nst;
      mbar_wait(&full[s], (n / nst) & 1);
      const Head<C::kWalk>& h = head[s];
      if (warp_uniform(h.need & bit)) {
        const unsigned char* w0 = stages + (size_t)s * C::kStageB;
        step<D, DKV>(ga, gb, o0, o0 + C::kTileB, w0, w0 + C::kWalkB, h, own, c2, scale, lane);
      }
      release(s);
    }
    if (tile < T) {
      const int pair = item / H;
      const size_t base = (size_t)pair * S * tok + (size_t)(item - pair * H) * D;
      const int ra = tile * kRows + 16 * wl + g;
      store_rows<D>(g0, ga, base, tok, ra, lane);
      if constexpr (DKV) store_rows<D>(g1, gb, base, tok, ra, lane);
    }
  }
}

// (B, S, H * D) bf16 as a 3-D tensor map with boxes of D values x `rows`
// tokens of one pair, swizzled by the box's row bytes (flash_attention.cu's
// tile_map); false if cuTensorMapEncodeTiled refuses it
bool tile_map(CUtensorMap* map, const void* ptr, int P, int S, int H, int D, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)H * D, (cuuint64_t)S, (cuuint64_t)P};
  const cuuint64_t strides[2] = {(cuuint64_t)H * D * 2, (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)rows, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int D, bool DKV>
int launch(const void* q, const void* k, const void* v, const void* seg, const void* m,
           const void* l, const void* dout, const void* di, void* g0, void* g1, int B, int S,
           int H, float scale, cudaStream_t st) {
  using C = Cfg<D, DKV>;
  CUtensorMap own0, own1, walk0, walk1;
  if (!tile_map(&own0, DKV ? k : q, B, S, H, D, kRows) ||
      !tile_map(&own1, DKV ? v : dout, B, S, H, D, kRows) ||
      !tile_map(&walk0, DKV ? q : k, B, S, H, D, C::kWalk) ||
      !tile_map(&walk1, DKV ? dout : v, B, S, H, D, C::kWalk))
    return (int)cudaErrorInvalidValue;
  const int T = S / kRows, units = (T + C::kUnit - 1) / C::kUnit;
  if ((long long)B * H * units > INT32_MAX || (long long)B * S > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  constexpr size_t smem = smem_bytes<D, DKV>(Ring<D, DKV>::kStages);
  static_assert(smem <= kSmemLimit, "the ring does not fit");
  // SMs of each device, 0 until a launch there has raised the kernel's
  // shared-memory limit (host threads may launch at once)
  static std::atomic<int> sms[64];
  int n_sm = sms[dev & 63].load(std::memory_order_acquire);
  if (n_sm == 0) {
    err = cudaFuncSetAttribute(walk_kernel<D, DKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms[dev & 63].store(n_sm, std::memory_order_release);
  }
  const long long all = (long long)B * H * units;
  const int ctas = all < n_sm ? (int)all : n_sm;  // one block an SM
  walk_kernel<D, DKV><<<ctas, C::kThreads, smem, st>>>(
      own0, own1, walk0, walk1, (const int32_t*)seg, (const float*)m, (const float*)l,
      (const float*)di, (__nv_bfloat16*)g0, (__nv_bfloat16*)g1, B, S, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace unit

// ---------------------------------------------------------------------------
// Heads of 128 and every wider multiple of 64 (wide::wide_kernel<W, DKV>):
// persistent blocks, a unit of one own 64-row tile and one column group of
// its gradients, a TMA ring of walked blocks over the whole head, S and dP
// once a (tile, block) on wgmma split between two consumer warpgroups by
// walked rows, bf16 p and dS through shared memory (see the file's header).

namespace wide {

constexpr int kRows = 64;                 // an own tile's rows: one wgmma M
constexpr int kChunkB = kRows * 128;      // 64 rows x 64 head columns of bf16 (a swizzle row)
constexpr int kConsumers = 2;             // consumer warpgroups
// and a producer warpgroup (one warp of it walks): the budgets after
// setmaxnreg (the producer's loop state spilled at 40 registers; a launch
// of nine warps, one producer warp, caps every thread at 168: three warps
// on one SM sub-partition)
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 56;
constexpr int kPool = kThreads * (65536 / kThreads / 8 * 8);
constexpr int kConsumerRegs = (kPool / 128 - kProducerRegs) / kConsumers / 8 * 8;
static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= kPool && kConsumerRegs == 224,
              "two consumer warpgroups at 224 registers beside a producer warpgroup at 56");
constexpr int kMaxStages = 4;
// blocks of a cluster: own tiles of one item and column group walking the
// same blocks, each block's chunks loaded from L2 once for all of them
// (TMA multicast, each block a share of the chunks)
constexpr int kCluster = 2;
constexpr int kResidentMax = 512;         // widest head whose own tile stays resident
constexpr int kWindow = 4;                // a window's chunks when it does not
constexpr size_t kSmemLimit = 232448;

// 64-column chunks of the gradients a consumer warpgroup holds: 2 for dK
// and dV (128 f32 a thread), 4 for dQ
template <bool DKV>
__host__ __device__ constexpr int grad_chunks() {
  return DKV ? 2 : 4;
}

// A stage's head: which of the cluster's own tiles share a segment id with
// the block (bit r: the block of rank r's tile), and the walked rows'
// values: (m log2e, 1 / l, di, id) for dK/dV (the walked rows are
// queries), the id in .w for dQ (keys)
template <int W>
struct Head {
  uint32_t need;
  int pad[3];
  float4 rows[W];
};

// bf16 p's or dS's element (r, k) (own row, walked row) in shared memory,
// as the gradient products read it (wgmma's A, K-major, no swizzle): core
// matrices of 8 rows x 16 bytes, 128 contiguous bytes each, k-adjacent
// ones 128 bytes apart, groups of 8 rows 16 W bytes apart; a warp's
// 32-bit stores of a row group fill 128 consecutive bytes
template <int W>
__device__ __forceinline__ int pds_at(int r, int k) {
  return (r >> 3) * (16 * W) + (k >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2;
}

// The launch's plan at heads of D (ops/flash_attention.py wide_bwd_plan
// mirrors it)
struct Plan {
  int nc;          // the head's 64-column chunks
  int ng;          // column groups: units of a tile
  int gmax;        // chunks of a group (the last may hold fewer)
  int resident;    // the own tile stays in shared memory for a unit's walk
  int wc;          // chunks a stage holds: nc when resident, else a window of gmax
  int nst;         // stages
  int stage_b;     // bytes of a stage
  int own_b;       // bytes of the resident own tile (0 when not resident)
  int pds_b;       // bytes of bf16 p and dS (dK/dV) or dS (dQ)
  size_t smem;     // dynamic shared memory
};

template <int W, bool DKV>
constexpr size_t plan_bytes(const Plan& p, int stages) {
  return (size_t)1024 + (size_t)stages * (p.stage_b + sizeof(Head<W>) + 2 * sizeof(uint64_t)) +
         p.own_b + p.pds_b + 2 * sizeof(uint64_t);
}

template <int W, bool DKV>
constexpr Plan plan(int D) {
  Plan p{};
  p.nc = D / 64;
  p.resident = D <= kResidentMax;
  p.gmax = p.resident ? 2 * grad_chunks<DKV>() : kWindow;
  if (p.gmax > p.nc) p.gmax = p.nc;
  p.ng = (p.nc + p.gmax - 1) / p.gmax;
  p.wc = p.resident ? p.nc : p.gmax;
  p.stage_b = 2 * p.wc * ((p.resident ? 0 : kChunkB) + W * 128);
  p.own_b = p.resident ? 2 * p.nc * kChunkB : 0;
  p.pds_b = (DKV ? 2 : 1) * kRows * 2 * W;
  p.nst = kMaxStages;
  while (p.nst > 1 && plan_bytes<W, DKV>(p, p.nst) > kSmemLimit) --p.nst;
  p.smem = plan_bytes<W, DKV>(p, p.nst);
  return p;
}

static_assert(sizeof(Head<64>) == 1040 && sizeof(Head<32>) == 528 && sizeof(Head<16>) == 272 &&
                  plan<64, true>(128).nst == 4 && plan<64, true>(128).smem == 185488 &&
                  plan<64, true>(256).nst == 2 && plan<64, true>(256).smem == 216144 &&
                  plan<64, false>(256).smem == 207952 && plan<32, true>(384).ng == 2 &&
                  plan<32, true>(384).smem == 206928 && plan<32, false>(384).ng == 1 &&
                  plan<16, true>(512).nst == 2 && plan<16, true>(512).smem == 202320 &&
                  plan<32, true>(640).resident == 0 && plan<32, true>(640).ng == 3 &&
                  plan<32, true>(640).smem == 206928,
              "heads of 128 in four stages, 256 in two; 384 (32-row blocks) and 512 (16) in "
              "two, dK/dV in two column groups; 640 in windows of four chunks");

// the walked block's rows at heads of D: 64 up to 256, 32 up to 384 and
// above 512 (a window of the head a stage), 16 at 448 and 512
inline int walk_rows(int D) {
  return D <= 256 ? 64 : D <= 384 || D > kResidentMax ? 32 : 16;
}

// the cluster's k-th unit: its item, its kCluster own tiles (the block's
// own tile is the first plus its rank) and column group; unit w of the
// launch goes to cluster w % clusters, so an item's units run together
__device__ __forceinline__ void unit_of(int k, int T, int ng, int cid, int ncl, int& item,
                                        int& tile0, int& grp) {
  const int w = cid + k * ncl, tg = T / kCluster;
  item = w / (tg * ng);
  const int r = w - item * (tg * ng);
  tile0 = (r / ng) * kCluster;
  grp = r - (r / ng) * ng;
}

// presence (the forward's rule) over a lane's rows that exist
__device__ __forceinline__ uint32_t presence_rows(int x, bool has_x, int x2, bool has_x2) {
  constexpr uint32_t kAll = 0xffffffffu;
  const bool other = (has_x && (unsigned)x >= 32u) || (has_x2 && (unsigned)x2 >= 32u);
  const uint32_t bits = (has_x && (unsigned)x < 32u ? 1u << x : 0u) |
                        (has_x2 && (unsigned)x2 < 32u ? 1u << x2 : 0u);
  return __any_sync(kAll, other) ? ~0u : __reduce_or_sync(kAll, bits);
}

// The producer warp's walk: for each unit and each W-row block of the
// item's other side, its head (bit r: the cluster's tile r shares an id
// with it) and, where any of the cluster's tiles does, its chunks by TMA:
// resident, one stage of the block's two tensors over the whole head;
// otherwise a stage a window of the head (this block's own tile's two
// tensors, then the walked block's), the unit's own group's window last.
// The walked chunks are multicast: each block of the cluster loads every
// kCluster-th (tensor, chunk) for all of them, and each block's full
// barrier expects the whole stage.  The warp reads a block's rows before
// it waits for the block's stage.
template <int W, bool DKV>
__device__ __forceinline__ void produce(const Plan& pl, const CUtensorMap* o0map,
                                        const CUtensorMap* o1map, const CUtensorMap* w0map,
                                        const CUtensorMap* w1map, const int32_t* __restrict__ seg,
                                        const float* __restrict__ res_m,
                                        const float* __restrict__ res_l,
                                        const float* __restrict__ di, unsigned char* stages,
                                        Head<W>* head, uint64_t* full, uint64_t* empty,
                                        int n_units, int S, int H, int cid, int ncl, int rank,
                                        int lane) {
  const int T = S / kRows, nb = S / W, nw = pl.resident ? 1 : pl.ng, per_unit = nb * nw;
  const int N = n_units * per_unit, D = 64 * pl.nc;
  const uint16_t everyone = (1u << kCluster) - 1;
  int k_tp = -1;  // the unit whose tiles' presence tp holds
  uint32_t tp[kCluster] = {};
  for (int n = 0; n < N; ++n) {
    const int k = n / per_unit, r = n - k * per_unit, ob = r / nw, i = r - ob * nw;
    int item, tile0, grp;
    unit_of(k, T, pl.ng, cid, ncl, item, tile0, grp);
    const int pair = item / H, hd = item - pair * H;
    const int32_t* srow = seg + (size_t)pair * S;
    const size_t rows = (size_t)item * S;  // the item's rows of m, l, di
    const int r0 = ob * W + lane, r1 = r0 + 32;
    const bool h0 = lane < W, h1 = lane + 32 < W;
    const int x0 = h0 ? srow[r0] : 0, x1 = h1 ? srow[r1] : 0;
    float4 v0 = make_float4(0.f, 0.f, 0.f, __int_as_float(x0));
    float4 v1 = make_float4(0.f, 0.f, 0.f, __int_as_float(x1));
    if constexpr (DKV) {
      if (h0) v0 = make_float4(res_m[rows + r0] * kLog2e, 1.f / res_l[rows + r0], di[rows + r0],
                               __int_as_float(x0));
      if (h1) v1 = make_float4(res_m[rows + r1] * kLog2e, 1.f / res_l[rows + r1], di[rows + r1],
                               __int_as_float(x1));
    }
    if (k != k_tp) {
#pragma unroll
      for (int c = 0; c < kCluster; ++c) {
        const int32_t* t = srow + (tile0 + c) * kRows;
        tp[c] = presence_rows(t[lane], true, t[32 + lane], true);
      }
      k_tp = k;
    }
    const uint32_t bp = presence_rows(x0, h0, x1, h1);
    uint32_t need = 0;
#pragma unroll
    for (int c = 0; c < kCluster; ++c)
      if (tp[c] & bp) need |= 1u << c;
    const int s = n % pl.nst;
    mbar_wait(&empty[s], ((n / pl.nst) & 1) ^ 1);  // the first round passes
    Head<W>& h = head[s];
    if (h0) h.rows[lane] = v0;
    if (h1) h.rows[lane + 32] = v1;
    if (lane == 0) h.need = need;
    if (lane == 0 && need) {
      unsigned char* st = stages + (size_t)s * pl.stage_b;
      // window win's chunks c0 .. c0 + cw - 1 (resident: the whole head)
      const int win = pl.resident ? 0 : (grp + 1 + i) % pl.ng, c0 = win * pl.gmax;
      const int cw = pl.resident ? pl.nc : min(pl.gmax, pl.nc - c0);
      unsigned char* wst = pl.resident ? st : st + 2 * pl.wc * kChunkB;
      mbar_arrive_expect_tx(&full[s], 2 * cw * ((pl.resident ? 0 : kChunkB) + W * 128));
      if (!pl.resident) {  // this block's own tile's chunks of the window
        for (int c = 0; c < cw; ++c) {
          const int col = hd * D + 64 * (c0 + c), row = (tile0 + rank) * kRows;
          tma_load_3d(st + c * kChunkB, o0map, &full[s], col, row, pair);
          tma_load_3d(st + (pl.wc + c) * kChunkB, o1map, &full[s], col, row, pair);
        }
      }
      for (int j = rank; j < 2 * cw; j += kCluster) {  // the walked (tensor, chunk)s, shared
        const int c = j < cw ? j : j - cw;
        tma_load_3d_multicast(wst + (j < cw ? c : pl.wc + c) * W * 128, j < cw ? w0map : w1map,
                              &full[s], hd * D + 64 * (c0 + c), ob * W, pair, everyone);
      }
    } else {
      mbar_arrive(&full[s]);
    }
  }
}

// Unit k's own tile of K and V (dK/dV) or q and dO (dQ) over the whole
// head, by TMA (resident plans; one thread, once both warpgroups are done
// with the last unit's)
__device__ __forceinline__ void load_own(const Plan& pl, const CUtensorMap* o0map,
                                         const CUtensorMap* o1map, unsigned char* own,
                                         uint64_t* own_full, int k, int S, int H, int cid,
                                         int ncl, int rank) {
  int item, tile, grp;
  unit_of(k, S / kRows, pl.ng, cid, ncl, item, tile, grp);
  tile += rank;
  const int pair = item / H, hd = item - pair * H, D = 64 * pl.nc;
  mbar_arrive_expect_tx(own_full, pl.own_b);
  for (int c = 0; c < pl.nc; ++c) {
    tma_load_3d(own + c * kChunkB, o0map, own_full, hd * D + 64 * c, tile * kRows, pair);
    tma_load_3d(own + (pl.nc + c) * kChunkB, o1map, own_full, hd * D + 64 * c, tile * kRows, pair);
  }
}

// A consumer thread's two own rows (16 warp + g and + 8 of the tile):
// their segment ids and, for dQ, m log2e, 1 / l and di
struct OwnRows {
  int seg[2];
  float m2[2], rl[2], di[2];
};

// x (S^T for dK/dV, S for dQ) and y (dP^T, dP) over the warpgroup's half
// of the walked rows, summed over chunks c of a window: o0, o1 the own
// tile's two tensors' chunks (8 KB each), w0, w1 the block's (W rows a
// chunk), the warpgroup's rows from row wg W / 2; scale_d 0 on the first
template <int W>
__device__ __forceinline__ void scores(float (&x)[W / 4], float (&y)[W / 4],
                                       const unsigned char* o0, const unsigned char* o1,
                                       const unsigned char* w0, const unsigned char* w1, int cw,
                                       int wg, bool first) {
  const int half = wg * (W / 2) * 128;
  for (int c = 0; c < cw; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(x, wgmma_desc_sw128(o0 + c * kChunkB + 32 * kk),
               wgmma_desc_sw128(w0 + c * W * 128 + half + 32 * kk),
               first && c == 0 && kk == 0 ? 0u : 1u);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(y, wgmma_desc_sw128(o1 + c * kChunkB + 32 * kk),
               wgmma_desc_sw128(w1 + c * W * 128 + half + 32 * kk),
               first && c == 0 && kk == 0 ? 0u : 1u);
  }
}

// The consumer warpgroups' units (see the file's header).
template <int W, bool DKV>
__device__ __forceinline__ void consume(const Plan& pl, const CUtensorMap* own0,
                                        const CUtensorMap* own1, const int32_t* __restrict__ seg,
                                        const float* __restrict__ res_m,
                                        const float* __restrict__ res_l,
                                        const float* __restrict__ di,
                                        __nv_bfloat16* __restrict__ g0,
                                        __nv_bfloat16* __restrict__ g1, unsigned char* stages,
                                        unsigned char* own, unsigned char* pds, Head<W>* head,
                                        uint64_t* full, uint64_t* empty, uint64_t* own_full,
                                        int n_units, int S, int H, float scale, int cid, int ncl,
                                        int rank, int warp, int lane) {
  constexpr int GC = grad_chunks<DKV>();
  const int T = S / kRows, nb = S / W;
  if (threadIdx.x == 0 && pl.resident && n_units > 0)
    load_own(pl, own0, own1, own, own_full, 0, S, H, cid, ncl, rank);

  // Consumer warpgroup wg: S and dP of the walked rows wg W / 2 .. (wg +
  // 1) W / 2 - 1 against the whole own tile; of the unit's column group, the
  // chunks wg, wg + 2, ... of the gradients
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const size_t tok = (size_t)H * 64 * pl.nc;  // stride of one token
  const float c2 = scale * kLog2e;
  // this warp is done with a stage: tell every block's producer
  auto release = [&](uint64_t* bar) {
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kCluster; ++r) mbar_arrive_remote_if(bar, r, lane == 0);
  };
  unsigned char* p_s = pds;                                   // bf16 p (dK/dV)
  unsigned char* ds_s = pds + (DKV ? kRows * 2 * W : 0);      // bf16 dS
  int n = 0;  // stages passed
  for (int k = 0; k < n_units; ++k) {
    int item, tile, grp;
    unit_of(k, T, pl.ng, cid, ncl, item, tile, grp);
    tile += rank;
    const int pair = item / H, hd = item - pair * H;
    const int g0c = grp * pl.gmax, gn = min(pl.gmax, pl.nc - g0c);
    const int mine = (gn - wg + 1) / 2;  // the group's chunks g0c + wg + 2 j, j < mine
    OwnRows ownr = {};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = tile * kRows + 16 * wl + g + 8 * hh;
      ownr.seg[hh] = seg[(size_t)pair * S + row];
      if constexpr (!DKV) {
        ownr.m2[hh] = res_m[(size_t)item * S + row] * kLog2e;
        ownr.rl[hh] = 1.f / res_l[(size_t)item * S + row];
        ownr.di[hh] = di[(size_t)item * S + row];
      }
    }
    float ga[GC][32], gb[DKV ? GC : 1][32];
#pragma unroll
    for (int j = 0; j < GC; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) ga[j][i] = 0.f;
#pragma unroll
    for (int j = 0; j < (DKV ? GC : 1); ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) gb[j][i] = 0.f;
    // p = ex2(s c2 - m log2e) (1 / l), 0 where the ids differ, into x; dS
    // = (dP - di) p sm_scale into y (x[4j + 2h + e]: own row 16 wl + g +
    // 8h, walked row wg W / 2 + 8j + 2t + e); then, once both warpgroups
    // are past their S and dP (so past the last block's gradient products,
    // which read p and dS), this half of bf16 p and dS into shared memory
    auto share_p_ds = [&](float (&x)[W / 4], float (&y)[W / 4], const Head<W>& h) {
#pragma unroll
      for (int j = 0; j < W / 16; ++j) {
        const int col = wg * (W / 2) + 8 * j + 2 * t;
        const float4 ra = h.rows[col], rb = h.rows[col + 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float& xa = x[4 * j + 2 * hh];
          float& xb = x[4 * j + 2 * hh + 1];
          float& ya = y[4 * j + 2 * hh];
          float& yb = y[4 * j + 2 * hh + 1];
          if constexpr (DKV) {  // the walked rows are the columns
            xa = __float_as_int(ra.w) == ownr.seg[hh] ? ex2(fmaf(xa, c2, -ra.x)) * ra.y : 0.f;
            xb = __float_as_int(rb.w) == ownr.seg[hh] ? ex2(fmaf(xb, c2, -rb.x)) * rb.y : 0.f;
            ya = (ya - ra.z) * xa * scale;
            yb = (yb - rb.z) * xb * scale;
          } else {  // the own rows are the rows
            const float nm = -ownr.m2[hh];
            xa = __float_as_int(ra.w) == ownr.seg[hh] ? ex2(fmaf(xa, c2, nm)) * ownr.rl[hh] : 0.f;
            xb = __float_as_int(rb.w) == ownr.seg[hh] ? ex2(fmaf(xb, c2, nm)) * ownr.rl[hh] : 0.f;
            ya = (ya - ownr.di[hh]) * xa * scale;
            yb = (yb - ownr.di[hh]) * xb * scale;
          }
        }
      }
      named_barrier(1, 128 * kConsumers);
#pragma unroll
      for (int j = 0; j < W / 16; ++j) {
        const int col = wg * (W / 2) + 8 * j + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int at = pds_at<W>(16 * wl + g + 8 * hh, col);
          if constexpr (DKV)
            *reinterpret_cast<uint32_t*>(p_s + at) = pack_bf16(x[4 * j + 2 * hh], x[4 * j + 2 * hh + 1]);
          *reinterpret_cast<uint32_t*>(ds_s + at) = pack_bf16(y[4 * j + 2 * hh], y[4 * j + 2 * hh + 1]);
        }
      }
      fence_proxy_async();  // the products read them in the async proxy
      named_barrier(2, 128 * kConsumers);  // both halves are in
    };
    // the gradient products of the warpgroup's chunks, the walked chunks
    // (from w0, chunk c0 first) as MN-major B: dV += p^T dO and dK += dS^T
    // q, or dQ += dS K; issued, not committed.  A 16-deep step of p or dS
    // is two core matrices along K (128 bytes apart), its 8-row groups 16
    // W bytes apart.
    auto grads = [&](const unsigned char* w0, int c0) {
#pragma unroll
      for (int j = 0; j < GC; ++j) {
        if (unit::warp_uniform(j < mine)) {
          const int cg = g0c + wg + 2 * j - c0;
          const unsigned char* q0 = w0 + (size_t)cg * W * 128;
          const unsigned char* q1 = w0 + (size_t)(pl.wc + cg) * W * 128;
#pragma unroll
          for (int kk = 0; kk < W / 16; ++kk) {
            if constexpr (DKV)
              wgmma_ss_mn(gb[j], wgmma_desc_core(p_s + kk * 256, 128, 16 * W),
                          wgmma_desc_mn<128>(q1 + kk * 16 * 128, W * 128), 1u);
            wgmma_ss_mn(ga[j], wgmma_desc_core(ds_s + kk * 256, 128, 16 * W),
                        wgmma_desc_mn<128>(q0 + kk * 16 * 128, W * 128), 1u);
          }
        }
      }
    };
    auto pin_grads = [&]() {
#pragma unroll
      for (int j = 0; j < GC; ++j) {
        wgmma_pin(ga[j]);
        if constexpr (DKV) wgmma_pin(gb[j]);
      }
    };
    float x[W / 4], y[W / 4];
    if (pl.resident) {
      // each block's S and dP, p and dS and gradient products in turn
      mbar_wait(own_full, k & 1);
      const unsigned char* o1 = own + (size_t)pl.nc * kChunkB;
      for (int ob = 0; ob < nb; ++ob, ++n) {
        const int s = n % pl.nst;
        mbar_wait(&full[s], (n / pl.nst) & 1);
        if (unit::warp_uniform((head[s].need >> rank) & 1u)) {
          const unsigned char* w0 = stages + (size_t)s * pl.stage_b;
          wgmma_fence();
          scores<W>(x, y, own, o1, w0, w0 + (size_t)pl.nc * W * 128, pl.nc, wg, true);
          wgmma_commit();
          wgmma_wait<0>();
          wgmma_pin(x);
          wgmma_pin(y);
          share_p_ds(x, y, head[s]);
          wgmma_fence();
          grads(w0, 0);
          wgmma_commit();
          wgmma_wait<0>();
          pin_grads();
        }
        release(&empty[s]);
      }
    } else {
      // windows of the head in turn, the unit's own group's last: each
      // earlier window's stage released once its products are done
      for (int ob = 0; ob < nb; ++ob) {
        bool need = false;
        int s = 0;
        const unsigned char* wlast = nullptr;  // the last window's walked chunks
        for (int i = 0; i < pl.ng; ++i, ++n) {
          s = n % pl.nst;
          mbar_wait(&full[s], (n / pl.nst) & 1);
          need = unit::warp_uniform((head[s].need >> rank) & 1u);
          unsigned char* st = stages + (size_t)s * pl.stage_b;
          const int win = (grp + 1 + i) % pl.ng;
          const int cw = min(pl.gmax, pl.nc - win * pl.gmax);
          wlast = st + 2 * pl.wc * kChunkB;
          if (need) {
            wgmma_fence();
            scores<W>(x, y, st, st + (size_t)pl.wc * kChunkB, wlast,
                      wlast + (size_t)pl.wc * W * 128, cw, wg, i == 0);
            wgmma_commit();
          }
          if (i + 1 < pl.ng) {
            if (need) {
              wgmma_wait<0>();
              wgmma_pin(x);
              wgmma_pin(y);
            }
            release(&empty[s]);
          }
        }
        if (need) {
          wgmma_wait<0>();
          wgmma_pin(x);
          wgmma_pin(y);
          share_p_ds(x, y, head[s]);
          wgmma_fence();
          grads(wlast, g0c);
          wgmma_commit();
          wgmma_wait<0>();
          pin_grads();
        }
        release(&empty[s]);
      }
    }
    if (pl.resident && k + 1 < n_units) {  // the next unit's own tile, once both are done
      named_barrier(3, 128 * kConsumers);
      if (threadIdx.x == 0) load_own(pl, own0, own1, own, own_full, k + 1, S, H, cid, ncl, rank);
    }
    // the gradients' rows 16 wl + g and + 8 of the tile, the warpgroup's chunks
    const size_t base = (size_t)pair * S * tok + (size_t)hd * 64 * pl.nc;
    const int ra = tile * kRows + 16 * wl + g;
#pragma unroll
    for (int j = 0; j < GC; ++j) {
      if (j < mine) {
        const int col0 = 64 * (g0c + wg + 2 * j) + 2 * t;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const size_t at = base + (size_t)ra * tok + col0 + 8 * jj;
          *reinterpret_cast<uint32_t*>(g0 + at) = pack_bf16(ga[j][4 * jj], ga[j][4 * jj + 1]);
          *reinterpret_cast<uint32_t*>(g0 + at + 8 * tok) =
              pack_bf16(ga[j][4 * jj + 2], ga[j][4 * jj + 3]);
          if constexpr (DKV) {
            *reinterpret_cast<uint32_t*>(g1 + at) = pack_bf16(gb[j][4 * jj], gb[j][4 * jj + 1]);
            *reinterpret_cast<uint32_t*>(g1 + at + 8 * tok) =
                pack_bf16(gb[j][4 * jj + 2], gb[j][4 * jj + 3]);
          }
        }
      }
    }
  }
}


// DKV: own tiles of 64 keys (K, V), the walk over q blocks (q, dO), the
// outputs dK (g0) and dV (g1); otherwise own tiles of 64 queries (q, dO),
// the walk over key blocks (K, V), the output dQ (g0).  own0/own1: 3-D
// tensor maps of (B, S, H D) with boxes of 64 columns x 64 rows; walk0/
// walk1: boxes of 64 columns x W rows; all with 128-byte swizzle.
template <int W, bool DKV>
__global__ void __launch_bounds__(kThreads, 1)
wide_kernel(const __grid_constant__ CUtensorMap own0, const __grid_constant__ CUtensorMap own1,
            const __grid_constant__ CUtensorMap walk0, const __grid_constant__ CUtensorMap walk1,
            const int32_t* __restrict__ seg, const float* __restrict__ res_m,
            const float* __restrict__ res_l, const float* __restrict__ di,
            __nv_bfloat16* __restrict__ g0, __nv_bfloat16* __restrict__ g1, const Plan pl,
            int P, int S, int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* own = stages + (size_t)pl.nst * pl.stage_b;
  unsigned char* pds = own + pl.own_b;  // p (dK/dV), then dS: 64 rows of kRowB bytes each
  Head<W>* head = reinterpret_cast<Head<W>*>(pds + pl.pds_b);
  uint64_t* full = reinterpret_cast<uint64_t*>(head + pl.nst);
  uint64_t* empty = full + pl.nst;
  uint64_t* own_full = empty + pl.nst;

  const int rank = (int)cluster_rank(), cid = (int)cluster_id(), ncl = (int)cluster_count();
  const int n_units = (P * H * (S / kRows / kCluster) * pl.ng - cid + ncl - 1) / ncl;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.nst; ++s) {
      mbar_init(&full[s], 32);  // every lane of the stage's producer warp, after its writes
      mbar_init(&empty[s], 4 * kConsumers * kCluster);  // every consumer warp of the cluster
    }
    mbar_init(own_full, 1);
    mbar_init_fence();
  }
  cluster_sync();  // every block's barriers are set before any other signals them

  if (warp >= 4 * kConsumers) {  // the producer warpgroup: its first warp walks
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 4 * kConsumers)
      produce<W, DKV>(pl, &own0, &own1, &walk0, &walk1, seg, res_m, res_l, di, stages, head,
                      full, empty, n_units, S, H, cid, ncl, rank, lane);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<W, DKV>(pl, &own0, &own1, seg, res_m, res_l, di, g0, g1, stages, own, pds, head, full,
                    empty, own_full, n_units, S, H, scale, cid, ncl, rank, warp, lane);
  }
  cluster_sync();  // no block leaves while another may still signal its barriers
}

// (B, S, H * D) bf16 as a 3-D tensor map with boxes of 64 values x `rows`
// tokens of one pair, 128-byte swizzle; false if cuTensorMapEncodeTiled
// refuses it
bool chunk_map(CUtensorMap* map, const void* ptr, int P, int S, int H, int D, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)H * D, (cuuint64_t)S, (cuuint64_t)P};
  const cuuint64_t strides[2] = {(cuuint64_t)H * D * 2, (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The clusters of an instantiation that the device holds at once, found
// once per device with the kernel's shared memory raised to the limit (0
// in `fit`: not yet); host threads may launch at once, and each may take
// that first step (flash_attention.cu's slab::clusters_held)
template <int W, bool DKV>
cudaError_t clusters_held(int* clusters) {
  static std::atomic<int> fit[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int c = fit[dev & 63].load(std::memory_order_acquire);
  if (c == 0) {
    err = cudaFuncSetAttribute(wide_kernel<W, DKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemLimit);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t config = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.gridDim = dim3(kCluster);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = kSmemLimit;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&c, wide_kernel<W, DKV>, &config);
    if (err != cudaSuccess) return err;
    if (c < 1) return cudaErrorInvalidConfiguration;
    fit[dev & 63].store(c, std::memory_order_release);
  }
  *clusters = c;
  return cudaSuccess;
}

template <int W, bool DKV>
int launch_w(const void* q, const void* k, const void* v, const void* seg, const void* m,
             const void* l, const void* dout, const void* di, void* g0, void* g1, int B, int S,
             int H, int D, float scale, cudaStream_t st) {
  const Plan pl = plan<W, DKV>(D);
  if (pl.smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap own0, own1, walk0, walk1;
  if (!chunk_map(&own0, DKV ? k : q, B, S, H, D, kRows) ||
      !chunk_map(&own1, DKV ? v : dout, B, S, H, D, kRows) ||
      !chunk_map(&walk0, DKV ? q : k, B, S, H, D, W) ||
      !chunk_map(&walk1, DKV ? dout : v, B, S, H, D, W))
    return (int)cudaErrorInvalidValue;
  const long long units = (long long)B * H * (S / kRows / kCluster) * pl.ng;
  if (units * kCluster > INT32_MAX || (long long)B * S > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  int clusters = 0;
  cudaError_t err = clusters_held<W, DKV>(&clusters);
  if (err != cudaSuccess) return (int)err;
  const int ncl = units < clusters ? (int)units : clusters;
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.gridDim = dim3(ncl * kCluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = pl.smem;
  config.stream = st;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, wide_kernel<W, DKV>, own0, own1, walk0, walk1,
                           (const int32_t*)seg, (const float*)m, (const float*)l,
                           (const float*)di, (__nv_bfloat16*)g0, (__nv_bfloat16*)g1, pl, B, S, H,
                           scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool DKV>
int launch(const void* q, const void* k, const void* v, const void* seg, const void* m,
           const void* l, const void* dout, const void* di, void* g0, void* g1, int B, int S,
           int H, int D, float scale, cudaStream_t st) {
  switch (walk_rows(D)) {
    case 64: return launch_w<64, DKV>(q, k, v, seg, m, l, dout, di, g0, g1, B, S, H, D, scale, st);
    case 32: return launch_w<32, DKV>(q, k, v, seg, m, l, dout, di, g0, g1, B, S, H, D, scale, st);
    default: return launch_w<16, DKV>(q, k, v, seg, m, l, dout, di, g0, g1, B, S, H, D, scale, st);
  }
}

}  // namespace wide

template <bool DKV>
int launch(const void* q, const void* k, const void* v, const void* seg, const void* m,
           const void* l, const void* dout, const void* di, void* g0, void* g1, int B, int S,
           int H, int D, float scale, void* stream) {
  if (S < 128 || S % 128 != 0 || B < 1 || H < 1 || (D != 32 && (D < 64 || D % 64 != 0)) ||
      (long long)B * H > INT32_MAX || (long long)H * D > INT32_MAX ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout | (uintptr_t)g0 |
       (uintptr_t)(DKV ? g1 : g0)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (D == 32) return unit::launch<32, DKV>(q, k, v, seg, m, l, dout, di, g0, g1, B, S, H, scale, st);
  if (D == 64) return unit::launch<64, DKV>(q, k, v, seg, m, l, dout, di, g0, g1, B, S, H, scale, st);
  return wide::launch<DKV>(q, k, v, seg, m, l, dout, di, g0, g1, B, S, H, D, scale, st);
}

}  // namespace

// dK and dV (B, S, H, D) bf16 of the forward's q, k, v (B, S, H, D) bf16,
// its segment ids (B, S) int32 and residuals m, l (B, H, S) f32, the
// cotangent dO (B, S, H, D) bf16 and di (B, H, S) f32; D 32 or a multiple
// of 64, S a multiple of 128, 16-byte aligned tensors.  Returns a
// cudaError_t: 1 (cudaErrorInvalidValue) for what it does not take.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* seg, const void* m, const void* l,
                                       const void* dout, const void* di, void* dk, void* dv,
                                       int B, int S, int H, int D, float scale, void* stream) {
  return launch<true>(q, k, v, seg, m, l, dout, di, dk, dv, B, S, H, D, scale, stream);
}

// dQ (B, S, H, D) bf16, from the same inputs as flash_attention_bwd_dkv.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* seg, const void* m, const void* l,
                                      const void* dout, const void* di, void* dq, int B, int S,
                                      int H, int D, float scale, void* stream) {
  return launch<false>(q, k, v, seg, m, l, dout, di, dq, nullptr, B, S, H, D, scale, stream);
}
