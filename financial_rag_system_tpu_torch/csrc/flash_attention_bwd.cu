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
// At a (64-row tile, 64-row block) step of D 32 each product is 0.26
// MFLOP, so what a step waits on (a load's latency, a product's) is what
// sets the time.  Heads of 32 and 64, every launch of the main paths, run
// unit::walk_kernel<D, DKV> (the design for the card):
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
// Heads of 128 and wider (no launch on the main paths) keep the first
// design, bwd_kernel<64, DKV>:
//  - a block of four warps for each (pair, head, 64-row tile of its own
//    side, piece of 64 head columns); each warp owns 16 of the tile's rows
//    and keeps its rows' gradient piece (16 x 64 f32) in registers
//    through the walk;
//  - the walk over the other side in 64-row blocks: the block's q and dO
//    (dK/dV) or K and V (dQ) are staged into shared memory with cp.async,
//    64 columns a chunk (rows padded by 16 bytes, so ldmatrix's eight rows
//    fall in distinct banks), beside the own tile's chunks; QK^T and dP
//    are summed over the head's chunks on mma.sync m16n8k16 (mma_bf16.cuh)
//    from ldmatrix fragments; p and dS feed the gradient products as A
//    fragments, with the staged rows' B fragments by ldmatrix.trans;
//  - each of the D / 64 pieces computes QK^T and dP over the whole head
//    again, with its own piece's chunk staged last so that it serves the
//    gradient products (at D 128 twice the QK^T and dP work, at D 384 six
//    times).
// Both skip a (tile, block) pair whose rows share no segment id (every p
// is 0, so it adds exactly 0), by the forward's presence masks of the ids
// in [0, 32) (any other id sets every bit).
// Liberties against jax's arithmetic, inside the tolerance the tests hold
// the kernels to (2^-7 of a gradient's largest value): exp as ex2.approx of
// one FFMA (s sm_scale log2e - m log2e), the zero select in place of the
// additive mask, and the f32 sums in another order (jax adds 128-row
// blocks in turn; here 64-row blocks, and chunks of the head).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

constexpr int kTile = 64;                // rows of the own tile, and of each block walked
constexpr int kWarps = kTile / 16;       // 16 own rows a warp
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

// W columns of the head a chunk; a row's bytes in shared memory, padded
template <int W>
struct Chunk {
  static constexpr int kRowB = 2 * W + 16;
  static constexpr int kBytes = kTile * kRowB;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows row0 .. row0 + 63 of one item's head, columns col0 .. col0 + W - 1,
// into a chunk buffer (src: the item's first element, tok: a token's stride)
template <int W>
__device__ __forceinline__ void stage(unsigned char* dst, const __nv_bfloat16* src, int row0,
                                      size_t tok, int col0) {
  constexpr int kSegs = W / 8;  // 16-byte pieces a row
  static_assert(kTile * kSegs % kThreads == 0, "every thread copies as many pieces");
#pragma unroll
  for (int it = 0; it < kTile * kSegs / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads, r = i / kSegs, c = i - r * kSegs;
    cp_async16(dst + r * Chunk<W>::kRowB + 16 * c, src + (size_t)(row0 + r) * tok + col0 + 8 * c);
  }
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

// acc[j] (+)= X (the warp's 16 own rows) . Y^T over one W-column chunk:
// Y's 64 rows are the accumulator's columns, eight n8 tiles
template <int W>
__device__ __forceinline__ void rows_by_rows(float (&acc)[8][4], const unsigned char* own,
                                             const unsigned char* oth, int warp, int lane) {
  constexpr int kRowB = Chunk<W>::kRowB;
  const unsigned char* a_at =
      own + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * kRowB + 16 * (lane >> 4);
  const unsigned char* b_at = oth + ((lane & 7) + 8 * (lane >> 4)) * kRowB + 16 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_at + 32 * kk);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, b_at + 16 * jp * kRowB + 32 * kk);
      mma_bf16(acc[2 * jp], a, b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// g += bf16(x) (the warp's 16 own rows x the walked block's 64 rows, in
// accumulator layout) . Y (the block's 64 rows x W columns, staged)
template <int W>
__device__ __forceinline__ void grad_product(float (&g)[W / 8][4], const float (&x)[8][4],
                                             const unsigned char* oth, int lane) {
  constexpr int kRowB = Chunk<W>::kRowB;
  const unsigned char* b_at = oth + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kRowB + 16 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < W / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, b_at + 16 * kk * kRowB + 32 * dp);
      mma_bf16(g[2 * dp], a, b[0], b[1]);
      mma_bf16(g[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// The gradient piece's rows (the warp's 16) to a (B, S, H, D) bf16 tensor
template <int W>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&g)[W / 8][4],
                                           size_t base, size_t tok, int r0, int col0, int lane) {
  const int ra = r0 + (lane >> 2), rb = ra + 8, t = lane & 3;
#pragma unroll
  for (int dn = 0; dn < W / 8; ++dn) {
    const int col = col0 + 8 * dn + 2 * t;
    *reinterpret_cast<uint32_t*>(out + base + (size_t)ra * tok + col) = pack_bf16(g[dn][0], g[dn][1]);
    *reinterpret_cast<uint32_t*>(out + base + (size_t)rb * tok + col) = pack_bf16(g[dn][2], g[dn][3]);
  }
}

// DKV: the own tile is 64 keys (K, V), the walk over q blocks (q, dO), and
// the outputs dK, dV; otherwise the own tile is 64 queries (q, dO), the
// walk over key blocks (K, V), and the output dQ.
template <int W, bool DKV>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
           const int32_t* __restrict__ seg, const float* __restrict__ res_m,
           const float* __restrict__ res_l, const float* __restrict__ di,
           __nv_bfloat16* __restrict__ g0, __nv_bfloat16* __restrict__ g1, int S, int H, int D,
           float scale) {
  using Ch = Chunk<W>;
  __shared__ __align__(16) unsigned char own[2][Ch::kBytes];  // K, V or q, dO
  __shared__ __align__(16) unsigned char oth[2][Ch::kBytes];  // q, dO or K, V
  __shared__ int oth_seg[kTile];
  __shared__ float oth_m2[kTile], oth_rl[kTile], oth_di[kTile];  // DKV: the q block's rows

  const int nc = D / W, T = S / kTile;
  int x = blockIdx.x;
  const int pc = x % nc;  // the block's piece of W columns
  x /= nc;
  const int tile = x % T;
  const int item = x / T;
  const int pair = item / H, hd = item - pair * H;
  const size_t tok = (size_t)H * D;
  const size_t base = (size_t)pair * S * tok + (size_t)hd * D;
  const size_t rows = (size_t)item * S;  // the item's rows of m, l, di
  const int32_t* srow = seg + (size_t)pair * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = tile * kTile;

  const __nv_bfloat16* own0 = (DKV ? k : q) + base;
  const __nv_bfloat16* own1 = (DKV ? v : dout) + base;
  const __nv_bfloat16* oth0 = (DKV ? q : k) + base;
  const __nv_bfloat16* oth1 = (DKV ? dout : v) + base;

  // the warp's own rows: segment ids and (dQ) the residuals
  int my_seg[2];
  float my_m2[2] = {0.f, 0.f}, my_rl[2] = {1.f, 1.f}, my_di[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + g + 8 * h;
    my_seg[h] = srow[r];
    if constexpr (!DKV) {
      my_m2[h] = res_m[rows + r] * kLog2e;
      my_rl[h] = 1.f / res_l[rows + r];
      my_di[h] = di[rows + r];
    }
  }
  const uint32_t own_p = presence(srow[r0 + lane], srow[r0 + 32 + lane]);
  const float c2 = scale * kLog2e;

  float ga[W / 8][4] = {};  // dK or dQ: the warp's rows, the piece's columns
  float gb[W / 8][4] = {};  // dV (DKV)
  for (int ob = 0; ob < T; ++ob) {
    const int b0 = ob * kTile;
    if ((presence(srow[b0 + lane], srow[b0 + 32 + lane]) & own_p) == 0) continue;
    float sc[8][4] = {}, dp[8][4] = {};
    for (int cc = 0; cc < nc; ++cc) {
      const int c = (pc + 1 + cc) % nc;  // the piece's own chunk last: it feeds the products
      __syncthreads();  // every warp is done with the buffers
      stage<W>(own[0], own0, r0, tok, c * W);
      stage<W>(own[1], own1, r0, tok, c * W);
      stage<W>(oth[0], oth0, b0, tok, c * W);
      stage<W>(oth[1], oth1, b0, tok, c * W);
      if (cc == 0) {
        const int r = threadIdx.x;
        if (r < kTile) {
          oth_seg[r] = srow[b0 + r];
          if constexpr (DKV) {
            oth_m2[r] = res_m[rows + b0 + r] * kLog2e;
            oth_rl[r] = 1.f / res_l[rows + b0 + r];
            oth_di[r] = di[rows + b0 + r];
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
      rows_by_rows<W>(sc, own[0], oth[0], warp, lane);  // QK^T (its transpose for dK/dV)
      rows_by_rows<W>(dp, own[1], oth[1], warp, lane);  // dP = dO V^T (transposed likewise)
    }
    // p and dS in place: element e of tile j is own row g + 8 (e >> 1),
    // walked row 8 j + 2 t + (e & 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, col = 8 * j + 2 * t + (e & 1);
        const float m2 = DKV ? oth_m2[col] : my_m2[h];
        const float rl = DKV ? oth_rl[col] : my_rl[h];
        const float d = DKV ? oth_di[col] : my_di[h];
        const float p = oth_seg[col] == my_seg[h] ? ex2(fmaf(sc[j][e], c2, -m2)) * rl : 0.f;
        sc[j][e] = p;
        dp[j][e] = (dp[j][e] - d) * p * scale;
      }
    }
    if constexpr (DKV) {
      grad_product<W>(gb, sc, oth[1], lane);  // dV += bf16(p)^T dO
      grad_product<W>(ga, dp, oth[0], lane);  // dK += bf16(dS)^T q
    } else {
      grad_product<W>(ga, dp, oth[0], lane);  // dQ += bf16(dS) K
    }
  }
  store_rows<W>(g0, ga, base, tok, r0 + 16 * warp, pc * W, lane);
  if constexpr (DKV) store_rows<W>(g1, gb, base, tok, r0 + 16 * warp, pc * W, lane);
}

// Heads of 128 and wider: D / 64 blocks a (pair, head, row tile)
template <bool DKV>
int launch_pieces(const void* q, const void* k, const void* v, const void* seg, const void* m,
                  const void* l, const void* dout, const void* di, void* g0, void* g1, int B,
                  int S, int H, int D, float scale, cudaStream_t st) {
  const long long blocks = (long long)B * H * (S / kTile) * (D / 64);
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  bwd_kernel<64, DKV><<<(int)blocks, kThreads, 0, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const int32_t*)seg, (const float*)m, (const float*)l,
      (const float*)di, (__nv_bfloat16*)g0, (__nv_bfloat16*)g1, S, H, D, scale);
  return (int)cudaGetLastError();
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
  return launch_pieces<DKV>(q, k, v, seg, m, l, dout, di, g0, g1, B, S, H, D, scale, st);
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
