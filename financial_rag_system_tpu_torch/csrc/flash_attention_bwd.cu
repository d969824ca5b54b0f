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
// The design here is the simple one that is right first (a TMA ring and
// wgmma are later work):
//  - a block of four warps for each (pair, head, 64-row tile of its own
//    side, piece of W head columns): the keys' tile for dK/dV, the
//    queries' for dQ; each warp owns 16 of the tile's rows and keeps its
//    rows' gradient piece (16 x W f32) in registers through the walk, so
//    nothing is summed across blocks: no atomics, and two runs give the
//    same bits;
//  - the walk over the other side in 64-row blocks: the block's q and dO
//    (dK/dV) or K and V (dQ) are staged into shared memory with cp.async,
//    W columns a chunk (rows padded by 16 bytes, so ldmatrix's eight rows
//    fall in distinct banks), beside the own tile's chunks; QK^T and dP
//    (the pair's dO . V^T) are summed over the head's chunks on mma.sync
//    m16n8k16 (mma_bf16.cuh) from ldmatrix fragments; p and dS are made in
//    the accumulators' registers and feed the gradient products as A
//    fragments, with the staged rows' B fragments by ldmatrix.trans;
//  - W = min(D, 64): at D 32 and 64 one piece, the own tile staged once; a
//    wider head is taken as D / 64 pieces (each block one), each computing
//    QK^T and dP over the whole head again, with its own piece's chunk
//    staged last so that it serves the gradient products (at D 128 twice
//    the QK^T and dP work, at D 384 six times);
//  - a (tile, block) pair whose rows share no segment id (every p is 0,
//    so it adds exactly 0) is skipped whole, by the forward's presence
//    masks of the ids in [0, 32) (any other id sets every bit).
// Liberties against jax's arithmetic, inside the tolerance the tests hold
// the kernels to (2^-7 of a gradient's largest value): exp as ex2.approx of
// one FFMA (s sm_scale log2e - m log2e), the zero select in place of the
// additive mask, and the f32 sums in another order (jax adds 128-row
// blocks in turn; here 64-row blocks, and chunks of the head).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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
  if (nc == 1) {  // the own tile's one chunk, staged once
    stage<W>(own[0], own0, r0, tok, 0);
    stage<W>(own[1], own1, r0, tok, 0);
  }
  for (int ob = 0; ob < T; ++ob) {
    const int b0 = ob * kTile;
    if ((presence(srow[b0 + lane], srow[b0 + 32 + lane]) & own_p) == 0) continue;
    float sc[8][4] = {}, dp[8][4] = {};
    for (int cc = 0; cc < nc; ++cc) {
      const int c = (pc + 1 + cc) % nc;  // the piece's own chunk last: it feeds the products
      __syncthreads();  // every warp is done with the buffers
      if (nc > 1) {
        stage<W>(own[0], own0, r0, tok, c * W);
        stage<W>(own[1], own1, r0, tok, c * W);
      }
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

template <bool DKV>
int launch(const void* q, const void* k, const void* v, const void* seg, const void* m,
           const void* l, const void* dout, const void* di, void* g0, void* g1, int B, int S,
           int H, int D, float scale, void* stream) {
  if (S < 128 || S % 128 != 0 || B < 1 || H < 1 || (D != 32 && (D < 64 || D % 64 != 0)) ||
      (long long)B * H > INT32_MAX || (long long)H * D > INT32_MAX ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout | (uintptr_t)g0 |
       (uintptr_t)(DKV ? g1 : g0)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int w = D == 32 ? 32 : 64;
  const long long blocks = (long long)B * H * (S / kTile) * (D / w);
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  auto args = [&](auto kernel) {
    kernel<<<(int)blocks, kThreads, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const __nv_bfloat16*)dout, (const int32_t*)seg, (const float*)m, (const float*)l,
        (const float*)di, (__nv_bfloat16*)g0, (__nv_bfloat16*)g1, S, H, D, scale);
  };
  if (w == 32)
    args(bwd_kernel<32, DKV>);
  else
    args(bwd_kernel<64, DKV>);
  return (int)cudaGetLastError();
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
