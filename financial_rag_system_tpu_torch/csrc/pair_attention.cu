// Pair self-attention for short-sequence BERT encoders with 32-wide heads.
//
// Replaces financial_rag_system_tpu/ops/attention.py:_attn_kernel (the
// Pallas kernel behind encoder_self_attention) and computes what it
// computes: q arrives pre-scaled by 1/sqrt(d) in f32 and rounded to bf16;
// logits are bf16 x bf16 products summed in f32 plus an additive -1e9
// key-padding bias; the softmax is a plain full-row f32 max/exp/sum (S <=
// 512, so no online rescaling: the row max is found first); the probs
// are rounded to bf16 for P.V, accumulated in f32, and the 1/sum divide is
// applied after P.V.  The context is stored as bf16.
//
// Bound on the H100 at the rerank shape (480 pairs x 400 tokens, 12 heads
// of 32): q, k, v in and the context out, 590 MB of bf16, take 0.18 ms at
// 3.35 TB/s; the 0.118 TFLOP of the two products take 0.12 ms at the 989
// TFLOP/s bf16 tensor-core peak.  It is memory bound once the (P, H, S, S)
// scores stay on chip.
// Design: the scores never leave the SM.  One block owns one (pair, head):
// it stages that head's K (row-major) and V (transposed) and the key bias
// row in shared memory once, padded so that the tensor-core fragment
// loads hit distinct banks, and its warps (8, fewer when S < 128) take 16
// query rows at a time.  A grid over blocks of 64 query rows would stage
// the same K and V seven times per (pair, head) at S = 400, and the
// staging, not the math, is the larger cost at head_dim 32.  Both products
// run on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate): a first sweep over the keys finds each row's max logit, a
// second recomputes the logits, takes exp(logit - max), sums the
// unrounded probs, and feeds the probs, rounded to bf16, straight from the
// accumulator registers into the P.V product.  Recomputing QK^T (32-deep)
// is cheaper than keeping a 400-wide row in registers.  Keys past S (the
// pad to 16) get a -inf bias and so a zero prob; query rows past S are
// neither loaded nor stored.
//
// Layout: q, k, v and out are (P, S, H, 32) bf16, contiguous; mask is
// (P, S) int32 key validity.  A fully masked pair stays finite: every
// logit carries the same -1e9 and the row max is subtracted first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kD = 32;         // head_dim
constexpr int kWarps = 8;      // most warps a block; 16 query rows each at a time
constexpr int kMaxS = 512;
constexpr int kKStride = 40;   // bf16 per staged K row (32 + 8 pad)

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One warp: 16 query rows [r0, r0 + 16) of one (pair, head) against all
// keys staged in shared memory.
__device__ __forceinline__ void attend_rows(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* ks, const __nv_bfloat16* vt, const float* bias,
    size_t base, size_t tok, int S, int sp, int vt_stride, int r0, int g, int t) {
  const int ra = r0 + g, rb = r0 + g + 8;  // this thread's two query rows

  uint32_t qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int c = kk * 16 + t * 2;
    qa[kk][0] = ra < S ? ld32(q + base + (size_t)ra * tok + c) : 0u;
    qa[kk][1] = rb < S ? ld32(q + base + (size_t)rb * tok + c) : 0u;
    qa[kk][2] = ra < S ? ld32(q + base + (size_t)ra * tok + c + 8) : 0u;
    qa[kk][3] = rb < S ? ld32(q + base + (size_t)rb * tok + c + 8) : 0u;
  }

  // sweep 1: row max of (logit + bias)
  float ma = -INFINITY, mb = -INFINITY;
  for (int n0 = 0; n0 < sp; n0 += 8) {
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat16* kr = ks + (n0 + g) * kKStride + t * 2;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) mma_bf16(sc, qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    const float b0 = bias[n0 + t * 2], b1 = bias[n0 + t * 2 + 1];
    ma = fmaxf(ma, fmaxf(sc[0] + b0, sc[1] + b1));
    mb = fmaxf(mb, fmaxf(sc[2] + b0, sc[3] + b1));
  }
  ma = quad_max(ma);
  mb = quad_max(mb);

  // sweep 2: probs, their sums, and P.V
  float o[4][4];
#pragma unroll
  for (int dn = 0; dn < 4; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float la = 0.f, lb = 0.f;
  for (int kc = 0; kc < sp; kc += 16) {
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat16* k0 = ks + (kc + g) * kKStride + t * 2;
    const __nv_bfloat16* k1 = k0 + 8 * kKStride;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      mma_bf16(s0, qa[kk], ld32(k0 + kk * 16), ld32(k0 + kk * 16 + 8));
      mma_bf16(s1, qa[kk], ld32(k1 + kk * 16), ld32(k1 + kk * 16 + 8));
    }
    const int key = kc + t * 2;
    const float c0 = bias[key], c1 = bias[key + 1], c8 = bias[key + 8], c9 = bias[key + 9];
    const float p00 = expf(s0[0] + c0 - ma), p01 = expf(s0[1] + c1 - ma);
    const float p02 = expf(s0[2] + c0 - mb), p03 = expf(s0[3] + c1 - mb);
    const float p10 = expf(s1[0] + c8 - ma), p11 = expf(s1[1] + c9 - ma);
    const float p12 = expf(s1[2] + c8 - mb), p13 = expf(s1[3] + c9 - mb);
    la += (p00 + p01) + (p10 + p11);
    lb += (p02 + p03) + (p12 + p13);
    // the two 16x8 logit tiles are exactly the 16x16 A fragment of P.V
    const uint32_t pa[4] = {pack_bf16(p00, p01), pack_bf16(p02, p03),
                            pack_bf16(p10, p11), pack_bf16(p12, p13)};
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      const __nv_bfloat16* vr = vt + (dn * 8 + g) * vt_stride + key;
      mma_bf16(o[dn], pa, ld32(vr), ld32(vr + 8));
    }
  }
  la = quad_sum(la);
  lb = quad_sum(lb);

#pragma unroll
  for (int dn = 0; dn < 4; ++dn) {
    const int c = dn * 8 + t * 2;
    if (ra < S)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)ra * tok + c) =
          pack_bf16(o[dn][0] / la, o[dn][1] / la);
    if (rb < S)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)rb * tok + c) =
          pack_bf16(o[dn][2] / lb, o[dn][3] / lb);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
pair_attention_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int32_t* __restrict__ mask,
                      __nv_bfloat16* __restrict__ out, int S, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = (S + 15) & ~15;         // keys padded to the P.V k-step
  const int vt_stride = sp + 8;          // (sp/2 + 4) words: conflict-free
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [sp][kKStride]
  __nv_bfloat16* vt = ks + sp * kKStride;                          // [kD][vt_stride]
  float* bias = reinterpret_cast<float*>(vt + kD * vt_stride);     // [sp]

  const int pair = blockIdx.x, head = blockIdx.y;
  const size_t tok = (size_t)H * kD;     // stride of one token
  const size_t base = (size_t)pair * S * tok + (size_t)head * kD;

  // stage K and V^T, 8 bf16 (16 bytes) at a time; zeros past S
  for (int i = threadIdx.x; i < sp * 4; i += blockDim.x) {
    const int s = i >> 2, c = (i & 3) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (s < S) {
      kv = *reinterpret_cast<const uint4*>(k + base + (size_t)s * tok + c);
      vv = *reinterpret_cast<const uint4*>(v + base + (size_t)s * tok + c);
    }
    *reinterpret_cast<uint4*>(ks + s * kKStride + c) = kv;
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
    for (int e = 0; e < 8; ++e) vt[(c + e) * vt_stride + s] = ve[e];
  }
  for (int s = threadIdx.x; s < sp; s += blockDim.x)
    bias[s] = s < S ? (mask[(size_t)pair * S + s] > 0 ? 0.0f : -1e9f) : -INFINITY;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int r0 = warp * 16; r0 < S; r0 += (blockDim.x >> 5) * 16)
    attend_rows(q, out, ks, vt, bias, base, tok, S, sp, vt_stride, r0, g, t);
}

size_t smem_bytes(int S) {
  const size_t sp = (size_t)((S + 15) & ~15);
  return sp * kKStride * sizeof(__nv_bfloat16) +
         (size_t)kD * (sp + 8) * sizeof(__nv_bfloat16) + sp * sizeof(float);
}

}  // namespace

// Returns a cudaError_t: 1 (cudaErrorInvalidValue) for shapes the kernel
// does not take, else the launch's own status.
extern "C" int pair_attention(const void* q, const void* k, const void* v,
                              const void* mask, void* out, int P, int S, int H,
                              int head_dim, void* stream) {
  if (head_dim != kD || S < 1 || S > kMaxS || P < 1 || H < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      pair_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int warps = min(kWarps, (S + 15) / 16);  // no idle warps at short S
  pair_attention_kernel<<<dim3(P, H), warps * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int32_t*)mask, (__nv_bfloat16*)out, S, H);
  return (int)cudaGetLastError();
}
