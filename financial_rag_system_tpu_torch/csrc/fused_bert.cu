// Fused encoder-block kernels: the QKV projection, the attention-output
// projection with residual and layernorm, and the FFN with residual and
// layernorm, each one pass over a row block of the (R, H) activation.
//
// Replaces financial_rag_system_tpu/ops/fused_bert.py:
//  - qkv_kernel      <- _qkv_kernel      q, k, v = bf16(x) W{q,k,v} + b{q,k,v}
//  - resid_ln_kernel <- _resid_ln_kernel y = LN(x + bf16(ctx) W_o + b_o)
//  - ffn_ln_kernel   <- _ffn_ln_kernel   y = LN(x + bf16(gelu_tanh(bf16(x) W_in + b_in)) W_out + b_out)
// and computes what they compute: bf16 operands with f32 sums on the
// tensor cores (mma.sync m16n8k16), bias, tanh GELU, residual and a
// two-pass layernorm (mean, then the mean square about it, then
// (v - mean) * rsqrt(var + eps) * scale + bias) in f32; outputs are f32.
//
// Bounds on the H100 at the rerank shape (R = 480 pairs x 400 tokens =
// 192,000 rows, H 384, I 1536), at 3.35 TB/s and 989 TFLOP/s bf16:
//  - ffn_ln: 4 R H I = 4.53e11 operations, 0.458 ms: bound by operations
//    once the (R, I) activation stays on chip (x and y f32, 590 MB, take
//    0.176 ms);
//  - qkv: x in and three f32 outputs, 1.18 GB, 0.352 ms: bound by bytes;
//  - resid_ln: x, ctx and y, 885 MB with an f32 ctx (737 MB with bf16),
//    0.264 ms (0.220 ms): bound by bytes.
// Design: a block owns 64 rows and loops over the weight inside itself;
// blocks carry nothing between them (the TPU kernel's grid runs in order,
// Hopper's blocks do not).  Its 8 warps split the rows in two halves of
// 32 and the columns in four quarters.  The activation tile is rounded to
// bf16 once into shared memory; weight pieces arrive with cp.async, in
// nn.Linear's (out, in) layout, which is the column-major B operand that
// mma.sync .row.col takes, and the next piece loads while the current one
// is multiplied.  Every staged row is padded by 8 bf16 so that the
// fragment loads (8 rows x 4 words) hit 32 distinct banks.
//  - ffn_ln walks I in chunks of 64: up = x W_in[chunk] (a warp: 32 rows x
//    16 columns), + b_in, GELU, rounded to bf16 in shared memory, then
//    acc += up W_out[:, chunk] into a 64 x H f32 accumulator held in
//    registers (a warp: 32 rows x H/4 columns).  The (R, I) activation
//    never reaches device memory, which is the whole point of the TPU
//    kernel.  W_out's chunk loads during the first product, the next
//    W_in chunk during the second.
//  - resid_ln stages ctx (f32 or bf16) once and walks W_o in double-
//    buffered 64-deep pieces into the same 64 x H accumulator.
//  - qkv stages x once and walks the 3H output columns in double-buffered
//    chunks of 64, storing each 64 x 64 result with its bias.
// The layernorm reduces a row within a quad of lanes by shuffles, then
// across the four column-quarter warps through shared memory.  Rows past
// R are staged as zeros and never read or stored: no padded copy.
// Shapes: H a multiple of 64 up to 512 (the accumulator is compiled for
// each), I a multiple of 64; anything else returns cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBM = 64;         // rows a block
constexpr int kBN = 64;         // columns (or depth) of one weight piece
constexpr int kThreads = 256;   // 8 warps: 2 row halves x 4 column quarters
constexpr int kPad = 8;         // bf16 padding of every staged row

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// jax.nn.gelu(approximate=True), in f32
__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

// Start the copy of a rows x cols piece of a row-major bf16 matrix (row
// stride ld) into shared memory [rows][cols + kPad], 16 bytes a copy.
__device__ __forceinline__ void stage_async(bf16* dst, const bf16* src, int rows, int cols,
                                            int ld) {
  const int vecs = cols / 8;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs, c = (i - r * vecs) * 8;
    cp_async16(dst + r * (cols + kPad) + c, src + (size_t)r * ld + c);
  }
}

// Rows [row0, row0 + kBM) of an (R, H) f32 matrix, rounded to bf16, into
// shared memory [kBM][H + kPad]; rows past R are zeros.
__device__ __forceinline__ void stage_rows(bf16* dst, const float* src, int row0, int R, int H) {
  const int vecs = H / 4;
  for (int i = threadIdx.x; i < kBM * vecs; i += kThreads) {
    const int r = i / vecs, c = (i - r * vecs) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < R) v = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * H + c);
    *reinterpret_cast<uint2*>(dst + r * (H + kPad) + c) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// The same for a bf16 matrix: a copy.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int row0, int R, int H) {
  const int vecs = H / 8;
  for (int i = threadIdx.x; i < kBM * vecs; i += kThreads) {
    const int r = i / vecs, c = (i - r * vecs) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < R) v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * H + c);
    *reinterpret_cast<uint4*>(dst + r * (H + kPad) + c) = v;
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[2][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
}

// One warp: acc (32 rows x NT*8 columns) += A[32 rows][0, K) * B[NT*8 rows][0, K)^T.
// A is the warp's first activation row, B its first output column's
// weight row (nn.Linear layout), both in shared memory with strides in
// bf16.  acc[mt][nt][2*hf + e] is row mt*16 + hf*8 + g, column nt*8 + 2t + e.
template <int NT>
__device__ __forceinline__ void warp_mma(float (&acc)[2][NT][4], const bf16* A, int lda,
                                         const bf16* B, int ldb, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* a0 = A + g * lda + t * 2;
  const bf16* b0 = B + g * ldb + t * 2;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const bf16* p = a0 + mt * 16 * lda + k0;
      a[mt][0] = ld32(p);
      a[mt][1] = ld32(p + 8 * lda);
      a[mt][2] = ld32(p + 8);
      a[mt][3] = ld32(p + 8 * lda + 8);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* p = b0 + nt * 8 * ldb + k0;
      const uint32_t lo = ld32(p), hi = ld32(p + 8);
      mma_bf16(acc[0][nt], a[0], lo, hi);
      mma_bf16(acc[1][nt], a[1], lo, hi);
    }
  }
}

// Totals over a row's H columns of the per-thread partials p[mt][hf]: a
// quad of lanes holds a warp's quarter of the row; the four quarter
// warps meet in red [kBM][4].
__device__ __forceinline__ void row_totals(float (&p)[2][2], float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      p[mt][hf] = quad_sum(p[mt][hf]);
      if (t == 0) red[(wm * 32 + mt * 16 + hf * 8 + g) * 4 + wn] = p[mt][hf];
    }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float* r = red + (wm * 32 + mt * 16 + hf * 8 + g) * 4;
      p[mt][hf] = (r[0] + r[1]) + (r[2] + r[3]);
    }
  __syncthreads();  // red is written again by the next call
}

// y = LN(x + (acc + bias)) for the block's 64 x H accumulator, stored to
// rows [row0, min(row0 + kBM, R)) of y.
template <int H>
__device__ __forceinline__ void residual_ln_store(float (&acc)[2][H / 32][4],
                                                  const float* __restrict__ x,
                                                  const float* __restrict__ bias,
                                                  const float* __restrict__ ln_s,
                                                  const float* __restrict__ ln_b, float eps,
                                                  float* __restrict__ y, int row0, int R,
                                                  float* red) {
  constexpr int NT = H / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const int col0 = wn * (H / 4) + t * 2;
  float s[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + wm * 32 + mt * 16 + hf * 8 + g;
      s[mt][hf] = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = col0 + nt * 8;
        const float2 bv = *reinterpret_cast<const float2*>(bias + c);
        float2 xv = make_float2(0.f, 0.f);
        if (row < R) xv = *reinterpret_cast<const float2*>(x + (size_t)row * H + c);
        acc[mt][nt][2 * hf] = xv.x + (acc[mt][nt][2 * hf] + bv.x);
        acc[mt][nt][2 * hf + 1] = xv.y + (acc[mt][nt][2 * hf + 1] + bv.y);
        s[mt][hf] += acc[mt][nt][2 * hf] + acc[mt][nt][2 * hf + 1];
      }
    }
  row_totals(s, red);
  float mu[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mu[mt][hf] = s[mt][hf] / H;
      s[mt][hf] = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float d0 = acc[mt][nt][2 * hf] - mu[mt][hf];
        const float d1 = acc[mt][nt][2 * hf + 1] - mu[mt][hf];
        s[mt][hf] += d0 * d0 + d1 * d1;
      }
    }
  row_totals(s, red);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + wm * 32 + mt * 16 + hf * 8 + g;
      if (row >= R) continue;
      const float rstd = rsqrtf(s[mt][hf] / H + eps);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = col0 + nt * 8;
        const float2 sc = *reinterpret_cast<const float2*>(ln_s + c);
        const float2 lb = *reinterpret_cast<const float2*>(ln_b + c);
        float2 out;
        out.x = (acc[mt][nt][2 * hf] - mu[mt][hf]) * rstd * sc.x + lb.x;
        out.y = (acc[mt][nt][2 * hf + 1] - mu[mt][hf]) * rstd * sc.y + lb.y;
        *reinterpret_cast<float2*>(y + (size_t)row * H + c) = out;
      }
    }
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
ffn_ln_kernel(const float* __restrict__ x, const bf16* __restrict__ w_in,
              const float* __restrict__ b_in, const bf16* __restrict__ w_out,
              const float* __restrict__ b_out, const float* __restrict__ ln_s,
              const float* __restrict__ ln_b, float eps, float* __restrict__ y, int R, int I) {
  constexpr int XS = H + kPad, CS = kBN + kPad;  // staged row strides, bf16
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [kBM][XS] x
  bf16* wis = xs + kBM * XS;                     // [kBN][XS] the chunk's W_in rows
  bf16* wos = wis + kBN * XS;                    // [H][CS]   the chunk's W_out columns
  bf16* ups = wos + H * CS;                      // [kBM][CS] gelu(up)
  float* red = reinterpret_cast<float*>(ups + kBM * CS);  // [kBM][4]

  const int row0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;

  stage_async(wis, w_in, kBN, H, H);
  cp_async_commit();
  stage_rows(xs, x, row0, R, H);

  float acc[2][H / 32][4];
  zero(acc);
  const int chunks = I / kBN;
  for (int c = 0; c < chunks; ++c) {
    stage_async(wos, w_out + (size_t)c * kBN, H, kBN, I);
    cp_async_commit();
    cp_async_wait<1>();  // the chunk's W_in has landed
    __syncthreads();
    float up[2][2][4];
    zero(up);
    warp_mma(up, xs + wm * 32 * XS, XS, wis + wn * 16 * XS, XS, H);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = wn * 16 + nt * 8 + t * 2;
        const float b0 = b_in[c * kBN + col], b1 = b_in[c * kBN + col + 1];
        bf16* u = ups + (wm * 32 + mt * 16 + g) * CS + col;
        *reinterpret_cast<uint32_t*>(u) =
            pack_bf16(gelu_tanh(up[mt][nt][0] + b0), gelu_tanh(up[mt][nt][1] + b1));
        *reinterpret_cast<uint32_t*>(u + 8 * CS) =
            pack_bf16(gelu_tanh(up[mt][nt][2] + b0), gelu_tanh(up[mt][nt][3] + b1));
      }
    __syncthreads();  // W_in read, up written
    if (c + 1 < chunks) {
      stage_async(wis, w_in + (size_t)(c + 1) * kBN * H, kBN, H, H);
      cp_async_commit();
      cp_async_wait<1>();  // the chunk's W_out has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    warp_mma(acc, ups + wm * 32 * CS, CS, wos + wn * (H / 4) * CS, CS, kBN);
    __syncthreads();  // W_out and up read before the next chunk overwrites them
  }
  residual_ln_store<H>(acc, x, b_out, ln_s, ln_b, eps, y, row0, R, red);
}

template <int H, typename CtxT>
__global__ void __launch_bounds__(kThreads, 1)
resid_ln_kernel(const float* __restrict__ x, const CtxT* __restrict__ ctx,
                const bf16* __restrict__ w, const float* __restrict__ b,
                const float* __restrict__ ln_s, const float* __restrict__ ln_b, float eps,
                float* __restrict__ y, int R) {
  constexpr int XS = H + kPad, CS = kBN + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);  // [kBM][XS] ctx
  bf16* ws = cs + kBM * XS;                      // [2][H][CS] pieces of W_o
  float* red = reinterpret_cast<float*>(ws + 2 * H * CS);

  const int row0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;

  stage_async(ws, w, H, kBN, H);
  cp_async_commit();
  stage_rows(cs, ctx, row0, R, H);

  float acc[2][H / 32][4];
  zero(acc);
  constexpr int pieces = H / kBN;
  for (int c = 0; c < pieces; ++c) {
    if (c + 1 < pieces) {
      stage_async(ws + ((c + 1) & 1) * H * CS, w + (c + 1) * kBN, H, kBN, H);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    warp_mma(acc, cs + wm * 32 * XS + c * kBN, XS, ws + (c & 1) * H * CS + wn * (H / 4) * CS, CS,
             kBN);
    __syncthreads();  // the piece is read before it is overwritten
  }
  residual_ln_store<H>(acc, x, b, ln_s, ln_b, eps, y, row0, R, red);
}

__global__ void __launch_bounds__(kThreads, 1)
qkv_kernel(const float* __restrict__ x, const bf16* __restrict__ wq,
           const float* __restrict__ bq, const bf16* __restrict__ wk,
           const float* __restrict__ bk, const bf16* __restrict__ wv,
           const float* __restrict__ bv, float* __restrict__ q, float* __restrict__ k,
           float* __restrict__ v, int R, int H) {
  const int XS = H + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [kBM][XS] x
  bf16* ws = xs + kBM * XS;                      // [2][kBN][XS] weight rows of a chunk

  const int row0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const int per = H / kBN, chunks = 3 * per;  // output chunks of q, then k, then v

  stage_async(ws, wq, kBN, H, H);
  cp_async_commit();
  stage_rows(xs, x, row0, R, H);

  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      const int n = c + 1, p = n / per;
      const bf16* wn_src = (p == 0 ? wq : p == 1 ? wk : wv) + (size_t)(n - p * per) * kBN * H;
      stage_async(ws + (n & 1) * kBN * XS, wn_src, kBN, H, H);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float acc[2][2][4];
    zero(acc);
    warp_mma(acc, xs + wm * 32 * XS, XS, ws + (c & 1) * kBN * XS + wn * 16 * XS, XS, H);
    const int p = c / per;
    float* out = p == 0 ? q : p == 1 ? k : v;
    const float* bias = p == 0 ? bq : p == 1 ? bk : bv;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = (c - p * per) * kBN + wn * 16 + nt * 8 + t * 2;
        const float b0 = bias[col], b1 = bias[col + 1];
        const int row = row0 + wm * 32 + mt * 16 + g;
        if (row < R)
          *reinterpret_cast<float2*>(out + (size_t)row * H + col) =
              make_float2(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
        if (row + 8 < R)
          *reinterpret_cast<float2*>(out + (size_t)(row + 8) * H + col) =
              make_float2(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
      }
    __syncthreads();  // the chunk is read before it is overwritten
  }
}

bool takes(int R, int H) { return R >= 1 && H >= kBN && H <= 512 && H % kBN == 0; }

dim3 grid(int R) { return dim3((unsigned)((R + kBM - 1) / kBM)); }

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int H>
int launch_ffn(const float* x, const bf16* w_in, const float* b_in, const bf16* w_out,
               const float* b_out, const float* ln_s, const float* ln_b, float eps, float* y,
               int R, int I, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * ((size_t)(kBM + kBN) * (H + kPad) +
                                      (size_t)(H + kBM) * (kBN + kPad)) +
                      sizeof(float) * kBM * 4;
  cudaError_t err = set_smem(ffn_ln_kernel<H>, smem);
  if (err != cudaSuccess) return (int)err;
  ffn_ln_kernel<H><<<grid(R), kThreads, smem, stream>>>(x, w_in, b_in, w_out, b_out, ln_s, ln_b,
                                                        eps, y, R, I);
  return (int)cudaGetLastError();
}

template <int H, typename CtxT>
int launch_resid(const float* x, const void* ctx, const bf16* w, const float* b,
                 const float* ln_s, const float* ln_b, float eps, float* y, int R,
                 cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * ((size_t)kBM * (H + kPad) + 2 * (size_t)H * (kBN + kPad)) +
                      sizeof(float) * kBM * 4;
  cudaError_t err = set_smem(resid_ln_kernel<H, CtxT>, smem);
  if (err != cudaSuccess) return (int)err;
  resid_ln_kernel<H, CtxT><<<grid(R), kThreads, smem, stream>>>(
      x, static_cast<const CtxT*>(ctx), w, b, ln_s, ln_b, eps, y, R);
  return (int)cudaGetLastError();
}

}  // namespace

#define FUSED_BERT_WIDTHS(X) X(64) X(128) X(192) X(256) X(320) X(384) X(448) X(512)

// Each entry returns a cudaError_t: 1 (cudaErrorInvalidValue) for shapes
// the kernel does not take, else the launch's own status.  Weights are
// bf16 in nn.Linear's (out, in) layout; everything else is f32 except a
// bf16 ctx (ctx_bf16 != 0).  All tensors are contiguous.

extern "C" int fused_qkv(const void* x, const void* wq, const void* bq, const void* wk,
                         const void* bk, const void* wv, const void* bv, void* q, void* k,
                         void* v, int R, int H, void* stream) {
  if (!takes(R, H)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(bf16) * (size_t)(kBM + 2 * kBN) * (H + kPad);
  cudaError_t err = set_smem(qkv_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  qkv_kernel<<<grid(R), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const bf16*)wq, (const float*)bq, (const bf16*)wk, (const float*)bk,
      (const bf16*)wv, (const float*)bv, (float*)q, (float*)k, (float*)v, R, H);
  return (int)cudaGetLastError();
}

extern "C" int fused_resid_ln(const void* x, const void* ctx, int ctx_bf16, const void* w,
                              const void* b, const void* ln_s, const void* ln_b, float eps,
                              void* y, int R, int H, void* stream) {
  if (!takes(R, H)) return (int)cudaErrorInvalidValue;
#define RESID_CASE(W)                                                                         \
  case W:                                                                                     \
    return ctx_bf16 ? launch_resid<W, bf16>((const float*)x, ctx, (const bf16*)w,            \
                                            (const float*)b, (const float*)ln_s,              \
                                            (const float*)ln_b, eps, (float*)y, R,            \
                                            (cudaStream_t)stream)                             \
                    : launch_resid<W, float>((const float*)x, ctx, (const bf16*)w,           \
                                             (const float*)b, (const float*)ln_s,             \
                                             (const float*)ln_b, eps, (float*)y, R,           \
                                             (cudaStream_t)stream);
  switch (H) { FUSED_BERT_WIDTHS(RESID_CASE) }
#undef RESID_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int fused_ffn_ln(const void* x, const void* w_in, const void* b_in, const void* w_out,
                            const void* b_out, const void* ln_s, const void* ln_b, float eps,
                            void* y, int R, int H, int I, void* stream) {
  if (!takes(R, H) || I < kBN || I % kBN != 0) return (int)cudaErrorInvalidValue;
#define FFN_CASE(W)                                                                           \
  case W:                                                                                     \
    return launch_ffn<W>((const float*)x, (const bf16*)w_in, (const float*)b_in,              \
                         (const bf16*)w_out, (const float*)b_out, (const float*)ln_s,         \
                         (const float*)ln_b, eps, (float*)y, R, I, (cudaStream_t)stream);
  switch (H) { FUSED_BERT_WIDTHS(FFN_CASE) }
#undef FFN_CASE
  return (int)cudaErrorInvalidValue;
}
