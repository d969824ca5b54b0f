// Fused encoder-block kernels: the QKV projection, the attention-output
// projection with residual and layernorm, and the FFN with residual and
// layernorm, each one pass over the (R, H) activation.
//
// Replaces financial_rag_system_tpu/ops/fused_bert.py:
//  - qkv_kernel      <- :73 _qkv_kernel      q, k, v = bf16(x) W{q,k,v} + b{q,k,v}
//  - resid_ln_kernel <- :89 _resid_ln_kernel y = LN(x + bf16(ctx) W_o + b_o)
//  - ffn_ln_kernel   <- :47 _ffn_ln_kernel   y = LN(x + bf16(gelu_tanh(bf16(x) W_in + b_in)) W_out + b_out)
// and computes what they compute: bf16 operands with f32 sums on the
// tensor cores, bias, tanh GELU, residual and a two-pass layernorm (mean,
// then the mean square about it, then (v - mean) * rsqrt(var + eps) *
// scale + bias) in f32; outputs are f32.
//
// Bounds on the H100 at the rerank shape (R = 480 pairs x 400 tokens =
// 192,000 rows, H 384, I 1536), at 3.35 TB/s and 989 TFLOP/s bf16:
//  - ffn_ln: 4 R H I = 4.53e11 operations, 0.458 ms: bound by operations
//    once the (R, I) activation stays on chip (x and y f32, 590 MB, take
//    0.176 ms);
//  - qkv: x in and three f32 outputs, 1.18 GB, 0.352 ms: bound by bytes
//    (its 1.70e11 operations take 0.172 ms);
//  - resid_ln: x, ctx and y, 885 MB with an f32 ctx (737 MB with bf16),
//    0.264 ms (0.220 ms): bound by bytes.
//
// qkv_kernel is built for Hopper.  The 3H output columns are cut into
// slices of BN (192 at H 384; a slice lies inside one of q, k, v).  A
// persistent block holds one slice's bf16 weights in shared memory for its
// whole life (147 KB at H 384), read from L2 once, where a block of the
// first design re-read all 884 KB for every 64 rows.  It walks row tiles
// of 64: block i takes slice i % slices and tiles i / slices,
// + ctas / slices, ..., so the blocks that read one x tile run side by
// side and all but the first find it in L2.  Two consumer warpgroups take
// alternate tiles, each through its own ring of shared-memory stages that
// a producer warp of its own fills: one thread issues TMA loads of the f32
// x tile in 64 x 32 boxes (128 B rows, 128-byte swizzle; rows past R
// arrive as zeros), with full and empty mbarriers.  A consumer reads a
// chunk of boxes' A fragments from shared memory, rounds them to bf16 in
// registers, frees the stages, and issues wgmma m64nBNk16 with A from
// registers and B, the resident slice, K-major from shared memory; sums
// stay in f32 registers over K = H.  The epilogue adds the bias into a
// 64 x 32 output box in shared memory (128-byte swizzle) and TMA stores
// it into the (3, R, H) output, full 128-byte lines; the map's bounds
// drop rows past R.  Measured on the H100 (PERF.md): neither device
// memory nor L2 sets its pace.  Multicasting each x box to a cluster of
// blocks cut the L2 traffic and ran slower, and prefetching x into L2
// changed nothing.  What holds it is each consumer's serial round of
// waiting for boxes, converting them and draining its wgmmas, which two
// warpgroups only partly overlap: A fragments loaded while wgmmas run are
// serialised by ptxas, and the 147 KB slice leaves room for eight boxes
// in flight.
//
// resid_ln_kernel: a block owns 64 rows and loops over the weight inside
// itself; blocks carry nothing between them (the TPU kernel's grid runs in
// order, Hopper's blocks do not).  Its 8 warps split the rows in two
// halves of 32 and the columns in four quarters (mma.sync m16n8k16).  ctx
// is rounded to bf16 once into shared memory (f32 or bf16 in); W_o
// arrives with cp.async in double-buffered 64-deep pieces, in nn.Linear's
// (out, in) layout, which is the column-major B operand that mma.sync
// .row.col takes, into a 64 x H f32 accumulator held in registers.  Every
// staged row is padded by 8 bf16 so that the fragment loads (8 rows x 4
// words) hit 32 distinct banks.  The layernorm reduces a row within a
// quad of lanes by shuffles, then across the four column-quarter warps
// through shared memory.  Rows past R are staged as zeros and never read
// or stored: no padded copy.
//
// ffn_ln_kernel is built for Hopper.  Its budget at the rerank shape:
//  - operations: 4 R H I = 4.53e11, 0.458 ms at 989 TFLOP/s, the bound;
//    x in and y out (f32) are 590 MB, 0.176 ms at 3.35 TB/s.  The (R, I)
//    activation never leaves the SM, which is the whole point of the TPU
//    kernel.
//  - registers: a warpgroup's 64 x H f32 accumulator is H / 2 registers
//    a thread, 192 at H 384.  setmaxnreg gives the two consumer
//    warpgroups 240 a thread and the producer warpgroup 24 (240 x 256 +
//    24 x 128 = 64,512 of the SM's 65,536).  Beside 192, a 64 x 64 up
//    accumulator (32 more) made ptxas spill and serialise every wgmma
//    (C7512); a 64 x 32 one (16) fits, so I is walked in chunks of 32,
//    and GEMM1's two chains over K (below) take turns in it.
//  - L2: a block reads all of W_in and W_out (2.36 MB at H 384, I 1536)
//    once per tile; with 128-row tiles that is 3.5 TB at the rerank shape,
//    where 64-row tiles would draw 7.1 TB.
//  - shared-memory bandwidth (128 B a clock an SM): GEMM1 is wgmma
//    m64n32k16 with both operands in shared memory, 192 B/clk at the
//    tensor cores' peak, so it runs at 2/3 of it at best; GEMM2 is
//    m64nNk16 with A from registers, 64 B/clk.
//  - the GELU, R I = 2.95e8 values: tanh as 1 - 2 / (e^2u + 1) on
//    ex2.approx and a fast reciprocal, as exact as tanhf here and nearly
//    as fast as tanh.approx.f32, whose error triples the outputs more than
//    1e-3 off and puts one past the tolerance (tools/ffn_ln_variants.py,
//    PERF.md).
// Design.  Persistent blocks of 384 threads, one an SM, walk units of (row
// tile, I split): unit blockIdx.x, + gridDim.x, ...  A producer
// warpgroup: warp 0 streams the unit's weight pieces by TMA, in the order
// W_in(c), W_out(c), W_in(c + 1), ... for the unit's I chunks c, into a
// ring of pieces (a chunk's rows of W_in or columns of W_out, H wide), a
// full mbarrier a TMA box and an empty one a piece; warps 1 and 2 each
// stream one consumer warpgroup's rows of x in f32 boxes of 64 rows x 32
// (128-byte swizzle; rows past R arrive as zeros) into two slots, and
// prefetch the next unit's rows into L2.  Two consumer warpgroups.  At a
// unit's start each converts its boxes: the bf16 values into the x tile
// (the K-major, 128-byte-swizzled A operand of GEMM1, staged once a tile),
// the f32 values plus b_out into its accumulator (the residual and the
// bias, so the epilogue reads no x: re-reading it there cost more).  Two
// plans of the kernel, chosen on the host (ops/fused_bert.py ffn_plan):
//  - H <= 384: row tiles of 128, each consumer warpgroup 64 rows x all H,
//    I in chunks of 32.  Per chunk: GEMM1 (up = x W_in(c)^T, 64 x 32, both
//    operands in shared memory) as two chains over the halves of K, each
//    waited for, the first's sums parked in shared memory and added to
//    the second's in f32 (one chain over all of K strays further from an
//    f32 sum than the tolerance allows); + b_in and GELU, rounded to
//    bf16 in registers that are exactly the A fragments of wgmma with A
//    from registers (FA3's P), so up never touches shared memory; GEMM2
//    (acc += up W_out(c)^T, wgmmas of N 192, 128 or 64, W_out's piece in
//    64-byte rows), waited for.  One wgmma group is in flight a warpgroup
//    (a second does not fit in registers); the other warpgroup's fills the
//    tensor cores while this one waits or GELUs.
//  - H 448 and 512, where the accumulator would not fit, and H 384 where
//    128-row tiles would be too few to fill the card: a tile is 64 rows, I is in chunks of 64, and the two warpgroups
//    split H: each computes 32 of a chunk's 64 up columns (m64n32k16, the
//    two chains over K in flight together in accumulators of their own),
//    writes them GELU'd as bf16 into a shared up tile, and after a barrier
//    runs GEMM2 (m64n(H/2)k16, both operands in shared memory) into its
//    half of the columns, GEMM1 of the next chunk in flight beside it; the
//    layernorm's row sums meet through shared memory.
// Every wgmma wait is on a fixed-count path (ptxas serialises otherwise).
// Epilogue: a row lies in one quad of lanes in the wgmma accumulator
// layout, so the layernorm's row sums are quad shuffles (with H split, the
// two halves meet through shared memory).  With row tiles of 128, y goes
// out by TMA through the warpgroup's rows of the x tile, free once its
// last GEMM1 is done, and the map's bounds drop rows past R; the H-split
// plan stores y from registers (full 32-byte sectors), rows past R
// dropped.
// Few row tiles (the embed shape, R 1,024: 16 tiles of 64): the plan splits I
// over `splits` blocks a tile so that tiles x splits fills the card.  Each
// block stores its partial sums (the split-0 block's include x and b_out)
// to a workspace in the accumulator's own layout, then takes an atomic
// ticket; the last block of the tile streams the tile's partials back by
// TMA through the x tile and the weight ring, sums them in split order,
// so the result is the same bit for bit from launch to launch, and runs
// the epilogue; it sets the ticket back to 0 for the next launch.
// Measured (PERF.md): 2.4x the first design at the rerank shape, 2.8x the
// bound; GEMM1's narrow wgmmas in two chains with a drain between them,
// one wgmma group in flight a warpgroup and the epilogue (about a ninth)
// hold it.
// Shapes: H a multiple of 64 up to 512, I a multiple of 64; anything else
// returns cudaErrorInvalidValue, as does a plan the kernel cannot run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mma_bf16.cuh"
#include "sm90.cuh"

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

bool takes(int R, int H) { return R >= 1 && H >= kBN && H <= 512 && H % kBN == 0; }

dim3 grid(int R) { return dim3((unsigned)((R + kBM - 1) / kBM)); }

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// -- QKV: persistent, resident weight slice, TMA-fed x, wgmma -------------

constexpr int kQkvRows = 64;                           // rows of a tile: one wgmma M
constexpr int kBoxCols = 32;                           // f32 columns of an x box: 128 B
constexpr int kBoxBytes = kQkvRows * kBoxCols * 4;     // 8 KB
constexpr int kConsumers = 2;                          // consumer warpgroups
constexpr int kQkvThreads = kConsumers * (128 + 32);    // + one producer warp each
constexpr int kSmemLimit = 232448;                     // a block's shared memory on the H100

// Bytes of dynamic shared memory: 1 KB to align to the swizzle's 1024-B
// atoms, the weight slice, the x ring, one output box per consumer and
// the ring's 2 * stages + 1 barriers.
size_t qkv_smem(int H, int BN, int stages) {
  return 1024 + (size_t)BN * H * 2 + (size_t)(stages + kConsumers) * kBoxBytes +
         (2 * stages + 1) * 8;
}

// Boxes whose A fragments a consumer warpgroup holds at once (8 registers
// a box): the wgmmas of a chunk issue in one pipeline stage, and no A
// register is written while a wgmma that reads it is in flight.
template <int BN>
__host__ __device__ constexpr int qkv_chunk_boxes() { return BN == 192 ? 3 : BN == 128 ? 4 : 2; }

// One chunk of a consumer warpgroup's tile: for each of its G boxes (32
// columns of the x tile, two 16-deep wgmma steps) wait for the box, read
// its A fragments into registers rounded to bf16 and free the stage; then
// issue the chunk's 2G wgmmas against the resident weight slice.  A box
// lies at [64 rows][128 B] with TMA's 128-byte swizzle: the 16-B granule
// j of row r sits at granule j ^ (r % 8).  `n` counts the boxes taken
// from the ring, `box0` is the chunk's first box in the tile.
template <int BN, int G>
__device__ __forceinline__ void qkv_chunk(float (&acc)[BN / 2], const unsigned char* xs,
                                          uint64_t* full, uint64_t* empty, int ring, int n,
                                          const unsigned char* ws, int box0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + g;  // rows r0 and r0 + 8: both swizzle by g
  uint32_t a[G][2][4];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int s = (n + i) % ring;
    mbar_wait(&full[s], ((n + i) / ring) & 1);
    const unsigned char* box = xs + (size_t)s * kBoxBytes;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // columns 2t (a[0], a[1]), 2t + 8 (a[2], a[3])
        const int c = kk * 16 + half * 8 + 2 * t;
        const int off = (((c >> 2) ^ g) << 4) + ((c & 3) << 2);
        const float2 lo = *reinterpret_cast<const float2*>(box + r0 * 128 + off);
        const float2 hi = *reinterpret_cast<const float2*>(box + (r0 + 8) * 128 + off);
        a[i][kk][2 * half] = pack_bf16(lo.x, lo.y);
        a[i][kk][2 * half + 1] = pack_bf16(hi.x, hi.y);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the fragments are in registers
  }
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int b = box0 + i;  // 32 columns deep: half of a 64-deep weight piece
    const unsigned char* piece = ws + (size_t)(b / 2) * BN * 128 + (b & 1) * 64;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_rs(acc, a[i][kk], wgmma_desc_sw128(piece + kk * 32), (b == 0 && kk == 0) ? 0u : 1u);
  }
  wgmma_commit();
}

template <int BN>
__global__ void __launch_bounds__(kQkvThreads, 1)
qkv_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
           const __grid_constant__ CUtensorMap omap, const float* __restrict__ bias, int R, int H,
           int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ws = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* xs = ws + (size_t)BN * H * 2;  // [stages][64 rows][128 B]
  unsigned char* os = xs + (size_t)stages * kBoxBytes;  // [kConsumers][64 rows][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(os + (size_t)kConsumers * kBoxBytes);
  uint64_t* empty = full + stages;
  uint64_t* wbar = empty + stages;

  const int slices = 3 * H / BN, slice = blockIdx.x % slices;
  const int tiles = (R + kQkvRows - 1) / kQkvRows;
  const int first_tile = blockIdx.x / slices, tile_step = gridDim.x / slices;
  const int boxes = H / kBoxCols;          // per tile
  const int ring = stages / kConsumers;    // stages of each consumer's ring
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per warp of the consuming warpgroup
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // Tile j of the block goes to consumer j % kConsumers, through that
  // consumer's own ring of stages, which a producer warp of its own fills:
  // each ring is filled and drained in one order, so a stage's barrier is
  // never two phases behind its waiter, and a full ring never holds up
  // the other consumer's loads.
  if (warp >= 4 * kConsumers) {  // producers: one thread of each issues its ring's loads
    const int c = warp - 4 * kConsumers;
    if (threadIdx.x % 32 == 0) {
      if (c == 0) {  // the slice's weights, once: H / 64 pieces of [BN rows][64 bf16]
        mbar_arrive_expect_tx(wbar, (uint32_t)(BN * H * 2));
        for (int kb = 0; kb < H / 64; ++kb)
          tma_load_2d(ws + (size_t)kb * BN * 128, &wmap, wbar, kb * 64, slice * BN);
      }
      int n = 0;  // boxes put in the ring
      int j = 0;
      for (int tile = first_tile; tile < tiles; tile += tile_step, ++j) {
        if (j % kConsumers != c) continue;
        for (int b = 0; b < boxes; ++b, ++n) {
          const int s = c * ring + n % ring;
          mbar_wait(&empty[s], ((n / ring) & 1) ^ 1);  // the first round passes
          mbar_arrive_expect_tx(&full[s], kBoxBytes);
          tma_load_2d(xs + (size_t)s * kBoxBytes, &xmap, &full[s], b * kBoxCols,
                      tile * kQkvRows);  // rows past R arrive as zeros
        }
      }
    }
    return;
  }

  // consumer warpgroup wg takes the block's tiles wg, wg + kConsumers, ...
  const int wg = warp / 4, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool leader = threadIdx.x % 128 == 0;  // issues the warpgroup's TMA stores
  const int col0 = slice * BN;  // in the packed 3H columns
  const int part = col0 / H;    // 0: q, 1: k, 2: v
  const float* bs = bias + col0 + 2 * t;
  const unsigned char* my_xs = xs + (size_t)wg * ring * kBoxBytes;
  uint64_t *my_full = full + wg * ring, *my_empty = empty + wg * ring;
  unsigned char* my_os = os + (size_t)wg * kBoxBytes;
  const int r0 = (warp & 3) * 16 + g;  // the thread's rows r0 and r0 + 8 of a tile
  mbar_wait(wbar, 0);
  constexpr int G = qkv_chunk_boxes<BN>();  // divides the boxes of every H taking this BN
  float acc[BN / 2];
  int n = 0;  // boxes taken from the ring
  int j = 0;
  for (int tile = first_tile; tile < tiles; tile += tile_step, ++j) {
    if (j % kConsumers != wg) continue;
    for (int b = 0; b < boxes; b += G, n += G) {
      qkv_chunk<BN, G>(acc, my_xs, my_full, my_empty, ring, n, ws, b);
      wgmma_wait<0>();  // before the next chunk writes A again
    }
    wgmma_pin(acc);
    // 32 columns at a time: bias added, into the output box (128-byte
    // swizzle, as TMA stores it), then one TMA store of the 64 x 32 box;
    // rows past R are dropped by the tensor map's bounds
#pragma unroll
    for (int cc = 0; cc < BN / 32; ++cc) {
      if (leader) bulk_wait_read<0>();  // the last store has read the box
      named_barrier(1 + wg, 128);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int jn = cc * 4 + u, c = u * 8 + 2 * t;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(bs + jn * 8));
        const int off = (((c >> 2) ^ g) << 4) + ((c & 3) << 2);
        *reinterpret_cast<float2*>(my_os + r0 * 128 + off) =
            make_float2(acc[4 * jn] + bb.x, acc[4 * jn + 1] + bb.y);
        *reinterpret_cast<float2*>(my_os + (r0 + 8) * 128 + off) =
            make_float2(acc[4 * jn + 2] + bb.x, acc[4 * jn + 3] + bb.y);
      }
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (leader) {
        tma_store_3d(&omap, my_os, col0 - part * H + cc * 32, tile * kQkvRows, part);
        bulk_commit();
      }
    }
    wgmma_pin(acc);
  }
  if (leader) bulk_wait_all();
}

// A row-major (mats, rows, cols) tensor map with (1, box_rows, box_cols)
// boxes and 128-byte swizzle (or `swizzle`); false if the driver refuses it.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, size_t elem, const void* ptr,
                int mats, int rows, int cols, int box_rows, int box_cols,
                CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem, (cuuint64_t)rows * cols * elem};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, type, mats > 1 ? 3 : 2, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch_qkv(const void* x, const void* w, const float* b, void* out, int R, int H, int stages,
               int ctas, cudaStream_t stream) {
  CUtensorMap xmap, wmap, omap;
  if (!tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, 1, R, H, kQkvRows, kBoxCols) ||
      !tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, 1, 3 * H, H, BN, 64) ||
      !tensor_map(&omap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, 3, R, H, kQkvRows, kBoxCols))
    return (int)cudaErrorInvalidValue;
  const size_t smem = qkv_smem(H, BN, stages);
  int dev = 0;
  cudaGetDevice(&dev);
  static bool sized[64] = {};  // the kernel may take the limit, once per device
  if (!sized[dev & 63]) {
    cudaError_t err = set_smem(qkv_kernel<BN>, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    sized[dev & 63] = true;
  }
  qkv_kernel<BN><<<ctas, kQkvThreads, smem, stream>>>(xmap, wmap, omap, b, R, H, stages);
  return (int)cudaGetLastError();
}

// -- FFN + LN: persistent, TMA-fed weight pieces, wgmma ---------------------

constexpr int kFfnThreads = 384;         // a producer warpgroup and two consumer warpgroups
constexpr int kFfnProducerRegs = 24;     // setmaxnreg budgets: 24 x 128 + 240 x 256 <= 65,536
constexpr int kFfnConsumerRegs = 240;
constexpr int kFfnMaxRing = 8;           // weight pieces in flight, at most
constexpr int kFfnXBox = 8192;           // an f32 x box: 64 rows x 32 (128 B rows)
constexpr int kFfnTicketThreads = 288;   // the consumers and the weight producer warp
// named barriers (0 is __syncthreads)
constexpr int kBarX = 1;       // 1, 2: a warpgroup's rows of the x tile (row tiles of 128);
                               // 1: the whole tile (H split)
constexpr int kBarUp = 3;      // H split: both halves of an up piece written
constexpr int kBarRed = 4;     // H split: the halves of the row sums written
constexpr int kBarTicket = 5;  // I split: partial sums stored, then the ticket drawn

// A tile of `rows` rows: 128, each consumer warpgroup 64 rows x all H
// columns, I walked in chunks of 32; or 64, the two warpgroups splitting H,
// I in chunks of 64 (H over 384, where 64 x H f32 does not fit in a
// warpgroup's registers, and H 384 where the plan splits I).  A weight
// piece is W_in's or W_out's share of one chunk: chunk x H bf16.
constexpr int ffn_chunk(int rows) { return rows == 128 ? 32 : 64; }

// Bytes of dynamic shared memory: 1 KB to align to the swizzle's atoms,
// the bf16 x tile, the weight ring, both consumer warpgroups' f32 x slots,
// two 8 KB buffers (with row tiles of 128 each warpgroup's GEMM1 sums over
// the first half of K; with H split the up tiles), with H split the row
// sums, then the barriers and the ticket's flag (ops/fused_bert.py
// ffn_smem is the same sum).
constexpr int ffn_smem(int H, int rows, int ring, int stages) {
  return 1024 + rows * H * 2 + ring * ffn_chunk(rows) * H * 2 + 2 * stages * kFfnXBox +
         2 * 8192 + (rows == 64 ? 1024 : 0) +
         8 * (ring * (H / 64) + ring + 4 * stages + 2 * (rows / ffn_chunk(rows) + ring)) + 16;
}

// x slots a consumer warpgroup: two where they fit beside two weight pieces
constexpr int ffn_stages(int H, int rows) {
  return ffn_smem(H, rows, 2, 2) <= kSmemLimit ? 2 : 1;
}

// weight pieces in the ring: as many as fit, up to kFfnMaxRing
constexpr int ffn_ring(int H, int rows) {
  int ring = kFfnMaxRing;
  while (ring > 0 && ffn_smem(H, rows, ring, ffn_stages(H, rows)) > kSmemLimit) --ring;
  return ring;
}

template <int H, int ROWS>
struct Ffn {
  static constexpr bool kSplitH = ROWS == 64;
  static constexpr int kBI = ffn_chunk(ROWS);       // I columns of a chunk
  static constexpr int kNB = H / 64;                // TMA boxes of a weight piece
  static constexpr int kBoxBytes = kBI * 128;       // W_in: kBI rows x 64; W_out: 64 rows x kBI
  static constexpr int kPiece = kBI * H * 2;        // a weight piece
  static constexpr int kXTile = ROWS * H * 2;       // the bf16 x tile: [H / 64][ROWS][128 B]
  static constexpr int kN = kSplitH ? H / 2 : H;    // a warpgroup's accumulator columns
  static constexpr int kAcc = kN / 2;               // its f32 accumulators a thread
  static constexpr int kXBoxes = kN / 32;           // f32 x boxes it converts a tile
  static constexpr int kUpN = kSplitH ? 32 : kBI;   // up columns of its GEMM1 (N)
  static constexpr int kSub = kSplitH ? kN : H % 192 == 0 ? 192 : H % 128 == 0 ? 128 : 64;
  static constexpr int kNSub = kN / kSub;           // GEMM2's wgmmas a 16-deep step
  static constexpr int kParts = ROWS * H * 4 / kPiece;  // piece-sized parts of a tile's partial sums
  static constexpr int kQ = kPiece / 4096;          // float4 of a thread in a part
  static constexpr int kStages = ffn_stages(H, ROWS);
  static constexpr int kRing = ffn_ring(H, ROWS);
  static constexpr int kSlots = kXTile / kPiece + kRing;  // reduction parts, over the x tile and ring
  static constexpr int kRingOff = kXTile;
  static constexpr int kStgOff = kRingOff + kRing * kPiece;        // [2][kStages][kFfnXBox]
  static constexpr int kUpsOff = kStgOff + 2 * kStages * kFfnXBox;  // [2][8 KB]
  static constexpr int kRedOff = kUpsOff + 2 * 8192;                 // H split: [2][2][64] f32
  static constexpr int kFullOff = kRedOff + (kSplitH ? 1024 : 0);   // [kRing][kNB]
  static constexpr int kEmptyOff = kFullOff + 8 * kRing * kNB;      // [kRing]
  static constexpr int kSFullOff = kEmptyOff + 8 * kRing;           // [2][kStages]
  static constexpr int kSEmptyOff = kSFullOff + 16 * kStages;       // [2][kStages]
  static constexpr int kRFullOff = kSEmptyOff + 16 * kStages;       // [kSlots]
  static constexpr int kREmptyOff = kRFullOff + 8 * kSlots;         // [kSlots]
  static constexpr int kFlagOff = kREmptyOff + 8 * kSlots;
  static constexpr int kSmem = 1024 + kFlagOff + 16;
  static_assert(kSmem == ffn_smem(H, ROWS, kRing, kStages), "the layout is ffn_smem's");
  static_assert(kRing >= 2 && kSmem <= kSmemLimit, "two weight pieces fit");
  static_assert(kAcc == kParts * kQ * 4, "a thread's accumulators fill its share of the parts");
  static_assert(kSplitH ? H >= 384 : H <= 384, "the accumulator fits in 192 registers");
};

// The block's shared memory from its 1024-aligned base.
template <int H, int ROWS>
struct FfnSmem {
  using F = Ffn<H, ROWS>;
  unsigned char* base;
  __device__ unsigned char* xs() const { return base; }
  __device__ unsigned char* piece(int s) const { return base + F::kRingOff + s * F::kPiece; }
  __device__ unsigned char* slot(int wg, int s) const {
    return base + F::kStgOff + (wg * F::kStages + s) * kFfnXBox;
  }
  // H split: up tile b (64 x 64 bf16); row tiles of 128: warpgroup b's
  // GEMM1 sums over the first half of K ([4 float4][128 threads])
  __device__ unsigned char* ups(int b) const { return base + F::kUpsOff + b * 8192; }
  __device__ float* red() const { return reinterpret_cast<float*>(base + F::kRedOff); }
  __device__ uint64_t* bar(int off, int i) const {
    return reinterpret_cast<uint64_t*>(base + off) + i;
  }
  __device__ uint64_t* full(int s, int b) const { return bar(F::kFullOff, s * F::kNB + b); }
  __device__ uint64_t* empty(int s) const { return bar(F::kEmptyOff, s); }
  __device__ uint64_t* sfull(int wg, int s) const { return bar(F::kSFullOff, wg * F::kStages + s); }
  __device__ uint64_t* sempty(int wg, int s) const {
    return bar(F::kSEmptyOff, wg * F::kStages + s);
  }
  __device__ uint64_t* rfull(int s) const { return bar(F::kRFullOff, s); }
  __device__ uint64_t* rempty(int s) const { return bar(F::kREmptyOff, s); }
  __device__ volatile int* flag() const {
    return reinterpret_cast<volatile int*>(base + F::kFlagOff);
  }
};

// tanh(u) = 1 - 2 / (e^2u + 1) on ex2.approx and a fast reciprocal: two
// MUFU ops, absolute error about 1e-7 (e^2u overflowing gives 1, as it
// should)
__device__ __forceinline__ float tanh_ex2(float u) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(u * 2.8853900817779268f));  // e^2u
  return 1.f - __fdividef(2.f, e + 1.f);
}

// jax.nn.gelu(approximate=True): 0.5 v (1 + tanh(sqrt(2 / pi) (v + 0.044715 v^3)))
__device__ __forceinline__ float gelu_tanh(float v) {
  const float u = v * fmaf(0.0356774081f, v * v, 0.7978845608f);
  const float h = 0.5f * v;
  return fmaf(h, tanh_ex2(u), h);
}

// I chunks [c0, c1) of split `split` of `splits`: whole chunks, the first
// nc % splits splits one more
__device__ __forceinline__ void chunk_range(int nc, int splits, int split, int& c0, int& c1) {
  const int base = nc / splits, extra = nc % splits;
  c0 = split * base + min(split, extra);
  c1 = c0 + base + (split < extra ? 1 : 0);
}

// this warp's arrival on a barrier
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

template <int R_>
__device__ __forceinline__ void pin_regs(uint32_t (&a)[R_][4]) {
#pragma unroll
  for (int i = 0; i < R_; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The producer's weight warp: the unit's pieces W_in(c), W_out(c),
// W_in(c + 1), ... into the ring, a full barrier a TMA box and an empty one
// a piece; with I split, the ticket, and in the last block of a tile the
// tile's partial sums, in split order, through the reduction slots.
template <int H, int ROWS>
__device__ __forceinline__ void ffn_weights(FfnSmem<H, ROWS> sm, const CUtensorMap* wimap,
                                            const CUtensorMap* womap, const float* ws,
                                            int* tickets, int units, int splits, int nc) {
  using F = Ffn<H, ROWS>;
  const int lane = threadIdx.x & 31;
  int n = 0, m = 0;  // pieces and parts put in the rings
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = u / splits, split = u - tile * splits;
    int c0, c1;
    chunk_range(nc, splits, split, c0, c1);
    for (int c = c0; c < c1; ++c) {
      for (int w = 0; w < 2; ++w, ++n) {  // W_in's rows of chunk c, then W_out's columns
        const int s = n % F::kRing;
        mbar_wait(sm.empty(s), ((n / F::kRing) & 1) ^ 1);  // the first round passes
        if (lane == 0) {
          for (int b = 0; b < F::kNB; ++b) {
            uint64_t* bar = sm.full(s, b);
            mbar_arrive_expect_tx(bar, F::kBoxBytes);
            if (w == 0)  // rows c kBI.. of W_in, columns 64 b..: [kBI][128 B]
              tma_load_2d(sm.piece(s) + b * F::kBoxBytes, wimap, bar, b * 64, c * F::kBI);
            else  // rows 64 b.. of W_out, columns c kBI..: [64][2 kBI B]
              tma_load_2d(sm.piece(s) + b * F::kBoxBytes, womap, bar, c * F::kBI, b * 64);
          }
        }
        __syncwarp();
      }
    }
    if (splits == 1) continue;
    named_barrier(kBarTicket, kFfnTicketThreads);  // the block's partial sums are stored
    if (lane == 0) {
      __threadfence();
      const int last = atomicAdd(&tickets[tile], 1) == splits - 1;
      if (last) tickets[tile] = 0;  // every split has drawn: ready for the next launch
      __threadfence();
      fence_proxy_async_global();  // the tile's stores before this block's TMA reads
      *sm.flag() = last;
    }
    named_barrier(kBarTicket, kFfnTicketThreads);
    if (!*sm.flag()) continue;
    for (int k = 0; k < splits; ++k)
      for (int p = 0; p < F::kParts; ++p, ++m) {
        const int s = m % F::kSlots;
        mbar_wait(sm.rempty(s), ((m / F::kSlots) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(sm.rfull(s), F::kPiece);
          bulk_load(sm.xs() + s * F::kPiece,
                    ws + ((size_t)(tile * splits + k) * F::kParts + p) * (F::kPiece / 4),
                    F::kPiece, sm.rfull(s));
        }
        __syncwarp();
      }
  }
}

// Row offset of consumer warpgroup wg's 64 rows in a tile, and its first
// accumulator column.
template <int H, int ROWS>
__host__ __device__ constexpr int wg_row(int wg) { return Ffn<H, ROWS>::kSplitH ? 0 : 64 * wg; }

template <int H, int ROWS>
__host__ __device__ constexpr int wg_col(int wg) {
  return Ffn<H, ROWS>::kSplitH ? wg * (H / 2) : 0;
}

// A producer x warp (one thread): consumer warpgroup wg's f32 x boxes of
// each unit into its slots, and the next unit's rows into L2.
template <int H, int ROWS>
__device__ __forceinline__ void ffn_x(FfnSmem<H, ROWS> sm, const CUtensorMap* xmap,
                                      const float* x, int wg, int R, int units, int splits) {
  using F = Ffn<H, ROWS>;
  int k = 0;  // boxes put in the slots
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int row0 = (u / splits) * ROWS + wg_row<H, ROWS>(wg);
    const int next = u + gridDim.x;
    if (next < units && (wg == 0 || !F::kSplitH)) {
      const int nrow0 = (next / splits) * ROWS + wg_row<H, ROWS>(wg);
      if (nrow0 < R) prefetch_l2(x + (size_t)nrow0 * H, (uint32_t)(min(64, R - nrow0) * H * 4));
    }
    for (int q = 0; q < F::kXBoxes; ++q, ++k) {
      const int s = k % F::kStages;
      mbar_wait(sm.sempty(wg, s), ((k / F::kStages) & 1) ^ 1);
      mbar_arrive_expect_tx(sm.sfull(wg, s), kFfnXBox);
      tma_load_2d(sm.slot(wg, s), xmap, sm.sfull(wg, s), wg_col<H, ROWS>(wg) + 32 * q,
                  row0);  // rows past R arrive as zeros
    }
  }
}

// A consumer thread: warpgroup wg, its thread tid; rows ra and ra + 8 of
// the warpgroup's 64 (ra = 16 warp + lane / 4) and accumulator columns 8j
// + 2t, + 1 (t = lane % 4): acc[4j + 2h + e] is row ra + 8h, column wg_col
// + 8j + 2t + e, as wgmma lays it out.
struct FfnThread {
  int wg, tid, t, ra;
};

// A consumer thread's accumulator: a row for each of GEMM2's wgmmas of N
// kSub; at() is its element i, counted as one array (acc[4j + 2h + e]).
template <int H, int ROWS>
using FfnAcc = float[Ffn<H, ROWS>::kNSub][Ffn<H, ROWS>::kSub / 2];

template <int H, int ROWS>
__device__ __forceinline__ float& at(FfnAcc<H, ROWS>& acc, int i) {
  constexpr int S = Ffn<H, ROWS>::kSub / 2;
  return acc[i / S][i % S];
}

// The unit's x boxes of warpgroup wg, in order: each value rounded to
// bf16 into the x tile (K-major, 128-byte swizzle: granule j of row r at j
// ^ (r % 8); the boxes arrive with the same swizzle), and acc = x + b_out
// (the residual and the bias, in the split-0 block) or 0, so that the
// epilogue reads no x.
template <int H, int ROWS>
__device__ __forceinline__ void take_x(FfnAcc<H, ROWS>& acc, FfnSmem<H, ROWS> sm,
                                       const FfnThread& th, int& k, bool residual,
                                       const float* __restrict__ b_out) {
  using F = Ffn<H, ROWS>;
  const int xrow0 = wg_row<H, ROWS>(th.wg);
#pragma unroll
  for (int q = 0; q < F::kXBoxes; ++q, ++k) {
    const int s = k % F::kStages;
    mbar_wait(sm.sfull(th.wg, s), (k / F::kStages) & 1);
    const unsigned char* box = sm.slot(th.wg, s);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = 8 * jj + 2 * th.t;                         // column in the box
      const int xc = wg_col<H, ROWS>(th.wg) + 32 * q + c;      // in the x tile
      const float2 bo = residual ? __ldg(reinterpret_cast<const float2*>(b_out + xc))
                                 : make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = th.ra + 8 * h;  // r % 8 == lane / 4
        const float2 v = *reinterpret_cast<const float2*>(
            box + r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2)));
        *reinterpret_cast<uint32_t*>(sm.xs() + (xc >> 6) * ROWS * 128 + (xrow0 + r) * 128 +
                                     ((((xc & 63) >> 3) ^ (r & 7)) << 4) + (xc & 7) * 2) =
            pack_bf16(v.x, v.y);
        const int i = 4 * (4 * q + jj) + 2 * h;  // acc[4j + 2h + e], j = 4q + jj
        at<H, ROWS>(acc, i) = residual ? v.x + bo.x : 0.f;
        at<H, ROWS>(acc, i + 1) = residual ? v.y + bo.y : 0.f;
      }
    }
    release(sm.sempty(th.wg, s));
  }
}

// GEMM1 on weight piece n (W_in of a chunk), issued: up (64 rows x kUpN
// columns from ucol of the chunk) = x_tile[K boxes kb0..kb1) W_in(c)[ucol..,
// same K]^T, m64nkUpNk16 with both operands in shared memory, a box (64
// deep) at a time as it lands.  The caller commits.
template <int H, int ROWS>
__device__ __forceinline__ void gemm1(float (&up)[Ffn<H, ROWS>::kUpN / 2], FfnSmem<H, ROWS> sm,
                                      const FfnThread& th, int n, int ucol, int kb0, int kb1) {
  using F = Ffn<H, ROWS>;
  const int s = n % F::kRing;
  const uint32_t parity = (n / F::kRing) & 1;
  const uint64_t da = wgmma_desc_sw128(sm.xs() + wg_row<H, ROWS>(th.wg) * 128);
  const uint64_t db = wgmma_desc_sw128(sm.piece(s) + ucol * 128);
  wgmma_fence();
#pragma unroll
  for (int kb = kb0; kb < kb1; ++kb) {
    mbar_wait(sm.full(s, kb), parity);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(up, da + ((kb * ROWS * 128 + kk * 32) >> 4),
               db + ((kb * F::kBoxBytes + kk * 32) >> 4), (kb != kb0 || kk != 0));
  }
}

// up + b_in, GELU'd, in place: up[4j + 2h + e] is column col0 + 8j + 2t + e
// of I.  The bias comes after the product, as the plain version adds it.
template <int N>
__device__ __forceinline__ void bias_gelu(float (&up)[N], const float* __restrict__ b_in,
                                          int col0, int t) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(b_in + col0 + 8 * j + 2 * t));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      up[4 * j + 2 * h] = gelu_tanh(up[4 * j + 2 * h] + b.x);
      up[4 * j + 2 * h + 1] = gelu_tanh(up[4 * j + 2 * h + 1] + b.y);
    }
  }
}

// Rows ra, ra + 8: their sums over the warpgroup's columns (a quad of
// lanes holds them), and with H split the other warpgroup's half added
// through shared memory, in warpgroup order.
template <int H, int ROWS>
__device__ __forceinline__ void row_sums(float& s0, float& s1, FfnSmem<H, ROWS> sm,
                                         const FfnThread& th, int pass) {
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);
  if constexpr (Ffn<H, ROWS>::kSplitH) {
    float* r = sm.red() + pass * 128;
    if (th.t == 0) {
      r[th.wg * 64 + th.ra] = s0;
      r[th.wg * 64 + th.ra + 8] = s1;
    }
    named_barrier(kBarRed, 256);
    s0 = r[th.ra] + r[64 + th.ra];
    s1 = r[th.ra + 8] + r[64 + th.ra + 8];
  }
}

// y = LN(acc) for rows row0 + ra and row0 + ra + 8 (acc holds x + b_out +
// the products), rows past R dropped.  With row tiles of 128, y goes out
// by TMA from the warpgroup's rows of the x tile, free once its last
// GEMM1 is done: six 64 x 32 f32 boxes (128-byte swizzle) a round, two
// rounds at H 384, so that the stores drain while the next tile starts
// (stored from registers, the kernel ran slower).
// With H split, each thread stores its values (full 32-byte sectors).
template <int H, int ROWS>
__device__ __forceinline__ void ln_store(FfnAcc<H, ROWS>& acc, FfnSmem<H, ROWS> sm,
                                         const FfnThread& th, int row0,
                                         const float* __restrict__ ln_s,
                                         const float* __restrict__ ln_b, float eps,
                                         float* __restrict__ y, const CUtensorMap* ymap, int R) {
  constexpr int J = Ffn<H, ROWS>::kN / 8;
  const int col0 = wg_col<H, ROWS>(th.wg) + 2 * th.t;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    s0 += at<H, ROWS>(acc, 4 * j) + at<H, ROWS>(acc, 4 * j + 1);
    s1 += at<H, ROWS>(acc, 4 * j + 2) + at<H, ROWS>(acc, 4 * j + 3);
  }
  row_sums<H, ROWS>(s0, s1, sm, th, 0);
  const float mu0 = s0 / H, mu1 = s1 / H;
  s0 = s1 = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float d0 = at<H, ROWS>(acc, 4 * j) - mu0, d1 = at<H, ROWS>(acc, 4 * j + 1) - mu0;
    const float d2 = at<H, ROWS>(acc, 4 * j + 2) - mu1, d3 = at<H, ROWS>(acc, 4 * j + 3) - mu1;
    s0 += d0 * d0 + d1 * d1;
    s1 += d2 * d2 + d3 * d3;
  }
  row_sums<H, ROWS>(s0, s1, sm, th, 1);
  const float rs0 = rsqrtf(s0 / H + eps), rs1 = rsqrtf(s1 / H + eps);
  if constexpr (!Ffn<H, ROWS>::kSplitH) {
    constexpr int kBoxes = H / 64;  // y boxes a round: one in each 64-column block of the x tile
    const bool leader = th.tid == 0;
#pragma unroll
    for (int round = 0; round < 2; ++round) {
      if (round > 0) {
        if (leader) bulk_wait_read<0>();  // the first round's boxes are read out
        named_barrier(kBarX + th.wg, 128);
      }
#pragma unroll
      for (int q = 0; q < kBoxes; ++q) {
        unsigned char* box = sm.xs() + q * ROWS * 128 + wg_row<H, ROWS>(th.wg) * 128;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = (round * kBoxes + q) * 4 + jj;  // columns 8j + 2t, + 1
          const int c = 8 * jj + 2 * th.t;               // in the box
          const float2 sc = __ldg(reinterpret_cast<const float2*>(ln_s + col0 + 8 * j));
          const float2 lb = __ldg(reinterpret_cast<const float2*>(ln_b + col0 + 8 * j));
          const int off = (((c >> 2) ^ (th.ra & 7)) << 4) + ((c & 3) << 2);
          *reinterpret_cast<float2*>(box + th.ra * 128 + off) =
              make_float2((at<H, ROWS>(acc, 4 * j) - mu0) * rs0 * sc.x + lb.x,
                          (at<H, ROWS>(acc, 4 * j + 1) - mu0) * rs0 * sc.y + lb.y);
          *reinterpret_cast<float2*>(box + (th.ra + 8) * 128 + off) =
              make_float2((at<H, ROWS>(acc, 4 * j + 2) - mu1) * rs1 * sc.x + lb.x,
                          (at<H, ROWS>(acc, 4 * j + 3) - mu1) * rs1 * sc.y + lb.y);
        }
      }
      fence_proxy_async();
      named_barrier(kBarX + th.wg, 128);
      if (leader) {
        for (int q = 0; q < kBoxes; ++q)
          tma_store_2d(ymap, sm.xs() + q * ROWS * 128 + wg_row<H, ROWS>(th.wg) * 128,
                       (round * kBoxes + q) * 32, row0);
        bulk_commit();
      }
    }
  } else {
    const int row_a = row0 + th.ra, row_b = row_a + 8;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = col0 + 8 * j;
      const float2 sc = __ldg(reinterpret_cast<const float2*>(ln_s + c));
      const float2 lb = __ldg(reinterpret_cast<const float2*>(ln_b + c));
      if (row_a < R)
        *reinterpret_cast<float2*>(y + (size_t)row_a * H + c) =
            make_float2((at<H, ROWS>(acc, 4 * j) - mu0) * rs0 * sc.x + lb.x,
                        (at<H, ROWS>(acc, 4 * j + 1) - mu0) * rs0 * sc.y + lb.y);
      if (row_b < R)
        *reinterpret_cast<float2*>(y + (size_t)row_b * H + c) =
            make_float2((at<H, ROWS>(acc, 4 * j + 2) - mu1) * rs1 * sc.x + lb.x,
                        (at<H, ROWS>(acc, 4 * j + 3) - mu1) * rs1 * sc.y + lb.y);
    }
  }
}

// I split: store the block's partial sums in the accumulator's own layout
// (part p: [warpgroup][kQ float4][128 threads]), let the weight warp draw
// the ticket, and in the tile's last block sum all splits' parts into acc,
// in split order.  Returns whether this block runs the tile's epilogue.
template <int H, int ROWS>
__device__ __forceinline__ bool reduce_splits(FfnAcc<H, ROWS>& acc, FfnSmem<H, ROWS> sm,
                                              const FfnThread& th, float* __restrict__ ws,
                                              int u, int splits, int& m) {
  using F = Ffn<H, ROWS>;
  constexpr int Q = F::kQ;
  float* dst = ws + (size_t)u * F::kParts * (F::kPiece / 4);
#pragma unroll
  for (int q = 0; q < F::kAcc / 4; ++q)
    reinterpret_cast<float4*>(dst + (q / Q) * (F::kPiece / 4))[(th.wg * Q + q % Q) * 128 + th.tid] =
        make_float4(at<H, ROWS>(acc, 4 * q), at<H, ROWS>(acc, 4 * q + 1),
                    at<H, ROWS>(acc, 4 * q + 2), at<H, ROWS>(acc, 4 * q + 3));
  fence_proxy_async_global();
  __threadfence();
  named_barrier(kBarTicket, kFfnTicketThreads);  // the weight warp draws the ticket
  named_barrier(kBarTicket, kFfnTicketThreads);
  if (!*sm.flag()) return false;
#pragma unroll
  for (int i = 0; i < F::kAcc; ++i) at<H, ROWS>(acc, i) = 0.f;
  for (int k = 0; k < splits; ++k) {
#pragma unroll
    for (int p = 0; p < F::kParts; ++p, ++m) {
      const int s = m % F::kSlots;
      mbar_wait(sm.rfull(s), (m / F::kSlots) & 1);
      const float4* src =
          reinterpret_cast<const float4*>(sm.xs() + s * F::kPiece) + th.wg * Q * 128 + th.tid;
#pragma unroll
      for (int r = 0; r < Q; ++r) {
        const float4 v = src[r * 128];
        at<H, ROWS>(acc, 4 * (p * Q + r)) += v.x;
        at<H, ROWS>(acc, 4 * (p * Q + r) + 1) += v.y;
        at<H, ROWS>(acc, 4 * (p * Q + r) + 2) += v.z;
        at<H, ROWS>(acc, 4 * (p * Q + r) + 3) += v.w;
      }
      release(sm.rempty(s));
    }
  }
  return true;
}

// Row tiles of 128: each warpgroup, per chunk c of 32, runs GEMM1 (up =
// x W_in(c)^T, 64 x 32) as two chains over K, boxes [0, kLo) and [kLo,
// kNB), one after the other; the first chain's sums wait in shared memory
// (beside the accumulator no registers are left for them) and are added
// to the second's in f32.  One chain over all of K strays further from the
// plain version's f32 sum (the tensor cores do not round each step as f32
// adds do), far enough to flip the bf16 rounding of a GELU output and put
// an output past the tolerance (tools/ffn_ln_variants.py one_chain,
// PERF.md).  It frees W_in(c), adds b_in and GELUs up into bf16 registers
// that are exactly the A fragments of GEMM2's two 16-deep steps (wgmma
// with A from registers, as FA3 feeds P); then runs GEMM2 (acc += up
// W_out(c)^T, in wgmmas of N kSub), waits, and frees W_out(c).  One wgmma
// group is in flight at a time: a second beside the accumulator made
// ptxas serialise the wgmmas (C7512); the other warpgroup's wgmmas fill
// the tensor cores while this one waits or GELUs.
template <int H>
__device__ __forceinline__ void rows128_chunks(FfnAcc<H, 128>& acc, FfnSmem<H, 128> sm,
                                               const FfnThread& th, int& n, int c0, int c1,
                                               const float* __restrict__ b_in) {
  using F = Ffn<H, 128>;
  constexpr int kLo = F::kNB / 2;  // GEMM1's first chain: K boxes [0, kLo)
  float up[F::kUpN / 2];
  uint32_t a[2][4];
  float4* lo = reinterpret_cast<float4*>(sm.ups(th.wg)) + th.tid;  // [kUpN / 8][128 threads]
  for (int c = c0; c < c1; ++c, n += 2) {
    if constexpr (kLo > 0) {
      gemm1<H, 128>(up, sm, th, n, 0, 0, kLo);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_pin(up);
#pragma unroll
      for (int q = 0; q < F::kUpN / 8; ++q)
        lo[q * 128] = make_float4(up[4 * q], up[4 * q + 1], up[4 * q + 2], up[4 * q + 3]);
    }
    gemm1<H, 128>(up, sm, th, n, 0, kLo, F::kNB);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(up);
    if constexpr (kLo > 0) {
#pragma unroll
      for (int q = 0; q < F::kUpN / 8; ++q) {
        const float4 v = lo[q * 128];
        up[4 * q] = v.x + up[4 * q];
        up[4 * q + 1] = v.y + up[4 * q + 1];
        up[4 * q + 2] = v.z + up[4 * q + 2];
        up[4 * q + 3] = v.w + up[4 * q + 3];
      }
    }
    release(sm.empty(n % F::kRing));
    bias_gelu(up, b_in, c * F::kBI, th.t);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[kk][i] = pack_bf16(up[8 * kk + 2 * i], up[8 * kk + 2 * i + 1]);
    // GEMM2 on piece n + 1 (W_out of chunk c), each wgmma as its boxes land
    const int s = (n + 1) % F::kRing;
    const uint32_t parity = ((n + 1) / F::kRing) & 1;
    const uint64_t db = wgmma_desc_sw64(sm.piece(s));  // W_out(c): [H rows][64 B]
    wgmma_fence();
#pragma unroll
    for (int sb = 0; sb < F::kNSub; ++sb) {
#pragma unroll
      for (int b = sb * F::kSub / 64; b < (sb + 1) * F::kSub / 64; ++b)
        mbar_wait(sm.full(s, b), parity);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_rs(acc[sb], a[kk], db + ((sb * F::kSub * 64 + kk * 32) >> 4), 1u);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int sb = 0; sb < F::kNSub; ++sb) wgmma_pin(acc[sb]);
    pin_regs(a);
    release(sm.empty(s));
  }
}

// H split (row tiles of 64): per chunk c of 64, GEMM1 of c + 1 and GEMM2 of
// c are in flight together, and the GELU of c + 1 runs while GEMM2 of c
// does.  Each warpgroup computes 32 of the chunk's 64 up columns, as two
// chains over K in accumulators of their own (there is room for both
// here), added in f32 as with row tiles of 128, and writes them GELU'd as
// bf16 into the shared up tile (K-major, 128-byte swizzle); after a
// barrier both run GEMM2 over all 64 into their halves of H, with both
// operands in shared memory.
template <int H>
__device__ __forceinline__ void rows64_chunks(FfnAcc<H, 64>& acc, FfnSmem<H, 64> sm,
                                              const FfnThread& th, int& n, int c0, int c1,
                                              const float* __restrict__ b_in) {
  using F = Ffn<H, 64>;
  float up[16], hi[16];
  auto gemm1_chains = [&](int np) {  // GEMM1 on piece np, one commit group
    gemm1<H, 64>(up, sm, th, np, 32 * th.wg, 0, F::kNB / 2);
    gemm1<H, 64>(hi, sm, th, np, 32 * th.wg, F::kNB / 2, F::kNB);
    wgmma_commit();
  };
  auto sum_chains = [&] {  // once GEMM1's group is done
    wgmma_pin(up);
    wgmma_pin(hi);
#pragma unroll
    for (int e = 0; e < 16; ++e) up[e] += hi[e];
  };
  auto up_to_tile = [&](int c) {  // up + b_in, GELU'd, into the up tile of chunk c
    bias_gelu(up, b_in, c * 64 + 32 * th.wg, th.t);
    unsigned char* ut = sm.ups(c & 1);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = th.ra + 8 * h;
        *reinterpret_cast<uint32_t*>(ut + r * 128 + (((4 * th.wg + j) ^ (r & 7)) << 4) +
                                     4 * th.t) = pack_bf16(up[4 * j + 2 * h], up[4 * j + 2 * h + 1]);
      }
  };
  auto gemm2 = [&](int c) {  // issued on piece n + 1 once its boxes land
    const int s = (n + 1) % F::kRing;
    const uint32_t parity = ((n + 1) / F::kRing) & 1;
#pragma unroll
    for (int b = 0; b < F::kNB; ++b) mbar_wait(sm.full(s, b), parity);
    const uint64_t da = wgmma_desc_sw128(sm.ups(c & 1));
    const uint64_t db = wgmma_desc_sw128(sm.piece(s) + th.wg * (H / 2) * 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(acc[0], da + ((kk * 32) >> 4), db + ((kk * 32) >> 4), 1u);
    wgmma_commit();
  };
  gemm1_chains(n);
  wgmma_wait<0>();
  sum_chains();
  release(sm.empty(n % F::kRing));
  up_to_tile(c0);
  fence_proxy_async();
  named_barrier(kBarUp, 256);
  for (int c = c0; c + 1 < c1; ++c, n += 2) {
    gemm1_chains(n + 2);
    gemm2(c);
    wgmma_wait<1>();  // GEMM1 of c + 1
    sum_chains();
    release(sm.empty((n + 2) % F::kRing));
    up_to_tile(c + 1);
    wgmma_wait<0>();  // GEMM2 of c
    wgmma_pin(acc[0]);
    release(sm.empty((n + 1) % F::kRing));
    fence_proxy_async();
    named_barrier(kBarUp, 256);  // both halves of up(c + 1) written, both GEMM2s of c done
  }
  gemm2(c1 - 1);
  wgmma_wait<0>();
  wgmma_pin(acc[0]);
  release(sm.empty((n + 1) % F::kRing));
  n += 2;
}

template <int H, int ROWS>
__device__ __forceinline__ void ffn_consume(FfnSmem<H, ROWS> sm, const CUtensorMap* ymap,
                                            const float* __restrict__ b_in,
                                            const float* __restrict__ b_out,
                                            const float* __restrict__ ln_s,
                                            const float* __restrict__ ln_b, float eps,
                                            float* __restrict__ y, float* __restrict__ ws, int R,
                                            int units, int splits, int nc) {
  using F = Ffn<H, ROWS>;
  FfnThread th;
  th.wg = (threadIdx.x >> 7) - 1;
  th.tid = threadIdx.x & 127;
  th.t = threadIdx.x & 3;
  th.ra = 16 * (th.tid >> 5) + ((threadIdx.x & 31) >> 2);
  FfnAcc<H, ROWS> acc;
  int n = 0, kx = 0, m = 0;  // weight pieces, x boxes and reduction parts taken
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = u / splits, split = u - tile * splits;
    int c0, c1;
    chunk_range(nc, splits, split, c0, c1);
    if (!F::kSplitH && u != (int)blockIdx.x) {  // the last tile's y boxes are read out of the x tile
      if (th.tid == 0) bulk_wait_read<0>();
      named_barrier(kBarX + th.wg, 128);
    }
    take_x<H, ROWS>(acc, sm, th, kx, split == 0, b_out);
    fence_proxy_async();  // the x tile's stores before the wgmmas read it
    if constexpr (F::kSplitH)
      named_barrier(kBarX, 256);
    else
      named_barrier(kBarX + th.wg, 128);
    if constexpr (F::kSplitH)
      rows64_chunks<H>(acc, sm, th, n, c0, c1, b_in);
    else
      rows128_chunks<H>(acc, sm, th, n, c0, c1, b_in);
    if (splits > 1 && !reduce_splits<H, ROWS>(acc, sm, th, ws, u, splits, m)) continue;
    ln_store<H, ROWS>(acc, sm, th, tile * ROWS + wg_row<H, ROWS>(th.wg), ln_s, ln_b, eps, y,
                      ymap, R);
  }
  if (!F::kSplitH && th.tid == 0) bulk_wait_all();  // the last y boxes are written
}

template <int H, int ROWS>
__global__ void __launch_bounds__(kFfnThreads, 1)
ffn_ln_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wimap,
              const __grid_constant__ CUtensorMap womap, const __grid_constant__ CUtensorMap ymap,
              const float* __restrict__ x,
              const float* __restrict__ b_in, const float* __restrict__ b_out,
              const float* __restrict__ ln_s, const float* __restrict__ ln_b, float eps,
              float* __restrict__ y, float* __restrict__ ws, int* __restrict__ tickets, int R,
              int I, int splits) {
  using F = Ffn<H, ROWS>;
  extern __shared__ unsigned char smem_raw[];
  const FfnSmem<H, ROWS> sm{smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023)};
  const int units = (R + ROWS - 1) / ROWS * splits, nc = I / F::kBI;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < F::kRing; ++s) {
      for (int b = 0; b < F::kNB; ++b) mbar_init(sm.full(s, b), 1);
      mbar_init(sm.empty(s), 8);  // every consumer warp
    }
    for (int wg = 0; wg < 2; ++wg)
      for (int s = 0; s < F::kStages; ++s) {
        mbar_init(sm.sfull(wg, s), 1);
        mbar_init(sm.sempty(wg, s), 4);  // the converting warpgroup's warps
      }
    for (int s = 0; s < F::kSlots; ++s) {
      mbar_init(sm.rfull(s), 1);
      mbar_init(sm.rempty(s), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp < 4) {  // the producer warpgroup
    setmaxnreg_dec<kFfnProducerRegs>();
    if (warp == 0)
      ffn_weights<H, ROWS>(sm, &wimap, &womap, ws, tickets, units, splits, nc);
    else if (warp <= 2 && (threadIdx.x & 31) == 0)
      ffn_x<H, ROWS>(sm, &xmap, x, warp - 1, R, units, splits);
    return;
  }
  setmaxnreg_inc<kFfnConsumerRegs>();
  ffn_consume<H, ROWS>(sm, &ymap, b_in, b_out, ln_s, ln_b, eps, y, ws, R, units, splits, nc);
}

template <int H, int ROWS>
int launch_ffn(const float* x, const bf16* w_in, const float* b_in, const bf16* w_out,
               const float* b_out, const float* ln_s, const float* ln_b, float eps, float* y,
               float* ws, int* tickets, int R, int I, int splits, int ctas, int ring, int stages,
               cudaStream_t stream) {
  using F = Ffn<H, ROWS>;
  if (ring != F::kRing || stages != F::kStages || I % F::kBI != 0 || splits > I / F::kBI)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wimap, womap, ymap;
  if (!tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, 1, R, H, 64, 32) ||
      !tensor_map(&ymap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, y, 1, R, H, 64, 32) ||
      !tensor_map(&wimap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w_in, 1, I, H, F::kBI, 64) ||
      !tensor_map(&womap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w_out, 1, H, I, 64, F::kBI,
                  F::kBI == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // devices on which this variant may take its shared memory, raised once
  // each; host threads may launch at once (the server's batches run in
  // worker threads), and each may do that first step
  static std::atomic<uint64_t> sized{0};
  const uint64_t bit = 1ull << (dev & 63);
  if (!(sized.load(std::memory_order_acquire) & bit)) {
    err = set_smem(ffn_ln_kernel<H, ROWS>, F::kSmem);
    if (err != cudaSuccess) return (int)err;
    sized.fetch_or(bit, std::memory_order_release);
  }
  ffn_ln_kernel<H, ROWS><<<ctas, kFfnThreads, F::kSmem, stream>>>(
      xmap, wimap, womap, ymap, x, b_in, b_out, ln_s, ln_b, eps, y, ws, tickets, R, I, splits);
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

// (q, k, v) = x W^T + b into `out`, a (3, R, H) f32 tensor, with W the
// (3H, H) bf16 stack of W_q, W_k and W_v and b the (3H,) f32 stack of
// their biases.  The tile plan comes from the caller (ops/fused_bert.py
// qkv_plan): bn columns a slice (64, 128 or 192, dividing H), `stages` x
// boxes in flight (an even number, split between the two consumers'
// rings), `ctas` blocks (a multiple of the 3H / bn slices, at most one
// block a slice per row tile).  x, W and out must be 16-byte aligned.
extern "C" int fused_qkv(const void* x, const void* w, const void* b, void* out, int R, int H,
                         int bn, int stages, int ctas, void* stream) {
  const int slices = bn > 0 ? 3 * H / bn : 0;
  if (!takes(R, H) || (bn != 64 && bn != 128 && bn != 192) || H % bn != 0 || stages < 4 ||
      stages % kConsumers != 0 || qkv_smem(H, bn, stages) > (size_t)kSmemLimit ||
      ctas < slices || ctas % slices != 0 || ctas / slices > (R + kQkvRows - 1) / kQkvRows ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const float* bias = (const float*)b;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bn) {
    case 64: return launch_qkv<64>(x, w, bias, out, R, H, stages, ctas, st);
    case 128: return launch_qkv<128>(x, w, bias, out, R, H, stages, ctas, st);
    default: return launch_qkv<192>(x, w, bias, out, R, H, stages, ctas, st);
  }
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

// y = LN(x + gelu_tanh(x W_in^T + b_in) W_out^T + b_out), with W_in (I, H)
// and W_out (H, I) bf16.  The plan comes from the caller (ops/fused_bert.py
// ffn_plan): `rows` a tile (128 for H up to 384; 64, the two warpgroups
// splitting H, for H 384 and over), I split over `splits` blocks a tile
// (then one tile and split a block: ctas = tiles x splits; else ctas
// persistent blocks, at most the tiles), `ring` and `stages` the kernel's
// own for this H and `rows`.  With splits > 1, `workspace` holds splits x
// tiles x rows x H f32 and `tickets` one int a tile, zero, which the
// kernel leaves zero.  x, W_in, W_out, y and the workspace must be 16-byte
// aligned.
extern "C" int fused_ffn_ln(const void* x, const void* w_in, const void* b_in, const void* w_out,
                            const void* b_out, const void* ln_s, const void* ln_b, float eps,
                            void* y, int R, int H, int I, int rows, int splits, int ctas, int ring,
                            int stages, void* workspace, void* tickets, void* stream) {
  const long long tiles = rows > 0 ? ((long long)R + rows - 1) / rows : 0;
  if (!takes(R, H) || I < 64 || I % 64 != 0 || !(rows == 128 ? H <= 384 : rows == 64 && H >= 384) ||
      splits < 1 || ctas < 1 || (splits == 1 ? ctas > tiles : ctas != tiles * splits) ||
      (splits > 1 && (workspace == nullptr || tickets == nullptr)) ||
      ((uintptr_t)x | (uintptr_t)w_in | (uintptr_t)w_out | (uintptr_t)y | (uintptr_t)workspace) %
              16 != 0)
    return (int)cudaErrorInvalidValue;
#define FFN_ARGS(W, ROWS)                                                                      \
  launch_ffn<W, ROWS>((const float*)x, (const bf16*)w_in, (const float*)b_in,                 \
                      (const bf16*)w_out, (const float*)b_out, (const float*)ln_s,            \
                      (const float*)ln_b, eps, (float*)y, (float*)workspace, (int*)tickets, R, \
                      I, splits, ctas, ring, stages, (cudaStream_t)stream)
#define FFN_ROWS128(W) \
  case W:              \
    return FFN_ARGS(W, 128);
#define FFN_ROWS64(W) \
  case W:             \
    return FFN_ARGS(W, 64);
  if (rows == 128) {
    switch (H) { FFN_ROWS128(64) FFN_ROWS128(128) FFN_ROWS128(192) FFN_ROWS128(256)
                 FFN_ROWS128(320) FFN_ROWS128(384) }
  } else {
    switch (H) { FFN_ROWS64(384) FFN_ROWS64(448) FFN_ROWS64(512) }
  }
#undef FFN_ROWS64
#undef FFN_ROWS128
#undef FFN_ARGS
  return (int)cudaErrorInvalidValue;
}
