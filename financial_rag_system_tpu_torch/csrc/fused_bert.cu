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
//    0.264 ms (0.220 ms): bound by bytes (its 5.7e10 operations take
//    0.057 ms).  At the embed shape (R 1,024, f32 ctx) 4.7 MB, 0.0014 ms:
//    there launch and latency set the time.
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
// resid_ln_kernel is built for Hopper.  W_o (295 KB bf16 at H 384) does
// not fit in a block's 227 KB, and the first design streamed all of it
// from L2 for every 64 rows (885 MB a launch).  Here a cluster of C blocks
// on neighbouring SMs shares each row tile of 64: the block of rank r owns
// output columns [r N, (r + 1) N), N = H / C (96 at H 384, C 4), and holds
// that slice of W_o in shared memory for its whole life, read by TMA once
// (8.8 MB from L2 a launch on 120 blocks).  Two consumer warpgroups take
// the cluster's tiles in turn, each fed by two producer threads of its
// own: ctx in 64 x 64 bf16 boxes by TMA (128-byte swizzle, the K-major A
// operand of wgmma as it lands; an f32 ctx comes in 64 x 32 boxes that the
// warpgroup rounds to bf16 into that layout), through a ring as deep as
// shared memory allows (a whole tile at H 384), and the block's N columns
// of x.  The product is wgmma m64nNk16 with both operands in shared
// memory, two groups in flight, each stage freed once its group is done.
// The layernorm needs each row's sums over all H: each block sums its N
// columns (quad shuffles), sends the pair to every partner's shared memory
// by st.async, which completes the bytes on the partner's mbarrier, and
// adds the C parts in rank order, so every block gets the same bits; twice
// a tile (the sums, then the squares about the mean: the two-pass
// arithmetic), through four buffers a warpgroup.  To keep those exchanges
// off the critical path a warpgroup holds two tiles' accumulators
// (setmaxnreg 232 for the consumers, 40 for the producers): the product of
// tile i + 1 runs while tile i's sums travel, and its sums while tile i's
// squares do.  x is added to acc + b from shared memory and its tile freed
// at once; b, ln_scale and ln_bias live in registers for the kernel's
// life; y goes out from registers, a quad of lanes writing a row's 32
// contiguous bytes.  Rows past R arrive as zeros and are never stored.
// Blocks are persistent, at most as many clusters as the card holds at
// once (30 of 4 on the H100: 120 SMs).  Measured (PERF.md, the variants
// tool): the bf16 rerank launch in 0.28 ms of device time, 1.27x its
// bound and 0.92 of a plain copy's rate over the same bytes; TMA
// multicast of ctx to the cluster (a quarter of the L2 reads) ran 1.75x
// slower, clusters of 3 or 8, a third wgmma group and two x tiles slower
// too.
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

#include <algorithm>
#include <atomic>
#include <cstring>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

bool takes(int R, int H) { return R >= 1 && H >= 64 && H <= 512 && H % 64 == 0; }

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

// -- o-proj + residual + LN: W_o resident across a cluster, TMA, wgmma ------

constexpr int kResRows = 64;        // rows of a tile: one wgmma M
constexpr int kResThreads = 384;    // two consumer warpgroups, then four producer warps
constexpr int kResStage = 8192;     // a ctx stage: 64 rows x 128 B (64 bf16 or 32 f32)
constexpr int kResMaxStages = 8;    // ctx stages a consumer warpgroup, at most
constexpr int kResXchg = 4;         // exchange buffers a warpgroup: uses u % 4
constexpr int kResXTiles = 1;       // x tiles a warpgroup: tile k's in x tile k % kResXTiles
constexpr int kResProducerRegs = 40;   // setmaxnreg budgets: 40 x 128 + 232 x 256 <= 65,536
constexpr int kResConsumerRegs = 232;

// Bytes of dynamic shared memory for width H and slices of N columns (a
// cluster of H / N blocks) with `stages` ctx stages a consumer warpgroup:
// 1 KB to align to the swizzle's atoms, the W_o slice, both warpgroups'
// ctx rings, with an f32 ctx a bf16 K box each to convert into, both
// warpgroups' x tiles (64 x N f32), the row sums the cluster exchanges (a
// slot a block in each of four buffers a warpgroup) and the barriers
// (ops/fused_bert.py resid_smem is the same sum).
constexpr int resid_smem(int H, int N, bool ctx_bf16, int stages) {
  return 1024 + N * H * 2 + 2 * stages * kResStage + (ctx_bf16 ? 0 : 2 * kResStage) +
         2 * kResXTiles * kResRows * N * 4 + 2 * kResXchg * (H / N) * kResRows * 4 +
         8 * (1 + 4 * stages + 4 * kResXTiles + 2 * kResXchg);
}

// ctx stages a warpgroup: as many as fit, up to kResMaxStages
constexpr int resid_stages(int H, int N, bool ctx_bf16) {
  int s = kResMaxStages;
  while (s > 0 && resid_smem(H, N, ctx_bf16, s) > kSmemLimit) --s;
  return s;
}

template <int H, int N, bool BF>
struct Res {
  static constexpr int kC = H / N;                    // blocks of a cluster
  static constexpr int kXB = N % 32 == 0 ? 32 : 16;   // f32 columns of an x box
  static constexpr int kXBox = kResRows * kXB * 4;    // its bytes: 128- or 64-byte rows
  static constexpr int kXBoxes = N / kXB;             // boxes of a tile's x
  static constexpr int kXTile = kResRows * N * 4;
  static constexpr int kKB = H / 64;                  // 64-deep K boxes of the product
  static constexpr int kLoads = BF ? kKB : 2 * kKB;   // ctx boxes a tile
  static constexpr int kStages = resid_stages(H, N, BF);
  static constexpr int kCtxOff = N * H * 2;                           // [2][kStages][8 KB]
  static constexpr int kConvOff = kCtxOff + 2 * kStages * kResStage;  // f32 ctx: [2][8 KB]
  static constexpr int kXOff = kConvOff + (BF ? 0 : 2 * kResStage);   // [2][kResXTiles][kXTile]
  static constexpr int kRedOff = kXOff + 2 * kResXTiles * kXTile;     // [2][kResXchg][kC][64] f32
  static constexpr int kBarOff = kRedOff + 2 * kResXchg * kC * kResRows * 4;
  static constexpr int kSmem =
      1024 + kBarOff + 8 * (1 + 4 * kStages + 4 * kResXTiles + 2 * kResXchg);
  static_assert(kSmem == resid_smem(H, N, BF, kStages), "the layout is resid_smem's");
  static_assert(kStages >= 2 && kSmem <= kSmemLimit, "two ctx stages fit");
  static_assert(H % N == 0 && N % 16 == 0 && N <= 96 && kC <= 8,
                "a slice is a wgmma N whose two accumulators fit in registers");
  static_assert(kXOff % 1024 == 0, "x boxes on the swizzle's atoms");
};

// The block's shared memory from its 1024-aligned base.
template <int H, int N, bool BF>
struct ResSmem {
  using F = Res<H, N, BF>;
  unsigned char* base;
  __device__ unsigned char* w() const { return base; }  // [H / 64][N rows][128 B]
  __device__ unsigned char* stage(int wg, int s) const {
    return base + F::kCtxOff + (wg * F::kStages + s) * kResStage;
  }
  __device__ unsigned char* conv(int wg) const { return base + F::kConvOff + wg * kResStage; }
  __device__ unsigned char* xbox(int wg, int t, int q) const {
    return base + F::kXOff + (wg * kResXTiles + t) * F::kXTile + q * F::kXBox;
  }
  __device__ float* red(int wg, int buf) const {  // [kC][64]: a block's row sums each
    return reinterpret_cast<float*>(base + F::kRedOff) + (wg * kResXchg + buf) * F::kC * kResRows;
  }
  __device__ uint64_t* bar(int i) const { return reinterpret_cast<uint64_t*>(base + F::kBarOff) + i; }
  __device__ uint64_t* wbar() const { return bar(0); }
  __device__ uint64_t* cfull(int wg, int s) const { return bar(1 + wg * F::kStages + s); }
  __device__ uint64_t* cempty(int wg, int s) const { return bar(1 + (2 + wg) * F::kStages + s); }
  __device__ uint64_t* xfull(int wg, int t) const {
    return bar(1 + 4 * F::kStages + wg * kResXTiles + t);
  }
  __device__ uint64_t* xempty(int wg, int t) const {
    return bar(1 + 4 * F::kStages + (2 + wg) * kResXTiles + t);
  }
  __device__ uint64_t* xchg(int wg, int buf) const {
    return bar(1 + 4 * F::kStages + 4 * kResXTiles + wg * kResXchg + buf);
  }
};

// Byte offset of f32 column c of row r in an x box of kXB columns, as
// TMA lays it out with the 128-byte (kXB 32) or 64-byte (kXB 16) swizzle:
// the 16-byte granule j of a row sits at j ^ (the row's place in its
// 1024- or 512-byte atom).
template <int XB>
__device__ __forceinline__ int xoff(int r, int c) {
  if constexpr (XB == 32) return r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2));
  return r * 64 + ((((c >> 2) ^ ((r >> 1) & 3)) << 4) | ((c & 3) << 2));
}

// A producer thread: consumer warpgroup wg's ctx boxes, tile by tile, into
// its ring (bf16: 64 x 64, the K-major wgmma A operand as it lands; f32:
// 64 x 32, converted by the consumer); rows past R arrive as zeros.  The
// warpgroup's tiles are the cluster's j-th with j % 2 == wg.
template <int H, int N, bool BF>
__device__ __forceinline__ void res_ctx_loads(ResSmem<H, N, BF> sm, const CUtensorMap* cmap,
                                              int wg, int tiles) {
  using F = Res<H, N, BF>;
  int n = 0;
  for (int tile = cluster_id() + wg * cluster_count(); tile < tiles;
       tile += 2 * cluster_count()) {
    for (int b = 0; b < F::kLoads; ++b, ++n) {
      const int s = n % F::kStages;
      mbar_wait(sm.cempty(wg, s), ((n / F::kStages) & 1) ^ 1);  // the first round passes
      mbar_arrive_expect_tx(sm.cfull(wg, s), kResStage);
      tma_load_2d(sm.stage(wg, s), cmap, sm.cfull(wg, s), b * (BF ? 64 : 32), tile * kResRows);
    }
  }
}

// A producer thread: warpgroup wg's x, the block's N columns of each of
// its tiles, into its x tiles in turn (f32 boxes, or bf16 boxes at the
// start of each, unswizzled).
template <int H, int N, bool BF>
__device__ __forceinline__ void res_x_loads(ResSmem<H, N, BF> sm, const CUtensorMap* xmap, int wg,
                                            int tiles, int col0, int x_bf16) {
  using F = Res<H, N, BF>;
  int k = 0;
  for (int tile = cluster_id() + wg * cluster_count(); tile < tiles;
       tile += 2 * cluster_count(), ++k) {
    const int t = k % kResXTiles;
    mbar_wait(sm.xempty(wg, t), ((k / kResXTiles) & 1) ^ 1);
    mbar_arrive_expect_tx(sm.xfull(wg, t), x_bf16 ? F::kXTile / 2 : F::kXTile);
    for (int q = 0; q < F::kXBoxes; ++q)
      tma_load_2d(sm.xbox(wg, t, q), xmap, sm.xfull(wg, t), col0 + q * F::kXB, tile * kResRows);
  }
}

// The tile's product into acc (64 rows x N, f32): for each 64-deep K box,
// four wgmma m64nNk16 with A (the ctx box) and B (the resident W_o slice)
// in shared memory.  bf16 ctx: a box's stage is freed once the group that
// reads it is done (two groups in flight).  f32 ctx: two 64 x 32 boxes a
// K box, which the warpgroup rounds to bf16 into its conversion box (the
// same swizzled layout) and frees, then one group at a time.
template <int H, int N, bool BF>
__device__ __forceinline__ void res_product(float (&acc)[N / 2], ResSmem<H, N, BF> sm, int wg,
                                            int tid, int& n) {
  using F = Res<H, N, BF>;
  const uint64_t dw = wgmma_desc_sw128(sm.w());
#pragma unroll 1
  for (int kb = 0; kb < F::kKB; ++kb) {
    const unsigned char* a;
    if constexpr (BF) {
      const int s = n % F::kStages;
      mbar_wait(sm.cfull(wg, s), (n / F::kStages) & 1);
      a = sm.stage(wg, s);
    } else {
      const int s0 = n % F::kStages, s1 = (n + 1) % F::kStages;
      mbar_wait(sm.cfull(wg, s0), (n / F::kStages) & 1);
      mbar_wait(sm.cfull(wg, s1), ((n + 1) / F::kStages) & 1);
      unsigned char* cv = sm.conv(wg);  // its last reader, the previous group, is done
#pragma unroll 1
      for (int p = 0; p < 4; ++p) {  // 64 rows x 8 granules of 8 bf16, 4 a thread
        const int m = tid + 128 * p, r = m >> 3, oc = m & 7;
        const unsigned char* box = sm.stage(wg, oc < 4 ? s0 : s1) + r * 128;
        const int c4 = 2 * (oc & 3);  // the granules of f32 columns 8 (oc % 4) .. + 7
        const float4 lo = *reinterpret_cast<const float4*>(box + ((c4 ^ (r & 7)) << 4));
        const float4 hi = *reinterpret_cast<const float4*>(box + (((c4 + 1) ^ (r & 7)) << 4));
        *reinterpret_cast<uint4*>(cv + r * 128 + ((oc ^ (r & 7)) << 4)) =
            make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                       pack_bf16(hi.z, hi.w));
      }
      release(sm.cempty(wg, s0));
      release(sm.cempty(wg, s1));
      fence_proxy_async();  // the box's stores before the wgmmas read it
      named_barrier(1 + wg, 128);
      a = cv;
    }
    const uint64_t da = wgmma_desc_sw128(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(acc, da + ((kk * 32) >> 4), dw + ((kb * N * 128 + kk * 32) >> 4),
               (kb | kk) != 0);
    wgmma_commit();
    if constexpr (BF) {
      wgmma_wait<1>();
      if (kb > 0) release(sm.cempty(wg, (n - 1) % F::kStages));
      n += 1;
    } else {
      wgmma_wait<0>();
      n += 2;
    }
  }
  wgmma_wait<0>();
  wgmma_pin(acc);
  if constexpr (BF) release(sm.cempty(wg, (n - 1) % F::kStages));
}

// A consumer thread's columns 8j + 2t, + 1 (j < N / 8) of b, ln_scale and
// ln_bias, loaded once for the kernel's life (3 N / 4 registers).
template <int N>
struct ResCols {
  float2 b[N / 8], s[N / 8], lb[N / 8];
  __device__ void load(const float* __restrict__ bias, const float* __restrict__ ln_s,
                       const float* __restrict__ ln_b, int col0) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      b[j] = __ldg(reinterpret_cast<const float2*>(bias + col0 + 8 * j));
      s[j] = __ldg(reinterpret_cast<const float2*>(ln_s + col0 + 8 * j));
      lb[j] = __ldg(reinterpret_cast<const float2*>(ln_b + col0 + 8 * j));
    }
  }
};

// The row sums of a tile's rows ra and ra + 8 through the cluster.  Each
// block sums its N columns (a quad of lanes holds a row); use u of the
// warpgroup (two a tile: the sums, then the squares about the mean) goes
// through buffer u % 4.  res_send: lane t == 0 puts the pair into slot
// `rank` of each partner's buffer by st.async, which completes 8 bytes on
// the partner's barrier of that buffer; thread 0 expects (C - 1) x 256
// bytes on its own.  res_total: wait, then add the blocks' parts in rank
// order, so every block of the cluster gets the same bits.  A warpgroup
// has at most two uses sent and not yet waited for, and reads a use right
// after its wait: a partner sends use u only after use u - 2 is complete
// everywhere, which needs this block's part of u - 2, sent after it read
// use u - 4 (the quad shuffles order a warp's reads before its sends).
template <int H, int N, bool BF>
__device__ __forceinline__ void res_send(float s0, float s1, ResSmem<H, N, BF> sm, int wg, int tid,
                                         uint32_t rank, int u) {
  using F = Res<H, N, BF>;
  if constexpr (F::kC > 1) {
    const int idx = ((tid >> 5) * 8 + ((tid & 31) >> 2)) * 2;  // rows ra, ra + 8
    float* slot = sm.red(wg, u % kResXchg);
    uint64_t* bar = sm.xchg(wg, u % kResXchg);
    if (tid == 0) mbar_arrive_expect_tx(bar, (F::kC - 1) * kResRows * 4);
    if ((tid & 3) == 0) {
      const uint32_t mine = smem_addr(slot + rank * kResRows + idx), b = smem_addr(bar);
#pragma unroll
      for (int p = 1; p < F::kC; ++p) {
        const uint32_t q = (rank + p) % F::kC;
        st_async_v2(mapa(mine, q), s0, s1, mapa(b, q));
      }
    }
  }
}

template <int H, int N, bool BF>
__device__ __forceinline__ float2 res_total(float s0, float s1, ResSmem<H, N, BF> sm, int wg,
                                            int tid, uint32_t rank, int u) {
  using F = Res<H, N, BF>;
  if constexpr (F::kC == 1) {
    return make_float2(s0, s1);
  } else {
    const int idx = ((tid >> 5) * 8 + ((tid & 31) >> 2)) * 2;
    const float* slot = sm.red(wg, u % kResXchg);
    mbar_wait_cluster(sm.xchg(wg, u % kResXchg), (u / kResXchg) & 1);
    float t0 = 0.f, t1 = 0.f;
#pragma unroll
    for (int p = 0; p < F::kC; ++p) {
      const float2 v = p == (int)rank ? make_float2(s0, s1)
                                      : *reinterpret_cast<const float2*>(slot + p * kResRows + idx);
      t0 += v.x;
      t1 += v.y;
    }
    return make_float2(t0, t1);
  }
}

// The epilogue of the warpgroup's k-th tile, y = LN(x + (acc + b)) for its
// rows ra, ra + 8 and the block's N columns, in three steps that another
// tile's work separates, so that each exchange travels meanwhile:
// res_sums: x from the tile's boxes into acc, the x tile freed, the row
// sums sent (use 2k); returns this block's parts.
template <int H, int N, bool BF>
__device__ __forceinline__ float2 res_sums(float (&acc)[N / 2], ResSmem<H, N, BF> sm, int wg,
                                           int tid, uint32_t rank, int k, const ResCols<N>& cols,
                                           int x_bf16) {
  using F = Res<H, N, BF>;
  constexpr int XB = F::kXB;
  const int t = tid & 3, ra = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int xt = k % kResXTiles;
  mbar_wait(sm.xfull(wg, xt), (k / kResXTiles) & 1);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int cb = (8 * j) % XB + 2 * t;  // acc[4j + 2h + e]: row ra + 8h, column 8j + 2t + e
    const unsigned char* box = sm.xbox(wg, xt, 8 * j / XB);
    const float2 bb = cols.b[j];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ra + 8 * h;
      float2 xv;
      if (x_bf16) {
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(box + r * XB * 2 + cb * 2);
        xv = __bfloat1622float2(v);
      } else {
        xv = *reinterpret_cast<const float2*>(box + xoff<XB>(r, cb));
      }
      acc[4 * j + 2 * h] = xv.x + (acc[4 * j + 2 * h] + bb.x);
      acc[4 * j + 2 * h + 1] = xv.y + (acc[4 * j + 2 * h + 1] + bb.y);
    }
    s0 += acc[4 * j] + acc[4 * j + 1];
    s1 += acc[4 * j + 2] + acc[4 * j + 3];
  }
  release(sm.xempty(wg, xt));  // the producer may load x tile k + kResXTiles here
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);
  res_send<H, N, BF>(s0, s1, sm, wg, tid, rank, 2 * k);
  return make_float2(s0, s1);
}

// res_squares: the means from use 2k, this block's sums of squares about
// them sent (use 2k + 1); returns the means and this block's parts.
template <int H, int N, bool BF>
__device__ __forceinline__ float4 res_squares(const float (&acc)[N / 2], float2 part,
                                              ResSmem<H, N, BF> sm, int wg, int tid,
                                              uint32_t rank, int k) {
  const float2 tot = res_total<H, N, BF>(part.x, part.y, sm, wg, tid, rank, 2 * k);
  const float mu0 = tot.x / H, mu1 = tot.y / H;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float d0 = acc[4 * j] - mu0, d1 = acc[4 * j + 1] - mu0;
    const float d2 = acc[4 * j + 2] - mu1, d3 = acc[4 * j + 3] - mu1;
    s0 += d0 * d0 + d1 * d1;
    s1 += d2 * d2 + d3 * d3;
  }
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);
  res_send<H, N, BF>(s0, s1, sm, wg, tid, rank, 2 * k + 1);
  return make_float4(mu0, mu1, s0, s1);
}

// res_store: the variances from use 2k + 1; y stored from registers
// (each quad of lanes writes a row's 32 contiguous bytes, full sectors),
// rows past R skipped.
template <int H, int N, bool BF>
__device__ __forceinline__ void res_store(const float (&acc)[N / 2], float4 st,
                                          ResSmem<H, N, BF> sm, int wg, int tid, uint32_t rank,
                                          int k, int tile, float* __restrict__ y, int R,
                                          const ResCols<N>& cols, float eps) {
  const int t = tid & 3, ra = 16 * (tid >> 5) + ((tid & 31) >> 2), col0 = rank * N;
  const float2 tot = res_total<H, N, BF>(st.z, st.w, sm, wg, tid, rank, 2 * k + 1);
  const float mu0 = st.x, mu1 = st.y;
  const float rs0 = rsqrtf(tot.x / H + eps), rs1 = rsqrtf(tot.y / H + eps);
  const int row0 = tile * kResRows + ra;
  float* y0 = y + (size_t)row0 * H + col0 + 2 * t;
  float* y1 = y0 + (size_t)8 * H;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 sc = cols.s[j], lb = cols.lb[j];
    if (row0 < R)
      *reinterpret_cast<float2*>(y0 + 8 * j) =
          make_float2((acc[4 * j] - mu0) * rs0 * sc.x + lb.x,
                      (acc[4 * j + 1] - mu0) * rs0 * sc.y + lb.y);
    if (row0 + 8 < R)
      *reinterpret_cast<float2*>(y1 + 8 * j) =
          make_float2((acc[4 * j + 2] - mu1) * rs1 * sc.x + lb.x,
                      (acc[4 * j + 3] - mu1) * rs1 * sc.y + lb.y);
  }
}

// A consumer warpgroup: its tiles i = 0, 1, ... (the cluster's tile
// cluster id + (2 i + wg) clusters) alternate between two accumulators,
// and each tile's epilogue steps interleave with the next tile's: the
// product of tile i + 1 runs while the sums of tile i travel, its sums
// while tile i's squares do.
template <int H, int N, bool BF>
__device__ __forceinline__ void res_consume(ResSmem<H, N, BF> sm, uint32_t rank, int tiles,
                                            const float* __restrict__ b,
                                            const float* __restrict__ ln_s,
                                            const float* __restrict__ ln_b, float eps,
                                            float* __restrict__ y, int R, int x_bf16) {
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int first = cluster_id() + wg * cluster_count(), step = 2 * cluster_count();
  ResCols<N> cols;
  cols.load(b, ln_s, ln_b, rank * N + 2 * (tid & 3));
  mbar_wait(sm.wbar(), 0);
  float a0[N / 2], a1[N / 2];
  float2 p0, p1;
  int n = 0;  // ctx boxes taken
  if (first < tiles) {
    res_product<H, N, BF>(a0, sm, wg, tid, n);
    p0 = res_sums<H, N, BF>(a0, sm, wg, tid, rank, 0, cols, x_bf16);
    for (int i = 1;; i += 2) {  // a0 holds tile i - 1, its sums sent
      const bool more = first + i * step < tiles;
      if (more) res_product<H, N, BF>(a1, sm, wg, tid, n);
      const float4 st0 = res_squares<H, N, BF>(a0, p0, sm, wg, tid, rank, i - 1);
      if (more) p1 = res_sums<H, N, BF>(a1, sm, wg, tid, rank, i, cols, x_bf16);
      res_store<H, N, BF>(a0, st0, sm, wg, tid, rank, i - 1, first + (i - 1) * step, y, R, cols,
                          eps);
      if (!more) break;
      const bool more0 = first + (i + 1) * step < tiles;  // a1 holds tile i
      if (more0) res_product<H, N, BF>(a0, sm, wg, tid, n);
      const float4 st1 = res_squares<H, N, BF>(a1, p1, sm, wg, tid, rank, i);
      if (more0) p0 = res_sums<H, N, BF>(a0, sm, wg, tid, rank, i + 1, cols, x_bf16);
      res_store<H, N, BF>(a1, st1, sm, wg, tid, rank, i, first + i * step, y, R, cols, eps);
      if (!more0) break;
    }
  }
}

// Persistent blocks in clusters of C = H / N on neighbouring SMs.  A
// cluster walks row tiles of 64 (tile = cluster id, + clusters, ...); its
// block of rank r owns output columns [r N, (r + 1) N) and holds that
// slice of W_o (N x H bf16, read by TMA once) for its whole life.
// Consumer warpgroup wg (threads 128 wg ..) takes the cluster's tiles j
// with j % 2 == wg; producer warps 8 + wg and 10 + wg load its ctx and x
// (warp 8 first W_o's slice).
template <int H, int N, bool BF>
__global__ void __launch_bounds__(kResThreads, 1)
resid_ln_kernel(const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap, const float* __restrict__ b,
                const float* __restrict__ ln_s, const float* __restrict__ ln_b, float eps,
                float* __restrict__ y, int R, int x_bf16) {
  using F = Res<H, N, BF>;
  extern __shared__ unsigned char smem_raw[];
  const ResSmem<H, N, BF> sm{smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023)};
  const uint32_t rank = cluster_rank();
  const int tiles = (R + kResRows - 1) / kResRows;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    mbar_init(sm.wbar(), 1);
    for (int wg = 0; wg < 2; ++wg) {
      for (int s = 0; s < F::kStages; ++s) {
        mbar_init(sm.cfull(wg, s), 1);
        mbar_init(sm.cempty(wg, s), 4);  // each warp of the consuming warpgroup
      }
      for (int t = 0; t < kResXTiles; ++t) {
        mbar_init(sm.xfull(wg, t), 1);
        mbar_init(sm.xempty(wg, t), 4);  // each warp of the warpgroup, once it has read x
      }
      for (int buf = 0; buf < kResXchg; ++buf) mbar_init(sm.xchg(wg, buf), 1);
    }
    mbar_init_fence();
  }
  __syncthreads();
  cluster_sync();  // every block's barriers are set before a partner sends to them
  if (warp >= 8) {
    setmaxnreg_dec<kResProducerRegs>();
    if ((threadIdx.x & 31) == 0) {
      const int p = warp - 8;
      if (p == 0) {  // the slice: H / 64 boxes of [N rows][64 bf16]
        mbar_arrive_expect_tx(sm.wbar(), (uint32_t)(N * H * 2));
        for (int kb = 0; kb < F::kKB; ++kb)
          tma_load_2d(sm.w() + kb * N * 128, &wmap, sm.wbar(), kb * 64, rank * N);
      }
      if (p < 2)
        res_ctx_loads<H, N, BF>(sm, &cmap, p, tiles);
      else
        res_x_loads<H, N, BF>(sm, &xmap, p - 2, tiles, rank * N, x_bf16);
    }
    __syncwarp();
  } else {
    setmaxnreg_inc<kResConsumerRegs>();  // two accumulators of N / 2 a thread
    res_consume<H, N, BF>(sm, rank, tiles, b, ln_s, ln_b, eps, y, R, x_bf16);
  }
  cluster_sync();  // no block leaves while a partner may still write into it
}

// The launch configuration of a variant: its blocks, shared memory and
// cluster size.
template <int H, int N, bool BF>
struct ResLaunch {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  ResLaunch(unsigned ctas, cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = Res<H, N, BF>::kC;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.gridDim = dim3(ctas);
    config.blockDim = dim3(kResThreads);
    config.dynamicSmemBytes = Res<H, N, BF>::kSmem;
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = 1;
  }
};

// The clusters of this variant the current device holds at once, found
// once per device with the kernel's shared memory raised (0 in `fit`:
// not yet); host threads may launch at once, and each may take that
// first step.
template <int H, int N, bool BF>
cudaError_t resid_clusters(int* clusters) {
  static std::atomic<int> fit[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int c = fit[dev & 63].load(std::memory_order_acquire);
  if (c == 0) {
    err = set_smem(resid_ln_kernel<H, N, BF>, Res<H, N, BF>::kSmem);
    if (err != cudaSuccess) return err;
    ResLaunch<H, N, BF> launch(Res<H, N, BF>::kC, nullptr);
    err = cudaOccupancyMaxActiveClusters(&c, resid_ln_kernel<H, N, BF>, &launch.config);
    if (err != cudaSuccess) return err;
    if (c < 1) return cudaErrorInvalidConfiguration;
    fit[dev & 63].store(c, std::memory_order_release);
  }
  *clusters = c;
  return cudaSuccess;
}

// One launch on the plan's ctx stages and blocks (at most as many
// clusters as the device holds at once: a cluster waiting for another to
// finish would double the time).  Only the maps of x and ctx are encoded
// here; W_o's comes encoded (resid_ln_wmap).
template <int H, int N, bool BF>
int launch_resid(const void* x, int x_bf16, const void* ctx, const void* wmap, const float* b,
                 const float* ln_s, const float* ln_b, float eps, float* y, int R, int stages,
                 int ctas, cudaStream_t stream) {
  using F = Res<H, N, BF>;
  if (stages != F::kStages) return (int)cudaErrorInvalidValue;
  const CUtensorMapSwizzle xswz =
      F::kXB == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap cmap, xmap, wm;
  std::memcpy(&wm, wmap, sizeof(wm));
  const bool ok =
      (BF ? tensor_map(&cmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ctx, 1, R, H, kResRows, 64)
          : tensor_map(&cmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ctx, 1, R, H, kResRows, 32)) &&
      (x_bf16 ? tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, 1, R, H, kResRows,
                           F::kXB, CU_TENSOR_MAP_SWIZZLE_NONE)
              : tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, 1, R, H, kResRows,
                           F::kXB, xswz));
  if (!ok) return (int)cudaErrorInvalidValue;
  int clusters = 0;
  cudaError_t err = resid_clusters<H, N, BF>(&clusters);
  if (err != cudaSuccess) return (int)err;
  ResLaunch<H, N, BF> launch((unsigned)std::min(ctas, clusters * F::kC), stream);
  err = cudaLaunchKernelEx(&launch.config, resid_ln_kernel<H, N, BF>, cmap, xmap, wm, b, ln_s,
                           ln_b, eps, y, R, x_bf16);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

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

// (H, N) of every plan ops/fused_bert.py resid_plan makes (N = H / the
// cluster size), for a bf16 and for an f32 context alike
#define RESID_PLANS(X) X(64, 64) X(128, 64) X(192, 96) X(256, 64) X(320, 80) X(384, 96) X(448, 64) X(512, 64)

// W_o's tensor map for clusters of `cluster` blocks, into `map` (128
// bytes): W_o (H, H) bf16 in nn.Linear's (out, in) layout, 16-byte
// aligned, read in boxes of H / cluster rows x 64 (128-byte swizzle).  A
// caller encodes it once for a weight it keeps (ops/fused_bert.py
// pack_resid) and passes it to every launch.
extern "C" int resid_ln_wmap(const void* w, int H, int cluster, void* map) {
  CUtensorMap m;
  if (H < 64 || H > 512 || H % 64 != 0 || cluster < 1 || H % cluster != 0 ||
      H / cluster > 256 || (uintptr_t)w % 16 != 0 ||
      !tensor_map(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, 1, H, H, H / cluster, 64))
    return (int)cudaErrorInvalidValue;
  std::memcpy(map, &m, sizeof(m));
  return 0;
}

// How many clusters of the plan's variant the current device holds at
// once, into *clusters.
extern "C" int resid_ln_clusters(int H, int cluster, int ctx_bf16, int* clusters) {
  const int N = cluster > 0 ? H / cluster : 0;
#define RESID_FIT(HH, NN, BFV) \
  if (H == HH && N == NN) return (int)resid_clusters<HH, NN, BFV>(clusters);
#define RESID_FIT_BF16(HH, NN) RESID_FIT(HH, NN, true)
#define RESID_FIT_F32(HH, NN) RESID_FIT(HH, NN, false)
  if (ctx_bf16) {
    RESID_PLANS(RESID_FIT_BF16)
  } else {
    RESID_PLANS(RESID_FIT_F32)
  }
#undef RESID_FIT_F32
#undef RESID_FIT_BF16
#undef RESID_FIT
  return (int)cudaErrorInvalidValue;
}

// y = LN(x + ctx W_o^T + b) (f32, (R, H)), x f32 or bf16 (x_bf16), ctx
// f32 or bf16 (ctx_bf16), W_o by its map (resid_ln_wmap, made for this
// cluster size).  The plan comes from the caller (ops/fused_bert.py
// resid_plan): `cluster` blocks a cluster, each owning H / cluster output
// columns, `stages` the variant's own, `ctas` blocks (a multiple of the
// cluster, at most a cluster a row tile of 64).  x, ctx
// and y must be 16-byte aligned.
extern "C" int fused_resid_ln(const void* x, int x_bf16, const void* ctx, int ctx_bf16,
                              const void* wmap, const void* b, const void* ln_s, const void* ln_b,
                              float eps, void* y, int R, int H, int cluster, int stages,
                              int ctas, void* stream) {
  const long long tiles = ((long long)R + kResRows - 1) / kResRows;
  if (!takes(R, H) || cluster < 1 || H % cluster != 0 || ctas < cluster || ctas % cluster != 0 ||
      ctas / cluster > tiles || wmap == nullptr ||
      ((uintptr_t)x | (uintptr_t)ctx | (uintptr_t)y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int N = H / cluster;
#define RESID_CASE(HH, NN, BFV)                                                               \
  if (H == HH && N == NN)                                                                     \
    return launch_resid<HH, NN, BFV>(x, x_bf16, ctx, wmap, (const float*)b, (const float*)ln_s, \
                                     (const float*)ln_b, eps, (float*)y, R, stages, ctas,      \
                                     (cudaStream_t)stream);
#define RESID_CASE_BF16(HH, NN) RESID_CASE(HH, NN, true)
#define RESID_CASE_F32(HH, NN) RESID_CASE(HH, NN, false)
  if (ctx_bf16) {
    RESID_PLANS(RESID_CASE_BF16)
  } else {
    RESID_PLANS(RESID_CASE_F32)
  }
#undef RESID_CASE_F32
#undef RESID_CASE_BF16
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
