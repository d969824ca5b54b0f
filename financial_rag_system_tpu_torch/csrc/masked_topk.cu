// Masked cosine similarity and top-k over a device-resident corpus.
//
// Replaces financial_rag_system_tpu/ops/topk.py:_topk_kernel (the Pallas
// kernel behind masked_topk_pallas) and computes what it computes: the
// bf16 x bf16 score of each of B queries against every corpus row, summed
// in f32; a row is masked out when it fails the query's [ticker,
// doc_type] code filter (-1 is the wildcard) or sits at or beyond
// n_valid; the (B, K) best come out in descending score, and equal scores
// go to the lower global row id (the Pallas merge's lowest-position rule,
// topk.py:186-196).  Empty slots come out as score -inf and id -1, which
// differs from the Pallas kernel's id 0: callers treat -inf as empty and
// clamp ids before the token-store gather (ops/fused_query.py).
//
// Bound on the H100 at the serving shape (B = 32, N = 131,072, D = 384,
// K = 15): the corpus and its codes, about 101.7 MB, read once at 3.35
// TB/s is about 30 us; the 3.2 GFLOP of products take 3 us at the bf16
// tensor-core peak.  It is memory bound.
// Design: the Pallas grid walks the corpus in order and carries the best
// list from tile to tile; Hopper blocks run in no order, so the work is
// split in two passes.
//  - Pass 1, grid (corpus splits) x (query blocks of 32): each block
//    stages its query block in shared memory, streams its contiguous range
//    of corpus rows in 64-row tiles (16-byte coalesced loads), scores each
//    tile on the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums; one
//    32-query x 8-row slice a warp), then each lane takes one query,
//    masks its warp's 8 rows and merges them into a best list kept in
//    registers; the 8 warps' lists merge in shared memory and the block
//    writes a (B, splits, K) partial.
//  - Pass 2, one warp per query: K rounds of a warp arg-max over the
//    splits*K candidates, each round taking the best candidate that ranks
//    after the last one taken.
// The corpus is read exactly once.  Loads are not yet overlapped with the
// scoring (no cp.async / TMA pipeline), which keeps it above its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQB = 32;      // queries per block: two m16 tiles, lane = query
constexpr int kWarps = 8;    // 256 threads, one n8 slice of the tile each
constexpr int kTile = 64;    // corpus rows per shared-memory tile
constexpr int kMaxK = 32;    // per-query list kept by pass 1 (>= k)
constexpr int kMaxD = 1024;
constexpr int kNoId = 0x7fffffff;

// (s1, i1) ranks before (s2, i2): higher score, then lower row id
__device__ __forceinline__ bool before(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// Insert (s, id) into a sorted register list if it ranks before the last
// entry.  Fully unrolled, so the list stays in registers.
__device__ __forceinline__ bool insert(float (&ls)[kMaxK], int (&li)[kMaxK], float s, int id) {
  if (!before(s, id, ls[kMaxK - 1], li[kMaxK - 1])) return false;
  ls[kMaxK - 1] = s;
  li[kMaxK - 1] = id;
#pragma unroll
  for (int p = kMaxK - 1; p > 0; --p) {
    if (before(ls[p], li[p], ls[p - 1], li[p - 1])) {
      const float ts = ls[p]; ls[p] = ls[p - 1]; ls[p - 1] = ts;
      const int ti = li[p]; li[p] = li[p - 1]; li[p - 1] = ti;
    }
  }
  return true;
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kWarps * 32)
topk_partial_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ corpus,
                    const int32_t* __restrict__ codes,
                    const int32_t* __restrict__ qf, int B, int N, int D,
                    int n_valid, int k, int rows_per_split,
                    float* __restrict__ part_s, int32_t* __restrict__ part_i) {
  extern __shared__ __align__(16) uint32_t smem_u32[];
  // rows of bf16 pairs, padded by 4 words: (D/2 + 4) is 4 mod 8 words, so
  // the fragment loads of 8 rows x 4 words hit 32 distinct banks
  const int stride = D / 2 + 4;
  const int vecs = D / 8;                              // 16-byte chunks a row
  uint32_t* qs = smem_u32;                             // [kQB][stride]
  uint32_t* ct = qs + kQB * stride;                    // [kTile][stride]
  float* sc = reinterpret_cast<float*>(ct + kTile * stride);  // [kQB][kTile + 1]
  int32_t* tcodes = reinterpret_cast<int32_t*>(sc + kQB * (kTile + 1));  // [2][kTile]
  float* ms = reinterpret_cast<float*>(tcodes + 2 * kTile);            // [kQB][kMaxK]
  int32_t* mi = reinterpret_cast<int32_t*>(ms + kQB * kMaxK);          // [kQB][kMaxK]

  const int split = blockIdx.x;
  const int qb0 = blockIdx.y * kQB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int splits = gridDim.x;

  // stage the query block (zeros past B)
  const uint4* q16 = reinterpret_cast<const uint4*>(q);
  for (int i = threadIdx.x; i < kQB * vecs; i += blockDim.x) {
    const int r = i / vecs, c = i % vecs;
    *reinterpret_cast<uint4*>(qs + r * stride + c * 4) =
        (qb0 + r < B) ? q16[(size_t)(qb0 + r) * vecs + c] : make_uint4(0, 0, 0, 0);
  }
  const int qi = qb0 + lane;
  const bool live = qi < B;
  const int tq = live ? qf[qi * 2] : -3;
  const int dq = live ? qf[qi * 2 + 1] : -3;

  float ls[kMaxK];
  int li[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) { ls[j] = -INFINITY; li[j] = kNoId; }

  const int r0 = split * rows_per_split;
  const int r1 = min(N, r0 + rows_per_split);
  const uint4* c16 = reinterpret_cast<const uint4*>(corpus);
  const int n0 = warp * 8;  // this warp's 8 rows of each tile
  for (int t0 = r0; t0 < r1; t0 += kTile) {
    __syncthreads();  // the previous tile's rows and scores are consumed
    const int nrows = min(kTile, r1 - t0);
    for (int i = threadIdx.x; i < kTile * vecs; i += blockDim.x) {
      const int r = i / vecs, c = i % vecs;
      *reinterpret_cast<uint4*>(ct + r * stride + c * 4) =
          (r < nrows) ? c16[(size_t)(t0 + r) * vecs + c] : make_uint4(0, 0, 0, 0);
    }
    for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
      tcodes[r] = (r < nrows) ? codes[t0 + r] : -2;
      tcodes[kTile + r] = (r < nrows) ? codes[(size_t)N + t0 + r] : -2;
    }
    __syncthreads();

    // (32 queries) x (8 rows) scores on the tensor cores
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const uint32_t* crow = ct + (n0 + g) * stride + t;
    const uint32_t* qa = qs + g * stride + t;
    for (int kk = 0; kk < D / 16; ++kk) {
      const int w = kk * 8;
      const uint32_t b0 = crow[w], b1 = crow[w + 4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t* qm = qa + mt * 16 * stride + w;
        mma_bf16(acc[mt], qm[0], qm[8 * stride], qm[4], qm[8 * stride + 4], b0, b1);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float* s0 = sc + (mt * 16 + g) * (kTile + 1) + n0 + t * 2;
      float* s8 = s0 + 8 * (kTile + 1);
      s0[0] = acc[mt][0];
      s0[1] = acc[mt][1];
      s8[0] = acc[mt][2];
      s8[1] = acc[mt][3];
    }
    __syncwarp();

    // lane = query: mask the warp's 8 rows and merge them into the list
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = n0 + j;
      const int gid = t0 + r;
      const int tc = tcodes[r], dc = tcodes[kTile + r];
      const bool ok = live && r < nrows && gid < n_valid &&
                      (tq == -1 || tq == tc) && (dq == -1 || dq == dc);
      if (ok) insert(ls, li, sc[lane * (kTile + 1) + r], gid);
    }
  }

  // merge the warps' lists into warp 0's, one warp at a time
  for (int w = 1; w < kWarps; ++w) {
    __syncthreads();
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) { ms[lane * kMaxK + j] = ls[j]; mi[lane * kMaxK + j] = li[j]; }
    }
    __syncthreads();
    if (warp == 0) {
      for (int j = 0; j < kMaxK; ++j) {
        // entries arrive sorted: once one fails to enter, the rest do too
        if (!insert(ls, li, ms[lane * kMaxK + j], mi[lane * kMaxK + j])) break;
      }
    }
  }
  if (warp == 0 && live) {
    const size_t o = ((size_t)qi * splits + split) * k;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k) { part_s[o + j] = ls[j]; part_i[o + j] = li[j]; }
    }
  }
}

__global__ void topk_merge_kernel(const float* __restrict__ part_s,
                                  const int32_t* __restrict__ part_i, int n_cand,
                                  int k, float* __restrict__ out_s,
                                  int32_t* __restrict__ out_i) {
  const int qi = blockIdx.x, lane = threadIdx.x;
  const float* ps = part_s + (size_t)qi * n_cand;
  const int32_t* pi = part_i + (size_t)qi * n_cand;
  float last_s = INFINITY;
  int last_i = -1;
  for (int j = 0; j < k; ++j) {
    float bs = -INFINITY;
    int bi = kNoId;
    for (int c = lane; c < n_cand; c += 32) {
      const float s = ps[c];
      const int id = pi[c];
      if (s > -INFINITY && before(last_s, last_i, s, id) && before(s, id, bs, bi)) {
        bs = s;
        bi = id;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (before(os, oi, bs, bi)) { bs = os; bi = oi; }
    }
    if (lane == 0) {
      out_s[(size_t)qi * k + j] = bs;
      out_i[(size_t)qi * k + j] = bs > -INFINITY ? bi : -1;
    }
    last_s = bs;
    last_i = bi;
  }
}

}  // namespace

extern "C" size_t masked_topk_scratch_count(int B, int N, int rows_per_split, int k) {
  const int splits = (N + rows_per_split - 1) / rows_per_split;
  return (size_t)B * splits * k;
}

// Returns a cudaError_t: 1 (cudaErrorInvalidValue) for shapes the kernel
// does not take, else the first launch error.  part_s / part_i hold
// masked_topk_scratch_count() elements each.
extern "C" int masked_topk(const void* q, const void* corpus, const void* codes,
                           const void* qf, int B, int N, int D, int n_valid, int k,
                           int rows_per_split, void* part_s, void* part_i,
                           void* out_s, void* out_i, void* stream) {
  if (B < 1 || N < 1 || D < 16 || D > kMaxD || D % 16 != 0 || k < 1 || k > kMaxK ||
      rows_per_split < 1)
    return (int)cudaErrorInvalidValue;
  const int splits = (N + rows_per_split - 1) / rows_per_split;
  const int qblocks = (B + kQB - 1) / kQB;
  const size_t smem = sizeof(uint32_t) * (size_t)(kQB + kTile) * (D / 2 + 4) +
                      sizeof(float) * kQB * (kTile + 1) + sizeof(int32_t) * 2 * kTile +
                      (sizeof(float) + sizeof(int32_t)) * kQB * kMaxK;
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  topk_partial_kernel<<<dim3(splits, qblocks), kWarps * 32, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)corpus, (const int32_t*)codes,
      (const int32_t*)qf, B, N, D, n_valid, k, rows_per_split, (float*)part_s,
      (int32_t*)part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_merge_kernel<<<B, 32, 0, s>>>((const float*)part_s, (const int32_t*)part_i,
                                     splits * k, k, (float*)out_s, (int32_t*)out_i);
  return (int)cudaGetLastError();
}
