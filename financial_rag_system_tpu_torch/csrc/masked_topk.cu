// Masked cosine similarity and top-k over a device-resident corpus.
//
// Replaces financial_rag_system_tpu/ops/topk.py:_topk_kernel (the Pallas
// kernel behind masked_topk_pallas) and computes what it computes: the
// score of each of B queries against every corpus row, bf16 x bf16 summed
// in f32 (masked_topk), or int8 x int8 summed in s32 and cast to f32,
// which is exact (masked_topk_s8: the Pallas kernel's int8 branch,
// topk.py:129-140, whose two variants give the same scores); a row is
// masked out when it fails the query's [ticker,
// doc_type] code filter (-1 is the wildcard) or sits at or beyond
// n_valid; the (B, K) best come out in descending score, and equal scores
// go to the lower global row id (the Pallas merge's lowest-position rule,
// topk.py:186-196).  Empty slots come out as score -inf and id -1, which
// differs from the Pallas kernel's id 0: callers treat -inf as empty and
// clamp ids before the token-store gather (ops/fused_query.py).
//
// Bound on the H100 at the serving shape (B = 32, N = 131,072, D = 384,
// K = 15): the corpus and its codes, about 101.7 MB in bf16 (51.4 MB in
// int8), read once at 3.35 TB/s is about 30 us (15 us); the 3.2 G
// operations of products take 3 us at the bf16 tensor-core peak (1.6 us
// at the int8 peak).  It is memory bound.
// Design: the Pallas grid walks the corpus in order and carries the best
// list from tile to tile; Hopper blocks run in no order, so the work is
// split in two passes (topk_common.cuh has the shared pieces).
//  - Pass 1, grid (corpus splits) x (query blocks of 32): each block
//    streams its contiguous range of corpus rows in 64-row tiles, scores
//    them on the tensor cores and keeps a per-query best list in
//    registers, then writes a (B, splits, K) partial.
//  - Pass 2, one warp per query: merges the splits' lists.
// The corpus is read exactly once.  Loads are not yet overlapped with the
// scoring (no cp.async / TMA pipeline), which keeps it above its bound.

#include "topk_common.cuh"

using namespace topk;

namespace {

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
topk_partial_kernel(const T* __restrict__ q, const T* __restrict__ corpus,
                    const int32_t* __restrict__ codes,
                    const int32_t* __restrict__ qf, int B, int N, int D,
                    int n_valid, int k, int rows_per_split,
                    float* __restrict__ part_s, int32_t* __restrict__ part_i) {
  extern __shared__ __align__(16) uint32_t smem_u32[];
  const int W = D / Elem<T>::kPerWord;
  const Smem m = carve(smem_u32, W);

  const int split = blockIdx.x;
  const int qb0 = blockIdx.y * kQB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int splits = gridDim.x;

  // stage the query block (zeros past B)
  stage_rows(m.qs, q + (size_t)qb0 * D, kQB, min(kQB, B - qb0), W, m.stride);
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
  const int n0 = warp * 8;  // this warp's 8 rows of each tile
  for (int t0 = r0; t0 < r1; t0 += kTile) {
    __syncthreads();  // the previous tile's rows and scores are consumed
    const int nrows = min(kTile, r1 - t0);
    stage_rows(m.ct, corpus + (size_t)t0 * D, kTile, nrows, W, m.stride);
    for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
      m.tcodes[r] = (r < nrows) ? codes[t0 + r] : -2;
      m.tcodes[kTile + r] = (r < nrows) ? codes[(size_t)N + t0 + r] : -2;
    }
    __syncthreads();
    score_tile<T>(m, W, warp, lane);
    __syncwarp();

    // lane = query: mask the warp's 8 rows and merge them into the list
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = n0 + j;
      const int gid = t0 + r;
      const int tc = m.tcodes[r], dc = m.tcodes[kTile + r];
      const bool ok = live && r < nrows && gid < n_valid &&
                      (tq == -1 || tq == tc) && (dq == -1 || dq == dc);
      if (ok) insert(ls, li, m.sc[lane * (kTile + 1) + r], gid);
    }
  }

  merge_warp_lists(m, ls, li, warp, lane);
  if (warp == 0 && live) {
    const size_t o = ((size_t)qi * splits + split) * k;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k) { part_s[o + j] = ls[j]; part_i[o + j] = li[j]; }
    }
  }
}

template <typename T>
int launch(const void* q, const void* corpus, const void* codes, const void* qf, int B,
           int N, int D, int n_valid, int k, int rows_per_split, void* part_s,
           void* part_i, void* out_s, void* out_i, void* stream) {
  if (B < 1 || N < 1 || D < Elem<T>::kDimStep || D > kMaxD || D % Elem<T>::kDimStep != 0 ||
      k < 1 || k > kMaxK || rows_per_split < 1)
    return (int)cudaErrorInvalidValue;
  const int splits = (N + rows_per_split - 1) / rows_per_split;
  const int qblocks = (B + kQB - 1) / kQB;
  const size_t smem = smem_bytes(D / Elem<T>::kPerWord);
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  topk_partial_kernel<T><<<dim3(splits, qblocks), kWarps * 32, smem, s>>>(
      (const T*)q, (const T*)corpus, (const int32_t*)codes, (const int32_t*)qf, B, N, D,
      n_valid, k, rows_per_split, (float*)part_s, (int32_t*)part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<B, 32, 0, s>>>((const float*)part_s, (const int32_t*)part_i, splits * k,
                                k, nullptr, (float*)out_s, (int32_t*)out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t masked_topk_scratch_count(int B, int N, int rows_per_split, int k) {
  const int splits = (N + rows_per_split - 1) / rows_per_split;
  return (size_t)B * splits * k;
}

// Each returns a cudaError_t: 1 (cudaErrorInvalidValue) for shapes the
// kernel does not take (D a multiple of 16 for bf16, of 32 for int8, at
// most 1024), else the first launch error.  part_s / part_i hold
// masked_topk_scratch_count() elements each.
extern "C" int masked_topk(const void* q, const void* corpus, const void* codes,
                           const void* qf, int B, int N, int D, int n_valid, int k,
                           int rows_per_split, void* part_s, void* part_i,
                           void* out_s, void* out_i, void* stream) {
  return launch<__nv_bfloat16>(q, corpus, codes, qf, B, N, D, n_valid, k, rows_per_split,
                               part_s, part_i, out_s, out_i, stream);
}

extern "C" int masked_topk_s8(const void* q, const void* corpus, const void* codes,
                              const void* qf, int B, int N, int D, int n_valid, int k,
                              int rows_per_split, void* part_s, void* part_i,
                              void* out_s, void* out_i, void* stream) {
  return launch<int8_t>(q, corpus, codes, qf, B, N, D, n_valid, k, rows_per_split, part_s,
                        part_i, out_s, out_i, stream);
}
