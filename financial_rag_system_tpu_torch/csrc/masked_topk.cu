// Masked cosine similarity and top-k over a device-resident corpus.
//
// Replaces financial_rag_system_tpu/ops/topk.py:_topk_kernel (the Pallas
// kernel behind masked_topk_pallas) and computes what it computes: the
// score of each of B queries against every corpus row, bf16 x bf16 summed
// in f32 (masked_topk), or int8 x int8 summed in s32 and cast to f32,
// which is exact (masked_topk_s8: the Pallas kernel's int8 branch,
// topk.py:129-140, whose two variants give the same scores); a row is
// masked out when it fails the query's [ticker, doc_type] code filter (-1
// is the wildcard) or sits at or beyond n_valid; the (B, K) best come out
// in descending score, and equal scores go to the lower global row id
// (the Pallas merge's lowest-position rule, topk.py:186-196).  Empty slots
// come out as score -inf and id -1, which differs from the Pallas kernel's
// id 0: callers treat -inf as empty and clamp ids before the token-store
// gather (ops/fused_query.py).
//
// Bound on the H100 at the serving shape (B = 32, N = 131,072, D = 384,
// K = 15): the corpus and its codes, about 101.7 MB in bf16 (51.4 MB in
// int8), read once at 3.35 TB/s is about 30 us (15 us); the 3.2 G
// operations of products take 3 us at the bf16 tensor-core peak (1.6 us
// at the int8 peak).  It is memory bound.
// Design (topk_common.cuh has the walk, the selection and the merge): the
// Pallas grid walks the corpus in order and carries the best list from
// tile to tile; here a persistent grid of ops/topk.py topk_plan's blocks
// (two an SM at B = 32) splits the 64-row tiles into contiguous shares,
// each block streams its share through a TMA ring while its consumer
// warps score and select, and a second launch of one block a query merges
// the blocks' lists.  The corpus is read exactly once.

#include <atomic>

#include "topk_common.cuh"

using namespace topk;

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
masked_topk_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap rmap,
                   const __grid_constant__ CUtensorMap cmap, const int32_t* __restrict__ qf,
                   int B, int N, int row_bytes, int n_valid, int k, int stages,
                   const float* __restrict__ floor_s, const int32_t* __restrict__ floor_i,
                   int floor_ld, float* __restrict__ part_s, int32_t* __restrict__ part_i) {
  extern __shared__ unsigned char smem_raw[];
  const int nbox = boxes_for(row_bytes);
  const Smem m = carve(smem_raw, nbox, stages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qb0 = blockIdx.y * kQB;
  if (threadIdx.x == 0) init_barriers(m, stages);
  __syncthreads();

  if (warp == kConsumers) {  // the producer: tiles [t0, t1) of the corpus
    if (lane == 0) {
      const long long tiles = (N + kRows - 1) / kRows;
      const int t0 = (int)(tiles * blockIdx.x / gridDim.x);
      const int t1 = (int)(tiles * (blockIdx.x + 1) / gridDim.x);
      Producer pr(m, stages, nbox);
      pr.queries(&qmap, qb0);
      for (int t = t0; t < t1; ++t) pr.tile(&rmap, &cmap, nullptr, t * kRows, N);
      pr.end();
    }
    return;
  }
  float ls[kQPW];
  int li[kQPW];
  consume<T, false>(m, nbox, row_bytes, stages, B, qb0, N, n_valid, k, qf, floor_s, floor_i,
                    floor_ld, warp, lane, ls, li);
  write_lists(ls, li, B, qb0, k, part_s, part_i, warp, lane);
}

template <typename T>
int launch(const void* q, const void* corpus, const void* codes, const void* qf, int B, int N,
           int D, int n_valid, int k, int blocks, int stages, void* scratch, void* out,
           void* stream) {
  const int row_bytes = D * (int)sizeof(T);
  const size_t smem = smem_bytes(boxes_for(row_bytes), stages);
  if (B < 1 || N < 1 || D < Elem<T>::kDimStep || row_bytes > kMaxRowBytes ||
      D % Elem<T>::kDimStep != 0 || k < 1 || blocks < 1 || blocks > kMaxBlocks || stages < 1 ||
      stages > kMaxStages || smem > (size_t)kSmemLimit || !aligned16(q) || !aligned16(corpus) ||
      !aligned16(codes) || !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, rmap, cmap;
  if (!rows_map(&qmap, q, B, row_bytes, kQB) || !rows_map(&rmap, corpus, N, row_bytes, kRows) ||
      !ints_map(&cmap, codes, 2LL * N, kCodeBox))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // raise the kernel's shared-memory limit once a device; host threads
  // may launch at once, and each may do that first
  static std::atomic<bool> ready[64];
  if (!ready[dev & 63].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(masked_topk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    ready[dev & 63].store(true, std::memory_order_release);
  }
  const int qblocks = (B + kQB - 1) / kQB;
  float* part_s = static_cast<float*>(scratch);
  int32_t* part_i = reinterpret_cast<int32_t*>(part_s + (size_t)B * min(k, kRoundK) * blocks);
  float* out_s = static_cast<float*>(out);
  int32_t* out_i = reinterpret_cast<int32_t*>(out_s + (size_t)B * k);
  // rounds of kRoundK; round r's floor is entry 32 r - 1 of the result
  for (int r0 = 0; r0 < k; r0 += kRoundK) {
    const int kr = min(kRoundK, k - r0);
    masked_topk_kernel<T><<<dim3(blocks, qblocks), kThreads, smem, (cudaStream_t)stream>>>(
        qmap, rmap, cmap, (const int32_t*)qf, B, N, row_bytes, max(0, min(n_valid, N)), kr,
        stages, r0 > 0 ? out_s + r0 - 1 : nullptr, r0 > 0 ? out_i + r0 - 1 : nullptr, k, part_s,
        part_i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    merge_kernel<<<B, kMergeWarps * 32, 0, (cudaStream_t)stream>>>(
        part_s, part_i, blocks, kr, nullptr, out_s + r0, out_i + r0, k, nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// Each returns a cudaError_t: 1 (cudaErrorInvalidValue) for shapes or a
// plan the kernel does not take (D a multiple of 16 for bf16, of 32 for
// int8, rows of at most 6272 bytes; any k >= 1; 1-384 blocks; 1-16
// stages within the shared-memory limit; q, corpus, codes and scratch 16-byte aligned),
// else the first failing launch's status.  `blocks` and `stages` come from
// ops/topk.py topk_plan; scratch holds a round's lists, 2 * B * min(k, 32)
// * blocks int32 words; out receives the (B, k) f32 scores, then the
// (B, k) int32 row ids.
extern "C" int masked_topk(const void* q, const void* corpus, const void* codes, const void* qf,
                           int B, int N, int D, int n_valid, int k, int blocks, int stages,
                           void* scratch, void* out, void* stream) {
  return launch<__nv_bfloat16>(q, corpus, codes, qf, B, N, D, n_valid, k, blocks, stages, scratch,
                               out, stream);
}

extern "C" int masked_topk_s8(const void* q, const void* corpus, const void* codes,
                              const void* qf, int B, int N, int D, int n_valid, int k, int blocks,
                              int stages, void* scratch, void* out, void* stream) {
  return launch<int8_t>(q, corpus, codes, qf, B, N, D, n_valid, k, blocks, stages, scratch, out,
                        stream);
}
