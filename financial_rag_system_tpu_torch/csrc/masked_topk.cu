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
// the blocks' lists.  The corpus is read exactly once.  Rows of more than
// 1,024 values (a 1536-wide embedding's, say) take the wide kernel
// (topk_common.cuh): one block an SM whose scoring warpgroup computes each
// tile's scores on wgmma straight from the ring while sixteen selecting
// warps select from the tile before; at B 32, N 131,072, D 1536 the rows
// (403 MB in bf16) bound it at 0.12 ms.  A k above 32 takes
// the same walk with the select path's consumers (topk_select.cuh): the
// scores go to a table in device memory, and an exact threshold selection
// over the table finds the top k.

#include "topk_select.cuh"

using namespace topk;

namespace {

// pass 1 (kSelect false: best lists into part_s / part_i) or the select
// path's walk (kSelect: scores into sel's table, column = row); kWide: the
// wide kernel (rows of more than kWideAboveD values), whose scoring
// warpgroup scores every tile for its selecting warps
template <typename T, bool kSelect, bool kWide>
__global__ void __launch_bounds__(kWide ? kWideThreads : kThreads, kWide ? 1 : 2)
masked_topk_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap rmap,
                   const __grid_constant__ CUtensorMap cmap, const int32_t* __restrict__ qf,
                   int B, int N, int row_bytes, int n_valid, int k, int stages,
                   float* __restrict__ part_s, int32_t* __restrict__ part_i, const Select sel) {
  extern __shared__ unsigned char smem_raw[];
  const int nbox = boxes_for(row_bytes);
  const Smem m = kWide ? carve_wide(smem_raw, nbox, stages) : carve(smem_raw, nbox, stages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qb0 = blockIdx.y * kQB;
  if (threadIdx.x == 0) {
    if constexpr (kWide) init_wide_barriers(m, stages);
    else init_barriers(m, stages);
  }
  if (kSelect) clear_select(sel, B);
  __syncthreads();

  if (warp == (kWide ? kWideProducer : kConsumers)) {  // the producer: tiles [t0, t1) of the corpus
    if (lane == 0) {
      const long long tiles = (N + kRows - 1) / kRows;
      const int t0 = (int)(tiles * blockIdx.x / gridDim.x);
      const int t1 = (int)(tiles * (blockIdx.x + 1) / gridDim.x);
      if (kSelect && blockIdx.x == 0 && blockIdx.y == 0) *sel.n_cols = (int)(tiles * kRows);
      Producer pr(m, stages, nbox);
      pr.queries(&qmap, qb0);
      for (int t = t0; t < t1; ++t) pr.tile(&rmap, &cmap, nullptr, t * kRows, N, t * kRows);
      pr.end();
    }
    return;
  }
  if constexpr (kWide) {
    if (warp >= kSelectors) {  // the scoring warpgroup
      score_walk<T>(m, nbox, stages, warp - kSelectors, lane);
      return;
    }
  }
  if (kSelect) {
    store_walk<T, false, kWide>(m, nbox, row_bytes, stages, B, qb0, N, n_valid, qf, sel, warp,
                                lane);
    return;
  }
  float ls[kQueries<kWide>];
  int li[kQueries<kWide>];
  consume<T, false, kWide>(m, nbox, row_bytes, stages, B, qb0, N, n_valid, k, qf, warp, lane, ls,
                           li);
  write_lists(ls, li, B, qb0, k, part_s, part_i, warp, lane);
}

// one pass-1 launch (the lists' or the select path's walk), its
// shared-memory limit raised first
template <typename T, bool kSelect, bool kWide>
cudaError_t walk(dim3 grid, size_t smem, cudaStream_t st, const CUtensorMap& qmap,
                 const CUtensorMap& rmap, const CUtensorMap& cmap, const int32_t* qf, int B, int N,
                 int row_bytes, int n_valid, int k, int stages, float* part_s, int32_t* part_i,
                 const Select& sel) {
  cudaError_t err = allow_smem<&masked_topk_kernel<T, kSelect, kWide>>();
  if (err != cudaSuccess) return err;
  masked_topk_kernel<T, kSelect, kWide><<<grid, kWide ? kWideThreads : kThreads, smem, st>>>(
      qmap, rmap, cmap, qf, B, N, row_bytes, n_valid, k, stages, part_s, part_i, sel);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* corpus, const void* codes, const void* qf, int B, int N,
           int D, int n_valid, int k, int blocks, int stages, void* scratch, void* out,
           void* stream) {
  const int row_bytes = D * (int)sizeof(T);
  const bool wide = D > kWideAboveD;
  const size_t smem = wide ? wide_smem_bytes(boxes_for(row_bytes), stages)
                           : smem_bytes(boxes_for(row_bytes), stages);
  if (B < 1 || N < 1 || D < Elem<T>::kDimStep || row_bytes > kMaxRowBytes ||
      D % Elem<T>::kDimStep != 0 || k < 1 || blocks < 1 || blocks > kMaxBlocks || stages < 1 ||
      stages > kMaxStages || smem > (size_t)kSmemLimit || !aligned16(q) || !aligned16(corpus) ||
      !aligned16(codes) || !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, rmap, cmap;
  if (!rows_map(&qmap, q, B, row_bytes, kQB) || !rows_map(&rmap, corpus, N, row_bytes, kRows) ||
      !ints_map(&cmap, codes, 2LL * N, kCodeBox))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, (B + kQB - 1) / kQB);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nv = max(0, min(n_valid, N));
  float* out_s = static_cast<float*>(out);
  int32_t* out_i = reinterpret_cast<int32_t*>(out_s + (size_t)B * k);
  if (k > kListK) {  // the select path: the walk, then passes 2-4 over its table
    const long long cols = (N + kRows - 1LL) / kRows * kRows;
    const Select sel = carve_select(scratch, B, cols, k,
                                    select_sweeps(B, cols, blocks * (int)grid.y), false);
    const cudaError_t err =
        (wide ? walk<T, true, true> : walk<T, true, false>)(
            grid, smem, st, qmap, rmap, cmap, (const int32_t*)qf, B, N, row_bytes, nv, k, stages,
            nullptr, nullptr, sel);
    if (err != cudaSuccess) return (int)err;
    return select_rest(sel, B, k, nullptr, out_s, out_i, st);
  }
  float* part_s = static_cast<float*>(scratch);
  int32_t* part_i = reinterpret_cast<int32_t*>(part_s + (size_t)B * k * blocks);
  cudaError_t err = (wide ? walk<T, false, true> : walk<T, false, false>)(
      grid, smem, st, qmap, rmap, cmap, (const int32_t*)qf, B, N, row_bytes, nv, k, stages,
      part_s, part_i, Select{});
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<B, kMergeWarps * 32, 0, st>>>(part_s, part_i, blocks, k, nullptr, out_s, out_i,
                                               k);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns a cudaError_t: 1 (cudaErrorInvalidValue) for shapes or a
// plan the kernel does not take (D a multiple of 16 for bf16, of 32 for
// int8, rows of at most 6272 bytes; any k >= 1; 1-384 blocks; 1-16
// stages within the shared-memory limit; q, corpus, codes and scratch 16-byte aligned),
// else the first failing launch's status.  `blocks` and `stages` come from
// ops/topk.py topk_plan; scratch holds the lists, 2 * B * k * blocks int32
// words, at k <= 32, and select_words(B, 64 * ceil(N / 64), k, sweeps, false)
// words above (topk_select.cuh, sweeps = select_sweeps(B, cols, blocks *
// ceil(B / 32))); out receives the (B, k) f32 scores, then the
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
