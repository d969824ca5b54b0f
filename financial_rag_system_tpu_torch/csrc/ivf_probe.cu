// Masked cosine similarity and top-k over the probed tiles of the IVF
// tier's cluster-major packing.
//
// Replaces financial_rag_system_tpu/index/ivf.py:_ivf_kernel (the Pallas
// kernel behind ivf_probe_pallas) and computes what it computes: a probe
// list of tile ids (the ascending active ids, then -1 for inactive
// entries, as index/ivf.py probe_tile_list makes it) names the `tile`-row
// blocks of the packed corpus to visit; every row of a visited tile is
// scored against each of B queries (bf16 x bf16 summed in f32: ivf_probe;
// or int8 x int8 summed in s32 and cast to f32, exact: ivf_probe_s8, the
// Pallas kernel's int8 branch, ivf.py:123-137) and masked out when it
// fails the query's [ticker, doc_type] code filter (-1 is the wildcard) or
// its packed gid is -1 (padding, or a slot masked by a re-upsert); the
// (B, K) best come out in descending score as original row ids
// (packed_gids).  Equal scores go to the lower packed position: the
// Pallas kernel walks the ascending probe list and keeps the first
// position on a tie (ivf.py:152-168), so the id carried through the walk
// and the merge here is the packed position, and it becomes a row id only
// when the result is written.  Empty slots come out as score -inf and id
// -1, as ivf_probe_xla gives.
//
// Bound on the H100: the active tiles' gids (4 bytes a slot) and the rows
// and codes of their live slots (2D + 8 bytes each in bf16, D + 8 in
// int8), read once at 3.35 TB/s.  A batch of 32 diverse queries probing 16
// of 512 clusters activates about 10,000 of 16,384 tiles; about half of
// their slots are padding (a cluster's block holds twice the average
// cluster), so about 0.5 GB is live, ~0.15 ms; its products (2 * 32 * D
// flops a row) take a fifth of that at the bf16 tensor-core peak.  It is
// memory bound.
// Design (topk_common.cuh has the walk, the selection and the merge): the
// producer warp of each persistent block finds the number of active
// entries itself (a 32-way search of the list, no host sync), takes an
// even contiguous share of the active tiles' 64-row pieces, reads each
// piece's gids and loads nothing of a piece that is padding only (the end
// of a cluster's block); the live pieces go through the TMA ring to the
// consumer warps, and a second launch of one block a query merges the
// blocks' lists and maps the winners to row ids.  Each live piece is read
// once per query block.  Rows of more than 1,024 values take the wide
// kernel (topk_common.cuh), as kernel 1's do.  A k above 32 takes the same walk with the select
// path's consumers (topk_select.cuh): the live pieces' scores go to a
// table in device memory, 64 columns a piece in the list's order, and an
// exact threshold selection over the table finds the top k.

#include "topk_select.cuh"

using namespace topk;

namespace {

// The number of active (>= 0) entries at the head of the probe list, by
// the producer warp: each round probes 32 evenly spaced entries of the
// range the count lies in and keeps the gap after the last active probe,
// so a list of 16,384 takes three rounds of one load each.
__device__ __forceinline__ int active_count(const int32_t* __restrict__ ids, int n, int lane) {
  int lo = 0, hi = n;  // the count lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int idx = lo + lane * step;
    const unsigned act = __ballot_sync(~0u, idx < hi && ids[idx] >= 0);
    const int c = act == ~0u ? 32 : __ffs(~act) - 1;  // leading active probes
    if (c == 0) {
      hi = lo;
    } else {
      const int last = lo + (c - 1) * step;
      lo = last + 1;
      hi = min(hi, last + step);
    }
  }
  return lo;
}

// pass 1 (kSelect false: best lists into part_s / part_i) or the select
// path's walk (kSelect: scores into sel's table, piece p at column 64 p);
// kWide: the wide kernel (masked_topk.cu's), whose scoring warpgroup
// scores every live piece for its selecting warps
template <typename T, bool kSelect, bool kWide>
__global__ void __launch_bounds__(kWide ? kWideThreads : kThreads, kWide ? 1 : 2)
ivf_probe_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap rmap,
                 const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap gmap,
                 const int32_t* __restrict__ gids, const int32_t* __restrict__ tile_ids,
                 const int32_t* __restrict__ qf, int B, int row_bytes, int n_packed, int tile,
                 int n_probe, int k, int stages, float* __restrict__ part_s,
                 int32_t* __restrict__ part_i, const Select sel) {
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

  if (warp == (kWide ? kWideProducer : kConsumers)) {  // the producer
    Producer pr(m, stages, nbox);
    if (lane == 0) pr.queries(&qmap, qb0);
    const int per_tile = tile / kRows, num_tiles = n_packed / tile;
    const long long pieces = (long long)active_count(tile_ids, n_probe, lane) * per_tile;
    const long long p0 = pieces * blockIdx.x / gridDim.x;
    const long long p1 = pieces * (blockIdx.x + 1) / gridDim.x;
    if (kSelect && blockIdx.x == 0 && blockIdx.y == 0 && lane == 0)
      *sel.n_cols = (int)(pieces * kRows);
    // 32 pieces at a time: lane j reads piece j's gids, and the live ones
    // (a gid >= 0) are sent in order
    for (long long pb = p0; pb < p1; pb += 32) {
      const long long p = pb + lane;
      int base = 0;
      bool live = false;
      if (p < p1) {
        const int a = (int)(p / per_tile);
        const int t = tile_ids[a];
        if (t >= 0 && t < num_tiles) {
          base = t * tile + (int)(p - (long long)a * per_tile) * kRows;
          const int4* g4 = reinterpret_cast<const int4*>(gids + base);
          int top = -1;
#pragma unroll
          for (int c = 0; c < kRows / 4; ++c) {
            const int4 v = g4[c];
            top = max(top, max(max(v.x, v.y), max(v.z, v.w)));
          }
          live = top >= 0;
        }
        // the select path's piece table: piece p's first packed position,
        // or -1 where the table holds nothing of it
        if (kSelect && blockIdx.y == 0) sel.pieces[p] = live ? base : -1;
      }
      for (unsigned send = __ballot_sync(~0u, live); send != 0; send &= send - 1) {
        const int src = __ffs(send) - 1;
        const int at = __shfl_sync(~0u, base, src);
        const int col = __shfl_sync(~0u, (int)(p * kRows), src);
        if (lane == 0) pr.tile(&rmap, &cmap, &gmap, at, n_packed, col);
      }
    }
    if (lane == 0) pr.end();
    return;
  }
  if constexpr (kWide) {
    if (warp >= kSelectors) {  // the scoring warpgroup
      score_walk<T>(m, nbox, stages, warp - kSelectors, lane);
      return;
    }
  }
  if (kSelect) {
    store_walk<T, true, kWide>(m, nbox, row_bytes, stages, B, qb0, n_packed, 0, qf, sel, warp,
                               lane);
    return;
  }
  float ls[kQueries<kWide>];
  int li[kQueries<kWide>];
  consume<T, true, kWide>(m, nbox, row_bytes, stages, B, qb0, n_packed, 0, k, qf, warp, lane, ls,
                          li);
  write_lists(ls, li, B, qb0, k, part_s, part_i, warp, lane);
}

// one pass-1 launch (the lists' or the select path's walk), its
// shared-memory limit raised first
template <typename T, bool kSelect, bool kWide>
cudaError_t walk(dim3 grid, size_t smem, cudaStream_t st, const CUtensorMap& qmap,
                 const CUtensorMap& rmap, const CUtensorMap& cmap, const CUtensorMap& gmap,
                 const int32_t* gids, const int32_t* tile_ids, const int32_t* qf, int B,
                 int row_bytes, int n_packed, int tile, int n_probe, int k, int stages,
                 float* part_s, int32_t* part_i, const Select& sel) {
  cudaError_t err = allow_smem<&ivf_probe_kernel<T, kSelect, kWide>>();
  if (err != cudaSuccess) return err;
  ivf_probe_kernel<T, kSelect, kWide><<<grid, kWide ? kWideThreads : kThreads, smem, st>>>(
      qmap, rmap, cmap, gmap, gids, tile_ids, qf, B, row_bytes, n_packed, tile, n_probe, k,
      stages, part_s, part_i, sel);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* packed_emb, const void* packed_codes,
           const void* packed_gids, const void* tile_ids, const void* qf, int B, int D,
           int n_packed, int tile, int n_probe, int k, int blocks, int stages, void* scratch,
           void* out, void* stream) {
  const int row_bytes = D * (int)sizeof(T);
  const bool wide = D > kWideAboveD;
  const size_t smem = wide ? wide_smem_bytes(boxes_for(row_bytes), stages)
                           : smem_bytes(boxes_for(row_bytes), stages);
  if (B < 1 || D < Elem<T>::kDimStep || row_bytes > kMaxRowBytes ||
      D % Elem<T>::kDimStep != 0 || k < 1 || tile < kRows || tile % kRows != 0 ||
      n_packed < tile || n_packed % tile != 0 || n_probe < 1 || blocks < 1 ||
      blocks > kMaxBlocks || stages < 1 || stages > kMaxStages || smem > (size_t)kSmemLimit ||
      !aligned16(q) || !aligned16(packed_emb) || !aligned16(packed_codes) ||
      !aligned16(packed_gids) || !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, rmap, cmap, gmap;
  if (!rows_map(&qmap, q, B, row_bytes, kQB) ||
      !rows_map(&rmap, packed_emb, n_packed, row_bytes, kRows) ||
      !ints_map(&cmap, packed_codes, 2LL * n_packed, kCodeBox) ||
      !ints_map(&gmap, packed_gids, n_packed, kRows))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, (B + kQB - 1) / kQB);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* g = static_cast<const int32_t*>(packed_gids);
  float* out_s = static_cast<float*>(out);
  int32_t* out_i = reinterpret_cast<int32_t*>(out_s + (size_t)B * k);
  if (k > kListK) {  // the select path: the walk, then passes 2-4 over its table
    const long long cols = (long long)n_probe * tile;
    const Select sel = carve_select(scratch, B, cols, k,
                                    select_sweeps(B, cols, blocks * (int)grid.y), true);
    const cudaError_t err = (wide ? walk<T, true, true> : walk<T, true, false>)(
        grid, smem, st, qmap, rmap, cmap, gmap, g, (const int32_t*)tile_ids, (const int32_t*)qf,
        B, row_bytes, n_packed, tile, n_probe, k, stages, nullptr, nullptr, sel);
    if (err != cudaSuccess) return (int)err;
    return select_rest(sel, B, k, g, out_s, out_i, st);
  }
  float* part_s = static_cast<float*>(scratch);
  int32_t* part_i = reinterpret_cast<int32_t*>(part_s + (size_t)B * k * blocks);
  const cudaError_t err = (wide ? walk<T, false, true> : walk<T, false, false>)(
      grid, smem, st, qmap, rmap, cmap, gmap, g, (const int32_t*)tile_ids, (const int32_t*)qf, B,
      row_bytes, n_packed, tile, n_probe, k, stages, part_s, part_i, Select{});
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<B, kMergeWarps * 32, 0, st>>>(part_s, part_i, blocks, k, g, out_s, out_i, k);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns a cudaError_t: 1 (cudaErrorInvalidValue) for shapes or a
// plan the kernel does not take (D a multiple of 16 for bf16, of 32 for
// int8, rows of at most 6272 bytes; a tile a multiple of 64 dividing
// n_packed; 1-384 blocks; 1-16 stages within the shared-memory limit; q,
// the packing's three arrays and scratch 16-byte aligned; any k >= 1), else the first
// failing launch's status.  `blocks` and `stages` come from index/ivf.py
// probe_plan; out as masked_topk.cu's entries take it, and scratch too:
// the lists at k <= 32, select_words(B, n_probe * tile, k, sweeps, true)
// words above (topk_select.cuh).
extern "C" int ivf_probe(const void* q, const void* packed_emb, const void* packed_codes,
                         const void* packed_gids, const void* tile_ids, const void* qf, int B,
                         int D, int n_packed, int tile, int n_probe, int k, int blocks,
                         int stages, void* scratch, void* out, void* stream) {
  return launch<__nv_bfloat16>(q, packed_emb, packed_codes, packed_gids, tile_ids, qf, B, D,
                               n_packed, tile, n_probe, k, blocks, stages, scratch,
                               out, stream);
}

extern "C" int ivf_probe_s8(const void* q, const void* packed_emb, const void* packed_codes,
                            const void* packed_gids, const void* tile_ids, const void* qf, int B,
                            int D, int n_packed, int tile, int n_probe, int k, int blocks,
                            int stages, void* scratch, void* out, void* stream) {
  return launch<int8_t>(q, packed_emb, packed_codes, packed_gids, tile_ids, qf, B, D, n_packed,
                        tile, n_probe, k, blocks, stages, scratch, out, stream);
}
