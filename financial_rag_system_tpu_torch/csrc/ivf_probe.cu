// Masked cosine similarity and top-k over the probed tiles of the IVF
// tier's cluster-major packing.
//
// Replaces financial_rag_system_tpu/index/ivf.py:_ivf_kernel (the Pallas
// kernel behind ivf_probe_pallas) and computes what it computes: a probe
// list of tile ids (-1 = inactive) names the `tile`-row blocks of the
// packed corpus to visit; every row of a visited tile is scored against
// each of B queries (bf16 x bf16 summed in f32: ivf_probe; or int8 x int8
// summed in s32 and cast to f32, exact: ivf_probe_s8, the Pallas kernel's
// int8 branch, ivf.py:123-137) and masked out when it fails
// the query's [ticker, doc_type] code filter (-1 is the wildcard) or its
// packed gid is -1 (padding, or a slot masked by a re-upsert); the (B, K)
// best come out in descending score as original row ids (packed_gids).
// Equal scores go to the lower packed position: the Pallas kernel walks
// the ascending probe list and keeps the first position on a tie
// (ivf.py:152-168), so the id carried through both passes here is the
// packed position, and it becomes a row id only at the end of pass 2.
// Empty slots come out as score -inf and id -1, as ivf_probe_xla gives.
//
// Bound on the H100: the active tiles' gids (4 bytes a slot) and the rows
// and codes of their live slots (2D + 8 bytes each in bf16, D + 8 in
// int8), read once at 3.35 TB/s.  A batch of 32 diverse queries probing 16 of 512 clusters
// activates about 10,000 of 16,384 tiles; about half of their slots are
// padding (a cluster's block holds twice the average cluster), so about
// 0.5 GB is live, ~0.15 ms; its products (2 * 32 * D flops a row) take a
// fifth of that at the bf16 tensor-core peak.  It is memory bound.
// Design (topk_common.cuh has the shared pieces):
//  - Pass 1, grid (probe splits) x (query blocks of 32): block j takes
//    entries j, j + splits, ... of the probe list, so the -1 padding that
//    sorts to the end of the list spreads evenly over the blocks; it
//    skips an inactive entry without loading anything, streams an active
//    tile in 64-row pieces (reading a piece's gids first and skipping a
//    piece of padding only), scores them on the tensor cores (mma.sync),
//    masks and keeps a per-query best list in registers, then writes a
//    (B, splits, K) partial keyed by packed position.
//  - Pass 2, one warp per query: merges the splits' lists on (score desc,
//    position asc) and maps each winner's position to its row id.
// Tiles are read once per query block.  Loads are not overlapped with the
// scoring (no cp.async / TMA pipeline).

#include "topk_common.cuh"

using namespace topk;

namespace {

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ivf_partial_kernel(const T* __restrict__ q, const T* __restrict__ packed_emb,
                   const int32_t* __restrict__ packed_codes,
                   const int32_t* __restrict__ packed_gids,
                   const int32_t* __restrict__ tile_ids,
                   const int32_t* __restrict__ qf, int B, int D, int n_packed,
                   int tile, int n_probe, int k, float* __restrict__ part_s,
                   int32_t* __restrict__ part_i) {
  extern __shared__ __align__(16) uint32_t smem_u32[];
  const int W = D / Elem<T>::kPerWord;
  const Smem m = carve(smem_u32, W);

  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int qb0 = blockIdx.y * kQB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  stage_rows(m.qs, q + (size_t)qb0 * D, kQB, min(kQB, B - qb0), W, m.stride);
  const int qi = qb0 + lane;
  const bool live = qi < B;
  const int tq = live ? qf[qi * 2] : -3;
  const int dq = live ? qf[qi * 2 + 1] : -3;

  float ls[kMaxK];
  int li[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) { ls[j] = -INFINITY; li[j] = kNoId; }

  const int num_tiles = n_packed / tile;
  const int n0 = warp * 8;  // this warp's 8 rows of each piece
  for (int p = split; p < n_probe; p += splits) {
    const int t = tile_ids[p];  // the same for every thread of the block
    if (t < 0 || t >= num_tiles) continue;
    for (int sub = 0; sub < tile; sub += kTile) {
      const int base = t * tile + sub;
      // a barrier (the previous piece's rows and scores are consumed) that
      // also skips a piece of padding only, as the end of a cluster's
      // block is: its rows are never loaded
      const bool row_live = threadIdx.x < kTile && packed_gids[base + threadIdx.x] >= 0;
      if (!__syncthreads_or(row_live)) continue;
      stage_rows(m.ct, packed_emb + (size_t)base * D, kTile, kTile, W, m.stride);
      for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
        m.tcodes[r] = packed_codes[base + r];
        m.tcodes[kTile + r] = packed_codes[(size_t)n_packed + base + r];
        m.tcodes[2 * kTile + r] = packed_gids[base + r];
      }
      __syncthreads();
      score_tile<T>(m, W, warp, lane);
      __syncwarp();

      // lane = query: mask the warp's 8 rows and merge them into the list
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = n0 + j;
        const int tc = m.tcodes[r], dc = m.tcodes[kTile + r];
        const bool ok = live && m.tcodes[2 * kTile + r] >= 0 &&
                        (tq == -1 || tq == tc) && (dq == -1 || dq == dc);
        if (ok) insert(ls, li, m.sc[lane * (kTile + 1) + r], base + r);
      }
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
int launch(const void* q, const void* packed_emb, const void* packed_codes,
           const void* packed_gids, const void* tile_ids, const void* qf, int B, int D,
           int n_packed, int tile, int n_probe, int k, int splits, void* part_s,
           void* part_i, void* out_s, void* out_i, void* stream) {
  if (B < 1 || D < Elem<T>::kDimStep || D > kMaxD || D % Elem<T>::kDimStep != 0 || k < 1 ||
      k > kMaxK || tile < kTile || tile % kTile != 0 || n_packed < tile ||
      n_packed % tile != 0 || n_probe < 1 || splits < 1 || splits > n_probe)
    return (int)cudaErrorInvalidValue;
  const int qblocks = (B + kQB - 1) / kQB;
  const size_t smem = smem_bytes(D / Elem<T>::kPerWord);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  ivf_partial_kernel<T><<<dim3(splits, qblocks), kWarps * 32, smem, s>>>(
      (const T*)q, (const T*)packed_emb, (const int32_t*)packed_codes,
      (const int32_t*)packed_gids, (const int32_t*)tile_ids, (const int32_t*)qf, B, D,
      n_packed, tile, n_probe, k, (float*)part_s, (int32_t*)part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<B, 32, 0, s>>>((const float*)part_s, (const int32_t*)part_i, splits * k,
                                k, (const int32_t*)packed_gids, (float*)out_s,
                                (int32_t*)out_i);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns a cudaError_t: 1 (cudaErrorInvalidValue) for shapes the
// kernel does not take (D a multiple of 16 for bf16, of 32 for int8, at
// most 1024), else the first launch error.  part_s / part_i hold
// B * splits * k elements each; 1 <= splits <= n_probe.
extern "C" int ivf_probe(const void* q, const void* packed_emb, const void* packed_codes,
                         const void* packed_gids, const void* tile_ids, const void* qf,
                         int B, int D, int n_packed, int tile, int n_probe, int k,
                         int splits, void* part_s, void* part_i, void* out_s,
                         void* out_i, void* stream) {
  return launch<__nv_bfloat16>(q, packed_emb, packed_codes, packed_gids, tile_ids, qf, B, D,
                               n_packed, tile, n_probe, k, splits, part_s, part_i, out_s,
                               out_i, stream);
}

extern "C" int ivf_probe_s8(const void* q, const void* packed_emb, const void* packed_codes,
                            const void* packed_gids, const void* tile_ids, const void* qf,
                            int B, int D, int n_packed, int tile, int n_probe, int k,
                            int splits, void* part_s, void* part_i, void* out_s,
                            void* out_i, void* stream) {
  return launch<int8_t>(q, packed_emb, packed_codes, packed_gids, tile_ids, qf, B, D,
                        n_packed, tile, n_probe, k, splits, part_s, part_i, out_s, out_i,
                        stream);
}
