// Pieces shared by the two masked top-k kernels: masked_topk.cu (kernel 1,
// a contiguous corpus) and ivf_probe.cu (kernel 3, the probed tiles of the
// IVF packing).  Both run the same two passes:
//  - pass 1: a block stages 32 queries in shared memory, streams 64-row
//    tiles of corpus rows (16-byte coalesced loads), scores each tile on
//    the tensor cores (one 32-query x 8-row slice a warp), then each lane
//    takes one query, masks its warp's 8 rows and inserts them into a best
//    list kept in registers; the 8 warps' lists merge in shared memory
//    into a (B, splits, K) partial;
//  - pass 2, one warp per query: K rounds of a warp arg-max over the
//    splits*K candidates, each round taking the best candidate that ranks
//    after the last one taken.
// Candidates are ordered by (score desc, id asc); the id is the row for
// kernel 1 and the packed position for kernel 3, which maps it to a row
// id only at the end of pass 2.
// Both kernels take a bf16 or an int8 corpus (Elem<T> below): bf16 rows
// score with mma.sync m16n8k16 (bf16 in, f32 sums), int8 rows with
// mma.sync m16n8k32 (s8 in, s32 sums, then f32: exact, since every sum
// is an integer of at most 127^2 * 1024 < 2^24).  Shared memory holds a
// row as 32-bit words either way, and the two products read their A and
// B fragments from the same words (word t and t + 4 of each 8-word step:
// 16 bf16 values or 32 int8 values), so only the instruction and the
// accumulator type differ.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace topk {

constexpr int kQB = 32;      // queries per block: two m16 tiles, lane = query
constexpr int kWarps = 8;    // 256 threads, one n8 slice of the tile each
constexpr int kTile = 64;    // corpus rows per shared-memory tile
constexpr int kMaxK = 32;    // per-query list kept by pass 1 (>= k)
constexpr int kMaxD = 1024;
constexpr int kNoId = 0x7fffffff;

// (s1, i1) ranks before (s2, i2): higher score, then lower id
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

// d += a (16x32, row) * b (32x8, col), s8 in, s32 accumulate
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The element type of the queries and the corpus: how many fit a 32-bit
// word, the widest D, and the tensor-core product of one 8-word step.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  static constexpr int kDimStep = 16;  // one m16n8k16 step
  using Acc = float;
  __device__ static void mma(Acc (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    mma_bf16(d, a, b0, b1);
  }
};

template <>
struct Elem<int8_t> {
  static constexpr int kPerWord = 4;
  static constexpr int kDimStep = 32;  // one m16n8k32 step
  using Acc = int;
  __device__ static void mma(Acc (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    mma_s8(d, a, b0, b1);
  }
};

// Shared-memory layout of pass 1.  A row of W = D / kPerWord words is
// padded by 4 words: W is a multiple of 8, so (W + 4) is 4 mod 8 words,
// and the fragment loads of 8 rows x 4 words hit 32 distinct banks.
struct Smem {
  uint32_t* qs;     // [kQB][stride] the query block
  uint32_t* ct;     // [kTile][stride] the corpus tile
  float* sc;        // [kQB][kTile + 1] the tile's scores
  int32_t* tcodes;  // [3][kTile] ticker codes, doc-type codes, ids
  float* ms;        // [kQB][kMaxK] a warp's lists, for the block merge
  int32_t* mi;      // [kQB][kMaxK]
  int stride;
};

// W: the words of one query or corpus row
__host__ __device__ inline size_t smem_bytes(int W) {
  return sizeof(uint32_t) * (size_t)(kQB + kTile) * (W + 4) +
         sizeof(float) * kQB * (kTile + 1) + sizeof(int32_t) * 3 * kTile +
         (sizeof(float) + sizeof(int32_t)) * kQB * kMaxK;
}

__device__ __forceinline__ Smem carve(uint32_t* base, int W) {
  Smem m;
  m.stride = W + 4;
  m.qs = base;
  m.ct = m.qs + kQB * m.stride;
  m.sc = reinterpret_cast<float*>(m.ct + kTile * m.stride);
  m.tcodes = reinterpret_cast<int32_t*>(m.sc + kQB * (kTile + 1));
  m.ms = reinterpret_cast<float*>(m.tcodes + 3 * kTile);
  m.mi = reinterpret_cast<int32_t*>(m.ms + kQB * kMaxK);
  return m;
}

// Copy rows [0, nrows) of a row-major matrix of W-word rows into a
// padded shared tile of `rows` rows, zero-filling the rest.
__device__ __forceinline__ void stage_rows(uint32_t* dst, const void* src, int rows,
                                           int nrows, int W, int stride) {
  const int vecs = W / 4;  // 16-byte chunks a row
  const uint4* s16 = reinterpret_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < rows * vecs; i += blockDim.x) {
    const int r = i / vecs, c = i % vecs;
    *reinterpret_cast<uint4*>(dst + r * stride + c * 4) =
        (r < nrows) ? s16[(size_t)r * vecs + c] : make_uint4(0, 0, 0, 0);
  }
}

// (32 queries) x (this warp's 8 rows) scores on the tensor cores, into
// m.sc as f32.  W: words a row.  The caller synchronises the block before
// (tile staged) and the warp after (scores written).
template <typename T>
__device__ __forceinline__ void score_tile(const Smem& m, int W, int warp, int lane) {
  using Acc = typename Elem<T>::Acc;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = warp * 8;
  Acc acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  const uint32_t* crow = m.ct + (n0 + g) * m.stride + t;
  const uint32_t* qa = m.qs + g * m.stride + t;
  for (int w = 0; w < W; w += 8) {
    const uint32_t b0 = crow[w], b1 = crow[w + 4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint32_t* qm = qa + mt * 16 * m.stride + w;
      const uint32_t a[4] = {qm[0], qm[8 * m.stride], qm[4], qm[8 * m.stride + 4]};
      Elem<T>::mma(acc[mt], a, b0, b1);
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float* s0 = m.sc + (mt * 16 + g) * (kTile + 1) + n0 + t * 2;
    float* s8 = s0 + 8 * (kTile + 1);
    s0[0] = (float)acc[mt][0];
    s0[1] = (float)acc[mt][1];
    s8[0] = (float)acc[mt][2];
    s8[1] = (float)acc[mt][3];
  }
}

// Merge the warps' lists into warp 0's, one warp at a time.
__device__ __forceinline__ void merge_warp_lists(const Smem& m, float (&ls)[kMaxK],
                                                 int (&li)[kMaxK], int warp, int lane) {
  for (int w = 1; w < kWarps; ++w) {
    __syncthreads();
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) { m.ms[lane * kMaxK + j] = ls[j]; m.mi[lane * kMaxK + j] = li[j]; }
    }
    __syncthreads();
    if (warp == 0) {
      for (int j = 0; j < kMaxK; ++j) {
        // entries arrive sorted: once one fails to enter, the rest do too
        if (!insert(ls, li, m.ms[lane * kMaxK + j], m.mi[lane * kMaxK + j])) break;
      }
    }
  }
}

// Pass 2.  id_map, when not null, maps each winning id to the id written
// out (kernel 3: packed position -> row id); empty slots are -inf / -1.
__global__ void merge_kernel(const float* __restrict__ part_s,
                             const int32_t* __restrict__ part_i, int n_cand, int k,
                             const int32_t* __restrict__ id_map,
                             float* __restrict__ out_s, int32_t* __restrict__ out_i) {
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
      out_i[(size_t)qi * k + j] =
          bs > -INFINITY ? (id_map != nullptr ? id_map[bi] : bi) : -1;
    }
    last_s = bs;
    last_i = bi;
  }
}

}  // namespace topk
