// Segment-masked flash attention for BERT encoders, built for Hopper
// (sm_90a): the forward of the encoder's RAG_TPU_FLASH path.
//
// Replaces financial_rag_system_tpu/models/bert.py:160 _flash_attention,
// which calls jax's bundled TPU flash kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py: the pallas_call in
// _flash_attention_impl, the bodies _flash_attention_kernel_single_batch
// and _flash_attention_kernel_single_batch_single_step), and computes what
// it computes as bert.py configures it (128-key blocks, no bias, not
// causal, the key-padding mask as the segment ids of both q and kv):
//  - s = (q . k^T) of bf16 values summed in f32, times sm_scale (after the
//    product), plus kMaskValue = -0.7 * FLT_MAX wherever the query's
//    segment id differs from the key's (a finite value: a row whose first
//    key block is wholly masked starts with a finite running max, and that
//    block's weight is scaled by exp(kMaskValue - m) = 0 once a key of its
//    segment appears; -inf would give exp(-inf + inf) = NaN);
//  - S 128, jax's single-step kernel: p = exp(s - max), p / sum(p) rounded
//    to bf16, P.V summed in f32;
//  - S above 128: an online softmax over 128-key blocks, in jax's order:
//    m_next = max(m, rowmax(s)), p = exp(s - m_next), l_corr = exp(m -
//    m_next) * l, l_next = sum(p) + l_corr, inv = 1 / l_next (1 where
//    l_next is 0), acc = acc * (l_corr * inv), then acc += (bf16(p) . V) *
//    inv, each product and sum rounded on its own (no fused multiply-add),
//    as the f32 ops of the Pallas kernel are;
//  - the context rounded to bf16.
// Two liberties, inside the kernel-vs-plain tolerance: the f32 sums of the
// products and of a row's probabilities are taken in another order.
//
// Layout: q, k, v and the output are (B, S, H, D) bf16 as the encoder's
// projections give them (no transpose), D a multiple of 16 up to 128 (the
// wrapper zero-pads narrower heads) or 256; the segment ids (B, S) int32;
// S a multiple of 128 up to 512.
//
// Design: one block of four warps takes one 64-row tile of one (pair,
// head); the grid is every (pair, head, row tile).  The block stages its
// q tile once, then for each 128-key block the keys' K and V rows and
// segment ids, in shared memory with 16-byte loads (rows padded by 16
// bytes, so ldmatrix reads them without bank conflicts).  Each warp owns
// 16 query rows: QK^T on mma.sync m16n8k16 (q's A fragments and K's B
// fragments by ldmatrix), the softmax on the f32 accumulator in
// registers, and P.V on mma.sync with P straight from that accumulator
// (its 16-key steps are the A fragments) and V's B fragments by
// ldmatrix.trans.  P.V runs one 16-column slice of the context at a time
// over all 128 keys into a fresh accumulator, so the block's product is
// whole in f32 before it is scaled and added, as jax adds it.
//
// This kernel is simple, not fast: each row tile reads its pair's K and V
// again (from L2), each block's loads are waited for before its products,
// no load overlaps a product, every key of every block is computed (the
// segment test, not a skip, masks them), and exp is the accurate expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 4;               // warps a block, 16 query rows each
constexpr int kRows = 16 * kWarps;      // query rows a block
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 128;              // jax's block_k (= block_k_major)
constexpr int kMaxS = 512;
constexpr float kMaskValue = (float)(-0.7 * (double)FLT_MAX);  // jax's DEFAULT_MASK_VALUE

static_assert(kThreads == kKeys, "one thread stages each key's segment id");

template <int D>
struct Flash {
  static constexpr int kStride = D * 2 + 16;  // bytes of a staged row
  static constexpr int kNt = D / 8;           // 8-wide column tiles of the context
  static constexpr int kGran = D / 8;         // 16-byte granules of a row
  static constexpr size_t kSmem = (size_t)(kRows + 2 * kKeys) * kStride + kKeys * sizeof(int);
};

// rows [row0, row0 + n) of one (pair, head) of x into shared memory
template <int D>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const __nv_bfloat16* __restrict__ x,
                                           size_t base, size_t tok, int row0, int n) {
  for (int i = threadIdx.x; i < n * Flash<D>::kGran; i += kThreads) {
    const int r = i / Flash<D>::kGran, gi = i - r * Flash<D>::kGran;
    *reinterpret_cast<uint4*>(dst + r * Flash<D>::kStride + gi * 16) =
        *reinterpret_cast<const uint4*>(x + base + (size_t)(row0 + r) * tok + gi * 8);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ seg,
                       __nv_bfloat16* __restrict__ out, int S, int H, float scale) {
  using F = Flash<D>;
  extern __shared__ __align__(16) unsigned char flash_smem[];
  unsigned char* qs = flash_smem;
  unsigned char* ks = qs + kRows * F::kStride;
  unsigned char* vs = ks + kKeys * F::kStride;
  int* segk = reinterpret_cast<int*>(vs + kKeys * F::kStride);

  const int T = S / kRows;
  const int tile = blockIdx.x % T, item = blockIdx.x / T;
  const int pair = item / H, hd = item - pair * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t tok = (size_t)H * D;
  const size_t base = (size_t)pair * S * tok + (size_t)hd * D;
  const int32_t* srow = seg + (size_t)pair * S;

  stage_rows<D>(qs, q, base, tok, tile * kRows, kRows);
  const int ra = tile * kRows + 16 * warp + g, rb = ra + 8;  // this thread's two rows
  const int seg_a = srow[ra], seg_b = srow[rb];
  // ldmatrix row addresses: q's A fragments (matrix i = lane / 8: rows 8 (i
  // & 1) .., columns 8 (i >> 1) ..); K's B fragments (lanes 0-7 a key's
  // first 8 values of a 16-value step, lanes 8-15 its second 8); V's
  // transposed B fragments (matrix i: keys 8 (i & 1) .., columns 8 (i >> 1) ..)
  const int mi = lane >> 3;
  const unsigned char* qrow = qs + (16 * warp + (lane & 7) + 8 * (mi & 1)) * F::kStride + (mi >> 1) * 16;
  const unsigned char* krow = ks + (lane & 7) * F::kStride + (mi & 1) * 16;
  const unsigned char* vrow = vs + ((lane & 7) + 8 * (mi & 1)) * F::kStride + (mi >> 1) * 16;

  const bool single = S == kKeys;  // jax's single-step kernel
  float o[F::kNt][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kb = 0; kb < S / kKeys; ++kb) {
    __syncthreads();  // every warp is done with the last block
    stage_rows<D>(ks, k, base, tok, kb * kKeys, kKeys);
    stage_rows<D>(vs, v, base, tok, kb * kKeys, kKeys);
    segk[threadIdx.x] = srow[kb * kKeys + threadIdx.x];
    __syncthreads();

    // s: row g keys 8j + 2t, 8j + 2t + 1 in s[j][0..1], row g + 8 in s[j][2..3]
    float s[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int k16 = 0; k16 < D / 16; ++k16) {
      uint32_t qa[4];
      ldsm_x4(qa, qrow + k16 * 32);
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        uint32_t b0, b1;
        ldsm_x2(b0, b1, krow + 8 * j * F::kStride + k16 * 32);
        mma_bf16(s[j], qa, b0, b1);
      }
    }
    float mc[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const int s0 = segk[8 * j + 2 * t], s1 = segk[8 * j + 2 * t + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sq = e < 2 ? seg_a : seg_b;
        const int sk = e & 1 ? s1 : s0;
        s[j][e] = __fadd_rn(__fmul_rn(s[j][e], scale), sq == sk ? 0.f : kMaskValue);
        mc[e >> 1] = fmaxf(mc[e >> 1], s[j][e]);
      }
    }
    float corr[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_next = fmaxf(m[r], quad_max(mc[r]));
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        s[j][2 * r] = expf(s[j][2 * r] - m_next);
        s[j][2 * r + 1] = expf(s[j][2 * r + 1] - m_next);
        ls += s[j][2 * r] + s[j][2 * r + 1];
      }
      ls = quad_sum(ls);
      if (single) {  // p / l, then the product alone
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          s[j][2 * r] = __fdiv_rn(s[j][2 * r], ls);
          s[j][2 * r + 1] = __fdiv_rn(s[j][2 * r + 1], ls);
        }
        corr[r] = 0.f;
        inv[r] = 1.f;
      } else {
        const float l_corr = __fmul_rn(expf(m[r] - m_next), l[r]);
        const float l_next = __fadd_rn(ls, l_corr);
        inv[r] = l_next == 0.f ? 1.f : __fdiv_rn(1.f, l_next);
        corr[r] = __fmul_rn(l_corr, inv[r]);
        m[r] = m_next;
        l[r] = l_next;
      }
    }
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int half = 0; half < F::kNt / 2; ++half) {  // context columns 16 half ..
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vrow + 16 * kk * F::kStride + half * 32);
        mma_bf16(c0, pa[kk], vf[0], vf[1]);
        mma_bf16(c1, pa[kk], vf[2], vf[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        o[2 * half][e] = __fadd_rn(__fmul_rn(o[2 * half][e], corr[r]), __fmul_rn(c0[e], inv[r]));
        o[2 * half + 1][e] =
            __fadd_rn(__fmul_rn(o[2 * half + 1][e], corr[r]), __fmul_rn(c1[e], inv[r]));
      }
    }
  }
#pragma unroll
  for (int dn = 0; dn < F::kNt; ++dn) {
    const int col = 8 * dn + 2 * t;
    *reinterpret_cast<uint32_t*>(out + base + (size_t)ra * tok + col) = pack_bf16(o[dn][0], o[dn][1]);
    *reinterpret_cast<uint32_t*>(out + base + (size_t)rb * tok + col) = pack_bf16(o[dn][2], o[dn][3]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* seg, void* out, int B, int S,
           int H, float scale, cudaStream_t stream) {
  const long long blocks = (long long)B * H * (S / kRows);
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // whether this device has raised the kernel's shared-memory limit; host
  // threads may launch at once (the server's batches run in worker threads)
  static std::atomic<bool> raised[64];
  if (!raised[dev & 63].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Flash<D>::kSmem);
    if (err != cudaSuccess) return (int)err;
    raised[dev & 63].store(true, std::memory_order_release);
  }
  flash_attention_kernel<D><<<(unsigned)blocks, kThreads, Flash<D>::kSmem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int32_t*)seg, (__nv_bfloat16*)out, S, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v and out (B, S, H, head_dim) bf16, 16-byte aligned; seg (B, S)
// int32; head_dim a multiple of 16 up to 128, or 256; S a multiple of 128
// up to 512.  Returns a cudaError_t: 1 (cudaErrorInvalidValue) for shapes
// the kernel does not take, else the launch's own status.
extern "C" int flash_attention(const void* q, const void* k, const void* v, const void* seg,
                               void* out, int B, int S, int H, int head_dim, float scale,
                               void* stream) {
  if (S < kKeys || S > kMaxS || S % kKeys != 0 || B < 1 || H < 1 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, seg, out, B, S, H, scale, st);
    case 32: return launch<32>(q, k, v, seg, out, B, S, H, scale, st);
    case 48: return launch<48>(q, k, v, seg, out, B, S, H, scale, st);
    case 64: return launch<64>(q, k, v, seg, out, B, S, H, scale, st);
    case 80: return launch<80>(q, k, v, seg, out, B, S, H, scale, st);
    case 96: return launch<96>(q, k, v, seg, out, B, S, H, scale, st);
    case 112: return launch<112>(q, k, v, seg, out, B, S, H, scale, st);
    case 128: return launch<128>(q, k, v, seg, out, B, S, H, scale, st);
    case 256: return launch<256>(q, k, v, seg, out, B, S, H, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
