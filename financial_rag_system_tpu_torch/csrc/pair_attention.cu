// Pair self-attention for short-sequence BERT encoders, built for Hopper
// (sm_90a): a persistent TMA/wgmma kernel for 32-wide heads
// (pair_attention), and a streaming kernel templated on the head width for
// every other multiple of 16 up to 128 (pair_attention_wide, at the end of
// this file).
//
// Replaces financial_rag_system_tpu/ops/attention.py:48 _attn_kernel (the
// Pallas kernel behind encoder_self_attention) and computes what it
// computes: q arrives pre-scaled by 1/sqrt(d) in f32 and rounded to bf16;
// logits are bf16 x bf16 products summed in f32 plus an additive -1e9
// key-padding bias (keys in the pad past S get -inf); the softmax is a
// plain full-row f32 max/exp/sum (S <= 512, so no online rescaling: the
// row max is found first); the probs are rounded to bf16 for P.V,
// accumulated in f32, the f32 sum is taken over the unrounded probs, and
// the 1/sum divide is applied after P.V.  The context is stored as bf16.
// A fully masked pair stays finite, with a uniform softmax over its S keys.
// Two liberties, both inside the kernel-vs-plain tolerance: f32 sums are
// taken in another order, and exp runs on ex2.approx (below).
//
// The rest of this comment, down to the layout, is the 32-wide kernel.
// Floors on the H100 at the rerank shape (P 480 pairs x S 400 tokens, H 12
// heads of d 32), with every key valid:
//  - bytes: q, k, v in and the context out, 590 MB of bf16, 0.176 ms at
//    3.35 TB/s;
//  - tensor cores: QK^T twice (once for the row max, once for the probs)
//    and P.V, 3 x 2 P H S^2 d = 1.77e11 FLOP, 0.18 ms at 989 TFLOP/s;
//  - exponentials: P H S^2 = 9.2e8, 0.22-0.25 ms at 16 MUFU.EX2 a clock on
//    each of 132 SMs (1.98-1.75 GHz).  This is the floor.
// What the design does about each:
//  - bytes: a (pair, head)'s K and V are staged once, by TMA, and read by
//    all its query rows from shared memory; each 64-row tile of q is
//    staged once by TMA; the context is written once from registers; the
//    (S, S) scores never leave the SM.  Only the keys below the pair's
//    last valid key are loaded.
//  - tensor cores: QK^T runs on wgmma m64n64k16 with q and K both in
//    shared memory (K-major, 64-byte swizzle).  P.V runs on mma.sync
//    m16n8k16, P straight from the QK^T accumulator (its 16-key steps are
//    mma.sync's A fragments) and V's B fragments by ldmatrix.trans from
//    the swizzled stage.  A P.V wgmma would be m64n32k16, its N the head
//    width, and would tie a warpgroup's four warps together at every
//    16-key step; the kernel ran faster with mma.sync, which also lets
//    each warp stop at kend in 16-key steps and skip rows past S.
//  - exponentials: each is one FFMA and one MUFU.EX2 (ex2.approx of
//    s log2e - m log2e, with m log2e folded per row), plus one FADD into
//    the sum; none is spent past a pair's last valid key (kend), on key
//    groups of 8 past it, or on 16-row warps wholly past S.  A key past
//    kend contributes exactly 0.0 to the sum and to P.V for any row with a
//    valid key (exp(s - 1e9 - m) underflows in f32), so the skip is exact.
// Measured on the card (PERF.md): the kernel sits well above all three
// floors, bound by latency: each QK^T is waited for at once, and the
// exponentials, mma.sync and wgmma of one warp run one after the other,
// so their overlap comes from the other warps alone.  More consumer
// warpgroups helped (tools/pair_attention_variants.py); keeping a
// second chunk's QK^T in flight costs registers that four warpgroups do
// not have, and ran slower where tried.
//
// Design.  A persistent grid of one block an SM walks the P * H (pair,
// head) items, item blockIdx.x + i * gridDim.x.  A producer warp fills a
// ring of three stages (two where S > 448 leaves no room); per item it
// reads the pair's mask, writes the key bias row (0, -1e9, or -inf past
// S), kend and a bit a 64-key chunk that is wholly valid into the stage,
// and one thread issues TMA loads of K and V for the keys below kend (all
// S keys when kend is 0), in boxes of 64 keys x 64 B from a 3-D
// (P, S, H*32) tensor map, so that rows past S arrive as zeros and never
// as the next pair's, with 64-byte swizzle.  Completion goes to the
// stage's full mbarrier.  Four consumer warpgroups split the items'
// ceil(S / 64) row tiles of 64 query rows: the tiles of the block's
// items, laid end to end, go to the warpgroups in turn, so none idles
// while another finishes an item; each warpgroup loads its next tile's q
// by TMA while it works on this one.  Each warp owns 16 rows.  Per tile,
// two sweeps over the key chunks below kend: the first takes the row max,
// the second the probs, their sum and P.V.  A chunk wholly inside the
// valid keys takes no bias: its max is one FMNMX an element and its probs
// one FFMA + MUFU.EX2 + FADD, with no test between its 16-key steps; a
// chunk with a masked key (the query-side hole of a rerank pair, the
// chunk holding kend or S) adds the bias from shared memory and computes
// exp as ex2((s + bias - m) log2e), exact in the bias add.  A pair with
// no valid key (kend 0) takes that form over all S keys, so its logits
// all round to -1e9 and its softmax is uniform, as in the Pallas kernel.
// When a warpgroup is done with an item, each of its warps arrives at the
// stage's empty mbarrier, and the producer refills it.
//
// Layout: q, k, v and out are (P, S, H, d) bf16, contiguous, 16-byte
// aligned; mask is (P, S) int32 key validity.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

constexpr int kD = 32;                      // head_dim
constexpr int kMaxS = 512;
constexpr int kRows = 64;                   // query rows of a tile: one wgmma M
constexpr int kChunk = 64;                  // keys of a chunk: QK^T's wgmma N and a TMA box
constexpr int kChunkBytes = kChunk * kD * 2;  // 64 keys x 64 B
constexpr int kConsumers = 4;               // consumer warpgroups
constexpr int kThreads = 128 * kConsumers + 32;  // and a producer warp
constexpr int kAcc = kChunk / 2;            // f32 accumulators a thread holds for a chunk
constexpr int kMaxStages = 3;               // items staged at once, where shared memory holds them
constexpr int kQBytes = kRows * kD * 2;     // one tile of q: 64 rows x 64 B
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNeg = -1e9f;

struct StageHead {
  int kend;       // 1 + the pair's last valid key; 0 if it has none
  uint32_t full;  // bit c: keys [64c, 64c + 64) are all valid and below S
};

// the producer reads a chunk's validity as two of its lanes' 32-key words
static_assert(kChunk == 64, "a chunk is two 32-key mask words");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// keys padded to whole chunks
__host__ __device__ constexpr int padded_keys(int S) { return (S + kChunk - 1) / kChunk * kChunk; }

// 1 KB to align the stages to the swizzle's atoms, then per stage K and V
// (sp keys of 64 B each), two q tiles a consumer warpgroup, then per stage
// the bias row, the head and the full and empty barriers, and the q tiles'
// barriers
size_t smem_bytes(int S, int stages) {
  const size_t sp = padded_keys(S);
  return 1024 + stages * (2 * sp * 64 + sp * sizeof(float) + sizeof(StageHead) +
                          2 * sizeof(uint64_t)) +
         kConsumers * 2 * (kQBytes + sizeof(uint64_t));
}

// three stages where they fit beside the q tiles, else two
int stages_for(int S) { return smem_bytes(S, kMaxStages) <= 232448 ? kMaxStages : 2; }

// Everything a warpgroup needs to attend one tile of one staged item.
struct Tile {
  const unsigned char* ks;  // the stage's K, [sp keys][64 B], 64-byte swizzle
  const unsigned char* vs;  // the stage's V, likewise
  const float* bias;        // the stage's bias row, [sp]
  int nck;                  // key chunks to visit
  int klim;                 // keys at or past klim are skipped (kend, or S when kend is 0)
  uint32_t full;            // wholly valid chunks
  bool active;              // the warp has a row below S
};

// chunk c's keys are all valid
__device__ __forceinline__ bool chunk_full(const Tile& tl, int c) { return (tl.full >> c) & 1u; }

// s = Q K_c^T for key chunk c into acc (64 rows x kChunk keys, f32) and
// wait for it; the tile's q (64 rows x 64 B, as TMA writes it) is in
// shared memory.  Each wgmma is waited for at once, so that ptxas can
// follow the groups in flight (a wait whose count depends on a runtime
// branch makes it serialise every wgmma); the other warpgroups keep the
// tensor cores busy meanwhile.
__device__ __forceinline__ void qk(float (&acc)[kAcc], const unsigned char* qs, const Tile& tl,
                                   int c) {
  wgmma_fence();
  const unsigned char* kc = tl.ks + c * kChunkBytes;
  wgmma_ss(acc, wgmma_desc_sw64(qs), wgmma_desc_sw64(kc), 0u);
  wgmma_ss(acc, wgmma_desc_sw64(qs + 32), wgmma_desc_sw64(kc + 32), 1u);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin(acc);
}

// sweep 1 on chunk c: the row maxima of (logit + bias) of the thread's
// rows g (m[0]) and g + 8 (m[1]); acc[4j + 2h + e] is row g + 8h, key
// c kChunk + 8j + 2t + e
__device__ __forceinline__ void chunk_max(float (&m)[2], const float (&acc)[kAcc], const Tile& tl,
                                          int c, int t) {
  if (!tl.active) return;
  if (chunk_full(tl, c)) {  // four chains a row, not one of kChunk / 4 dependent FMNMX
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) r[u] = fmaxf(acc[4 * u + 2 * h], acc[4 * u + 2 * h + 1]);
#pragma unroll
      for (int j = 4; j < kChunk / 8; ++j)
        r[j & 3] = fmaxf(r[j & 3], fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
      m[h] = fmaxf(m[h], fmaxf(fmaxf(r[0], r[1]), fmaxf(r[2], r[3])));
    }
    return;
  }
  const float* bc = tl.bias + c * kChunk + 2 * t;
#pragma unroll
  for (int j = 0; j < kChunk / 8; ++j) {
    if (c * kChunk + 8 * j >= tl.klim) break;
    const float2 b = *reinterpret_cast<const float2*>(bc + 8 * j);
    m[0] = fmaxf(m[0], fmaxf(acc[4 * j] + b.x, acc[4 * j + 1] + b.y));
    m[1] = fmaxf(m[1], fmaxf(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y));
  }
}

// o += P V for one 16-key step from its probs: rounded to bf16 into the A
// fragment of an mma.sync m16n8k16 (acc's columns 16kk .. 16kk + 15 are
// exactly that fragment), V's B fragments by ldmatrix.trans from the
// swizzled stage, where the 16 B granule gi of key row r sits at granule
// gi ^ ((r >> 1) & 3).  o[dn] is the 16 x 8 tile of context columns
// 8dn .. 8dn + 7; `key` is this lane's ldmatrix row.
__device__ __forceinline__ void step_pv(float (&o)[4][4], float (&l)[2], const float (&p)[8],
                                        const unsigned char* vs, int key, int mi) {
  l[0] += (p[0] + p[1]) + (p[4] + p[5]);
  l[1] += (p[2] + p[3]) + (p[6] + p[7]);
  const uint32_t pa[4] = {pack_bf16(p[0], p[1]),   // row g, keys 2t, 2t + 1
                          pack_bf16(p[2], p[3]),   // row g + 8
                          pack_bf16(p[4], p[5]),   // row g, keys 2t + 8, 2t + 9
                          pack_bf16(p[6], p[7])};  // row g + 8
  const unsigned char* vrow = vs + key * 64;
  const int sw = (key >> 1) & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {  // context columns 16 half ..
    uint32_t vf[4];  // B fragments: keys 0-7 and 8-15 of column tiles 2half, 2half + 1
    ldsm_x4_trans(vf, vrow + ((((mi >> 1) + 2 * half) ^ sw) << 4));
    mma_bf16(o[2 * half], pa, vf[0], vf[1]);
    mma_bf16(o[2 * half + 1], pa, vf[2], vf[3]);
  }
}

// sweep 2 on chunk c: the probs, their unrounded sum into l, and P.V.  A
// wholly valid chunk takes all eight 16-key steps with no test between
// them; any other chunk stops at the step holding klim and adds the bias.
__device__ __forceinline__ void chunk_pv(float (&o)[4][4], float (&l)[2], const float (&acc)[kAcc],
                                         const Tile& tl, int c, const float (&m)[2],
                                         const float (&nml)[2], int lane, int t) {
  if (!tl.active) return;
  const int key0 = c * kChunk;
  const int mi = lane >> 3;                             // the ldmatrix matrix this lane addresses
  const int key = key0 + (lane & 7) + 8 * (mi & 1);     // its key row in step 0
  if (chunk_full(tl, c)) {
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) p[e] = ex2(fmaf(acc[8 * kk + e], kLog2e, nml[(e >> 1) & 1]));
      step_pv(o, l, p, tl.vs, key + 16 * kk, mi);
    }
    return;
  }
  const float* bc = tl.bias + key0 + 2 * t;
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    if (key0 + 16 * kk >= tl.klim) break;
    float p[8];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * kk + jj;
      if (key0 + 8 * j < tl.klim) {
        const float2 b = *reinterpret_cast<const float2*>(bc + 8 * j);
        p[4 * jj] = ex2((acc[4 * j] + b.x - m[0]) * kLog2e);
        p[4 * jj + 1] = ex2((acc[4 * j + 1] + b.y - m[0]) * kLog2e);
        p[4 * jj + 2] = ex2((acc[4 * j + 2] + b.x - m[1]) * kLog2e);
        p[4 * jj + 3] = ex2((acc[4 * j + 3] + b.y - m[1]) * kLog2e);
      } else {
        p[4 * jj] = p[4 * jj + 1] = p[4 * jj + 2] = p[4 * jj + 3] = 0.f;
      }
    }
    step_pv(o, l, p, tl.vs, key + 16 * kk, mi);
  }
}

// One warpgroup, one tile: query rows [r0, r0 + 64) of the item whose K, V
// and bias `tl` holds, q in `qs`; the thread's warp owns rows rw .. rw + 15
__device__ __forceinline__ void attend_tile(const unsigned char* qs, const Tile& tl,
                                            __nv_bfloat16* __restrict__ out, size_t base,
                                            size_t tok, int S, int rw, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float acc[kAcc];

  // sweep 1: the row max
  float m[2] = {-INFINITY, -INFINITY};
  for (int c = 0; c < tl.nck; ++c) {
    qk(acc, qs, tl, c);
    chunk_max(m, acc, tl, c, t);
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  const float nml[2] = {-m[0] * kLog2e, -m[1] * kLog2e};

  // sweep 2: probs, sums and P.V
  float o[4][4] = {};
  float l[2] = {0.f, 0.f};
  for (int c = 0; c < tl.nck; ++c) {
    qk(acc, qs, tl, c);
    chunk_pv(o, l, acc, tl, c, m, nml, lane, t);
  }
  if (!tl.active) return;  // (quad_sum's shuffles stay within a quad of this warp)
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);

  const int ra = rw + g, rb = ra + 8;
#pragma unroll
  for (int dn = 0; dn < 4; ++dn) {
    const int col = 8 * dn + 2 * t;
    if (ra < S)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)ra * tok + col) =
          pack_bf16(o[dn][0] / l[0], o[dn][1] / l[0]);
    if (rb < S)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)rb * tok + col) =
          pack_bf16(o[dn][2] / l[1], o[dn][3] / l[1]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
pair_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const int32_t* __restrict__ mask,
                      __nv_bfloat16* __restrict__ out, int P, int S, int H, int nst) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int sp = padded_keys(S);
  const size_t kv_bytes = (size_t)sp * 64;  // one of K, V in one stage
  unsigned char* qtiles = stages + nst * 2 * kv_bytes;  // [kConsumers][2][kQBytes]
  float* bias = reinterpret_cast<float*>(qtiles + kConsumers * 2 * kQBytes);  // [nst][sp]
  StageHead* head = reinterpret_cast<StageHead*>(bias + nst * sp);
  uint64_t* full = reinterpret_cast<uint64_t*>(head + nst);
  uint64_t* empty = full + nst;
  uint64_t* qfull = empty + nst;  // [kConsumers][2]

  const int items = P * H;
  const int n_items = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int T = (S + kRows - 1) / kRows;  // row tiles an item
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 32);               // every producer lane, after its bias writes
      mbar_init(&empty[s], 4 * kConsumers);  // every consumer warp, when done with the item
    }
    for (int b = 0; b < 2 * kConsumers; ++b) mbar_init(&qfull[b], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // the producer warp
    for (int i = 0; i < n_items; ++i) {
      const int item = blockIdx.x + i * gridDim.x;
      const int pair = item / H, hd = item - pair * H;
      const int s = i % nst;
      // the pair's mask, keys lane + 32u: bit u of `valid`
      const int32_t* mrow = mask + (size_t)pair * S;
      uint32_t valid = 0;
#pragma unroll
      for (int u = 0; u < kMaxS / 32; ++u) {
        const int key = lane + 32 * u;
        if (key < S && mrow[key] > 0) valid |= 1u << u;
      }
      const int last = valid ? lane + 32 * (31 - __clz(valid)) + 1 : 0;
      const int kend = __reduce_max_sync(0xffffffffu, last);
      uint32_t fullbits = 0;
#pragma unroll
      for (int c = 0; c < kMaxS / kChunk; ++c)
        if (__all_sync(0xffffffffu, ((valid >> (2 * c)) & 3u) == 3u)) fullbits |= 1u << c;
      const int nck = ((kend > 0 ? kend : S) + kChunk - 1) / kChunk;

      mbar_wait(&empty[s], ((i / nst) & 1) ^ 1);  // the first round passes
      float* b = bias + s * sp;
      for (int key = lane; key < sp; key += 32)
        b[key] = key < S ? (((valid >> (key >> 5)) & 1u) ? 0.0f : kNeg) : -INFINITY;
      if (lane == 0) {
        head[s].kend = kend;
        head[s].full = fullbits;
        mbar_arrive_expect_tx(&full[s], (uint32_t)(2 * nck * kChunkBytes));
        unsigned char* ks = stages + (size_t)s * 2 * kv_bytes;
        for (int c = 0; c < nck; ++c) {  // keys past S arrive as zeros
          tma_load_3d(ks + c * kChunkBytes, &kmap, &full[s], hd * kD, c * kChunk, pair);
          tma_load_3d(ks + kv_bytes + c * kChunkBytes, &vmap, &full[s], hd * kD, c * kChunk, pair);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumer warpgroup wg takes positions wg, wg + kConsumers, ... of the
  // block's (item, row tile) sequence; one thread of it loads each tile's
  // q by TMA into one of its two q buffers, a tile ahead (rows past S
  // arrive as zeros)
  const int wg = warp >> 2, wl = warp & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  unsigned char* my_q = qtiles + wg * 2 * kQBytes;
  uint64_t* my_qfull = qfull + 2 * wg;
  const int positions = n_items * T;
  auto load_q = [&](int pos, int b) {
    const int item = blockIdx.x + (pos / T) * gridDim.x;
    const int pair = item / H;
    mbar_arrive_expect_tx(&my_qfull[b], kQBytes);
    tma_load_3d(my_q + b * kQBytes, &qmap, &my_qfull[b], (item - pair * H) * kD,
                (pos % T) * kRows, pair);
  };
  const size_t tok = (size_t)H * kD;  // stride of one token
  int pos = wg, n = 0;                // n: tiles this warpgroup has taken
  if (leader && pos < positions) load_q(pos, 0);
  for (int i = 0; i < n_items; ++i) {
    const int s = i % nst;
    mbar_wait(&full[s], (i / nst) & 1);
    Tile tl;
    tl.ks = stages + (size_t)s * 2 * kv_bytes;
    tl.vs = tl.ks + kv_bytes;
    tl.bias = bias + s * sp;
    const int kend = head[s].kend;
    tl.full = head[s].full;
    tl.klim = kend > 0 ? kend : S;
    tl.nck = (tl.klim + kChunk - 1) / kChunk;
    const int item = blockIdx.x + i * gridDim.x;
    const int pair = item / H;
    const size_t base = (size_t)pair * S * tok + (size_t)(item - pair * H) * kD;
    for (; pos < (i + 1) * T; pos += kConsumers, ++n) {
      const int b = n & 1;
      // every warp is past the last tile's wgmmas, which read the other buffer
      named_barrier(1 + wg, 128);
      if (leader && pos + kConsumers < positions) load_q(pos + kConsumers, b ^ 1);
      mbar_wait(&my_qfull[b], (n >> 1) & 1);
      const int rw = (pos - i * T) * kRows + 16 * wl;  // the warp's first row
      tl.active = rw < S;
      attend_tile(my_q + b * kQBytes, tl, out, base, tok, S, rw, lane);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp's wgmmas have read the stage
  }
}

// (P, S, H * 32) bf16 as a 3-D tensor map with boxes of one head's 32
// values x 64 tokens of one pair and 64-byte swizzle; false if the driver
// refuses it
bool kv_map(CUtensorMap* map, const void* ptr, int P, int S, int H) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)H * kD, (cuuint64_t)S, (cuuint64_t)P};
  const cuuint64_t strides[2] = {(cuuint64_t)H * kD * 2, (cuuint64_t)S * H * kD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kD, (cuuint32_t)kChunk, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_64B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Returns a cudaError_t: 1 (cudaErrorInvalidValue) for shapes the kernel
// does not take, else the launch's own status.
extern "C" int pair_attention(const void* q, const void* k, const void* v,
                              const void* mask, void* out, int P, int S, int H,
                              int head_dim, void* stream) {
  if (head_dim != kD || S < 1 || S > kMaxS || P < 1 || H < 1 || (long long)P * H > INT32_MAX ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  if (!kv_map(&qmap, q, P, S, H) || !kv_map(&kmap, k, P, S, H) || !kv_map(&vmap, v, P, S, H))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // SMs of each device, 0 until a launch there has raised the kernel's
  // shared-memory limit; host threads may launch at once (the server's
  // batches run in worker threads), and each may do that first step
  static std::atomic<int> sms[64];
  int n_sm = sms[dev & 63].load(std::memory_order_acquire);
  if (n_sm == 0) {
    err = cudaFuncSetAttribute(pair_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               232448);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms[dev & 63].store(n_sm, std::memory_order_release);
  }
  const int ctas = P * H < n_sm ? P * H : n_sm;  // one block an SM
  const int nst = stages_for(S);
  pair_attention_kernel<<<ctas, kThreads, smem_bytes(S, nst), (cudaStream_t)stream>>>(
      qmap, kmap, vmap, (const int32_t*)mask, (__nv_bfloat16*)out, P, S, H, nst);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Heads of 16 to 128 values (a multiple of 16, 32 excepted): the streaming
// kernel.
//
// A whole (pair, head)'s K and V stop fitting in shared memory beside the
// q tiles at these widths (at d 128 and S 512 they are 256 KB, above the
// 227 KB a block may take), so this kernel streams them in 64-key chunks
// and keeps the two sweeps of the 32-wide kernel: the row max first, then
// the probs exp(s - m_final), rounded to bf16 for P.V, with their
// unrounded sum.  So the probs are the Pallas kernel's and the plain
// version's, with no online rescaling.
//
// One block of four warps takes one 64-row tile of one (pair, head), each
// warp 16 rows; the grid is every (pair, head, row tile).  Each warp holds
// its q rows as mma.sync A fragments, loaded once from device memory.  Per
// sweep, for each 64-key chunk below the pair's last valid key (kend; all
// S keys when it has none): the block stages the chunk's K (and in sweep
// 2 its V) in shared memory with 16-byte loads, rows padded by 16 bytes
// so that ldmatrix reads them without bank conflicts; QK^T runs on
// mma.sync m16n8k16 with K's B fragments by ldmatrix, P.V on mma.sync
// with P straight from the QK^T accumulator and V's by ldmatrix.trans.
// Keys past kend are skipped exactly as in the 32-wide kernel.
//
// Bound, at the rerank shape with 64-wide heads (P 480, S 400, 12 heads):
// q, k, v in and the context out are 1.18 GB of bf16 (0.35 ms at 3.35
// TB/s); the products 3 x 2 P H S^2 d = 3.5e11 FLOP (0.36 ms at 989
// TFLOP/s); the exponentials P H S^2 = 9.2e8 (0.22-0.25 ms of MUFU).  This
// kernel is simple, not fast: K and V are read once per row tile (from
// L2), each chunk's loads are waited for before its products, and no
// product overlaps a load.

namespace {

constexpr int kWideWarps = 4;  // warps a block, 16 query rows each
constexpr int kWideRows = 16 * kWideWarps;
constexpr int kWideThreads = 32 * kWideWarps;

template <int D>
struct Wide {
  static constexpr int kStride = D * 2 + 16;  // bytes of a staged key row
  static constexpr int kNt = D / 8;           // 8-wide column tiles of the context
  static constexpr size_t kSmem = 2 * (size_t)kChunk * kStride + kChunk * sizeof(float);
  static_assert(kSmem <= 48 * 1024, "static launch limit of dynamic shared memory");
};

// chunk c's rows of K (and V, when vs is given) into shared memory, zeros
// past S, and its bias slots: 0 for a valid key, -1e9 for a masked one
template <int D>
__device__ __forceinline__ void stage_chunk(unsigned char* ks, unsigned char* vs, float* bias,
                                            const __nv_bfloat16* __restrict__ k,
                                            const __nv_bfloat16* __restrict__ v,
                                            const int32_t* __restrict__ mrow, size_t base,
                                            size_t tok, int S, int c) {
  constexpr int kGran = D / 8;  // 16-byte granules a row
  for (int x = threadIdx.x; x < kChunk * kGran; x += kWideThreads) {
    const int r = x / kGran, gi = x - r * kGran, key = c * kChunk + r;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (key < S) {
      kv = *reinterpret_cast<const uint4*>(k + base + (size_t)key * tok + gi * 8);
      if (vs != nullptr) vv = *reinterpret_cast<const uint4*>(v + base + (size_t)key * tok + gi * 8);
    }
    *reinterpret_cast<uint4*>(ks + r * Wide<D>::kStride + gi * 16) = kv;
    if (vs != nullptr) *reinterpret_cast<uint4*>(vs + r * Wide<D>::kStride + gi * 16) = vv;
  }
  if (threadIdx.x < kChunk) {
    const int key = c * kChunk + threadIdx.x;
    bias[threadIdx.x] = key < S && mrow[key] > 0 ? 0.0f : kNeg;
  }
}

// acc[j] (keys 8j .. 8j + 7 of the chunk) = the warp's 16 q rows times the
// staged chunk's keys: row g, keys 2t, 2t + 1 in acc[j][0..1], row g + 8
// in acc[j][2..3]
template <int D>
__device__ __forceinline__ void wide_qk(float (&acc)[kChunk / 8][4], const uint32_t (&qa)[D / 16][4],
                                        const unsigned char* ks, int lane) {
#pragma unroll
  for (int j = 0; j < kChunk / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // ldmatrix x2: lanes 0-7 address keys 8j.. at the step's first 8 values,
  // lanes 8-15 at its second 8 (lanes 16-31 repeat them)
  const unsigned char* row = ks + (lane & 7) * Wide<D>::kStride + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int j = 0; j < kChunk / 8; ++j) {
#pragma unroll
    for (int ks16 = 0; ks16 < D / 16; ++ks16) {
      uint32_t b0, b1;
      asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                   : "=r"(b0), "=r"(b1)
                   : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(
                         row + 8 * j * Wide<D>::kStride + ks16 * 32))));
      mma_bf16(acc[j], qa[ks16], b0, b1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWideThreads)
pair_attention_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ mask,
                           __nv_bfloat16* __restrict__ out, int S, int H) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  unsigned char* ks = wide_smem;
  unsigned char* vs = ks + kChunk * Wide<D>::kStride;
  float* bias = reinterpret_cast<float*>(vs + kChunk * Wide<D>::kStride);
  __shared__ int kend_s;

  const int T = (S + kWideRows - 1) / kWideRows;
  const int tile = blockIdx.x % T, item = blockIdx.x / T;
  const int pair = item / H, hd = item - pair * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t tok = (size_t)H * D;
  const size_t base = (size_t)pair * S * tok + (size_t)hd * D;
  const int32_t* mrow = mask + (size_t)pair * S;

  // kend: 1 + the pair's last valid key, 0 if it has none
  if (threadIdx.x == 0) kend_s = 0;
  __syncthreads();
  int last = 0;
  for (int key = threadIdx.x; key < S; key += blockDim.x)
    if (mrow[key] > 0) last = key + 1;
  if (last > 0) atomicMax(&kend_s, last);
  __syncthreads();
  const int kend = kend_s;
  const int klim = kend > 0 ? kend : S;
  const int nck = (klim + kChunk - 1) / kChunk;

  // the warp's 16 rows of q as A fragments (rows past S are zeros)
  const int ra = tile * kWideRows + 16 * warp + g, rb = ra + 8;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int s16 = 0; s16 < D / 16; ++s16) {
    const int col = 16 * s16 + 2 * t;
    qa[s16][0] = ra < S ? ld32(q + base + (size_t)ra * tok + col) : 0u;
    qa[s16][1] = rb < S ? ld32(q + base + (size_t)rb * tok + col) : 0u;
    qa[s16][2] = ra < S ? ld32(q + base + (size_t)ra * tok + col + 8) : 0u;
    qa[s16][3] = rb < S ? ld32(q + base + (size_t)rb * tok + col + 8) : 0u;
  }

  float acc[kChunk / 8][4];
  // sweep 1: the row max over the keys below klim
  float m[2] = {-INFINITY, -INFINITY};
  for (int c = 0; c < nck; ++c) {
    __syncthreads();  // every warp is done with the last chunk
    stage_chunk<D>(ks, nullptr, bias, k, v, mrow, base, tok, S, c);
    __syncthreads();
    wide_qk<D>(acc, qa, ks, lane);
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
      const int key = c * kChunk + 8 * j + 2 * t;
      const float b0 = bias[8 * j + 2 * t], b1 = bias[8 * j + 2 * t + 1];
      if (key < klim) {
        m[0] = fmaxf(m[0], acc[j][0] + b0);
        m[1] = fmaxf(m[1], acc[j][2] + b0);
      }
      if (key + 1 < klim) {
        m[0] = fmaxf(m[0], acc[j][1] + b1);
        m[1] = fmaxf(m[1], acc[j][3] + b1);
      }
    }
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);

  // sweep 2: probs, their unrounded sum, and P.V
  float o[Wide<D>::kNt][4] = {};
  float l[2] = {0.f, 0.f};
  const int mi = lane >> 3;
  const unsigned char* vrow = vs + ((lane & 7) + 8 * (mi & 1)) * Wide<D>::kStride + (mi >> 1) * 16;
  for (int c = 0; c < nck; ++c) {
    __syncthreads();
    stage_chunk<D>(ks, vs, bias, k, v, mrow, base, tok, S, c);
    __syncthreads();
    wide_qk<D>(acc, qa, ks, lane);
    float p[kChunk / 8][4];
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c * kChunk + 8 * j + 2 * t + (e & 1);
        p[j][e] = key < klim ? ex2((acc[j][e] + bias[8 * j + 2 * t + (e & 1)] - m[e >> 1]) * kLog2e)
                             : 0.f;
      }
      l[0] += p[j][0] + p[j][1];
      l[1] += p[j][2] + p[j][3];
    }
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      if (c * kChunk + 16 * kk >= klim) break;
      const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                              pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                              pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int half = 0; half < Wide<D>::kNt / 2; ++half) {  // context columns 16 half ..
        uint32_t vf[4];
        ldsm_x4_trans(vf, vrow + 16 * kk * Wide<D>::kStride + half * 32);
        mma_bf16(o[2 * half], pa, vf[0], vf[1]);
        mma_bf16(o[2 * half + 1], pa, vf[2], vf[3]);
      }
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
#pragma unroll
  for (int dn = 0; dn < Wide<D>::kNt; ++dn) {
    const int col = 8 * dn + 2 * t;
    if (ra < S)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)ra * tok + col) =
          pack_bf16(o[dn][0] / l[0], o[dn][1] / l[0]);
    if (rb < S)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)rb * tok + col) =
          pack_bf16(o[dn][2] / l[1], o[dn][3] / l[1]);
  }
}

template <int D>
int launch_wide(const void* q, const void* k, const void* v, const void* mask, void* out, int P,
                int S, int H, cudaStream_t stream) {
  const long long blocks = (long long)P * H * ((S + kWideRows - 1) / kWideRows);
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  pair_attention_wide_kernel<D><<<(unsigned)blocks, kWideThreads, Wide<D>::kSmem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int32_t*)mask, (__nv_bfloat16*)out, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Heads of 16, 48, 64, 80, 96, 112 or 128 values; the arguments and the
// return as pair_attention's.
extern "C" int pair_attention_wide(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, int P, int S, int H,
                                   int head_dim, void* stream) {
  if (S < 1 || S > kMaxS || P < 1 || H < 1 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (head_dim) {
    case 16: return launch_wide<16>(q, k, v, mask, out, P, S, H, st);
    case 48: return launch_wide<48>(q, k, v, mask, out, P, S, H, st);
    case 64: return launch_wide<64>(q, k, v, mask, out, P, S, H, st);
    case 80: return launch_wide<80>(q, k, v, mask, out, P, S, H, st);
    case 96: return launch_wide<96>(q, k, v, mask, out, P, S, H, st);
    case 112: return launch_wide<112>(q, k, v, mask, out, P, S, H, st);
    case 128: return launch_wide<128>(q, k, v, mask, out, P, S, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
