// Pair self-attention for BERT encoders, built for Hopper (sm_90a): a
// persistent TMA/wgmma kernel for heads of 32 up to S 512 (the persistent
// kernel, pair_attention_kernel), a persistent ring kernel for heads of 64
// and 128 at every S (ring::ring_kernel<D>, after it), and the long-pair
// kernel for heads of 32 above S 512 (longpair::long_pair_kernel, last).
// The wrapper
// (ops/attention.py) zero-pads every other head width up to 128 to the
// next of the three, which is exact: zero columns add nothing to QK^T and
// the padded context columns are dropped.
//
// Replaces financial_rag_system_tpu/ops/attention.py:48 _attn_kernel (the
// Pallas kernel behind encoder_self_attention) and computes what it
// computes: q arrives pre-scaled by 1/sqrt(d) in f32 and rounded to bf16;
// logits are bf16 x bf16 products summed in f32 plus an additive -1e9
// key-padding bias (keys in the pad past S get -inf); the softmax is f32;
// the probs are rounded to bf16 for P.V, accumulated in f32, the f32 sum
// is taken over the unrounded probs, and the 1/sum divide is applied after
// P.V.  The context is stored as bf16.  A fully masked pair stays finite,
// with a uniform softmax over its S keys.  No key past a pair's last valid
// key (kend) is loaded or computed: it would add exactly 0 (below).
// Liberties, all inside the kernel-vs-plain tolerance (atol 1e-2; above S
// 512 atol and rtol 1e-2): f32 sums are taken in another order; exp runs
// on ex2.approx; the ring and long-pair kernels' softmax is online
// (below): its probs are exp(s - m) of the running row max m, rounded to
// bf16 at that scale, and the context and sum are rescaled by exp(m_old -
// m_new) when a block (a 64-key step in the long-pair kernel) raises the
// max, where the Pallas kernel and the plain version take the full row's
// max first; and the long-pair kernel sums the bf16-rounded probs (on the
// tensor cores, below), where they sum the unrounded ones.  The
// persistent kernel finds the row max in a first sweep.
//
// The persistent kernel (heads of 32).
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
//
// The ring kernel (heads of 64 and 128).  An item's K and V up to kend no
// longer fit beside the q tiles at these widths (at d 128 and kend 400 they
// take 229 KB in 64-key chunks, more than a block's 227 KB; at d 64, 115 KB,
// which leaves no second stage), so they stream through a ring, as kernel 7
// (flash_attention.cu) does.  Floors on the H100 at the rerank shape (P 480
// pairs x S 400 tokens, 12 heads of 64 or 6 of 128), every key valid: bytes
// 1.18 GB of q, k, v and context, 0.35 ms at 3.35 TB/s; tensor cores 2 x 2
// P H S^2 d = 2.4e11 FLOP, 0.24 ms; exponentials P H S^2, 0.22-0.25 ms (12
// heads) of MUFU.EX2.  Design:
//  - a persistent grid of one block an SM walks the P * H (pair, head)
//    items, item blockIdx.x + i * gridDim.x;
//  - a producer warp (of a warpgroup whose other warps exit) reads each
//    pair's mask, finds kend, and for each unit of the item's 64-row tiles
//    (one a consumer warpgroup) stages every 128-key block below kend (all
//    S keys when kend is 0) into a ring behind full and empty mbarriers:
//    K and V by TMA from 3-D (P, S, H * d) tensor maps (boxes of 128 keys x
//    64 values, 128-byte swizzle; keys past S arrive as zeros), the block's
//    bias row (0, -1e9, -inf past S), a flag for a block whose keys are all
//    valid and one for the item's last block;
//  - consumer warpgroups (three at d 64, two at d 128) take the unit's
//    tiles, one each, and walk its stages in lockstep; a warpgroup with no
//    tile in a unit passes through its stages; each loads its next tile's
//    q by TMA into one of two buffers, a tile ahead;
//  - QK^T on wgmma m64n128k16 with q and the K block both K-major in
//    shared memory as TMA swizzles them, waited for at once;
//  - one sweep, an online softmax a block: the block's row max (four
//    chains a row, a quad shuffle), alpha = ex2((m_old - m_new) log2e), the
//    probs as one FFMA and one MUFU.EX2 each on a wholly valid block
//    (ex2(s log2e - m log2e)) and as ex2((s + bias - m) log2e) on any other
//    block (exact in the bias: a pair with no valid key gets ex2(0) = 1 for
//    every key below S, its uniform softmax), the thread's share of the sum
//    rescaled by alpha and added to, the context rescaled by alpha; the
//    quad's sums are added once, at the end.  A key past kend, or masked,
//    in a block where the row has a valid key gets ex2 of about -1.4e9: 0.
//    A block before the first valid key is wiped by alpha = 0 at the block
//    that holds it, as the plain version's exp(-1e9 - m) = 0;
//  - P.V on wgmma m64n64k16 (d 64) or m64n128k16 (d 128), a 16-key step
//    each, committed together: P's A fragments from registers, the QK^T
//    accumulator rounded to bf16 (its layout is the A fragment's), V read
//    MN-major from the swizzled stage (transposed B), the context itself
//    the accumulator.  On the H100 it ran 4-8% faster at d 64 and 10-15%
//    at d 128 than mma.sync m16n8k16 from the same registers with V's
//    fragments by ldmatrix.trans (tools/pair_attention_variants.py
//    ring_pv_mma);
//  - registers by setmaxnreg: a consumer thread 152 at d 64, 232 at d
//    128, the producer warpgroup 40, within the launch's pool (regs_fit);
//    shared memory: 5 stages at d 64, 2 at d 128 (ring_stages;
//    ops/attention.py ring_plan mirrors both).
//
// The ring holds 128-key blocks whatever S is, and nothing its producer
// keeps grows with S: it finds kend by a loop over the pair's mask, 32
// keys a step, and reads a block's 128 mask words as it stages the block.
// It serves heads of 64 and 128 above S 512 as below; the bounds scale as
// at S 400: bytes with P S H d, tensor work and exponentials with P H S
// kend.
//
// The long-pair kernel (heads of 32 above S 512).  The persistent kernel
// stages an item's K, V and bias whole, about 132 bytes a key at d 32:
// past 512 keys one stage fits, past about 1,700 none.  This kernel
// streams 128-key blocks of K and V through a ring of eight stages with
// the ring kernel's producer (64-byte swizzle).  What bounds it at the
// served shape of a 1,024-position reranker (P 480 pairs x S 992 tokens,
// 12 heads of 32, documents of 480-960 tokens): not bytes (q and the
// context, K and V of the attended keys: about 1.3 GB, 0.4 ms at 3.35
// TB/s) nor the tensor cores (QK^T and P.V over the attended keys, 5.5e11
// FLOP, 0.56 ms at 989 TFLOP/s), but the softmax between
// them: its exponentials (one ex2 a query row and attended key: about 1 ms
// at 16 MUFU.EX2 a clock an SM) and, per score, an FFMA, an FMNMX and half
// an F2FP beside it, with each step's QK^T wait, row-max shuffles and
// alpha in the chain.  On the card (PERF.md) cutting MUFU out saves an
// eighth, P.V a tenth, and the loads alone take 0.3 of the time: latency,
// not one unit, bounds it.  What the design does:
//  - units of four row tiles, one a consumer warpgroup (four warpgroups,
//    16 consumer warps an SM to hide each other's waits): an item's 16
//    tiles at S 992 are four full units, no warpgroup passes through a
//    unit idle, and K and V are staged four times an item, not six (units
//    of three; ops/attention.py long_pair_plan reckons the bytes).  Where
//    T mod 4 = r > 0, the last unit's last 4 - r warpgroups hold no tile
//    and pass through its blocks;
//  - registers by setmaxnreg: a consumer thread 112, the producer
//    warpgroup 24 (five warpgroups: a pool of 96 a thread), which holds
//    one 64-key step's scores (32 f32) beside the context: each staged
//    block is two online-softmax steps of 64 keys, each step's QK^T on
//    wgmma m64n64k16 (q and the K rows K-major in shared memory) waited
//    for before its softmax;
//  - the block holding kend, where kend mod 128 is in (0, 64], is a tail:
//    its first 64 keys alone are staged (a 64-key TMA box) and computed,
//    one step.  The keys it leaves out are at or past kend and add
//    exactly 0 to any row with a valid key; a pair with no valid key has
//    no tail and takes all S keys;
//  - P.V on mma.sync m16n8k16 straight from the score registers, V's
//    fragments by ldmatrix.trans; a fifth n8 tile against a column of ones
//    takes each row's sum of the step's bf16 probs on the tensor cores, in
//    place of an FADD a score (the sum then covers the rounded probs: a
//    liberty, above);
//  - the row max in four chains a row, alpha and the probs as the ring
//    kernel's (one FFMA and one MUFU.EX2 a score on a wholly valid step,
//    exact in the bias on any other).
// Variants timed against it at the served shape, each build in order and
// then in reverse (tools/pair_attention_variants.py; PERF.md), on the
// served and a stretched rerank mask; none faster: two warpgroups of two
// tiles, their softmaxes interleaved step by step in a warp (two chains,
// 240 registers) 1.09-1.10x its time, and with FADD sums and 128-key
// steps as well 1.17-1.20x; three warpgroups of one tile (units of three)
// 1.15-1.16x; FADD sums in four chains a row 1.04-1.05x; 128-key steps
// (64 f32 of scores) level but spilling; a block's two QK^T issued
// together, the second in flight across the first step's softmax, level;
// no tail 1.05-1.07x; the warpgroups' QK^T issued in turns on named
// barriers (FA3's ping-pong) 1.03-1.04x, or started out of phase once
// 1.01-1.03x; the contexts rescaled only where a row max moved 1.04x;
// P.V on wgmma m64n32k16 1.01x; one exp in eight on the FMA pipe 1.09x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

constexpr int kD = 32;                      // head_dim
constexpr int kMaxS = 512;                  // the persistent kernel's longest S: an item a stage
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

// (no blocks-an-SM minimum in the bounds: with it ptxas held the kernel to
// 96 registers with 8 bytes of spills, without it to 96 with none and the
// kernel ran 2-3% faster on the H100; tools/pair_attention_variants.py
// persist_min_blocks)
__global__ void __launch_bounds__(kThreads)
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

// the 32-wide kernel's launch; shapes checked by the C entry
int launch_persistent(const void* q, const void* k, const void* v, const void* mask, void* out,
                      int P, int S, int H, void* stream) {
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
// The ring kernel: heads of 64 and 128 values (the wrapper zero-pads 33-63
// to 64 and 65-127 to 128).  See the file header.

namespace ring {

constexpr int kKeys = 128;  // keys of a stage: QK^T's wgmma N and a TMA box
constexpr int kMaxStages = 8;
constexpr size_t kSmemLimit = 232448;

template <int D>
struct Cfg {
  // consumer warpgroups: three at d 64 ran 8-10% faster than two on the
  // H100 (tools/pair_attention_variants.py ring_wg2); at d 128 three leave
  // too few registers for the 64 f32 of context beside the 64 of scores
  static constexpr int kWg = D == 128 ? 2 : 3;
  static constexpr int kThreads = 128 * (kWg + 1);  // and a producer warpgroup
  // registers a thread after setmaxnreg, within the launch's pool
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = D == 128 ? 232 : 152;
  static constexpr int kCw = 64;        // values in a swizzled row of a column chunk
  static constexpr int kRowB = 2 * kCw;  // its bytes, the swizzle: 128
  static constexpr int kChunks = D / kCw;
  static constexpr int kQChunk = kRows * kRowB;  // bytes of a column chunk of a q tile
  static constexpr int kKChunk = kKeys * kRowB;  // of a K or V block
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKvBytes = kChunks * kKChunk;  // one of K, V in a stage
};

// setmaxnreg moves registers within the pool a block is given at launch:
// its threads times the count __launch_bounds__ leaves each (65,536 over
// the threads, in steps of 8).  A budget past the pool never returns.
template <int D>
constexpr bool regs_fit() {
  using C = Cfg<D>;
  return 128 * (C::kProducerRegs + C::kWg * C::kConsumerRegs) <=
         C::kThreads * (65536 / C::kThreads / 8 * 8);
}
static_assert(regs_fit<64>() && regs_fit<128>(),
              "the register budgets exceed the block's pool");

struct StageHead {
  int full;           // every key of the block is valid and below S: no bias
  int last;           // the item's last block below kend
  float bias[kKeys];  // 0 for a valid key, -1e9 for a masked one, -inf past S
};

// 1 KB to align the stages to the swizzle's atoms; per stage K, V, its
// head and its full and empty barriers; two q tiles and their barriers a
// consumer warpgroup (ops/attention.py ring_plan mirrors this)
template <int D>
constexpr size_t smem_bytes(int stages) {
  using C = Cfg<D>;
  return 1024 + stages * (2 * (size_t)C::kKvBytes + sizeof(StageHead) + 2 * sizeof(uint64_t)) +
         C::kWg * 2 * ((size_t)C::kQBytes + sizeof(uint64_t));
}

// as many stages as fit, up to kMaxStages: 5 at D 64, 2 at D 128
template <int D>
constexpr int ring_stages() {
  int n = kMaxStages;
  while (n > 2 && smem_bytes<D>(n) > kSmemLimit) --n;
  return n;
}

// s = q K^T for one block (64 rows x kKeys keys, f32), waited for:
// s[4j + 2h + e] is row 16 warp + g + 8h, key 8j + 2t + e
template <int D>
__device__ __forceinline__ void qk(float (&s)[kKeys / 2], const unsigned char* qs,
                                   const unsigned char* ks) {
  using C = Cfg<D>;
  // q's descriptors are the same for every block of a tile: left to
  // itself the compiler keeps all D / 16 of them live across the tile
  if constexpr (D == 128) {
    uintptr_t qa = reinterpret_cast<uintptr_t>(qs);
    asm volatile("" : "+l"(qa));
    qs = reinterpret_cast<const unsigned char*>(qa);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / (C::kCw / 16), o = (kk % (C::kCw / 16)) * 32;
    wgmma_ss(s, wgmma_desc_sw128(qs + c * C::kQChunk + o),
             wgmma_desc_sw128(ks + c * C::kKChunk + o), kk > 0 ? 1u : 0u);
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin(s);
}

// One consumer warp's 16 rows of one tile: the online-softmax state.
template <int D>
struct Rows {
  float o[D / 8][4];  // context tile dn: rows g, g + 8, columns 8dn + 2t, + 1
  float m[2];         // running max of the biased logits
  float l[2];         // this thread's share of the running sum of the probs
};

// The warp's rows against one staged block: the online softmax, the
// context rescaled, and P.V into it.
template <int D>
__device__ __forceinline__ void attend(Rows<D>& r, float (&s)[kKeys / 2], const StageHead& h,
                                       const unsigned char* vs, int lane) {
  using C = Cfg<D>;
  const int t = lane & 3;
  const bool full = h.full;
  if (!full) {  // the key bias, the same for every row
    const float* b = h.bias + 2 * t;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(b + 8 * j);
      s[4 * j] += bb.x;
      s[4 * j + 1] += bb.y;
      s[4 * j + 2] += bb.x;
      s[4 * j + 3] += bb.y;
    }
  }
  float alpha[2], nml[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // four chains a row, not one of kKeys / 4 dependent FMNMX
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = fmaxf(s[4 * u + 2 * hh], s[4 * u + 2 * hh + 1]);
#pragma unroll
    for (int j = 4; j < kKeys / 8; ++j)
      x[j & 3] = fmaxf(x[j & 3], fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
    const float mn = fmaxf(r.m[hh], quad_max(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]))));
    // the first block: m is -inf, alpha 0; a block that raises no row max: 1
    alpha[hh] = ex2((r.m[hh] - mn) * kLog2e);
    r.m[hh] = mn;
    nml[hh] = -mn * kLog2e;
  }
  float ls[2] = {0.f, 0.f};
  if (full) {  // one FFMA and one MUFU.EX2 a score
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], kLog2e, nml[e >> 1]));
        ls[e >> 1] += s[4 * j + e];
      }
    }
  } else {  // exact in the bias: a pair with no valid key gets ex2(0) = 1 a key below S
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = ex2((s[4 * j + e] - r.m[e >> 1]) * kLog2e);
        ls[e >> 1] += s[4 * j + e];
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) r.l[hh] = fmaf(r.l[hh], alpha[hh], ls[hh]);
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) r.o[dn][e] *= alpha[e >> 1];
  }
  // P.V on wgmma m64n<D>k16, one a 16-key step: P's A fragments from
  // registers (mma.sync's m16n8k16 A layout, warp w rows 16w ..), rounded
  // to bf16; V an MN-major B operand of the swizzled stage (atoms of 8 keys
  // x kCw values, kKChunk bytes between column chunks); the context, whose
  // layout is the accumulator's, accumulates
  uint32_t pa[kKeys / 16][4];
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);      // row g, keys 2t, 2t + 1
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);  // row g + 8
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);  // row g, keys 2t + 8, 2t + 9
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);  // row g + 8
  }
  float (&acc)[D / 2] = reinterpret_cast<float (&)[D / 2]>(r.o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    wgmma_rs_mn(acc, pa[kk], wgmma_desc_mn<C::kRowB>(vs + kk * 16 * C::kRowB, C::kKChunk), 1u);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin(acc);
}

// The producer warp: for each unit (an item's row tiles, one a consumer
// warpgroup) and each kKeys-key block below the pair's kend (all S keys
// when it has none), the block's bias row and flags, and its K and V by
// TMA (keys past S arrive as zeros).
template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        const int32_t* __restrict__ mask, unsigned char* kv,
                                        StageHead* head, uint64_t* full, uint64_t* empty,
                                        int n_items, int S, int H, int nst, int lane) {
  using C = Cfg<D>;
  constexpr uint32_t kAll = 0xffffffffu;
  const int T = (S + kRows - 1) / kRows;
  int n = 0;  // stages filled
  for (int i = 0; i < n_items; ++i) {
    const int item = blockIdx.x + i * gridDim.x;
    const int pair = item / H, hd = item - pair * H;
    // kend from the pair's mask, keys lane + 32u: any S, a 32-key word a step
    const int32_t* mrow = mask + (size_t)pair * S;
    int last = 0;
#pragma unroll 4
    for (int key = lane; key < S; key += 32)
      if (mrow[key] > 0) last = key + 1;
    const int kend = __reduce_max_sync(kAll, last);
    const int nb = ((kend > 0 ? kend : S) + kKeys - 1) / kKeys;
    for (int t0 = 0; t0 < T; t0 += C::kWg) {  // a unit: tiles t0 .. t0 + kWg - 1
      for (int kb = 0; kb < nb; ++kb) {
        // the block's validity, keys kb kKeys + lane + 32j, read while the
        // stage may still be in use
        bool ok[kKeys / 32], all = true;
#pragma unroll
        for (int j = 0; j < kKeys / 32; ++j) {
          const int key = kb * kKeys + lane + 32 * j;
          ok[j] = key < S && mrow[key] > 0;
          all = all && ok[j];
        }
        const int s = n % nst;
        mbar_wait(&empty[s], ((n / nst) & 1) ^ 1);  // the first round passes
        StageHead& h = head[s];
#pragma unroll
        for (int j = 0; j < kKeys / 32; ++j)
          h.bias[lane + 32 * j] =
              kb * kKeys + lane + 32 * j < S ? (ok[j] ? 0.0f : kNeg) : -INFINITY;
        const bool whole = __all_sync(kAll, all);
        if (lane == 0) {
          h.full = whole;
          h.last = kb == nb - 1;
          mbar_arrive_expect_tx(&full[s], 2 * C::kKvBytes);
          unsigned char* ks = kv + (size_t)s * 2 * C::kKvBytes;
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c) {
            tma_load_3d(ks + c * C::kKChunk, kmap, &full[s], hd * D + c * C::kCw, kb * kKeys, pair);
            tma_load_3d(ks + C::kKvBytes + c * C::kKChunk, vmap, &full[s], hd * D + c * C::kCw,
                        kb * kKeys, pair);
          }
        } else {
          mbar_arrive(&full[s]);
        }
        ++n;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
ring_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const int32_t* __restrict__ mask,
            __nv_bfloat16* __restrict__ out, int P, int S, int H, int nst) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kv = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qtiles = kv + (size_t)nst * 2 * C::kKvBytes;  // [kWg][2][kQBytes]
  StageHead* head = reinterpret_cast<StageHead*>(qtiles + C::kWg * 2 * C::kQBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(head + nst);
  uint64_t* empty = full + nst;
  uint64_t* qfull = empty + nst;  // [kWg][2]

  const int items = P * H;
  const int n_items = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int T = (S + kRows - 1) / kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 32);           // every producer lane, after its head writes
      mbar_init(&empty[s], 4 * C::kWg);  // every consumer warp, when done with the block
    }
    for (int b = 0; b < 2 * C::kWg; ++b) mbar_init(&qfull[b], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * C::kWg) {  // the producer warpgroup: one warp works
    setmaxnreg_dec<C::kProducerRegs>();
    if (warp == 4 * C::kWg)
      produce<D>(&kmap, &vmap, mask, kv, head, full, empty, n_items, S, H, nst, lane);
    return;
  }
  setmaxnreg_inc<C::kConsumerRegs>();

  // Consumer warpgroup wg takes the tile positions wg, wg + kWg, ... of the
  // block's items' row tiles laid end to end: one in each unit, whose
  // stages it works through in lockstep with the others; it passes through
  // the stages of a unit where it has no tile.  One thread of it loads each
  // tile's q by TMA into one of its two q buffers, a tile ahead (rows past
  // S arrive as zeros).
  const int wg = warp >> 2, wl = warp & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  unsigned char* my_q = qtiles + wg * 2 * C::kQBytes;
  uint64_t* my_qfull = qfull + 2 * wg;
  const int positions = n_items * T;
  auto load_q = [&](int pos, int b) {
    const int item = blockIdx.x + (pos / T) * gridDim.x;
    const int pair = item / H, hd = item - pair * H;
    mbar_arrive_expect_tx(&my_qfull[b], C::kQBytes);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      tma_load_3d(my_q + b * C::kQBytes + c * C::kQChunk, &qmap, &my_qfull[b],
                  hd * D + c * C::kCw, (pos % T) * kRows, pair);
  };
  const size_t tok = (size_t)H * D;  // stride of one token
  int pos = wg, k = 0, n = 0;        // k: tiles this warpgroup has taken; n: stages passed
  if (leader && pos < positions) load_q(pos, 0);
  for (int i = 0; i < n_items; ++i) {
    const int item = blockIdx.x + i * gridDim.x;
    const int pair = item / H;
    const size_t base = (size_t)pair * S * tok + (size_t)(item - pair * H) * D;
    for (int t0 = 0; t0 < T; t0 += C::kWg) {
      const int upos = i * T + t0;
      const bool has = pos < upos + min(C::kWg, T - t0);
      const int ra = (has ? (pos - i * T) * kRows : 0) + 16 * wl + (lane >> 2), rb = ra + 8;
      const unsigned char* qs = my_q + (k & 1) * C::kQBytes;
      Rows<D> r;
      if (has) {
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) r.o[dn][0] = r.o[dn][1] = r.o[dn][2] = r.o[dn][3] = 0.f;
        r.m[0] = r.m[1] = -INFINITY;
        r.l[0] = r.l[1] = 0.f;
        // every warp is past the last tile's wgmmas, which read the other buffer
        named_barrier(1 + wg, 128);
        if (leader && pos + C::kWg < positions) load_q(pos + C::kWg, (k + 1) & 1);
        mbar_wait(&my_qfull[k & 1], (k >> 1) & 1);
      }
      bool last = false;
      while (!last) {  // the item's blocks below kend
        const int s = n % nst;
        mbar_wait(&full[s], (n / nst) & 1);
        const StageHead& h = head[s];
        last = h.last;
        if (has) {
          const unsigned char* ks = kv + (size_t)s * 2 * C::kKvBytes;
          float sc[kKeys / 2];
          qk<D>(sc, qs, ks);
          attend<D>(r, sc, h, ks + C::kKvBytes, lane);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
        ++n;
      }
      if (has) {
        const int t = lane & 3;
        const float inv_a = 1.f / quad_sum(r.l[0]), inv_b = 1.f / quad_sum(r.l[1]);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const int col = 8 * dn + 2 * t;
          if (ra < S)
            *reinterpret_cast<uint32_t*>(out + base + (size_t)ra * tok + col) =
                pack_bf16(r.o[dn][0] * inv_a, r.o[dn][1] * inv_a);
          if (rb < S)
            *reinterpret_cast<uint32_t*>(out + base + (size_t)rb * tok + col) =
                pack_bf16(r.o[dn][2] * inv_b, r.o[dn][3] * inv_b);
        }
        pos += C::kWg;
        ++k;
      }
    }
  }
}

// (P, S, H * D) bf16 as a 3-D tensor map with boxes of `cw` values x
// `rows` tokens of one pair, swizzled by the box's row bytes; false if
// cuTensorMapEncodeTiled refuses it
bool tile_map(CUtensorMap* map, const void* ptr, int P, int S, int H, int D, int cw, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)H * D, (cuuint64_t)S, (cuuint64_t)P};
  const cuuint64_t strides[2] = {(cuuint64_t)H * D * 2, (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cw, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                cw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int P, int S,
           int H, void* stream) {
  using C = Cfg<D>;
  CUtensorMap qmap, kmap, vmap;
  if (!tile_map(&qmap, q, P, S, H, D, C::kCw, kRows) ||
      !tile_map(&kmap, k, P, S, H, D, C::kCw, kKeys) ||
      !tile_map(&vmap, v, P, S, H, D, C::kCw, kKeys))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  constexpr int nst = ring_stages<D>();
  constexpr size_t smem = smem_bytes<D>(nst);
  static_assert(smem <= kSmemLimit, "the ring does not fit");
  // as launch_persistent's: SMs of each device, 0 until a launch there has
  // raised this instantiation's shared-memory limit
  static std::atomic<int> sms[64];
  int n_sm = sms[dev & 63].load(std::memory_order_acquire);
  if (n_sm == 0) {
    err = cudaFuncSetAttribute(ring_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms[dev & 63].store(n_sm, std::memory_order_release);
  }
  const int ctas = P * H < n_sm ? P * H : n_sm;  // one block an SM
  ring_kernel<D><<<ctas, C::kThreads, smem, (cudaStream_t)stream>>>(
      qmap, kmap, vmap, (const int32_t*)mask, (__nv_bfloat16*)out, P, S, H, nst);
  return (int)cudaGetLastError();
}

}  // namespace ring

// ---------------------------------------------------------------------------
// Heads of 32 above S 512 (longpair::long_pair_kernel).  See the file
// header.

namespace longpair {

constexpr int D = 32;
constexpr int kKeys = ring::kKeys;   // keys of a stage
constexpr int kStep = 64;            // keys of an online-softmax step (QK^T on wgmma m64n64k16)
constexpr int kRowB = 2 * D;         // bytes of a row of q, K or V: the 64-byte swizzle
constexpr int kKvBytes = kKeys * kRowB;  // one of K, V in a stage: 8 KB
constexpr int kQBytes = kRows * kRowB;   // one q tile: 4 KB
constexpr int kWg = 4;               // consumer warpgroups
constexpr int kTiles = 1;            // row tiles of a unit a consumer warpgroup takes
constexpr int kUnit = kWg * kTiles;  // warpgroup wg takes tiles t0 + wg (its A) and t0 + kWg + wg (B)
constexpr int kThreads = 128 * (kWg + 1);  // and a producer warpgroup
constexpr int kProducerRegs = 24;          // registers a thread after setmaxnreg
constexpr int kConsumerRegs = 112;
constexpr int kMaxStages = 8;
static_assert(128 * (kProducerRegs + kWg * kConsumerRegs) <=
                  kThreads * (65536 / kThreads / 8 * 8),
              "the register budgets exceed the block's pool");

struct alignas(16) StageHead {
  float bias[kKeys];  // 0 for a valid key, -1e9 for a masked one, -inf past S
  int full;           // every key the block computes is valid and below S: no bias
  int last;           // the item's last block below kend
  int keys;           // keys the block computes: kKeys, or kStep for a tail
};

// 1 KB to align the stages to the swizzle's atoms; per stage K, V, its
// head and its full and empty barriers; a consumer warpgroup's q tiles,
// two buffers of kTiles, and a barrier a buffer (ops/attention.py
// long_pair_plan mirrors this)
constexpr size_t smem_bytes(int stages) {
  return 1024 + stages * (2 * (size_t)kKvBytes + sizeof(StageHead) + 2 * sizeof(uint64_t)) +
         kWg * 2 * (kTiles * (size_t)kQBytes + sizeof(uint64_t));
}

constexpr int ring_stages() {
  int n = kMaxStages;
  while (n > 2 && smem_bytes(n) > ring::kSmemLimit) --n;
  return n;
}
constexpr int kStages = ring_stages();
static_assert(kStages == 8 && sizeof(StageHead) == 528 && smem_bytes(kStages) == 169280,
              "eight 16 KB stages and eight q tiles");

// x as lane 0 of the warp holds it: a value the compiler then knows to be
// the same in every lane, so a branch on it is no divergent path around
// the wgmmas inside it
__device__ __forceinline__ bool warp_uniform(bool x) {
  return __shfl_sync(0xffffffffu, (int)x, 0) != 0;
}

// The producer warp: for each item, its kend (a loop over the pair's
// mask, 32 keys a step); for each unit of kUnit row tiles and each
// kKeys-key block below kend (all S keys when it has none), the block's
// bias row and flags, and its K and V by TMA (keys past S arrive as
// zeros).  Where kend mod kKeys is in (0, kStep], the block holding kend
// is a tail: its first kStep keys alone are staged and computed.
__device__ __forceinline__ void produce(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        const CUtensorMap* kmap_tail,
                                        const CUtensorMap* vmap_tail,
                                        const int32_t* __restrict__ mask, unsigned char* kv,
                                        StageHead* head, uint64_t* full, uint64_t* empty,
                                        int n_items, int S, int H, int lane) {
  constexpr uint32_t kAll = 0xffffffffu;
  const int T = (S + kRows - 1) / kRows;
  int n = 0;  // stages filled
  for (int i = 0; i < n_items; ++i) {
    const int item = blockIdx.x + i * gridDim.x;
    const int pair = item / H, hd = item - pair * H;
    const int32_t* mrow = mask + (size_t)pair * S;
    int last = 0;
#pragma unroll 4
    for (int key = lane; key < S; key += 32)
      if (mrow[key] > 0) last = key + 1;
    const int kend = __reduce_max_sync(kAll, last);
    const int nb = ((kend > 0 ? kend : S) + kKeys - 1) / kKeys;
    const bool tail = kend > 0 && (kend - 1) % kKeys < kStep;
    for (int t0 = 0; t0 < T; t0 += kUnit) {
      for (int kb = 0; kb < nb; ++kb, ++n) {
        const int keys = tail && kb == nb - 1 ? kStep : kKeys;
        // the block's validity, keys kb kKeys + lane + 32j, read while the
        // stage may still be in use
        bool ok[kKeys / 32], all = true;
#pragma unroll
        for (int j = 0; j < kKeys / 32; ++j) {
          const int key = kb * kKeys + lane + 32 * j;
          ok[j] = key < S && mrow[key] > 0;
          if (32 * j < keys) all = all && ok[j];
        }
        const int s = n % kStages;
        mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);  // the first round passes
        StageHead& h = head[s];
#pragma unroll
        for (int j = 0; j < kKeys / 32; ++j)
          h.bias[lane + 32 * j] =
              kb * kKeys + lane + 32 * j < S ? (ok[j] ? 0.0f : kNeg) : -INFINITY;
        const bool whole = __all_sync(kAll, all);
        if (lane == 0) {
          h.full = whole;
          h.last = kb == nb - 1;
          h.keys = keys;
          mbar_arrive_expect_tx(&full[s], 2 * keys * kRowB);
          unsigned char* ks = kv + (size_t)s * 2 * kKvBytes;
          const bool short_block = keys == kStep;
          tma_load_3d(ks, short_block ? kmap_tail : kmap, &full[s], hd * D, kb * kKeys, pair);
          tma_load_3d(ks + kKvBytes, short_block ? vmap_tail : vmap, &full[s], hd * D,
                      kb * kKeys, pair);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  }
}

// s = q K^T of NK keys (64 rows x NK, f32), issued and not waited for:
// two wgmma m64nNKk16 steps, both operands K-major in the 64-byte
// swizzle; s[4j + 2h + e] is row 16 warp + g + 8h, key 8j + 2t + e
template <int NK>
__device__ __forceinline__ void qk_issue(float (&s)[NK / 2], const unsigned char* qs,
                                         const unsigned char* ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(s, wgmma_desc_sw64(qs + 32 * kk), wgmma_desc_sw64(ks + 32 * kk), kk > 0 ? 1u : 0u);
}

// One consumer warp's 16 rows of one tile: the online-softmax state
struct Tile {
  float acc[D / 2];  // the context: acc[4j + 2h + e] is row g + 8h, column 8j + 2t + e
  float m[2];        // running max of the biased logits
  float l[2];        // running sum of the bf16-rounded probs, the whole row's in each lane
};

// The key bias of a step with a masked key or a key past S, the same for
// every row, into the scores
template <int NK>
__device__ __forceinline__ void add_bias(float (&s)[NK / 2], const float* bias, int t) {
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
    s[4 * j] += bb.x;
    s[4 * j + 1] += bb.y;
    s[4 * j + 2] += bb.x;
    s[4 * j + 3] += bb.y;
  }
}

// The step's row max (four chains a row), the new running max, alpha =
// ex2((m_old - m_new) log2e) (0 at the first step, whose m is -inf), and
// nml = -m_new log2e.  A step whose keys are not all valid subtracts
// m_new from its scores here and takes nml 0, so its probs are ex2((s +
// bias - m) log2e), exact in the bias: a pair with no valid key gets
// ex2(0) = 1 for every key below S, its uniform softmax.
template <int NK>
__device__ __forceinline__ void row_max(Tile& r, float (&s)[NK / 2], bool full,
                                        float (&alpha)[2], float (&nml)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = fmaxf(s[4 * u + 2 * hh], s[4 * u + 2 * hh + 1]);
#pragma unroll
    for (int j = 4; j < NK / 8; ++j)
      x[j & 3] = fmaxf(x[j & 3], fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
    const float mn = fmaxf(r.m[hh], quad_max(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]))));
    alpha[hh] = ex2((r.m[hh] - mn) * kLog2e);
    r.m[hh] = mn;
    nml[hh] = full ? -mn * kLog2e : 0.f;
  }
  if (!full) {
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) s[i] -= r.m[(i >> 1) & 1];
  }
}

// the probs of 16-key step kk, one FFMA and one MUFU.EX2 each, rounded to
// bf16 into P's A fragment pa: row g keys 2t, 2t + 1; row g + 8; row g
// keys 2t + 8, 2t + 9; row g + 8
template <int N>
__device__ __forceinline__ void exp_step(float (&s)[N], int kk, const float (&nml)[2],
                                         uint32_t (&pa)[4]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float& x = s[8 * kk + e];
    x = ex2(fmaf(x, kLog2e, nml[(e >> 1) & 1]));
  }
#pragma unroll
  for (int f = 0; f < 4; ++f) pa[f] = pack_bf16(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1]);
}

// acc += P.V of 16-key step kk and sum += P.1 on mma.sync m16n8k16: P's A
// fragment pa as exp_step made it; V's B fragments by ldmatrix.trans from
// the 64-byte-swizzled stage (see v_lane); the context is the four n8
// tiles' accumulators (acc[4j ..] is tile j's); a fifth n8 tile against a
// column of ones takes each row's sum of the step's bf16 probs (sum[0],
// sum[1]: row g; sum[2], sum[3]: row g + 8), in place of an FADD a score
__device__ __forceinline__ void pv_step(float (&acc)[D / 2], float (&sum)[4],
                                        const uint32_t (&pa)[4], const unsigned char* vrow,
                                        int swh, int kk) {
  constexpr uint32_t kOnes = 0x3f803f80u;  // two bf16 1.0
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t vf[4];
    ldsm_x4_trans(vf, vrow + 16 * kk * kRowB + (((2 * half) ^ swh) << 4));
    mma_bf16(*reinterpret_cast<float(*)[4]>(acc + 8 * half), pa, vf[0], vf[1]);
    mma_bf16(*reinterpret_cast<float(*)[4]>(acc + 8 * half + 4), pa, vf[2], vf[3]);
  }
  mma_bf16(sum, pa, kOnes, kOnes);
}

// The lane's row of V in a stage and its swizzle: lane's matrix mi = lane
// / 8 is keys 8 (mi & 1) .. of a step, column granule (mi >> 1) of the 16
// columns; granule gi of key row k sits at gi ^ ((k >> 1) & 3)
__device__ __forceinline__ const unsigned char* v_lane(const unsigned char* vs, int lane, int& swh) {
  const int mi = lane >> 3;
  const int key = (lane & 7) + 8 * (mi & 1);
  swh = ((key >> 1) & 3) ^ (mi >> 1);
  return vs + key * kRowB;
}

// One step for the warp's rows of tile a and, when TWO, of tile b, in one
// stream (two independent chains a warp): the bias where the step is not
// wholly valid, the softmax, the contexts rescaled by alpha, then each
// 16-key piece's probs made and multiplied into the contexts and the
// sums at once (P lives 16 keys, not a step).
template <int NK, bool TWO>
__device__ __forceinline__ void attend(Tile& a, float (&sa)[NK / 2], Tile& b, float (&sb)[NK / 2],
                                       const float* bias, bool full, int lane,
                                       const unsigned char* vs) {
  float ala[2], nma[2], alb[2], nmb[2];
  if (!full) {
    add_bias<NK>(sa, bias, lane & 3);
    if constexpr (TWO) add_bias<NK>(sb, bias, lane & 3);
  }
  row_max<NK>(a, sa, full, ala, nma);
  if constexpr (TWO) row_max<NK>(b, sb, full, alb, nmb);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    a.acc[i] *= ala[(i >> 1) & 1];
    if constexpr (TWO) b.acc[i] *= alb[(i >> 1) & 1];
  }
  int swh;
  const unsigned char* vrow = v_lane(vs, lane, swh);
  float oa[4] = {}, ob[4] = {};
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t pa[4], pb[4];
    exp_step(sa, kk, nma, pa);
    if constexpr (TWO) exp_step(sb, kk, nmb, pb);
    pv_step(a.acc, oa, pa, vrow, swh, kk);
    if constexpr (TWO) pv_step(b.acc, ob, pb, vrow, swh, kk);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    a.l[hh] = fmaf(a.l[hh], ala[hh], oa[2 * hh]);
    if constexpr (TWO) b.l[hh] = fmaf(b.l[hh], alb[hh], ob[2 * hh]);
  }
}

// One step of NK keys (K at ks, V at vs, their bias row) for the
// warpgroup's tiles: QK^T of both on wgmma (an absent B's scores go
// unread), waited for, then attend
template <int NK>
__device__ __forceinline__ void step(Tile& a, Tile& b, bool has_b, const unsigned char* qa,
                                     const unsigned char* qb, const unsigned char* ks,
                                     const unsigned char* vs, const float* bias, bool full,
                                     int lane) {
  float sa[NK / 2], sb[NK / 2];
  wgmma_fence();
  qk_issue<NK>(sa, qa, ks);
  if constexpr (kTiles == 2) qk_issue<NK>(sb, qb, ks);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin(sa);
  if constexpr (kTiles == 2) wgmma_pin(sb);
  if (kTiles == 2 && has_b) {
    attend<NK, true>(a, sa, b, sb, bias, full, lane, vs);
  } else {
    attend<NK, false>(a, sa, b, sb, bias, full, lane, vs);
  }
}

// A tile's context over its row sums, rows ra and ra + 8 below S of the
// item at `base`
__device__ __forceinline__ void store_tile(const Tile& r, __nv_bfloat16* __restrict__ out,
                                           size_t base, size_t tok, int ra, int S, int lane) {
  const int t = lane & 3;
  const float inv_a = 1.f / r.l[0], inv_b = 1.f / r.l[1];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (ra < S)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)ra * tok + col) =
          pack_bf16(r.acc[4 * j] * inv_a, r.acc[4 * j + 1] * inv_a);
    if (ra + 8 < S)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)(ra + 8) * tok + col) =
          pack_bf16(r.acc[4 * j + 2] * inv_b, r.acc[4 * j + 3] * inv_b);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
long_pair_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap kmap_tail,
                 const __grid_constant__ CUtensorMap vmap_tail, const int32_t* __restrict__ mask,
                 __nv_bfloat16* __restrict__ out, int P, int S, int H) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kv = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qtiles = kv + (size_t)kStages * 2 * kKvBytes;  // [kWg][2][kTiles][kQBytes]
  StageHead* head = reinterpret_cast<StageHead*>(qtiles + kWg * 2 * kTiles * kQBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(head + kStages);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;  // [kWg][2]

  const int n_items = (P * H - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int T = (S + kRows - 1) / kRows, units = (T + kUnit - 1) / kUnit;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);        // every producer lane, after its head writes
      mbar_init(&empty[s], 4 * kWg);  // every consumer warp, when done with the block
    }
    for (int b = 0; b < 2 * kWg; ++b) mbar_init(&qfull[b], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * kWg) {  // the producer warpgroup: one warp works
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 4 * kWg)
      produce(&kmap, &vmap, &kmap_tail, &vmap_tail, mask, kv, head, full, empty, n_items, S, H,
              lane);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // Consumer warpgroup wg takes tiles t0 + wg (A) and, with two tiles a
  // warpgroup, t0 + kWg + wg (B) of each unit of the block's items (each
  // where the item has it: the last unit of an item whose T is no
  // multiple of kUnit deals its tiles in that order, so a warpgroup holds
  // fewer or none there), and takes every staged block of the unit for
  // them, in steps of kStep keys.  One thread loads each unit's q tiles by
  // TMA into one of two buffers, a unit ahead (rows past S arrive as
  // zeros; a warpgroup with no tile in a unit loads none and passes
  // through its blocks).
  const int wg = warp >> 2, wl = warp & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  unsigned char* my_q = qtiles + wg * 2 * kTiles * kQBytes;
  uint64_t* my_qfull = qfull + 2 * wg;
  const int positions = n_items * units;  // the block's units
  auto load_q = [&](int k, int b) {       // unit k's tiles of this warpgroup into buffer b
    const int item = blockIdx.x + (k / units) * gridDim.x;
    const int pair = item / H, hd = item - pair * H;
    const int t0 = (k % units) * kUnit;
    int nt = 0;
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
      if (t0 + kWg * j + wg < T) nt = j + 1;
    mbar_arrive_expect_tx(&my_qfull[b], nt * kQBytes);
    for (int j = 0; j < nt; ++j)
      tma_load_3d(my_q + (b * kTiles + j) * kQBytes, &qmap, &my_qfull[b], hd * D,
                  (t0 + kWg * j + wg) * kRows, pair);
  };
  const size_t tok = (size_t)H * D;  // stride of one token
  if (leader && positions > 0) load_q(0, 0);
  int n = 0;  // stages passed
  for (int k = 0; k < positions; ++k) {
    const int item = blockIdx.x + (k / units) * gridDim.x;
    const int pair = item / H;
    const int t0 = (k % units) * kUnit;
    const bool has_a = t0 + wg < T, has_b = kTiles == 2 && t0 + kWg + wg < T;
    const int ra = (t0 + wg) * kRows + 16 * wl + (lane >> 2);  // tile A's rows ra, ra + 8
    const int rb = ra + kWg * kRows;                            // tile B's
    Tile a, b;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) a.acc[i] = b.acc[i] = 0.f;
    a.m[0] = a.m[1] = b.m[0] = b.m[1] = -INFINITY;
    a.l[0] = a.l[1] = b.l[0] = b.l[1] = 0.f;
    // every warp is past the last unit's wgmmas, which read the other buffer
    named_barrier(1 + wg, 128);
    if (leader && k + 1 < positions) load_q(k + 1, (k + 1) & 1);
    mbar_wait(&my_qfull[k & 1], (k >> 1) & 1);
    const unsigned char* qa = my_q + (k & 1) * kTiles * kQBytes;
    const unsigned char* qb = qa + (kTiles - 1) * kQBytes;
    bool last = false;
    while (!last) {  // the item's blocks below kend
      const int s = n % kStages;
      mbar_wait(&full[s], (n / kStages) & 1);
      const StageHead& h = head[s];
      last = h.last;
      if (has_a) {
        const unsigned char* ks = kv + (size_t)s * 2 * kKvBytes;
        const bool whole = warp_uniform(h.full);
        // the block's first kStep keys, then (where it is no tail) the rest:
        // one step's scores live at a time
        step<kStep>(a, b, has_b, qa, qb, ks, ks + kKvBytes, h.bias, whole, lane);
        if (warp_uniform(h.keys == kKeys))
          step<kStep>(a, b, has_b, qa, qb, ks + kStep * kRowB, ks + kKvBytes + kStep * kRowB,
                      h.bias + kStep, whole, lane);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
      ++n;
    }
    const size_t base = (size_t)pair * S * tok + (size_t)(item - pair * H) * D;
    if (has_a) store_tile(a, out, base, tok, ra, S, lane);
    if (has_b) store_tile(b, out, base, tok, rb, S, lane);
  }
}

int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int P, int S,
           int H, void* stream) {
  CUtensorMap qmap, kmap, vmap, kmap_tail, vmap_tail;
  if (!ring::tile_map(&qmap, q, P, S, H, D, D, kRows) ||
      !ring::tile_map(&kmap, k, P, S, H, D, D, kKeys) ||
      !ring::tile_map(&vmap, v, P, S, H, D, D, kKeys) ||
      !ring::tile_map(&kmap_tail, k, P, S, H, D, D, kStep) ||
      !ring::tile_map(&vmap_tail, v, P, S, H, D, D, kStep))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  constexpr size_t smem = smem_bytes(kStages);
  // as launch_persistent's: SMs of each device, 0 until a launch there has
  // raised this kernel's shared-memory limit
  static std::atomic<int> sms[64];
  int n_sm = sms[dev & 63].load(std::memory_order_acquire);
  if (n_sm == 0) {
    err = cudaFuncSetAttribute(long_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms[dev & 63].store(n_sm, std::memory_order_release);
  }
  const int ctas = P * H < n_sm ? P * H : n_sm;  // one block an SM
  long_pair_kernel<<<ctas, kThreads, smem, (cudaStream_t)stream>>>(
      qmap, kmap, vmap, kmap_tail, vmap_tail, (const int32_t*)mask, (__nv_bfloat16*)out, P, S, H);
  return (int)cudaGetLastError();
}

}  // namespace longpair

}  // namespace

// q, k, v and out (P, S, H, head_dim) bf16, contiguous, 16-byte aligned;
// mask (P, S) int32; head_dim 32 (the persistent kernel up to S 512, the
// long-pair kernel above), 64 or 128 (the ring kernel); S >= 1 and P H below
// 2^31 (S is a 32-bit TMA coordinate).  Returns a cudaError_t: 1
// (cudaErrorInvalidValue) for shapes the kernels do not take, else the
// launch's own status.
extern "C" int pair_attention(const void* q, const void* k, const void* v,
                              const void* mask, void* out, int P, int S, int H,
                              int head_dim, void* stream) {
  if (S < 1 || P < 1 || H < 1 || (long long)P * H > INT32_MAX ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  switch (head_dim) {
    case 32:
      return S <= kMaxS ? launch_persistent(q, k, v, mask, out, P, S, H, stream)
                        : longpair::launch(q, k, v, mask, out, P, S, H, stream);
    case 64: return ring::launch<64>(q, k, v, mask, out, P, S, H, stream);
    case 128: return ring::launch<128>(q, k, v, mask, out, P, S, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
