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
//  - s = (q . k^T) of bf16 values summed in f32, times sm_scale; a key
//    whose segment id differs from the query's takes no weight (jax adds
//    its finite -0.7 * FLT_MAX, whose weight reaches the context as
//    exactly 0, see the liberties);
//  - S 128, jax's single-step kernel: p = exp(s - max), p / sum(p) rounded
//    to bf16, P.V summed in f32;
//  - S above 128: an online softmax over 128-key blocks, in jax's order:
//    m_next = max(m, rowmax(s)), p = exp(s - m_next), l_corr = exp(m -
//    m_next) * l, l_next = sum(p) + l_corr, inv = 1 / l_next (1 where
//    l_next is 0), acc = acc * (l_corr * inv) + (bf16(p) . V) * inv;
//  - every row, pad rows included (a pad row attends the pad keys only),
//    and the context rounded to bf16;
//  - on request (flash_attention_res, the training path), jax's saved
//    residuals: each row's final max m of the scaled scores and its sum l
//    of p at that max, one f32 a row (jax broadcasts them over 128 lanes).
//    The backward kernels (flash_attention_bwd.cu) read them.  Serving
//    asks for none, and its context is the same bit for bit.
//
// Layout: q, k, v and the output are (B, S, H, D) bf16 as the encoder's
// projections give them (no transpose), D 32, 64, 128, 256 or any multiple
// of 128 from 384 (the wrapper zero-pads every other width up to 128 to
// the next of 32, 64 and 128); the segment ids (B, S) int32, any values;
// S any multiple of 128.  These are the shapes jax's kernel takes.
// Kernels: flash_kernel<D> (D 32 up to S 512, 64 and 128 at every S; the
// design below), d256::flash256_kernel (D 256), slab::slab_kernel (384
// and wider) and longrow::long_kernel (D 32 above S 512), each with a
// section below.
//
// What bounds it on the H100, at the served shape (P 480 pairs, S 512,
// 12 heads of 32, the rerank mask padded to 512; at 3 heads of 256 the
// bytes double to 0.451 ms, the tensor work doubles and the exponentials
// are a quarter):
//  - bytes: q, k, v in and the context out, 755 MB of bf16: 0.226 ms at
//    3.35 TB/s;
//  - tensor cores: QK^T and P.V over every (query, key) pair, 4 P H S^2 D
//    = 1.9e11 FLOP: 0.196 ms at 989 TFLOP/s;
//  - exponentials, and the softmax's other per-score work (an FFMA, a
//    max, a sum, half a bf16 pack, the segment test where a block mixes
//    ids): P H S^2 = 1.5e9 scores, 0.41 ms of MUFU.EX2 alone at 16 a clock
//    an SM.  Over the (query, key) pairs that share a segment only, 0.19
//    ms.  This is the floor the design works against.
// What the design does about each:
//  - bytes: a persistent grid of one block an SM walks the P * H (pair,
//    head) items, item blockIdx.x + i * gridDim.x.  A producer warp (of a
//    warpgroup whose other warps exit) stages each item's K and V by TMA
//    (3-D (B, S, H * D) tensor maps, boxes of
//    128 keys at column head * D, 64- or 128-byte swizzle) into a ring of
//    128-key stages behind full and empty mbarriers, and each stage
//    serves a unit of the item's 64-row tiles, one tile to each consumer
//    warpgroup (3 at D 32, 2 at D 64 and 128): K and V come from device
//    memory once per item and from L2 once per unit (at D 32 and S 512
//    three times an item, against eight times, once a row tile, before).
//    The consumers' registers (setmaxnreg: 152 a thread at D 32, 232 at
//    D 64, 240 at D 128; the producer warpgroup 40, 24 at D 128) hold the
//    64 f32 scores of a 128-key block beside the context without spilling.
//    Each
//    warpgroup's q tiles come by TMA into two buffers, a tile ahead.  The
//    context is stored from registers.
//  - tensor cores: QK^T on wgmma m64n128k16 with q and the K block both
//    K-major in shared memory as TMA swizzles them.  P.V on mma.sync
//    m16n8k16, P straight from the QK^T accumulator (its 16-key steps are
//    mma.sync's A fragments) and V's B fragments by ldmatrix.trans from
//    the swizzled stage: kernel 2 measured this faster than a P.V wgmma at
//    d 32, and it needs no MN-major descriptor.  A 16-row warp's P.V runs
//    32 context columns at a time over the block's 128 keys into a fresh
//    accumulator, so the block's product is whole in f32 before it is
//    scaled and added, as jax adds it.
//  - exponentials: each is one FFMA (s sm_scale log2e - m sm_scale log2e,
//    the second term folded per row) and one MUFU.EX2 (ex2.approx); a
//    (tile, block) pair in which no query row shares a segment id with
//    any key is skipped whole (no QK^T, softmax or P.V; no load at all
//    when no tile of the unit needs the block).  The test is exact for any
//    int32 ids: the producer makes a 32-bit presence mask of the ids in
//    [0, 32) of each of a unit's row tiles when the unit starts and of
//    each block as it stages it (every bit where any other id appears), so
//    nothing it keeps grows with S.  A block whose keys all carry one id
//    needs no test a score: a row attends all of it or none of it.
// Measured on the card (PERF.md, tools/flash_attention_variants.py): the
// kernel is bound by latency, not by one unit.  Cutting out the MUFU work,
// the segment test or P.V saves a tenth or so each; the warpgroups of a
// unit take each stage's QK^T, softmax and P.V at the same time, so the
// tensor cores, MUFU and the issue slots wait on each other.  Two consumer
// warpgroups ran slower than three; four (at 112 registers) spilled and
// ran slower.  Tried and dropped: skipping the 16-key steps of a block
// that none of a warp's rows attends (exact, a third of the served mask's
// scores against a tenth for whole blocks) ran slower, its branches
// cutting the softmax and P.V into blocks the scheduler cannot overlap;
// the row sums on the tensor core (P . 1, of the bf16 p) ran a little
// faster but doubled the difference from the plain version, to half the
// tolerance.
//
// Liberties against jax's arithmetic, all inside the kernel-vs-plain
// tolerance (atol 1e-2):
//  - exp is ex2.approx of one FFMA (a few f32 ulps);
//  - a masked key takes exactly zero weight (a select on the score, and a
//    row with no key of its segment in the block so far keeps m = -inf,
//    l = 0, acc = 0) in place of the additive mask value.  jax gives it
//    exactly zero weight too: exp(mask - m) = 0 once the row has a key of
//    its segment, and before that the l_corr = exp(mask - m) * l = 0
//    product wipes what the wholly masked blocks added.  Every row has
//    such a key (its own), so the contexts agree;
//  - a skipped (tile, block) pair leaves acc as it was, where jax scales it
//    by l_corr * inv = l * (1 / l): at most one f32 ulp a skipped block;
//  - the accumulator update is one FMA, S 128's p / sum(p) a product with
//    the reciprocal, and the f32 sums are taken in another order.
//
// D 256 (d256::flash256_kernel<SINGLE>, at the end; SINGLE at S 128)
// keeps that skeleton and those liberties: the persistent grid, a
// producer warp staging by TMA behind full and empty mbarriers with each
// block's StageHead (segment ids, the unit's `need` bits), q tiles by TMA,
// ex2.approx of one FFMA, the zero-weight select and the (tile, block)
// skips.  What differs:
//  - shared memory: a q tile is 32 KB and a 128-key block of K and V 128
//    KB, so the D <= 128 stage leaves no ring.  K and V are staged as 32
//    KB slots, each the block's 128 keys at half the head's columns (two
//    TMA boxes of 64 columns, 128-byte swizzle), in the order K columns
//    0-127, K 128-255, V 0-127, V 128-255, through a ring of five slots;
//    the K slots go back to the producer once QK^T has waited, so the next
//    block's K loads while this block's softmax and P.V run.  Five slots,
//    one q tile for each of two consumer warpgroups and the heads of two
//    blocks take 231,552 of the 232,448 bytes (static_asserts below);
//  - registers: two consumer warpgroups at 240 and the producer
//    warpgroup at 24 (128 (24 + 2 x 240) = 64,512, the pool of 384
//    threads at 168).  A thread holds 128 f32 of context.  Beside it, the
//    64 scores of a 128-key block spilled whatever else was trimmed, so
//    the online softmax takes 64-key steps, as FA3 narrows its key block
//    at d 256: 32 f32 of scores a thread, no spills, and a
//    quarter less time on the card than the spilling 128-key steps
//    (PERF.md; tools/flash_attention_variants.py d256_keys_128).
//    P is packed to bf16 a 16-key step at a time as the scores are
//    exponentiated, so the f32 scores die as P is built;
//  - tensor cores: QK^T is one wgmma m64n64k16 chain of 16 steps a 64-key
//    step, over the two K slots; P.V runs on wgmma too (m64n128k16 with P
//    from registers and V MN-major, one product a 16-key step and column
//    half: the two V slots need not be adjacent in the ring, so no N-256
//    product spans them), accumulating into the context itself;
//  - reuse: a unit is the two warpgroups' row tiles of one item, and the
//    units are dealt round the blocks in order, so the S / 128 units of
//    an item run on neighbouring SMs at once and read its K and V from
//    device memory once and from L2 S / 128 times.  (Whole items a block,
//    their units one after another, keep 132 items' K and V, 67 MB at S
//    512, in flight: more than the 50 MB L2.)
// Liberties of D 256 beyond those above, inside the same atol 1e-2
// (tests/test_torch_flash_wide.py emulates the kernel's order on the CPU
// and holds it to the plain version and to jax's kernel):
//  - above S 128 the online softmax steps over 64 keys, not jax's 128: P
//    is rounded to bf16 against the running max over the keys up to the
//    end of its 64-key step.  S 128 keeps jax's single step, P = p /
//    sum(p) rounded against the row's max over all 128 keys, in an
//    instantiation of its own that takes the block in two passes of
//    64-key steps (the first for each row's max and sum, the second, QK^T
//    again, for P and P.V): 128 keys of scores beside the context spilled.
//    Its sum is the online softmax's (a rescale of the first step's share
//    by exp(m_0 - m)), not jax's sum in one order: a few f32 ulps;
//  - the context accumulates unnormalised (acc = acc alpha + P.V, l = l
//    alpha + sum(p), alpha = exp(m - m_next)) and is divided by l once at
//    the end: jax's normalised update (acc_jax = acc / l after every
//    block) rearranged.
//
// Heads of 384 and every wider multiple of 128 (slab::slab_kernel<G,
// SINGLE>, at the end).  What bounds it: at phase 15 (c)'s shape (P 480,
// S 1,024, 2 heads of 384) the function's tensor work, 0.99 ms at 989
// TFLOP/s, over its bytes (0.38 ms); its exponentials (P H S^2) are a
// sixth of D 32's.  But a 64-row tile's context at D 384 is 24,576 f32,
// three eighths of the SM's registers, and a 128-key block of K and V
// 192 KB: the card holds one tile's context and one block at a time, and
// what it stages from L2 (K and V once for every tile that reads them)
// is the cost to design against.  What the design does:
//  - one QK^T and one softmax a (tile, block) over the whole head: the
//    two consumer warpgroups hold the tile's context between them (a
//    64-column chunk of each 128-column slab each: 32 f32 a chunk a
//    thread, 96 at D 384, 128 at D 512), and split each block's keys for
//    QK^T (wgmma m64n64k16, keys 64 wg .. of the block, q resident in
//    shared memory, loaded once a tile) and the softmax; their row
//    maxima (and at S 128 their row sums) meet in shared memory behind a
//    named barrier, each writes its 64 keys of P (bf16, 128-byte
//    swizzle) there for the other, and both run P.V (wgmma m64n64k16)
//    with P's A fragments from registers (their own keys' as the softmax
//    made them, the other's read back by ldmatrix) and B their chunk of
//    V MN-major, a block's last P.V left in flight into the next
//    block's QK^T;
//  - K and V staged once for two row tiles: a cluster of two blocks (two
//    SMs) takes two row tiles of an item, and each block loads its 64
//    keys of every K and V slot for both (TMA multicast); a slot's
//    release counts both blocks' consumer warps (remote mbarrier arrives
//    with CTA-scope release: cluster-scope ones made a slot's round trip
//    the kernel's bottleneck, over twice as slow).  Clusters of four ran slower
//    than two, and one (no multicast) slower still (PERF.md;
//    tools/flash_attention_variants.py slab_cluster_1, slab_cluster_4);
//  - through a ring of 32 KB slots (128 keys x 128 columns: K's pieces,
//    then V's slabs of the column group; four at D 384 and 512 beside q,
//    P and the heads), K's slots going back a piece at a time as QK^T
//    moves on (wait_group 1), V's a slab at a time.
// L2 -> shared bytes at phase 15 (c)'s shape: 12.83 GB against the
// parent's 42.28 GB (ops/flash_attention.py slab_plan).  Heads wider than
// 512 run in column groups of two to four slabs, as even as they come
// (640: 3 + 2; 1,024: 4 + 4), a launch for each group size, QK^T and the
// softmax once a group: a thread holds at most four slabs' chunks of
// context (128 f32) beside its 32 scores and 32 words of P, and five (160
// f32) would pass its 224 registers, so this is the one place the kernel
// computes a (tile, block)'s QK^T more than once (PERF.md, open
// questions).  One instantiation with four slabs' accumulators, taking a
// group's slab count at run time, in one launch (640 as 4 + 1), ran slower
// on the H100 (tools/flash_attention_variants.py slab640_one_launch,
// slab1024_one_launch and their _groups_outer forms; PERF.md, PR 23 call
// 22): 1.15-1.24x at 640 with a row-tile pair's groups dealt one after
// the other (an even count of clusters leaves each cluster units of one
// group, and the four-slab ones set the time), 1.05-1.06x with the groups
// outermost in an item, which made 1,024 1.04-1.09x.  Heads above
// 1,024 stage q's 128-column pieces a block beside K's (q no longer fits
// beside two slots).
// Liberties beyond the file's, inside the same atol 1e-2
// (tests/test_torch_long_attention.py emulates the order): the context
// accumulates unnormalised and is divided by l once at the end, as at D
// 256; l is the sum of the two warpgroups' shares.  m and l for the flash
// trainer come from the one softmax.
//
// Heads of 32 above S 512 (longrow::long_kernel, at the end).  What bounds
// it: not the tensor work (a 32-deep QK^T and P.V) but the softmax's
// per-score work, an FFMA, an MUFU.EX2, an FMNMX, an FADD, half an F2FP
// and the segment test where a block mixes ids, over every score of the
// (tile, block) pairs the skip rule keeps (more than the pairs that share
// a segment, whose MUFU floor PERF.md gives); issue slots more than
// MUFU (cutting MUFU out saves a tenth: PERF.md).  flash_kernel<32>
// there (three warpgroups, units of three tiles: the sixth unit of an
// item's 16 tiles holds one, its other warpgroups idle) is bound by
// latency, as its note above says.
// What the design does: two consumer warpgroups take two row tiles each
// of a unit of four (16 tiles are four units: none idles, and K and V
// are staged four times an item, not six); a warpgroup takes each staged
// block for both its tiles, QK^T of both on wgmma, then both softmaxes
// interleaved step by step (two independent chains a warp: 7% faster
// than one after the other) and both P.V on mma.sync, its arithmetic
// otherwise flash_kernel's.  No QK^T or P.V is in flight across a
// softmax.  FA3's pipeline ran slower, timed as variants at phase 15
// (b)'s shape (tools/flash_attention_variants.py; PERF.md, PR 23 calls 20
// and 22): one tile a warpgroup with block kb's QK^T and block kb - 1's
// P.V (wgmma m64n32k16) in flight across the softmax and the warpgroups
// issuing in turns on named barriers (long_pipelined) 1.14-1.17x, without
// the turns (long_pipelined_solo) 1.08-1.12x, and two tiles a warpgroup
// each running its softmax while the other's P.V and next QK^T are in
// flight (long_staggered) 1.22-1.23x: the tensor work they hide is small
// at d 32 (the softmax cut out leaves a third of the time), the first two
// give up the two chains a warp and stage K and V twice as often (units
// of two), and the third runs its two tiles' softmaxes one after the
// other, not interleaved step by step.  Heads of
// 64 and 128 keep flash_kernel<D> above S 512: two tiles' contexts (64 or
// 128 f32 a thread each) beside two blocks of scores pass the 240
// registers a thread.  Its liberty beyond the file's: the context
// accumulates unnormalised (as at D 256).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

constexpr int kKeys = 128;    // jax's block_k: a stage, and QK^T's wgmma N
constexpr int kRows = 64;     // query rows of a tile: one wgmma M
constexpr int kMaxStages = 8;
constexpr size_t kSmemLimit = 232448;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kWg = D == 32 ? 3 : 2;          // consumer warpgroups
  static constexpr int kThreads = 128 * (kWg + 1);     // and a producer warpgroup
  // registers a thread after setmaxnreg, within the launch's pool
  static constexpr int kProducerRegs = D == 128 ? 24 : 40;
  static constexpr int kConsumerRegs = D == 32 ? 152 : D == 64 ? 232 : 240;
  static constexpr int kCw = D == 32 ? 32 : 64;  // values in a swizzled row of a column chunk
  static constexpr int kRowB = 2 * kCw;          // its bytes, the swizzle: 64 or 128
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
static_assert(regs_fit<32>() && regs_fit<64>() && regs_fit<128>(),
              "the register budgets exceed the block's pool");

struct StageHead {
  uint32_t need;   // bit i: tile i of the unit attends this block
  int uniform;     // every key of the block carries the id `id`
  int id;
  int pad;        // ids 8-byte aligned for the consumers' int2 loads
  int ids[kKeys];  // the block's segment ids
};

// 1 KB to align the stages to the swizzle's atoms; per stage K, V, its
// head and its full and empty barriers; two q tiles and their barriers a
// consumer warpgroup
template <int D>
constexpr size_t smem_bytes(int stages) {
  using C = Cfg<D>;
  return 1024 + stages * (2 * (size_t)C::kKvBytes + sizeof(StageHead) + 2 * sizeof(uint64_t)) +
         C::kWg * 2 * ((size_t)C::kQBytes + sizeof(uint64_t));
}

// as many stages as fit, up to kMaxStages: 8 at D 32, 6 at D 64, 2 at D 128
template <int D>
constexpr int ring_stages() {
  int n = kMaxStages;
  while (n > 2 && smem_bytes<D>(n) > kSmemLimit) --n;
  return n;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x as lane 0 of the warp holds it: a value the compiler then knows to be
// the same in every lane, so a branch on it around wgmmas in flight is no
// divergent path (ptxas would otherwise fence and serialise them, C7520)
__device__ __forceinline__ bool warp_uniform(bool x) {
  return __shfl_sync(0xffffffffu, (int)x, 0) != 0;
}

template <int RowB>
__device__ __forceinline__ uint64_t desc(const void* p) {
  if constexpr (RowB == 64) return wgmma_desc_sw64(p);
  else return wgmma_desc_sw128(p);
}

// s = q K^T for one 128-key block (64 rows x 128 keys, f32), waited for:
// s[4j + 2h + e] is row 16 warp + g + 8h, key 8j + 2t + e
template <int D>
__device__ __forceinline__ void qk(float (&s)[64], const unsigned char* qs,
                                   const unsigned char* ks) {
  using C = Cfg<D>;
  // q's descriptors are the same for every block of a tile: left to
  // itself the compiler keeps all D / 16 of them live across the tile,
  // which heads of 128 cannot afford
  if constexpr (D == 128) {
    uintptr_t qa = reinterpret_cast<uintptr_t>(qs);
    asm volatile("" : "+l"(qa));
    qs = reinterpret_cast<const unsigned char*>(qa);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / (C::kCw / 16), o = (kk % (C::kCw / 16)) * 32;
    wgmma_ss(s, desc<C::kRowB>(qs + c * C::kQChunk + o), desc<C::kRowB>(ks + c * C::kKChunk + o),
             kk > 0 ? 1u : 0u);
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin(s);
}

// One consumer warp's 16 rows of one tile: the online-softmax state.
template <int D>
struct Rows {
  float acc[D / 8][4];  // context tile dn: rows g, g + 8, columns 8dn + 2t, + 1
  float m[2], l[2];     // running max (of the unscaled scores) and sum
  int seg[2];           // the rows' segment ids
};

// The warp's rows against one staged block: softmax and P.V into r.
// SINGLE: S 128, jax's single-step kernel.
template <int D, bool SINGLE>
__device__ __forceinline__ void attend(Rows<D>& r, float (&s)[64], const StageHead& h,
                                       const unsigned char* vs, float c2, int lane) {
  using C = Cfg<D>;
  const int t = lane & 3;
  // the segment test: none[h] when row h attends no key of the block
  bool none[2] = {false, false};
  if (h.uniform) {
    none[0] = r.seg[0] != h.id;
    none[1] = r.seg[1] != h.id;
  } else {
    const int* ids = h.ids + 2 * t;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      // at heads of 128, four ids' loads in flight, not all sixteen
      if constexpr (D == 128)
        if (j % 4 == 0) asm volatile("" ::: "memory");
      const int2 kid = *reinterpret_cast<const int2*>(ids + 8 * j);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        s[4 * j + 2 * hh] = kid.x == r.seg[hh] ? s[4 * j + 2 * hh] : -INFINITY;
        s[4 * j + 2 * hh + 1] = kid.y == r.seg[hh] ? s[4 * j + 2 * hh + 1] : -INFINITY;
      }
    }
  }
  float cr[2], nm[2], alpha[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // four chains a row, not one of 32 dependent FMNMX
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = fmaxf(s[4 * u + 2 * hh], s[4 * u + 2 * hh + 1]);
#pragma unroll
    for (int j = 4; j < kKeys / 8; ++j)
      x[j & 3] = fmaxf(x[j & 3], fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
    float mx = quad_max(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])));
    if (none[hh]) mx = -INFINITY;
    const float mn = fmaxf(r.m[hh], mx);
    const bool empty = mn == -INFINITY;  // no key of the row's segment yet
    alpha[hh] = empty ? 1.f : ex2((r.m[hh] - mn) * c2);
    // p = ex2(s c2 - mn c2); 0 for every key of a row that attends none
    cr[hh] = none[hh] ? 0.f : c2;
    nm[hh] = none[hh] ? -INFINITY : (empty ? 0.f : -mn * c2);
    r.m[hh] = mn;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1;
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], cr[hh], nm[hh]));
      ls[hh] += s[4 * j + e];
    }
  }
  float corr[2], inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    ls[hh] = quad_sum(ls[hh]);
    if constexpr (SINGLE) {  // p / l, then the product alone
      const float rl = 1.f / ls[hh];
      r.l[hh] = ls[hh];  // the residual l
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        s[4 * j + 2 * hh] *= rl;
        s[4 * j + 2 * hh + 1] *= rl;
      }
      corr[hh] = 0.f;
      inv[hh] = 1.f;
    } else {
      const float l_corr = alpha[hh] * r.l[hh];
      const float l_next = ls[hh] + l_corr;
      inv[hh] = l_next == 0.f ? 1.f : 1.f / l_next;
      corr[hh] = l_corr * inv[hh];
      r.l[hh] = l_next;
    }
  }
  uint32_t pa[kKeys / 16][4];  // P's A fragments, a 16-key step each
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);          // row g, keys 2t, 2t + 1
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);      // row g + 8
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);      // row g, keys 2t + 8, 2t + 9
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);      // row g + 8
  }
  // V's B fragments by ldmatrix.trans: lane's matrix mi = lane / 8 is keys
  // 8 (mi & 1) .. of the step, column granule (mi >> 1) of the 16 columns;
  // granule gi of key row k sits at gi ^ ((k >> 1) & 3) (64-byte swizzle)
  // or gi ^ (k & 7) (128-byte), the same for the lane's row in every step
  const int mi = lane >> 3;
  const int key = (lane & 7) + 8 * (mi & 1);
  const int swh = (C::kRowB == 64 ? (key >> 1) & 3 : key & 7) ^ (mi >> 1);
  const unsigned char* vrow = vs + key * C::kRowB;
#pragma unroll
  for (int c32 = 0; c32 < D / 32; ++c32) {  // context columns 32 c32 ..
    float pv[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // the step's even granule g0 of the row, in column chunk g0 / (kCw / 8);
        // the lane's is g0 + (mi >> 1), and (g0 + (mi >> 1)) ^ sw = g0 ^ swh
        const int g0 = 4 * c32 + 2 * half;
        const int chunk = g0 / (C::kCw / 8), gl = g0 % (C::kCw / 8);
        uint32_t vf[4];
        ldsm_x4_trans(vf, vrow + chunk * C::kKChunk + 16 * kk * C::kRowB + ((gl ^ swh) << 4));
        mma_bf16(pv[2 * half], pa[kk], vf[0], vf[1]);
        mma_bf16(pv[2 * half + 1], pa[kk], vf[2], vf[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& a = r.acc[4 * c32 + n][e];
        a = fmaf(pv[n][e], inv[e >> 1], a * corr[e >> 1]);
      }
    }
  }
}

// jax's saved residuals of rows ra and rb of an item (row0 = item * S in
// the (B, H, S) arrays): the row's final max of the scaled scores (m, the
// unscaled max times scale: a positive factor keeps the max) and its sum
// of p at that max (l)
__device__ __forceinline__ void store_residuals(float* res_m, float* res_l, size_t row0, int ra,
                                                int rb, const float (&m)[2], const float (&l)[2],
                                                float scale) {
  res_m[row0 + ra] = m[0] * scale;
  res_m[row0 + rb] = m[1] * scale;
  res_l[row0 + ra] = l[0];
  res_l[row0 + rb] = l[1];
}

// The skip rule's view of a run of segment ids, the warp's values x: bit i
// when some lane holds id i in [0, 32), every bit when some lane holds any
// other id (such a run may share an id with anything).  A (tile, block)
// pair is needed when its tile's and its block's masks meet; the test is
// exact for any int32 ids, and nothing it keeps grows with S.
template <int N>
__device__ __forceinline__ uint32_t presence(const int (&x)[N]) {
  constexpr uint32_t kAll = 0xffffffffu;
  uint32_t bits = 0;
  bool other = false;
#pragma unroll
  for (int u = 0; u < N; ++u) {
    bits |= (unsigned)x[u] < 32u ? 1u << x[u] : 0u;
    other = other || (unsigned)x[u] >= 32u;
  }
  return __any_sync(kAll, other) ? ~0u : __reduce_or_sync(kAll, bits);
}

// The presence masks of a unit's row tiles t0 .. t0 + kWg - 1 of a pair
// (0 for a tile past its T tiles: it needs no block)
template <int kWg>
__device__ __forceinline__ void tile_presence(const int32_t* srow, int t0, int T, int lane,
                                              uint32_t (&tp)[kWg]) {
#pragma unroll
  for (int w = 0; w < kWg; ++w) {
    tp[w] = 0;
    if (t0 + w < T) {
      const int x[2] = {srow[(t0 + w) * kRows + lane], srow[(t0 + w) * kRows + 32 + lane]};
      tp[w] = presence(x);
    }
  }
}

// 128-key block kb of a pair: its ids (x, lane's keys lane + 32u), their
// least and largest (one id fills it when they are equal), and the bits
// of the unit's tiles (presence masks tp) that share an id with it
template <int kWg>
__device__ __forceinline__ uint32_t block_need(const int32_t* srow, int kb,
                                               const uint32_t (&tp)[kWg], int lane, int (&x)[4],
                                               int& lo, int& hi) {
  constexpr uint32_t kAll = 0xffffffffu;
#pragma unroll
  for (int u = 0; u < 4; ++u) x[u] = srow[kb * kKeys + lane + 32 * u];
  lo = __reduce_min_sync(kAll, min(min(x[0], x[1]), min(x[2], x[3])));
  hi = __reduce_max_sync(kAll, max(max(x[0], x[1]), max(x[2], x[3])));
  const uint32_t bp = presence(x);
  uint32_t need = 0;
#pragma unroll
  for (int w = 0; w < kWg; ++w)
    if (tp[w] & bp) need |= 1u << w;
  return need;
}

// The producer warp: for each unit (an item's row tiles, one a consumer
// warpgroup) and each 128-key block, the block's segment ids, which of the
// unit's tiles attend it, and its K and V by TMA where any does.
template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        const int32_t* __restrict__ seg, unsigned char* kv,
                                        StageHead* head, uint64_t* full, uint64_t* empty,
                                        int n_items, int S, int H, int nst, int lane) {
  using C = Cfg<D>;
  const int T = S / kRows, nb = S / kKeys;
  int n = 0;  // stages filled
  for (int i = 0; i < n_items; ++i) {
    const int item = blockIdx.x + i * gridDim.x;
    const int pair = item / H, hd = item - pair * H;
    const int32_t* srow = seg + (size_t)pair * S;
    for (int t0 = 0; t0 < T; t0 += C::kWg) {  // a unit: tiles t0 .. t0 + kWg - 1
      uint32_t tp[C::kWg];
      tile_presence<C::kWg>(srow, t0, T, lane, tp);
      for (int kb = 0; kb < nb; ++kb) {
        int x[4], lo, hi;
        const uint32_t need = block_need<C::kWg>(srow, kb, tp, lane, x, lo, hi);
        const int s = n % nst;
        mbar_wait(&empty[s], ((n / nst) & 1) ^ 1);  // the first round passes
        StageHead& h = head[s];
#pragma unroll
        for (int u = 0; u < 4; ++u) h.ids[lane + 32 * u] = x[u];
        if (lane == 0) {
          h.need = need;
          h.uniform = lo == hi;
          h.id = lo;
        }
        if (lane == 0 && need) {
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
flash_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, const int32_t* __restrict__ seg,
             __nv_bfloat16* __restrict__ out, float* __restrict__ res_m,
             float* __restrict__ res_l, int P, int S, int H, float scale, int nst) {
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
  const int T = S / kRows, nb = S / kKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 32);             // every producer lane, after its head writes
      mbar_init(&empty[s], 4 * C::kWg);    // every consumer warp, when done with the block
    }
    for (int b = 0; b < 2 * C::kWg; ++b) mbar_init(&qfull[b], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * C::kWg) {  // the producer warpgroup: one warp works
    setmaxnreg_dec<C::kProducerRegs>();
    if (warp == 4 * C::kWg)
      produce<D>(&kmap, &vmap, seg, kv, head, full, empty, n_items, S, H, nst, lane);
    return;
  }
  setmaxnreg_inc<C::kConsumerRegs>();

  // Consumer warpgroup wg takes the tile positions wg, wg + kWg, ... of the
  // block's items' row tiles laid end to end: one in each unit, whose
  // stages it works through in lockstep with the others; it passes through
  // the stages of a unit where it has no tile.  One thread of it loads each
  // tile's q by TMA into one of its two q buffers, a tile ahead.
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
  const float c2 = scale * kLog2e;
  const bool single = nb == 1;
  int pos = wg, k = 0, n = 0;  // k: tiles this warpgroup has taken; n: stages passed
  if (leader && pos < positions) load_q(pos, 0);
  for (int i = 0; i < n_items; ++i) {
    const int item = blockIdx.x + i * gridDim.x;
    const int pair = item / H;
    const size_t base = (size_t)pair * S * tok + (size_t)(item - pair * H) * D;
    for (int t0 = 0; t0 < T; t0 += C::kWg) {
      const int upos = i * T + t0;
      const bool has = pos < upos + min(C::kWg, T - t0);
      const int mine = pos - upos;  // the tile's index in the unit
      const int ra = (has ? (pos - i * T) * kRows : 0) + 16 * wl + (lane >> 2), rb = ra + 8;
      const unsigned char* qs = my_q + (k & 1) * C::kQBytes;
      Rows<D> r;
      if (has) {
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) r.acc[dn][0] = r.acc[dn][1] = r.acc[dn][2] = r.acc[dn][3] = 0.f;
        r.m[0] = r.m[1] = -INFINITY;
        r.l[0] = r.l[1] = 0.f;
        r.seg[0] = seg[(size_t)pair * S + ra];
        r.seg[1] = seg[(size_t)pair * S + rb];
        // every warp is past the last tile's wgmmas, which read the other buffer
        named_barrier(1 + wg, 128);
        if (leader && pos + C::kWg < positions) load_q(pos + C::kWg, (k + 1) & 1);
        mbar_wait(&my_qfull[k & 1], (k >> 1) & 1);
      }
      for (int kb = 0; kb < nb; ++kb) {
        const int s = n % nst;
        mbar_wait(&full[s], (n / nst) & 1);
        if (has) {
          const StageHead& h = head[s];
          const bool need = (h.need >> mine) & 1u;
          const unsigned char* ks = kv + (size_t)s * 2 * C::kKvBytes;
          if (need) {
            float sc[64];
            qk<D>(sc, qs, ks);
            if (single)
              attend<D, true>(r, sc, h, ks + C::kKvBytes, c2, lane);
            else
              attend<D, false>(r, sc, h, ks + C::kKvBytes, c2, lane);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
        ++n;
      }
      if (has) {
        const int t = lane & 3;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const int col = 8 * dn + 2 * t;
          *reinterpret_cast<uint32_t*>(out + base + (size_t)ra * tok + col) =
              pack_bf16(r.acc[dn][0], r.acc[dn][1]);
          *reinterpret_cast<uint32_t*>(out + base + (size_t)rb * tok + col) =
              pack_bf16(r.acc[dn][2], r.acc[dn][3]);
        }
        if (res_m != nullptr && t == 0)
          store_residuals(res_m, res_l, (size_t)item * S, ra, rb, r.m, r.l, scale);
        pos += C::kWg;
        ++k;
      }
    }
  }
}

// (B, S, H * D) bf16 as a 3-D tensor map with boxes of `cw` values x
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
int launch(const void* q, const void* k, const void* v, const void* seg, void* out, float* res_m,
           float* res_l, int P, int S, int H, float scale, cudaStream_t stream) {
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
  // SMs of each device, 0 until a launch there has raised the kernel's
  // shared-memory limit; host threads may launch at once (the server's
  // batches run in worker threads), and each may do that first step
  static std::atomic<int> sms[64];
  int n_sm = sms[dev & 63].load(std::memory_order_acquire);
  if (n_sm == 0) {
    err = cudaFuncSetAttribute(flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms[dev & 63].store(n_sm, std::memory_order_release);
  }
  const int ctas = P * H < n_sm ? P * H : n_sm;  // one block an SM
  flash_kernel<D><<<ctas, C::kThreads, smem, stream>>>(qmap, kmap, vmap, (const int32_t*)seg,
                                                       (__nv_bfloat16*)out, res_m, res_l, P, S, H,
                                                       scale, nst);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// D 256 (d256::flash256_kernel): flash_kernel<D>'s skeleton with K and V
// staged as 32 KB slots of half a head's columns (see the file's header).

namespace d256 {

constexpr int D = 256;
constexpr int kWg = 2;                      // consumer warpgroups: a unit is 2 row tiles
constexpr int kThreads = 128 * (kWg + 1);   // and a producer warpgroup
constexpr int kProducerRegs = 24;           // registers a thread after setmaxnreg
constexpr int kConsumerRegs = 240;
constexpr int kCw = 64;                     // values in a swizzled row of a column chunk
constexpr int kRowB = 2 * kCw;              // its bytes, the swizzle: 128
constexpr int kHalf = D / 2;                // columns of K or V a slot holds
constexpr int kQChunk = kRows * kRowB;      // 8 KB: a column chunk of a q tile
constexpr int kQBytes = D / kCw * kQChunk;  // 32 KB: a q tile
constexpr int kSlotChunk = kKeys * kRowB;   // 16 KB: a column chunk of a block's 128 keys
constexpr int kSlotBytes = kHalf / kCw * kSlotChunk;  // 32 KB
constexpr int kSlotsABlock = 4;             // K columns 0-127, K 128-255, V 0-127, V 128-255
constexpr int kMaxSlots = 8;
constexpr int kSub = 64;                    // keys of an online-softmax step: half jax's block_k

static_assert(128 * (kProducerRegs + kWg * kConsumerRegs) <=
                  kThreads * (65536 / kThreads / 8 * 8),
              "the register budgets exceed the block's pool");

// 1 KB to align the slots to the swizzle's atoms; the slots; one q tile a
// consumer warpgroup; the heads of two blocks; each slot's full and empty
// barriers and each q tile's (ops/flash_attention.py d256_plan mirrors this)
constexpr size_t smem_bytes(int slots) {
  return 1024 + (size_t)slots * kSlotBytes + kWg * (size_t)kQBytes + 2 * sizeof(StageHead) +
         2 * slots * sizeof(uint64_t) + kWg * sizeof(uint64_t);
}

// as many slots as fit, up to kMaxSlots: 5
constexpr int ring_slots() {
  int n = kMaxSlots;
  while (n > kSlotsABlock && smem_bytes(n) > kSmemLimit) --n;
  return n;
}
static_assert(ring_slots() == 5 && smem_bytes(ring_slots()) == 231552 &&
                  smem_bytes(ring_slots() + 1) > kSmemLimit,
              "five 32 KB slots, two q tiles and the heads fill a block's shared memory");

// s = q K^T over kSub keys from `key0` of the block, waited for; K's
// column halves in slots k0 and k1.  s[4j + 2h + e] is row 16 warp + g +
// 8h, key key0 + 8j + 2t + e.
template <int N>
__device__ __forceinline__ void scores(float (&s)[N], const unsigned char* qs,
                                       const unsigned char* k0, const unsigned char* k1,
                                       int key0) {
  // q's descriptors are the same for every step of a tile, and S 128's
  // second pass repeats its first's K descriptors: left to itself the
  // compiler computes them once and keeps them live between the steps
  uintptr_t qa = reinterpret_cast<uintptr_t>(qs), ka = reinterpret_cast<uintptr_t>(k0),
            kb = reinterpret_cast<uintptr_t>(k1);
  asm volatile("" : "+l"(qa), "+l"(ka), "+l"(kb));
  qs = reinterpret_cast<const unsigned char*>(qa);
  k0 = reinterpret_cast<const unsigned char*>(ka);
  k1 = reinterpret_cast<const unsigned char*>(kb);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / (kCw / 16), o = (kk % (kCw / 16)) * 32;  // column chunk, offset in its row
    const unsigned char* ks = (c < 2 ? k0 : k1) + (c & 1) * kSlotChunk + key0 * kRowB + o;
    wgmma_ss(s, wgmma_desc_sw128(qs + c * kQChunk + o), wgmma_desc_sw128(ks), kk > 0 ? 1u : 0u);
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin(s);
}

// One consumer warp's 16 rows of one tile: the online-softmax state.
struct Rows {
  // the context, unnormalised: acc[4j + 2h + e] is row g + 8h, column 8j + 2t + e
  float acc[D / 2];
  float m[2];        // running max of the unscaled scores
  float l[2];        // this thread's share of the running sum
  int seg[2];        // the rows' segment ids
};

// The segment test of the block's keys key0 .. key0 + kSub - 1: a key of
// another id takes score -inf; none[h] when row h attends no key of a
// block that one id fills.
template <int N>
__device__ __forceinline__ void segment_test(const Rows& r, float (&s)[N], const StageHead& h,
                                             int key0, int lane, bool (&none)[2]) {
  none[0] = none[1] = false;
  if (h.uniform) {
    none[0] = r.seg[0] != h.id;
    none[1] = r.seg[1] != h.id;
    return;
  }
  const int* ids = h.ids + key0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    if (j % 4 == 0) asm volatile("" ::: "memory");  // four ids' loads in flight, not all
    const int2 kid = *reinterpret_cast<const int2*>(ids + 8 * j);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      s[4 * j + 2 * hh] = kid.x == r.seg[hh] ? s[4 * j + 2 * hh] : -INFINITY;
      s[4 * j + 2 * hh + 1] = kid.y == r.seg[hh] ? s[4 * j + 2 * hh + 1] : -INFINITY;
    }
  }
}

// A step's row maxima: m_next = max(m, rowmax) into r.m, alpha = ex2((m -
// m_next) c2) (1 while m_next is -inf), and the factors of the FFMA that
// makes p = ex2(s cr + nm): cr = c2, nm = -m_next c2, or 0 and -inf for a
// row that attends none of the block.
template <int N>
__device__ __forceinline__ void step_max(Rows& r, const float (&s)[N], const bool (&none)[2],
                                         float c2, float (&cr)[2], float (&nm)[2],
                                         float (&alpha)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // four chains a row, not one of N / 2 dependent FMNMX
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = fmaxf(s[4 * u + 2 * hh], s[4 * u + 2 * hh + 1]);
#pragma unroll
    for (int j = 4; j < N / 4; ++j)
      x[j & 3] = fmaxf(x[j & 3], fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
    float mx = quad_max(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])));
    if (none[hh]) mx = -INFINITY;
    const float mn = fmaxf(r.m[hh], mx);
    const bool empty = mn == -INFINITY;  // no key of the row's segment yet
    alpha[hh] = empty ? 1.f : ex2((r.m[hh] - mn) * c2);
    cr[hh] = none[hh] ? 0.f : c2;
    nm[hh] = none[hh] ? -INFINITY : (empty ? 0.f : -mn * c2);
    r.m[hh] = mn;
  }
}

// S 128's first pass over a step: the row maxima and this thread's share
// of the sums, as the online softmax takes them, and no P.
template <int N>
__device__ __forceinline__ void step_stats(Rows& r, const float (&s)[N], const bool (&none)[2],
                                           float c2) {
  float cr[2], nm[2], alpha[2], ls[2] = {0.f, 0.f};
  step_max(r, s, none, c2, cr, nm, alpha);
#pragma unroll
  for (int i = 0; i < N; ++i)
    ls[(i >> 1) & 1] += ex2(fmaf(s[i], cr[(i >> 1) & 1], nm[(i >> 1) & 1]));
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) r.l[hh] = fmaf(r.l[hh], alpha[hh], ls[hh]);
}

// The softmax of a step: p = ex2(s c2 - m c2) rounded to bf16 into P's A
// fragments (a 16-key step each), packed as they are made so the f32
// scores die; alpha rescales the context and this thread's share of l.
// FINAL (S 128's second pass): m and l are the row's over all its keys
// (alpha 1), and P is p / sum(p), rounded, as jax's single step makes it.
template <bool FINAL, int N>
__device__ __forceinline__ void softmax(Rows& r, float (&s)[N], const bool (&none)[2], float c2,
                                        uint32_t (&pa)[N / 8][4], float (&alpha)[2]) {
  float cr[2], nm[2], rl[2] = {1.f, 1.f}, ls[2] = {0.f, 0.f};
  step_max(r, s, none, c2, cr, nm, alpha);
  if constexpr (FINAL) {
    rl[0] = 1.f / quad_sum(r.l[0]);
    rl[1] = 1.f / quad_sum(r.l[1]);
  }
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
#pragma unroll
    for (int i = 8 * kk; i < 8 * kk + 8; ++i) {
      s[i] = ex2(fmaf(s[i], cr[(i >> 1) & 1], nm[(i >> 1) & 1]));
      if constexpr (FINAL)
        s[i] *= rl[(i >> 1) & 1];
      else
        ls[(i >> 1) & 1] += s[i];
    }
    // pa[kk]: row g keys 2t, 2t + 1; row g + 8; row g keys 2t + 8, 2t + 9; row g + 8
#pragma unroll
    for (int f = 0; f < 4; ++f) pa[kk][f] = pack_bf16(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1]);
  }
  if constexpr (!FINAL) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) r.l[hh] = fmaf(r.l[hh], alpha[hh], ls[hh]);
  }
}

// acc = acc alpha + P.V over a step's N / 2 keys from key0: wgmma
// m64n128k16 a 16-key step and column half, P from registers, V MN-major
// in its slots (atoms of 8 keys x 64 columns, 16 KB between column
// chunks).  A warp whose rows' maxima all stayed put (alpha 1) skips the
// rescale: exact, and on the card a tenth of the kernel's time (PERF.md;
// tools/flash_attention_variants.py d256_eager_rescale).
template <int N>
__device__ __forceinline__ void pv(Rows& r, const uint32_t (&pa)[N / 8][4],
                                   const float (&alpha)[2], const unsigned char* v0,
                                   const unsigned char* v1, int key0) {
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) r.acc[i] *= alpha[(i >> 1) & 1];
  }
  float (&lo)[D / 4] = *reinterpret_cast<float (*)[D / 4]>(r.acc);
  float (&hi)[D / 4] = *reinterpret_cast<float (*)[D / 4]>(r.acc + D / 4);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    const int off = (key0 + 16 * kk) * kRowB;
    wgmma_rs_mn(lo, pa[kk], wgmma_desc_mn<kRowB>(v0 + off, kSlotChunk), 1u);
    wgmma_rs_mn(hi, pa[kk], wgmma_desc_mn<kRowB>(v1 + off, kSlotChunk), 1u);
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin(r.acc);
}

// The work: units, each the kWg row tiles 2u, 2u + 1 of one item, in the
// order item 0's units, item 1's, ...; unit w goes to block w % gridDim.x.
// So the units of one item run on neighbouring SMs at the same time and
// share its K and V in L2 (one item's K and V are 512 KB at S 512: an
// item's units run one after another on one SM would keep 132 of them,
// more than the 50 MB L2, in flight).
__device__ __forceinline__ int units_of_block(int items, int units) {
  return (items * units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
}

// the block's k-th unit: its item and its unit in the item
__device__ __forceinline__ void unit_of(int k, int units, int& item, int& u) {
  const int w = blockIdx.x + k * gridDim.x;
  item = w / units;
  u = w - item * units;
}

// The producer warp: for each unit and each 128-key block, the block's
// head (ids, which of the unit's tiles attend it) with its first slot, and
// its four slots by TMA where any tile does.
__device__ __forceinline__ void produce(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        const int32_t* __restrict__ seg, unsigned char* slots,
                                        StageHead* heads, uint64_t* full, uint64_t* empty,
                                        int n_units, int S, int H, int ns, int lane) {
  const int T = S / kRows, nb = S / kKeys, units = T / kWg;
  int n = 0, blk = 0;  // slots filled, blocks staged
  for (int k = 0; k < n_units; ++k) {
    int item, u;
    unit_of(k, units, item, u);
    const int pair = item / H, hd = item - pair * H;
    const int32_t* srow = seg + (size_t)pair * S;
    uint32_t tp[kWg];
    tile_presence<kWg>(srow, u * kWg, T, lane, tp);
    for (int kb = 0; kb < nb; ++kb, ++blk) {
      int x[4], lo, hi;
      const uint32_t need = block_need<kWg>(srow, kb, tp, lane, x, lo, hi);
#pragma unroll 1
      for (int part = 0; part < kSlotsABlock; ++part, ++n) {
        const int s = n % ns;
        mbar_wait(&empty[s], ((n / ns) & 1) ^ 1);  // the first round passes
        if (part == 0) {
          // the head two blocks back is free: this slot's last tenant was
          // that block's or a later one's, released after its readers
          StageHead& h = heads[blk & 1];
#pragma unroll
          for (int u = 0; u < 4; ++u) h.ids[lane + 32 * u] = x[u];
          if (lane == 0) {
            h.need = need;
            h.uniform = lo == hi;
            h.id = lo;
          }
        }
        if (lane == 0 && need) {
          mbar_arrive_expect_tx(&full[s], kSlotBytes);
          const CUtensorMap* map = part < 2 ? kmap : vmap;
#pragma unroll
          for (int c = 0; c < kHalf / kCw; ++c)
            tma_load_3d(slots + (size_t)s * kSlotBytes + c * kSlotChunk, map, &full[s],
                        hd * D + (part & 1) * kHalf + c * kCw, kb * kKeys, pair);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  }
}

// The online softmax in kSub-key steps.  SINGLE: S 128, jax's single step
// over the block's 128 keys in two passes of the same steps, the first for
// each row's max and sum, the second (QK^T again) for P = p / sum(p) and
// P.V: 128 keys of scores beside the context spill.
template <bool SINGLE>
__global__ void __launch_bounds__(kThreads, 1)
flash256_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const int32_t* __restrict__ seg,
                __nv_bfloat16* __restrict__ out, float* __restrict__ res_m,
                float* __restrict__ res_l, int P, int S, int H, float scale, int ns) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* slots = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qtiles = slots + (size_t)ns * kSlotBytes;  // [kWg][kQBytes]
  StageHead* heads = reinterpret_cast<StageHead*>(qtiles + kWg * kQBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(heads + 2);
  uint64_t* empty = full + ns;
  uint64_t* qfull = empty + ns;  // [kWg]

  const int units = S / (kWg * kRows), nb = S / kKeys;
  const int n_units = units_of_block(P * H, units);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(&full[s], 32);         // every producer lane, after its head writes
      mbar_init(&empty[s], 4 * kWg);   // every consumer warp, when done with the slot
    }
    for (int w = 0; w < kWg; ++w) mbar_init(&qfull[w], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * kWg) {  // the producer warpgroup: one warp works
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 4 * kWg)
      produce(&kmap, &vmap, seg, slots, heads, full, empty, n_units, S, H, ns, lane);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // Consumer warpgroup wg takes row tile 2u + wg of each of the block's
  // units, in lockstep with the other through the slots.  Its one
  // q buffer is reloaded by TMA once every warp of it is past the tile's
  // last QK^T, so the load overlaps that block's softmax and P.V.
  const int wg = warp >> 2, wl = warp & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  const unsigned char* qs = qtiles + wg * kQBytes;
  uint64_t* my_qfull = qfull + wg;
  auto load_q = [&](int k) {
    int item, u;
    unit_of(k, units, item, u);
    const int pair = item / H, hd = item - pair * H;
    mbar_arrive_expect_tx(my_qfull, kQBytes);
#pragma unroll
    for (int c = 0; c < D / kCw; ++c)
      tma_load_3d(qtiles + wg * kQBytes + c * kQChunk, &qmap, my_qfull, hd * D + c * kCw,
                  (u * kWg + wg) * kRows, pair);
  };
  const size_t tok = (size_t)H * D;  // stride of one token
  const float c2 = scale * kLog2e;
  if (leader && n_units > 0) load_q(0);
  int n = 0, blk = 0;  // slots passed, blocks passed
  for (int pos = 0; pos < n_units; ++pos) {
    int item, u;
    unit_of(pos, units, item, u);
    const int pair = item / H;
    const size_t base = (size_t)pair * S * tok + (size_t)(item - pair * H) * D;
    const int ra = (u * kWg + wg) * kRows + 16 * wl + (lane >> 2), rb = ra + 8;
    Rows r;
    r.m[0] = r.m[1] = -INFINITY;
    r.l[0] = r.l[1] = 0.f;
    r.seg[0] = seg[(size_t)pair * S + ra];
    r.seg[1] = seg[(size_t)pair * S + rb];
    mbar_wait(my_qfull, pos & 1);
    if constexpr (!SINGLE) {
#pragma unroll
      for (int e = 0; e < D / 2; ++e) r.acc[e] = 0.f;
    }
    for (int kb = 0; kb < nb; ++kb, ++blk, n += kSlotsABlock) {
      const int sk0 = n % ns, sk1 = (n + 1) % ns, sv0 = (n + 2) % ns, sv1 = (n + 3) % ns;
      mbar_wait(&full[sk0], (n / ns) & 1);
      mbar_wait(&full[sk1], ((n + 1) / ns) & 1);
      const StageHead& h = heads[blk & 1];
      const bool need = (h.need >> wg) & 1u;
      const unsigned char* k0 = slots + (size_t)sk0 * kSlotBytes;
      const unsigned char* k1 = slots + (size_t)sk1 * kSlotBytes;
      const unsigned char* v0 = slots + (size_t)sv0 * kSlotBytes;
      const unsigned char* v1 = slots + (size_t)sv1 * kSlotBytes;
      if constexpr (SINGLE) {  // the first pass: each row's max and sum
#pragma unroll
        for (int key0 = 0; key0 < kKeys; key0 += kSub) {
          float sc[kSub / 2];
          bool none[2];
          if (need) {
            scores(sc, qs, k0, k1, key0);
            segment_test(r, sc, h, key0, lane, none);
            step_stats(r, sc, none, c2);
          }
        }
        // the zero context, made here: made at the tile's start, its
        // registers sat beside the first pass's and spilled
#pragma unroll
        for (int e = 0; e < D / 2; ++e) r.acc[e] = 0.f;
      }
#pragma unroll
      for (int key0 = 0; key0 < kKeys; key0 += kSub) {
        float sc[kSub / 2];
        bool none[2];
        if (need) {
          scores(sc, qs, k0, k1, key0);
          segment_test(r, sc, h, key0, lane, none);
        }
        if (key0 + kSub == kKeys) {  // done with K: its slots go back to the producer
          __syncwarp();
          if (lane == 0) {
            mbar_arrive(&empty[sk0]);
            mbar_arrive(&empty[sk1]);
          }
          if (kb == nb - 1) {  // and with q: every warp is past its last wgmma
            named_barrier(1 + wg, 128);
            if (leader && pos + 1 < n_units) load_q(pos + 1);
          }
        }
        uint32_t pa[kSub / 16][4];
        float alpha[2];
        if (need) softmax<SINGLE>(r, sc, none, c2, pa, alpha);
        if (key0 == 0) {
          mbar_wait(&full[sv0], ((n + 2) / ns) & 1);
          mbar_wait(&full[sv1], ((n + 3) / ns) & 1);
        }
        if (need) pv<kSub / 2>(r, pa, alpha, v0, v1, key0);
      }
      __syncwarp();
      if (lane == 0) {  // done with V
        mbar_arrive(&empty[sv0]);
        mbar_arrive(&empty[sv1]);
      }
    }
    // the context over the row's sum (P holds p / sum(p) at S 128)
    float inv[2], l[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] = quad_sum(r.l[hh]);
      inv[hh] = SINGLE || l[hh] == 0.f ? 1.f : 1.f / l[hh];
    }
    const int t = lane & 3;
    if (res_m != nullptr && t == 0)
      store_residuals(res_m, res_l, (size_t)item * S, ra, rb, r.m, l, scale);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(out + base + (size_t)ra * tok + col) =
          pack_bf16(r.acc[4 * j] * inv[0], r.acc[4 * j + 1] * inv[0]);
      *reinterpret_cast<uint32_t*>(out + base + (size_t)rb * tok + col) =
          pack_bf16(r.acc[4 * j + 2] * inv[1], r.acc[4 * j + 3] * inv[1]);
    }
  }
}

template <bool SINGLE>
int launch(const void* q, const void* k, const void* v, const void* seg, void* out, float* res_m,
           float* res_l, int P, int S, int H, float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!tile_map(&qmap, q, P, S, H, D, kCw, kRows) || !tile_map(&kmap, k, P, S, H, D, kCw, kKeys) ||
      !tile_map(&vmap, v, P, S, H, D, kCw, kKeys))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  constexpr int ns = ring_slots();
  constexpr size_t smem = smem_bytes(ns);
  // as launch<D>'s: SMs of each device, 0 until a launch there has raised
  // this instantiation's shared-memory limit
  static std::atomic<int> sms[64];
  int n_sm = sms[dev & 63].load(std::memory_order_acquire);
  if (n_sm == 0) {
    err = cudaFuncSetAttribute(flash256_kernel<SINGLE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms[dev & 63].store(n_sm, std::memory_order_release);
  }
  const int work = P * H * (S / (kWg * kRows));  // units
  const int ctas = work < n_sm ? work : n_sm;       // one block an SM
  flash256_kernel<SINGLE><<<ctas, kThreads, smem, stream>>>(
      qmap, kmap, vmap, (const int32_t*)seg, (__nv_bfloat16*)out, res_m, res_l, P, S, H, scale,
      ns);
  return (int)cudaGetLastError();
}

}  // namespace d256

// ---------------------------------------------------------------------------
// Heads of 384 and every wider multiple of 128 (slab::slab_kernel<G, SINGLE>):
// one QK^T and one softmax a (row tile, key block), the context held across
// two consumer warpgroups, K and V multicast to a cluster of two blocks
// (see the file's header).

namespace slab {

// blocks of a cluster: row tiles sharing each K and V slot.  Four ran
// slower on the H100 (where an item's tiles come in fours), and one (no
// multicast) slower still (PERF.md; tools/flash_attention_variants.py
// slab_cluster_1, slab_cluster_4)
constexpr int kCluster = 2;
constexpr int kWg = 2;                    // consumer warpgroups
constexpr int kThreads = 128 * (kWg + 1);  // and a producer warpgroup
// registers a thread after setmaxnreg: the producer's loop state spilled at 24
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr int kHalf = kKeys / kWg;        // 64: a consumer warpgroup's keys of a block
constexpr int kQChunk = kRows * 128;      // 8 KB: 64 rows x 64 columns of q or P, 128-byte swizzle
constexpr int kKChunk = kKeys * 128;      // 16 KB: 128 keys x 64 columns of K or V
constexpr int kSlotBytes = 2 * kKChunk;   // 32 KB: a slot, 128 keys x 128 columns
constexpr int kPBytes = 2 * kQChunk;      // 16 KB: P, 64 rows x 128 keys
constexpr int kMaxSlots = 8;
constexpr int kMaxGroup = 4;              // 128-column slabs of a column group: G 32 f32 a thread
constexpr int kShare = kKeys / kCluster;  // keys of a slot each block loads for the cluster
static_assert(128 * (kProducerRegs + kWg * kConsumerRegs) <=
                  kThreads * (65536 / kThreads / 8 * 8),
              "the register budgets exceed the block's pool");

// 1 KB to align; q's tile when it stays resident; P; the slots; the heads
// of two blocks; the two warpgroups' row maxima and row sums; each slot's
// full and empty barriers and q's (ops/flash_attention.py slab_plan
// mirrors this)
__host__ __device__ constexpr size_t smem_bytes(int d, bool qres, int slots) {
  return 1024 + (qres ? (size_t)kRows * d * 2 : 0) + kPBytes + (size_t)slots * kSlotBytes +
         2 * sizeof(StageHead) + 2 * kWg * kRows * sizeof(float) +
         (2 * (size_t)slots + 1) * sizeof(uint64_t);
}

// q stays resident, loaded once a tile, while it leaves two slots (heads
// up to 1,024); wider heads stage q's 128-column pieces beside K's
__host__ __device__ constexpr bool q_resident(int d) { return smem_bytes(d, true, 2) <= kSmemLimit; }

// as many slots as fit, up to kMaxSlots.  A block's head is written with
// its first slot into one of two, so a slot's last tenant must be of the
// block before or the last slot of the block two back: at most a block's
// slots plus one, which every width keeps (a block takes D / 128 + G >= 5)
__host__ __device__ constexpr int ring_slots(int d) {
  int n = kMaxSlots;
  while (n > 2 && smem_bytes(d, q_resident(d), n) > kSmemLimit) --n;
  return n;
}
static_assert(ring_slots(384) == 4 && ring_slots(512) == 4 && ring_slots(640) == 3 &&
                  q_resident(1024) && ring_slots(1024) == 2 && !q_resident(1152) &&
                  ring_slots(1152) == 6,
              "the rings ops/flash_attention.py slab_plan expects");

// The work: units (item, group u of kCluster row tiles, column group g),
// item-major; unit w goes to cluster w % clusters, so an item's units run
// on neighbouring SMs at once and share its K and V in L2.  Block `rank`
// of the cluster takes row tile kCluster u + rank.
__device__ __forceinline__ void unit_of(int w, int tgroups, int ng, int& item, int& u, int& g) {
  item = w / (tgroups * ng);
  const int r = w - item * tgroups * ng;
  u = r / ng;
  g = r - u * ng;
}

template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>());
    static_for<I + 1, N>(f);
  }
}

// The producer warp: for each unit and 128-key block, the block's head
// (ids, which of the cluster's tiles attend it) with its first slot; then
// K's 128-column pieces (each followed by q's piece of this block's tile
// when q is not resident) and V's slabs of the unit's column group.  Where
// any tile of the cluster attends the block, each block loads its kShare
// keys of every K and V slot for the whole cluster (TMA multicast), so a
// slot is read from L2 once for kCluster row tiles; each block's full
// barrier expects the whole slot.
template <int G>
__device__ __forceinline__ void produce(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, const int32_t* __restrict__ seg,
                                        unsigned char* slots, StageHead* heads, uint64_t* full,
                                        uint64_t* empty, int n_units, int ns, int S, int H, int D,
                                        int ng, int slab0, bool qres, uint32_t rank, int cid,
                                        int ncl, int lane) {
  const int T = S / kRows, nb = S / kKeys, tg = T / kCluster, np = D / 128;
  const int parts = (qres ? np : 2 * np) + G;  // slots a block
  const uint16_t cluster = (1u << kCluster) - 1;
  int s = 0, blk = 0;  // the next slot, blocks staged
  uint32_t ph = 0;     // its round's parity
  for (int k = 0; k < n_units; ++k) {
    int item, u, g;
    unit_of(cid + k * ncl, tg, ng, item, u, g);
    const int pair = item / H, hd = item - pair * H;
    const int32_t* srow = seg + (size_t)pair * S;
    uint32_t tp[kCluster];
    tile_presence<kCluster>(srow, u * kCluster, T, lane, tp);
    for (int kb = 0; kb < nb; ++kb, ++blk) {
      int x[4], lo, hi;
      const uint32_t need = block_need<kCluster>(srow, kb, tp, lane, x, lo, hi);
#pragma unroll 1
      for (int part = 0; part < parts; ++part) {
        mbar_wait(&empty[s], ph ^ 1);  // the first round passes
        if (part == 0) {  // the head two blocks back is free: see ring_slots
          StageHead& h = heads[blk & 1];
#pragma unroll
          for (int v = 0; v < 4; ++v) h.ids[lane + 32 * v] = x[v];
          if (lane == 0) {
            h.need = need;
            h.uniform = lo == hi;
            h.id = lo;
          }
        }
        if (lane == 0 && need) {
          unsigned char* dst = slots + (size_t)s * kSlotBytes;
          const int piece = qres ? part : part >> 1;
          if (!qres && part < 2 * np && (part & 1)) {  // q's piece of this block's tile
            mbar_arrive_expect_tx(&full[s], 2 * kQChunk);
#pragma unroll
            for (int c = 0; c < 2; ++c)
              tma_load_3d(dst + c * kQChunk, qmap, &full[s], hd * D + piece * 128 + 64 * c,
                          (u * kCluster + rank) * kRows, pair);
          } else {  // K's piece or V's slab: this block's keys of it, for the cluster
            const bool v = part >= parts - G;
            const int col = hd * D + (v ? slab0 + g * G + part - (parts - G) : piece) * 128;
            mbar_arrive_expect_tx(&full[s], kSlotBytes);
#pragma unroll
            for (int c = 0; c < 2; ++c)
              tma_load_3d_multicast(dst + c * kKChunk + rank * kShare * 128, v ? vmap : kmap,
                                    &full[s], col + 64 * c, kb * kKeys + rank * kShare, pair,
                                    cluster);
          }
        } else {
          mbar_arrive(&full[s]);
        }
        if (++s == ns) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  }
}

// A warpgroup's share of P.V over one slab of the column group: its
// 64-column chunk of the slab (chunk wg, kKChunk bytes in), one wgmma
// m64n64k16 a 16-key step into the chunk's 32 accumulators, V MN-major,
// P's A fragments from registers: its own 64 keys' first, then the other
// warpgroup's, read back from shared memory (a little faster than P from
// shared memory by descriptor: tools/flash_attention_variants.py
// slab_pv_from_smem)
__device__ __forceinline__ void pv_chunk(float (&acc)[32], const uint32_t (&own)[kHalf / 16][4],
                                         const uint32_t (&other)[kHalf / 16][4],
                                         const unsigned char* vc, int wg) {
  const unsigned char* vo = vc + wg * kHalf * 128;        // the own keys' rows of V
  const unsigned char* vt = vc + (1 - wg) * kHalf * 128;  // the other warpgroup's
#pragma unroll
  for (int kk = 0; kk < kHalf / 16; ++kk)
    wgmma_rs_mn(acc, own[kk], wgmma_desc_mn<128>(vo + kk * 16 * 128, kKChunk), 1u);
#pragma unroll
  for (int kk = 0; kk < kHalf / 16; ++kk)
    wgmma_rs_mn(acc, other[kk], wgmma_desc_mn<128>(vt + kk * 16 * 128, kKChunk), 1u);
}

// G: 128-column slabs of a column group (2-4); the launch computes ng
// groups from slab `slab0`.  SINGLE: S 128, jax's single step.
template <int G, bool SINGLE>
__global__ void __launch_bounds__(kThreads, 1)
slab_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const int32_t* __restrict__ seg,
            __nv_bfloat16* __restrict__ out, float* __restrict__ res_m,
            float* __restrict__ res_l, int P, int S, int H, int D, float scale, int ng,
            int slab0, int ns) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qtile = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const bool qres = q_resident(D);
  unsigned char* pbuf = qtile + (qres ? (size_t)kRows * D * 2 : 0);  // [2][kQChunk]
  unsigned char* slots = pbuf + kPBytes;
  StageHead* heads = reinterpret_cast<StageHead*>(slots + (size_t)ns * kSlotBytes);
  float* redm = reinterpret_cast<float*>(heads + 2);  // [kWg][kRows]: row maxima of a block
  float* redl = redm + kWg * kRows;                   // [kWg][kRows]: row sums
  uint64_t* full = reinterpret_cast<uint64_t*>(redl + kWg * kRows);
  uint64_t* empty = full + ns;
  uint64_t* qfull = empty + ns;

  const uint32_t rank = cluster_rank();
  const int cid = (int)cluster_id(), ncl = (int)cluster_count();
  const int T = S / kRows, nb = S / kKeys, tg = T / kCluster, np = D / 128;
  const int n_units = (P * H * tg * ng - cid + ncl - 1) / ncl;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(&full[s], 32);                    // every producer lane, after its head writes
      mbar_init(&empty[s], 4 * kWg * kCluster);   // every consumer warp of the cluster
    }
    mbar_init(qfull, 1);
    mbar_init_fence();
  }
  cluster_sync();  // every block's barriers are set before any other signals them

  if (warp >= 4 * kWg) {  // the producer warpgroup: one warp works
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 4 * kWg)
      produce<G>(&qmap, &kmap, &vmap, seg, slots, heads, full, empty, n_units, ns, S, H, D, ng,
                 slab0, qres, rank, cid, ncl, lane);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    // Consumer warpgroup wg: keys 64 wg .. 64 wg + 63 of every block for
    // QK^T and the softmax, 64-column chunk wg of each of the column
    // group's slabs for P.V (the same instructions in both warpgroups); the row maxima (and at S 128 the row sums)
    // exchanged through shared memory, P written there for both.
    const int wg = warp >> 2, wl = warp & 3, t = lane & 3;
    const int row_a = 16 * wl + (lane >> 2);  // the thread's rows of the tile: row_a, row_a + 8
    const float c2 = scale * kLog2e;
    auto load_q = [&](int k) {  // unit k's resident q tile
      int item, u, g;
      unit_of(cid + k * ncl, tg, ng, item, u, g);
      const int pair = item / H, hd = item - pair * H;
      mbar_arrive_expect_tx(qfull, kRows * D * 2);
      for (int c = 0; c < D / 64; ++c)
        tma_load_3d(qtile + c * kQChunk, &qmap, qfull, hd * D + 64 * c,
                    (u * kCluster + rank) * kRows, pair);
    };
    auto release = [&](int slot) {  // this warp is done with a slot: tell every block's producer
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kCluster; ++r) mbar_arrive_remote_if(&empty[slot], r, lane == 0);
    };
    int s = 0, blk = 0;  // the next slot, blocks passed
    uint32_t ph = 0;     // its round's parity
    auto take = [&]() {  // the next slot, waited for
      const int sl = s;
      mbar_wait(&full[sl], ph);
      if (++s == ns) {
        s = 0;
        ph ^= 1;
      }
      return sl;
    };
    if (qres && threadIdx.x == 0 && n_units > 0) load_q(0);
    for (int k = 0; k < n_units; ++k) {
      int item, u, g;
      unit_of(cid + k * ncl, tg, ng, item, u, g);
      const int pair = item / H;
      const int ra = (u * kCluster + (int)rank) * kRows + row_a;
      const int seg_r[2] = {seg[(size_t)pair * S + ra], seg[(size_t)pair * S + ra + 8]};
      float acc[32 * G];  // the context, unnormalised: slab c's chunk at acc[32 c ..], wgmma's layout
#pragma unroll
      for (int i = 0; i < 32 * G; ++i) acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};  // running max of the unscaled scores
      float l[2] = {0.f, 0.f};  // this thread's share of the running sum (S 128: the row's)
      if (qres) mbar_wait(qfull, k & 1);
      int pending_v = -1;  // the slot of a P.V still in flight from the block before
      for (int kb = 0; kb < nb; ++kb, ++blk) {
        mbar_wait(&full[s], ph);  // the block's head came with its first slot
        const StageHead& h = heads[blk & 1];
        const bool need = warp_uniform((h.need >> rank) & 1u);
        // QK^T of the warpgroup's 64 keys, a 128-column piece of the head
        // a slot; a piece's slots go back once its products are done
        float sc[32];
        int prev_k = 0, prev_q = 0;
        for (int c = 0; c < np; ++c) {
          const int sk = take();
          const int sq = qres ? 0 : take();
          const unsigned char* qs = qres ? qtile + 2 * c * kQChunk : slots + (size_t)sq * kSlotBytes;
          if (need) {
            wgmma_fence();
            const unsigned char* ks = slots + (size_t)sk * kSlotBytes + wg * kHalf * 128;
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_ss(sc, wgmma_desc_sw128(qs + cc * kQChunk + 32 * kk),
                         wgmma_desc_sw128(ks + cc * kKChunk + 32 * kk),
                         (c | cc | kk) != 0 ? 1u : 0u);
            }
          }
          wgmma_commit();
          wgmma_wait<1>();
          if (c > 0) {
            release(prev_k);
            if (!qres) release(prev_q);
          } else if (pending_v >= 0) {  // the last block's P.V is done
            release(pending_v);
            pending_v = -1;
          }
          prev_k = sk;
          prev_q = sq;
        }
        wgmma_wait<0>();
        wgmma_pin(sc);
        wgmma_pin(acc);
        release(prev_k);
        if (!qres) release(prev_q);
        if (kb == nb - 1) {  // both warpgroups are past the unit's last QK^T
          named_barrier(2, 2 * 128);
          if (qres && threadIdx.x == 0 && k + 1 < n_units) load_q(k + 1);
        }
        float alpha[2] = {1.f, 1.f};
        uint32_t own[kHalf / 16][4], other[kHalf / 16][4];  // P's A fragments, 64 keys each
        if (need) {
          // the segment test: a key of another id takes score -inf; none[h]
          // when row h attends no key of a block that one id fills
          bool none[2] = {false, false};
          if (warp_uniform(h.uniform)) {
            none[0] = seg_r[0] != h.id;
            none[1] = seg_r[1] != h.id;
          } else {
            const int* ids = h.ids + kHalf * wg + 2 * t;
#pragma unroll
            for (int j = 0; j < kHalf / 8; ++j) {
              const int2 kid = *reinterpret_cast<const int2*>(ids + 8 * j);
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                sc[4 * j + 2 * hh] = kid.x == seg_r[hh] ? sc[4 * j + 2 * hh] : -INFINITY;
                sc[4 * j + 2 * hh + 1] = kid.y == seg_r[hh] ? sc[4 * j + 2 * hh + 1] : -INFINITY;
              }
            }
          }
          // the block's row maxima: this warpgroup's 64 keys, then both
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float x[4];
#pragma unroll
            for (int v = 0; v < 4; ++v) x[v] = fmaxf(sc[4 * v + 2 * hh], sc[4 * v + 2 * hh + 1]);
#pragma unroll
            for (int j = 4; j < kHalf / 8; ++j)
              x[j & 3] = fmaxf(x[j & 3], fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
            const float mx = quad_max(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])));
            if (t == 0) redm[wg * kRows + row_a + 8 * hh] = none[hh] ? -INFINITY : mx;
          }
          named_barrier(1, 2 * 128);
          float cr[2], nm[2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = row_a + 8 * hh;
            const float mn = fmaxf(m[hh], fmaxf(redm[row], redm[kRows + row]));
            const bool empty_row = mn == -INFINITY;  // no key of the row's segment yet
            alpha[hh] = empty_row ? 1.f : ex2((m[hh] - mn) * c2);
            // p = ex2(s c2 - mn c2); 0 for every key of a row that attends none
            cr[hh] = none[hh] ? 0.f : c2;
            nm[hh] = none[hh] ? -INFINITY : (empty_row ? 0.f : -mn * c2);
            m[hh] = mn;
          }
          float ls[2] = {0.f, 0.f};
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            sc[i] = ex2(fmaf(sc[i], cr[(i >> 1) & 1], nm[(i >> 1) & 1]));
            ls[(i >> 1) & 1] += sc[i];
          }
          if constexpr (SINGLE) {  // p / sum(p) over both halves, as jax's single step
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float q4 = quad_sum(ls[hh]);
              if (t == 0) redl[wg * kRows + row_a + 8 * hh] = q4;
            }
            named_barrier(1, 2 * 128);
            float rl[2];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = row_a + 8 * hh;
              l[hh] = redl[row] + redl[kRows + row];
              rl[hh] = 1.f / l[hh];
            }
#pragma unroll
            for (int i = 0; i < 32; ++i) sc[i] *= rl[(i >> 1) & 1];
          } else {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) l[hh] = fmaf(l[hh], alpha[hh], ls[hh]);
          }
          // P rounded to bf16: the warpgroup's own 64 keys as A fragments
          // (own[kk]: row g keys 2t, 2t + 1; row g + 8; row g keys 2t + 8,
          // 2t + 9; row g + 8), and into its 64-key chunk of shared memory
          // for the other warpgroup: row r at 128 r, its 16-byte granule j
          // at j ^ (r & 7) (128-byte swizzle)
          unsigned char* pc = pbuf + wg * kQChunk;
#pragma unroll
          for (int kk = 0; kk < kHalf / 16; ++kk) {
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              own[kk][f] = pack_bf16(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1]);
              const int row = row_a + 8 * (f & 1), j = 2 * kk + (f >> 1);
              *reinterpret_cast<uint32_t*>(pc + row * 128 + ((j ^ (row & 7)) << 4) + 4 * t) =
                  own[kk][f];
            }
          }
          named_barrier(1, 2 * 128);  // both halves of P are in
          // the other warpgroup's 64 keys of P, as A fragments (ldmatrix:
          // lane l gives row (l & 7) + 8 ((l >> 3) & 1) of the warp's 16,
          // 16-byte granule 2 kk + (l >> 4))
          {
            const unsigned char* po = pbuf + (1 - wg) * kQChunk;
            const int row = 16 * wl + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
            for (int kk = 0; kk < kHalf / 16; ++kk)
              ldsm_x4(other[kk], po + row * 128 + (((2 * kk + (lane >> 4)) ^ (row & 7)) << 4));
          }
          if constexpr (!SINGLE) {
            // a warp whose rows' maxima all stayed put (alpha 1) skips it: exact
            if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
              for (int i = 0; i < 32 * G; ++i) acc[i] *= alpha[(i >> 1) & 1];
            }
          }
        }
        // P.V over the column group's V slabs, a slab a slot: this
        // warpgroup's 64-column chunk wg of each
        int prev_v = 0;
        static_for<0, G>([&](auto ic) {
          constexpr int i = decltype(ic)::value;
          const int sv = take();
          if (need) {
            wgmma_fence();
            pv_chunk(*reinterpret_cast<float(*)[32]>(acc + 32 * i), own, other,
                     slots + (size_t)sv * kSlotBytes + wg * kKChunk, wg);
          }
          wgmma_commit();
          wgmma_wait<1>();
          if (i > 0) release(prev_v);
          prev_v = sv;
        });
        // the block's last P.V stays in flight into the next block's QK^T
        // (a little faster than waiting here: slab_pv_waited)
        pending_v = prev_v;
      }
      if (pending_v >= 0) {  // the unit's last P.V
        wgmma_wait<0>();
        wgmma_pin(acc);
        release(pending_v);
      }
      // the row sums: both warpgroups' shares (S 128: the row's already)
      float inv[2] = {1.f, 1.f};
      if constexpr (!SINGLE) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float q4 = quad_sum(l[hh]);
          if (t == 0) redl[wg * kRows + row_a + 8 * hh] = q4;
        }
        named_barrier(1, 2 * 128);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row_a + 8 * hh;
          l[hh] = redl[row] + redl[kRows + row];
          inv[hh] = l[hh] == 0.f ? 1.f : 1.f / l[hh];
        }
      }
      const size_t tok = (size_t)H * D;  // stride of one token
      const size_t base = (size_t)pair * S * tok + (size_t)(item - pair * H) * D +
                          (size_t)(slab0 + g * G) * 128 + wg * 64;
#pragma unroll
      for (int c = 0; c < G; ++c) {  // chunk c: the group's columns 128 c + 64 wg ..
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 128 * c + 8 * j + 2 * t;
          const float* a = acc + 32 * c + 4 * j;
          *reinterpret_cast<uint32_t*>(out + base + (size_t)ra * tok + col) =
              pack_bf16(a[0] * inv[0], a[1] * inv[0]);
          *reinterpret_cast<uint32_t*>(out + base + (size_t)(ra + 8) * tok + col) =
              pack_bf16(a[2] * inv[1], a[3] * inv[1]);
        }
      }
      // m and l, from the one softmax: the first column group writes them
      if (res_m != nullptr && g == 0 && wg == 0 && t == 0)
        store_residuals(res_m, res_l, (size_t)item * S, ra, ra + 8, m, l, scale);
    }
  }
  cluster_sync();  // no block leaves while another may still signal its barriers
}

// The clusters of an instantiation that the device holds at once, found
// once per device with the kernel's shared memory raised to the limit (0
// in `fit`: not yet); host threads may launch at once, and each may take
// that first step.
template <int G, bool SINGLE>
cudaError_t clusters_held(int* clusters) {
  static std::atomic<int> fit[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int c = fit[dev & 63].load(std::memory_order_acquire);
  if (c == 0) {
    err = cudaFuncSetAttribute(slab_kernel<G, SINGLE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemLimit);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t config = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.gridDim = dim3(kCluster);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = kSmemLimit;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&c, slab_kernel<G, SINGLE>, &config);
    if (err != cudaSuccess) return err;
    if (c < 1) return cudaErrorInvalidConfiguration;
    fit[dev & 63].store(c, std::memory_order_release);
  }
  *clusters = c;
  return cudaSuccess;
}

// ng column groups of G slabs from slab `slab0`, at most as many clusters
// as the device holds at once
template <int G, bool SINGLE>
int launch_groups(const CUtensorMap& qmap, const CUtensorMap& kmap, const CUtensorMap& vmap,
                  const void* seg, void* out, float* res_m, float* res_l, int P, int S, int H,
                  int D, float scale, int ng, int slab0, cudaStream_t stream) {
  int clusters = 0;
  cudaError_t err = clusters_held<G, SINGLE>(&clusters);
  if (err != cudaSuccess) return (int)err;
  const long long units = (long long)P * H * (S / kRows / kCluster) * ng;
  if (units > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int ncl = units < clusters ? (int)units : clusters;
  const int ns = ring_slots(D);
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.gridDim = dim3(ncl * kCluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem_bytes(D, q_resident(D), ns);
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, slab_kernel<G, SINGLE>, qmap, kmap, vmap,
                           (const int32_t*)seg, (__nv_bfloat16*)out, res_m, res_l, P, S, H, D,
                           scale, ng, slab0, ns);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool SINGLE>
int launch_size(int G, const CUtensorMap& qmap, const CUtensorMap& kmap, const CUtensorMap& vmap,
                const void* seg, void* out, float* res_m, float* res_l, int P, int S, int H, int D,
                float scale, int ng, int slab0, cudaStream_t stream) {
  switch (G) {
    case 2:
      return launch_groups<2, SINGLE>(qmap, kmap, vmap, seg, out, res_m, res_l, P, S, H, D, scale,
                                       ng, slab0, stream);
    case 3:
      return launch_groups<3, SINGLE>(qmap, kmap, vmap, seg, out, res_m, res_l, P, S, H, D, scale,
                                       ng, slab0, stream);
    case 4:
      return launch_groups<4, SINGLE>(qmap, kmap, vmap, seg, out, res_m, res_l, P, S, H, D, scale,
                                       ng, slab0, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The head's D / 128 slabs in column groups of at most kMaxGroup, as even
// as they come (sizes 2-4: 3, 4, 3 + 2, 3 + 3, 4 + 3, ...); one launch a
// size, the first (from slab 0) writing m and l
int launch(const void* q, const void* k, const void* v, const void* seg, void* out, float* res_m,
           float* res_l, int P, int S, int H, int D, float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!tile_map(&qmap, q, P, S, H, D, 64, kRows) || !tile_map(&kmap, k, P, S, H, D, 64, kShare) ||
      !tile_map(&vmap, v, P, S, H, D, 64, kShare))
    return (int)cudaErrorInvalidValue;
  const int np = D / 128, ng = (np + kMaxGroup - 1) / kMaxGroup;
  const int base = np / ng, extra = np % ng;  // extra groups of base + 1 slabs, then of base
  const bool single = S == kKeys;
  int err = 0;
  if (extra > 0)
    err = single ? launch_size<true>(base + 1, qmap, kmap, vmap, seg, out, res_m, res_l, P, S, H,
                                     D, scale, extra, 0, stream)
                 : launch_size<false>(base + 1, qmap, kmap, vmap, seg, out, res_m, res_l, P, S,
                                      H, D, scale, extra, 0, stream);
  if (err == 0 && ng > extra) {
    float* rm = extra > 0 ? nullptr : res_m;
    float* rl = extra > 0 ? nullptr : res_l;
    err = single ? launch_size<true>(base, qmap, kmap, vmap, seg, out, rm, rl, P, S, H, D, scale,
                                     ng - extra, extra * (base + 1), stream)
                 : launch_size<false>(base, qmap, kmap, vmap, seg, out, rm, rl, P, S, H, D, scale,
                                      ng - extra, extra * (base + 1), stream);
  }
  return err;
}

}  // namespace slab

// ---------------------------------------------------------------------------
// Heads of 32 above S 512 (longrow::long_kernel): flash_kernel<32>'s ring
// and layout, two consumer warpgroups of two row tiles each; a warpgroup
// waits for both tiles' QK^T of a block, then runs their softmaxes and
// P.V (mma.sync) interleaved step by step.  No QK^T or P.V is in flight
// across a softmax, and the warpgroups do not take turns: FA3's pipeline
// is a variant that was timed against it (see the file's header).

namespace longrow {

constexpr int D = 32;
using C = Cfg<D>;                    // flash_kernel<32>'s stages: 32-column rows, 64-byte swizzle
constexpr int kWg = 2;               // consumer warpgroups
constexpr int kTiles = 2;            // row tiles of a unit a consumer warpgroup takes
constexpr int kUnit = kWg * kTiles;  // warpgroup wg takes tiles t0 + wg (its A) and t0 + 2 + wg (B)
constexpr int kThreads = 128 * (kWg + 1);  // and a producer warpgroup
constexpr int kProducerRegs = 24;          // registers a thread after setmaxnreg
constexpr int kConsumerRegs = 240;
static_assert(128 * (kProducerRegs + kWg * kConsumerRegs) <=
                  kThreads * (65536 / kThreads / 8 * 8),
              "the register budgets exceed the block's pool");

// 1 KB to align the stages to the swizzle's atoms; per stage K, V, its
// head and its full and empty barriers; a consumer warpgroup's q tiles,
// two buffers of kTiles, and a barrier a buffer (ops/flash_attention.py
// long_plan mirrors this)
constexpr size_t smem_bytes(int stages) {
  return 1024 + stages * (2 * (size_t)C::kKvBytes + sizeof(StageHead) + 2 * sizeof(uint64_t)) +
         kWg * 2 * (kTiles * (size_t)C::kQBytes + sizeof(uint64_t));
}

constexpr int ring_stages() {
  int n = kMaxStages;
  while (n > 2 && smem_bytes(n) > kSmemLimit) --n;
  return n;
}
constexpr int kStages = ring_stages();
static_assert(kStages == 8 && smem_bytes(kStages) == 169248,
              "eight 16 KB stages and eight q tiles");

// The producer warp: flash_kernel's, with units of kUnit row tiles
__device__ __forceinline__ void produce(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        const int32_t* __restrict__ seg, unsigned char* kv,
                                        StageHead* head, uint64_t* full, uint64_t* empty,
                                        int n_items, int S, int H, int lane) {
  const int T = S / kRows, nb = S / kKeys;
  int n = 0;  // stages filled
  for (int i = 0; i < n_items; ++i) {
    const int item = blockIdx.x + i * gridDim.x;
    const int pair = item / H, hd = item - pair * H;
    const int32_t* srow = seg + (size_t)pair * S;
    for (int t0 = 0; t0 < T; t0 += kUnit) {
      uint32_t tp[kUnit];
      tile_presence<kUnit>(srow, t0, T, lane, tp);
      for (int kb = 0; kb < nb; ++kb, ++n) {
        int x[4], lo, hi;
        const uint32_t need = block_need<kUnit>(srow, kb, tp, lane, x, lo, hi);
        const int s = n % kStages;
        mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);  // the first round passes
        StageHead& h = head[s];
#pragma unroll
        for (int u = 0; u < 4; ++u) h.ids[lane + 32 * u] = x[u];
        if (lane == 0) {
          h.need = need;
          h.uniform = lo == hi;
          h.id = lo;
        }
        if (lane == 0 && need) {
          mbar_arrive_expect_tx(&full[s], 2 * C::kKvBytes);
          unsigned char* ks = kv + (size_t)s * 2 * C::kKvBytes;
          tma_load_3d(ks, kmap, &full[s], hd * D, kb * kKeys, pair);
          tma_load_3d(ks + C::kKvBytes, vmap, &full[s], hd * D, kb * kKeys, pair);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  }
}

// s = q K^T of one block (64 rows x 128 keys, f32), issued and not waited
// for: two wgmma m64n128k16 steps, both operands K-major
__device__ __forceinline__ void qk_issue(float (&s)[64], const unsigned char* qs,
                                         const unsigned char* ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(s, wgmma_desc_sw64(qs + 32 * kk), wgmma_desc_sw64(ks + 32 * kk), kk > 0 ? 1u : 0u);
}

// One consumer warp's 16 rows of one tile
struct Tile {
  float acc[D / 2];  // the context, unnormalised: acc[4j + 2h + e] is row g + 8h, column 8j + 2t + e
  float m[2];        // running max of the unscaled scores
  float l[2];        // this thread's share of the running sum
  int seg[2];        // the rows' segment ids
};

// The softmax of one block for the warp's rows, flash_kernel's attend, in
// steps: the segment test (a key of another id takes score -inf; none[h]
// when row h attends no key of a block that one id fills); m_next, alpha =
// ex2((m - m_next) c2) and the factors of p = ex2(s cr + nm); p a 16-key
// step at a time, summed and rounded to bf16 into P's A fragment.
__device__ __forceinline__ void segment_test(const Tile& r, float (&s)[64], const StageHead& h,
                                             bool uniform, int lane, bool (&none)[2]) {
  none[0] = none[1] = false;
  if (uniform) {
    none[0] = r.seg[0] != h.id;
    none[1] = r.seg[1] != h.id;
    return;
  }
  const int* ids = h.ids + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    const int2 kid = *reinterpret_cast<const int2*>(ids + 8 * j);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      s[4 * j + 2 * hh] = kid.x == r.seg[hh] ? s[4 * j + 2 * hh] : -INFINITY;
      s[4 * j + 2 * hh + 1] = kid.y == r.seg[hh] ? s[4 * j + 2 * hh + 1] : -INFINITY;
    }
  }
}

__device__ __forceinline__ void row_max(Tile& r, const float (&s)[64], const bool (&none)[2],
                                        float c2, float (&cr)[2], float (&nm)[2],
                                        float (&alpha)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // four chains a row, not one of 32 dependent FMNMX
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = fmaxf(s[4 * u + 2 * hh], s[4 * u + 2 * hh + 1]);
#pragma unroll
    for (int j = 4; j < kKeys / 8; ++j)
      x[j & 3] = fmaxf(x[j & 3], fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
    float mx = quad_max(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])));
    if (none[hh]) mx = -INFINITY;
    const float mn = fmaxf(r.m[hh], mx);
    const bool empty = mn == -INFINITY;  // no key of the row's segment yet
    alpha[hh] = empty ? 1.f : ex2((r.m[hh] - mn) * c2);
    cr[hh] = none[hh] ? 0.f : c2;
    nm[hh] = none[hh] ? -INFINITY : (empty ? 0.f : -mn * c2);
    r.m[hh] = mn;
  }
}

// p of 16-key step kk into P's A fragment pa: row g keys 2t, 2t + 1; row
// g + 8; row g keys 2t + 8, 2t + 9; row g + 8
__device__ __forceinline__ void exp_step(float (&s)[64], int kk, const float (&cr)[2],
                                         const float (&nm)[2], float (&ls)[2], uint32_t (&pa)[4]) {
#pragma unroll
  for (int i = 8 * kk; i < 8 * kk + 8; ++i) {
    s[i] = ex2(fmaf(s[i], cr[(i >> 1) & 1], nm[(i >> 1) & 1]));
    ls[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int f = 0; f < 4; ++f) pa[f] = pack_bf16(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1]);
}

// acc += P.V of 16-key step kk (mma.sync m16n8k16, as flash_kernel's
// attend: faster than a P.V wgmma at d 32, kernel 2's measure): P's A
// fragment pa as the softmax made it, V's B fragments by ldmatrix.trans
// from the 64-byte-swizzled stage (see v_lane); the context is the four
// n8 tiles' accumulators (acc[4j ..] is tile j's)
__device__ __forceinline__ void pv_step(float (&acc)[D / 2], const uint32_t (&pa)[4],
                                        const unsigned char* vrow, int swh, int kk) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t vf[4];
    ldsm_x4_trans(vf, vrow + 16 * kk * C::kRowB + (((2 * half) ^ swh) << 4));
    mma_bf16(*reinterpret_cast<float(*)[4]>(acc + 8 * half), pa, vf[0], vf[1]);
    mma_bf16(*reinterpret_cast<float(*)[4]>(acc + 8 * half + 4), pa, vf[2], vf[3]);
  }
}

// The lane's row of V in a stage and its swizzle: lane's matrix mi = lane
// / 8 is keys 8 (mi & 1) .. of a step, column granule (mi >> 1) of the 16
// columns; granule gi of key row k sits at gi ^ ((k >> 1) & 3)
__device__ __forceinline__ const unsigned char* v_lane(const unsigned char* vs, int lane, int& swh) {
  const int mi = lane >> 3;
  const int key = (lane & 7) + 8 * (mi & 1);
  swh = ((key >> 1) & 3) ^ (mi >> 1);
  return vs + key * C::kRowB;
}

// The block for the warp's rows of one tile: the softmax, the context
// rescaled by alpha, then each 16-key step's p made and multiplied into
// the context at once (P lives a step, not a block: fewer registers)
__device__ __forceinline__ void attend(Tile& r, float (&s)[64], const StageHead& h, bool uniform,
                                       float c2, int lane, const unsigned char* vs) {
  bool none[2];
  float cr[2], nm[2], alpha[2], ls[2] = {0.f, 0.f};
  segment_test(r, s, h, uniform, lane, none);
  row_max(r, s, none, c2, cr, nm, alpha);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) r.acc[i] *= alpha[(i >> 1) & 1];
  int swh;
  const unsigned char* vrow = v_lane(vs, lane, swh);
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    uint32_t pa[4];
    exp_step(s, kk, cr, nm, ls, pa);
    pv_step(r.acc, pa, vrow, swh, kk);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) r.l[hh] = fmaf(r.l[hh], alpha[hh], ls[hh]);
}

// attend for both of a warp's tiles, step by step in one stream: two
// independent chains a warp for the scheduler to overlap (the kernel is
// bound by issue and latency, not by MUFU)
__device__ __forceinline__ void attend2(Tile& a, float (&sa)[64], Tile& b, float (&sb)[64],
                                        const StageHead& h, bool uniform, float c2, int lane,
                                        const unsigned char* vs) {
  bool none_a[2], none_b[2];
  float cra[2], nma[2], ala[2], lsa[2] = {0.f, 0.f};
  float crb[2], nmb[2], alb[2], lsb[2] = {0.f, 0.f};
  segment_test(a, sa, h, uniform, lane, none_a);
  segment_test(b, sb, h, uniform, lane, none_b);
  row_max(a, sa, none_a, c2, cra, nma, ala);
  row_max(b, sb, none_b, c2, crb, nmb, alb);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    a.acc[i] *= ala[(i >> 1) & 1];
    b.acc[i] *= alb[(i >> 1) & 1];
  }
  int swh;
  const unsigned char* vrow = v_lane(vs, lane, swh);
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    uint32_t pa[4], pb[4];
    exp_step(sa, kk, cra, nma, lsa, pa);
    exp_step(sb, kk, crb, nmb, lsb, pb);
    pv_step(a.acc, pa, vrow, swh, kk);
    pv_step(b.acc, pb, vrow, swh, kk);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    a.l[hh] = fmaf(a.l[hh], ala[hh], lsa[hh]);
    b.l[hh] = fmaf(b.l[hh], alb[hh], lsb[hh]);
  }
}

// A tile's context over its row sums, rows ra and ra + 8 of the item at
// `base`, and jax's residuals on request
__device__ __forceinline__ void store_tile(const Tile& r, __nv_bfloat16* __restrict__ out,
                                           size_t base, size_t tok, int ra, float* res_m,
                                           float* res_l, size_t row0, float scale, int lane) {
  const int t = lane & 3;
  float l[2], inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] = quad_sum(r.l[hh]);
    inv[hh] = l[hh] == 0.f ? 1.f : 1.f / l[hh];
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(out + base + (size_t)ra * tok + col) =
        pack_bf16(r.acc[4 * j] * inv[0], r.acc[4 * j + 1] * inv[0]);
    *reinterpret_cast<uint32_t*>(out + base + (size_t)(ra + 8) * tok + col) =
        pack_bf16(r.acc[4 * j + 2] * inv[1], r.acc[4 * j + 3] * inv[1]);
  }
  if (res_m != nullptr && t == 0) store_residuals(res_m, res_l, row0, ra, ra + 8, r.m, l, scale);
}

__global__ void __launch_bounds__(kThreads, 1)
long_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const int32_t* __restrict__ seg,
            __nv_bfloat16* __restrict__ out, float* __restrict__ res_m,
            float* __restrict__ res_l, int P, int S, int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kv = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qtiles = kv + (size_t)kStages * 2 * C::kKvBytes;  // [kWg][2][kTiles][kQBytes]
  StageHead* head = reinterpret_cast<StageHead*>(qtiles + kWg * 2 * kTiles * C::kQBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(head + kStages);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;  // [kWg][2]

  const int n_items = (P * H - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int T = S / kRows, nb = S / kKeys, units = (T + kUnit - 1) / kUnit;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);         // every producer lane, after its head writes
      mbar_init(&empty[s], 4 * kWg);   // every consumer warp, when done with the block
    }
    for (int b = 0; b < 2 * kWg; ++b) mbar_init(&qfull[b], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * kWg) {  // the producer warpgroup: one warp works
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 4 * kWg) produce(&kmap, &vmap, seg, kv, head, full, empty, n_items, S, H, lane);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // Consumer warpgroup wg takes tiles t0 + wg (A) and t0 + 2 + wg (B) of
  // each unit of the block's items (B only where the item has it), and
  // takes each staged block for both: QK^T of both tiles on wgmma, then
  // both softmaxes and P.V (mma.sync) interleaved step by step (two
  // independent chains a warp).  One thread loads each unit's q tiles by
  // TMA into one of two buffers, a unit ahead.
  const int wg = warp >> 2, wl = warp & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  unsigned char* my_q = qtiles + wg * 2 * kTiles * C::kQBytes;
  uint64_t* my_qfull = qfull + 2 * wg;
  const int positions = n_items * units;  // the block's units
  auto load_q = [&](int k, int b) {       // unit k's tiles into buffer b
    const int item = blockIdx.x + (k / units) * gridDim.x;
    const int pair = item / H, hd = item - pair * H;
    const int t0 = (k % units) * kUnit;
    const int nt = t0 + kWg + wg < T ? 2 : 1;
    mbar_arrive_expect_tx(&my_qfull[b], nt * C::kQBytes);
    for (int j = 0; j < nt; ++j)
      tma_load_3d(my_q + (b * kTiles + j) * C::kQBytes, &qmap, &my_qfull[b], hd * D,
                  (t0 + kWg * j + wg) * kRows, pair);
  };
  auto release = [&](int n) {  // this warp is done with stage n
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[n % kStages]);
  };
  auto stage = [&](int n) { return kv + (size_t)(n % kStages) * 2 * C::kKvBytes; };
  const size_t tok = (size_t)H * D;  // stride of one token
  const float c2 = scale * kLog2e;
  if (leader && positions > 0) load_q(0, 0);
  int n = 0;  // stages passed
  for (int k = 0; k < positions; ++k) {
    const int item = blockIdx.x + (k / units) * gridDim.x;
    const int pair = item / H;
    const int t0 = (k % units) * kUnit;
    const bool has_b = t0 + kWg + wg < T;
    const int ra = (t0 + wg) * kRows + 16 * wl + (lane >> 2);  // tile A's rows ra, ra + 8
    const int rb = ra + kWg * kRows;                            // tile B's
    Tile a, b;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) a.acc[i] = b.acc[i] = 0.f;
    a.m[0] = a.m[1] = b.m[0] = b.m[1] = -INFINITY;
    a.l[0] = a.l[1] = b.l[0] = b.l[1] = 0.f;
    a.seg[0] = seg[(size_t)pair * S + ra];
    a.seg[1] = seg[(size_t)pair * S + ra + 8];
    b.seg[0] = has_b ? seg[(size_t)pair * S + rb] : 0;
    b.seg[1] = has_b ? seg[(size_t)pair * S + rb + 8] : 0;
    // every warp is past the last unit's wgmmas, which read the other buffer
    named_barrier(1 + wg, 128);
    if (leader && k + 1 < positions) load_q(k + 1, (k + 1) & 1);
    mbar_wait(&my_qfull[k & 1], (k >> 1) & 1);
    const unsigned char* qa = my_q + (k & 1) * kTiles * C::kQBytes;
    const unsigned char* qb = qa + C::kQBytes;
    const uint32_t bit_a = 1u << wg, bit_b = has_b ? 1u << (kWg + wg) : 0u;
    for (int kb = 0; kb < nb; ++kb, ++n) {
      mbar_wait(&full[n % kStages], (n / kStages) & 1);
      const StageHead& h = head[n % kStages];
      const unsigned char* ks = stage(n);
      const bool need_a = warp_uniform(h.need & bit_a), need_b = warp_uniform(h.need & bit_b);
      if (need_a || need_b) {
        float sa[64], sb[64];
        wgmma_fence();
        qk_issue(sa, qa, ks);
        qk_issue(sb, qb, ks);  // an absent B's scores go unread
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_pin(sa);
        wgmma_pin(sb);
        const bool uniform = warp_uniform(h.uniform);
        const unsigned char* vs = ks + C::kKvBytes;
        if (need_a && need_b) {
          attend2(a, sa, b, sb, h, uniform, c2, lane, vs);
        } else if (need_a) {
          attend(a, sa, h, uniform, c2, lane, vs);
        } else {
          attend(b, sb, h, uniform, c2, lane, vs);
        }
      }
      release(n);
    }
    const size_t base = (size_t)pair * S * tok + (size_t)(item - pair * H) * D;
    store_tile(a, out, base, tok, ra, res_m, res_l, (size_t)item * S, scale, lane);
    if (has_b) store_tile(b, out, base, tok, rb, res_m, res_l, (size_t)item * S, scale, lane);
  }
}

int launch(const void* q, const void* k, const void* v, const void* seg, void* out, float* res_m,
           float* res_l, int P, int S, int H, float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!tile_map(&qmap, q, P, S, H, D, C::kCw, kRows) ||
      !tile_map(&kmap, k, P, S, H, D, C::kCw, kKeys) ||
      !tile_map(&vmap, v, P, S, H, D, C::kCw, kKeys))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  constexpr size_t smem = smem_bytes(kStages);
  // as launch<D>'s: SMs of each device, 0 until a launch there has raised
  // this kernel's shared-memory limit
  static std::atomic<int> sms[64];
  int n_sm = sms[dev & 63].load(std::memory_order_acquire);
  if (n_sm == 0) {
    err = cudaFuncSetAttribute(long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms[dev & 63].store(n_sm, std::memory_order_release);
  }
  const int ctas = P * H < n_sm ? P * H : n_sm;  // one block an SM
  long_kernel<<<ctas, kThreads, smem, stream>>>(qmap, kmap, vmap, (const int32_t*)seg,
                                                (__nv_bfloat16*)out, res_m, res_l, P, S, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace longrow

}  // namespace

// q, k, v and out (B, S, H, head_dim) bf16, 16-byte aligned; seg (B, S)
// int32; head_dim 32, 64, 128, 256, or a multiple of 128 from 384; S a
// multiple of 128 from 128; B H and H head_dim below 2^31 (32-bit TMA
// coordinates).  m and l: null, or both (B, H, S) f32 that receive jax's
// saved residuals (_flash_attention_fwd: each row's final max of the
// scaled scores and its sum of p at that max; jax keeps them broadcast
// over 128 lanes), which the backward kernels (flash_attention_bwd.cu)
// read.  Returns a cudaError_t: 1 (cudaErrorInvalidValue) for shapes the
// kernel does not take, else the launch's own status.
extern "C" int flash_attention_res(const void* q, const void* k, const void* v, const void* seg,
                                   void* out, void* m, void* l, int B, int S, int H,
                                   int head_dim, float scale, void* stream) {
  if (S < kKeys || S % kKeys != 0 || B < 1 || H < 1 || head_dim < 1 ||
      (long long)B * H > INT32_MAX || (long long)H * head_dim > INT32_MAX ||
      (m == nullptr) != (l == nullptr) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* rm = (float*)m;
  float* rl = (float*)l;
  if (head_dim > 256 && head_dim % 128 == 0)
    return slab::launch(q, k, v, seg, out, rm, rl, B, S, H, head_dim, scale, st);
  switch (head_dim) {
    case 32:
      return S > 512 ? longrow::launch(q, k, v, seg, out, rm, rl, B, S, H, scale, st)
                     : launch<32>(q, k, v, seg, out, rm, rl, B, S, H, scale, st);
    case 64: return launch<64>(q, k, v, seg, out, rm, rl, B, S, H, scale, st);
    case 128: return launch<128>(q, k, v, seg, out, rm, rl, B, S, H, scale, st);
    case 256:
      return S == kKeys ? d256::launch<true>(q, k, v, seg, out, rm, rl, B, S, H, scale, st)
                        : d256::launch<false>(q, k, v, seg, out, rm, rl, B, S, H, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The serving entry: the context alone (no residuals), as before they
// were added; earlier builds of this file export it with these arguments.
extern "C" int flash_attention(const void* q, const void* k, const void* v, const void* seg,
                               void* out, int B, int S, int H, int head_dim, float scale,
                               void* stream) {
  return flash_attention_res(q, k, v, seg, out, nullptr, nullptr, B, S, H, head_dim, scale,
                             stream);
}
