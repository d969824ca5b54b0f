"""Time variants of the flash-attention kernel (kernel 7) on one NVIDIA GPU.

    python3 financial_rag_system_tpu_torch/tools/flash_attention_variants.py [--parent CSRC ...]
                                                                             [--only a,b]

Builds copies of ``financial_rag_system_tpu_torch/csrc/flash_attention.cu``
with one constant changed or one part cut out, and times each beside the
kernel as it is at the served shape (P 480, S 512, 12 heads of 32; the
``d256_`` variants at 3 heads of 256; the ``slab_`` and ``long_`` ones at
phase 15's shapes, below) on a
rerank-layout mask padded from 400 to 512 (``rerank_layout_mask``) and
on ``chip_smoke.py``'s uniform-length mask, in one
process on one card.  A variant with a part cut out computes a wrong
context: its time says what that part costs.  Variants at heads of 32:

- ``as_is``: the kernel as the port builds it;
- ``consumers_2``, ``consumers_4``: two (232 registers a thread) or four
  (112, the producer warpgroup 24) consumer warpgroups at heads of 32;
- ``stagger``: consumer warpgroup w starts 700 w ns late, so that the
  warpgroups' QK^T, softmax and P.V phases fall at different times;
- ``no_skip``: every (row tile, key block) pair computed;
- ``no_mask``: no per-score segment test (every block taken as one id);
- ``no_mufu``: ex2.approx replaced by the identity (no MUFU work);
- ``no_qk``: QK^T cut out (no wgmma, scores from the lane);
- ``no_pv``: P.V cut out;
- ``no_pack``: P truncated to bf16 by a byte permute in place of the
  rounding ``F2FP`` pack.

At heads of 256 (``d256::flash256_kernel``):

- ``d256_as_is``: the kernel as the port builds it;
- ``d256_keys_128``: online-softmax steps of jax's 128 keys (64 f32 of
  scores a thread beside the context: it spills) in place of 64;
- ``d256_slots_4``: a ring of four 32 KB slots, not five;
- ``d256_regs_232``: consumer warpgroups at 232 registers, the producer's
  at 40;
- ``d256_pv_mma``: P.V on ``mma.sync`` m16n8k16 with V's fragments by
  ``ldmatrix.trans``, accumulating into the context, in place of ``wgmma``;
- ``d256_no_mufu``: ex2.approx replaced by the identity;
- ``d256_no_pv``: P.V cut out;
- ``d256_no_skip``: every (row tile, key block) pair computed;
- ``d256_eager_rescale``: the context rescaled at every step, also by a
  warp whose rows' maxima all stayed put (alpha 1);
- ``d256_no_rescale``: the context's rescale cut out;
- ``d256_item_a_block``: each block takes whole items (their units one
  after another on one SM) in place of units dealt round the blocks.

The slab kernel (``slab::slab_kernel``, the ``slab_`` variants) at phase
15 (c)'s shape, P 480, S 1,024, 2 heads of 384 (the rerank layout of 992
keys padded to 1,024, and the uniform-length mask):

- ``slab_as_is``: the kernel as the port builds it;
- ``slab_cluster_1``, ``slab_cluster_4``: clusters of one block (no
  multicast: each row tile stages its own K and V) or four, not two;
- ``slab_q_staged``: q's 128-column pieces staged a block beside K's
  (each in a slot) in place of q resident, for a ring of six slots in
  place of four;
- ``slab_pv_from_smem``: P.V's A operand, P, from shared memory by
  descriptor in place of registers;
- ``slab_pv_waited``: each block's P.V waited for at its end, not left in
  flight into the next block's QK^T;
- ``slab_no_softmax``, ``slab_no_qk``, ``slab_no_pv``: that part cut out;
- ``slab_loads_only``: all three cut out (the producer's staging alone);
- ``slab_no_loads``: the producer stages nothing (the consumers' work
  alone, on whatever the slots hold).

The long-row kernel (``longrow::long_kernel``, the ``long_`` variants) at
phase 15 (b)'s shape, P 480, S 1,024, 12 heads of 32:

- ``long_as_is``: the kernel as the port builds it;
- ``long_one_chain``: the two tiles' softmaxes and P.V one after the
  other, not interleaved step by step;
- ``long_no_softmax``: the softmax and P.V cut out;
- ``long_no_mufu``: ex2.approx replaced by the identity;
- ``long_pipelined``: FA3's design in place of the kernel function (one
  row tile a consumer warpgroup, units of two; block kb's QK^T and block
  kb - 1's P.V, ``wgmma`` m64n32k16 with P from registers and V MN-major,
  issued together and the softmax run while the P.V is in flight; the two
  warpgroups issue in turns on named barriers, FA3's ping-pong);
- ``long_pipelined_solo``: the same without the turns;
- ``long_staggered``: two row tiles a warpgroup (units of four) as
  shipped, P.V on ``wgmma`` m64n32k16, and each tile's P.V and next QK^T
  issued together so that one tile's softmax runs while the other's
  products are in flight.

The slab kernel at 2 heads of 640 (column groups of 3 + 2, two launches)
and 1,024 (4 + 4), P 480, S 1,024 (``slab640_``, ``slab1024_``):

- ``slab640_as_is``, ``slab1024_as_is``: the kernel as the port builds it;
- ``slab640_one_launch``, ``slab1024_one_launch``: one instantiation a
  step kind with four slabs' accumulators, a column group's slab count at
  run time, one launch over every group, four slabs a group and the last
  taking the rest (640 as 4 + 1);
- ``..._one_launch_groups_outer``: the same with an item's column groups
  outermost in the order its units are dealt.

``--parent CSRC`` (it may repeat) also times an earlier checkout's
``flash_attention.cu`` at every family's shape, as ``parent0``,
``parent1``, ...
Each line gives the build's median time (CUDA events, 20 launches), twice:
every build is timed in order and then in reverse order (in turns); the
largest difference from the plain version over the first 8 pairs; the
registers and spills of the family's kernel as ``ptxas -v`` reports them
(registers before ``setmaxnreg``), and the card's name and power limit.
A build that fails is reported and the rest are timed (exit status 1).
The variants build in parallel, into ``build/flash_attention_variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

SRC = Path(__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"
OUT = REPO / "build" / "flash_attention_variants"


def rerank_layout_mask(np, p: int, s: int, lq: int = 32, seed: int = 0):
    """Key masks laid out as the rerank pairs are (``ops/fused_query.py
    _assemble_pairs``): query tokens, a zero-padded hole up to ``lq``,
    document tokens, tail padding up to ``s``."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((p, s), np.int32)
    for i in range(p):
        mask[i, :rng.integers(3, lq + 1)] = 1
        mask[i, lq:lq + rng.integers(1, s - lq + 1)] = 1
    return mask


def patched(text: str, *pairs: tuple[str, str]) -> str:
    for old, new in pairs:
        if old not in text:
            raise RuntimeError(f"flash_attention.cu no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    return text


WG = "static constexpr int kWg = D == 32 ? 3 : 2;"
REGS = "static constexpr int kConsumerRegs = D == 32 ? 152 : D == 64 ? 232 : 240;"
PRODUCER = "static constexpr int kProducerRegs = D == 128 ? 24 : 40;"
PV = "#pragma unroll\n  for (int c32 = 0; c32 < D / 32; ++c32) {  // context columns 32 c32 .."
VARIANTS = {
    "as_is": lambda s: s,
    "consumers_2": lambda s: patched(s, (WG, "static constexpr int kWg = 2;"),
                                     (REGS, "static constexpr int kConsumerRegs = D == 128 ? 240 : 232;")),
    "consumers_4": lambda s: patched(
        s, (WG, "static constexpr int kWg = D == 32 ? 4 : 2;"),
        (REGS, "static constexpr int kConsumerRegs = D == 32 ? 112 : D == 64 ? 232 : 240;"),
        (PRODUCER, "static constexpr int kProducerRegs = D == 64 ? 40 : 24;")),
    "stagger": lambda s: patched(
        s, ("  setmaxnreg_inc<C::kConsumerRegs>();\n",
            "  setmaxnreg_inc<C::kConsumerRegs>();\n  __nanosleep(700 * (warp >> 2));\n")),
    "no_skip": lambda s: patched(
        s, ("    if (tp[w] & bp) need |= 1u << w;", "    if (tp[w] != 0) need |= 1u << w;")),
    "no_mask": lambda s: patched(s, ("  if (h.uniform) {", "  if (true) {")),
    "no_mufu": lambda s: patched(
        s, ('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x;")),
    "no_qk": lambda s: patched(
        s, ("            qk<D>(sc, qs, ks);",
            "#pragma unroll\n            for (int e = 0; e < 64; ++e) sc[e] = (float)(e ^ lane);")),
    "no_pv": lambda s: patched(s, (PV, "  if (pa[0][0] == 0x12345u)\n" + PV)),
    "no_pack": lambda s: patched(
        s, ("  uint32_t pa[kKeys / 16][4];  // P's A fragments, a 16-key step each",
            "  auto pack_bf16 = [](float a, float b) {\n"
            "    return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);\n  };\n"
            "  uint32_t pa[kKeys / 16][4];")),
}


D256_SLOTS = "constexpr int kMaxSlots = 8;\nconstexpr int kSub = 64;"
D256_SLOTS_ASSERT = ("static_assert(ring_slots() == 5 && smem_bytes(ring_slots()) == 231552 &&\n"
                     "                  smem_bytes(ring_slots() + 1) > kSmemLimit,")
D256_PV = "  wgmma_fence();\n#pragma unroll\n  for (int kk = 0; kk < N / 8; ++kk) {\n    const int off"
D256_PV_END = "  wgmma_pin(r.acc);\n}"
D256_PV_MMA = """  // P.V on mma.sync: V's B fragments by ldmatrix.trans from the
  // swizzled slots (granule gi of key row k at gi ^ (k & 7))
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  const int key = (lane & 7) + 8 * (mi & 1), swh = (key & 7) ^ (mi >> 1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const unsigned char* vrow = (half ? v1 : v0) + (key0 + key) * kRowB;
#pragma unroll
    for (int kk = 0; kk < N / 8; ++kk) {
#pragma unroll
      for (int g0 = 0; g0 < kHalf / 8; g0 += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vrow + (g0 / 8) * kSlotChunk + 16 * kk * kRowB + (((g0 % 8) ^ swh) << 4));
        const int dn = half * (kHalf / 8) + g0;
        mma_bf16(*reinterpret_cast<float (*)[4]>(r.acc + 4 * dn), pa[kk], vf[0], vf[1]);
        mma_bf16(*reinterpret_cast<float (*)[4]>(r.acc + 4 * dn + 4), pa[kk], vf[2], vf[3]);
      }
    }
  }
  return;
""" + D256_PV
D256_RESCALE = "  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {"
D256_VARIANTS = {
    "d256_as_is": lambda s: s,
    "d256_keys_128": lambda s: patched(
        s, ("constexpr int kSub = 64;", "constexpr int kSub = 128;")),
    "d256_slots_4": lambda s: patched(
        s, (D256_SLOTS, "constexpr int kMaxSlots = 4;\nconstexpr int kSub = 64;"),
        (D256_SLOTS_ASSERT, "static_assert(ring_slots() == 4,")),
    "d256_regs_232": lambda s: patched(
        s, ("constexpr int kProducerRegs = 24;           // registers",
            "constexpr int kProducerRegs = 40;           // registers"),
        ("constexpr int kConsumerRegs = 240;", "constexpr int kConsumerRegs = 232;")),
    "d256_pv_mma": lambda s: patched(s, (D256_PV, D256_PV_MMA)),
    "d256_no_mufu": VARIANTS["no_mufu"],
    "d256_no_pv": lambda s: patched(s, (D256_PV, "  if (gridDim.x == 12345u) {\n" + D256_PV),
                                    (D256_PV_END, "  wgmma_pin(r.acc);\n  }\n}")),
    "d256_no_skip": VARIANTS["no_skip"],
    "d256_eager_rescale": lambda s: patched(s, (D256_RESCALE, "  {")),
    "d256_no_rescale": lambda s: patched(s, (D256_RESCALE, "  if (false) {")),
    "d256_item_a_block": lambda s: patched(
        s, ("  return (items * units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;",
            "  return (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * units;"),
        ("  const int w = blockIdx.x + k * gridDim.x;\n  item = w / units;\n  u = w - item * units;",
         "  item = blockIdx.x + (k / units) * gridDim.x;\n  u = k % units;"),
        ("  const int work = P * H * (S / (kWg * kRows));  // units",
         "  const int work = P * H;  // items")),
}


SLAB_SOFTMAX = ("        uint32_t own[kHalf / 16][4], other[kHalf / 16][4];  // P's A fragments, 64 "
                "keys each\n        if (need) {")
SLAB_QK = "          if (need) {\n            wgmma_fence();\n            const unsigned char* ks"
SLAB_PV_NEED = "          if (need) {\n            wgmma_fence();\n            pv_chunk("
SLAB_LOADS = "        if (lane == 0 && need) {\n          unsigned char* dst = slots"


def cut(anchor: str) -> tuple[str, str]:
    """The pair that turns ``if (need ...`` at ``anchor`` false."""
    return anchor, anchor.replace("need) {", "need && gridDim.y == 7u) {", 1)


SLAB_QRES = ("__host__ __device__ constexpr bool q_resident(int d) { return smem_bytes(d, true, 2) "
             "<= kSmemLimit; }")
SLAB_RINGS = "static_assert(ring_slots(384) == 4"
SLAB_P_STORE = "          named_barrier(1, 2 * 128);  // both halves of P are in"
SLAB_PV = ("    wgmma_rs_mn(acc, other[kk], wgmma_desc_mn<128>(vt + kk * 16 * 128, kKChunk), 1u);\n}")
# P.V with A = P from shared memory by descriptor (wgmma's transposed B, A
# K-major): the helper and the chunk's products, appended after pv_chunk
WGMMA_SS_MN = r"""// d (64 x N f32) = A (64 x 16 bf16, K-major in shared memory, by
// descriptor) * B (16 x N, MN-major in shared memory: wgmma_desc_mn) +
// (scale_d ? d : 0); d's layout as wgmma_rs's; N 64.
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t a, uint64_t b,
                                            uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
"""
SLAB_PV_SMEM = ("    wgmma_rs_mn(acc, other[kk], wgmma_desc_mn<128>(vt + kk * 16 * 128, kKChunk), 1u);\n"
                "}\n" + WGMMA_SS_MN + "__device__ __forceinline__ void pv_chunk_smem(float (&acc)[32], "
                "const unsigned char* p, const unsigned char* vc) {\n"
                "#pragma unroll\n  for (int kk = 0; kk < kKeys / 16; ++kk)\n"
                "    wgmma_ss_mn(acc, wgmma_desc_sw128(p + (kk / 4) * kQChunk + (kk % 4) * 32),\n"
                "                wgmma_desc_mn<128>(vc + kk * 16 * 128, kKChunk), 1u);\n}")
SLAB_PV_CALL = ("            pv_chunk(*reinterpret_cast<float(*)[32]>(acc + 32 * i), own, other,\n"
                "                     slots + (size_t)sv * kSlotBytes + wg * kKChunk, wg);")
SLAB_PENDING = "        pending_v = prev_v;\n      }"
SLAB_P_LOAD = ("              ldsm_x4(other[kk], po + row * 128 + (((2 * kk + (lane >> 4)) ^ (row & 7)) "
               "<< 4));")


SLAB_VARIANTS = {
    "slab_as_is": lambda s: s,
    "slab_cluster_1": lambda s: patched(s, ("constexpr int kCluster = 2;", "constexpr int kCluster = 1;")),
    "slab_cluster_4": lambda s: patched(s, ("constexpr int kCluster = 2;", "constexpr int kCluster = 4;")),
    "slab_q_staged": lambda s: patched(
        s, (SLAB_QRES, "__host__ __device__ constexpr bool q_resident(int) { return false; }"),
        (SLAB_RINGS, "static_assert(true || ring_slots(384) == 4")),
    "slab_pv_waited": lambda s: patched(
        s, (SLAB_PENDING, "        wgmma_wait<0>();\n        wgmma_pin(acc);\n        release(prev_v);\n      }")),
    "slab_pv_from_smem": lambda s: patched(
        s, (SLAB_PV, SLAB_PV_SMEM),
        (SLAB_P_STORE, "          fence_proxy_async();\n" + SLAB_P_STORE),
        (SLAB_P_LOAD, "              (void)po;"),
        (SLAB_PV_CALL, "            pv_chunk_smem(*reinterpret_cast<float(*)[32]>(acc + 32 * i), pbuf,\n"
                       "                          slots + (size_t)sv * kSlotBytes + wg * kKChunk);")),
    "slab_no_softmax": lambda s: patched(s, cut(SLAB_SOFTMAX)),
    "slab_no_qk": lambda s: patched(s, cut(SLAB_QK)),
    "slab_no_pv": lambda s: patched(s, cut(SLAB_PV_NEED)),
    "slab_loads_only": lambda s: patched(s, cut(SLAB_SOFTMAX), cut(SLAB_QK), cut(SLAB_PV_NEED)),
    "slab_no_loads": lambda s: patched(s, cut(SLAB_LOADS)),
}
LONG_PAIR = "          attend2(a, sa, b, sb, h, uniform, c2, lane, vs);"
LONG_BRANCHES = (("        if (need_a && need_b) {", "        if (gridDim.y == 7u) {"),
                 ("        } else if (need_a) {", "        } else if (gridDim.y == 7u) {"),
                 ("        } else {\n          attend(b", "        } else if (gridDim.y == 7u) {\n          attend(b"))
# FA3's design for the long-row kernel (heads of 32 above S 512): one row
# tile a consumer warpgroup (units of two), and for each 128-key block a
# "turn" in which the warpgroup issues the block's QK^T and the block
# before's P.V (wgmma m64n32k16, P from registers, V MN-major) together,
# then runs the block's softmax while that P.V is in flight (the
# intra-warpgroup pipeline: two score sets, the scores and the packed P
# in flight); the two warpgroups take their turns to issue in alternation
# on named barriers 3 and 4 (ping-pong), so one's softmax runs beside the
# other's products.  A block no tile of the warpgroup attends still takes
# its turn with P = 0 (the ring is zeroed first, so a stage that was
# never loaded holds finite values), which keeps every commit group
# holding its wgmmas.  It replaces the shipped kernel function whole.
LONG_WGMMA_HELPERS = r"""// P.V of one block on wgmma m64n32k16: P's A fragments from registers, V
// an MN-major B operand of the 64-byte-swizzled stage, into the context
__device__ __forceinline__ void pv_issue(float (&acc)[D / 2], const uint32_t (&p)[kKeys / 16][4],
                                         const unsigned char* vs) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    wgmma_rs_mn(acc, p[kk], wgmma_desc_mn<C::kRowB>(vs + kk * 16 * C::kRowB, C::kKChunk), 1u);
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// keep P's registers live until the wgmmas that read them have been waited for
__device__ __forceinline__ void p_pin(uint32_t (&p)[kKeys / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) asm volatile("" : "+r"(p[kk][f])::"memory");
  }
}

// one block's softmax for the warp's rows into P's A fragments pn; alpha
// and the block's row sums ls for the update once the P.V before is done
__device__ __forceinline__ void soft(Tile& r, float (&s)[64], const StageHead& h, bool uniform,
                                     float c2, int lane, uint32_t (&pn)[kKeys / 16][4],
                                     float (&alpha)[2], float (&ls)[2]) {
  bool none[2];
  float cr[2], nm[2];
  ls[0] = ls[1] = 0.f;
  segment_test(r, s, h, uniform, lane, none);
  row_max(r, s, none, c2, cr, nm, alpha);
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) exp_step(s, kk, cr, nm, ls, pn[kk]);
}

"""
LONG_PIPELINED_KERNEL = r"""__global__ void __launch_bounds__(kThreads, 1)
long_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const int32_t* __restrict__ seg,
            __nv_bfloat16* __restrict__ out, float* __restrict__ res_m,
            float* __restrict__ res_l, int P, int S, int H, float scale) {
  constexpr bool kPingPong = true;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kv = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qtiles = kv + (size_t)kStages * 2 * C::kKvBytes;  // [kWg][2][kQBytes]
  StageHead* head = reinterpret_cast<StageHead*>(qtiles + kWg * 2 * kTiles * C::kQBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(head + kStages);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;  // [kWg][2]

  const int n_items = (P * H - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int T = S / kRows, nb = S / kKeys, units = (T + kUnit - 1) / kUnit;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 4 * kWg);
    }
    for (int b = 0; b < 2 * kWg; ++b) mbar_init(&qfull[b], 1);
    mbar_init_fence();
  }
  for (int i = threadIdx.x; i < kStages * 2 * C::kKvBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(kv)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  __syncthreads();

  if (warp >= 4 * kWg) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 4 * kWg) produce(&kmap, &vmap, seg, kv, head, full, empty, n_items, S, H, lane);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp >> 2, wl = warp & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  unsigned char* my_q = qtiles + wg * 2 * C::kQBytes;
  uint64_t* my_qfull = qfull + 2 * wg;
  const int positions = n_items * units;
  auto load_q = [&](int k, int b) {
    const int item = blockIdx.x + (k / units) * gridDim.x;
    const int pair = item / H, hd = item - pair * H;
    const int t0 = (k % units) * kUnit;
    mbar_arrive_expect_tx(&my_qfull[b], C::kQBytes);
    tma_load_3d(my_q + b * C::kQBytes, &qmap, &my_qfull[b], hd * D, (t0 + wg) * kRows, pair);
  };
  auto release = [&](int n) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[n % kStages]);
  };
  auto stage = [&](int n) { return kv + (size_t)(n % kStages) * 2 * C::kKvBytes; };
  // ping-pong: warpgroup wg issues on barrier 3 + wg once the other has
  // issued and arrived there; warpgroup 0 takes the first turn, and the
  // last turn's arrival is left out, so every arrival is waited for
  const int turns = positions * (nb + 1);
  int turn = 0;
  auto mine = [&]() {
    if (kPingPong) named_barrier(3 + wg, 256);
  };
  auto pass = [&]() {
    ++turn;
    if (kPingPong && (wg == 0 || turn < turns)) named_arrive(4 - wg, 256);
  };
  if (kPingPong && wg == 1 && turns > 0) named_arrive(3, 256);
  const size_t tok = (size_t)H * D;
  const float c2 = scale * kLog2e;
  if (leader && positions > 0) load_q(0, 0);
  int n = 0;
  for (int k = 0; k < positions; ++k) {
    const int item = blockIdx.x + (k / units) * gridDim.x;
    const int pair = item / H;
    const int t0 = (k % units) * kUnit;
    const int ra = (t0 + wg) * kRows + 16 * wl + (lane >> 2);
    Tile a;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) a.acc[i] = 0.f;
    a.m[0] = a.m[1] = -INFINITY;
    a.l[0] = a.l[1] = 0.f;
    a.seg[0] = seg[(size_t)pair * S + ra];
    a.seg[1] = seg[(size_t)pair * S + ra + 8];
    named_barrier(1 + wg, 128);
    if (leader && k + 1 < positions) load_q(k + 1, (k + 1) & 1);
    mbar_wait(&my_qfull[k & 1], (k >> 1) & 1);
    const unsigned char* qa = my_q + (k & 1) * C::kQBytes;
    const uint32_t bit = 1u << wg;
    float s[64], alpha[2], ls[2];
    uint32_t pc[kKeys / 16][4], pn[kKeys / 16][4];  // this block's P, the next block's
    // turn 0: block 0's QK^T, then its softmax
    mbar_wait(&full[n % kStages], (n / kStages) & 1);
    {
      const StageHead& h = head[n % kStages];
      const bool need = warp_uniform(h.need & bit);
      mine();
      wgmma_fence();
      qk_issue(s, qa, stage(n));
      wgmma_commit();
      pass();
      wgmma_wait<0>();
      wgmma_pin(s);
      if (need) {
        soft(a, s, h, warp_uniform(h.uniform), c2, lane, pc, alpha, ls);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) a.l[hh] = ls[hh];
      } else {
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) pc[kk][0] = pc[kk][1] = pc[kk][2] = pc[kk][3] = 0u;
      }
    }
    // turn kb: block kb's QK^T and block kb - 1's P.V issued together;
    // block kb's softmax while the P.V runs; the context rescaled after it
    for (int kb = 1; kb < nb; ++kb) {
      const int cur = n + kb;
      mbar_wait(&full[cur % kStages], (cur / kStages) & 1);
      const StageHead& h = head[cur % kStages];
      const bool need = warp_uniform(h.need & bit);
      mine();
      wgmma_fence();
      qk_issue(s, qa, stage(cur));
      wgmma_commit();
      pv_issue(a.acc, pc, stage(cur - 1) + C::kKvBytes);
      wgmma_commit();
      pass();
      wgmma_wait<1>();
      wgmma_pin(s);
      if (need) soft(a, s, h, warp_uniform(h.uniform), c2, lane, pn, alpha, ls);
      wgmma_wait<0>();
      wgmma_pin(a.acc);
      p_pin(pc);
      release(cur - 1);
      if (need) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) a.acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) a.l[hh] = fmaf(a.l[hh], alpha[hh], ls[hh]);
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
          for (int f = 0; f < 4; ++f) pc[kk][f] = pn[kk][f];
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) pc[kk][0] = pc[kk][1] = pc[kk][2] = pc[kk][3] = 0u;
      }
    }
    // the last turn: the last block's P.V
    mine();
    wgmma_fence();
    pv_issue(a.acc, pc, stage(n + nb - 1) + C::kKvBytes);
    wgmma_commit();
    pass();
    wgmma_wait<0>();
    wgmma_pin(a.acc);
    p_pin(pc);
    release(n + nb - 1);
    n += nb;
    const size_t base = (size_t)pair * S * tok + (size_t)(item - pair * H) * D;
    store_tile(a, out, base, tok, ra, res_m, res_l, (size_t)item * S, scale, lane);
  }
}

"""
LONG_KERNEL_START = "__global__ void __launch_bounds__(kThreads, 1)\nlong_kernel("
LONG_KERNEL_END = ("int launch(const void* q, const void* k, const void* v, const void* seg, void* out, "
                   "float* res_m,\n           float* res_l, int P, int S, int H, float scale, "
                   "cudaStream_t stream) {")


# A staggered pipeline that keeps two row tiles a consumer warpgroup (units
# of four, as shipped): the warpgroup commits, in order, X_kb = {tile A's
# P.V of block kb, A's QK^T of block kb + 1} and Y_kb = {B's P.V of kb, B's
# QK^T of kb + 1}, so A's softmax runs while B's products are in flight and
# B's while A's are; P.V on wgmma m64n32k16.  The last block's "next" QK^T
# reads its own K again and goes unread, so every group holds its wgmmas.
LONG_STAGGERED_KERNEL = r"""__global__ void __launch_bounds__(kThreads, 1)
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
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 4 * kWg);
    }
    for (int b = 0; b < 2 * kWg; ++b) mbar_init(&qfull[b], 1);
    mbar_init_fence();
  }
  // the ring and the q tiles zeroed: a stage no tile needs is not loaded,
  // and an absent tile's q is not either, yet both are read (P = 0)
  for (int i = threadIdx.x; i < (kStages * 2 * C::kKvBytes + kWg * 2 * kTiles * C::kQBytes) / 16;
       i += kThreads)
    reinterpret_cast<uint4*>(kv)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  __syncthreads();

  if (warp >= 4 * kWg) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 4 * kWg) produce(&kmap, &vmap, seg, kv, head, full, empty, n_items, S, H, lane);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp >> 2, wl = warp & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  unsigned char* my_q = qtiles + wg * 2 * kTiles * C::kQBytes;
  uint64_t* my_qfull = qfull + 2 * wg;
  const int positions = n_items * units;
  auto load_q = [&](int k, int b) {
    const int item = blockIdx.x + (k / units) * gridDim.x;
    const int pair = item / H, hd = item - pair * H;
    const int t0 = (k % units) * kUnit;
    const int nt = t0 + kWg + wg < T ? 2 : 1;
    mbar_arrive_expect_tx(&my_qfull[b], nt * C::kQBytes);
    for (int j = 0; j < nt; ++j)
      tma_load_3d(my_q + (b * kTiles + j) * C::kQBytes, &qmap, &my_qfull[b], hd * D,
                  (t0 + kWg * j + wg) * kRows, pair);
  };
  auto release = [&](int n) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[n % kStages]);
  };
  auto stage = [&](int n) { return kv + (size_t)(n % kStages) * 2 * C::kKvBytes; };
  const size_t tok = (size_t)H * D;
  const float c2 = scale * kLog2e;
  if (leader && positions > 0) load_q(0, 0);
  int n = 0;
  for (int k = 0; k < positions; ++k) {
    const int item = blockIdx.x + (k / units) * gridDim.x;
    const int pair = item / H;
    const int t0 = (k % units) * kUnit;
    const bool has_b = t0 + kWg + wg < T;
    const int ra = (t0 + wg) * kRows + 16 * wl + (lane >> 2);
    const int rb = ra + kWg * kRows;
    Tile a, b;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) a.acc[i] = b.acc[i] = 0.f;
    a.m[0] = a.m[1] = b.m[0] = b.m[1] = -INFINITY;
    a.l[0] = a.l[1] = b.l[0] = b.l[1] = 0.f;
    a.seg[0] = seg[(size_t)pair * S + ra];
    a.seg[1] = seg[(size_t)pair * S + ra + 8];
    b.seg[0] = has_b ? seg[(size_t)pair * S + rb] : 0;
    b.seg[1] = has_b ? seg[(size_t)pair * S + rb + 8] : 0;
    named_barrier(1 + wg, 128);
    if (leader && k + 1 < positions) load_q(k + 1, (k + 1) & 1);
    mbar_wait(&my_qfull[k & 1], (k >> 1) & 1);
    const unsigned char* qa = my_q + (k & 1) * kTiles * C::kQBytes;
    const unsigned char* qb = qa + C::kQBytes;
    const uint32_t bit_a = 1u << wg, bit_b = has_b ? 1u << (kWg + wg) : 0u;
    float sa[64], sb[64], al[2], ls[2];
    uint32_t pa[kKeys / 16][4], pb[kKeys / 16][4];
    // groups, in commit order: X_kb = {P.V of A at kb, QK^T of A at kb + 1},
    // Y_kb = {P.V of B at kb, QK^T of B at kb + 1}; QK^T of A and B at 0 first
    mbar_wait(&full[n % kStages], (n / kStages) & 1);
    wgmma_fence();
    qk_issue(sa, qa, stage(n));
    wgmma_commit();
    qk_issue(sb, qb, stage(n));
    wgmma_commit();
    for (int kb = 0; kb < nb; ++kb) {
      const int cur = n + kb;
      const StageHead& h = head[cur % kStages];
      const bool need_a = warp_uniform(h.need & bit_a), need_b = warp_uniform(h.need & bit_b);
      const bool uniform = warp_uniform(h.uniform);
      // the last block's "next" QK^T reads this block's K again, unread
      const bool more = kb + 1 < nb;
      if (more) mbar_wait(&full[(cur + 1) % kStages], ((cur + 1) / kStages) & 1);
      const unsigned char* kn = stage(more ? cur + 1 : cur);
      const unsigned char* vs = stage(cur) + C::kKvBytes;
      wgmma_wait<1>();  // X_{kb-1}: A's QK^T at kb and its P.V at kb - 1
      wgmma_pin(sa);
      wgmma_pin(a.acc);
      p_pin(pa);
      if (need_a) {
        soft(a, sa, h, uniform, c2, lane, pa, al, ls);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) a.acc[i] *= al[(i >> 1) & 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) a.l[hh] = fmaf(a.l[hh], al[hh], ls[hh]);
      } else {
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
      }
      wgmma_fence();
      pv_issue(a.acc, pa, vs);
      qk_issue(sa, qa, kn);
      wgmma_commit();  // X_kb
      wgmma_wait<1>();  // Y_{kb-1}: B's QK^T at kb and its P.V at kb - 1
      wgmma_pin(sb);
      wgmma_pin(b.acc);
      p_pin(pb);
      if (kb > 0) release(cur - 1);
      if (need_b) {
        soft(b, sb, h, uniform, c2, lane, pb, al, ls);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) b.acc[i] *= al[(i >> 1) & 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) b.l[hh] = fmaf(b.l[hh], al[hh], ls[hh]);
      } else {
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) pb[kk][0] = pb[kk][1] = pb[kk][2] = pb[kk][3] = 0u;
      }
      wgmma_fence();
      pv_issue(b.acc, pb, vs);
      qk_issue(sb, qb, kn);
      wgmma_commit();  // Y_kb
    }
    wgmma_wait<0>();
    wgmma_pin(sa);
    wgmma_pin(sb);
    wgmma_pin(a.acc);
    wgmma_pin(b.acc);
    p_pin(pa);
    p_pin(pb);
    release(n + nb - 1);
    n += nb;
    const size_t base = (size_t)pair * S * tok + (size_t)(item - pair * H) * D;
    store_tile(a, out, base, tok, ra, res_m, res_l, (size_t)item * S, scale, lane);
    if (has_b) store_tile(b, out, base, tok, rb, res_m, res_l, (size_t)item * S, scale, lane);
  }
}

"""


def long_kernel_replaced(text: str, kernel: str) -> str:
    """The source with the function ``long_kernel`` replaced by ``kernel``
    (after the wgmma helpers the replacements share)."""
    start = text.index(LONG_KERNEL_START)
    end = text.index(LONG_KERNEL_END, start)
    return text[:start] + LONG_WGMMA_HELPERS + kernel + text[end:]


def long_pipelined(text: str, ping_pong: bool = True) -> str:
    """The source with ``long_kernel`` replaced by FA3's design
    (``LONG_PIPELINED_KERNEL``), units of two tiles, with or without the
    ping-pong."""
    text = patched(text, ("constexpr int kTiles = 2;", "constexpr int kTiles = 1;"),
                   ("static_assert(kStages == 8 && smem_bytes(kStages) == 169248,",
                    "static_assert(kStages == 8,"))
    kernel = LONG_PIPELINED_KERNEL
    if not ping_pong:
        kernel = kernel.replace("constexpr bool kPingPong = true;", "constexpr bool kPingPong = false;")
    return long_kernel_replaced(text, kernel)


LONG_VARIANTS = {
    "long_as_is": lambda s: s,
    "long_one_chain": lambda s: patched(
        s, (LONG_PAIR, "          attend(a, sa, h, uniform, c2, lane, vs);\n"
                       "          attend(b, sb, h, uniform, c2, lane, vs);")),
    "long_no_softmax": lambda s: patched(s, *LONG_BRANCHES),
    "long_no_mufu": VARIANTS["no_mufu"],
    "long_pipelined": long_pipelined,
    "long_pipelined_solo": lambda s: long_pipelined(s, ping_pong=False),
    "long_staggered": lambda s: long_kernel_replaced(s, LONG_STAGGERED_KERNEL),
}
# The slab kernel as one instantiation a step kind (four slabs'
# accumulators, a column group's slab count, group_slabs, at run time) and
# one launch over every column group, four slabs a group and the last
# taking the rest (640 as 4 + 1) in place of an instantiation and a launch
# a group size; with groups_outer an item's units take its column groups
# outermost (g slower than the row-tile pair u).
SLAB_ONE_LAUNCH = (
    ("template <int I, int N, typename F>",
     "__device__ __forceinline__ int group_slabs(int np, int g) {\n"
     "  return np - kMaxGroup * g < kMaxGroup ? np - kMaxGroup * g : kMaxGroup;\n}\n\n"
     "template <int I, int N, typename F>"),
    ("""template <int G>
__device__ __forceinline__ void produce(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, const int32_t* __restrict__ seg,
                                        unsigned char* slots, StageHead* heads, uint64_t* full,
                                        uint64_t* empty, int n_units, int ns, int S, int H, int D,
                                        int ng, int slab0, bool qres, uint32_t rank, int cid,
                                        int ncl, int lane) {
  const int T = S / kRows, nb = S / kKeys, tg = T / kCluster, np = D / 128;
  const int parts = (qres ? np : 2 * np) + G;  // slots a block
""",
     """__device__ __forceinline__ void produce(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, const int32_t* __restrict__ seg,
                                        unsigned char* slots, StageHead* heads, uint64_t* full,
                                        uint64_t* empty, int n_units, int ns, int S, int H, int D,
                                        int ng, bool qres, uint32_t rank, int cid, int ncl,
                                        int lane) {
  const int T = S / kRows, nb = S / kKeys, tg = T / kCluster, np = D / 128;
"""),
    ("""    const int pair = item / H, hd = item - pair * H;
    const int32_t* srow = seg + (size_t)pair * S;
    uint32_t tp[kCluster];""",
     """    const int pair = item / H, hd = item - pair * H;
    const int gs = group_slabs(np, g);
    const int parts = (qres ? np : 2 * np) + gs;  // slots a block
    const int32_t* srow = seg + (size_t)pair * S;
    uint32_t tp[kCluster];"""),
    ("""            const bool v = part >= parts - G;
            const int col = hd * D + (v ? slab0 + g * G + part - (parts - G) : piece) * 128;""",
     """            const bool v = part >= parts - gs;
            const int col = hd * D + (v ? kMaxGroup * g + part - (parts - gs) : piece) * 128;"""),
    ("""template <int G, bool SINGLE>
__global__ void __launch_bounds__(kThreads, 1)
slab_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const int32_t* __restrict__ seg,
            __nv_bfloat16* __restrict__ out, float* __restrict__ res_m,
            float* __restrict__ res_l, int P, int S, int H, int D, float scale, int ng,
            int slab0, int ns) {""",
     """template <bool SINGLE>
__global__ void __launch_bounds__(kThreads, 1)
slab_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const int32_t* __restrict__ seg,
            __nv_bfloat16* __restrict__ out, float* __restrict__ res_m,
            float* __restrict__ res_l, int P, int S, int H, int D, float scale, int ng, int ns) {
  constexpr int G = kMaxGroup;"""),
    ("""      produce<G>(&qmap, &kmap, &vmap, seg, slots, heads, full, empty, n_units, ns, S, H, D, ng,
                 slab0, qres, rank, cid, ncl, lane);""",
     """      produce(&qmap, &kmap, &vmap, seg, slots, heads, full, empty, n_units, ns, S, H, D, ng, qres,
              rank, cid, ncl, lane);"""),
    ("""      const int pair = item / H;
      const int ra = (u * kCluster + (int)rank) * kRows + row_a;""",
     """      const int pair = item / H;
      const int gs = group_slabs(np, g);
      const int ra = (u * kCluster + (int)rank) * kRows + row_a;"""),
    ("""          const int sv = take();
          if (need) {
            wgmma_fence();
            pv_chunk(*reinterpret_cast<float(*)[32]>(acc + 32 * i), own, other,
                     slots + (size_t)sv * kSlotBytes + wg * kKChunk, wg);
          }
          wgmma_commit();
          wgmma_wait<1>();
          if (i > 0) release(prev_v);
          prev_v = sv;
        });""",
     """          if (i == 0 || warp_uniform(i < gs)) {
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
          }
        });"""),
    ("""                          (size_t)(slab0 + g * G) * 128 + wg * 64;
#pragma unroll
      for (int c = 0; c < G; ++c) {  // chunk c: the group's columns 128 c + 64 wg ..
""",
     """                          (size_t)(kMaxGroup * g) * 128 + wg * 64;
#pragma unroll
      for (int c = 0; c < G; ++c) {  // chunk c: the group's columns 128 c + 64 wg ..
        if (c >= gs) break;
"""),
)
SLAB_ONE_LAUNCH_HOST = r"""// The clusters of an instantiation that the device holds at once, found
// once per device with the kernel's shared memory raised to the limit (0
// in `fit`: not yet); host threads may launch at once, and each may take
// that first step.
template <bool SINGLE>
cudaError_t clusters_held(int* clusters) {
  static std::atomic<int> fit[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int c = fit[dev & 63].load(std::memory_order_acquire);
  if (c == 0) {
    err = cudaFuncSetAttribute(slab_kernel<SINGLE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
    err = cudaOccupancyMaxActiveClusters(&c, slab_kernel<SINGLE>, &config);
    if (err != cudaSuccess) return err;
    if (c < 1) return cudaErrorInvalidConfiguration;
    fit[dev & 63].store(c, std::memory_order_release);
  }
  *clusters = c;
  return cudaSuccess;
}

// One launch over the head's column groups of at most kMaxGroup slabs (the
// last takes what is left: 640 is 4 + 1), at most as many clusters as the
// device holds at once; the first group writes m and l
template <bool SINGLE>
int launch_groups(const CUtensorMap& qmap, const CUtensorMap& kmap, const CUtensorMap& vmap,
                  const void* seg, void* out, float* res_m, float* res_l, int P, int S, int H,
                  int D, float scale, cudaStream_t stream) {
  int clusters = 0;
  cudaError_t err = clusters_held<SINGLE>(&clusters);
  if (err != cudaSuccess) return (int)err;
  const int ng = (D / 128 + kMaxGroup - 1) / kMaxGroup;
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
  err = cudaLaunchKernelEx(&config, slab_kernel<SINGLE>, qmap, kmap, vmap, (const int32_t*)seg,
                           (__nv_bfloat16*)out, res_m, res_l, P, S, H, D, scale, ng, ns);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, const void* seg, void* out, float* res_m,
           float* res_l, int P, int S, int H, int D, float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!tile_map(&qmap, q, P, S, H, D, 64, kRows) || !tile_map(&kmap, k, P, S, H, D, 64, kShare) ||
      !tile_map(&vmap, v, P, S, H, D, 64, kShare))
    return (int)cudaErrorInvalidValue;
  return S == kKeys ? launch_groups<true>(qmap, kmap, vmap, seg, out, res_m, res_l, P, S, H, D,
                                          scale, stream)
                    : launch_groups<false>(qmap, kmap, vmap, seg, out, res_m, res_l, P, S, H, D,
                                           scale, stream);
}

"""
SLAB_GROUPS_OUTER = ("""  u = r / ng;
  g = r - u * ng;""", """  g = r / tgroups;
  u = r - g * tgroups;""")


def slab_one_launch(text: str, groups_outer: bool = False) -> str:
    """The source with the slab kernel as ``SLAB_ONE_LAUNCH`` makes it."""
    text = patched(text, *SLAB_ONE_LAUNCH)
    start = text.index("// The clusters of an instantiation that the device holds at once")
    end = text.index("}  // namespace slab", start)
    text = text[:start] + SLAB_ONE_LAUNCH_HOST + text[end:]
    return patched(text, SLAB_GROUPS_OUTER) if groups_outer else text


# the slab kernel at heads of 640 (column groups of 3 + 2) and 1,024 (4 + 4)
WIDE_SLAB_VARIANTS = {
    "slab640_as_is": lambda s: s,
    "slab640_one_launch": slab_one_launch,
    "slab640_one_launch_groups_outer": lambda s: slab_one_launch(s, groups_outer=True),
    "slab1024_as_is": lambda s: s,
    "slab1024_one_launch": slab_one_launch,
    "slab1024_one_launch_groups_outer": lambda s: slab_one_launch(s, groups_outer=True),
}
# (heads, width, S, the rerank layout's length before padding) of each family
FAMILIES = {"": (12, 32, 512, 400), "d256_": (3, 256, 512, 400), "slab_": (2, 384, 1024, 992),
            "long_": (12, 32, 1024, 992), "slab640_": (2, 640, 1024, 992),
            "slab1024_": (2, 1024, 1024, 992)}


CHECK_PAIRS = 8  # pairs of each case held to the plain version


def family(name: str) -> str:
    return next((f for f in ("d256_", "slab_", "long_", "slab640_", "slab1024_")
                 if name.startswith(f)), "")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, action="append", default=[], metavar="CSRC",
                        help="csrc/ of an earlier checkout: time its flash_attention.cu too "
                             "(may repeat: parent0, parent1, ...)")
    parser.add_argument("--only", default=None, help="comma-separated variants to build")
    opts = parser.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from financial_rag_system_tpu_torch.ops import _cuda
    from financial_rag_system_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_attention_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    OUT.mkdir(parents=True, exist_ok=True)
    source = SRC.read_text()
    every = {**VARIANTS, **D256_VARIANTS, **SLAB_VARIANTS, **LONG_VARIANTS, **WIDE_SLAB_VARIANTS}
    wanted = opts.only.split(",") if opts.only else list(every)
    cases = {}  # family: its kernel's bf16 q, k, v and masks at its shape
    for fam in dict.fromkeys(family(name) for name in wanted + (list(FAMILIES)
                                                                if opts.parent else [])):
        h, d, s, lr = FAMILIES[fam]
        q, k, v, uniform = cs.attention_inputs(torch, np, cs.PAIRS, s, h, d)
        rerank = np.pad(rerank_layout_mask(np, cs.PAIRS, lr), ((0, 0), (0, s - lr)))
        cases[fam] = (fa.kernel_inputs(q, k, v), {
            "rerank-layout": torch.tensor(rerank, device="cuda"),
            "uniform-length": torch.tensor(uniform, device="cuda")})
        del q, k, v
    builds = {}  # one nvcc a variant, all at once
    for name in wanted:
        src = OUT / f"{name}.cu"
        src.write_text(every[name](source))
        builds[name] = (src, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", f"-I{_cuda.CSRC_DIR}",
             "-o", str(OUT / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    for i, parent in enumerate(opts.parent):
        builds[f"parent{i}"] = (None, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", f"-I{parent}",
             "-o", str(OUT / f"parent{i}.so"), str(parent / "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    kernels = {"": "12flash_kernelILi32E", "d256_": "flash256_kernel",
               "slab_": "11slab_kernelILi3ELb0E", "long_": "11long_kernel", "slab640_": "11slab_kernel",
               "slab1024_": "11slab_kernel"}
    logs, failed = {}, False
    for name, (_, proc) in builds.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            print(f"[variants] {name}: build failed\n{log}", flush=True)
            failed = True
        else:
            logs[name] = log
    runs = [(name, fam) for name in logs
            for fam in (list(cases) if name.startswith("parent") else [family(name)])]
    times, errs = {}, {}  # (name, family, mask): ms of each pass; max_abs_err
    # every build timed twice, in order and then in reverse (in turns)
    for seq in (runs, runs[::-1]):
        for name, fam in seq:
            d = FAMILIES[fam][1]
            (qb, kb, vb), masks = cases[fam]
            with cs.kernel_lib("flash_attention", ctypes.CDLL(str(OUT / f"{name}.so"))):
                for label, mask in masks.items():
                    times.setdefault((name, fam, label), []).append(cs.median_ms(
                        lambda: fa.flash_attention_kernel(qb, kb, vb, mask, d ** -0.5), reps=20))
                    if (name, fam, label) in errs:
                        continue
                    # the context of the first pairs against the plain version's
                    few = [t[:CHECK_PAIRS].contiguous() for t in (qb, kb, vb, mask)]
                    got = fa.flash_attention_kernel(*few, d ** -0.5).float()
                    ref = fa.flash_attention_plain(*(t.float() for t in few[:3]), few[3],
                                                   d ** -0.5)
                    errs[name, fam, label] = float((got.reshape(ref.shape) - ref).abs().max())
    for name, fam in runs:
        h, d, s, _ = FAMILIES[fam]
        log = logs[name]
        regs = {kern: r for kern, r in cs.ptxas_kernels(log).items() if kernels[fam] in kern}
        # ptxas's notes that it serialised a kernel's wgmmas (C7510-C7520)
        serial = sorted({re.search(r"\((C75\d\d)\)", line).group(1) for line in log.splitlines()
                         if kernels[fam] in line and re.search(r"\(C75\d\d\).*serialized", line)})
        print(f"[variants] {smi}: {name}, P {cs.PAIRS} S {s} {h} heads of {d}: " + ", ".join(
            f"{label} {' / '.join(f'{ms:.4f}' for ms in times[name, fam, label])} ms "
            f"(max_abs_err {errs[name, fam, label]:.3g} over {CHECK_PAIRS} pairs)"
            for label in cases[fam][1])
            + f"; ptxas (registers, spill store and load bytes) {regs}, wgmma serialised "
            f"{serial or 'no'}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
