"""Time variants of the pair-attention kernel (kernel 2) on one NVIDIA GPU.

    python3 financial_rag_system_tpu_torch/tools/pair_attention_variants.py [--parent CSRC]
                                                                            [--only a,b]

Builds copies of ``financial_rag_system_tpu_torch/csrc/pair_attention.cu``
with one constant changed or one part cut out, and times each beside the
kernel as it is at the rerank shape (P 480, S 400) at 12 heads of 32 (the
persistent kernel), 12 of 64 and 6 of 128 (the ring kernel), each with
every key valid, on ``chip_smoke.py``'s uniform-length mask and on a
rerank-layout mask (query tokens, a hole up to 32, document tokens); the
``long_`` variants at phase 15 (a)'s shape instead (below).  All in one
process on one card.  A variant with a part cut out computes a wrong
context: its time says what that part costs.  Variants at S 400:

- ``as_is``: the kernel as the port builds it;
- ``consumers_2``, ``consumers_3``, ``consumers_5``: other counts of the
  persistent kernel's consumer warpgroups;
- ``no_mufu``: ex2.approx replaced by the identity (no MUFU work), in both
  kernels;
- ``no_sweep1``: the persistent kernel's row-max sweep cut out;
- ``no_tiles``: the persistent kernel with no attention at all, only the
  loads and the bookkeeping;
- ``long_pair_at_400``: heads of 32 on the long-pair kernel in place of
  the persistent kernel;
- ``ring_keys_64``: the ring kernel with 64-key stages (QK^T on wgmma
  m64n64k16, more stages);
- ``ring_wg2``: the ring kernel at d 64 with two consumer warpgroups (232
  registers a thread) in place of three (152);
- ``ring_no_pv``: the ring kernel's P.V cut out;
- ``ring_no_rescale``: the ring kernel's context not rescaled by alpha;
- ``ring_pv_mma``: the ring kernel's P.V on ``mma.sync`` m16n8k16, P
  straight from the QK^T accumulator and V's fragments by
  ``ldmatrix.trans``, in place of ``wgmma`` with V as an MN-major operand;
- ``persist_min_blocks``: the persistent kernel's launch bounds with a
  minimum of one block an SM: what it does to its registers and spills.

The long-pair kernel (``longpair::long_pair_kernel``, heads of 32 above S
512), the ``long_`` variants, at phase 15 (a)'s shape: P 480, S 992, 12
heads of 32, on its document-length mask (query tokens, a hole up to 32,
a document of 480-960 tokens: ``doc_length_mask``) and on the
rerank-layout mask of S 400 stretched to 992 (``chip_smoke.stretch_mask``):

- ``long_as_is``: the kernel as the port builds it (four consumer
  warpgroups of one row tile, 64-key steps, the sums against a column of
  ones, the 64-key tail);
- ``long_no_mufu``: ex2.approx replaced by the identity (no MUFU work);
- ``long_no_pv``: P.V cut out (the probs still packed, and summed);
- ``long_no_rescale``: the contexts not rescaled by alpha;
- ``long_loads_only``: the consumers compute nothing (the producer's
  staging and the barriers alone);
- ``long_units_3``: three consumer warpgroups (160 registers), units of
  three;
- ``long_two_tiles``: two consumer warpgroups of two row tiles each (240
  registers), the two tiles' softmaxes and P.V interleaved step by step
  in a warp; ``long_two_tiles_fadd``: the same with ``long_fadd_sums``'s
  and ``long_steps_128``'s changes;
- ``long_fadd_sums``: each row's sum by FADD, four chains a lane, in
  place of the ones column;
- ``long_steps_128``: each 128-key block one online-softmax step (QK^T on
  wgmma m64n128k16, 64 f32 of scores a thread);
- ``long_overlap``: both 64-key steps' QK^T of a block issued together,
  the second in flight while the first step's softmax and P.V run;
- ``long_no_tail``: the block holding kend always 128 keys;
- ``long_lazy``: the contexts rescaled only where a row max of the warp
  moved (exact: alpha is 1 everywhere else);
- ``long_stagger``: consumer warpgroup w starts 0.5 w us late, once;
- ``long_turns``: FA3's ping-pong for four warpgroups: each issues a
  step's QK^T in its turn on named barriers, so that one's softmax runs
  while the others' products are on the tensor cores;
- ``long_pv_wgmma``: P.V on ``wgmma`` m64n32k16 (P's A fragments from
  registers, V MN-major) after the step's softmax, in place of
  ``mma.sync`` piece by piece;
- ``long_exp2_poly``: one probability in eight (the last of each thread's
  16-key piece) as 2^x on the FMA pipe (Cody-Waite reduction and a
  degree-3 polynomial, 8.6e-5 relative), the rest on MUFU.

``--parent CSRC`` also times an earlier checkout's ``pair_attention.cu``
(its ``pair_attention`` at heads of 32, its streaming
``pair_attention_wide`` at 64 and 128 where it has one) at both shapes.
Every build is launched by its C entry alone
(``chip_smoke.attention_launcher``).  Each line gives the build's median
time (CUDA events, 20 launches) at each width and mask, twice: every
build is timed in order and then in reverse order (in turns); its largest
difference from the plain version (at the long shape over its first 8
pairs, at atol 1e-2 + rtol 1e-2); its kernels' registers (before
``setmaxnreg``) and spills as ``ptxas -v`` reports them, and the card's
name and power limit.  A build that fails is reported and the rest are
timed (exit status 1).  The variants build in parallel, into
``build/pair_attention_variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

SRC = Path(__file__).resolve().parents[1] / "csrc" / "pair_attention.cu"
OUT = REPO / "build" / "pair_attention_variants"


def patched(text: str, *pairs: tuple[str, str]) -> str:
    for old, new in pairs:
        if old not in text:
            raise RuntimeError(f"pair_attention.cu no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    return text


def consumers(n: int):
    return lambda s: patched(s, ("constexpr int kConsumers = 4;", f"constexpr int kConsumers = {n};"))


SWEEP1 = """  for (int c = 0; c < tl.nck; ++c) {
    qk(acc, qs, tl, c);
    chunk_max(m, acc, tl, c, t);
  }
"""
RING_PV = """  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    wgmma_rs_mn(acc, pa[kk], wgmma_desc_mn<C::kRowB>(vs + kk * 16 * C::kRowB, C::kKChunk), 1u);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin(acc);
"""
# the P.V cut out, its probs still packed and used (a wgmma must not sit
# under a branch that differs between the warpgroup's threads)
NO_PV = """#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) acc[kk] += __uint_as_float(pa[kk][0] ^ pa[kk][3]);
"""
RESCALE = "    for (int e = 0; e < 4; ++e) r.o[dn][e] *= alpha[e >> 1];"
# the ring kernel's wgmma P.V, from its comment to the end of attend(),
# and the mma.sync P.V that ring_pv_mma puts in its place: P straight from
# the QK^T accumulator as m16n8k16 A fragments, V's B fragments by
# ldmatrix.trans from the swizzled stage
PV_WGMMA_START = "  // P.V on wgmma m64n<D>k16, one a 16-key step: P's A fragments from"
PV_WGMMA_END = "  wgmma_pin(acc);\n}\n"
PV_MMA = """  const int mi = lane >> 3;
  const int key = (lane & 7) + 8 * (mi & 1);
  const int swh = (C::kRowB == 64 ? (key >> 1) & 3 : key & 7) ^ (mi >> 1);
  const unsigned char* vrow = vs + key * C::kRowB;
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(s[8 * kk], s[8 * kk + 1]), pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                            pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                            pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
#pragma unroll
    for (int g0 = 0; g0 < D / 8; g0 += 2) {
      const int chunk = g0 / (C::kCw / 8), gl = g0 % (C::kCw / 8);
      uint32_t vf[4];
      ldsm_x4_trans(vf, vrow + chunk * C::kKChunk + 16 * kk * C::kRowB + ((gl ^ swh) << 4));
      mma_bf16(r.o[g0], pa, vf[0], vf[1]);
      mma_bf16(r.o[g0 + 1], pa, vf[2], vf[3]);
    }
  }
}
"""


def pv_mma(text: str) -> str:
    start = text.index(PV_WGMMA_START)
    end = text.index(PV_WGMMA_END, start) + len(PV_WGMMA_END)
    return text[:start] + PV_MMA + text[end:]


RING_KEYS_64 = ("constexpr int kKeys = 128;  // keys of a stage", "constexpr int kKeys = 64;  // keys")
RING_WG2 = (("static constexpr int kWg = D == 128 ? 2 : 3;", "static constexpr int kWg = D == 32 ? 3 : 2;"),
            ("static constexpr int kConsumerRegs = D == 128 ? 232 : 152;",
             "static constexpr int kConsumerRegs = D == 32 ? 152 : 232;"))
VARIANTS = {
    "as_is": lambda s: s,
    "consumers_2": consumers(2),
    "consumers_3": consumers(3),
    "consumers_5": consumers(5),
    "no_mufu": lambda s: patched(
        s, ('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x;")),
    "no_sweep1": lambda s: patched(s, (SWEEP1, "  m[0] = m[1] = 0.f;\n")),
    "no_tiles": lambda s: patched(
        s, ("      attend_tile(my_q + b * kQBytes, tl, out, base, tok, S, rw, lane);",
            "      if (my_q[b * kQBytes] == 0x7fu) out[rw] = __float2bfloat16(1.f);")),
    "long_pair_at_400": lambda s: patched(
        s, ("      return S <= kMaxS ? launch_persistent(q, k, v, mask, out, P, S, H, stream)",
            "      return false ? launch_persistent(q, k, v, mask, out, P, S, H, stream)")),
    "ring_keys_64": lambda s: patched(s, RING_KEYS_64),
    "ring_wg2": lambda s: patched(s, *RING_WG2),
    "ring_no_pv": lambda s: patched(s, (RING_PV, NO_PV)),
    "ring_no_rescale": lambda s: patched(s, (RESCALE, "    for (int e = 0; e < 4; ++e);")),
    "ring_pv_mma": pv_mma,
    "persist_min_blocks": lambda s: patched(
        s, ("__global__ void __launch_bounds__(kThreads)\npair_attention_kernel(",
            "__global__ void __launch_bounds__(kThreads, 1)\npair_attention_kernel(")),
}
WIDTHS = ((12, 32), (12, 64), (6, 128))  # (heads, head width) at P 480, S 400

# -- the long-pair kernel's variants (namespace longpair) --------------------------

LP = "namespace longpair {"


def in_longpair(text: str, *pairs: tuple[str, str]) -> str:
    """``patched`` on the longpair namespace alone."""
    start = text.index(LP)
    end = text.index("}  // namespace longpair", start)
    return text[:start] + patched(text[start:end], *pairs) + text[end:]


PV_BODY = """    ldsm_x4_trans(vf, vrow + 16 * kk * kRowB + (((2 * half) ^ swh) << 4));
    mma_bf16(*reinterpret_cast<float(*)[4]>(acc + 8 * half), pa, vf[0], vf[1]);
    mma_bf16(*reinterpret_cast<float(*)[4]>(acc + 8 * half + 4), pa, vf[2], vf[3]);
"""
RESCALE_AB = """    a.acc[i] *= ala[(i >> 1) & 1];
    if constexpr (TWO) b.acc[i] *= alb[(i >> 1) & 1];
"""
RESCALE_LOOP = "#pragma unroll\n  for (int i = 0; i < D / 2; ++i) {\n" + RESCALE_AB + "  }\n"
LP_BLOCKS = "      if (has_a) {\n        const unsigned char* ks = kv + (size_t)s * 2 * kKvBytes;"
LP_CONSUMER = "  setmaxnreg_inc<kConsumerRegs>();\n"
STEPS = """        step<kStep>(a, b, has_b, qa, qb, ks, ks + kKvBytes, h.bias, whole, lane);
        if (warp_uniform(h.keys == kKeys))
          step<kStep>(a, b, has_b, qa, qb, ks + kStep * kRowB, ks + kKvBytes + kStep * kRowB,
                      h.bias + kStep, whole, lane);"""
# a 128-key block as one online-softmax step (64 f32 of scores a thread)
STEPS_128 = """        if (warp_uniform(h.keys == kKeys)) {
          step<kKeys>(a, b, has_b, qa, qb, ks, ks + kKvBytes, h.bias, whole, lane);
        } else {
          step<kStep>(a, b, has_b, qa, qb, ks, ks + kKvBytes, h.bias, whole, lane);
        }"""
STEP_LOOP = """  float oa[4] = {}, ob[4] = {};
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t pa[4], pb[4];
    exp_step(sa, kk, nma, pa);
    if constexpr (TWO) exp_step(sb, kk, nmb, pb);
    pv_step(a.acc, oa, pa, vrow, swh, kk);
    if constexpr (TWO) pv_step(b.acc, ob, pb, vrow, swh, kk);
  }
"""
L_UPDATE = """    a.l[hh] = fmaf(a.l[hh], ala[hh], oa[2 * hh]);
    if constexpr (TWO) b.l[hh] = fmaf(b.l[hh], alb[hh], ob[2 * hh]);
"""
# each row's sum by FADD, four chains a lane (the quad's lanes' shares
# added at the end), in place of the ones column
FADD_SUMS = (
    ("""__device__ __forceinline__ void exp_step(float (&s)[N], int kk, const float (&nml)[2],
                                         uint32_t (&pa)[4]) {""",
     """__device__ __forceinline__ void exp_step(float (&s)[N], int kk, const float (&nml)[2],
                                         float (&ls)[2][4], uint32_t (&pa)[4]) {"""),
    ("    x = ex2(fmaf(x, kLog2e, nml[(e >> 1) & 1]));\n",
     "    x = ex2(fmaf(x, kLog2e, nml[(e >> 1) & 1]));\n"
     "    ls[(e >> 1) & 1][(e & 1) | ((e >> 1) & 2)] += x;\n"),
    ("  mma_bf16(sum, pa, kOnes, kOnes);\n", ""),
    (STEP_LOOP, STEP_LOOP.replace("float oa[4] = {}, ob[4] = {};",
                                  "float oa[4], ob[4], lsa[2][4] = {}, lsb[2][4] = {};")
     .replace("exp_step(sa, kk, nma, pa)", "exp_step(sa, kk, nma, lsa, pa)")
     .replace("exp_step(sb, kk, nmb, pb)", "exp_step(sb, kk, nmb, lsb, pb)")),
    (L_UPDATE, """    a.l[hh] = fmaf(a.l[hh], ala[hh], (lsa[hh][0] + lsa[hh][1]) + (lsa[hh][2] + lsa[hh][3]));
    if constexpr (TWO)
      b.l[hh] = fmaf(b.l[hh], alb[hh], (lsb[hh][0] + lsb[hh][1]) + (lsb[hh][2] + lsb[hh][3]));
"""),
    ("  const float inv_a = 1.f / r.l[0], inv_b = 1.f / r.l[1];",
     "  const float inv_a = 1.f / quad_sum(r.l[0]), inv_b = 1.f / quad_sum(r.l[1]);"))
UNITS_3 = (("constexpr int kWg = 4;", "constexpr int kWg = 3;"),
           ("constexpr int kConsumerRegs = 112;", "constexpr int kConsumerRegs = 160;"),
           ("smem_bytes(kStages) == 169280", "smem_bytes(kStages) == 161072"))
TWO_TILES = (("constexpr int kWg = 4;", "constexpr int kWg = 2;"),
             ("constexpr int kTiles = 1;", "constexpr int kTiles = 2;"),
             ("constexpr int kConsumerRegs = 112;", "constexpr int kConsumerRegs = 240;"),
             ("smem_bytes(kStages) == 169280", "smem_bytes(kStages) == 169248"))
# the contexts rescaled only where a row max of the warp moved (alpha 1
# everywhere else: skipping it changes no bit)
LAZY = ((RESCALE_LOOP,
         "  if (__any_sync(0xffffffffu, ala[0] != 1.f || ala[1] != 1.f ||\n"
         "                            (TWO && (alb[0] != 1.f || alb[1] != 1.f)))) {\n"
         + RESCALE_LOOP + "  }\n"),)
# FA3's ping-pong for four warpgroups: warpgroup w waits for its turn
# (barrier 5 + w) before issuing a step's QK^T and hands the turn to w +
# 1 after; the last hands the first its first turn; every warpgroup takes
# its turns also where it has no tile
TURNS_HELPER = """__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");
}

// One step of NK keys (K at ks"""
TURNS = (
    ("// One step of NK keys (K at ks", TURNS_HELPER),
    ("                                     const unsigned char* vs, const float* bias, bool full,\n"
     "                                     int lane) {",
     "                                     const unsigned char* vs, const float* bias, bool full,\n"
     "                                     int lane, int wg) {"),
    ("  wgmma_fence();\n  qk_issue<NK>(sa, qa, ks);",
     "  named_barrier(5 + wg, 256);\n  wgmma_fence();\n  qk_issue<NK>(sa, qa, ks);"),
    ("  wgmma_commit();\n  wgmma_wait<0>();\n  wgmma_pin(sa);",
     "  wgmma_commit();\n  bar_arrive(5 + (wg + 1) % kWg, 256);\n  wgmma_wait<0>();\n"
     "  wgmma_pin(sa);"),
    (STEPS, STEPS.replace("whole, lane);", "whole, lane, wg);")
     .replace("if (warp_uniform(h.keys == kKeys))",
              "if (warp_uniform(h.keys == kKeys)) {").replace(
         "h.bias + kStep, whole, lane, wg);",
         "h.bias + kStep, whole, lane, wg);\n        } else {\n"
         "          named_barrier(5 + wg, 256);\n          bar_arrive(5 + (wg + 1) % kWg, 256);\n"
         "        }")),
    ("      }\n      __syncwarp();\n      if (lane == 0) mbar_arrive(&empty[s]);",
     "      } else {\n        for (int u = 0; u < h.keys / kStep; ++u) {\n"
     "          named_barrier(5 + wg, 256);\n          bar_arrive(5 + (wg + 1) % kWg, 256);\n"
     "        }\n      }\n"
     "      __syncwarp();\n      if (lane == 0) mbar_arrive(&empty[s]);"),
    ("  if (leader && positions > 0) load_q(0, 0);\n  int n = 0;  // stages passed",
     "  if (leader && positions > 0) load_q(0, 0);\n  if (wg == kWg - 1) bar_arrive(5, 256);\n"
     "  int n = 0;  // stages passed"))
PV_WGMMA = ((STEP_LOOP, """  float oa[4] = {}, ob[4] = {};
  constexpr uint32_t kOnes = 0x3f803f80u;  // two bf16 1.0
  uint32_t pa[NK / 16][4], pb[NK / 16][4];
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    exp_step(sa, kk, nma, pa[kk]);
    mma_bf16(oa, pa[kk], kOnes, kOnes);
    if constexpr (TWO) {
      exp_step(sb, kk, nmb, pb[kk]);
      mma_bf16(ob, pb[kk], kOnes, kOnes);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
    wgmma_rs_mn(a.acc, pa[kk], wgmma_desc_mn<kRowB>(vs + kk * 16 * kRowB, kKvBytes), 1u);
  if constexpr (TWO) {
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
      wgmma_rs_mn(b.acc, pb[kk], wgmma_desc_mn<kRowB>(vs + kk * 16 * kRowB, kKvBytes), 1u);
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin(a.acc);
  if constexpr (TWO) wgmma_pin(b.acc);
"""), ("  int swh;\n  const unsigned char* vrow = v_lane(vs, lane, swh);\n", ""))
# 2^x on the FMA pipe: x = j + f, j = floor(x) (clamped at -127: 2^-127
# or less is taken as the denormal it gives), 2^f by a degree-3
# polynomial on [0, 1) (8.6e-5 relative), j added to its exponent
EXP2_POLY = (("// the probs of 16-key step kk", """__device__ __forceinline__ float ex2_fma(float x) {
  x = fmaxf(x, -127.f);
  const float j = floorf(x);
  const float f = x - j;
  const float p = fmaf(fmaf(fmaf(0.07705726f, f, 0.22765566f), f, 0.69511443f), f, 1.f);
  return __int_as_float(__float_as_int(p) + (int)j * (1 << 23));
}

// the probs of 16-key step kk"""), ("    x = ex2(fmaf(x, kLog2e, nml[(e >> 1) & 1]));",
                                    "    x = e == 7 ? ex2_fma(fmaf(x, kLog2e, nml[(e >> 1) & 1]))\n"
                                    "               : ex2(fmaf(x, kLog2e, nml[(e >> 1) & 1]));"))

# both 64-key steps' QK^T of a block issued together (a tail's second
# reads the stage's other keys and goes unread), the second in flight
# while the first step's softmax and P.V run
OVERLAP = ((STEPS, """        float s0[kStep / 2], s1[kStep / 2];
        wgmma_fence();
        qk_issue<kStep>(s0, qa, ks);
        wgmma_commit();
        qk_issue<kStep>(s1, qa, ks + kStep * kRowB);
        wgmma_commit();
        wgmma_wait<1>();
        wgmma_pin(s0);
        attend<kStep, false>(a, s0, b, s0, h.bias, whole, lane, ks + kKvBytes);
        wgmma_wait<0>();
        wgmma_pin(s1);
        if (warp_uniform(h.keys == kKeys))
          attend<kStep, false>(a, s1, b, s1, h.bias + kStep, whole, lane,
                               ks + kKvBytes + kStep * kRowB);"""),)


LONG_VARIANTS = {
    "long_as_is": lambda s: s,
    "long_overlap": lambda s: in_longpair(s, *OVERLAP),
    "long_no_mufu": lambda s: patched(
        s, ('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x;")),
    "long_no_pv": lambda s: in_longpair(
        s, (PV_BODY, "    acc[half] += __uint_as_float(pa[0] ^ pa[3]);\n")),
    "long_no_rescale": lambda s: in_longpair(s, (RESCALE_AB, "    ;\n")),
    "long_loads_only": lambda s: in_longpair(
        s, (LP_BLOCKS, LP_BLOCKS.replace("if (has_a) {", "if (has_a && gridDim.y == 7u) {"))),
    "long_units_3": lambda s: in_longpair(s, *UNITS_3),
    "long_two_tiles": lambda s: in_longpair(s, *TWO_TILES),
    "long_two_tiles_fadd": lambda s: in_longpair(s, *TWO_TILES, *FADD_SUMS, (STEPS, STEPS_128)),
    "long_fadd_sums": lambda s: in_longpair(s, *FADD_SUMS),
    "long_steps_128": lambda s: in_longpair(s, (STEPS, STEPS_128)),
    "long_no_tail": lambda s: in_longpair(
        s, ("const bool tail = kend > 0 &&", "const bool tail = false && kend > 0 &&")),
    "long_lazy": lambda s: in_longpair(s, *LAZY),
    "long_stagger": lambda s: in_longpair(
        s, (LP_CONSUMER, LP_CONSUMER + "  __nanosleep(500 * (warp >> 2));\n")),
    "long_turns": lambda s: in_longpair(s, *TURNS),
    "long_pv_wgmma": lambda s: in_longpair(s, *PV_WGMMA),
    "long_exp2_poly": lambda s: in_longpair(s, *EXP2_POLY),
}
LONG_SHAPE = (480, 992, 12, 32)  # phase 15 (a): P, S, heads, head width
CHECK_PAIRS = 8  # pairs of the long shape held to the plain version


def doc_length_mask(np, p: int, s: int, lq: int = 32, lo: int = 480, seed: int = 0):
    """Phase 15 (a)'s pairs: query tokens (3 to ``lq``), a hole up to
    ``lq``, then a document of ``lo`` to ``s - lq`` tokens."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((p, s), np.int32)
    for i in range(p):
        mask[i, :rng.integers(3, lq + 1)] = 1
        mask[i, lq:lq + rng.integers(lo, s - lq + 1)] = 1
    return mask


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None, metavar="CSRC",
                        help="csrc/ of an earlier checkout: time its pair_attention.cu too")
    parser.add_argument("--only", default=None, help="comma-separated variants to build")
    opts = parser.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from financial_rag_system_tpu_torch.ops import _cuda
    from financial_rag_system_tpu_torch.ops import attention as attn
    from financial_rag_system_tpu_torch.tools.flash_attention_variants import rerank_layout_mask

    if not torch.cuda.is_available():
        print("pair_attention_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    OUT.mkdir(parents=True, exist_ok=True)
    source = SRC.read_text()
    every = {**VARIANTS, **LONG_VARIANTS}
    wanted = opts.only.split(",") if opts.only else list(every)
    fams = {"long" if name.startswith("long_") and name != "long_pair_at_400" else "s400"
            for name in wanted}
    if opts.parent is not None:
        fams |= {"s400", "long"}
    cases = {}  # (family, width, mask label): the wrapper's padded inputs and the mask
    plain = {}  # (family, width): the plain version's context on the family's checked mask
    if "s400" in fams:
        for h, d in WIDTHS:
            q, k, v, uniform = cs.attention_inputs(torch, np, cs.PAIRS, 400, h, d)
            qs, kb, vb = attn.kernel_inputs(q, k, v, 1.0 / d ** 0.5)
            for label, mask in (("all-valid", np.ones_like(uniform)), ("uniform-length", uniform),
                                ("rerank-layout", rerank_layout_mask(np, cs.PAIRS, 400))):
                cases[("s400", d, label)] = (qs, kb, vb, torch.tensor(mask, device="cuda"))
            mask = cases[("s400", d, "rerank-layout")][3]
            plain["s400", d] = attn.encoder_self_attention_plain(q, k, v, mask, 1.0 / d ** 0.5).view(
                cs.PAIRS, 400, h, d).to(torch.bfloat16)
            del q, k, v
    if "long" in fams:
        p, s, h, d = LONG_SHAPE
        q, k, v, _ = cs.card_inputs(torch, np, p, s, h, d)
        qs, kb, vb = attn.kernel_inputs(q, k, v, 1.0 / d ** 0.5)
        stretched = cs.stretch_mask(np, rerank_layout_mask(np, p, 400), s, 32)
        for label, mask in (("phase-15-a", doc_length_mask(np, p, s)),
                            ("stretched-rerank", stretched)):
            cases[("long", d, label)] = (qs, kb, vb, torch.tensor(mask, device="cuda"))
        mask = cases[("long", d, "phase-15-a")][3][:CHECK_PAIRS]
        plain["long", d] = attn.encoder_self_attention_plain(
            q[:CHECK_PAIRS], k[:CHECK_PAIRS], v[:CHECK_PAIRS], mask, 1.0 / d ** 0.5).view(
            CHECK_PAIRS, s, h, d).to(torch.bfloat16)
        del q, k, v
    builds = {}  # one nvcc a variant, all at once
    for name in wanted:
        src = OUT / f"{name}.cu"
        src.write_text(every[name](source))
        builds[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", f"-I{_cuda.CSRC_DIR}",
             "-o", str(OUT / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    if opts.parent is not None:
        builds["parent"] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", f"-I{opts.parent}",
             "-o", str(OUT / "parent.so"), str(opts.parent / "pair_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    logs, failed = {}, False
    for name, proc in builds.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            print(f"[variants] {name}: build failed\n{log}", flush=True)
            failed = True
        else:
            logs[name] = log

    def family(name):
        if name == "parent":
            return ("s400", "long")
        return ("long",) if name.startswith("long_") and name != "long_pair_at_400" else ("s400",)

    runs = [(name, key) for name in logs for key in cases if key[0] in family(name)]
    times, errs = {}, {}  # (name, case): ms of each pass; (name, family, width): max_abs_err
    for seq in (runs, runs[::-1]):  # every build timed in order, then in reverse
        for name, key in seq:
            qs, kb, vb, mask = cases[key]
            fam, d, label = key
            lib = ctypes.CDLL(str(OUT / f"{name}.so"))
            times.setdefault((name, key), []).append(
                cs.median_ms(cs.attention_launcher(torch, lib, qs, kb, vb, mask), reps=20))
            checked = "phase-15-a" if fam == "long" else "rerank-layout"
            if label != checked or (name, fam, d) in errs:
                continue
            n = CHECK_PAIRS if fam == "long" else qs.shape[0]
            few = [t[:n].contiguous() for t in (qs, kb, vb, mask)]
            got = cs.attention_launcher(torch, lib, *few)().float()
            ref = plain[fam, d].float()
            errs[name, fam, d] = (float((got - ref).abs().max()),
                                  float(((got - ref).abs() - 1e-2 * ref.abs()).max()))
    for name in logs:
        for fam in family(name):
            keys = [key for key in cases if key[0] == fam]
            print(f"[variants] {smi}: {name}, " + ", ".join(
                f"{'S 992' if fam == 'long' else 'S 400'} d {d} {label} "
                f"{' / '.join(f'{ms:.4f}' for ms in times[name, (fam, d, label)])} ms"
                for (_, d, label) in keys)
                + "; max abs diff from the plain version "
                + ", ".join(f"d {d} {errs[name, fam, d][0]:.3g} (beyond rtol 1e-2: "
                            f"{errs[name, fam, d][1]:.3g})"
                            for d in dict.fromkeys(d for _, d, _ in keys))
                + f"; ptxas (registers, spill store and load bytes) "
                f"{cs.ptxas_kernels(logs[name])}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
