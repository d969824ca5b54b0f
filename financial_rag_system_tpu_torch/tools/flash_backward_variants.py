"""Time variants of the flash attention's backward (kernels 8 and 9) on one NVIDIA GPU.

    python3 financial_rag_system_tpu_torch/tools/flash_backward_variants.py [--parent CSRC]
                                                                             [--only a,b]
                                                                             [--width D]

Builds copies of ``financial_rag_system_tpu_torch/csrc/flash_attention_bwd.cu``
with one constant changed, one part redone or one part cut out, and times
both C entries of each (``flash_attention_bwd_dkv``, kernel 8, and
``flash_attention_bwd_dq``, kernel 9) at the cross-encoder trainer's shape
(B 32, S 512, 12 heads of 32) on its first batch's mask
(``chip_smoke.first_batch``), every build in order and then in reverse,
in one process on one card, CUDA events and device time (profiler).  A
variant with a part cut out computes wrong gradients: its time says what
that part costs.  Each build's gradients are held to the kernel as it is
(the largest difference over the largest magnitude).  Variants of the
unit kernel (``unit::walk_kernel``, heads of 32, the default ``--width
32``):

- ``as_is``: the kernel as the port builds it (units of four own tiles,
  112 registers a consumer thread; dK/dV walking 32-row blocks in sixteen
  stages, dQ 64-row blocks in eight; the producer's four warps taking
  every fourth block);
- ``unit_2``, ``unit_3``: units of two (232 registers) or three (160)
  own tiles in both kernels, one a consumer warpgroup;
- ``walk_64``: dK/dV on 64-row walked blocks too (at units of four: it
  spills); ``walk_64_units_3_4``: 64-row blocks in both, units of three
  for dK/dV (the first timed form); ``walk_32_both``: 32-row blocks in
  both; ``stages_8``: eight stages of 32-row blocks for dK/dV, not
  sixteen;
- ``overlap``: each block's gradient products left in flight while the
  next block's S and dP are issued, one wait retiring both (the step
  split in two and the walk replaced: ``OVERLAP_FUNCS``,
  ``OVERLAP_LOOP``);
- ``one_producer``: one producer warp takes every block (its loads of the
  rows' values wait in one chain); ``producer_64_rows``: each producer
  warp takes 64 rows of blocks at a time (two 32-row blocks for dK/dV:
  one load wait for both; ``PRODUCE_64_ROWS`` in place of the producer);
- ``rows_128``: walked blocks of 128 rows (S and dP on ``wgmma``
  m64n128k16, the gradient products eight 16-row steps), units of two;
- ``dp_first``: S and dP committed as two groups, p made while dP is in
  flight, then dS (FA3's order), in place of both waited together;
- ``no_mufu``: ex2.approx replaced by the identity (no MUFU work);
- ``no_grads``: the gradient products (dV, dK or dQ) cut out;
- ``no_ss``: S and dP cut out (the scores from the lane);
- ``one_cta_item``: one block an item (S <= 512) computing dK, dV and
  dQ in one pass (``ONE_CTA_ITEM``, its own C entry
  ``flash_attention_bwd_fused``, timed against the two entries' sum);
- ``loads_only``: the consumers compute nothing (the producer's staging,
  the own tiles' loads and the barriers alone).

With ``--width D`` (128 or wider) the case is H D 768 (B 32, S 512, the
same mask) and the variants are the wide kernel's (``wide::wide_kernel``):

- ``as_is``: the kernel as the port builds it (clusters of two blocks,
  each walked block multicast to both; each block's S and dP, p and dS
  and gradient products in turn);
- ``pipelined``: block ob + 1's S and dP issued before block ob's
  gradient products, which run while ob + 1's p and dS are made;
- ``no_cluster``: clusters of one block (each walked block read from L2
  once a tile, not multicast);
- ``walk_32``: 32-row walked blocks above heads of 128 (four stages at
  256);
- ``no_mufu``, ``no_grads``, ``no_ss``, ``loads_only``: as above, cut out
  of the wide kernel.

``--parent CSRC`` also times an earlier checkout's
``flash_attention_bwd.cu`` (may repeat: parent0, parent1, ...).  It prints
``ptxas -v``'s registers and spills of each build's heads-of-32 kernels
and ptxas's notes where it serialised their ``wgmma``s.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
SRC = Path(__file__).resolve().parents[1] / "csrc" / "flash_attention_bwd.cu"
OUT = REPO / "build" / "flash_backward_variants"
UNIT = "namespace unit {"


def patched(text: str, *pairs: tuple[str, str]) -> str:
    """``text`` with each (old, new) replaced inside the unit kernel's
    namespace; raises if an old string is not there."""
    head, body = text[:text.index(UNIT)], text[text.index(UNIT):]
    for old, new in pairs:
        if old not in body:
            raise ValueError(f"patch anchor not found: {old[:60]!r}")
        body = body.replace(old, new)
    return head + body


# the static_assert that pins the shipped plan's numbers
PIN = re.compile(r"static_assert\(sizeof\(Head<64>\) == 1296.*?\);\n", re.S)


def unpinned(text: str) -> str:
    if not PIN.search(text):
        raise ValueError("the pinned static_assert is not there")
    return PIN.sub("", text)


UNIT_LINE = "static constexpr int kUnit = D == 32 ? 4 : 2;"
WALK_LINE = "static constexpr int kWalk = D == 32 && DKV ? 32 : 64;"


def unit(n: int):
    return lambda t: unpinned(patched(t, (UNIT_LINE, f"static constexpr int kUnit = D == 32 ? "
                                                     f"{n} : 2;")))


SS_START = """  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(x,"""
ELEMENTWISE_START = "  // p = ex2(s c2 - m log2e) (1 / l), 0 where the ids differ, into x;"
PACK_START = "  // bf16(p) and bf16(dS) as A fragments of the gradient products, a"
GRADS_START = "  // the stage's blocks as MN-major B: rows are the product's K, 8 rows an"
GRADS_END = "  if constexpr (DKV) wgmma_pin(gb);\n}\n"

DP_FIRST_ELEMENTWISE = """  // p into x while dP is in flight
#pragma unroll
  for (int j = 0; j < C::kWalk / 8; ++j) {
    if constexpr (DKV) {
      const float4 ra = h.rows[8 * j + 2 * t], rb = h.rows[8 * j + 2 * t + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float& xa = x[4 * j + 2 * hh];
        float& xb = x[4 * j + 2 * hh + 1];
        xa = __float_as_int(ra.w) == own.seg[hh] ? ex2(fmaf(xa, c2, -ra.x)) * ra.y : 0.f;
        xb = __float_as_int(rb.w) == own.seg[hh] ? ex2(fmaf(xb, c2, -rb.x)) * rb.y : 0.f;
      }
    } else {
      const int2 kid = *reinterpret_cast<const int2*>(h.ids + 8 * j + 2 * t);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float nm = -own.m2[hh];
        x[4 * j + 2 * hh] = kid.x == own.seg[hh] ? ex2(fmaf(x[4 * j + 2 * hh], c2, nm)) * own.rl[hh] : 0.f;
        x[4 * j + 2 * hh + 1] =
            kid.y == own.seg[hh] ? ex2(fmaf(x[4 * j + 2 * hh + 1], c2, nm)) * own.rl[hh] : 0.f;
      }
    }
  }
  wgmma_wait<0>();
  wgmma_pin(y);
#pragma unroll
  for (int j = 0; j < C::kWalk / 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = DKV ? h.rows[8 * j + 2 * t + e].z : own.di[hh];
        y[4 * j + 2 * hh + e] = (y[4 * j + 2 * hh + e] - d) * x[4 * j + 2 * hh + e] * scale;
      }
    }
  }
"""


SS_WAIT = """  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin(x);
  wgmma_pin(y);
"""


def dp_first(text: str) -> str:
    """S, then dP, each its own commit group; wait for S alone, make p,
    then wait for dP and make dS."""
    body = text[text.index(UNIT):]
    start = body.index(ELEMENTWISE_START)
    old_elementwise = body[start:body.index(PACK_START)]
    y_loop = ("#pragma unroll\n  for (int kk = 0; kk < D / 16; ++kk)\n    wgmma_ss(y,")
    return patched(text, (y_loop, "  wgmma_commit();\n" + y_loop),
                   (SS_WAIT, "  wgmma_commit();\n  wgmma_wait<1>();\n  wgmma_pin(x);\n"),
                   (old_elementwise, DP_FIRST_ELEMENTWISE))


def cut_between(text: str, start: str, end: str, new: str) -> str:
    body = text[text.index(UNIT):]
    a = body.index(start)
    b = body.index(end, a)
    return patched(text, (body[a:b], new))


NO_GRADS = """  // gradient products cut out: fold the fragments into the sums
#pragma unroll
  for (int kk = 0; kk < C::kWalk / 16; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      ga[f] += __uint_as_float(da[kk][f] & 0x807fffffu);
      if constexpr (DKV) gb[f] += __uint_as_float(pa[kk][f] & 0x807fffffu);
    }
"""

NO_SS = """#pragma unroll
  for (int i = 0; i < C::kWalk / 2; ++i) {
    x[i] = 0.01f * (float)(i + (lane & 7));
    y[i] = 0.02f * (float)(i - (lane & 3));
  }
"""

# ``overlap``: the step split in two, the gradient products issued and
# left in flight while the next block's S and dP are issued
OVERLAP_FUNCS = r'''// x = own0 . w0^T (S^T for dK/dV, S for dQ) and y = own1 . w1^T (dP^T or
// dP), 64 own rows x kWalk walked rows, issued as one group: x[4j + 2h + e]
// is own row 16 warp + g + 8h, walked row 8j + 2t + e.  o0, o1: the own
// tile's K and V (dK/dV) or q and dO (dQ); w0, w1: the stage's q and dO, or
// K and V.
template <int D, bool DKV>
__device__ __forceinline__ void issue_ss(float (&x)[Cfg<D, DKV>::kWalk / 2], float (&y)[Cfg<D, DKV>::kWalk / 2],
                                         const unsigned char* o0, const unsigned char* o1,
                                         const unsigned char* w0, const unsigned char* w1) {
  using C = Cfg<D, DKV>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(x, desc<C::kRowB>(o0 + 32 * kk), desc<C::kRowB>(w0 + 32 * kk), kk > 0 ? 1u : 0u);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(y, desc<C::kRowB>(o1 + 32 * kk), desc<C::kRowB>(w1 + 32 * kk), kk > 0 ? 1u : 0u);
  wgmma_commit();
}

// From S and dP (x, y, waited for) the gradient products of the block,
// issued as one group and not waited for: ga, gb: dK and dV, or dQ (ga[4j +
// 2h + e] is own row 16 warp + g + 8h, column 8j + 2t + e); pa, da: the A
// fragments they read, which stay untouched until the group is retired.
template <int D, bool DKV>
__device__ __forceinline__ void issue_grads(float (&ga)[D / 2], float (&gb)[D / 2],
                                            float (&x)[Cfg<D, DKV>::kWalk / 2], float (&y)[Cfg<D, DKV>::kWalk / 2],
                                            uint32_t (&pa)[Cfg<D, DKV>::kWalk / 16][4],
                                            uint32_t (&da)[Cfg<D, DKV>::kWalk / 16][4],
                                            const unsigned char* w0, const unsigned char* w1,
                                            const Head<Cfg<D, DKV>::kWalk>& h, const OwnRows& own, float c2,
                                            float scale, int lane) {
  using C = Cfg<D, DKV>;
  const int t = lane & 3;
  // p = ex2(s c2 - m log2e) (1 / l), 0 where the ids differ, into x;
  // dS = (dP - di) p sm_scale into y
#pragma unroll
  for (int j = 0; j < C::kWalk / 8; ++j) {
    if constexpr (DKV) {  // the walked rows are the columns
      const float4 ra = h.rows[8 * j + 2 * t], rb = h.rows[8 * j + 2 * t + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float& xa = x[4 * j + 2 * hh];
        float& xb = x[4 * j + 2 * hh + 1];
        xa = __float_as_int(ra.w) == own.seg[hh] ? ex2(fmaf(xa, c2, -ra.x)) * ra.y : 0.f;
        xb = __float_as_int(rb.w) == own.seg[hh] ? ex2(fmaf(xb, c2, -rb.x)) * rb.y : 0.f;
        y[4 * j + 2 * hh] = (y[4 * j + 2 * hh] - ra.z) * xa * scale;
        y[4 * j + 2 * hh + 1] = (y[4 * j + 2 * hh + 1] - rb.z) * xb * scale;
      }
    } else {  // the own rows are the rows
      const int2 kid = *reinterpret_cast<const int2*>(h.ids + 8 * j + 2 * t);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float& xa = x[4 * j + 2 * hh];
        float& xb = x[4 * j + 2 * hh + 1];
        const float nm = -own.m2[hh];
        xa = kid.x == own.seg[hh] ? ex2(fmaf(xa, c2, nm)) * own.rl[hh] : 0.f;
        xb = kid.y == own.seg[hh] ? ex2(fmaf(xb, c2, nm)) * own.rl[hh] : 0.f;
        y[4 * j + 2 * hh] = (y[4 * j + 2 * hh] - own.di[hh]) * xa * scale;
        y[4 * j + 2 * hh + 1] = (y[4 * j + 2 * hh + 1] - own.di[hh]) * xb * scale;
      }
    }
  }
  // bf16(p) and bf16(dS) as A fragments of the gradient products, a
  // 16-row step of the walked block each: row g cols 2t, 2t + 1; row g +
  // 8; row g cols 2t + 8, 2t + 9; row g + 8
#pragma unroll
  for (int kk = 0; kk < C::kWalk / 16; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      if constexpr (DKV) pa[kk][f] = pack_bf16(x[8 * kk + 2 * f], x[8 * kk + 2 * f + 1]);
      da[kk][f] = pack_bf16(y[8 * kk + 2 * f], y[8 * kk + 2 * f + 1]);
    }
  }
  // the stage's blocks as MN-major B: rows are the product's K, 8 rows an
  // atom (8 RowB bytes apart), the D columns one atom wide
  wgmma_fence();
  if constexpr (DKV) {
#pragma unroll
    for (int kk = 0; kk < C::kWalk / 16; ++kk)  // dV += bf16(p^T) . dO
      wgmma_rs_mn(gb, pa[kk], wgmma_desc_mn<C::kRowB>(w1 + kk * 16 * C::kRowB, C::kWalkB), 1u);
  }
#pragma unroll
  for (int kk = 0; kk < C::kWalk / 16; ++kk)  // dK += bf16(dS^T) . q, or dQ += bf16(dS) . K
    wgmma_rs_mn(ga, da[kk], wgmma_desc_mn<C::kRowB>(w0 + kk * 16 * C::kRowB, C::kWalkB), 1u);
  wgmma_commit();
}

'''

OVERLAP_LOOP = r'''    // Each needed block: S and dP issued and waited for, p and dS, the
    // gradient products issued; they stay in flight while the next block's
    // S and dP are issued, and one wait retires both (then the earlier
    // stage is released).
    uint32_t pa[C::kWalk / 16][4], da[C::kWalk / 16][4];
    int pend = -1;  // the stage whose gradient products are in flight
    for (int ob = 0; ob < nb; ++ob, ++n) {
      const int s = n % nst;
      mbar_wait(&full[s], (n / nst) & 1);
      const Head<C::kWalk>& h = head[s];
      const bool need = warp_uniform(h.need & bit);
      const unsigned char* w0 = stages + (size_t)s * C::kStageB;
      float x[C::kWalk / 2], y[C::kWalk / 2];
      if (need) issue_ss<D, DKV>(x, y, o0, o0 + C::kTileB, w0, w0 + C::kWalkB);
      wgmma_wait<0>();
      wgmma_pin(ga);
      if constexpr (DKV) wgmma_pin(gb);
      if (pend >= 0) release(pend);
      pend = -1;
      if (need) {
        wgmma_pin(x);
        wgmma_pin(y);
        issue_grads<D, DKV>(ga, gb, x, y, pa, da, w0, w0 + C::kWalkB, h, own, c2, scale, lane);
        pend = s;
      } else {
        release(s);
      }
    }
    wgmma_wait<0>();
    wgmma_pin(ga);
    if constexpr (DKV) wgmma_pin(gb);
    if (pend >= 0) release(pend);
'''

STEP_START = "// One (tile, block) step for the warpgroup."
STEP_END = "// A gradient's rows ra, ra + 8 (step's layout)"
LOOP_START = "    for (int ob = 0; ob < nb; ++ob, ++n) {\n      const int s = n % nst;\n      mbar_wait(&full[s], (n / nst) & 1);\n      const Head<C::kWalk>& h = head[s];\n      if (warp_uniform"
LOOP_END = "    if (tile < T) {\n      const int pair = item / H;"


def overlap(text: str) -> str:
    return cut_between(cut_between(text, STEP_START, STEP_END, OVERLAP_FUNCS), LOOP_START,
                       LOOP_END, OVERLAP_LOOP)



# ``one_cta_item``: one block an item at heads of 32 and S <= 512, dK, dV
# and dQ in one pass, appended to the source with a C entry of its own
# (``flash_attention_bwd_fused``): q, k, v and dO resident in shared memory
# (loaded once by TMA), each row's values made once, two consumer
# warpgroups each taking one key tile a round and walking the q blocks in
# a rotated order, so that at each step the two add to different q blocks
# of the f32 dQ in shared memory (a barrier a step: no atomics, the same
# bits every run); bf16(dS) goes through shared memory as dQ's A operand.
ONE_CTA_ITEM = r"""
namespace {
namespace fused_item {

constexpr int D = 32;
constexpr int kWg = 2;                 // consumer warpgroups
constexpr int kThreads = 128 * kWg;
constexpr int kRowB = 64;              // a 32-column row, 64-byte swizzle
constexpr int kTileB = 64 * kRowB;     // 64 rows of q, dO, K or V
constexpr int kMaxS = 512;
constexpr int kStageB = 64 * 128;      // a warpgroup's bf16(dS^T), 128-byte swizzle

size_t smem_bytes(int S) {
  return 1024 + 4 * (size_t)S * kRowB + kWg * kStageB + (size_t)S * D * 4 + (size_t)S * 16 +
         4 * (kMaxS / 64) + 8;
}

// d (64 x 32 f32) = A (64 x 16, MN-major in shared memory) * B (16 x 32,
// MN-major) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[16], uint64_t a, uint64_t b,
                                            uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__global__ void __launch_bounds__(kThreads, 1)
fused_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
             const int32_t* __restrict__ seg, const float* __restrict__ res_m,
             const float* __restrict__ res_l, const float* __restrict__ di,
             __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
             __nv_bfloat16* __restrict__ dv, int S, int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* dos = qs + (size_t)S * kRowB;
  unsigned char* ks = dos + (size_t)S * kRowB;
  unsigned char* vs = ks + (size_t)S * kRowB;
  unsigned char* stages = vs + (size_t)S * kRowB;                  // [kWg][kStageB]
  float* dqs = reinterpret_cast<float*>(stages + kWg * kStageB);   // [S][32], columns swizzled
  float4* rows = reinterpret_cast<float4*>(dqs + (size_t)S * D);
  uint32_t* pres = reinterpret_cast<uint32_t*>(rows + S);
  uint64_t* bar = reinterpret_cast<uint64_t*>(pres + kMaxS / 64);

  const int item = blockIdx.x, pair = item / H, hd = item - pair * H;
  const int T = S / 64;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, 4 * S * kRowB);
    for (int b = 0; b < T; ++b) {
      tma_load_3d(qs + b * kTileB, &qmap, bar, hd * D, b * 64, pair);
      tma_load_3d(dos + b * kTileB, &dmap, bar, hd * D, b * 64, pair);
      tma_load_3d(ks + b * kTileB, &kmap, bar, hd * D, b * 64, pair);
      tma_load_3d(vs + b * kTileB, &vmap, bar, hd * D, b * 64, pair);
    }
  }
  const int32_t* srow = seg + (size_t)pair * S;
  const size_t r0 = (size_t)item * S;
  for (int r = tid; r < S; r += kThreads)  // each row's values, once
    rows[r] = make_float4(res_m[r0 + r] * kLog2e, 1.f / res_l[r0 + r], di[r0 + r],
                          __int_as_float(srow[r]));
  for (int i = tid; i < S * D; i += kThreads) dqs[i] = 0.f;
  for (int b = warp; b < T; b += kThreads / 32) {
    const uint32_t pm = presence(srow[b * 64 + lane], srow[b * 64 + 32 + lane]);
    if (lane == 0) pres[b] = pm;
  }
  __syncthreads();
  mbar_wait(bar, 0);

  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  unsigned char* stg = stages + wg * kStageB;
  const float c2 = scale * kLog2e;
  const size_t tok = (size_t)H * D;
  const size_t gbase = (size_t)pair * S * tok + (size_t)hd * D;
  for (int round = 0; round < T / kWg; ++round) {
    const int kt = round * kWg + wg;  // the warpgroup's key tile this round
    const unsigned char* kk_t = ks + kt * kTileB;
    const unsigned char* vv_t = vs + kt * kTileB;
    const int kseg[2] = {srow[kt * 64 + 16 * wl + g], srow[kt * 64 + 16 * wl + g + 8]};
    float gk[16], gv[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) gk[i] = gv[i] = 0.f;
    for (int st = 0; st < T; ++st) {
      const int qb = (kt + st) % T;  // the warpgroups' q blocks differ at every step
      if (unit::warp_uniform(pres[kt] & pres[qb])) {
        const unsigned char* qq = qs + qb * kTileB;
        const unsigned char* dd = dos + qb * kTileB;
        float x[32], y[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_ss(x, wgmma_desc_sw64(kk_t + 32 * kk), wgmma_desc_sw64(qq + 32 * kk), kk > 0 ? 1u : 0u);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_ss(y, wgmma_desc_sw64(vv_t + 32 * kk), wgmma_desc_sw64(dd + 32 * kk), kk > 0 ? 1u : 0u);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_pin(x);
        wgmma_pin(y);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 ra = rows[qb * 64 + 8 * j + 2 * t], rb = rows[qb * 64 + 8 * j + 2 * t + 1];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float& xa = x[4 * j + 2 * hh];
            float& xb = x[4 * j + 2 * hh + 1];
            xa = __float_as_int(ra.w) == kseg[hh] ? ex2(fmaf(xa, c2, -ra.x)) * ra.y : 0.f;
            xb = __float_as_int(rb.w) == kseg[hh] ? ex2(fmaf(xb, c2, -rb.x)) * rb.y : 0.f;
            y[4 * j + 2 * hh] = (y[4 * j + 2 * hh] - ra.z) * xa * scale;
            y[4 * j + 2 * hh + 1] = (y[4 * j + 2 * hh + 1] - rb.z) * xb * scale;
          }
        }
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            pa[kk][f] = pack_bf16(x[8 * kk + 2 * f], x[8 * kk + 2 * f + 1]);
            da[kk][f] = pack_bf16(y[8 * kk + 2 * f], y[8 * kk + 2 * f + 1]);
          }
        // bf16(dS^T) as dQ's A: a key a 128-byte row of 64 queries, 128-byte swizzle
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int r = 16 * wl + g + 8 * (f & 1), cw = 2 * kk + (f >> 1);
            *reinterpret_cast<uint32_t*>(stg + r * 128 + ((cw ^ (r & 7)) << 4) + 4 * t) = da[kk][f];
          }
        fence_proxy_async();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dV += bf16(p^T) . dO
          wgmma_rs_mn(gv, pa[kk], wgmma_desc_mn<64>(dd + kk * 16 * 64, kTileB), 1u);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dK += bf16(dS^T) . q
          wgmma_rs_mn(gk, da[kk], wgmma_desc_mn<64>(qq + kk * 16 * 64, kTileB), 1u);
        wgmma_commit();
        named_barrier(1 + wg, 128);  // the warpgroup's bf16(dS^T) is in shared memory
        float dqp[16];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dQ part = bf16(dS) . K
          wgmma_ss_tt(dqp, wgmma_desc_mn<128>(stg + kk * 16 * 128, kStageB),
                      wgmma_desc_mn<64>(kk_t + kk * 16 * 64, kTileB), kk > 0 ? 1u : 0u);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_pin(gk);
        wgmma_pin(gv);
        wgmma_pin(dqp);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = qb * 64 + 16 * wl + g + 8 * hh;
            float2* a = reinterpret_cast<float2*>(dqs + r * 32 + ((8 * j + 2 * t) ^ ((r & 3) << 3)));
            float2 v = *a;
            v.x += dqp[4 * j + 2 * hh];
            v.y += dqp[4 * j + 2 * hh + 1];
            *a = v;
          }
      }
      named_barrier(15, kThreads);  // the step's dQ sums are in before the next step's
    }
    const int ra = kt * 64 + 16 * wl + g;
    unit::store_rows<32>(dk, gk, gbase, tok, ra, lane);
    unit::store_rows<32>(dv, gv, gbase, tok, ra, lane);
  }
  __syncthreads();
  for (int i = tid; i < S * D / 2; i += kThreads) {
    const int r = 2 * i / D, col = 2 * i % D;
    const float2 v = *reinterpret_cast<const float2*>(dqs + r * 32 + (col ^ ((r & 3) << 3)));
    *reinterpret_cast<uint32_t*>(dq + gbase + (size_t)r * tok + col) = pack_bf16(v.x, v.y);
  }
}

int launch(const void* q, const void* k, const void* v, const void* seg, const void* m,
           const void* l, const void* dout, const void* di, void* dq, void* dk, void* dv, int B,
           int S, int H, int Dh, float scale, cudaStream_t st) {
  if (Dh != D || S > kMaxS || S % 128 != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap, dmap;
  if (!unit::tile_map(&qmap, q, B, S, H, D, 64) || !unit::tile_map(&kmap, k, B, S, H, D, 64) ||
      !unit::tile_map(&vmap, v, B, S, H, D, 64) || !unit::tile_map(&dmap, dout, B, S, H, D, 64))
    return (int)cudaErrorInvalidValue;
  static bool raised = false;
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_bytes(kMaxS));
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  fused_kernel<<<B * H, kThreads, smem_bytes(S), st>>>(
      qmap, kmap, vmap, dmap, (const int32_t*)seg, (const float*)m, (const float*)l,
      (const float*)di, (__nv_bfloat16*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace fused_item
}  // namespace

extern "C" int flash_attention_bwd_fused(const void* q, const void* k, const void* v,
                                         const void* seg, const void* m, const void* l,
                                         const void* dout, const void* di, void* dq, void* dk,
                                         void* dv, int B, int S, int H, int D, float scale,
                                         void* stream) {
  return fused_item::launch(q, k, v, seg, m, l, dout, di, dq, dk, dv, B, S, H, D, scale,
                            (cudaStream_t)stream);
}
"""
FUSED = "flash_attention_bwd_fused"


def fused_entry_fn(torch, lib, c: dict):
    """A launch of the one-block-an-item variant's C entry on the case,
    into buffers of its own; returns (dQ, dK, dV)."""
    from financial_rag_system_tpu_torch.ops import _cuda

    import chip_smoke as cs

    qb, kb, vb, seg, m, l, dob, di, inv = cs.bwd_args(c)
    b, s, h, dp = qb.shape
    outs = [torch.empty_like(qb) for _ in range(3)]
    fn = getattr(lib, FUSED)
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = [x.data_ptr() for x in (qb, kb, vb, seg, m, l, dob, di, *outs)]

    def launch():
        _cuda.launch(fn, FUSED, *ptrs, b, s, h, dp, inv)
        return outs
    return launch


PRODUCE_64_ROWS = r'''// The producer warpgroup: for each unit and each kWalk-row block of the
// item's other side, the block's head (which tiles need it; the rows'
// values) and its two tiles by TMA where any tile needs it.  The walk's
// blocks (unit n / nb, block n % nb) go to the four warps in turn, 64 rows
// (one or two blocks) at a time, so their global loads of ids, m, l and
// di wait in four chains at once, one wait for 64 rows (one warp waiting
// on each block's loads in turn held the consumers up); each warp reads
// its rows before it waits for the stages.
template <int D, bool DKV>
__device__ __forceinline__ void produce(const CUtensorMap* w0map, const CUtensorMap* w1map,
                                        const int32_t* __restrict__ seg,
                                        const float* __restrict__ res_m,
                                        const float* __restrict__ res_l,
                                        const float* __restrict__ di, unsigned char* stages,
                                        Head<Cfg<D, DKV>::kWalk>* head, uint64_t* full,
                                        uint64_t* empty, int n_units, int units, int S, int H,
                                        int pw, int lane) {
  using C = Cfg<D, DKV>;
  constexpr int nst = Ring<D, DKV>::kStages;
  // blocks a warp takes at once, 64 rows: their loads wait together
  constexpr int kBatch = 64 / C::kWalk;
  static_assert(nst % (kProducers * kBatch) == 0, "a stage is always the same warp's");
  constexpr int U = C::kUnit;
  constexpr int kLane = C::kWalk / 32;  // a lane's rows of a block
  const int T = S / kRows, nb = S / C::kWalk, N = n_units * nb;
  int k_tp = -1;  // the unit whose tiles' presence tp holds
  uint32_t tp[U];
  // a unit's nb blocks are a multiple of kBatch, so a batch is one unit's
  for (int n0 = pw * kBatch; n0 < N; n0 += kProducers * kBatch) {
    const int k = n0 / nb, ob0 = n0 - k * nb;
    int item, u;
    unit_of(k, units, item, u);
    const int pair = item / H, hd = item - pair * H;
    const int32_t* srow = seg + (size_t)pair * S;
    const size_t rows = (size_t)item * S;  // the item's rows of m, l, di
    int x[kBatch][kLane];
    float rm[kBatch][kLane], rs[kBatch][kLane], rd[kBatch][kLane];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
#pragma unroll
      for (int i = 0; i < kLane; ++i) {
        const int r = (ob0 + b) * C::kWalk + lane + 32 * i;
        x[b][i] = srow[r];
        if constexpr (DKV) {
          rm[b][i] = res_m[rows + r];
          rs[b][i] = res_l[rows + r];
          rd[b][i] = di[rows + r];
        }
      }
    }
    if (k != k_tp) {  // a new unit: its tiles' presence
      int t[2 * U];
#pragma unroll
      for (int w = 0; w < U; ++w) {
        const int tile = u * U + w;
        t[2 * w] = tile < T ? srow[tile * kRows + lane] : 0;
        t[2 * w + 1] = tile < T ? srow[tile * kRows + 32 + lane] : 0;
      }
#pragma unroll
      for (int w = 0; w < U; ++w) tp[w] = u * U + w < T ? presence(t[2 * w], t[2 * w + 1]) : 0u;
      k_tp = k;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int n = n0 + b, ob = ob0 + b;
      const uint32_t bp = presence_of(x[b]);
      uint32_t need = 0;
#pragma unroll
      for (int w = 0; w < U; ++w)
        if (tp[w] & bp) need |= 1u << w;
      const int s = n % nst;
      mbar_wait(&empty[s], ((n / nst) & 1) ^ 1);  // the first round passes
      Head<C::kWalk>& h = head[s];
      if (need) {
#pragma unroll
        for (int i = 0; i < kLane; ++i) {
          if constexpr (DKV)
            h.rows[lane + 32 * i] = make_float4(rm[b][i] * kLog2e, 1.f / rs[b][i], rd[b][i],
                                                __int_as_float(x[b][i]));
          else
            h.ids[lane + 32 * i] = x[b][i];
        }
      }
      if (lane == 0) h.need = need;
      if (lane == 0 && need) {
        unsigned char* st = stages + (size_t)s * C::kStageB;
        mbar_arrive_expect_tx(&full[s], C::kStageB);
        tma_load_3d(st, w0map, &full[s], hd * D, ob * C::kWalk, pair);
        tma_load_3d(st + C::kWalkB, w1map, &full[s], hd * D, ob * C::kWalk, pair);
      } else {
        mbar_arrive(&full[s]);
      }
    }
  }
}

'''
PRODUCE_START = "// The producer warpgroup: for each unit and each kWalk-row block of the"
PRODUCE_END = "// A consumer thread's two own rows"


def producer_64_rows(text: str) -> str:
    return cut_between(text, PRODUCE_START, PRODUCE_END, PRODUCE_64_ROWS)


VARIANTS = {
    "as_is": lambda t: t,
    "unit_2": unit(2),
    "unit_3": unit(3),
    "walk_64": lambda t: unpinned(patched(t, (WALK_LINE, "static constexpr int kWalk = 64;"))),
    "walk_64_units_3_4": lambda t: unpinned(patched(
        t, (WALK_LINE, "static constexpr int kWalk = 64;"),
        (UNIT_LINE, "static constexpr int kUnit = D == 32 ? (DKV ? 3 : 4) : 2;"))),
    "walk_32_both": lambda t: unpinned(patched(
        t, (WALK_LINE, "static constexpr int kWalk = D == 32 ? 32 : 64;"))),
    "stages_8": lambda t: unpinned(patched(
        t, ("static constexpr int kMaxStages = 8 * 64 / kWalk;",
            "static constexpr int kMaxStages = 8;"))),
    "overlap": overlap,
    "producer_64_rows": producer_64_rows,
    "one_producer": lambda t: patched(t, (
        "    produce<D, DKV>(&walk0, &walk1, seg, res_m, res_l, di, stages, head, full, empty, "
        "n_units,\n                    units, S, H, warp - 4 * U, lane);",
        "    if (warp == 4 * U)\n      produce<D, DKV>(&walk0, &walk1, seg, res_m, res_l, di, "
        "stages, head, full, empty,\n                      n_units, units, S, H, 0, lane);"),
        ("constexpr int kProducers = 4;", "constexpr int kProducers = 1;")),
    "rows_128": lambda t: unpinned(patched(
        t, (WALK_LINE, "static constexpr int kWalk = 128;"),
        (UNIT_LINE, "static constexpr int kUnit = D == 32 ? 2 : 2;"))),
    "dp_first": dp_first,
    "no_mufu": lambda t: patched(t, ("ex2(fmaf(", "(fmaf(")),
    "no_grads": lambda t: cut_between(t, GRADS_START, GRADS_END, NO_GRADS),
    "no_ss": lambda t: cut_between(t, SS_START, ELEMENTWISE_START, NO_SS),
    "one_cta_item": lambda t: t + ONE_CTA_ITEM,
    "loads_only": lambda t: patched(t, ("      if (warp_uniform(h.need & bit)) {",
                                        "      if (warp_uniform(h.need & bit) && gridDim.y == 7u) {")),
}
ENTRIES = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")

# Variants of the wide kernel (``wide::wide_kernel``, heads of 128 and
# wider), timed with ``--width``:
WIDE = "namespace wide {"


def patched_wide(text: str, *pairs: tuple[str, str]) -> str:
    """``text`` with each (old, new) replaced inside the wide kernel's
    namespace; raises if an old string is not there."""
    head, body = text[:text.index(WIDE)], text[text.index(WIDE):]
    for old, new in pairs:
        if old not in body:
            raise ValueError(f"patch anchor not found: {old[:60]!r}")
        body = body.replace(old, new)
    return head + body


RESIDENT_START = "      // each block's S and dP, p and dS and gradient products in turn"
RESIDENT_END = "    } else {\n      // windows of the head in turn"
PIPELINED = """      // Software-pipelined: block ob + 1's S and dP are issued before block
      // ob's gradient products, which run while ob + 1's p and dS are made
      mbar_wait(own_full, k & 1);
      const unsigned char* o1 = own + (size_t)pl.nc * kChunkB;
      auto issue_scores = [&](int s) {
        const unsigned char* w0 = stages + (size_t)s * pl.stage_b;
        wgmma_fence();
        scores<W>(x, y, own, o1, w0, w0 + (size_t)pl.nc * W * 128, pl.nc, wg, true);
        wgmma_commit();
      };
      int s = n % pl.nst;
      mbar_wait(&full[s], (n / pl.nst) & 1);
      bool need = unit::warp_uniform(head[s].need != 0);
      if (need) issue_scores(s);
      bool pending = false;
      int ps = 0;
      for (int ob = 0; ob < nb; ++ob, ++n) {
        s = n % pl.nst;
        if (need) {
          if (pending) wgmma_wait<1>();
          else wgmma_wait<0>();
          wgmma_pin(x);
          wgmma_pin(y);
          share_p_ds(x, y, head[s]);
        }
        if (pending) {
          wgmma_wait<0>();
          pin_grads();
          release(&empty[ps]);
          pending = false;
        }
        bool need_next = false;
        if (ob + 1 < nb) {
          const int s1 = (n + 1) % pl.nst;
          mbar_wait(&full[s1], ((n + 1) / pl.nst) & 1);
          need_next = unit::warp_uniform(head[s1].need != 0);
          if (need_next) issue_scores(s1);
        }
        if (need) {
          wgmma_fence();
          grads(stages + (size_t)s * pl.stage_b, 0);
          wgmma_commit();
          pending = true;
          ps = s;
        } else {
          release(&empty[s]);
        }
        need = need_next;
      }
      if (pending) {
        wgmma_wait<0>();
        pin_grads();
        release(&empty[ps]);
      }
"""


def pipelined(text: str) -> str:
    head, body = text[:text.index(WIDE)], text[text.index(WIDE):]
    a, b = body.index(RESIDENT_START), body.index(RESIDENT_END)
    return head + body[:a] + PIPELINED + body[b:]


NEVER = " && gridDim.y == 7u"  # a launch has gridDim.y 1: the part never runs
WIDE_VARIANTS = {
    "as_is": lambda t: t,
    "pipelined": pipelined,
    "walk_32": lambda t: patched_wide(t, ("return D <= 256 ? 64 :", "return D <= 128 ? 64 :")),
    "no_mufu": lambda t: patched_wide(t, ("ex2(fmaf(", "(fmaf(")),
    "no_grads": lambda t: patched_wide(t, ("if (unit::warp_uniform(j < mine)) {",
                                           f"if (unit::warp_uniform(j < mine{NEVER})) {{")),
    "no_ss": lambda t: patched_wide(t, ("for (int c = 0; c < cw; ++c) {",
                                        f"for (int c = 0; c < cw{NEVER}; ++c) {{")),
    "no_cluster": lambda t: patched_wide(t, ("constexpr int kCluster = 2;",
                                             "constexpr int kCluster = 1;")),
    "loads_only": lambda t: patched_wide(
        t, ("unit::warp_uniform((head[s].need >> rank) & 1u)",
            f"unit::warp_uniform(((head[s].need >> rank) & 1u){NEVER})")),
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, action="append", default=[], metavar="CSRC",
                        help="csrc/ of an earlier checkout: time its flash_attention_bwd.cu "
                             "too (may repeat: parent0, parent1, ...)")
    parser.add_argument("--only", default=None, help="comma-separated variants to build")
    parser.add_argument("--width", type=int, default=32,
                        help="the head width: 32 (the unit kernel's variants) or 128 and wider "
                             "(the wide kernel's: H D 768 at B 32, S 512)")
    opts = parser.parse_args()
    variants = VARIANTS if opts.width < 128 else WIDE_VARIANTS
    heads = 12 if opts.width < 128 else 768 // opts.width
    import numpy as np
    import torch

    import chip_smoke as cs
    from financial_rag_system_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        print("flash_backward_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    OUT.mkdir(parents=True, exist_ok=True)
    source = SRC.read_text()
    wanted = opts.only.split(",") if opts.only else list(variants)
    if "as_is" not in wanted:
        wanted.insert(0, "as_is")
    builds = {}  # one nvcc a build, all at once
    for name in wanted:
        src = OUT / f"{name}.cu"
        src.write_text(variants[name](source))
        builds[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", f"-I{_cuda.CSRC_DIR}",
             "-o", str(OUT / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for i, parent in enumerate(opts.parent):
        builds[f"parent{i}"] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", f"-I{parent}",
             "-o", str(OUT / f"parent{i}.so"), str(parent / "flash_attention_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs, failed = {}, False
    for name, proc in builds.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            print(f"[variants] {name}: build failed\n{log}", flush=True)
            failed = True
        else:
            logs[name] = log
    examples = cs.trainer_examples(np, cs.FLASH_TRAIN_STEPS)
    mask = np.asarray(cs.first_batch(torch, np, examples)["pairs"][2])
    c = cs.flash_bwd_case(torch, np, mask.shape[0], mask.shape[1], heads, opts.width, mask,
                          seed=opts.width)
    libs = {name: ctypes.CDLL(str(OUT / f"{name}.so")) for name in logs}

    def entries(name):
        return (FUSED,) if name == "one_cta_item" else ENTRIES

    fns = {(name, e): (fused_entry_fn(torch, lib, c) if e == FUSED
                       else cs.bwd_entry_fn(torch, lib, e, c))
           for name, lib in libs.items() for e in entries(name)}
    ref = {e: [x.float().clone() for x in fns["as_is", e]()] for e in ENTRIES if "as_is" in libs}
    if ref:  # the fused entry's (dQ, dK, dV)
        ref[FUSED] = ref[ENTRIES[1]] + ref[ENTRIES[0]]
    errs = {}
    for (name, e), fn in fns.items():
        got = [x.float() for x in fn()]
        torch.cuda.synchronize()
        errs[name, e] = max(float((a - r).abs().max()) / float(r.abs().max())
                            for a, r in zip(got, ref[e])) if e in ref else float("nan")
    names = list(libs)
    times, device = {}, {}
    for seq in (names, names[::-1]):  # in order, then in reverse
        for name in seq:
            for e in entries(name):
                times.setdefault((name, e), []).append(cs.median_ms(fns[name, e], reps=30))
                device.setdefault((name, e), []).append(
                    sum(cs.device_split(torch, fns[name, e]).values()))
    for name in names:
        log = logs[name]
        kern = "ILi32" if opts.width < 128 else "wide_kernel"
        regs = {k: r for k, r in cs.ptxas_kernels(log).items()
                if kern in k or "bwd_kernelILi32" in k or "fused_kernel" in k}
        serial = sorted({re.search(r"\((C75\d\d)\)", line).group(1) for line in log.splitlines()
                         if kern in line and re.search(r"\(C75\d\d\).*serialized", line)})
        print(f"[variants] {smi}: {name}, B {mask.shape[0]} S {mask.shape[1]} {heads} heads of "
              f"{opts.width}: "
              + "; ".join(f"{e.removeprefix('flash_attention_bwd_')} events "
                          f"{' / '.join(f'{t:.4f}' for t in times[name, e])} ms, device "
                          f"{' / '.join(f'{t:.4f}' for t in device[name, e])} ms (off as_is "
                          f"{errs[name, e]:.3g} of its largest magnitude)"
                          for e in entries(name))
              + f"; ptxas (registers, spill store and load bytes) {regs}, wgmma serialised "
              f"{serial or 'no'}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
