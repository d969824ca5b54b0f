"""Time variants of the flash-attention kernel (kernel 7) on one NVIDIA GPU.

    python3 financial_rag_system_tpu_torch/tools/flash_attention_variants.py [--parent CSRC]
                                                                             [--only a,b]

Builds copies of ``financial_rag_system_tpu_torch/csrc/flash_attention.cu``
with one constant changed or one part cut out, and times each beside the
kernel as it is at the served shape (P 480, S 512, 12 heads of 32; the
``d256_`` variants at 3 heads of 256) on a
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

``--parent CSRC`` also times an earlier checkout's ``flash_attention.cu``
at both widths.
Each line gives the variant's median time (CUDA events, 20 launches), the
registers and spills of its heads-of-32 (or heads-of-256) kernel as
``ptxas -v`` reports them (registers before ``setmaxnreg``), and the
card's name and power limit.
The variants build in parallel, into ``build/flash_attention_variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None, metavar="CSRC",
                        help="csrc/ of an earlier checkout: time its flash_attention.cu too")
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
    inputs = {}  # head width: its kernel's bf16 q, k, v at the served shape
    for h, d in ((12, 32), (3, 256)):
        q, k, v, uniform = cs.attention_inputs(torch, np, cs.PAIRS, 512, h, d)
        inputs[d] = fa.kernel_inputs(q, k, v)
        del q, k, v
    rerank = np.pad(rerank_layout_mask(np, cs.PAIRS, 400), ((0, 0), (0, 112)))
    masks = {"rerank-layout": torch.tensor(rerank, device="cuda"),
             "uniform-length": torch.tensor(uniform, device="cuda")}
    every = {**VARIANTS, **D256_VARIANTS}
    wanted = opts.only.split(",") if opts.only else list(every)
    builds = {}  # one nvcc a variant, all at once
    for name in wanted:
        src = OUT / f"{name}.cu"
        src.write_text(every[name](source))
        builds[name] = (src, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", f"-I{_cuda.CSRC_DIR}",
             "-o", str(OUT / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    if opts.parent is not None:
        builds["parent"] = (None, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", f"-I{opts.parent}",
             "-o", str(OUT / "parent.so"), str(opts.parent / "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    for name, (_, proc) in builds.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode:
            print(f"[variants] {name}: build failed\n{log}")
            return 1
        widths = (256,) if name.startswith("d256_") else (32, 256) if name == "parent" else (32,)
        for d in widths:
            kernel = "flash256_kernel" if d == 256 else "12flash_kernelILi32E"
            regs = {kern: r for kern, r in cs.ptxas_kernels(log).items() if kernel in kern}
            qb, kb, vb = inputs[d]
            times = {}
            with cs.kernel_lib("flash_attention", ctypes.CDLL(str(OUT / f"{name}.so"))):
                for label, mask in masks.items():
                    times[label] = cs.median_ms(
                        lambda: fa.flash_attention_kernel(qb, kb, vb, mask, d ** -0.5), reps=20)
            print(f"[variants] {smi}: {name}, P {cs.PAIRS} S 512 heads of {d}: " + ", ".join(
                f"{label} {ms:.4f} ms" for label, ms in times.items())
                + f"; ptxas (registers, spill store and load bytes) {regs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
