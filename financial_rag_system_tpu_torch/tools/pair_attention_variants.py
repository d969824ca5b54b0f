"""Time variants of the pair-attention kernel (kernel 2) on one NVIDIA GPU.

    python3 financial_rag_system_tpu_torch/tools/pair_attention_variants.py [--parent CSRC]
                                                                            [--only a,b]

Builds copies of ``financial_rag_system_tpu_torch/csrc/pair_attention.cu``
with one constant changed or one part cut out, and times each beside the
kernel as it is at the rerank shape (P 480, S 400) at 12 heads of 32 (the
persistent kernel), 12 of 64 and 6 of 128 (the ring kernel), each with
every key valid, on ``chip_smoke.py``'s uniform-length mask and on a
rerank-layout mask (query tokens, a hole up to 32, document tokens), in
one process on one card.  A variant with a part cut out computes a wrong
context: its time says what that part costs.  Variants:

- ``as_is``: the kernel as the port builds it;
- ``consumers_2``, ``consumers_3``, ``consumers_5``: other counts of the
  persistent kernel's consumer warpgroups;
- ``no_mufu``: ex2.approx replaced by the identity (no MUFU work), in both
  kernels;
- ``no_sweep1``: the persistent kernel's row-max sweep cut out;
- ``no_tiles``: the persistent kernel with no attention at all, only the
  loads and the bookkeeping;
- ``ring_d32``: heads of 32 on the ring kernel's D-32 instance (three
  consumer warpgroups, 64-byte swizzle) in place of the persistent kernel;
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

``--parent CSRC`` also times an earlier checkout's ``pair_attention.cu``
(its ``pair_attention`` at heads of 32, its streaming
``pair_attention_wide`` at 64 and 128).  Every build is launched by its C
entry alone (``chip_smoke.attention_launcher``).  Each line gives the
variant's median time (CUDA events, 20 launches) at each width and mask,
its largest difference from the plain version, its kernels' registers (before
``setmaxnreg``) and spills as ``ptxas -v`` reports them, and the card's
name and power limit.  The variants build in parallel, into
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
    "ring_d32": lambda s: patched(
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
    cases = {}  # (width, mask label): the wrapper's padded inputs and the mask
    plain = {}  # width: the plain version's context on the rerank-layout mask
    for h, d in WIDTHS:
        q, k, v, uniform = cs.attention_inputs(torch, np, cs.PAIRS, 400, h, d)
        qs, kb, vb = attn.kernel_inputs(q, k, v, 1.0 / d ** 0.5)
        for label, mask in (("all-valid", np.ones_like(uniform)), ("uniform-length", uniform),
                            ("rerank-layout", rerank_layout_mask(np, cs.PAIRS, 400))):
            cases[(d, label)] = (qs, kb, vb, torch.tensor(mask, device="cuda"))
        mask = cases[(d, "rerank-layout")][3]
        plain[d] = attn.encoder_self_attention_plain(q, k, v, mask, 1.0 / d ** 0.5).view(
            cs.PAIRS, 400, h, d).to(torch.bfloat16)
        del q, k, v
    wanted = opts.only.split(",") if opts.only else list(VARIANTS)
    builds = {}  # one nvcc a variant, all at once
    for name in wanted:
        src = OUT / f"{name}.cu"
        src.write_text(VARIANTS[name](source))
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
    for name, proc in builds.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode:
            print(f"[variants] {name}: build failed\n{log}")
            return 1
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        times, errs = {}, {}
        for (d, label), (qs, kb, vb, mask) in cases.items():
            fn = cs.attention_launcher(torch, lib, qs, kb, vb, mask)
            if label == "rerank-layout":
                errs[d] = float((fn().float() - plain[d].float()).abs().max())
            times[(d, label)] = cs.median_ms(fn, reps=20)
        print(f"[variants] {smi}: {name}: " + ", ".join(
            f"d {d} {label} {ms:.4f} ms" for (d, label), ms in times.items())
            + "; max abs diff from the plain version on the rerank-layout mask "
            + ", ".join(f"d {d} {e:.3g}" for d, e in errs.items())
            + f"; ptxas (registers, spill store and load bytes) {cs.ptxas_kernels(log)}",
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
