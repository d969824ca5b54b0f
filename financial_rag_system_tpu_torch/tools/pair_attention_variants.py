"""Time variants of the pair-attention kernel on one NVIDIA GPU.

    python3 financial_rag_system_tpu_torch/tools/pair_attention_variants.py

Builds copies of ``financial_rag_system_tpu_torch/csrc/pair_attention.cu``
with one constant changed or one part cut out, and times each beside the
kernel as it is, at the rerank shape (P 480, S 400, H 12, d 32) with
every key valid and on ``chip_smoke.py``'s uniform-length mask, in one
process on one card.  A variant with a part cut out computes a wrong
context: its time says what that part costs.  Variants:

- ``as_is``: the kernel as the port builds it;
- ``consumers_2``, ``consumers_3``, ``consumers_5``: other counts of
  consumer warpgroups;
- ``no_mufu``: ex2.approx replaced by the identity (no MUFU work);
- ``no_sweep1``: the row-max sweep cut out;
- ``no_tiles``: no attention at all, only the loads and the bookkeeping.

Each line gives the variant's median time (CUDA events, 20 launches), its
registers and spills as ``ptxas -v`` reports them, and the card's name
and power limit.  The variants build in parallel, into
``build/pair_attention_variants/``.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

SRC = Path(__file__).resolve().parents[1] / "csrc" / "pair_attention.cu"
OUT = REPO / "build" / "pair_attention_variants"


def patched(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"pair_attention.cu no longer holds {old[:60]!r}")
    return text.replace(old, new)


def consumers(n: int):
    return lambda s: patched(s, "constexpr int kConsumers = 4;", f"constexpr int kConsumers = {n};")


SWEEP1 = """  for (int c = 0; c < tl.nck; ++c) {
    qk(acc, qs, tl, c);
    chunk_max(m, acc, tl, c, t);
  }
"""
VARIANTS = {
    "as_is": lambda s: s,
    "consumers_2": consumers(2),
    "consumers_3": consumers(3),
    "consumers_5": consumers(5),
    "no_mufu": lambda s: patched(
        s, 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x;"),
    "no_sweep1": lambda s: patched(s, SWEEP1, "  m[0] = m[1] = 0.f;\n"),
    "no_tiles": lambda s: patched(
        s, "      attend_tile(my_q + b * kQBytes, tl, out, base, tok, S, rw, lane);",
        "      if (my_q[b * kQBytes] == 0x7fu) out[rw] = __float2bfloat16(1.f);"),
}


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from financial_rag_system_tpu_torch.ops import _cuda
    from financial_rag_system_tpu_torch.ops import attention as attn

    if not torch.cuda.is_available():
        print("pair_attention_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    OUT.mkdir(parents=True, exist_ok=True)
    source = SRC.read_text()
    q, k, v, uniform = cs.attention_inputs(torch, np, cs.PAIRS, 400)
    qs, kb, vb = (t.contiguous() for t in attn._scaled_inputs(q, k, v, 1.0 / 32 ** 0.5))
    masks = {"all-valid": torch.ones_like(torch.tensor(uniform, device="cuda")),
             "uniform-length": torch.tensor(uniform, device="cuda")}
    builds = {}  # one nvcc a variant, all at once
    for name, patch in VARIANTS.items():
        src = OUT / f"{name}.cu"
        src.write_text(patch(source))
        builds[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", f"-I{_cuda.CSRC_DIR}",
             "-o", str(OUT / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    for name, proc in builds.items():
        log = proc.communicate(timeout=300)[0]
        if proc.returncode:
            print(f"[variants] {name}: build failed\n{log}")
            return 1
        regs = " ".join(re.findall(r"Used \d+ registers|\d+ bytes spill stores", log))
        times = {}
        with cs.kernel_lib("pair_attention", ctypes.CDLL(str(OUT / f"{name}.so"))):
            for label, mask in masks.items():
                times[label] = cs.median_ms(
                    lambda: attn.pair_attention_kernel(qs, kb, vb, mask), reps=20)
        print(f"[variants] {smi}: {name}: " + ", ".join(
            f"{label} {ms:.4f} ms" for label, ms in times.items()) + f"; {regs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
