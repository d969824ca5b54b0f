"""Time variants of the FFN + LayerNorm kernel (kernel 4) on one NVIDIA GPU.

    python3 financial_rag_system_tpu_torch/tools/ffn_ln_variants.py [--parent OLD/.../csrc]

Builds copies of ``financial_rag_system_tpu_torch/csrc/fused_bert.cu``,
each changed in one way, and runs each at the main path's shapes (H 384,
I 1536; rerank R 192,000 and embed R 1,024) on ``ffn_plan``'s plans.
Variants:

- ``as_is``: the kernel as the port builds it (the GELU's tanh as
  1 - 2 / (e^2u + 1) on ``ex2.approx`` and a fast reciprocal: two MUFU ops);
  it also runs the other plan at H 384 (row tiles of 64 with H split at
  the rerank shape, of 128 at the embed shape) and the embed shape split
  over I in 2, 4 and 8 blocks a tile;
- ``tanhf``: the GELU's tanh by ``tanhf`` (full precision, ~25 FP32
  instructions);
- ``tanh_approx``: by ``tanh.approx.f32`` (one MUFU op, relative error
  about 2^-11);
- ``one_chain``: with row tiles of 128, GEMM1 summed over all of K in one
  chain of wgmmas, where the kernel sums each half of K in a chain of its
  own and adds the two in f32;
- ``no_epilogue``: no layernorm and no stores (no output): what the
  epilogue costs.

With ``--parent``, the FFN kernel of an earlier checkout's
``fused_bert.cu`` runs on the same inputs too (``chip_smoke.py``'s
``--ffn-baseline`` launch).  Each line gives the variant's median time (CUDA events, 20 launches) and
its median device time (the profiler's kernel times over 10 launches), its
largest difference from the plain version (``fused_ffn_ln_plain``, the
tolerance is atol = rtol = 2e-3), the count of elements outside that
tolerance and of those more than 1e-3 off, and the card's name and power limit.  Before them, each
variant's ``ptxas -v`` registers and spills for every instantiation of
``ffn_ln_kernel``, and from ``cuobjdump -sass`` the highest register each
uses and its local-memory (spill) instructions.  The variants build in
parallel, into ``build/ffn_ln_variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

SRC = Path(__file__).resolve().parents[1] / "csrc" / "fused_bert.cu"
OUT = REPO / "build" / "ffn_ln_variants"
TANH = "  return fmaf(h, tanh_ex2(u), h);"


def patched(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"fused_bert.cu no longer holds {old[:60]!r}")
    return text.replace(old, new)


def tanh_by(expr: str):
    return lambda s: patched(s, TANH, f"  return fmaf(h, {expr}, h);")


TANH_EX2 = """  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(u * 2.8853900817779268f));  // e^2u
  return 1.f - __fdividef(2.f, e + 1.f);"""
TANH_APPROX = """  float r;
  asm("tanh.approx.f32 %0, %1;" : "=f"(r) : "f"(u));
  return r;"""


VARIANTS = {
    "as_is": lambda s: s,
    "tanhf": tanh_by("tanhf(u)"),
    "tanh_approx": lambda s: patched(s, TANH_EX2, TANH_APPROX),
    "one_chain": lambda s: patched(s, "  constexpr int kLo = F::kNB / 2;  // GEMM1's first chain",
                                   "  constexpr int kLo = 0;  // GEMM1's first chain"),
    "no_epilogue": lambda s: patched(
        s, "    ln_store<H, ROWS>(acc, sm, th, tile * ROWS", "    if (R < 0) ln_store<H, ROWS>(acc, sm, th, tile * ROWS"),
}
EMBED_SPLITS = (2, 4, 8)  # I splits timed at the embed shape (the plan's 64-row tiles)


def ptxas_lines(log: str) -> list[str]:
    """Registers and spills of each ffn_ln_kernel instantiation."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"ffn_ln_kernelILi(\d+)ELi(\d+)E", m.group(1))
            name = f"H {k.group(1)} rows {k.group(2)}" if k else None
        elif name and ("spill" in line or "Used" in line):
            out.append(f"{name}: {line.split('info    :')[-1].strip()}")
    return out


def sass_lines(lib: Path) -> list[str]:
    """Highest register and local-memory instructions of each
    ffn_ln_kernel instantiation, from cuobjdump -sass."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return ["cuobjdump not found"]
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    out = []
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        k = re.search(r"ffn_ln_kernelILi(\d+)ELi(\d+)E", part.split("\n", 1)[0])
        if not k:
            continue
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", part)]
        out.append(f"H {k.group(1)} rows {k.group(2)}: highest register R{max(regs, default=0)}, "
                   f"{len(re.findall(r'STL', part))} STL, {len(re.findall(r'LDL', part))} LDL, "
                   f"{len(re.findall(r'HGMMA', part))} HGMMA")
    return out


def main() -> int:
    import torch

    import chip_smoke as cs
    from financial_rag_system_tpu_torch.ops import _cuda
    from financial_rag_system_tpu_torch.ops import fused_bert as fb

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None, metavar="CSRC",
                        help="csrc/ of an earlier checkout: run its FFN kernel too")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("ffn_ln_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    OUT.mkdir(parents=True, exist_ok=True)
    source = SRC.read_text()
    builds = {}  # one nvcc a variant, all at once
    for name, patch in VARIANTS.items():
        src = OUT / f"{name}.cu"
        src.write_text(patch(source))
        builds[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", f"-I{_cuda.CSRC_DIR}",
             "-o", str(OUT / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    g = torch.Generator(device="cuda").manual_seed(8)

    def randn(*shape, scale=1.0, loc=0.0):
        return loc + scale * torch.randn(shape, generator=g, device="cuda")

    h, i = 384, 1536
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    w = (randn(i, h, scale=0.05), randn(i, scale=0.01), randn(h, i, scale=0.05),
         randn(h, scale=0.01), randn(h, scale=0.1, loc=1.0), randn(h, scale=0.1))
    shapes = {"rerank": randn(cs.PAIRS * 400, h), "embed": randn(cs.B * 32, h)}
    plain = {k: fb.fused_ffn_ln_plain(x, *w, 1e-12) for k, x in shapes.items()}
    operands = {k: fb._ffn_operands(x, *w) for k, x in shapes.items()}
    def report(label: str, fn, ref) -> str:
        got = fn()
        err = (got - ref).abs()
        bad = int((~torch.isclose(got, ref, atol=2e-3, rtol=2e-3)).sum())
        ms = cs.median_ms(fn, reps=20)
        return (f"{label} {ms:.4f} ms, device {cs.device_ms(torch, fn, 'ffn_ln_kernel'):.4f} ms "
                f"(max abs err "
                f"{float(err.max()):.3g}, {bad} outside, {int((err > 1e-3).sum())} over 1e-3)")

    if opts.parent is not None:
        parent = cs.baseline_lib("fused_bert", opts.parent)
        parts = []
        for shape, (xf, ops) in operands.items():
            y = torch.empty_like(plain[shape])
            parts.append(report(shape, cs.ffn_baseline_fn(parent, xf, ops, 1e-12, y),
                                plain[shape]))
        print(f"[variants] {smi}: parent: " + "; ".join(parts), flush=True)
    for name, proc in builds.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode:
            print(f"[variants] {name}: build failed\n{log}")
            return 1
        for line in ptxas_lines(log) + sass_lines(OUT / f"{name}.so"):
            print(f"[variants] {name}: {line}", flush=True)
        parts = []
        with cs.kernel_lib("fused_bert", ctypes.CDLL(str(OUT / f"{name}.so"))):
            fb._library.cache_clear()  # the wrappers' entry points from this build
            for shape, (xf, ops) in operands.items():
                own = fb.ffn_plan(h, i, xf.shape[0], sms).rows
                for rows in (own, 192 - own) if name == "as_is" else (own,):
                    plan = fb._ffn_plan_rows(h, i, xf.shape[0], sms, rows)
                    parts.append(report(f"{shape} rows {rows}",
                                        lambda: fb._ffn_launch(xf, ops, 1e-12, plan),
                                        plain[shape]))
            if name == "as_is":  # the embed shape on other I splits
                xf, ops = operands["embed"]
                base = fb.ffn_plan(h, i, xf.shape[0], sms)
                for splits in EMBED_SPLITS:
                    plan = base._replace(splits=splits, ctas=base.tiles * splits,
                                         workspace=splits * base.tiles * base.rows * h)
                    parts.append(report(f"embed {splits} splits",
                                        lambda: fb._ffn_launch(xf, ops, 1e-12, plan),
                                        plain["embed"]))
        fb._library.cache_clear()
        print(f"[variants] {smi}: {name}: " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
