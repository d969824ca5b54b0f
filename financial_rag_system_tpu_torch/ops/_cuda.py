"""Build and load the port's CUDA kernels at first use.

Every ``csrc/*.cu`` file has a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/<name>.so`` at
the repo root; the wrappers in ``ops/`` and ``index/`` load them with
``ctypes``.  All sources compile in parallel, one ``nvcc`` process each,
and a library newer than its source and every ``csrc/*.cuh`` header is
reused.  Nothing here runs at import: the CPU
tests import every module of the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels build at first use")


def build_all() -> float:
    """Compile every stale ``csrc/*.cu`` in parallel; returns seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # every source includes the shared headers: a newer header rebuilds all
    headers = max((h.stat().st_mtime for h in CSRC_DIR.glob("*.cuh")), default=0.0)
    procs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        out = BUILD_DIR / f"{src.stem}.so"
        newest = max(src.stat().st_mtime, headers)
        if out.exists() and out.stat().st_mtime >= newest:
            continue
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
        procs.append((src.name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded ``build/torch_kernels/<name>.so``, building on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(BUILD_DIR / f"{name}.so"))
            _libs[name] = lib
        return lib


def refuse_grad(what: str, *tensors) -> None:
    """Raise when grad mode is on and a tensor (``None`` skipped) requires
    grad: kernels 1-6 have no backward, and launching one on raw pointers
    would cut the autograd graph without a word.  A graded forward of the
    encoder never comes here (``models/bert.py _graded``).  The flash
    attention does not ask it: it has a backward of its own
    (``ops/flash_attention.py _FlashAttention``, kernels 8 and 9)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward; call it on tensors "
                           "that do not require grad, or under torch.no_grad()")


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a kernel's C entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def launch(fn, name: str, *args) -> None:
    """``fn(*args, stream)`` on the current device's current stream (its
    raw handle, which torch.cuda.current_stream() takes ~7 us to wrap)."""
    check(fn(*args, current_stream()), name)


def current_stream() -> int:
    """The raw handle of the current device's current stream."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def on_device(dev: torch.device):
    """``dev`` made current for the block, unless it is already."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


@functools.cache
def sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def stream_scratch(dev: torch.device, words: int) -> torch.Tensor:
    """At least ``words`` int32 of scratch for kernels launched on the
    current stream of ``dev`` (current for the caller): one buffer a
    (device, stream), which launches on that stream share, since they run
    in order."""
    key = (dev.index, current_stream())
    with _lock:
        buf = _scratch.get(key)
        if buf is None or buf.numel() < words:
            buf = torch.empty(max(words, 1024), dtype=torch.int32, device=dev)
            _scratch[key] = buf
        return buf


_scratch: dict[tuple[int, int], torch.Tensor] = {}
