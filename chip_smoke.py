"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--topk-baseline OLD_CHECKOUT/financial_rag_system_tpu_torch/csrc]
                          [--ivf-baseline OLD_CHECKOUT/financial_rag_system_tpu_torch/csrc]
                          [--attn-baseline OLD_CHECKOUT/financial_rag_system_tpu_torch/csrc]
                          [--ffn-baseline OLD_CHECKOUT/financial_rag_system_tpu_torch/csrc]
                          [--resid-baseline OLD_CHECKOUT/financial_rag_system_tpu_torch/csrc]

Drives ``financial_rag_system_tpu_torch`` end to end on the card, in
nine phases; any failure raises and the script exits non-zero:

0. the card: name, power limit and compute capability (Hopper, 9.0);
1. build: every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a``
   into ``build/torch_kernels/`` (all sources in parallel);
2. each kernel against its plain PyTorch version at the main path's
   shapes, with its time, the plain version's, a PyTorch library call's
   where one computes the same function, and its bound on the H100;
   kernel 2 at the rerank shape on the table's mask (uniform lengths)
   and on a mask with every key valid, each beside its bound (the bytes
   and products of the keys that mask leaves) and its MUFU floor (and
   after phase 3 on that batch's own rerank mask); kernel 2's streaming
   kernel at heads of 64 (12) and 128 (6) at the rerank shape, and heads
   of 24 and 40 (12), which the wrapper pads to 32 and 48; kernels 1 and 3
   at k 33, 64, 100, 256, 1024 and 2048 (rounds of 32) in bf16 and int8,
   with times, and bit for bit on tie-heavy exact rows; kernels 1 and 3 at
   D 1536 and k 15 (one block an SM) in bf16, int8 (bit for bit) and on
   tie-heavy exact bf16 rows (bit for bit);
3. the main path: ``build_default_engine(device="cuda")`` over
   random-init full-width BGE-small and MiniLM-L6 checkpoints and a
   persisted 131,072-row flat index with a 368-wide token store; three
   single asks, two bursts of 32 concurrent asks (one fused batch each)
   and a cache hit,
   with the kernels' launch counts read around the run (the query embed,
   below S 256, takes the JAX einsum path's attention, so kernel 2
   launches in the 6 rerank layers only), then one batch checked against
   the same pipeline run on the CPU, and the batch of 32 with the embed's
   attention as the einsum path and as kernel 2 compute it (their top-15
   overlap);
4. the IVF path (BASELINE config 3): a clustered 1,048,576-row corpus
   built on the card, ``engine.rebuild_index("ivf")`` (the call behind
   ``POST /index/rebuild``) with its build time by step, three single
   asks, two bursts of 32, a rare-ticker ask on the staged path, an
   upsert and an ask that must find it, and a cache hit, with the launch
   counts read around the run; then kernel 3 against its plain version on
   a real batch's probe list, its time beside kernel 1's over the same
   corpus, the fused batch's recall@15 against the exact flat top-15, a
   profile of one fused IVF batch, and an IVF index built on the card and
   loaded on the CPU (65,536 rows) checked against it;
5. the fused-block path: phase 3 again with ``RAG_TPU_FUSED_BLOCK=1``
   (a new engine from the same checkpoints and index), where kernels 4-6
   launch 18 times a batch (they launch never in phases 3 and 4); one batch checked against the CPU pipeline (plain
   versions) and against the card's unfused tanh layer; a profile of a
   batch of 32 each way; kernels 4-6 against their plain versions at the
   rerank and embed shapes, with their times beside the plain version's,
   the unfused layer's torch sequence for the same half-layer, a library
   call where one computes the same function, and the bound; kernel 4
   also beside its two products alone (``gemms_ms``), with its device
   time from the profiler, its plan and the weight bytes it draws from
   L2; kernel 6 (bf16 context at the rerank shape, f32 at the embed
   shape, as the main path gives them, and the other type checked too)
   beside its product alone (``gemm_ms``), with its device time, its
   plan (cluster size, blocks on SMs, W_o bytes from L2) and its
   device-memory rate beside a plain copy's;
6. int8 corpora (``RAG_TPU_INDEX_DTYPE=int8``): the phase-3 corpus saved
   as an int8 ``flat_index.npz`` and served through
   ``build_default_engine(device="cuda")`` (3 single asks, a burst of 32,
   a cache hit), one batch against the CPU pipeline (the same rows),
   the int8 top-15 against the bf16 top-15 of the same vectors (reported
   only), the int8 branch of kernel 1 against its plain version bit for
   bit; then phase 4 over an int8 corpus of 1,048,576 rows (one burst),
   with the int8 branch of kernel 3 against its plain version bit for bit
   and recall@15 against the exact int8 flat top-15;
7. the hash stack, as the port starts with no checkpoints: the hash
   tables drawn and checked bit for bit, a 131,072-row index of hash bags
   with its token store, ``build_default_engine(device="cuda")`` with the
   de-aliased hash rerank (3 single asks, a burst of 32, a cache hit;
   kernel 1's launches), one batch against the CPU; ``rebuild_index("ivf")``
   and a burst on the fused IVF hash program (kernel 3's launches, recall@15
   against the flat hash top-15); a TESTING-mode engine's ask in retrieval
   order;
8. the HNSW path: a persisted 131,072-row clustered index (8 tickers, so
   no burst filter is selective, and 1,000 rows of a rare ticker) behind
   ``build_default_engine(device="cuda")`` with phase 3's checkpoints and
   the C++ tokenizer, ``engine.rebuild_index("hnsw")`` (the native graph
   built with g++ at first use, JAX's defaults and routing aids) with its
   seconds by step, 3 single asks, two bursts of 32 (one fused
   ``hnsw_full`` batch each), a rare-ticker ask on the staged path, an
   upsert that enters the graph online and an ask that finds it, a cache
   hit, the launches read around the run (kernel 2 six times a fused
   batch, kernel 1 on the staged ask); the fused batch's recall@15 against
   the exact flat top-15; the graph saved on the card and loaded on the
   CPU, and the walk of the card's query vectors on both (rows identical
   wherever neighbouring scores differ by more than 1e-5) with the CPU
   rerank of the card's rows; a fused batch split into embed, routing and
   walk, gather and rerank, and the walk's device time, launches and wall
   time from the profiler; the same rows as an int8 corpus on the same
   graph, one burst, and the card's walk bit for bit with the CPU's.

The CPU references of phases 3-6 set ``RAG_TPU_FAST_GELU=1``: the card's
default GELU is the tanh form and the CPU's exact erf, JAX's rule.

Kernels 1 and 3 log, beside each CUDA-event time, their device time by
kernel (profiler), the wrapper's host time a call and their launch plan
(blocks, stages, work a block, merge candidates): kernel 1 at phase 2's
shape in both branches and over the IVF corpus's flat rows, kernel 3 on
the real and the diverse batch's lists in both branches.

``--topk-baseline`` also builds the ``masked_topk.cu`` of an earlier
checkout (its C entry that takes the plan, PR 10 on), holds kernel 1 bit
for bit against it in both branches and times both in turns with their
device times;
``--ivf-baseline`` does the same for an earlier ``ivf_probe.cu`` and
kernel 3 on both lists (bit for bit on the real list, and on the diverse
one in int8); ``--attn-baseline``
builds an earlier ``pair_attention.cu`` and times it beside kernel 2 on
the same inputs and masks, in turns, with their contexts' difference;
``--ffn-baseline`` builds an earlier ``fused_bert.cu`` and times its FFN
kernel beside kernel 4 at both shapes the same way; ``--resid-baseline``
the same for its o-proj kernel beside kernel 6 (a checkout whose C entry
took no plan).

The last lines are the ``kernels`` JSON line, the card's name and power
limit as ``nvidia-smi`` gives them, and ``{"ok": true, "device": ...}``.
Nothing is fetched; weights and data come from fixed seeds.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PACKAGE = "financial_rag_system_tpu_torch"

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12

# main-path shapes
B, N, D, K = 32, 131_072, 384, 15
N_TICKERS, DOC_TYPES = 50, ("10-K", "10-Q", "8-K")
DLEN = 368        # token-store width measured at 1000-character chunks
PAIRS = B * K     # 480 rerank pairs per fused batch of 32
SEED = 0

# IVF path: BASELINE config 3, "1M-chunk corpus: HNSW/IVF index build +
# query kernels on a single chip"
N_IVF = 1_048_576
N_TOPICS = 512        # topic centres of the synthetic clustered corpus
TOPIC_NOISE = 0.3     # a row is normalize(centre + TOPIC_NOISE * g / sqrt(D))
RARE, RARE_ROWS = "RARE", 1_000   # a selective ticker: staged path
N_CPU_CHECK = 65_536
IVF_GEOMETRY = (512, 16, 4096, 32, 16_384)  # clusters, nprobe, c_max, tiles/cluster, tiles


def log(*a) -> None:
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    """The larger of the bytes over the memory rate and the operations
    over ``peak`` (the bf16 tensor-core rate unless given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 0/1 ---------------------------------------------------------------


def phase_card() -> str:
    import torch

    smi = smi_line()
    cap = torch.cuda.get_device_capability(0)
    log(f"[card] {smi}; capability {cap}; torch {torch.__version__} "
        f"(CUDA {torch.version.cuda})")
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (capability 9.0), got {cap}")
    return smi


def phase_build() -> None:
    from financial_rag_system_tpu_torch.ops import _cuda

    shutil.rmtree(_cuda.BUILD_DIR, ignore_errors=True)  # build from sources
    secs = _cuda.build_all()
    built = sorted(p.name for p in _cuda.BUILD_DIR.glob("*.so"))
    log(f"[build] {built} in {secs:.2f} s")
    if len(built) != len(list(_cuda.CSRC_DIR.glob("*.cu"))):
        raise RuntimeError("not every kernel source built")


# -- phase 2: kernels against their plain versions ----------------------------


def topk_inputs(torch, rng, n_valid):
    import numpy as np

    q = rng.standard_normal((B, D)).astype(np.float32)
    c = rng.standard_normal((N, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    c[70_001] = c[70_000]                       # exact duplicates tie
    codes = np.stack([
        rng.integers(0, N_TICKERS, N), rng.integers(0, len(DOC_TYPES), N),
    ]).astype(np.int32)
    codes[0, [17, 40_000, 90_000]] = N_TICKERS  # a ticker on 3 rows only
    codes[:, n_valid:] = -2
    qf = np.stack([
        rng.integers(-1, N_TICKERS, B), rng.integers(-1, len(DOC_TYPES), B),
    ], axis=1).astype(np.int32)
    qf[0] = (N_TICKERS, -1)
    qf[1] = (-1, -1)
    q[1] = c[70_000]
    dev = torch.device("cuda")
    return (torch.tensor(q, device=dev).bfloat16(), torch.tensor(c, device=dev).bfloat16(),
            torch.tensor(codes, device=dev), torch.tensor(qf, device=dev))


@functools.cache
def baseline_lib(name: str, csrc: Path):
    """``<name>.cu`` of ``csrc`` (an earlier checkout's), built with the
    port's flags, once."""
    import ctypes

    from financial_rag_system_tpu_torch.ops import _cuda

    out = _cuda.BUILD_DIR.parent / "torch_kernels_baseline" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(out),
                    str(csrc / f"{name}.cu")], check=True, timeout=300)
    return ctypes.CDLL(str(out))


@contextlib.contextmanager
def kernel_lib(name: str, lib):
    """The wrappers launch ``lib``'s kernels in place of ``<name>.so``'s
    meanwhile."""
    from financial_rag_system_tpu_torch.ops import _cuda

    current = _cuda.library(name)
    _cuda._libs[name] = lib
    try:
        yield
    finally:
        _cuda._libs[name] = current


def parent_topk_fn(torch, lib, args):
    """A launch of kernel 1 from an earlier ``masked_topk.cu`` whose C
    entry takes the plan (PR 10 on: blocks, stages, one scratch), on the
    wrapper's arguments at k <= 32; returns (scores, ids)."""
    import ctypes

    from financial_rag_system_tpu_torch.ops import _cuda
    from financial_rag_system_tpu_torch.ops.topk import topk_plan

    q, c, codes, qf, n_valid, k = args
    (b, d), n = q.shape, c.shape[0]
    plan = topk_plan(b, n, d, c.element_size(), k, sms(torch))
    fn = lib.masked_topk_s8 if c.dtype == torch.int8 else lib.masked_topk
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
    scratch = torch.empty(plan.scratch, dtype=torch.int32, device=c.device)
    out = torch.empty((2, b, k), dtype=torch.float32, device=c.device)

    def launch():
        _cuda.launch(fn, "parent masked_topk", q.data_ptr(), c.data_ptr(), codes.data_ptr(),
                     qf.data_ptr(), b, n, d, n_valid, k, plan.blocks, plan.stages,
                     scratch.data_ptr(), out.data_ptr())
        return out[0], out[1].view(torch.int32)
    return launch


def parent_probe_fn(torch, lib, args, tile: int):
    """A launch of kernel 3 from an earlier ``ivf_probe.cu`` whose C entry
    takes the plan (PR 10 on), at k <= 32; returns (scores, ids)."""
    import ctypes

    from financial_rag_system_tpu_torch.index.ivf import probe_plan
    from financial_rag_system_tpu_torch.ops import _cuda

    q, qf, emb, codes, gids, tl, k = args
    (b, d), n_packed, n_probe = q.shape, emb.shape[0], tl.numel()
    plan = probe_plan(b, n_probe, tile, d, emb.element_size(), k, sms(torch))
    fn = lib.ivf_probe_s8 if emb.dtype == torch.int8 else lib.ivf_probe
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3
    scratch = torch.empty(plan.scratch, dtype=torch.int32, device=emb.device)
    out = torch.empty((2, b, k), dtype=torch.float32, device=emb.device)

    def launch():
        _cuda.launch(fn, "parent ivf_probe", q.data_ptr(), emb.data_ptr(), codes.data_ptr(),
                     gids.data_ptr(), tl.data_ptr(), qf.data_ptr(), b, d, n_packed, tile,
                     n_probe, k, plan.blocks, plan.stages, scratch.data_ptr(),
                     out.data_ptr())
        return out[0], out[1].view(torch.int32)
    return launch


def against_parent(torch, tag: str, smi: str, parent, new, exact: bool = True) -> None:
    """The parent's kernel against the new one on the same inputs: bit for
    bit (scores and ids) where ``exact``, then both timed in turns (parent,
    new, new, parent), CUDA events and device time (profiler)."""
    got = [x.cpu().numpy().tobytes() for x in new()]
    want = [x.cpu().numpy().tobytes() for x in parent()]
    same = got == want
    if exact and not same:
        raise AssertionError(f"{tag}: differs from the parent's kernel")
    order = (parent, new, new, parent)
    events = [median_ms(fn, reps=30) for fn in order]
    device = [sum(device_split(torch, fn).values()) for fn in order]
    log(f"{tag} {smi}: bit for bit with the parent's kernel: {same}; in turns (parent, new, "
        f"new, parent): events {', '.join(f'{t:.4f}' for t in events)} ms; device "
        f"{', '.join(f'{t:.4f}' for t in device)} ms")


def plan_line(tag: str, plan, pieces: float | None = None) -> None:
    """A kernel-1 or kernel-3 launch plan: blocks, stages, work a block and
    the merge's candidates."""
    work = (f"{plan.tiles / plan.blocks:.1f} tiles a block" if pieces is None
            else f"{pieces / plan.blocks:.1f} live-candidate pieces a block")
    log(f"{tag} plan: {plan.blocks} blocks x {plan.qblocks} query blocks, {plan.stages} "
        f"stages, {plan.smem} B of shared memory, {work}, at most {plan.candidates} merge "
        f"candidates a query")


def sms(torch) -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def check_topk(torch, np, smi: str, baseline: Path | None = None) -> dict:
    from financial_rag_system_tpu_torch.ops.topk import masked_topk, masked_topk_plain, topk_plan

    n_valid = N - 100
    q, c, codes, qf = topk_inputs(torch, np.random.default_rng(SEED), n_valid)
    args = (q, c, codes, qf, n_valid, K)
    s, i = (x.cpu().numpy() for x in masked_topk(*args))
    torch.cuda.synchronize()
    s_ref, i_ref = (x.cpu().numpy() for x in masked_topk_plain(*args))
    fin = np.isfinite(s_ref)
    if not (np.isfinite(s) == fin).all():
        raise AssertionError("top-k: empty slots differ from the plain version")
    err = float(np.abs(s[fin] - s_ref[fin]).max())
    if err > 1e-4:
        raise AssertionError(f"top-k scores differ by {err} > 1e-4")
    with np.errstate(invalid="ignore"):
        gap = np.abs(s_ref[:, :, None] - s_ref[:, None, :])
    gap[:, np.arange(K), np.arange(K)] = np.inf
    clear = fin & (gap.min(axis=2) >= 1e-4)
    if not (i[clear] == i_ref[clear]).all() or not (i[~fin] == -1).all():
        raise AssertionError("top-k ids differ from the plain version")
    if fin[0].sum() != 3:
        raise AssertionError("the 3-row filter must give exactly 3 hits")
    if not (i[1, 0] == 70_000 and i[1, 1] == 70_001 and s[1, 0] == s[1, 1]):
        raise AssertionError("duplicated rows must tie, lower id first")
    ms = median_ms(lambda: masked_topk(*args), reps=50)
    plain_ms = median_ms(lambda: masked_topk_plain(*args), reps=10)
    nbytes = N * D * 2 + 2 * N * 4 + B * D * 2 + B * 2 * 4 + B * K * 8
    b_ms, b_by = bound_ms(nbytes, 2.0 * B * N * D)
    log(f"[topk] {smi}: B={B} N={N} D={D} K={K}: max_abs_err {err:.3g}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    retrieval_timing(torch, f"[topk] bf16 B={B} N={N}:", lambda: masked_topk(*args), ms, smi)
    plan_line(f"[topk] bf16 B={B} N={N}:", topk_plan(B, N, D, 2, K, sms(torch)))
    if baseline is not None:
        against_parent(torch, f"[topk] bf16 B={B} N={N}:", smi,
                       parent_topk_fn(torch, baseline_lib("masked_topk", baseline), args),
                       lambda: masked_topk(*args))
    return {
        "name": "masked_topk", "route": "cuda",
        "source": f"{PACKAGE}/csrc/masked_topk.cu",
        "replaces": "financial_rag_system_tpu/ops/topk.py:99",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


LARGE_K = (33, 64, 100, 256, 1024, 2048)
WIDE_D = 1536  # rows wider than two blocks an SM hold: one block an SM
PROBE_TILES, PROBE_ACTIVE = 2048, 1024  # phase 2's packing (128-row tiles) and probed tiles


def clear_ids_agree(np, s, i, s_ref, i_ref, what: str) -> tuple[float, int]:
    """Kernel against plain in bf16: the same empty slots, scores within
    1e-4, and the same ids wherever no neighbour in the list lies within
    that noise (f32 sums taken in another order), the last entry aside (a
    row past the list may tie it); returns the score error and the count
    of finite entries whose ids differ all the same."""
    fin = np.isfinite(s_ref)
    if not (np.isfinite(s) == fin).all() or not (i[~fin] == -1).all():
        raise AssertionError(f"{what}: empty slots differ from the plain version")
    err = float(np.abs(s[fin] - s_ref[fin]).max())
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(s_ref, axis=1))
    near = np.zeros_like(s_ref)
    near[:, 1:-1] = np.minimum(gap[:, :-1], gap[:, 1:])
    near[:, 0] = gap[:, 0]
    clear = fin & (near >= 1e-4)
    if err > 1e-4 or not (i[clear] == i_ref[clear]).all():
        raise AssertionError(f"{what}: scores differ by {err} or ids differ")
    return err, int((i[fin] != i_ref[fin]).sum())


def exact_rows(torch, n: int, distinct: int, seed: int, dtype, d: int = D):
    """``n`` rows of ``d`` values drawn from ``distinct`` integer vectors in
    -3..3 on the card: as bf16 (v / 16) their dot products are exact with
    f32 sums in any order, so the kernels meet their plain versions bit for
    bit, and the repeated rows tie for real."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.randint(-3, 4, (distinct, d), generator=g, device="cuda")
    rows = base[torch.randint(0, distinct, (n,), generator=g, device="cuda")]
    return rows.to(torch.int8) if dtype == torch.int8 else (rows.float() / 16).bfloat16()


def probe_packing(torch, np, rows_fn):
    """A packing of PROBE_TILES 128-row tiles (rows from ``rows_fn(n)``),
    30% padding slots, gids unrelated to packed order, codes as phase 2's
    corpus draws them, and a probe list of PROBE_ACTIVE ascending active
    tiles, then -1s, as probe_tile_list makes it."""
    rng = np.random.default_rng(SEED + 7)
    n = PROBE_TILES * 128
    gids = rng.permutation(4 * n)[:n].astype(np.int32)
    gids[rng.random(n) < 0.3] = -1
    codes = np.stack([rng.integers(0, N_TICKERS, n),
                      rng.integers(0, len(DOC_TYPES), n)]).astype(np.int32)
    tile_ids = np.full(2 * PROBE_ACTIVE, -1, np.int32)
    tile_ids[:PROBE_ACTIVE] = np.sort(rng.choice(PROBE_TILES, PROBE_ACTIVE, replace=False))
    dev = torch.device("cuda")
    return (rows_fn(n), torch.tensor(codes, device=dev), torch.tensor(gids[None, :], device=dev),
            torch.tensor(tile_ids, device=dev))


def check_large_k(torch, np, smi: str) -> None:
    """Kernels 1 and 3 at k above a 32-entry round (LARGE_K), against
    their plain versions: kernel 1 over phase 2's corpus, kernel 3 over a
    packing of PROBE_TILES tiles with PROBE_ACTIVE probed; random unit rows
    in bf16 (scores within 1e-4, ids where clear of that noise) and int8
    (bit for bit), each with its time, the plain version's and its bound;
    and tie-heavy exact rows in bf16, bit for bit.  Off the main paths,
    which take k 15."""
    from financial_rag_system_tpu_torch.index.flat import quantize_int8
    from financial_rag_system_tpu_torch.index.ivf import ivf_probe, ivf_probe_plain, probe_plan
    from financial_rag_system_tpu_torch.ops.topk import masked_topk, masked_topk_plain, topk_plan

    n_valid = N - 100
    q, c, codes, qf = topk_inputs(torch, np.random.default_rng(SEED), n_valid)
    normalize = torch.nn.functional.normalize
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    unit = lambda n: normalize(torch.randn(n, D, generator=g, device="cuda"), dim=1)  # noqa: E731
    emb = unit(PROBE_TILES * 128)
    _, pcodes, gids, tile_ids = probe_packing(torch, np, lambda n: None)
    live = int((gids[0].view(-1, 128)[tile_ids[:PROBE_ACTIVE].long()] >= 0).sum())
    cases = {
        "bf16": (q, c, q, emb.bfloat16()),
        "int8": (quantize_int8(q), quantize_int8(c), quantize_int8(q), quantize_int8(emb)),
    }
    for k in LARGE_K:
        for dtype, (q1, c1, q3, e3) in cases.items():
            elt = c1.element_size()
            peak = INT8_OP_PER_S if elt == 1 else BF16_FLOP_PER_S
            flat = (q1, c1, codes, qf, n_valid, k)
            probe = (q3, qf, e3, pcodes, gids, tile_ids, k)
            for name, fn, plain, nbytes, ops, plan in (
                ("kernel 1", lambda: masked_topk(*flat), lambda: masked_topk_plain(*flat),
                 N * (D * elt + 8) + B * (D * elt + 8) + B * k * 8, 2.0 * B * N * D,
                 topk_plan(B, N, D, elt, k, sms(torch))),
                ("kernel 3", lambda: ivf_probe(*probe, tile=128),
                 lambda: ivf_probe_plain(*probe, tile=128),
                 PROBE_ACTIVE * 128 * 4 + live * (D * elt + 8) + B * (D * elt + 8) + B * k * 8,
                 2.0 * B * live * D,
                 probe_plan(B, tile_ids.numel(), 128, D, elt, k, sms(torch))),
            ):
                what = f"[large-k] {name} {dtype} k={k}"
                s, i = (x.cpu().numpy() for x in fn())
                torch.cuda.synchronize()
                s_ref, i_ref = (x.cpu().numpy() for x in plain())
                if dtype == "int8":
                    if s.tobytes() != s_ref.tobytes() or i.tobytes() != i_ref.tobytes():
                        raise AssertionError(f"{what}: not bit for bit with the plain version")
                    err, n_diff = 0.0, 0
                else:
                    err, n_diff = clear_ids_agree(np, s, i, s_ref, i_ref, what)
                ms = median_ms(fn, reps=10)
                plain_ms = median_ms(plain, reps=3)
                b_ms, b_by = bound_ms(nbytes, ops, peak)
                log(f"{what} {smi}: B={B} D={D}, {plan.rounds} rounds: max_abs_err {err:.3g}, "
                    f"finite ids differing {n_diff} of {int(np.isfinite(s_ref).sum())}, "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                    f"({b_by})")
        # tie-heavy exact rows: bit for bit in bf16 too
        xq = exact_rows(torch, B, 3, SEED + k, torch.bfloat16)
        xc = exact_rows(torch, N, 6, SEED + k + 1, torch.bfloat16)
        xe = exact_rows(torch, PROBE_TILES * 128, 6, SEED + k + 2, torch.bfloat16)
        for name, fn, plain in (
            ("kernel 1", lambda: masked_topk(xq, xc, codes, qf, n_valid, k),
             lambda: masked_topk_plain(xq, xc, codes, qf, n_valid, k)),
            ("kernel 3", lambda: ivf_probe(xq, qf, xe, pcodes, gids, tile_ids, k, tile=128),
             lambda: ivf_probe_plain(xq, qf, xe, pcodes, gids, tile_ids, k, tile=128)),
        ):
            got = [x.cpu().numpy().tobytes() for x in fn()]
            if got != [x.cpu().numpy().tobytes() for x in plain()]:
                raise AssertionError(f"[large-k] {name} bf16 exact rows k={k}: not bit for bit")
    log(f"[large-k] {smi}: kernels 1 and 3 at k {list(LARGE_K)} agree with their plain "
        f"versions (bf16 tie-heavy rows bit for bit, int8 bit for bit)")


def check_wide_rows(torch, np, smi: str) -> None:
    """Kernels 1 and 3 at D = WIDE_D, k 15 (plans of one block an SM),
    against their plain versions: random unit rows in bf16 (scores within
    1e-4, ids where clear of that noise, and the count that differ) and
    int8 (bit for bit: exact sums cast once, rounding above D 1040), and
    tie-heavy exact rows in bf16, every id and score bit for bit; with the
    kernels' times, the plain versions' and the bounds.  Off the main
    paths, which take D 384."""
    from financial_rag_system_tpu_torch.index.flat import quantize_int8
    from financial_rag_system_tpu_torch.index.ivf import ivf_probe, ivf_probe_plain, probe_plan
    from financial_rag_system_tpu_torch.ops.topk import masked_topk, masked_topk_plain, topk_plan

    d, n_valid = WIDE_D, N - 100
    _, _, codes, qf = topk_inputs(torch, np.random.default_rng(SEED), n_valid)
    _, pcodes, gids, tile_ids = probe_packing(torch, np, lambda n: None)
    live = int((gids[0].view(-1, 128)[tile_ids[:PROBE_ACTIVE].long()] >= 0).sum())
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    unit = lambda n: torch.nn.functional.normalize(  # noqa: E731
        torch.randn(n, d, generator=g, device="cuda"), dim=1)
    q, c, emb = unit(B), unit(N), unit(PROBE_TILES * 128)
    cases = {
        "bf16": (q.bfloat16(), c.bfloat16(), emb.bfloat16()),
        "int8": (quantize_int8(q), quantize_int8(c), quantize_int8(emb)),
        "bf16 exact": (exact_rows(torch, B, 3, SEED + 20, torch.bfloat16, d),
                       exact_rows(torch, N, 6, SEED + 21, torch.bfloat16, d),
                       exact_rows(torch, PROBE_TILES * 128, 6, SEED + 22, torch.bfloat16, d)),
    }
    for dtype, (qd, cd, ed) in cases.items():
        elt = cd.element_size()
        peak = INT8_OP_PER_S if elt == 1 else BF16_FLOP_PER_S
        flat = (qd, cd, codes, qf, n_valid, K)
        probe = (qd, qf, ed, pcodes, gids, tile_ids, K)
        for name, fn, plain, nbytes, ops, plan in (
            ("kernel 1", lambda: masked_topk(*flat), lambda: masked_topk_plain(*flat),
             N * (d * elt + 8) + B * (d * elt + 8) + B * K * 8, 2.0 * B * N * d,
             topk_plan(B, N, d, elt, K, sms(torch))),
            ("kernel 3", lambda: ivf_probe(*probe, tile=128),
             lambda: ivf_probe_plain(*probe, tile=128),
             PROBE_ACTIVE * 128 * 4 + live * (d * elt + 8) + B * (d * elt + 8) + B * K * 8,
             2.0 * B * live * d, probe_plan(B, tile_ids.numel(), 128, d, elt, K, sms(torch))),
        ):
            what = f"[wide-d] {name} {dtype} D={d} k={K}"
            s, i = (x.cpu().numpy() for x in fn())
            torch.cuda.synchronize()
            s_ref, i_ref = (x.cpu().numpy() for x in plain())
            if dtype != "bf16":
                if s.tobytes() != s_ref.tobytes() or i.tobytes() != i_ref.tobytes():
                    raise AssertionError(f"{what}: not bit for bit with the plain version")
                err, n_diff = 0.0, 0
            else:
                err, n_diff = clear_ids_agree(np, s, i, s_ref, i_ref, what)
            ms = median_ms(fn, reps=10)
            plain_ms = median_ms(plain, reps=3)
            b_ms, b_by = bound_ms(nbytes, ops, peak)
            log(f"{what} {smi}: B={B}, plan {plan.blocks} blocks x {plan.stages} stages: "
                f"max_abs_err {err:.3g}, finite ids differing {n_diff} of "
                f"{int(np.isfinite(s_ref).sum())}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by})")


def attention_inputs(torch, np, p: int, s: int, h: int = 12, d: int = 32):
    """Random (p, s, h, d) f32 q, k and v on the card, and the kernel
    table's mask: lengths uniform in 1..s, pair 0 whole, the last pair
    fully padded."""
    rng = np.random.default_rng(SEED + s)
    dev = torch.device("cuda")
    q, k, v = (torch.tensor(rng.standard_normal((p, s, h, d)), dtype=torch.float32,
                            device=dev) for _ in range(3))
    lens = rng.integers(1, s + 1, p)
    lens[0] = s
    mask_np = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    mask_np[-1] = 0                              # a fully padded pair
    return q, k, v, mask_np


def attended_keys(np, mask_np):
    """The keys each pair's softmax spans: its valid keys, or all S keys
    for a pair with none (its softmax is uniform over them)."""
    n_valid = (mask_np > 0).sum(axis=1)
    return np.where(n_valid > 0, n_valid, mask_np.shape[1])


def attention_bound(np, mask_np, h: int, d: int = 32) -> tuple[float, str]:
    """Kernel 2's bound on one mask, from what the function needs: q in
    and the context out for every query row, K and V of the attended keys
    only (a masked key adds exactly 0 to a row with a valid key), the
    mask; QK^T and P.V once over the same keys."""
    p, s = mask_np.shape
    keys = float(attended_keys(np, mask_np).sum())
    nbytes = 2 * p * s * h * d * 2 + 2 * keys * h * d * 2 + p * s * 4
    return bound_ms(nbytes, 4.0 * h * s * d * keys)


def mufu_floor_ms(torch, np, mask_np, h: int) -> float:
    """The least time the card's MUFU units take for the exponentials the
    mask needs: each query row of a pair against each of its attended
    keys, at 16 ``MUFU.EX2`` a clock on each SM at the top SM clock that
    ``nvidia-smi`` reports."""
    s = mask_np.shape[1]
    exps = float(h * s * attended_keys(np, mask_np).sum())
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return exps / (sms * 16 * mhz * 1e6) * 1e3


def time_attention_mask(torch, np, smi: str, label: str, q, k, v, mask_np,
                        baseline=None) -> dict:
    """Kernel 2 on one mask: against its plain version (1e-2), its time
    beside the mask's bound and MUFU floor, and the mask's kend (1 + a
    pair's last valid key) spread.  With ``baseline`` (an earlier build of the
    kernel, ``--attn-baseline``): the largest difference between its
    context and this kernel's on the same inputs, and both timed in turns
    (old, new, new, old)."""
    from financial_rag_system_tpu_torch.ops import attention as attn

    p, s, h, d = q.shape
    mask = torch.tensor(mask_np, device=q.device)
    inv = 1.0 / d ** 0.5
    got = attn.encoder_self_attention(q, k, v, mask, inv)
    torch.cuda.synchronize()
    ref = attn.encoder_self_attention_plain(q, k, v, mask, inv)
    if not torch.isfinite(got).all():
        raise AssertionError(f"attention, {label} mask, S={s}: non-finite output")
    err = float((got - ref).abs().max())
    if err > 1e-2:
        raise AssertionError(f"attention, {label} mask, S={s}: differs by {err} > 1e-2")
    qs, kb, vb = attn.kernel_inputs(q, k, v, inv)  # heads padded to a multiple of 16

    def kernel():
        return attn.pair_attention_kernel(qs, kb, vb, mask)

    ms = median_ms(kernel, reps=20)
    valid = mask_np > 0
    kend = np.where(valid.any(axis=1), s - np.argmax(valid[:, ::-1], axis=1), 0)
    b_ms, b_by = attention_bound(np, mask_np, h, d)
    mufu = mufu_floor_ms(torch, np, mask_np, h)
    line = (f"[attention] {smi}: {label} mask, P={p} S={s} H={h} d={d}: max_abs_err {err:.3g}, "
            f"kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), MUFU floor {mufu:.4f} ms; "
            f"kend min {kend.min()} mean {kend.mean():.1f} max {kend.max()}")
    if baseline is not None:
        new = kernel()
        with kernel_lib("pair_attention", baseline):
            old = kernel()
            torch.cuda.synchronize()
        diff = float((new.float() - old.float()).abs().max())

        def old_ms():
            with kernel_lib("pair_attention", baseline):
                return median_ms(kernel, reps=20)

        turns = [old_ms(), median_ms(kernel, reps=20), median_ms(kernel, reps=20), old_ms()]
        line += (f"; baseline: context max abs diff {diff:.3g}, old, new, new, old "
                 f"{[round(t, 4) for t in turns]} ms")
    log(line)
    return {"max_abs_err": err, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
            "mufu_ms": mufu,
            "qs": qs, "kb": kb, "vb": vb, "mask": mask}


def check_attention_at(torch, np, smi: str, p: int, s: int, h: int = 12,
                       all_valid: bool = False, baseline=None, d: int = 32) -> dict:
    """Kernel 2 at one shape on the table's mask (uniform lengths), and,
    with ``all_valid``, on a mask with every key valid (nothing to skip);
    the plain version's time, SDPA's and the bound on the table's mask."""
    from financial_rag_system_tpu_torch.ops import attention as attn

    q, k, v, mask_np = attention_inputs(torch, np, p, s, h, d)
    if all_valid:
        time_attention_mask(torch, np, smi, "all-valid", q, k, v, np.ones_like(mask_np),
                            baseline)
    res = time_attention_mask(torch, np, smi, "uniform-length", q, k, v, mask_np, baseline)
    inv = 1.0 / d ** 0.5
    mask = res["mask"]
    plain_ms = median_ms(
        lambda: attn.encoder_self_attention_plain(q, k, v, mask, inv), reps=5
    )
    # yardstick only: one PyTorch call for the same function (the port never calls it)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (res["qs"], res["kb"], res["vb"]))
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = median_ms(lambda: sdpa(qh, kh, vh, attn_mask=bias, scale=1.0), reps=20)
    log(f"[attention] {smi}: P={p} S={s} H={h} d={d}: max_abs_err {res['max_abs_err']:.3g}, "
        f"kernel {res['ms']:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
        f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}), MUFU floor "
        f"{res['mufu_ms']:.4f} ms")
    return {key: res[key] for key in ("max_abs_err", "ms", "bound_ms", "bound_by")} | {
        "plain_ms": plain_ms, "library_ms": library_ms}


def check_attention(torch, np, smi: str, baseline=None) -> dict:
    rerank = check_attention_at(torch, np, smi, PAIRS, 400, all_valid=True, baseline=baseline)
    # the query embed's shape: the main paths take the einsum path there
    # (S < 256), RAG_TPU_PAIR_ATTN=1 sends it to the kernel
    check_attention_at(torch, np, smi, B, 32)
    # wider heads, the streaming kernel: a 768-wide BERT-base cross-encoder
    # (12 heads of 64) and 6 heads of 128 at the rerank shape; off the main
    # paths, whose models have heads of 32
    for h, d in ((12, 64), (6, 128)):
        check_attention_at(torch, np, smi, PAIRS, 400, h=h, d=d)
    # heads that are not a multiple of 16, zero-padded to 32 (the
    # persistent kernel) and 48 (the streaming one) by the wrapper
    for d in (24, 40):
        check_attention_at(torch, np, smi, PAIRS, 400, h=12, d=d)
    return {
        "name": "pair_attention", "route": "cuda",
        "source": f"{PACKAGE}/csrc/pair_attention.cu",
        "replaces": "financial_rag_system_tpu/ops/attention.py:48",
        **rerank,
    }


def rerank_batch_mask(torch, np, main: dict):
    """The key mask of the rerank pairs of one flat batch of 32 on the
    card, as the encoder hands it to attention (all six layers alike)."""
    from financial_rag_system_tpu_torch.models import bert

    engine = main["engine"]
    seen = []
    original = bert.encoder_self_attention

    def spy(q, k, v, attention_mask, *args, **kwargs):
        if q.shape[1] >= 256:
            seen.append(attention_mask.to(torch.int32).cpu().numpy())
        return original(q, k, v, attention_mask, *args, **kwargs)

    bert.encoder_self_attention = spy
    try:
        flat_batch(torch, engine, main["burst"], "cuda", engine.index,
                   (engine.embedder, engine.reranker))
    finally:
        bert.encoder_self_attention = original
    if len(seen) != 6 or any((m != seen[0]).any() for m in seen):
        raise AssertionError(f"the rerank layers saw {len(seen)} masks, not one mask 6 times")
    return seen[0]


def check_attention_batch_mask(torch, np, main: dict, smi: str, baseline=None) -> None:
    """Kernel 2 on the phase-3 batch's own rerank mask (the query-side
    hole, the documents' lengths), with random q, k and v."""
    mask_np = rerank_batch_mask(torch, np, main)
    p, s = mask_np.shape
    q, k, v, _ = attention_inputs(torch, np, p, s)
    time_attention_mask(torch, np, smi, "phase-3 rerank", q, k, v, mask_np, baseline)


# -- phase 3: the main path -----------------------------------------------------


def write_checkpoints(torch, work: Path) -> None:
    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.models.hf_export import save_bert_checkpoint

    for name, cfg, seed, cross in (
        ("bge", bert.BGE_SMALL, 0, False), ("reranker", bert.MINILM_L6_CROSS, 1, True),
    ):
        model = bert.BertModel(cfg, device="cpu")
        bert.load_jax_params(
            model, bert.init_params(torch.Generator().manual_seed(seed), cfg)
        )
        save_bert_checkpoint(model, cfg, str(work / name), cross_encoder=cross)


def write_index(torch, np, work: Path, name: str = "index", n_tickers: int = N_TICKERS,
                embed=None) -> None:
    """131,072 unit rows, ~``n_tickers`` tickers x 3 doc types, a 368-wide
    token store of random wordpiece ids, short texts as payloads, saved
    to ``work / name``.  The rows are random, or ``embed(dtok)`` of the
    (N, DLEN) token store."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.models.tokenizer import SEP_ID

    rng = np.random.default_rng(SEED + 1)
    emb = rng.standard_normal((N, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    lens = rng.integers(DLEN // 2, DLEN + 1, N)
    dtok = rng.integers(1000, 30522, (N, DLEN)).astype(np.int32)
    dtok[np.arange(N), lens - 1] = SEP_ID
    dtok *= np.arange(DLEN)[None, :] < lens[:, None]
    if embed is not None:
        emb = embed(dtok)
    tick = rng.integers(0, n_tickers, N)
    dtyp = rng.integers(0, len(DOC_TYPES), N)
    index = FlatIndex(D, capacity=N, token_store_len=DLEN, device="cpu")
    codes = np.empty((2, N), np.int32)
    for r in range(N):
        payload = {"ticker": f"T{tick[r]:02d}", "document_type": DOC_TYPES[dtyp[r]],
                   "source_file": f"filing_{r // 64}.txt"}
        index.store.upsert(f"chunk-{r}", f"chunk {r} of T{tick[r]:02d} "
                           f"{DOC_TYPES[dtyp[r]]}", payload)
        codes[:, r] = index.store.codes_for(payload)
    index._arrays = (torch.from_numpy(emb).bfloat16(), torch.from_numpy(codes),
                     torch.from_numpy(dtok))
    index.save(str(work / name))


def kernel_counters() -> dict:
    """Each kernel's launch counter by its name in the ``kernels`` line:
    (wrapper, attribute).  The int8 branches of kernels 1 and 3 count
    apart from their bf16 branches."""
    from financial_rag_system_tpu_torch.index.ivf import ivf_probe
    from financial_rag_system_tpu_torch.ops import fused_bert
    from financial_rag_system_tpu_torch.ops.attention import encoder_self_attention
    from financial_rag_system_tpu_torch.ops.topk import masked_topk

    return {"masked_topk": (masked_topk, "launches"),
            "masked_topk_int8": (masked_topk, "launches_int8"),
            "pair_attention": (encoder_self_attention, "launches"),
            "ivf_probe": (ivf_probe, "launches"),
            "ivf_probe_int8": (ivf_probe, "launches_int8"),
            **{name: (getattr(fused_bert, name), "launches")
               for name in ("fused_ffn_ln", "fused_qkv", "fused_resid_ln")}}


def reset_launches() -> None:
    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)


def read_launches() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in kernel_counters().items()}


def want_launches(**counts: int) -> dict:
    """Every kernel's expected launches: 0 unless given."""
    return {name: counts.get(name, 0) for name in kernel_counters()}


FUSED_BLOCK_KERNELS = ("fused_ffn_ln", "fused_qkv", "fused_resid_ln")
# phase 5's opt-in: alone, as the JAX gate takes it (the card's GELU is
# tanh by default, the kernels' own)
FUSED_BLOCK_ENV = {"RAG_TPU_FUSED_BLOCK": "1"}
# the CPU references of phases 3-6: the card's default GELU is tanh and the
# CPU's exact erf (JAX's accelerator rule), so the CPU side is asked for tanh
CPU_TANH = {"RAG_TPU_FAST_GELU": "1"}


def drive_main_path(torch, np, work: Path, smi: str, label: str = "main",
                    index: str = "index", rounds: int = 2) -> dict:
    """The flat tier through ``build_default_engine(device="cuda")`` over
    the index saved in ``work / index``: 3 single asks, ``rounds`` bursts
    of 32 and a cache hit.  ``label`` tags the log lines and, past the
    first run, the questions, so that no ask of a later run is a cache hit
    of an earlier one.  Kernel 1's bf16 or int8 branch launches once a
    batch, as the index is; kernel 2 once a rerank layer (the query embed,
    below S 256, takes the einsum path); the fused-block kernels 18 times
    a batch when the caller has set their opt-in, else never."""
    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.models.tokenizer import pad_batch
    from financial_rag_system_tpu_torch.obs.tracing import get_tracer
    from financial_rag_system_tpu_torch.serving.app import build_default_engine
    from financial_rag_system_tpu_torch.utils.config import reset_config

    os.environ.update({
        "RAG_TPU_BGE_DIR": str(work / "bge"),
        "RAG_TPU_RERANKER_DIR": str(work / "reranker"),
        "INDEX_DIR": str(work / index),
        "TESTING": "true",
        "DATABASE_URL": str(work / "cache.db"),
        "RAG_TPU_CB_PATH": str(work / "breaker.json"),
        # a fixed window long enough that 32 concurrent asks form one batch
        "RAG_TPU_BATCH_WINDOW_S": "0.25",
        "RAG_TPU_BATCH_EAGER_IDLE_S": "0",
    })
    reset_config()
    engine = build_default_engine(device="cuda")
    if engine.queue_status()["fused_kind"] != "full":
        raise AssertionError(f"fused_kind {engine.queue_status()['fused_kind']!r}")
    if engine.index.n_valid != N or engine.index.token_store_len != DLEN:
        raise AssertionError("the persisted index did not load whole")

    batches: list[tuple[int, float]] = []
    inner = engine.batcher.batch_fn

    def timed_batch(queries, filters):
        t0 = time.perf_counter()
        out = inner(queries, filters)
        batches.append((len(queries), (time.perf_counter() - t0) * 1e3))
        return out

    engine.batcher.batch_fn = timed_batch
    # the engine admits 25 asks at once (the reference's LLM concurrency
    # cap); lift it so the 32-ask burst reaches the batcher whole
    engine.llm_semaphore = asyncio.Semaphore(B)
    tickers = [f"T{i:02d}" for i in range(N_TICKERS)]
    tag = "" if label == "main" else f" ({label})"
    singles = [(f"what was revenue growth in the last quarter{tag}", tickers[3], None),
               (f"analyze the margin trajectory{tag}", tickers[7], "10-K"),
               (f"supply chain risk{tag}", tickers[11], None)]
    burst = [(f"question {i} about segment results and liquidity{tag}", tickers[i % N_TICKERS],
              DOC_TYPES[i % 3] if i % 2 else None) for i in range(B)]

    async def scenario():
        await engine.startup()
        try:
            answers = [await engine.ask(q, t, 5, d) for q, t, d in singles]
            # two bursts: the first pays the one-time costs of a new batch
            # shape (allocator growth, GEMM heuristics); the second is warm
            for n in range(rounds):
                answers += await asyncio.gather(*[
                    engine.ask(f"{q} (round {n})", t, 5, d) for q, t, d in burst
                ])
            await asyncio.sleep(0.2)  # write-behind cache saves land
            repeat = await engine.ask(*singles[0][:2], 5, singles[0][2])
        finally:
            await engine.shutdown()
        return answers, repeat

    fused_block = bert._fused_block_enabled(engine.embedder.model)
    get_tracer().reset()  # the stage split below is this run's
    reset_launches()
    answers, repeat = asyncio.run(scenario())
    launches = read_launches()

    n_batches = len(batches)
    if [n for n, _ in batches] != [1, 1, 1] + [B] * rounds:
        raise AssertionError(f"batch sizes {[n for n, _ in batches]} != [1, 1, 1] + "
                             f"[{B}] * {rounds}")
    # per fused batch: one top-k, attention once a rerank layer (6), and
    # the fused-block kernels once a layer (12 embed + 6 rerank) under
    # their opt-in
    topk = "masked_topk_int8" if engine.index.quantized else "masked_topk"
    want = want_launches(**{topk: n_batches, "pair_attention": 6 * n_batches},
                         **dict.fromkeys(FUSED_BLOCK_KERNELS, 18 * n_batches if fused_block else 0))
    if launches != want:
        raise AssertionError(f"[{label}] launches {launches}, want {want}")
    check_answers(np, answers, 5)
    if not (repeat["cached"] and repeat["provider"] == "Cache"):
        raise AssertionError("the repeated query was not a cache hit")

    tok = engine.embedder.tokenizer
    lq = pad_batch([tok.encode(q, 64) for q, _, _ in burst])[0].shape[1]
    snap = get_tracer().metrics_snapshot()
    stage = {m: snap[m] for m in ("fused_tokenize_ms", "fused_device_ms", "fused_assemble_ms")}
    log(f"[{label}] {smi}: launches {launches} over {n_batches} fused batches; pair length "
        f"{lq + DLEN} ({lq} query + {DLEN} doc); batch walls (size, ms) {batches}")
    log(f"[{label}] {smi}: stage split over all batches: {json.dumps(stage)}")
    return {"launches": launches, "engine": engine, "singles": singles, "burst": burst,
            "lq": lq}


def fused_inputs(torch, engine, queries, device, store=None):
    """Tokenized batch + filters for the fused pipelines, as the engine
    builds them (ids padded to the batch and length buckets); filter codes
    from ``store`` (default: the engine's index's)."""
    from financial_rag_system_tpu_torch.models.tokenizer import pad_batch

    tok = engine.embedder.tokenizer
    store = store or engine.index.store
    ids, types, mask = pad_batch([tok.encode(q, 64) for q, _, _ in queries])
    codes = [store.query_codes(t, d) for _, t, d in queries]
    qf = torch.tensor(codes + [(-3, -3)] * (ids.shape[0] - len(codes)),
                      dtype=torch.int32, device=device)
    return [torch.as_tensor(a, device=device) for a in (ids, types, mask)] + [qf]


def profile_batch(torch, main: dict, smi: str, label: str = "fused_two_stage") -> None:
    """Device time by kernel over one fused flat batch of 32."""
    from financial_rag_system_tpu_torch.ops.fused_query import fused_two_stage

    engine = main["engine"]
    emb, codes, dtok = engine.index._arrays
    args = fused_inputs(torch, engine, main["burst"], "cuda")
    profile_run(torch, lambda: fused_two_stage(
        engine.embedder.model, engine.reranker.model, *args, emb, codes, dtok, N,
        rerank_cfg=engine.reranker.cfg, k=K), label, smi)


def profile_run(torch, fn, label: str, smi: str):
    """Wall time and device time by kernel (torch.profiler) of one call of
    ``fn`` after a warm-up; returns its output."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        out = fn()
        torch.cuda.synchronize()
        return out

    run()
    t0 = time.perf_counter()
    out = run()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    rows = []
    for ev in prof.key_averages():
        # kernels only: an aten:: op's device time repeats its kernels'
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0 and not ev.key.startswith("aten::"):
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    log(f"[profile] {smi}: {label} on {B} queries: wall {wall:.2f} ms, device "
        f"{total:.2f} ms in {len(rows)} kernels")
    for ms, count, key in rows[:15]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    return out


def flat_batch(torch, engine, queries, dev, index, models):
    """``fused_two_stage`` on ``dev`` over ``index`` with ``models``
    (embedder, reranker); the first ``len(queries)`` rows of its outputs
    as numpy arrays."""
    from financial_rag_system_tpu_torch.ops.fused_query import fused_two_stage

    e, r = models
    emb, idx_codes, dtok = index._arrays
    out = fused_two_stage(e.model, r.model, *fused_inputs(torch, engine, queries, dev),
                          emb, idx_codes, dtok, N, rerank_cfg=r.cfg, k=K)
    return [x.cpu().numpy()[: len(queries)] for x in out]


def compare_batches(np, what: str, got, ref) -> None:
    """Two fused batches' (rows, bi, ce) agree: bi scores within 2e-3, at
    least K - 2 rows shared per query, ce within 5e-2 on the shared rows."""
    (rows_g, bi_g, ce_g), (rows_c, bi_c, ce_c) = got, ref
    bi_err = float(np.abs(bi_g - bi_c).max())
    if bi_err > 2e-3:
        raise AssertionError(f"{what}: bi scores differ by {bi_err}")
    ce_errs, overlap = [], []
    for q in range(len(rows_g)):
        pos_c = {int(r): j for j, r in enumerate(rows_c[q])}
        common = [(j, pos_c[int(r)]) for j, r in enumerate(rows_g[q]) if int(r) in pos_c]
        overlap.append(len(common))
        ce_errs += [abs(float(ce_g[q, a]) - float(ce_c[q, b])) for a, b in common]
    ce_err = max(ce_errs)
    if min(overlap) < K - 2 or ce_err > 5e-2:
        raise AssertionError(f"{what}: row overlap {overlap}, ce err {ce_err}")
    log(f"{what} on {len(rows_g)} queries: bi err {bi_err:.3g}, "
        f"rows shared {overlap} of {K}, ce err {ce_err:.3g}")


def check_against_cpu(torch, np, main: dict, cpu_models) -> None:
    """One small fused batch on the card against the same pipeline on the
    CPU (plain versions of the kernels), from the same checkpoints and
    index."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.utils.config import get_config

    engine = main["engine"]
    cpu_index = FlatIndex.load(get_config().index_dir, device="cpu")
    queries = main["burst"][:2]
    got = flat_batch(torch, engine, queries, "cuda", engine.index,
                     (engine.embedder, engine.reranker))
    with env_set(**CPU_TANH):
        ref = flat_batch(torch, engine, queries, "cpu", cpu_index, cpu_models)
    compare_batches(np, "[main] card vs CPU", got, ref)


def check_attention_gate(torch, np, main: dict, smi: str) -> None:
    """The query embed's attention before and after it followed the JAX
    gate: the flat batch of 32 with the embed (S < 256) taking the JAX
    einsum path's arithmetic (the default) and kernel 2's
    (``RAG_TPU_PAIR_ATTN=1``, what the port computed before); kernel 2's
    launches each way and the two batches' top-15 overlap."""
    from financial_rag_system_tpu_torch.ops.attention import encoder_self_attention

    engine = main["engine"]

    def batch():
        n0 = encoder_self_attention.launches
        out = flat_batch(torch, engine, main["burst"], "cuda", engine.index,
                         (engine.embedder, engine.reranker))
        return out, encoder_self_attention.launches - n0

    (rows_e, bi_e, _), n_einsum = batch()
    with env_set(RAG_TPU_PAIR_ATTN="1"):
        (rows_k, bi_k, _), n_kernel = batch()
    if (n_einsum, n_kernel) != (6, 18):
        raise AssertionError(f"kernel 2 launched {n_einsum} and {n_kernel} times, want 6 and 18")
    overlap = [len(set(a.tolist()) & set(b.tolist())) for a, b in zip(rows_e, rows_k)]
    log(f"[gate] {smi}: flat batch of {B}, query embed with the einsum arithmetic against "
        f"kernel 2's: top-{K} overlap mean {np.mean(overlap) / K:.4f}, lowest "
        f"{min(overlap)} of {K}, queries with all {K} shared {overlap.count(K)} of {B}; "
        f"bi score max abs diff {float(np.abs(bi_e - bi_k).max()):.3g}; kernel 2 launches "
        f"{n_einsum} and {n_kernel}")


# -- phase 4: the IVF path ------------------------------------------------------


def clustered_flat(torch, np, n: int, tok, seed: int, dev, plant=None,
                   dtype=None, n_tickers: int = N_TICKERS):
    """A FlatIndex of ``n`` clustered unit rows made on ``dev`` (no host
    copy of the corpus): N_TOPICS topic centres; ``n_tickers`` tickers x 3
    document types drawn evenly, so that at 1M rows (or 131,072 rows and 8
    tickers) no ticker is selective; RARE_ROWS rows
    of the ticker RARE; a DLEN-wide token store of random wordpiece ids.
    ``plant`` = (query vectors, filters) gives each query K rows at cosines
    0.90, 0.88, ... under its filter, so its top K stand clear of rounding.
    ``dtype``: bf16 (the default) or int8 rows."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.models.tokenizer import SEP_ID

    normalize = torch.nn.functional.normalize
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = FlatIndex(D, capacity=n + 1024, tile=1024, token_store_len=DLEN, tokenizer=tok,
                     device=dev, dtype=dtype or torch.bfloat16)
    emb, codes, dtok = flat._arrays
    centres = normalize(torch.randn((N_TOPICS, D), generator=g, device=dev), dim=1)
    cols = torch.arange(DLEN, device=dev)
    step = 1 << 17
    for s in range(0, n, step):
        m = min(step, n - s)
        topic = torch.randint(0, N_TOPICS, (m,), generator=g, device=dev)
        x = centres[topic] + TOPIC_NOISE / D**0.5 * torch.randn((m, D), generator=g, device=dev)
        emb[s : s + m] = flat.prep_queries(normalize(x, dim=1))
        last = torch.randint(DLEN // 2, DLEN + 1, (m, 1), generator=g, device=dev) - 1
        wp = torch.randint(1000, 30522, (m, DLEN), generator=g, device=dev, dtype=torch.int32)
        dtok[s : s + m] = torch.where(cols < last, wp, torch.where(cols == last, SEP_ID, 0))
    rng = np.random.default_rng(seed)
    tick = rng.integers(0, n_tickers, n)
    tick[rng.choice(n, RARE_ROWS, replace=False)] = n_tickers
    dtyp = rng.integers(0, len(DOC_TYPES), n)
    names = [f"T{i:02d}" for i in range(n_tickers)] + [RARE]
    if plant is not None:
        qv, filters = plant
        for q, (t, d), rows in zip(qv, filters, rng.choice(n, (len(qv), K), replace=False)):
            for j, r in enumerate(rows):
                cos = 0.9 - 0.02 * j
                noise = rng.standard_normal(D)
                noise -= (noise @ q) * q
                v = cos * q + np.sqrt(1 - cos**2) * noise / np.linalg.norm(noise)
                emb[r] = flat.prep_queries(torch.as_tensor(v, dtype=torch.float32, device=dev))
                tick[r] = names.index(t)
                dtyp[r] = dtyp[r] if d is None else DOC_TYPES.index(d)
    store = flat.store
    for t in names:
        store.tickers.encode(t)
    for d in DOC_TYPES:
        store.doc_types.encode(d)
    payloads = [[{"ticker": t, "document_type": d} for d in DOC_TYPES] for t in names]
    tl, dl = tick.tolist(), dtyp.tolist()
    store.texts = [f"chunk {r} of {names[t]} {DOC_TYPES[d]}" for r, (t, d) in enumerate(zip(tl, dl))]
    store.payloads = [payloads[t][d] for t, d in zip(tl, dl)]  # get() copies
    store.id_to_row = {f"chunk-{r}": r for r in range(n)}
    codes[:, :n] = torch.as_tensor(np.stack([tick, dtyp]).astype(np.int32), device=dev)
    return flat


def check_answers(np, answers, top_k: int) -> None:
    for a in answers:
        scores = [s["score"] for s in a["sources"]]
        if a["cached"] or not 1 <= len(scores) <= top_k or scores != sorted(scores, reverse=True):
            raise AssertionError(f"bad answer {a}")
        if not np.isfinite(scores).all():
            raise AssertionError("non-finite rerank score")


def drive_ivf_path(torch, np, flat_run: dict, smi: str, label: str = "ivf",
                   dtype=None, rounds: int = 2) -> dict:
    """The IVF tier as users reach it: a 1M-chunk corpus (bf16 rows, or
    int8 ones for ``dtype=torch.int8``) promoted by ``rebuild_index("ivf")``,
    then 3 single asks, ``rounds`` bursts of 32, a rare-ticker ask (staged),
    an upsert and an ask that finds it, and a cache hit through the
    batched engine, with every kernel's launches counted around them."""
    from financial_rag_system_tpu_torch.serving.engine import RAGEngine
    from financial_rag_system_tpu_torch.utils.config import get_config

    base = flat_run["engine"]
    t0 = time.perf_counter()
    flat = clustered_flat(torch, np, N_IVF, base.embedder.tokenizer, SEED + 2,
                          torch.device("cuda"), dtype=dtype)
    torch.cuda.synchronize()
    log(f"[{label}] {N_IVF} {flat.dtype} rows ({N_TOPICS} topics, {N_TICKERS} tickers x "
        f"{len(DOC_TYPES)} doc types, {RARE_ROWS} rows of {RARE}) made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    engine = RAGEngine(get_config(), flat, base.embedder, base.reranker)
    t0 = time.perf_counter()
    built = engine.rebuild_index("ivf")  # the call behind POST /index/rebuild
    build_s = time.perf_counter() - t0
    idx = engine.index
    geom = (idx.n_clusters, idx.nprobe, idx.c_max, idx.tiles_per_cluster, idx.num_tiles)
    kind = engine.queue_status()["fused_kind"]
    if kind != "ivf_full" or geom != IVF_GEOMETRY or built["tail_rows"]:
        raise AssertionError(f"rebuild_index: {built}, fused_kind {kind!r}, geometry {geom}")
    if idx.packed_emb.dtype != flat.dtype or idx.centroids.dtype != torch.bfloat16:
        raise AssertionError(f"packing {idx.packed_emb.dtype}, centroids {idx.centroids.dtype}")
    split = {k: round(v, 3) for k, v in idx.build_seconds.items()}
    log(f"[{label}] {smi}: rebuild_index('ivf') {build_s:.2f} s, by step (s) {split}; "
        f"geometry (clusters, nprobe, c_max, tiles/cluster, tiles) {geom}")

    batches = []  # (size, fused, wall ms)
    actives = []  # each fused batch's active probed tiles (0-d device tensors)
    fused_exec, batch_fn = engine._fused_exec, engine.batcher.batch_fn

    def exec_spy(*a):
        res = fused_exec(*a)
        if res is not None:
            actives.append(res[3])
        return res

    def timed_batch(queries, filters):
        n0, t0 = len(actives), time.perf_counter()
        out = batch_fn(queries, filters)
        batches.append((len(queries), len(actives) > n0,
                        round((time.perf_counter() - t0) * 1e3, 2)))
        return out

    engine._fused_exec, engine.batcher.batch_fn = exec_spy, timed_batch
    engine.llm_semaphore = asyncio.Semaphore(B)
    singles = [(f"{q} in the filings ({label})", t, d) for q, t, d in flat_run["singles"]]
    burst = flat_run["burst"]
    fresh = [f"fresh filing note {i} ({label}): the board approved a special dividend"
             for i in range(4)]

    async def scenario():
        await engine.startup()
        try:
            answers = [await engine.ask(q, t, 5, d) for q, t, d in singles]
            for n in range(rounds):
                answers += await asyncio.gather(*[
                    engine.ask(f"{q} ({label} round {n})", t, 5, d) for q, t, d in burst
                ])
            rare = await engine.ask(f"liquidity risk of the rare issuer ({label})", RARE, 5)
            added = await engine.ingest_chunks(
                [f"fresh-{i}" for i in range(len(fresh))], fresh,
                [{"ticker": "T05", "document_type": "10-K"}] * len(fresh),
            )
            found = await engine.ask(fresh[0], "T05", K)
            await asyncio.sleep(0.2)  # write-behind cache saves land
            repeat = await engine.ask(*singles[0][:2], 5, singles[0][2])
        finally:
            await engine.shutdown()
        return answers, rare, added, found, repeat

    reset_launches()
    answers, rare, added, found, repeat = asyncio.run(scenario())
    launches = read_launches()

    shape = [(n, f) for n, f, _ in batches]
    if shape != [(1, True)] * 3 + [(B, True)] * rounds + [(1, False), (1, True)]:
        raise AssertionError(f"batches (size, fused) {shape}")
    n_fused = sum(f for _, f in shape)
    n_staged = len(shape) - n_fused
    # one probe per batch (the staged search probes too), kernel 1 on the
    # staged batch's selective rows, attention once a rerank layer of a
    # fused batch (the 400-token pairs); the query and upsert embeds and
    # the staged batch's rerank of its short chunk texts stay below S 256
    # and take the einsum path; the fused-block kernels are off by default
    sfx = "_int8" if flat.quantized else ""
    want = want_launches(**{f"masked_topk{sfx}": n_staged, f"ivf_probe{sfx}": n_fused + n_staged,
                            "pair_attention": 6 * n_fused})
    if launches != want:
        raise AssertionError(f"[{label}] launches {launches}, want {want}")
    check_answers(np, answers + [rare], 5)
    check_answers(np, [found], K)
    if not all(f" of {RARE} " in s["text"] for s in rare["sources"]):
        raise AssertionError(f"the {RARE} ask returned other tickers: {rare['sources']}")
    if added != len(fresh) or idx._tail_rows:
        raise AssertionError(f"upsert: {added} added, tail {idx._tail_rows[:8]}")
    if not any(s["text"] in fresh for s in found["sources"]):
        raise AssertionError("the ask after the upsert did not find the upserted rows")
    if not (repeat["cached"] and repeat["provider"] == "Cache"):
        raise AssertionError("the repeated query was not a cache hit")
    active = [int(a) for a in actives]
    log(f"[{label}] {smi}: launches {launches} over {n_fused} fused and {n_staged} staged "
        f"batches; batch walls (size, fused, ms) {batches}; active tiles per fused batch "
        f"{active}")
    return {"engine": engine, "burst": burst, "launches": launches, "label": label}


def recall_at_k(np, rows, exact_s, exact_rows) -> list[float]:
    """Per query: the share of the exact top-k (its finite slots) in ``rows``."""
    out = []
    for r, s_e, r_e in zip(rows, exact_s.cpu().numpy(), exact_rows.cpu().numpy()):
        want = set(r_e[np.isfinite(s_e)].tolist())
        out.append(len(want & set(r.tolist())) / max(1, len(want)))
    return out


def check_ivf_kernel(torch, np, ivf_run: dict, smi: str, baseline: Path | None = None) -> dict:
    """Kernel 3 (its bf16 or int8 branch, as the packing is) against its
    plain version on the probe list of a real batch of 32 over the 1M
    packing: within 1e-4 in bf16, bit for bit in int8; its time beside
    kernel 1's over the same corpus, there and on a diverse batch's list;
    the fused IVF batch's recall@15 against the exact flat top-15, and its
    profile."""
    from financial_rag_system_tpu_torch.index.ivf import ivf_probe, ivf_probe_plain, probe_plan
    from financial_rag_system_tpu_torch.ops import fused_query as fq
    from financial_rag_system_tpu_torch.ops.topk import masked_topk, topk_plan

    engine, label = ivf_run["engine"], ivf_run["label"]
    idx = engine.index
    tile = idx.tile
    centroids, packed_emb, packed_codes, packed_gids = idx._state[:4]
    emb, codes, dtok = idx.flat._arrays
    quantized = idx.flat.quantized
    elt = packed_emb.element_size()
    peak = INT8_OP_PER_S if quantized else BF16_FLOP_PER_S
    nv = idx.n_valid
    ids, types, mask, qf = fused_inputs(torch, engine, ivf_run["burst"], "cuda")
    with torch.inference_mode():
        q = fq._prep_queries(fq._embed(engine.embedder.model, ids, types, mask),
                             packed_emb.dtype)

    def probe_list(queries):
        return fq._probe_tiles(queries, centroids, nprobe=idx.nprobe,
                               tiles_per_cluster=idx.tiles_per_cluster,
                               num_tiles=idx.num_tiles)

    tile_ids = probe_list(q)
    n_act = int((tile_ids >= 0).sum())

    # the real batch, with one query set on a row duplicated into another
    # probed tile, its packed order the reverse of its gid order
    act = tile_ids[tile_ids >= 0].long()
    pos = (act[:, None] * tile + torch.arange(tile, device=act.device)).reshape(-1)
    pos = pos[packed_gids[0, pos] >= 0]
    p1, p2 = int(pos[0]), int(pos[-1])
    pe, pg = packed_emb.clone(), packed_gids.clone()
    pe[p2] = pe[p1]
    hi, lo = sorted((int(pg[0, p1]), int(pg[0, p2])), reverse=True)
    pg[0, p1], pg[0, p2] = hi, lo
    qt, qft = q.clone(), qf.clone()
    qt[1], qft[1] = pe[p1], -1
    args = (qt, qft, pe, packed_codes, pg, tile_ids, K)
    s, i = (x.cpu().numpy() for x in ivf_probe(*args, tile=tile))
    torch.cuda.synchronize()
    s_ref, i_ref = (x.cpu().numpy() for x in ivf_probe_plain(*args, tile=tile))
    del pe, pg
    fin = np.isfinite(s_ref)
    if not (np.isfinite(s) == fin).all() or not (i[~fin] == -1).all():
        raise AssertionError("ivf_probe: empty slots differ from the plain version")
    err = float(np.abs(s[fin] - s_ref[fin]).max())
    if err > 1e-4 or (quantized and s.tobytes() != s_ref.tobytes()):
        raise AssertionError(f"ivf_probe ({packed_emb.dtype}) scores differ by {err}")
    # both order by (score desc, packed position asc): the ids must agree
    # wherever the score is finite, near-equal scores included
    if not (i[fin] == i_ref[fin]).all():
        raise AssertionError("ivf_probe ids differ from the plain version")
    if not ((i[1, 0], i[1, 1]) == (hi, lo) and s[1, 0] == s[1, 1]
            and (i_ref[1, 0], i_ref[1, 1]) == (hi, lo)):
        raise AssertionError("duplicated rows must tie, lower packed position first")
    log(f"[ivf_probe] {packed_emb.dtype} B={B} tiles {n_act} active of {tile_ids.numel()}: "
        f"max_abs_err {err:.3g}; scores bit for bit: {s.tobytes() == s_ref.tobytes()}; ids "
        f"identical where finite: True; tie by packed position: True")

    # times on the real batch's list and on a diverse batch's (queries
    # near 32 random corpus rows), each beside kernel 1 over the 1M corpus
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    near = emb[torch.randint(0, nv, (B,), generator=g, device="cuda")].float()
    qd = fq._prep_queries(torch.nn.functional.normalize(
        near + 0.1 / D**0.5 * torch.randn((B, D), generator=g, device="cuda"), dim=1
    ), packed_emb.dtype)
    flat_bytes = nv * (elt * D + 8) + B * D * elt + B * 8 + B * K * 8
    flat_b = bound_ms(flat_bytes, 2.0 * B * nv * D, peak)[0]
    out = {}
    for name, qq in (("real", q), ("diverse", qd)):
        tl = tile_ids if name == "real" else probe_list(qq)
        act = tl[tl >= 0].long()
        a = act.numel()
        # the function must read every active slot's gid, and the row and
        # codes of each live (gid >= 0) slot
        live = int((packed_gids[0, act[:, None] * tile + torch.arange(tile, device=act.device)]
                    >= 0).sum())
        real = (qq, qf, packed_emb, packed_codes, packed_gids, tl, K)
        ms = median_ms(lambda: ivf_probe(*real, tile=tile), reps=50)
        plain_ms = median_ms(lambda: ivf_probe_plain(*real, tile=tile), reps=10)
        flat_ms = median_ms(lambda: masked_topk(qq, emb, codes, qf, nv, K), reps=50)
        nbytes = (a * tile * 4 + live * (elt * D + 8) + B * D * elt + B * 8 + tl.numel() * 4
                  + B * K * 8)
        b_ms, b_by = bound_ms(nbytes, 2.0 * B * live * D, peak)
        rows_i = ivf_probe(*real, tile=tile)[1].cpu().numpy()
        recall = np.mean(recall_at_k(np, rows_i, *masked_topk(qq, emb, codes, qf, nv, K)))
        log(f"[ivf_probe] {smi}: {packed_emb.dtype} {name} batch of {B}: {a} active tiles of {tl.numel()} "
            f"({a * tile} slots, {live} live); kernel 3 {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}); kernel 1 over {nv} flat rows {flat_ms:.4f} ms, bound "
            f"{flat_b:.4f} ms; probe recall@{K} against flat {recall:.4f}")
        tag = f"[ivf_probe] {packed_emb.dtype} {name} list:"
        retrieval_timing(torch, tag, lambda: ivf_probe(*real, tile=tile), ms, smi)
        plan_line(tag, probe_plan(B, tl.numel(), tile, D, elt, K, sms(torch)),
                  pieces=a * tile / 64)
        if baseline is not None:
            against_parent(torch, tag, smi,
                           parent_probe_fn(torch, baseline_lib("ivf_probe", baseline), real, tile),
                           lambda: ivf_probe(*real, tile=tile), exact=quantized or name == "real")
        if name == "real":
            tag = f"[topk] {packed_emb.dtype} B={B} N={nv}:"
            retrieval_timing(torch, tag, lambda: masked_topk(qq, emb, codes, qf, nv, K), flat_ms,
                             smi)
            plan_line(tag, topk_plan(B, nv, D, elt, K, sms(torch)))
        out[name] = (ms, plain_ms, b_ms, b_by)
    ms, plain_ms, b_ms, b_by = out["real"]

    # the fused IVF batch of 32: profile, then recall@15 against flat
    fused = engine._fused_fn
    rows, bi, _, act_t = profile_run(torch, lambda: fused(
        engine.embedder.model, engine.reranker.model, ids, types, mask, qf,
        centroids, packed_emb, packed_codes, packed_gids, dtok),
        f"fused_ivf_two_stage ({packed_emb.dtype})", smi)
    hits = recall_at_k(np, rows.cpu().numpy(), *masked_topk(q, emb, codes, qf, nv, K))
    recall = float(np.mean(hits))
    log(f"[{label}] {smi}: fused IVF batch of {B} ({int(act_t)} active tiles): recall@{K} "
        f"against the exact {packed_emb.dtype} flat top-{K} {recall:.4f} (lowest query "
        f"{min(hits):.4f})")
    if recall < 0.9:
        raise AssertionError(f"IVF recall@{K} {recall} < 0.9")
    return {
        "name": "ivf_probe_int8" if quantized else "ivf_probe", "route": "cuda",
        "source": f"{PACKAGE}/csrc/ivf_probe.cu",
        "replaces": "financial_rag_system_tpu/index/ivf.py:99",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def check_ivf_against_cpu(torch, np, flat_run: dict, work: Path, cpu_models) -> None:
    """An IVF index built on the card (N_CPU_CHECK rows) and saved, loaded
    on the CPU from the same files: one fused IVF batch agrees."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.index.ivf import IVFIndex
    from financial_rag_system_tpu_torch.ops.fused_query import make_fused_ivf_query

    engine = flat_run["engine"]
    queries = flat_run["burst"][:2]
    qv = engine.embedder.encode([q for q, _, _ in queries])
    flat = clustered_flat(torch, np, N_CPU_CHECK, engine.embedder.tokenizer, SEED + 3,
                          torch.device("cuda"), plant=(qv, [(t, d) for _, t, d in queries]))
    card = IVFIndex(flat, tile=128)
    directory = str(work / "ivf_small")
    card.save(directory)
    cpu = IVFIndex.load(directory, FlatIndex.load(directory, device="cpu"))
    outs = []
    for dev, idx, (e, r) in (("cuda", card, (engine.embedder, engine.reranker)),
                             ("cpu", cpu, cpu_models)):
        fn = make_fused_ivf_query(r.cfg, k=K, tile=idx.tile, nprobe=idx.nprobe,
                                  tiles_per_cluster=idx.tiles_per_cluster)
        with env_set(**CPU_TANH):
            out = fn(e.model, r.model,
                     *fused_inputs(torch, engine, queries, dev, store=idx.store),
                     *idx._state[:4], idx.flat._arrays[2])
        outs.append([x.cpu().numpy()[: len(queries)] for x in out[:3]])
    (rows_g, bi_g, ce_g), (rows_c, bi_c, ce_c) = outs
    if not (rows_g == rows_c).all():
        raise AssertionError(f"IVF card vs CPU: rows differ\n{rows_g}\n{rows_c}")
    fin = np.isfinite(bi_c)
    bi_err = float(np.abs(bi_g[fin] - bi_c[fin]).max())
    ce_err = float(np.abs(ce_g[fin] - ce_c[fin]).max())
    if bi_err > 2e-3 or ce_err > 5e-2:
        raise AssertionError(f"IVF card vs CPU: bi err {bi_err}, ce err {ce_err}")
    log(f"[ivf] card vs CPU, {N_CPU_CHECK} rows ({card.n_clusters} clusters, nprobe "
        f"{card.nprobe}), {len(queries)} queries: the same {fin.sum()} rows, bi err "
        f"{bi_err:.3g}, ce err {ce_err:.3g}")


# -- phase 5: the fused-block path ------------------------------------------------


@contextlib.contextmanager
def env_set(**values: str):
    """Set environment variables for the block, then restore them."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_fused_block_batch(torch, np, run: dict, cpu_models, smi: str) -> None:
    """One fused-block batch on the card against the same pipeline on the
    CPU (the gate patched on, so the plain versions run) and against the
    card's unfused layer with tanh GELU (the same function); then a
    profile of a batch of 32 each way."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.ops import fused_bert
    from financial_rag_system_tpu_torch.utils.config import get_config

    engine = run["engine"]
    card = (engine.embedder, engine.reranker)
    queries = run["burst"][:2]

    def on_card():
        n0 = fused_bert.fused_qkv.launches
        out = flat_batch(torch, engine, queries, "cuda", engine.index, card)
        return out, fused_bert.fused_qkv.launches - n0

    got, n_fused = on_card()
    with env_set(RAG_TPU_FUSED_BLOCK="0"):
        unfused, n_unfused = on_card()
    if (n_fused, n_unfused) != (18, 0):
        raise AssertionError(f"fused_qkv launched {n_fused} and {n_unfused} times, want 18 and 0")
    gate = bert._fused_block_enabled
    bert._fused_block_enabled = lambda model: True
    try:
        cpu_index = FlatIndex.load(get_config().index_dir, device="cpu")
        with env_set(**CPU_TANH):
            ref = flat_batch(torch, engine, queries, "cpu", cpu_index, cpu_models)
    finally:
        bert._fused_block_enabled = gate
    compare_batches(np, "[fused-block] card vs CPU (plain versions)", got, ref)
    compare_batches(np, "[fused-block] card, fused vs unfused tanh layer", got, unfused)
    profile_batch(torch, run, smi, "fused_two_stage, fused block")
    with env_set(RAG_TPU_FUSED_BLOCK="0"):
        profile_batch(torch, run, smi, "fused_two_stage, unfused layer, tanh GELU")


def fused_kernel_err(torch, what: str, fn, plain) -> float:
    """Max abs error of a fused-block kernel against its plain version on
    the same inputs; raises beyond atol = rtol = 2e-3 (the JAX package's
    bound for these kernels) or on a non-finite output."""
    got = fn()
    torch.cuda.synchronize()
    got, ref = (torch.stack(t) if isinstance(t, tuple) else t for t in (got, plain()))
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    err = float((got - ref).abs().max())
    if not torch.allclose(got, ref, atol=2e-3, rtol=2e-3):
        raise AssertionError(f"{what} differs from its plain version by {err}")
    return err


def time_fused_kernel(torch, smi: str, name: str, shape: str, fn, plain, unfused, library,
                      nbytes: float, flops: float, reps: int = 20) -> dict:
    """One fused-block kernel against its plain version, then the times of
    the kernel, its plain version, the unfused layer's torch sequence for
    the same half-layer and a library call (``None``: no single call
    computes the function)."""
    err = fused_kernel_err(torch, f"{name} at the {shape} shape", fn, plain)
    ms = median_ms(fn, reps=reps)
    plain_ms = median_ms(plain, reps=5)
    unfused_ms = median_ms(unfused, reps=reps)
    library_ms = None if library is None else median_ms(library, reps=reps)
    b_ms, b_by = bound_ms(nbytes, flops)
    lib = "null" if library_ms is None else f"{library_ms:.4f} ms"
    log(f"[{name}] {smi}: {shape} shape: max_abs_err {err:.3g}, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, unfused_ms {unfused_ms:.4f}, library {lib}, "
        f"bound {b_ms:.4f} ms ({b_by}), share of the bound {b_ms / ms:.3f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "unfused_ms": unfused_ms}


def qkv_limits(torch, smi: str, shape: str, x, ms: float, plan) -> None:
    """What kernel 5's time ``ms`` is against the card's limits: its bytes
    (x read once, three (R, H) f32 outputs written) at the rate of a plain
    copy of an (R, 3H) f32 tensor, and the rate at which its blocks draw
    from L2 (each of the ``plan.slices`` blocks of a row tile reads the
    tile, each block its weight slice once, and the outputs pass
    through)."""
    from financial_rag_system_tpu_torch.ops import fused_bert as fb

    r, h = x.shape
    src = torch.empty((r, 3 * h), device=x.device)
    dst = torch.empty_like(src)
    copy_ms = median_ms(lambda: dst.copy_(src), reps=20)
    rate = 2 * src.numel() * 4 / copy_ms / 1e9  # TB/s
    dram = r * h * 4 * 4
    l2 = plan.slices * r * h * 4 + 3 * r * h * 4 + plan.ctas * plan.bn * h * 2
    del src, dst
    # the same work on half the blocks: near twice the time if each
    # block's own pipeline sets the pace, much less if a path the blocks
    # share (device memory, L2) does
    w, b = fb.pack_qkv(*(torch.zeros(s_, device=x.device) for _ in range(3)
                         for s_ in ((h, h), (h,))))
    out = torch.empty((3, r, h), device=x.device)
    half = max(plan.slices, plan.ctas // 2 // plan.slices * plan.slices)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(ctas):
        return lambda: fb._cuda.check(fb._library().fused_qkv(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), r, h, plan.bn,
            plan.stages, ctas, stream), "fused_qkv")

    all_ms, half_ms = median_ms(launch(plan.ctas), reps=20), median_ms(launch(half), reps=20)
    log(f"[fused_qkv] {smi}: {shape} shape, plan {plan._asdict()}: kernel {ms:.4f} ms, "
        f"{dram / ms / 1e9:.3f} TB/s of device memory; a copy moves {rate:.3f} TB/s, at "
        f"which the kernel's {dram / 1e9:.3f} GB take {dram / rate / 1e9:.4f} ms (the "
        f"kernel at {dram / rate / 1e9 / ms:.3f} of it); L2 to the SMs {l2 / 1e9:.3f} GB "
        f"at {l2 / ms / 1e9:.3f} TB/s; launched alone on {plan.ctas} blocks {all_ms:.4f} ms, "
        f"on {half} blocks {half_ms:.4f} ms ({half_ms / all_ms:.2f}x)")


def device_ms(torch, fn, kernel: str, calls: int = 10) -> float:
    """Median device time of the launches of the kernel whose name holds
    ``kernel`` among ``calls`` calls of ``fn``: the profiler's kernel
    times, without the host's work around each launch (the CUDA-event
    times of a short kernel are mostly that).  NaN if three profiles in a
    row hold none (the profiler has been seen to drop them)."""
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = [e.device_time for e in prof.events() if kernel in e.name]
        if times:
            return statistics.median(times) / 1e3
    return float("nan")


def device_split(torch, fn, calls: int = 10) -> dict:
    """Device ms that one call of ``fn`` spends in each kernel it launches:
    by the kernel's short name, its median time a launch (the profiler's,
    each launch counted once) times its launches a call (at least one: the
    profiler has been seen to drop and to repeat records); empty if three
    profiles in a row hold none."""
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = {}
        for e in prof.events():
            if e.device_time > 0 and not e.name.startswith(("Memcpy", "Memset")):
                name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
                name = name.split("(")[0].split("<")[0].split("::")[-1]
                times.setdefault(name, {})[e.time_range.start] = e.device_time / 1e3
        if times:
            return {name: statistics.median(t.values()) * max(1, round(len(t) / calls))
                    for name, t in times.items()}
    return {}


def host_us(torch, fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to queue its work (the
    device runs behind; the queue never fills at this count)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def retrieval_timing(torch, tag: str, fn, ms: float, smi: str) -> float:
    """Log a retrieval kernel's CUDA-event time ``ms`` beside its device
    time by kernel and the wrapper's host time; returns the device ms."""
    split = device_split(torch, fn)
    dev = sum(split.values()) if split else float("nan")
    parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
    log(f"{tag} {smi}: events {ms:.4f} ms, device {dev:.4f} ms ({parts}), host "
        f"{host_us(torch, fn):.1f} us a call")
    return dev


def ffn_baseline_fn(baseline, xf, ops, eps: float, y):
    """A launch of the FFN entry of an earlier ``fused_bert.cu``
    (``--ffn-baseline``), whose C entry took no plan:
    ``fused_ffn_ln(x, w_in, b_in, w_out, b_out, ln_s, ln_b, eps, y, R, H, I,
    stream)``, into ``y``."""
    import ctypes

    import torch

    from financial_rag_system_tpu_torch.ops import _cuda

    fn = baseline.fused_ffn_ln
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 7 + [ctypes.c_float, p, i, i, i, p]
    fn.restype = ctypes.c_int
    (r, h), n_i = xf.shape, ops[0].shape[0]

    def launch():
        _cuda.check(fn(xf.data_ptr(), *(t.data_ptr() for t in ops), float(eps), y.data_ptr(),
                       r, h, n_i, torch.cuda.current_stream().cuda_stream), "baseline fused_ffn_ln")
        return y

    return launch


def ffn_yardsticks(torch, smi: str, shape: str, ffn: tuple, res: dict, baseline=None) -> None:
    """Kernel 4 at one shape beside its yardsticks, on the same inputs, with
    its device time from the profiler beside the CUDA-event time: the
    two FFN products alone (``torch.mm(bf16, bf16, out_dtype=f32)``, no
    bias, GELU or layernorm) as ``gemms_ms``, the unfused layer's torch
    sequence (``unfused_ms``, timed by ``time_fused_kernel``), and with
    ``baseline`` (``--ffn-baseline``) an earlier build's kernel, timed in
    turns (old, new, new, old) with the outputs' largest difference.  Then
    what the plan draws from L2: the weight bytes (every unit reads its
    chunks' W_in and W_out pieces once; a tile's units together read all
    of both) and the blocks it runs."""
    from financial_rag_system_tpu_torch.ops import fused_bert as fb

    x, w_in, b_in, w_out, b_out, ln_s, ln_b, eps = ffn
    r, h = x.shape
    i = w_in.shape[0]
    bf, f32 = torch.bfloat16, torch.float32
    x16, wi16, wo16 = x.to(bf), w_in.to(bf), w_out.to(bf)
    up16 = torch.empty((r, i), dtype=bf, device=x.device).normal_()

    def gemms():
        torch.mm(x16, wi16.t(), out_dtype=f32)
        return torch.mm(up16, wo16.t(), out_dtype=f32)

    gemms_ms = median_ms(gemms, reps=20)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fb.ffn_plan(h, i, r, sms)
    ms = res["ms"]
    weights = plan.tiles * 2 * h * i * 2  # bytes

    def kernel():
        return fb.fused_ffn_ln(*ffn)

    dev_ms = device_ms(torch, kernel, "ffn_ln_kernel")
    line = (f"[fused_ffn_ln] {smi}: {shape} shape: kernel {ms:.4f} ms (device {dev_ms:.4f} ms), "
            f"gemms_ms {gemms_ms:.4f}, unfused_ms {res['unfused_ms']:.4f}, "
            f"bound {res['bound_ms']:.4f} ms")
    if baseline is not None:
        xf, ops = fb._ffn_operands(*ffn[:-1])
        new = kernel()
        old_launch = ffn_baseline_fn(baseline, xf, ops, eps, torch.empty_like(new))
        old = old_launch()
        torch.cuda.synchronize()
        diff = float((new - old).abs().max())
        turns = [median_ms(old_launch, reps=20), median_ms(kernel, reps=20),
                 median_ms(kernel, reps=20), median_ms(old_launch, reps=20)]
        line += (f"; baseline: max abs diff {diff:.3g}, old, new, new, old "
                 f"{[round(t, 4) for t in turns]} ms, old device "
                 f"{device_ms(torch, old_launch, 'ffn_ln_kernel'):.4f} ms")
    log(line)
    log(f"[fused_ffn_ln] {smi}: {shape} shape, plan {plan._asdict()}: weights from L2 "
        f"{weights / 1e9:.3f} GB at {weights / dev_ms / 1e9:.3f} TB/s of device time; "
        f"{plan.ctas} blocks on {min(plan.ctas, sms)} of {sms} SMs"
        + (f"; partial sums {plan.workspace * 4 / 1e6:.1f} MB written, read back by "
           f"{plan.tiles} blocks" if plan.splits > 1 else ""))


def resid_baseline_fn(baseline, res: tuple, y):
    """A launch of the o-proj entry of an earlier ``fused_bert.cu``
    (``--resid-baseline``), whose C entry took no plan:
    ``fused_resid_ln(x, ctx, ctx_bf16, w, b, ln_s, ln_b, eps, y, R, H,
    stream)`` with an f32 x and a bf16 W_o, into ``y``."""
    import ctypes

    import torch

    from financial_rag_system_tpu_torch.ops import _cuda

    fn = baseline.fused_resid_ln
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, p, p, p, ctypes.c_float, p, i, i, p]
    fn.restype = ctypes.c_int
    x, ctx, w, b, ln_s, ln_b, eps = res
    w16 = w.to(torch.bfloat16).contiguous()
    r, h = x.shape

    def launch():
        _cuda.check(fn(x.data_ptr(), ctx.data_ptr(), int(ctx.dtype == torch.bfloat16),
                       w16.data_ptr(), b.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), float(eps),
                       y.data_ptr(), r, h, torch.cuda.current_stream().cuda_stream),
                    "baseline fused_resid_ln")
        return y

    return launch


def resid_yardsticks(torch, smi: str, shape: str, res: tuple, pack, out: dict,
                     baseline=None) -> None:
    """Kernel 6 at one shape beside its yardsticks, on the same inputs: its
    device time from the profiler beside the CUDA-event time; the product
    alone (``torch.mm(ctx_bf16, W_o^T, out_dtype=f32)``, no bias, residual
    or layernorm) as ``gemm_ms``; the plan (cluster size, blocks on how
    many SMs, W_o bytes each block reads from L2 once) and the kernel's
    device-memory rate (x, ctx and y once, over device time) beside a plain
    copy's; with ``baseline`` (``--resid-baseline``) an earlier build's
    kernel timed in turns (old, new, new, old) with its device time and the
    outputs' largest difference.  Adds ``device_ms`` and ``gemm_ms`` to
    ``out``."""
    import ctypes

    from financial_rag_system_tpu_torch.ops import fused_bert as fb

    x, ctx, w, b, ln_s, ln_b, eps = res
    r, h = x.shape
    bf, f32 = torch.bfloat16, torch.float32
    c16, w16 = ctx.to(bf), pack.w
    gemm_ms = median_ms(lambda: torch.mm(c16, w16.t(), out_dtype=f32), reps=20)

    def kernel():
        return fb.fused_resid_ln(*res, pack)

    dev_ms = device_ms(torch, kernel, "resid_ln_kernel")
    out.update(device_ms=dev_ms, gemm_ms=gemm_ms)
    line = (f"[fused_resid_ln] {smi}: {shape} shape ({str(ctx.dtype)[6:]} ctx): kernel "
            f"{out['ms']:.4f} ms (device {dev_ms:.4f} ms), gemm_ms {gemm_ms:.4f}, unfused_ms "
            f"{out['unfused_ms']:.4f}, bound {out['bound_ms']:.4f} ms; met by device time "
            f"{out['bound_ms'] / dev_ms:.3f} of the bound")
    if baseline is not None:
        new = kernel()
        old_launch = resid_baseline_fn(baseline, res, torch.empty_like(new))
        old = old_launch()
        torch.cuda.synchronize()
        diff = float((new - old).abs().max())
        turns = [median_ms(old_launch, reps=20), median_ms(kernel, reps=20),
                 median_ms(kernel, reps=20), median_ms(old_launch, reps=20)]
        line += (f"; baseline: max abs diff {diff:.3g}, old, new, new, old "
                 f"{[round(t, 4) for t in turns]} ms, old device "
                 f"{device_ms(torch, old_launch, 'resid_ln_kernel'):.4f} ms")
    log(line)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctx_bf16 = ctx.dtype == bf
    plan = fb.resid_plan(h, r, sms, ctx_bf16)
    held = ctypes.c_int(0)
    fb._cuda.check(fb._library().resid_ln_clusters(h, plan.cluster, int(ctx_bf16),
                                                   ctypes.byref(held)), "resid_ln_clusters")
    blocks = min(plan.ctas, held.value * plan.cluster)
    weights = blocks * (h // plan.cluster) * h * 2  # each block reads its slice once
    dram = r * h * (x.element_size() + ctx.element_size() + 4)
    src = torch.empty(dram // 2, dtype=torch.uint8, device=x.device)
    dst = torch.empty_like(src)
    copy_ms = median_ms(lambda: dst.copy_(src), reps=20)
    del src, dst
    rate = dram / copy_ms / 1e9  # TB/s
    log(f"[fused_resid_ln] {smi}: {shape} shape, plan {plan._asdict()}: clusters of "
        f"{plan.cluster}, {blocks} blocks on {blocks} of {sms} SMs (the card holds "
        f"{held.value} such clusters at once); W_o from L2 {weights / 1e6:.3f} MB; device "
        f"memory {dram / 1e9:.4f} GB at {dram / dev_ms / 1e9:.3f} TB/s of device time; a copy "
        f"of as many bytes moves {rate:.3f} TB/s, {dram / rate / 1e9:.4f} ms (the kernel at "
        f"{dram / rate / 1e9 / dev_ms:.3f} of it)")


def check_fused_block_kernels(torch, run: dict, smi: str, ffn_baseline=None,
                              resid_baseline=None) -> list[dict]:
    """Kernels 4-6 at the main path's rerank and embed shapes, on a random
    (R, H) activation, the models' first-layer weights and random biases
    and layernorm parameters (the random-init checkpoints' are 0 and 1).
    Kernel 6 takes the context the main path gives it at each shape (bf16
    from kernel 2 at the rerank shape, f32 from the einsum path at the
    embed shape) and is checked with the other type too."""
    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.ops import fused_bert as fb

    engine = run["engine"]
    bf, f32 = torch.bfloat16, torch.float32
    plen = run["lq"] + DLEN
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)

    def randn(*shape, scale=1.0, loc=0.0):
        return loc + scale * torch.randn(shape, generator=g, device="cuda")

    # kernel 5 on ragged row counts: a last tile cut short, and blocks
    # that walk unequal numbers of tiles
    lp = engine.reranker.model.layers[0]
    h = lp.q.weight.shape[1]
    for r in (777, 64 * 137 + 5):
        x = randn(r, h)
        qkv = (x, lp.q.weight, randn(h, scale=0.01), lp.k.weight, randn(h, scale=0.01),
               lp.v.weight, randn(h, scale=0.01))
        err = fused_kernel_err(torch, f"fused_qkv at R {r}", lambda: fb.fused_qkv(*qkv),
                               lambda: fb.fused_qkv_plain(*qkv))
        log(f"[fused_qkv] ragged R {r}: max_abs_err {err:.3g}")

    out = {}
    for shape, model, r in (("rerank", engine.reranker.model, PAIRS * plen),
                            ("embed", engine.embedder.model, B * run["lq"])):
        lp, cfg = model.layers[0], model.cfg
        h, i, eps = cfg.hidden, cfg.intermediate, cfg.ln_eps
        x = randn(r, h)
        ctx32 = randn(r, h)
        ctx = ctx32.to(bf)  # as the attention kernel gives it
        w32 = {n: getattr(lp, n).weight for n in ("q", "k", "v", "o", "inter", "out")}
        w = {n: t.to(bf) for n, t in w32.items()}
        b = {n: randn(t.shape[0], scale=0.01) for n, t in w32.items()}
        ln1, ln2 = ((randn(h, scale=0.1, loc=1.0), randn(h, scale=0.1)) for _ in range(2))
        ffn = (x, w["inter"], b["inter"], w["out"], b["out"], *ln2, eps)
        qkv = (x, w["q"], b["q"], w["k"], b["k"], w["v"], b["v"])
        main_ctx, other_ctx = (ctx, ctx32) if shape == "rerank" else (ctx32, ctx)
        res = (x, main_ctx, w32["o"], b["o"], *ln1, eps)
        o_pack = fb.pack_resid(w32["o"], b["o"])  # made once, as BertLayer.o_pack does
        other = str(other_ctx.dtype)[6:]
        err = fused_kernel_err(torch, f"fused_resid_ln at the {shape} shape, {other} ctx",
                               lambda: fb.fused_resid_ln(x, other_ctx, *res[2:], o_pack),
                               lambda: fb.fused_resid_ln_plain(x, other_ctx, *res[2:]))
        log(f"[fused_resid_ln] {shape} shape, {other} ctx: max_abs_err {err:.3g}")
        x16 = x.to(bf)
        pack = fb.pack_qkv(*qkv[1:])  # made once, as BertLayer.qkv_pack does

        # the unfused layer's torch sequence for each half-layer (models/bert.py)
        def unfused_ffn():
            up = bert._gelu(bert._matmul(x, w32["inter"], b["inter"]))
            return bert._ln(x + bert._matmul(up, w32["out"], b["out"]), *ln2, eps)

        def unfused_qkv():
            hb = x.to(bf)
            return [bert._matmul(hb, w32[n], b[n]) for n in ("q", "k", "v")]

        def unfused_resid():
            return bert._ln(x + bert._matmul(main_ctx, w32["o"], b["o"]), *ln1, eps)

        out[shape] = {
            "fused_ffn_ln": time_fused_kernel(
                torch, smi, "fused_ffn_ln", shape, lambda: fb.fused_ffn_ln(*ffn),
                lambda: fb.fused_ffn_ln_plain(*ffn), unfused_ffn, None,
                r * h * 4 * 2 + 2 * h * i * 2 + (i + 3 * h) * 4, 4.0 * r * h * i),
            "fused_qkv": time_fused_kernel(
                torch, smi, "fused_qkv", shape, lambda: fb.fused_qkv(*qkv, pack),
                lambda: fb.fused_qkv_plain(*qkv), unfused_qkv,
                lambda: torch.mm(x16, pack[0].t(), out_dtype=f32),
                r * h * 4 * 4 + 3 * h * h * 2 + 3 * h * 4, 6.0 * r * h * h),
            "fused_resid_ln": time_fused_kernel(
                torch, smi, "fused_resid_ln", shape, lambda: fb.fused_resid_ln(*res, o_pack),
                lambda: fb.fused_resid_ln_plain(*res), unfused_resid, None,
                r * h * (4 + main_ctx.element_size() + 4) + h * h * 2 + 3 * h * 4,
                2.0 * r * h * h),
        }
        resid_yardsticks(torch, smi, shape, res, o_pack, out[shape]["fused_resid_ln"],
                         resid_baseline)
        ffn_yardsticks(torch, smi, shape, ffn, out[shape]["fused_ffn_ln"], ffn_baseline)
        qkv_limits(torch, smi, shape, x, out[shape]["fused_qkv"]["ms"], fb.qkv_plan(
            h, r, torch.cuda.get_device_properties(0).multi_processor_count))
    lines = {"fused_ffn_ln": 47, "fused_qkv": 73, "fused_resid_ln": 89}
    return [{"name": name, "route": "cuda", "source": f"{PACKAGE}/csrc/fused_bert.cu",
             "replaces": f"financial_rag_system_tpu/ops/fused_bert.py:{line}",
             **out["rerank"][name]} for name, line in lines.items()]


# -- phase 6: int8 corpora ------------------------------------------------------------

def check_topk_int8(torch, np, smi: str, baseline: Path | None = None) -> dict:
    """Kernel 1's int8 branch against its plain version at the main path's
    shape (phase 2's inputs, quantized), bit for bit in scores and ids,
    with a planted tie; its time, the plain version's and its bound
    (bytes at the memory rate, operations at the int8 tensor-core rate)."""
    from financial_rag_system_tpu_torch.index.flat import quantize_int8
    from financial_rag_system_tpu_torch.ops.topk import masked_topk, masked_topk_plain, topk_plan

    n_valid = N - 100
    q, c, codes, qf = topk_inputs(torch, np.random.default_rng(SEED), n_valid)
    args = (quantize_int8(q), quantize_int8(c), codes, qf, n_valid, K)
    del q, c
    s, i = (x.cpu().numpy() for x in masked_topk(*args))
    torch.cuda.synchronize()
    s_ref, i_ref = (x.cpu().numpy() for x in masked_topk_plain(*args))
    if s.tobytes() != s_ref.tobytes() or i.tobytes() != i_ref.tobytes():
        raise AssertionError("int8 top-k differs from its plain version")
    if np.isfinite(s[0]).sum() != 3:
        raise AssertionError("the 3-row filter must give exactly 3 hits")
    if not (i[1, 0] == 70_000 and i[1, 1] == 70_001 and s[1, 0] == s[1, 1]):
        raise AssertionError("duplicated rows must tie, lower id first")
    ms = median_ms(lambda: masked_topk(*args), reps=50)
    plain_ms = median_ms(lambda: masked_topk_plain(*args), reps=10)
    nbytes = N * D + 2 * N * 4 + B * D + B * 2 * 4 + B * K * 8
    b_ms, b_by = bound_ms(nbytes, 2.0 * B * N * D, INT8_OP_PER_S)
    log(f"[topk-int8] {smi}: B={B} N={N} D={D} K={K}: scores and ids bit for bit, tie by "
        f"lower row; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    retrieval_timing(torch, f"[topk-int8] int8 B={B} N={N}:", lambda: masked_topk(*args), ms,
                     smi)
    plan_line(f"[topk-int8] int8 B={B} N={N}:", topk_plan(B, N, D, 1, K, sms(torch)))
    if baseline is not None:
        against_parent(torch, f"[topk-int8] int8 B={B} N={N}:", smi,
                       parent_topk_fn(torch, baseline_lib("masked_topk", baseline), args),
                       lambda: masked_topk(*args))
    return {
        "name": "masked_topk_int8", "route": "cuda",
        "source": f"{PACKAGE}/csrc/masked_topk.cu",
        "replaces": "financial_rag_system_tpu/ops/topk.py:99",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def write_int8_index(torch, np, work: Path, main: dict) -> dict:
    """The phase-3 corpus as an int8 index in the JAX format, saved in
    ``work / "index_int8"``: the bf16 index's rows widened, renormalized
    and quantized (``index/flat.py quantize_int8``), with its codes, token
    store and documents.  For the card-vs-CPU check, each of the first two
    burst questions gets K of the rows its filter admits set to cosines
    0.90, 0.88, ... with its vector, so its top K stand clear of the
    quantization.  Returns the bf16 tensor of the same vectors too."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex, quantize_int8

    t0 = time.perf_counter()
    engine = main["engine"]
    flat = engine.index
    emb, codes, dtok = (t[:N] for t in flat._arrays)
    vecs = emb.float()
    queries = main["burst"][:2]
    qv = engine.embedder.encode([q for q, _, _ in queries])
    host_codes = codes.cpu().numpy()
    rng = np.random.default_rng(SEED + 7)
    planted = []
    for v, (_, t, d) in zip(qv, queries):
        tc, dc = flat.store.query_codes(t, d)
        ok = ((tc == -1) | (host_codes[0] == tc)) & ((dc == -1) | (host_codes[1] == dc))
        rows = rng.choice(np.flatnonzero(ok), K, replace=False)
        for j, r in enumerate(rows):
            cos = 0.9 - 0.02 * j
            noise = rng.standard_normal(D)
            noise -= (noise @ v) * v
            vecs[r] = torch.as_tensor(cos * v + np.sqrt(1 - cos**2) * noise
                                      / np.linalg.norm(noise), dtype=torch.float32,
                                      device=vecs.device)
        planted.append(rows)
    vecs = torch.nn.functional.normalize(vecs, dim=1)
    index = FlatIndex(D, capacity=N, token_store_len=DLEN, device="cpu", dtype=torch.int8)
    index._arrays = (quantize_int8(vecs).cpu(), codes.cpu(), dtok.cpu())
    index.store = flat.store
    index.save(str(work / "index_int8"))
    log(f"[int8] the phase-3 corpus as an int8 index ({K} rows planted for each of 2 "
        f"questions) written in {time.perf_counter() - t0:.1f} s")
    return {"dir": "index_int8", "bf16": vecs.to(torch.bfloat16), "queries": queries,
            "planted": np.stack(planted)}


def check_int8_against_cpu(torch, np, run: dict, int8: dict, work: Path, cpu_models) -> None:
    """The int8 flat pipeline on the card against the same pipeline on the
    CPU over the same saved index: the planted rows in both, identical;
    each side's bi scores equal, bit for bit, its own quantized queries'
    integer dot products with those rows; the two sides' quantized queries
    differ by at most one step a component (their f32 vectors differ in
    the last digits, which moves a component across a rounding boundary
    now and then); rerank logits within phase 3's 5e-2."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.ops import fused_query as fq

    engine = run["engine"]
    queries = int8["queries"]
    cpu_index = FlatIndex.load(str(work / int8["dir"]), device="cpu")
    card = (engine.embedder, engine.reranker)
    got = flat_batch(torch, engine, queries, "cuda", engine.index, card)
    with env_set(**CPU_TANH):
        ref = flat_batch(torch, engine, queries, "cpu", cpu_index, cpu_models)
    (rows_g, bi_g, ce_g), (rows_c, bi_c, ce_c) = got, ref
    if not (cpu_index.quantized and (rows_g == int8["planted"]).all() and (rows_c == rows_g).all()):
        raise AssertionError(f"int8 card vs CPU: rows\n{rows_g}\n{rows_c}\n{int8['planted']}")

    def quantized_queries(dev, models):
        ids, types, mask, _ = fused_inputs(torch, engine, queries, dev)
        with torch.inference_mode():
            qv = fq._embed(models[0].model, ids, types, mask)
        return fq._prep_queries(qv, torch.int8).cpu().numpy()[: len(queries)]

    rows = cpu_index._emb.numpy().astype(np.int64)[rows_g]  # (2, K, D)
    q_g = quantized_queries("cuda", card)
    with env_set(**CPU_TANH):
        q_c = quantized_queries("cpu", cpu_models)
    for side, q, bi in (("card", q_g, bi_g), ("CPU", q_c, bi_c)):
        if not (np.einsum("bkd,bd->bk", rows, q.astype(np.int64)) == bi).all():
            raise AssertionError(f"int8 {side} bi scores are not its queries' dot products")
    steps = np.abs(q_g.astype(np.int64) - q_c)
    ce_err = float(np.abs(ce_g - ce_c).max())
    if steps.max() > 1 or ce_err > 5e-2:
        raise AssertionError(f"int8 card vs CPU: query steps {steps.max()}, ce err {ce_err}")
    log(f"[int8] card vs CPU on {len(queries)} queries: the same {rows_g.size} rows (the "
        f"planted ones); bi scores each side's exact dot products; quantized query "
        f"components that differ by one step: {int(steps.sum())} of {steps.size}, bi err "
        f"{float(np.abs(bi_g - bi_c).max()):.0f} (of {float(np.abs(bi_c).max()):.0f}); ce err "
        f"{ce_err:.3g}")


def int8_overlap(torch, np, run: dict, int8: dict, smi: str) -> None:
    """Reported only: the top-15 of the burst's 32 questions over the int8
    index against the top-15 over the bf16 rows of the same vectors (the
    same query vectors, quantized or cast), through kernel 1."""
    from financial_rag_system_tpu_torch.index.flat import quantize_int8
    from financial_rag_system_tpu_torch.ops import fused_query as fq
    from financial_rag_system_tpu_torch.ops.topk import masked_topk

    engine = run["engine"]
    ids, types, mask, qf = fused_inputs(torch, engine, run["burst"], "cuda")
    with torch.inference_mode():
        qv = fq._embed(engine.embedder.model, ids, types, mask)
    emb8, codes, _ = engine.index._arrays
    r8 = masked_topk(quantize_int8(qv), emb8, codes, qf, N, K)[1].cpu().numpy()[:B]
    r16 = masked_topk(qv.to(torch.bfloat16), int8["bf16"], codes[:, :N].contiguous(), qf, N,
                      K)[1].cpu().numpy()[:B]
    overlap = [len(set(a.tolist()) & set(b.tolist()) - {-1}) for a, b in zip(r8, r16)]
    log(f"[int8] {smi}: top-{K} of {B} questions, int8 index against bf16 rows of the same "
        f"vectors: overlap mean {np.mean(overlap) / K:.4f}, lowest {min(overlap)} of {K}, "
        f"queries with all {K} shared {overlap.count(K)} of {B}")


# -- phase 7: the hermetic hash stack -----------------------------------------------

# 16,384 rows a ticker over the 131,072: above IVFIndex.SELECTIVE_LIMIT,
# so that no filter of the IVF burst is scored exactly (staged)
HASH_TICKERS = 8


@contextlib.contextmanager
def env_unset(*names: str):
    """Unset environment variables for the block, then restore them."""
    saved = {k: os.environ.pop(k) for k in names if k in os.environ}
    try:
        yield
    finally:
        os.environ.update(saved)


def hash_rows(torch, table):
    """``embed`` for write_index: each chunk's row is the hash bag of its
    [CLS] + token-store ids, as ``HashEmbedder.encode`` makes it for the
    text with those ids, computed on the card."""
    from financial_rag_system_tpu_torch.models.embedder import _hash_embed
    from financial_rag_system_tpu_torch.models.tokenizer import CLS_ID

    def embed(dtok):
        out = []
        with torch.inference_mode():
            for r0 in range(0, len(dtok), 16_384):
                ids = torch.as_tensor(dtok[r0:r0 + 16_384], device=table.device)
                ids = torch.cat([torch.full_like(ids[:, :1], CLS_ID), ids], dim=1)
                out.append(_hash_embed(table, ids, ids != 0).cpu())
        return torch.cat(out).numpy()
    return embed


def hash_batch(torch, engine, queries, dev, arrays, tables):
    """``fused_hash_rerank_query`` on ``dev`` over a flat index's
    ``arrays`` with the (embedder, reranker) ``tables``: rows, bi and ce
    of the first ``len(queries)`` queries as numpy arrays."""
    from financial_rag_system_tpu_torch.ops.fused_query import fused_hash_rerank_query

    ids, _, mask, qf = fused_inputs(torch, engine, queries, dev)
    emb, codes, dtok = arrays
    _, bi, rows, ce = fused_hash_rerank_query(*tables, ids, mask, qf, emb, codes, dtok, N,
                                              k=K)
    return [x.cpu().numpy()[: len(queries)] for x in (rows, bi, ce)]


def drive_hash_path(torch, np, work: Path, smi: str) -> list[dict]:
    """Phase 7: the port as it starts with no checkpoints.
    ``build_default_engine(device="cuda")`` with no ``RAG_TPU_BGE_DIR`` /
    ``RAG_TPU_RERANKER_DIR`` serves the hash stack (seeded tables, the same
    bits as the numpy draw) over a persisted 131,072-row index of
    1000-character chunks (rows: their hash bags; the 368-wide token store;
    HASH_TICKERS tickers), with the de-aliased hash rerank on the card:
    3 single asks, a burst of 32 (one fused "hash" batch) and a cache hit,
    kernel 1's launches read around the run, one batch against the same
    program on the CPU; then ``engine.rebuild_index("ivf")`` and a burst
    of 32 on "ivf_hash", kernel 3's launches, recall@15 against the flat
    hash top-15.  The IVF runs over these 131,072 rows, not phase 4's 1M.
    Last, a TESTING-mode engine (the identity reranker): one ask whose
    sources keep retrieval order.  The LLM leg is the mock client (no
    network).  Returns each run's launches."""
    from financial_rag_system_tpu_torch.models.embedder import HashEmbedder
    from financial_rag_system_tpu_torch.models.reranker import HashReranker
    from financial_rag_system_tpu_torch.obs.tracing import get_tracer
    from financial_rag_system_tpu_torch.ops.fused_query import (
        fused_hash_query,
        fused_ivf_hash_query,
    )
    from financial_rag_system_tpu_torch.serving.app import build_default_engine
    from financial_rag_system_tpu_torch.serving.llm import MockLLMClient
    from financial_rag_system_tpu_torch.utils.config import reset_config

    t0 = time.perf_counter()
    cpu_tables = (HashEmbedder(device="cpu").table, HashReranker(device="cpu").table)
    t_tables = time.perf_counter() - t0
    write_index(torch, np, work, "index_hash", HASH_TICKERS,
                hash_rows(torch, cpu_tables[0].to("cuda")))
    t_index = time.perf_counter() - t0 - t_tables
    tickers = [f"T{i:02d}" for i in range(HASH_TICKERS)]
    singles = [("what was revenue growth in the last quarter (hash)", tickers[3], None),
               ("analyze the margin trajectory (hash)", tickers[5], "10-K"),
               ("supply chain risk (hash)", tickers[1], None)]
    burst = [(f"hash question {i} about segment results and liquidity",
              tickers[i % HASH_TICKERS], DOC_TYPES[i % 3] if i % 2 else None) for i in range(B)]
    runs = []
    with env_unset("RAG_TPU_BGE_DIR", "RAG_TPU_RERANKER_DIR", "RAG_TPU_INDEX_DTYPE",
                   "RAG_TPU_FUSED_BLOCK"), \
            env_set(INDEX_DIR=str(work / "index_hash"), TESTING="false",
                    DATABASE_URL=str(work / "cache_hash.db"),
                    RAG_TPU_CB_PATH=str(work / "breaker_hash.json"),
                    RAG_TPU_BATCH_WINDOW_S="0.25", RAG_TPU_BATCH_EAGER_IDLE_S="0"):
        reset_config()
        t1 = time.perf_counter()
        engine = build_default_engine(device="cuda")
        t_engine = time.perf_counter() - t1
        engine.llm = MockLLMClient(engine.cfg)  # no network: the canned answer
        engine.llm_semaphore = asyncio.Semaphore(B)
        st = engine.queue_status()
        if not (isinstance(engine.embedder, HashEmbedder)
                and isinstance(engine.reranker, HashReranker) and not engine.reranker.identity
                and st["fused_kind"] == "hash" and st["fused_hash_rerank"]):
            raise AssertionError(f"the hash stack did not start fused: {st}")
        if not (torch.equal(engine.embedder.table.cpu(), cpu_tables[0])
                and torch.equal(engine.reranker.table.cpu(), cpu_tables[1])):
            raise AssertionError("the card's hash tables differ from the numpy draw")
        batches = []
        inner = engine.batcher.batch_fn

        def timed_batch(queries, filters):
            t = time.perf_counter()
            out = inner(queries, filters)
            batches.append((len(queries), round((time.perf_counter() - t) * 1e3, 2)))
            return out

        engine.batcher.batch_fn = timed_batch
        ivf_burst = [(f"{q} (ivf)", t, d) for q, t, d in burst]
        n_flat = []

        async def scenario():
            # one event loop for the engine's life: its batcher's queue
            # belongs to the loop that first used it
            await engine.startup()
            try:
                answers = [await engine.ask(q, t, 5, d) for q, t, d in singles]
                answers += await asyncio.gather(*[engine.ask(q, t, 5, d) for q, t, d in burst])
                await asyncio.sleep(0.2)  # write-behind cache saves land
                again = await engine.ask(*singles[0][:2], 5, singles[0][2])
                runs.append({"launches": read_launches()})
                n_flat.append(len(batches))
                t1 = time.perf_counter()
                built = engine.rebuild_index("ivf")  # the call behind POST /index/rebuild
                t_ivf = time.perf_counter() - t1
                reset_launches()
                ivf_answers = await asyncio.gather(*[engine.ask(q, t, 5, d)
                                                     for q, t, d in ivf_burst])
                runs.append({"launches": read_launches()})
            finally:
                await engine.shutdown()
            return answers, again, built, t_ivf, ivf_answers

        get_tracer().reset()
        reset_launches()
        answers, again, built, t_ivf, ivf_answers = asyncio.run(scenario())
        flat_batches, ivf_batches = batches[:n_flat[0]], batches[n_flat[0]:]
        batches = flat_batches
        if [n for n, _ in batches] != [1, 1, 1, B]:
            raise AssertionError(f"hash: batch sizes {batches}")
        if runs[0]["launches"] != want_launches(masked_topk=4):
            raise AssertionError(f"hash: launches {runs[0]['launches']}")
        check_answers(np, answers, 5)
        if not (again["cached"] and again["provider"] == "Cache"):
            raise AssertionError("hash: the repeated query was not a cache hit")
        snap = get_tracer().metrics_snapshot()
        stage = {m: snap[m] for m in ("fused_tokenize_ms", "fused_device_ms", "fused_assemble_ms")}
        log(f"[hash] {smi}: tables (numpy, 2 x {tuple(cpu_tables[0].shape)}) {t_tables:.2f} s, "
            f"index written {t_index:.2f} s, build_default_engine {t_engine:.2f} s; "
            f"launches {runs[0]['launches']}; batch walls (size, ms) {batches}")
        log(f"[hash] {smi}: stage split over all batches: {json.dumps(stage)}")

        # one batch against the same program on the CPU
        from financial_rag_system_tpu_torch.index.flat import FlatIndex

        cpu_index = FlatIndex.load(str(work / "index_hash"), device="cpu")
        card_tables = (engine.embedder.table, engine.reranker.table)
        got = hash_batch(torch, engine, burst[:4], "cuda", engine.index.flat._arrays,
                         card_tables)
        ref = hash_batch(torch, engine, burst[:4], "cpu", cpu_index._arrays, cpu_tables)
        fin = np.isfinite(ref[1])
        bi_err = float(np.abs(got[1][fin] - ref[1][fin]).max())
        ce_err = float(np.abs(got[2][fin] - ref[2][fin]).max())
        if not ((got[0] == ref[0]).all() and (np.isfinite(got[1]) == fin).all()
                and bi_err <= 1e-5 and ce_err <= 1e-5):
            raise AssertionError(f"hash card vs CPU: rows\n{got[0]}\n{ref[0]}\n"
                                 f"bi err {bi_err}, ce err {ce_err}")
        log(f"[hash] card vs CPU on 4 queries: the same {fin.sum()} rows, bi err {bi_err:.3g}, "
            f"ce err {ce_err:.3g}")

        # the IVF tier over the same rows, promoted inside the run above
        st = engine.queue_status()
        if st["fused_kind"] != "ivf_hash" or not st["fused_hash_rerank"] or built["tail_rows"]:
            raise AssertionError(f"rebuild_index: {built}, {st}")
        if runs[-1]["launches"] != want_launches(ivf_probe=1) or [n for n, _ in ivf_batches] != [B]:
            raise AssertionError(f"ivf_hash: launches {runs[-1]['launches']}, "
                                 f"batches {ivf_batches}")
        check_answers(np, ivf_answers, 5)
        idx = engine.index
        ids, _, mask, qf = fused_inputs(torch, engine, ivf_burst, "cuda")
        emb, codes, _ = idx.flat._arrays
        _, exact_s, exact_rows = fused_hash_query(engine.embedder.table, ids, mask, qf, emb,
                                                  codes, idx.n_valid, k=K)
        _, _, rows, active = fused_ivf_hash_query(
            engine.embedder.table, ids, mask, qf, *idx._state[:4], k=K, tile=idx.tile,
            nprobe=idx.nprobe, tiles_per_cluster=idx.tiles_per_cluster)
        recall = recall_at_k(np, rows.cpu().numpy()[:B], exact_s[:B], exact_rows[:B])
        log(f"[hash-ivf] {smi}: rebuild_index('ivf') {t_ivf:.2f} s ({idx.n_clusters} clusters, "
            f"nprobe {idx.nprobe}, {int(active)} of {idx._state.geom.num_tiles} tiles probed "
            f"by the burst); launches {runs[-1]['launches']}; batch wall (size, ms) {ivf_batches}; "
            f"recall@{K} against the flat hash top-{K}: mean {np.mean(recall):.4f}, lowest "
            f"{min(recall):.4f}")
        del engine

    # TESTING mode: the identity reranker keeps retrieval order
    with env_unset("RAG_TPU_BGE_DIR", "RAG_TPU_RERANKER_DIR", "RAG_TPU_INDEX_DTYPE",
                   "RAG_TPU_FUSED_BLOCK"), \
            env_set(INDEX_DIR=str(work / "index_hash"), TESTING="true",
                    DATABASE_URL=str(work / "cache_testing.db"),
                    RAG_TPU_CB_PATH=str(work / "breaker_testing.json")):
        reset_config()
        engine = build_default_engine(device="cuda")
        st = engine.queue_status()
        if not (engine.reranker.identity and st["fused_kind"] == "hash"
                and not st["fused_hash_rerank"]):
            raise AssertionError(f"TESTING mode: {st}")
        async def ask_once():
            await engine.startup()
            try:
                return await engine.ask(*singles[0][:2], 5, singles[0][2])
            finally:
                await engine.shutdown()

        reset_launches()
        answer = asyncio.run(ask_once())
        runs.append({"launches": read_launches()})
        if runs[-1]["launches"] != want_launches(masked_topk=1):
            raise AssertionError(f"TESTING: launches {runs[-1]['launches']}")
        ids, _, mask, qf = fused_inputs(torch, engine, [singles[0]], "cuda")
        emb, codes, _ = engine.index._arrays
        _, bi, rows = fused_hash_query(engine.embedder.table, ids, mask, qf, emb, codes,
                                       engine.index.n_valid, k=K)
        want = [engine.index.store.get(int(r))["text"] for r in rows[0, :5].tolist()]
        got = [src["text"] for src in answer["sources"]]
        scores = [src["score"] for src in answer["sources"]]
        if got != want or scores != sorted(scores, reverse=True):
            raise AssertionError(f"TESTING mode: sources {got} are not retrieval order {want}")
        log(f"[hash-testing] {smi}: identity reranker, one ask: {len(got)} sources in retrieval "
            f"order (bi scores {[round(x, 4) for x in scores]}); launches {runs[-1]['launches']}")
        del engine
    reset_config()
    return runs


# -- phase 8: the HNSW path ------------------------------------------------------

# 16,384 rows a ticker over the 131,072: above HNSWIndex.SELECTIVE_LIMIT, so
# that no filter of a burst is scored exactly (staged); RARE's rows are
HNSW_TICKERS = 8
HNSW_DIR = "index_hnsw"
HNSW_NEAR = 1e-5  # rows compared wherever neighbouring scores differ by more


def hnsw_state_on(torch, idx, dev):
    """(emb, codes, adj, entries, pool rows, hierarchy) of ``idx``'s
    snapshot on ``dev``: what hnsw_routed_walk reads."""
    adj, ent, _pad, _ef, _rbt, _n, hier, pool = idx._graph_state
    emb, codes, _ = idx.flat._arrays
    hier = None if hier is None else (hier[0].to(dev), hier[1].to(dev), hier[2])
    return (emb.to(dev), codes.to(dev), adj.to(dev), ent.to(dev), pool[0].to(dev), hier)


def hnsw_walk_of(torch, idx, q, qf, dev):
    """The routed walk of ``idx`` (its geometry and snapshot, on ``dev``)."""
    from financial_rag_system_tpu_torch.index.hnsw import hnsw_routed_walk

    emb, codes, adj, ent, pool, hier = hnsw_state_on(torch, idx, dev)
    st = idx._graph_state
    return hnsw_routed_walk(q.to(dev), qf.to(dev), emb, codes, adj, ent, pool, hier, K, ef=st[3],
                            steps=idx.steps, frontier=idx.frontier, pad_id=st[2],
                            take=st[7][3], descend=idx.descend if hier is not None else None)


def rows_where_clear(np, rows, s_ref, rows_ref, what: str) -> int:
    """The same rows wherever neighbouring reference scores differ by more
    than HNSW_NEAR; returns how many rows differ in all."""
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(s_ref, axis=1))
    near = np.zeros(s_ref.shape, bool)
    near[:, 1:] |= ~(gap > HNSW_NEAR)
    near[:, :-1] |= ~(gap > HNSW_NEAR)
    if not (rows[~near] == rows_ref[~near]).all():
        raise AssertionError(f"{what}: rows differ where the scores stand apart")
    return int((rows != rows_ref).sum())


def drive_hnsw_path(torch, np, work: Path, smi: str) -> dict:
    """Phase 8, the HNSW tier as users reach it: a persisted 131,072-row
    clustered index (the IVF corpus's topics, HNSW_TICKERS tickers, RARE's
    rows, the 368-wide token store) behind ``build_default_engine(
    device="cuda")`` with phase 3's checkpoints, promoted by
    ``rebuild_index("hnsw")`` (the native build, JAX's defaults and
    routing aids); 3 single asks, two bursts of 32 (one fused "hnsw_full"
    batch each), a RARE ask (staged: its inverted list, kernel 1), an
    upsert that enters the graph online and an ask that finds it, and a
    cache hit, with the launches read around the run."""
    from financial_rag_system_tpu_torch.index.hnsw import HNSWIndex
    from financial_rag_system_tpu_torch.serving.app import build_default_engine
    from financial_rag_system_tpu_torch.utils.config import reset_config

    t0 = time.perf_counter()
    flat = clustered_flat(torch, np, N, None, SEED + 4, torch.device("cuda"),
                          n_tickers=HNSW_TICKERS)
    flat.save(str(work / HNSW_DIR))
    del flat
    log(f"[hnsw] {N} clustered rows ({HNSW_TICKERS} tickers x {len(DOC_TYPES)} doc types, "
        f"{RARE_ROWS} rows of {RARE}) made on the card and saved in "
        f"{time.perf_counter() - t0:.1f} s")
    with env_set(INDEX_DIR=str(work / HNSW_DIR), DATABASE_URL=str(work / "cache_hnsw.db")):
        reset_config()
        engine = build_default_engine(device="cuda")
    tok = engine.embedder.tokenizer
    if tok._get_native() is None:
        raise AssertionError("the C++ tokenizer did not build or load")
    t0 = time.perf_counter()
    built = engine.rebuild_index("hnsw")  # the call behind POST /index/rebuild
    build_s = time.perf_counter() - t0
    idx = engine.index
    adj, ent, pad, ef, _rbt, n_graph, hier, pool = idx._graph_state
    kind = engine.queue_status()["fused_kind"]
    if not (isinstance(idx, HNSWIndex) and idx._native is not None and kind == "hnsw_full"
            and hier is not None and pool[3] > 0 and built["tail_rows"] == 0):
        raise AssertionError(f"rebuild_index('hnsw'): {built}, fused_kind {kind!r}, native "
                             f"{idx._native is not None}, hierarchy {hier is not None}")
    split = {k: round(v, 3) for k, v in idx.build_seconds.items()}
    log(f"[hnsw] {smi}: rebuild_index('hnsw') {build_s:.2f} s on {os.cpu_count()} host "
        f"threads, by step (s) {split}; m {idx.m} efc {idx.ef_construction} ef {ef} "
        f"(asked {idx.ef}) frontier {idx.frontier} steps {idx.steps}; {n_graph} rows, "
        f"sentinel {pad}, {int((ent < pad).sum())} entries, hierarchy {hier[2]} nodes on "
        f"{hier[1].shape[0]} levels (descent {idx.descend}), pool {pool[2]} rows, "
        f"{pool[3]} seeds a query")

    batches = []  # (size, fused, wall ms)
    fused_exec, batch_fn = engine._fused_exec, engine.batcher.batch_fn
    fused_n = [0]

    def exec_spy(*a):
        res = fused_exec(*a)
        fused_n[0] += res is not None
        return res

    def timed_batch(queries, filters):
        n0, t1 = fused_n[0], time.perf_counter()
        out = batch_fn(queries, filters)
        batches.append((len(queries), fused_n[0] > n0,
                        round((time.perf_counter() - t1) * 1e3, 2)))
        return out

    engine._fused_exec, engine.batcher.batch_fn = exec_spy, timed_batch
    engine.llm_semaphore = asyncio.Semaphore(B)
    tickers = [f"T{i:02d}" for i in range(HNSW_TICKERS)]
    singles = [("what was revenue growth in the last quarter (hnsw)", tickers[3], None),
               ("analyze the margin trajectory (hnsw)", tickers[5], "10-K"),
               ("supply chain risk (hnsw)", tickers[1], None)]
    burst = [(f"hnsw question {i} about segment results and liquidity", tickers[i % HNSW_TICKERS],
              DOC_TYPES[i % 3] if i % 2 else None) for i in range(B)]
    fresh = [f"fresh filing note {i} (hnsw): the board approved a special dividend"
             for i in range(4)]

    async def scenario():
        await engine.startup()
        try:
            answers = [await engine.ask(q, t, 5, d) for q, t, d in singles]
            for n in range(2):
                answers += await asyncio.gather(*[
                    engine.ask(f"{q} (round {n})", t, 5, d) for q, t, d in burst])
            rare = await engine.ask("liquidity risk of the rare issuer (hnsw)", RARE, 5)
            added = await engine.ingest_chunks(
                [f"fresh-{i}" for i in range(len(fresh))], fresh,
                [{"ticker": "T05", "document_type": "10-K"}] * len(fresh))
            found = await engine.ask(fresh[0], "T05", K)
            await asyncio.sleep(0.2)  # write-behind cache saves land
            repeat = await engine.ask(*singles[0][:2], 5, singles[0][2])
        finally:
            await engine.shutdown()
        return answers, rare, added, found, repeat

    reset_launches()
    answers, rare, added, found, repeat = asyncio.run(scenario())
    launches = read_launches()
    engine._fused_exec, engine.batcher.batch_fn = fused_exec, batch_fn

    shape = [(n, f) for n, f, _ in batches]
    if shape != [(1, True)] * 3 + [(B, True)] * 2 + [(1, False), (1, True)]:
        raise AssertionError(f"[hnsw] batches (size, fused) {shape}")
    n_fused = sum(f for _, f in shape)
    n_staged = len(shape) - n_fused
    # kernel 2 once a rerank layer of a fused batch; kernel 1 once for the
    # staged RARE ask (its inverted list); the walk itself is torch ops
    want = want_launches(masked_topk=n_staged, pair_attention=6 * n_fused)
    if launches != want:
        raise AssertionError(f"[hnsw] launches {launches}, want {want}")
    check_answers(np, answers + [rare], 5)
    check_answers(np, [found], K)
    if not all(f" of {RARE} " in s["text"] for s in rare["sources"]):
        raise AssertionError(f"the {RARE} ask returned other tickers: {rare['sources']}")
    if added != len(fresh) or idx._tail_rows or idx.n_graph != N + len(fresh):
        raise AssertionError(f"upsert: {added} added, graph {idx.n_graph}, tail "
                             f"{idx._tail_rows[:8]}")
    if not any(s["text"] in fresh for s in found["sources"]):
        raise AssertionError("the ask after the upsert did not find the upserted rows")
    if not (repeat["cached"] and repeat["provider"] == "Cache"):
        raise AssertionError("the repeated query was not a cache hit")
    log(f"[hnsw] {smi}: launches {launches} over {n_fused} fused and {n_staged} staged "
        f"batches; batch walls (size, fused, ms) {batches}; the upsert entered the graph "
        f"online ({idx.n_graph} rows, no tail)")
    return {"engine": engine, "burst": burst, "launches": launches}


def hnsw_burst(torch, run: dict, dev="cuda"):
    """The phase-8 burst as the engine's fused program takes it on ``dev``:
    (ids, types, mask, qf) and the query vectors of the card's embed."""
    from financial_rag_system_tpu_torch.ops.fused_query import _embed

    engine = run["engine"]
    args = fused_inputs(torch, engine, run["burst"], dev)
    return args, _embed(engine.embedder.model, *args[:3])


def check_hnsw_recall(torch, np, run: dict, smi: str) -> None:
    """Recall@15 against the exact flat top-15 (kernel 1) of the same query
    vectors and filters: the fused batch as served (each query's ticker,
    half with a document type: a result-side filter matching 1/8 or 1/24
    of the rows), the same vectors with no filter, and 32 queries drawn
    like the corpus (a row plus the topics' noise) with no filter."""
    from financial_rag_system_tpu_torch.ops.topk import masked_topk

    engine = run["engine"]
    idx = engine.index
    args, qv = hnsw_burst(torch, run)
    emb, codes, adj, ent, pool, hier = hnsw_state_on(torch, idx, "cuda")
    rows, bi, _ = engine._fused_fn(engine.embedder.model, engine.reranker.model, *args, emb,
                                   codes, adj, ent, idx.flat._arrays[2], pool, hier)
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    near = emb[torch.randint(0, N, (B,), generator=g, device="cuda")].float()
    near = torch.nn.functional.normalize(
        near + TOPIC_NOISE / D**0.5 * torch.randn((B, D), generator=g, device="cuda"), dim=1)
    anyf = torch.full((B, 2), -1, dtype=torch.int32, device="cuda")
    lines = []
    for what, q, qf, got in (
        ("the fused batch as served", qv, args[3], rows),
        ("its vectors unfiltered", qv, anyf, None),
        ("queries drawn like the corpus, unfiltered", near, anyf, None),
    ):
        if got is None:
            got = hnsw_walk_of(torch, idx, q, qf, "cuda")[1]
        exact_s, exact_r = masked_topk(idx.flat.prep_queries(q), emb, codes, qf,
                                       idx.flat.n_valid, K)
        rec = recall_at_k(np, got.cpu().numpy()[:B], exact_s[:B], exact_r[:B])
        lines.append(f"{what} mean {np.mean(rec):.4f}, lowest {min(rec):.4f}, "
                     f"at 1.0 {rec.count(1.0)} of {B}")
    log(f"[hnsw] {smi}: recall@{K} against the exact flat top-{K}: " + "; ".join(lines))


def check_hnsw_against_cpu(torch, np, run: dict, work: Path, cpu_models) -> None:
    """The graph saved on the card and loaded on the CPU (HNSWIndex.load):
    identical adjacency, entries, hierarchy and pool.  The routed walk of
    the card's query vectors on the card and on the CPU over that graph and
    the same rows: rows identical wherever neighbouring scores differ by
    more than HNSW_NEAR (the count that differ printed); the CPU rerank of
    the card's rows within phase 3's 5e-2 of the card's logits."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.index.hnsw import HNSWIndex
    from financial_rag_system_tpu_torch.ops.fused_query import _cross_rerank

    engine = run["engine"]
    idx = engine.index
    directory = str(work / "hnsw_saved")
    t0 = time.perf_counter()
    idx.save(directory)
    cpu = HNSWIndex.load(directory, FlatIndex.load(directory, device="cpu"))
    load_s = time.perf_counter() - t0
    native = idx._native
    hi_ids, _levels, hi_adj = native.hierarchy()
    cpu_ids, cpu_adj, cpu_n = cpu._graph_state[6]
    same = (np.array_equal(cpu._host_graph[0], native.adjacency())
            and np.array_equal(cpu._host_graph[1], native.entries(idx.entries_cap))
            and cpu_n == len(hi_ids) and np.array_equal(cpu_ids[:cpu_n].numpy(), hi_ids)
            and np.array_equal(cpu_adj[:, :cpu_n].numpy(), np.where(hi_adj < 0, cpu_n, hi_adj))
            and np.array_equal(cpu._host_pool[0], idx._host_pool[0]))
    if not same or cpu.n_graph != idx.n_graph or cpu._tail_rows:
        raise AssertionError("the graph loaded on the CPU differs from the card's")
    args, qv = hnsw_burst(torch, run)
    s_c, r_c = (x.cpu().numpy() for x in hnsw_walk_of(torch, idx, qv, args[3], "cuda"))
    s_r, r_r = (x.numpy() for x in hnsw_walk_of(torch, cpu, qv.cpu(), args[3].cpu(), "cpu"))
    s_c, r_c, s_r, r_r = s_c[:B], r_c[:B], s_r[:B], r_r[:B]
    n_diff = rows_where_clear(np, r_c, s_r, r_r, "[hnsw] card vs CPU walk")
    fin = np.isfinite(s_r)
    bi_err = float(np.abs(s_c[fin] - s_r[fin]).max())
    # the rerank of the card's rows: the card's program and the CPU models
    emb, codes, adj, ent, pool, hier = hnsw_state_on(torch, idx, "cuda")
    rows, bi, ce = engine._fused_fn(engine.embedder.model, engine.reranker.model, *args, emb,
                                    codes, adj, ent, idx.flat._arrays[2], pool, hier)
    with env_set(**CPU_TANH):
        ce_r = _cross_rerank(cpu_models[1].model, args[0].cpu(), rows.cpu(), bi.cpu(),
                             cpu.flat._arrays[2], rerank_cfg=cpu_models[1].cfg)
    ce, ce_r = ce.cpu().numpy()[:B], ce_r.numpy()[:B]
    keep = np.isfinite(ce_r)
    ce_err = float(np.abs(ce[keep] - ce_r[keep]).max())
    if bi_err > 2 * HNSW_NEAR or ce_err > 5e-2 or not (np.isfinite(ce) == keep).all():
        raise AssertionError(f"[hnsw] card vs CPU: bi err {bi_err}, ce err {ce_err}")
    log(f"[hnsw] card vs CPU: the graph saved on the card and loaded on the CPU in "
        f"{load_s:.1f} s has the same adjacency ({cpu.n_graph} x {2 * idx.m}), entries, "
        f"hierarchy and pool; the walk of {B} queries: rows differing {n_diff} of "
        f"{int(fin.sum())} (all where neighbouring scores lie within {HNSW_NEAR}), "
        f"score err {bi_err:.3g}; rerank of the card's rows on the CPU: ce err {ce_err:.3g}")


def profile_hnsw_batch(torch, np, run: dict, smi: str) -> None:
    """One fused HNSW batch of 32 split into embed, routing and walk,
    gather (token rows and pair assembly) and rerank by CUDA events
    between the stages (median of 5); the routed walk alone under the
    profiler: its device time, kernel launches and wall time; the whole
    batch's device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from financial_rag_system_tpu_torch.ops import fused_query as fq

    engine = run["engine"]
    idx = engine.index
    args, _ = hnsw_burst(torch, run)
    emb, codes, adj, ent, pool, hier = hnsw_state_on(torch, idx, "cuda")
    rerank = engine.reranker
    splits = []
    for _ in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        qv = fq._embed(engine.embedder.model, *args[:3])
        ev[1].record()
        bi, rows = hnsw_walk_of(torch, idx, qv, args[3], "cuda")
        ev[2].record()
        pair_q, pair_d = fq._gather_pairs(args[0], rows, idx.flat._arrays[2])
        pairs = fq._assemble_pairs(pair_q, pair_d, rerank_cfg=rerank.cfg)
        ev[3].record()
        hh = rerank.model.encode(*pairs)
        fq._pair_head(rerank.model, hh, pair_q.shape[0])
        ev[4].record()
        ev[4].synchronize()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    med = np.median(np.asarray(splits[1:]), axis=0)
    names = ("embed", "routing and walk", "gather", "rerank")
    log(f"[hnsw] {smi}: fused batch of {B} by stage (CUDA events, median of 5): "
        + ", ".join(f"{n} {m:.3f} ms" for n, m in zip(names, med)) + f"; total {med.sum():.3f} ms")

    def walk():
        out = hnsw_walk_of(torch, idx, qv, args[3], "cuda")
        torch.cuda.synchronize()
        return out

    walk()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        walk()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        walk()
    dev_ms, kernels, by_name = 0.0, 0, []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0) if us is None else us
        if us > 0 and not e.key.startswith("aten::"):
            dev_ms += us / 1e3
            kernels += e.count
            by_name.append((us / 1e3, e.count, e.key))
    by_name.sort(reverse=True)
    log(f"[hnsw] {smi}: the routed walk of {B} queries ({idx.steps} steps, descent "
        f"{idx.descend}): wall {statistics.median(walls):.3f} ms (median of 5, synchronised), "
        f"device {dev_ms:.3f} ms in {kernels} kernel launches; device idle share of the wall "
        f"{1 - dev_ms / statistics.median(walls):.3f}")
    for ms, count, key in by_name[:8]:
        log(f"[hnsw]   {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    profile_run(torch, lambda: engine._fused_fn(
        engine.embedder.model, rerank.model, *args, emb, codes, adj, ent,
        idx.flat._arrays[2], pool, hier), "fused_hnsw_two_stage", smi)


def drive_hnsw_int8(torch, np, run: dict, smi: str) -> dict:
    """The same rows as an int8 corpus (round(v * 127) of phase 8's rows,
    the same store, codes and token store) on the same graph (the card's
    native export, loaded: an int8 index walks the bf16 build's graph):
    one burst of 32 through the engine (one fused hnsw_full batch, kernel 2
    six times, kernel 1 never), then the card's routed walk against the
    CPU's on the same int8 queries, rows and scores bit for bit."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex, quantize_int8
    from financial_rag_system_tpu_torch.index.hnsw import HNSWIndex
    from financial_rag_system_tpu_torch.serving.engine import RAGEngine
    from financial_rag_system_tpu_torch.utils.config import get_config

    base = run["engine"]
    src = base.index
    emb, codes, dtok = src.flat._arrays
    flat8 = FlatIndex(D, capacity=src.flat.capacity, tile=src.flat.tile, token_store_len=DLEN,
                      tokenizer=base.embedder.tokenizer, device="cuda", dtype=torch.int8)
    flat8._arrays = (quantize_int8(emb.float()), codes, dtok)
    flat8.store = src.flat.store
    native = src._native
    idx8 = HNSWIndex(flat8, graph=(native.adjacency(), native.entries(src.entries_cap)),
                     hier=native.hierarchy(), pool=src._host_pool)
    engine = RAGEngine(get_config(), idx8, base.embedder, base.reranker)
    if engine.queue_status()["fused_kind"] != "hnsw_full":
        raise AssertionError("the int8 HNSW index did not fuse")
    engine.llm_semaphore = asyncio.Semaphore(B)
    sizes = []
    batch_fn = engine.batcher.batch_fn
    engine.batcher.batch_fn = lambda q, f: sizes.append(len(q)) or batch_fn(q, f)

    async def scenario():
        await engine.startup()
        try:
            return await asyncio.gather(*[engine.ask(f"{q} (hnsw int8)", t, 5, d)
                                          for q, t, d in run["burst"]])
        finally:
            await engine.shutdown()

    reset_launches()
    answers = asyncio.run(scenario())
    launches = read_launches()
    if sizes != [B] or launches != want_launches(pair_attention=6):
        raise AssertionError(f"[hnsw-int8] batches {sizes}, launches {launches}")
    check_answers(np, answers, 5)
    args, qv = hnsw_burst(torch, run)
    q8 = quantize_int8(qv)
    s_c, r_c = (x.cpu().numpy() for x in hnsw_walk_of(torch, idx8, q8, args[3], "cuda"))
    s_r, r_r = (x.numpy() for x in hnsw_walk_of(torch, idx8, q8.cpu(), args[3].cpu(), "cpu"))
    if s_c.tobytes() != s_r.tobytes() or r_c.tobytes() != r_r.tobytes():
        raise AssertionError("[hnsw-int8] the card's walk differs from the CPU's")
    log(f"[hnsw-int8] {smi}: {src.n_graph} int8 rows on the bf16 build's graph: a burst of "
        f"{B} in one fused batch, launches {launches}; the card's walk equals the CPU's bit "
        f"for bit ({int(np.isfinite(s_c).sum())} rows)")
    return {"launches": launches}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--topk-baseline", type=Path, default=None, metavar="CSRC",
        help="csrc/ directory of an earlier checkout: hold kernel 1 bit for bit against its "
             "masked_topk.cu in both branches, and time both in turns",
    )
    parser.add_argument(
        "--ivf-baseline", type=Path, default=None, metavar="CSRC",
        help="csrc/ directory of an earlier checkout: hold kernel 3 bit for bit against its "
             "ivf_probe.cu on the real batch's list (and the diverse one in int8), and time "
             "both in turns on both lists",
    )
    parser.add_argument(
        "--attn-baseline", type=Path, default=None, metavar="CSRC",
        help="csrc/ directory of an earlier checkout: time its pair_attention.cu "
             "beside kernel 2 on the same inputs, and log their contexts' difference",
    )
    parser.add_argument(
        "--ffn-baseline", type=Path, default=None, metavar="CSRC",
        help="csrc/ directory of an earlier checkout: time its fused_bert.cu's FFN kernel "
             "beside kernel 4 on the same inputs, in turns, and log their outputs' difference",
    )
    parser.add_argument(
        "--resid-baseline", type=Path, default=None, metavar="CSRC",
        help="csrc/ directory of an earlier checkout whose o-proj C entry took no plan: time "
             "its fused_bert.cu's o-proj kernel beside kernel 6 on the same inputs, in turns, "
             "and log their outputs' difference",
    )
    opts = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (REPO / PACKAGE).is_dir():
        print(f"chip_smoke: {PACKAGE}/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np

    smi = phase_card()
    t0 = time.perf_counter()
    phase_build()
    log(f"[build] phase 1 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    attn_baseline = (baseline_lib("pair_attention", opts.attn_baseline)
                     if opts.attn_baseline else None)
    ffn_baseline = (baseline_lib("fused_bert", opts.ffn_baseline)
                    if opts.ffn_baseline else None)
    resid_baseline = (baseline_lib("fused_bert", opts.resid_baseline)
                      if opts.resid_baseline else None)
    kernels = [check_topk(torch, np, smi, opts.topk_baseline),
               check_attention(torch, np, smi, attn_baseline)]
    check_large_k(torch, np, smi)
    check_wide_rows(torch, np, smi)
    log(f"[kernels] phase 2 took {time.perf_counter() - t0:.1f} s")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        t0 = time.perf_counter()
        write_checkpoints(torch, work)
        write_index(torch, np, work)
        log(f"[main] checkpoints and index written in {time.perf_counter() - t0:.1f} s")
        main_run = drive_main_path(torch, np, work, smi)
        from financial_rag_system_tpu_torch.models.embedder import get_embedder
        from financial_rag_system_tpu_torch.models.reranker import get_reranker

        cpu_models = (get_embedder(device="cpu"), get_reranker(device="cpu"))
        check_against_cpu(torch, np, main_run, cpu_models)
        check_attention_gate(torch, np, main_run, smi)
        check_attention_batch_mask(torch, np, main_run, smi, attn_baseline)
        profile_batch(torch, main_run, smi)
        log(f"[main] phase 3 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ivf_run = drive_ivf_path(torch, np, main_run, smi)
        kernels.append(check_ivf_kernel(torch, np, ivf_run, smi, opts.ivf_baseline))
        check_ivf_against_cpu(torch, np, main_run, work, cpu_models)
        log(f"[ivf] phase 4 took {time.perf_counter() - t0:.1f} s")
        del ivf_run["engine"]
        t0 = time.perf_counter()
        with env_set(**FUSED_BLOCK_ENV):
            block_run = drive_main_path(torch, np, work, smi, label="fused-block")
            check_fused_block_batch(torch, np, block_run, cpu_models, smi)
            kernels += check_fused_block_kernels(torch, block_run, smi, ffn_baseline,
                                                 resid_baseline)
        log(f"[fused-block] phase 5 took {time.perf_counter() - t0:.1f} s")
        del block_run["engine"]
        t0 = time.perf_counter()
        int8 = write_int8_index(torch, np, work, main_run)
        with env_set(RAG_TPU_INDEX_DTYPE="int8"):
            int8_run = drive_main_path(torch, np, work, smi, label="int8", index=int8["dir"],
                                       rounds=1)
        check_int8_against_cpu(torch, np, int8_run, int8, work, cpu_models)
        int8_overlap(torch, np, int8_run, int8, smi)
        kernels.append(check_topk_int8(torch, np, smi, opts.topk_baseline))
        del int8_run["engine"], int8["bf16"]
        ivf8_run = drive_ivf_path(torch, np, main_run, smi, label="ivf-int8",
                                  dtype=torch.int8, rounds=1)
        kernels.append(check_ivf_kernel(torch, np, ivf8_run, smi, opts.ivf_baseline))
        del ivf8_run["engine"]
        log(f"[int8] phase 6 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        hash_runs = drive_hash_path(torch, np, work, smi)
        log(f"[hash] phase 7 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        hnsw_run = drive_hnsw_path(torch, np, work, smi)
        check_hnsw_recall(torch, np, hnsw_run, smi)
        check_hnsw_against_cpu(torch, np, hnsw_run, work, cpu_models)
        profile_hnsw_batch(torch, np, hnsw_run, smi)
        hnsw8_run = drive_hnsw_int8(torch, np, hnsw_run, smi)
        del hnsw_run["engine"]
        log(f"[hnsw] phase 8 took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # launches over the main paths, each counted from 0 around its run
    runs = (main_run, ivf_run, block_run, int8_run, ivf8_run, *hash_runs, hnsw_run, hnsw8_run)
    for kern in kernels:
        name = kern["name"]
        kern["launches"] = sum(run["launches"][name] for run in runs)
        if kern["launches"] < 1:
            raise AssertionError(f"{name} never launched on the main paths")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
