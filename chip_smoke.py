"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--topk-baseline OLD_CHECKOUT/financial_rag_system_tpu_torch/csrc]
                          [--ivf-baseline OLD_CHECKOUT/financial_rag_system_tpu_torch/csrc]
                          [--attn-baseline OLD_CHECKOUT/financial_rag_system_tpu_torch/csrc]
                          [--ffn-baseline OLD_CHECKOUT/financial_rag_system_tpu_torch/csrc]
                          [--resid-baseline OLD_CHECKOUT/financial_rag_system_tpu_torch/csrc]
                          [--flash-baseline OLD_CHECKOUT/financial_rag_system_tpu_torch/csrc]
                          [--bwd-baseline OLD_CHECKOUT/financial_rag_system_tpu_torch/csrc]
                          [--phases 2,16]

Drives ``financial_rag_system_tpu_torch`` end to end on the card, in
seventeen phases; any failure raises and the script exits non-zero:

0. the card: name, power limit and compute capability (Hopper, 9.0);
1. build: every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a``
   into ``build/torch_kernels/`` (all sources in parallel);
2. each kernel against its plain PyTorch version at the main path's
   shapes, with its time, the plain version's, a PyTorch library call's
   where one computes the same function, and its bound on the H100;
   kernel 2 at the rerank shape (P 480, S 400) at 12 heads of 32 (its
   persistent kernel), 12 of 64 and 6 of 128 (its ring kernel) on the
   table's mask (uniform lengths) and on a mask with every key valid (and
   after phase 3 on that batch's own rerank mask), each beside the plain
   version, SDPA, its bound (the bytes and products of the keys that mask
   leaves) and its MUFU floor; at 12 heads of 24, 40, 48, 80 and 112,
   which the wrapper pads to 32, 64, 64, 128 and 128; ``nvcc -Xptxas -v``
   of every kernel-2 instantiation (none may spill); kernels 1 and 3
   at k 33, 64, 100, 256, 1024 and 2048 (the select path: each call
   launches it once and nothing else) in bf16 and int8, with times,
   device time by launch, plan and scratch, the ``mm + where + topk``
   yardstick, and bit for bit on tie-heavy exact rows; kernel 1 over
   1,048,580 rows at k 1024 in both types; kernels 1 and 3 at
   D 1536 and k 15 on the wide kernel (rows of more than 1,024 values) in
   bf16, int8 (bit for bit) and on tie-heavy exact bf16 rows (bit for
   bit), with device time by pass, plan, the ``mm + where + topk``
   yardstick and ``nvcc -Xptxas -v`` of its instantiations (none may
   spill); then the wide path: ``FlatIndex(dim=1536)`` of 131,072 rows in
   bf16 and in int8 with an ``IVFIndex`` over each, a batch of 32 through
   each index's ``search_device`` at k 15 and 1024 (the ``kernels``
   line's ``masked_topk_wide`` and ``ivf_probe_wide``, 0 launches on
   every served path), held against the same indexes searched on the CPU;
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
   graph, one burst, and the card's walk bit for bit with the CPU's;
9. the training path: ``python -m financial_rag_system_tpu_torch.train.stack``'s
   entry with evaluate.py's canonical flags (full-width BGE-small
   bi-encoder with filler negatives at weight 0.5, MiniLM-L6
   cross-encoder at 1000-character pairs, 150 steps each, 50 distillation
   steps), each trainer's first and last loss, median step time (CUDA
   events), real tokens/s, peak memory and ``train_mfu``; kernel 2's
   launches 0 inside the graded steps, and in the teacher pass 6 a
   ``cross_score`` call whose pairs pad to 256 tokens or more (evaluate.py's
   unpadded distillation triples pad to 128 or 256); the export served
   by ``build_default_engine(device="cuda")`` over the 65,536-chunk hard
   corpus (56 hard-set questions in bursts of 32 and 24, kernels 1 and 2
   launching), one batch against the CPU, and its Hit@5 beside a
   random-init stack's (reported); one step of each objective at full
   width on the card against the CPU; a checkpoint resume against the
   uninterrupted step and the cross-encoder trained twice, each bit for
   bit; a profile of one step of each tower by kind;
10. the mesh-sharded tier on a mesh of four shards on the one card
   (``[cuda:0] * 4``; their launches run one after another): (a) the
   phase-3 index rewritten as a ``sharded_index.npz`` (4 x 32,768 valid
   rows) behind ``build_default_engine(device="cuda",
   mesh_devices=MESH)``, 3 asks, a burst of 32 and a cache hit (kernel 1
   once a shard and kernel 2 once a shard's rerank chunk a layer), the
   burst's batch against the single-device program over the same rows
   (rows identical, bi within 1e-6, ce within 1e-2) and both profiled;
   (b) the same over phase 6's int8 index (rows and bi bit for bit); (c)
   ``rebuild_index("ivf")`` over phase 4's 1,048,576 rows (4 x 262,144),
   recall@15 against the sharded flat (reported), a burst (kernel 3 once
   a shard), an upsert that grows every shard and a staged ask that finds
   it; (d) ``rebuild_index("hnsw")`` over phase 8's 131,072 rows (four
   native graphs), recall@15, a burst, and the four walks' wall against
   device time; (e) a one-rank NCCL process group serving (a)'s index
   through ``attach_control_plane`` (a ControlServer with no workers and
   a BroadcastIndex): (a)'s rows; (f) shards with no valid rows
   (capacity twice the corpus): the single device's rows and three asks.
   Each part prints its seconds;
11. the data-parallel trainer and the data plane: (a) the contrastive
   step over ``data:4`` of ``[cuda:0] * 4`` (micro-batches of 8) on phase
   9's trained full-width BGE-small tower, 3 steps of 32 triples at 64
   tokens against the one-device step from the same weights (losses
   within 2e-3, step 1's gradient leaves within 1e-2 of their norms, the
   weights after step 3 at JAX's bounds), with both step times (CUDA
   events); (b) ``train(mesh=...)`` with the ``data`` axis over a
   one-rank NCCL group (rank 0 writes a checkpoint after each step, behind
   a barrier), 3 steps bit for bit with ``train()`` without a mesh; (c)
   ``data/ingest.ingest_files`` of 3 seeded filings of a new ticker into a
   new engine over phase 3's checkpoints and index, a re-ingest that adds
   no row, the ticker's cache entry cleared, and 2 asks for the ticker
   whose sources are ingested chunks (kernel 1 once and kernel 2 six
   times an ask); (d) the trace-export pump over (c)'s traces with an
   in-memory sink (only complete traces ship; their OTLP and MLflow
   encodings); (e) ``utils/timing`` ``fetched_ms`` and
   ``sustained_ms(depth=4)`` of the phase-3 fused batch of 32, reported.
   Each part prints its seconds;
12. the flash path (``RAG_TPU_FLASH``): (a) kernel 7 against its plain
   version on every row (atol 1e-2) at P 480, S 512, 12 heads of 32 on
   phase 3's rerank mask padded to 512 (the ``kernels`` line's figures),
   3 heads of 256 on that mask (the D-256 kernel, ``d256::flash256_kernel``:
   the line's ``flash_attention_wide``), and 12 heads of 32 on the
   uniform-length mask (its last pair all padding), at S 128 and
   256, and at heads of 64 (12) and 128 (6) at S 512, each with its
   CUDA-event and device times, the plain version's, SDPA's with the
   boolean segment-equality mask (a yardstick) and its bound and MUFU
   floor, and the share of (pair, 64-row tile, 128-key block) pairs that
   the skip rule leaves out on that mask (no common segment id; worked
   out from the mask on the host); ``nvcc -Xptxas -v``'s registers and
   spills of each of its kernels (none may spill); (b) the flat tier
   through ``build_default_engine(device="cuda")``
   under ``RAG_TPU_FLASH=1 RAG_TPU_PAIR_ATTN=0`` (3 asks, a burst of 32, a
   cache hit; kernel 7 six times a batch, kernel 2 never), its batch of 32
   against phase 3's default batch (rows and bi scores identical, logits
   within 5e-2) and against the port on the CPU under the same variables,
   profiled beside the default batch; (c) ``RAG_TPU_FLASH=1`` alone: the
   pairs pad to 512 and kernel 2 takes them (6 launches at S 512, kernel 7
   none), its logits against (b)'s; (d) a graded cross-encoder step under
   both variables: kernel 7 and its backward (kernels 8 and 9) six times
   each, the loss and gradients within phase 9's tolerances of those
   without them; (e) the staged reranker at the 128 bucket under
   ``RAG_TPU_FLASH=1``: kernel 7 six times.  Each part prints its seconds;
13. a BERT-base-shaped reranker: a random-init cross-encoder of
   google-bert/bert-base-uncased's shape (hidden 768, 12 layers, 12 heads
   of 64, intermediate 3072) with a pooler and one logit, behind
   ``build_default_engine(device="cuda")`` with phase 3's BGE-small and
   index: 3 single asks, a burst of 32 and a cache hit, kernel 2's ring
   kernel 12 times a batch and its persistent kernel never; the batch of
   32 against the same batch under ``RAG_TPU_PAIR_ATTN=0`` (rows and bi
   scores identical, logits within 5e-2); its wall and device time and the
   ring kernel's share of it (profiler);
14. BERT-base widths in 3 heads of 256 (a shape no published checkpoint
   has, the one width of the D-256 kernel): a random-init cross-encoder
   (hidden 768, 12 layers, 3 heads of 256, intermediate 3072, a pooler and
   one logit) behind ``build_default_engine(device="cuda")`` with phase
   3's BGE-small and index under ``RAG_TPU_FLASH=1``: the pairs pad from
   400 to 512, 3 single asks, a burst of 32 and a cache hit, kernel 7's
   D-256 kernel 12 times a batch and kernel 2 never; the batch of 32
   against the same batch without the variable (the einsum attention:
   rows and bi scores identical, logits within 5e-2); its wall and device
   time and the D-256 kernel's share of it (profiler);
15. pairs above 512 tokens: a 32,768-chunk index of synthetic filings
   chunked at about 2,500 characters (documents of 480-960 wordpieces, a
   960-wide token store) and a random-init cross-encoder of MiniLM-L6's
   widths with 1,024 positions, trained length 1,024, behind
   ``build_default_engine(device="cuda")`` with phase 3's BGE-small: (a)
   the default gate, pairs of 992 tokens, kernel 2's long branch (the
   long-pair kernel, heads of 32 above S 512, ``pair_attention_long``) 6
   times a batch, its time beside the parent's in turns with
   ``--attn-baseline``; (b)
   ``RAG_TPU_FLASH=1 RAG_TPU_PAIR_ATTN=0``, pairs padded to 1,024, kernel
   7's long-row kernel (``flash_attention_long``, heads of 32 above S 512)
   6 times a batch; (c) a cross-encoder of BERT-base widths in 2 heads
   of 384 (4 layers, 1,024 positions) under ``RAG_TPU_FLASH=1``, kernel
   7's slab kernel (``flash_attention_slab``) 4 times a batch; each with 3
   asks, a burst of 32 and a cache hit, an 8-query batch against the
   einsum batch (rows and bi scores identical, logits within 5e-2), the
   (S, d) the kernel saw and a profile; the ``kernels`` line's figures of
   the three branches at the served shapes (the plain version in chunks
   of pairs; with ``--flash-baseline`` kernel 7's two beside the parent's
   build in turns), and the L2 -> shared bytes kernel 7's two stage there
   as their plans reckon them; then kernel 2 at heads of 32, 64 and 128 at S 513,
   640, 1,024, 2,048 and 4,096, kernel 7 at heads of 32-256 at S 640,
   1,024 and 2,048 and at heads of 384 and 512 at S 128, 512 and 1,024,
   on phase 3's rerank mask stretched to S and on the uniform-length
   mask, each against its plain version (1e-2), some timed beside SDPA,
   the bound and the MUFU floor; with ``--flash-baseline`` kernel 7 at S
   1,024 and 2,048 (heads of 32, 64, 128, 256, 384, 512 and 640) beside
   the parent's build in turns, bit for bit at the widths this build did
   not redesign (64-256);
16. the flash attention's backward (kernels 8 and 9,
   ``csrc/flash_attention_bwd.cu``) and the cross-encoder trainer on the
   flash path: (a) kernel 7's residuals (m, l) and kernels 8 and 9
   against their plain twins (each gradient within 2^-7 of its largest
   magnitude) at S 128, 256, 512 and 1,024, heads of 32, 64, 128, 256 and
   384, on prefix, rerank-layout and holed masks with an all-padding
   pair; the served context with residuals asked for, bit for bit the
   one without; ``ptxas -v`` of the source (no spill; four
   ``walk_kernel`` and six ``wide_kernel`` instantiations); both kernels
   at the trainer's shape (B 32, S 512, 12 heads of 32, its first batch's
   mask) and at H D 768 in heads of 128, 256 and 384 on the same mask,
   with CUDA-event and device times, the plain twins', SDPA's backward
   with the boolean segment mask, the bound and the MUFU floor (the
   ``kernels`` line's ``flash_attention_bwd_dkv`` and
   ``flash_attention_bwd_dq`` at heads of 32, ``flash_attention_bwd_wide_dkv``
   and ``flash_attention_bwd_wide_dq`` at 256), and the L2 -> shared bytes
   each stages beside the first design's (``bwd_plan``,
   ``wide_bwd_plan``, ``parent_bwd_staged``, computed); (b)
   ``train_cross_encoder`` at MiniLM-L6's full width from ``init_model``'s
   weights under ``RAG_TPU_FLASH=1``, 6 steps of 32 x 512: kernels 7, 8
   and 9 six times a step and nothing else; its first step against the
   einsum step (phase 9's tolerances); a second run bit for bit; median
   step time and peak memory beside the einsum run's; both steps' device
   time by kind; (c) the same at phase 14's widths (BERT-base, 12 layers,
   3 heads of 256), 3 steps: kernel 7's D-256 kernel and the wide backward
   kernels twelve times a step, kernel 2 never.

``--phases LIST`` runs only the phases named (``2,16``; phase 16's parts
apart: ``16a,16c``) with the phases they need (phase 1 always; phase 3
for 4-6, 8, 10-12, 15 and 16 (a); 6 for 10; 9 for 11); the ``kernels``
line then lists and checks only the selected phases' kernels (phase 16's
entries with the part that launches them: (b) heads of 32, (c) 256).
With no flags every phase runs.

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
device times, at k 15, at every k of phase 2's large-k checks (the
earlier build with the scratch its own ``ops/topk.py`` plan asks for)
and at D 1536 (bit for bit in int8 and on exact rows); ``--ivf-baseline``
does the same for an earlier ``ivf_probe.cu`` and kernel 3 on both lists
(bit for bit on the real list, and on the diverse one in int8), at phase
2's large k and at D 1536; ``--attn-baseline``
builds an earlier ``pair_attention.cu`` (one with the streaming
``pair_attention_wide`` entry) and times it beside
kernel 2 on the same inputs and masks, in turns, with their contexts'
difference: its ``pair_attention`` at heads of 32, its streaming
``pair_attention_wide`` at 64 and 128, both builds launched by their C
entries alone;
phase 15 with ``--attn-baseline`` also holds kernel 2's contexts at S
400 and 512 bit for bit against the earlier build's, every width, and
above S 512 at heads of 64 and 128 (the parent's build: those kernels
are unchanged), and times heads of 32 at S 992 (phase 15 (a)'s served
mask) and 1,024-4,096 beside it in turns, logging their contexts'
difference (the long-pair kernel's sums take another order; each is held
to the plain version at 1e-2 + rtol 1e-2), and with
``--flash-baseline`` kernel 7's at S 128-512;
``--ffn-baseline`` builds an earlier ``fused_bert.cu`` and times its FFN
kernel beside kernel 4 at both shapes the same way; ``--resid-baseline``
the same for its o-proj kernel beside kernel 6 (a checkout whose C entry
took no plan); ``--flash-baseline`` builds an earlier ``flash_attention.cu``
and times it beside kernel 7 at each shape of phase 12 (a) in turns, with
both device times and their contexts' difference (at 3 heads of 256 the
earlier checkout's own D-256 kernel, whatever its design);
``--bwd-baseline`` builds an earlier ``flash_attention_bwd.cu`` and, in
phase 16 (a) at the trainer's shape and at each of its wide widths, holds
both C entries' gradients to this build's within 2^-7 of their largest
magnitude and times each entry beside this build's in turns (parent, new,
new, parent), CUDA events and device time.

The last lines are the ``kernels`` JSON line, the card's name and power
limit as ``nvidia-smi`` gives them, and ``{"ok": true, "device": ...}``.
Nothing is fetched; weights and data come from fixed seeds.
"""

from __future__ import annotations

import argparse
import asyncio
import atexit
import collections
import contextlib
import functools
import json
import math
import os
import re
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


@functools.cache
def parent_plan(csrc: Path, module: str):
    """An earlier checkout's plan function, ``topk_plan`` of its
    ``ops/topk.py`` or ``probe_plan`` of its ``index/ivf.py`` (which then
    imports that ``ops/topk.py``), loaded from beside its ``csrc/``; their
    other imports resolve to this checkout's package."""
    import importlib.util

    def load(name: str, path: Path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    topk = load("parent_topk", csrc.parent / "ops" / "topk.py")
    if module == "topk":
        return topk.topk_plan
    key = f"{PACKAGE}.ops.topk"
    current = sys.modules[key]
    sys.modules[key] = topk
    try:
        return load("parent_ivf", csrc.parent / "index" / "ivf.py").probe_plan
    finally:
        sys.modules[key] = current


def topk_entry_fn(torch, lib, args, plan_fn=None):
    """A launch of kernel 1 by the C entry alone of a build of
    ``masked_topk.cu`` whose C entry takes the plan (blocks, stages, one
    scratch; an earlier checkout's, or this one's), on the wrapper's
    arguments, sized by ``plan_fn`` (an earlier checkout's ``topk_plan``;
    this one's by default); returns (scores, ids)."""
    import ctypes

    from financial_rag_system_tpu_torch.ops import _cuda
    from financial_rag_system_tpu_torch.ops.topk import topk_plan

    q, c, codes, qf, n_valid, k = args
    (b, d), n = q.shape, c.shape[0]
    plan = (plan_fn or topk_plan)(b, n, d, c.element_size(), k, sms(torch))
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


def probe_entry_fn(torch, lib, args, tile: int, plan_fn=None):
    """A launch of kernel 3 by the C entry alone of a build of
    ``ivf_probe.cu`` whose C entry takes the plan, sized by ``plan_fn``
    (an earlier checkout's ``probe_plan``; this one's by default); returns
    (scores, ids)."""
    import ctypes

    from financial_rag_system_tpu_torch.index.ivf import probe_plan
    from financial_rag_system_tpu_torch.ops import _cuda

    q, qf, emb, codes, gids, tl, k = args
    (b, d), n_packed, n_probe = q.shape, emb.shape[0], tl.numel()
    plan = (plan_fn or probe_plan)(b, n_probe, tile, d, emb.element_size(), k, sms(torch))
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


def against_parent(torch, tag: str, smi: str, parent, new, exact: bool = True,
                   new_entry=None) -> None:
    """The parent's kernel against the new one (its wrapper, ``new``) on the
    same inputs: bit for bit (scores and ids) where ``exact``, then both
    timed in turns (parent, new, new, parent), CUDA events and device time
    (profiler); ``new_entry``, where given, is the new build's C entry
    alone, launched as the parent's is, and takes the wrapper's turns."""
    got = [x.cpu().numpy().tobytes() for x in new()]
    want = [x.cpu().numpy().tobytes() for x in parent()]
    same = got == want
    if exact and not same:
        raise AssertionError(f"{tag}: differs from the parent's kernel")
    new = new_entry or new
    order = (parent, new, new, parent)
    events = [median_ms(fn, reps=30) for fn in order]
    device = [sum(device_split(torch, fn).values()) for fn in order]
    log(f"{tag} {smi}: bit for bit with the parent's kernel: {same}; in turns (parent, new, "
        f"new, parent{'; C entries alone' if new_entry else ''}): events "
        f"{', '.join(f'{t:.4f}' for t in events)} ms; device "
        f"{', '.join(f'{t:.4f}' for t in device)} ms")


def topk_library():
    """This build's ``masked_topk`` library, its entries' types set."""
    from financial_rag_system_tpu_torch.ops.topk import _library

    return _library()


def probe_library():
    """This build's ``ivf_probe`` library, its entries' types set."""
    from financial_rag_system_tpu_torch.index.ivf import _library

    return _library()


def plan_line(tag: str, plan, pieces: float | None = None) -> None:
    """A kernel-1 or kernel-3 launch plan: blocks, stages, work a block and
    the merge's candidates, or the select path's table and scratch."""
    work = (f"{plan.tiles / plan.blocks:.1f} tiles a block" if pieces is None
            else f"{pieces / plan.blocks:.1f} live-candidate pieces a block")
    tail = (f"at most {plan.candidates} merge candidates a query" if plan.path == "lists" else
            f"select path: {plan.cols} table columns and {plan.sweeps} sweeping blocks a query, "
            f"{plan.runs} sort run(s), scratch {4 * plan.scratch} B")
    log(f"{tag} plan: {plan.blocks} blocks x {plan.qblocks} query blocks, {plan.stages} "
        f"stages, {plan.smem} B of shared memory, {work}, {tail}")


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
                       topk_entry_fn(torch, baseline_lib("masked_topk", baseline), args),
                       lambda: masked_topk(*args),
                       new_entry=topk_entry_fn(torch, topk_library(), args))
    return {
        "name": "masked_topk", "route": "cuda",
        "source": f"{PACKAGE}/csrc/masked_topk.cu",
        "replaces": "financial_rag_system_tpu/ops/topk.py:99",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


LARGE_K = (33, 64, 100, 256, 1024, 2048)
WIDE_D = 1536  # rows of more than WIDE_ABOVE_D values: the wide kernel
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


def yardstick_fn(torch, q, rows, mask, k: int):
    """One library sequence over the rows a kernel scores: ``torch.mm``
    (bf16 into f32; int8: ``torch._int_mm`` into s32 over the rows padded
    with masked zero rows to a multiple of 8, then a cast) +
    ``torch.where`` of the mask + ``torch.topk(sorted=True)``.  Timed as a
    yardstick only; the port never calls it."""
    neg = torch.tensor(float("-inf"), device=q.device)
    if rows.dtype == torch.int8:
        if rows.shape[0] % 8:  # _int_mm takes widths in multiples of 8: masked zero rows
            pad = -rows.shape[0] % 8
            rows = torch.cat([rows, rows.new_zeros((pad, rows.shape[1]))])
            mask = torch.cat([mask, mask.new_zeros((mask.shape[0], pad))], dim=1)
        scores = lambda: torch._int_mm(q, rows.T).float()  # noqa: E731
    else:
        scores = lambda: torch.mm(q, rows.T, out_dtype=torch.float32)  # noqa: E731
    return lambda: torch.topk(torch.where(mask, scores(), neg), k, dim=1, sorted=True)


def select_call(torch, wrapper: str, fn):
    """``fn()`` (a call of kernel 1's or 3's wrapper above k 32), which must
    launch the select path once and nothing else."""
    before = read_launches()
    out = fn()
    after = read_launches()
    launched = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    if launched != {f"{wrapper}_select": 1}:
        raise AssertionError(f"{wrapper} above k 32 launched {launched}")
    return out


def large_k_case(torch, np, smi: str, what: str, wrapper: str, fn, plain, yard, nbytes: float,
                 ops: float, peak: float, plan, parent=None, entry=None) -> None:
    """One kernel-1 or kernel-3 call above k 32 against its plain version
    (int8 bit for bit; bf16 within 1e-4 with ids where clear), then its
    time (events, device time by launch, host time), the plain version's,
    the yardstick's, its bound, plan and scratch, and the parent's build
    in turns with this build's C entry alone (``entry``; bit for bit: both
    score alike)."""
    s, i = (x.cpu().numpy() for x in select_call(torch, wrapper, fn))
    torch.cuda.synchronize()
    s_ref, i_ref = (x.cpu().numpy() for x in plain())
    if "int8" in what:
        if s.tobytes() != s_ref.tobytes() or i.tobytes() != i_ref.tobytes():
            raise AssertionError(f"{what}: not bit for bit with the plain version")
        err, n_diff = 0.0, 0
    else:
        err, n_diff = clear_ids_agree(np, s, i, s_ref, i_ref, what)
    ms = median_ms(fn, reps=10)
    plain_ms = median_ms(plain, reps=3)
    try:
        yard_ms = median_ms(yard, reps=10)
    except RuntimeError as exc:  # a cuBLAS that takes no int8 product at this shape
        log(f"{what}: the yardstick did not run ({exc})")
        yard_ms = float("nan")
    b_ms, b_by = bound_ms(nbytes, ops, peak)
    log(f"{what} {smi}: B={B} D={D}: max_abs_err {err:.3g}, finite ids differing {n_diff} of "
        f"{int(np.isfinite(s_ref).sum())}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"mm + where + topk {yard_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    retrieval_timing(torch, what, fn, ms, smi)
    plan_line(what, plan)
    if parent is not None:
        against_parent(torch, what, smi, parent, fn, new_entry=entry)


def check_large_k(torch, np, smi: str, topk_baseline: Path | None = None,
                  ivf_baseline: Path | None = None) -> None:
    """Kernels 1 and 3 at k above the lists' 32 (LARGE_K, the select path),
    against their plain versions: kernel 1 over phase 2's corpus, kernel 3
    over a packing of PROBE_TILES tiles with PROBE_ACTIVE probed; random
    unit rows in bf16 (scores within 1e-4, ids where clear of that noise)
    and int8 (bit for bit), each with large_k_case's times, and the
    parent's rounds in turns where a baseline is given; tie-heavy exact
    rows in bf16, bit for bit; kernel 1 over 1,048,580 rows at k 1024.
    Off the main paths, which take k 15 (their select counters stay 0)."""
    from financial_rag_system_tpu_torch.index.flat import quantize_int8
    from financial_rag_system_tpu_torch.index.ivf import ivf_probe, ivf_probe_plain, probe_plan
    from financial_rag_system_tpu_torch.ops.topk import (
        _match_mask,
        masked_topk,
        masked_topk_plain,
        topk_plan,
    )

    n_valid = N - 100
    q, c, codes, qf = topk_inputs(torch, np.random.default_rng(SEED), n_valid)
    normalize = torch.nn.functional.normalize
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    unit = lambda n: normalize(torch.randn(n, D, generator=g, device="cuda"), dim=1)  # noqa: E731
    emb = unit(PROBE_TILES * 128)
    _, pcodes, gids, tile_ids = probe_packing(torch, np, lambda n: None)
    probed = (tile_ids[:PROBE_ACTIVE].long()[:, None] * 128
              + torch.arange(128, device="cuda")).reshape(-1)
    live = int((gids[0][probed] >= 0).sum())
    flat_mask = _match_mask(codes, qf) & (torch.arange(N, device="cuda") < n_valid)
    probe_mask = _match_mask(pcodes[:, probed], qf) & (gids[0][probed] >= 0)
    cases = {
        "bf16": (q, c, q, emb.bfloat16()),
        "int8": (quantize_int8(q), quantize_int8(c), quantize_int8(q), quantize_int8(emb)),
    }
    libs = {name: baseline_lib(name, csrc) if csrc else None
            for name, csrc in (("masked_topk", topk_baseline), ("ivf_probe", ivf_baseline))}
    for k in LARGE_K:
        for dtype, (q1, c1, q3, e3) in cases.items():
            elt = c1.element_size()
            peak = INT8_OP_PER_S if elt == 1 else BF16_FLOP_PER_S
            flat = (q1, c1, codes, qf, n_valid, k)
            probe = (q3, qf, e3, pcodes, gids, tile_ids, k)
            large_k_case(
                torch, np, smi, f"[large-k] kernel 1 {dtype} k={k}", "masked_topk",
                lambda: masked_topk(*flat), lambda: masked_topk_plain(*flat),
                yardstick_fn(torch, q1, c1, flat_mask, k),
                N * (D * elt + 8) + B * (D * elt + 8) + B * k * 8, 2.0 * B * N * D, peak,
                topk_plan(B, N, D, elt, k, sms(torch)),
                libs["masked_topk"] and topk_entry_fn(
                    torch, libs["masked_topk"], flat, parent_plan(topk_baseline, "topk")),
                libs["masked_topk"] and topk_entry_fn(torch, topk_library(), flat))
            large_k_case(
                torch, np, smi, f"[large-k] kernel 3 {dtype} k={k}", "ivf_probe",
                lambda: ivf_probe(*probe, tile=128), lambda: ivf_probe_plain(*probe, tile=128),
                yardstick_fn(torch, q3, e3[probed], probe_mask, k),
                PROBE_ACTIVE * 128 * 4 + live * (D * elt + 8) + B * (D * elt + 8) + B * k * 8,
                2.0 * B * live * D, peak,
                probe_plan(B, tile_ids.numel(), 128, D, elt, k, sms(torch)),
                libs["ivf_probe"] and probe_entry_fn(
                    torch, libs["ivf_probe"], probe, 128, parent_plan(ivf_baseline, "ivf")),
                libs["ivf_probe"] and probe_entry_fn(torch, probe_library(), probe, 128))
        # tie-heavy exact rows: bit for bit in bf16 too
        xq = exact_rows(torch, B, 3, SEED + k, torch.bfloat16)
        xc = exact_rows(torch, N, 6, SEED + k + 1, torch.bfloat16)
        xe = exact_rows(torch, PROBE_TILES * 128, 6, SEED + k + 2, torch.bfloat16)
        for name, wrapper, fn, plain in (
            ("kernel 1", "masked_topk", lambda: masked_topk(xq, xc, codes, qf, n_valid, k),
             lambda: masked_topk_plain(xq, xc, codes, qf, n_valid, k)),
            ("kernel 3", "ivf_probe",
             lambda: ivf_probe(xq, qf, xe, pcodes, gids, tile_ids, k, tile=128),
             lambda: ivf_probe_plain(xq, qf, xe, pcodes, gids, tile_ids, k, tile=128)),
        ):
            got = [x.cpu().numpy().tobytes() for x in select_call(torch, wrapper, fn)]
            if got != [x.cpu().numpy().tobytes() for x in plain()]:
                raise AssertionError(f"[large-k] {name} bf16 exact rows k={k}: not bit for bit")
    del cases, emb
    # kernel 1 over the IVF corpus's flat size
    big_n, k = 1_048_580, 1024
    big = unit(big_n)
    big_codes = torch.stack([torch.randint(0, N_TICKERS, (big_n,), generator=g, device="cuda"),
                             torch.randint(0, len(DOC_TYPES), (big_n,), generator=g,
                                           device="cuda")]).int()
    big_mask = _match_mask(big_codes, qf)
    for dtype, (qb, rows) in (("bf16", (q, big.bfloat16())),
                              ("int8", (quantize_int8(q), quantize_int8(big)))):
        elt = rows.element_size()
        args = (qb, rows, big_codes, qf, big_n, k)
        large_k_case(
            torch, np, smi, f"[large-k] kernel 1 {dtype} N={big_n} k={k}", "masked_topk",
            lambda: masked_topk(*args), lambda: masked_topk_plain(*args),
            yardstick_fn(torch, qb, rows, big_mask, k),
            big_n * (D * elt + 8) + B * (D * elt + 8) + B * k * 8, 2.0 * B * big_n * D,
            INT8_OP_PER_S if elt == 1 else BF16_FLOP_PER_S,
            topk_plan(B, big_n, D, elt, k, sms(torch)),
            libs["masked_topk"] and topk_entry_fn(
                torch, libs["masked_topk"], args, parent_plan(topk_baseline, "topk")),
            libs["masked_topk"] and topk_entry_fn(torch, topk_library(), args))
        del rows
    log(f"[large-k] {smi}: kernels 1 and 3 at k {list(LARGE_K)} agree with their plain "
        f"versions (bf16 tie-heavy rows bit for bit, int8 bit for bit), each call on the "
        f"select path")


def wide_ptxas(torch) -> None:
    """``nvcc -Xptxas -v`` of both retrieval sources: each holds its four
    wide-kernel instantiations (bf16 and int8, lists and select path), and
    none of them spills."""
    for name in ("masked_topk", "ivf_probe"):
        report = ptxas_report(name)
        wide = {k: v for k, v in report.items() if re.search(r"Lb[01]ELb1EE", k)}
        log(f"[wide-d] ptxas -v of csrc/{name}.cu's wide kernel (registers, spill store and "
            f"load bytes): {wide}")
        if len(wide) != 4 or any(r[1] or r[2] for r in wide.values()):
            raise AssertionError(f"[wide-d] {name}: a wide instantiation spills, or ptxas named "
                                 f"other kernels: {report}")


def check_wide_rows(torch, np, smi: str, topk_baseline: Path | None = None,
                    ivf_baseline: Path | None = None) -> list:
    """Kernels 1 and 3 at D = WIDE_D, k 15, on the wide kernel (rows of
    more than WIDE_ABOVE_D values: one block an SM, a scoring warpgroup on
    ``wgmma`` and sixteen selecting warps), against their plain versions:
    random unit rows in bf16 (scores within 1e-4, ids where clear of that
    noise, and the count that differ) and int8 (bit for bit: exact sums
    cast once, rounding above D 1040), and tie-heavy exact rows in bf16,
    every id and score bit for bit; with the kernels' times (events,
    device time by pass, host time), plan, the plain versions', the ``mm +
    where + topk`` yardstick and the bounds; with ``--topk-baseline`` /
    ``--ivf-baseline`` the parent's C entries in turns (bit for bit in
    int8 and on exact rows); ``ptxas -v`` of the wide instantiations (a
    spill fails the run).  Off the served paths, which take D 384.
    Returns the ``kernels`` line's ``masked_topk_wide`` and
    ``ivf_probe_wide`` entries (random bf16 rows)."""
    from financial_rag_system_tpu_torch.index.flat import quantize_int8
    from financial_rag_system_tpu_torch.index.ivf import ivf_probe, ivf_probe_plain, probe_plan
    from financial_rag_system_tpu_torch.ops.topk import (
        _match_mask,
        masked_topk,
        masked_topk_plain,
        topk_plan,
    )

    d, n_valid = WIDE_D, N - 100
    _, _, codes, qf = topk_inputs(torch, np.random.default_rng(SEED), n_valid)
    _, pcodes, gids, tile_ids = probe_packing(torch, np, lambda n: None)
    probed = (tile_ids[:PROBE_ACTIVE].long()[:, None] * 128
              + torch.arange(128, device="cuda")).reshape(-1)
    live = int((gids[0][probed] >= 0).sum())
    flat_mask = _match_mask(codes, qf) & (torch.arange(N, device="cuda") < n_valid)
    probe_mask = _match_mask(pcodes[:, probed], qf) & (gids[0][probed] >= 0)
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
    del q, c, emb
    libs = {name: baseline_lib(name, csrc) if csrc else None
            for name, csrc in (("masked_topk", topk_baseline), ("ivf_probe", ivf_baseline))}
    entries = []
    for dtype, (qd, cd, ed) in cases.items():
        elt = cd.element_size()
        peak = INT8_OP_PER_S if elt == 1 else BF16_FLOP_PER_S
        flat = (qd, cd, codes, qf, n_valid, K)
        probe = (qd, qf, ed, pcodes, gids, tile_ids, K)
        timed = dtype != "bf16 exact"  # exact rows are held bit for bit, not timed
        if timed:  # a read rate the card reaches: one torch.sum over the rows
            read_ms = median_ms(lambda: cd.sum(dtype=torch.float32), reps=10)
            log(f"[wide-d] {dtype} {smi}: torch.sum over kernel 1's {N} rows "
                f"({cd.numel() * elt / 1e6:.1f} MB) {read_ms:.4f} ms, "
                f"{cd.numel() * elt / read_ms / 1e9:.3f} TB/s")
        for name, fn, plain, yard, nbytes, ops, plan, parent, entry in (
            ("kernel 1", lambda: masked_topk(*flat), lambda: masked_topk_plain(*flat),
             timed and yardstick_fn(torch, qd, cd, flat_mask, K),
             N * (d * elt + 8) + B * (d * elt + 8) + B * K * 8, 2.0 * B * N * d,
             topk_plan(B, N, d, elt, K, sms(torch)),
             libs["masked_topk"] and topk_entry_fn(
                 torch, libs["masked_topk"], flat, parent_plan(topk_baseline, "topk")),
             libs["masked_topk"] and topk_entry_fn(torch, topk_library(), flat)),
            ("kernel 3", lambda: ivf_probe(*probe, tile=128),
             lambda: ivf_probe_plain(*probe, tile=128),
             timed and yardstick_fn(torch, qd, ed[probed], probe_mask, K),
             PROBE_ACTIVE * 128 * 4 + live * (d * elt + 8) + B * (d * elt + 8) + B * K * 8,
             2.0 * B * live * d, probe_plan(B, tile_ids.numel(), 128, d, elt, K, sms(torch)),
             libs["ivf_probe"] and probe_entry_fn(
                 torch, libs["ivf_probe"], probe, 128, parent_plan(ivf_baseline, "ivf")),
             libs["ivf_probe"] and probe_entry_fn(torch, probe_library(), probe, 128)),
        ):
            what = f"[wide-d] {name} {dtype} D={d} k={K}"
            if not plan.wide:
                raise AssertionError(f"{what}: the plan is not the wide kernel's: {plan}")
            s, i = (x.cpu().numpy() for x in fn())
            torch.cuda.synchronize()
            s_ref, i_ref = (x.cpu().numpy() for x in plain())
            if dtype != "bf16":
                if s.tobytes() != s_ref.tobytes() or i.tobytes() != i_ref.tobytes():
                    raise AssertionError(f"{what}: not bit for bit with the plain version")
                err, n_diff = 0.0, 0
            else:
                err, n_diff = clear_ids_agree(np, s, i, s_ref, i_ref, what)
            if not timed:
                log(f"{what} {smi}: bit for bit with the plain version")
            else:
                ms = median_ms(fn, reps=20)
                plain_ms = median_ms(plain, reps=3)
                yard_ms = median_ms(yard, reps=10)
                b_ms, b_by = bound_ms(nbytes, ops, peak)
                log(f"{what} {smi}: B={B}: max_abs_err {err:.3g}, finite ids differing "
                    f"{n_diff} of {int(np.isfinite(s_ref).sum())}, kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, mm + where + topk {yard_ms:.4f} ms, bound {b_ms:.4f} ms "
                    f"({b_by})")
                dev = retrieval_timing(torch, what, fn, ms, smi)
                log(f"{what}: {b_ms / dev:.3f} of the bound by device time")
                plan_line(what, plan)
            if parent is not None:
                against_parent(torch, what, smi, parent, fn, exact=dtype != "bf16",
                               new_entry=entry)
            if dtype == "bf16":
                entries.append({
                    "name": "masked_topk_wide" if name == "kernel 1" else "ivf_probe_wide",
                    "route": "cuda",
                    "source": f"{PACKAGE}/csrc/"
                              f"{'masked_topk' if name == 'kernel 1' else 'ivf_probe'}.cu",
                    "replaces": ("financial_rag_system_tpu/ops/topk.py:99" if name == "kernel 1"
                                 else "financial_rag_system_tpu/index/ivf.py:99"),
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                })
    wide_ptxas(torch)
    return entries


WIDE_N = 131_072  # the wide path's corpus: phase 3's rows, D WIDE_D


def drive_wide_path(torch, np, work: Path, smi: str) -> dict:
    """Phase 2's wide path: ``FlatIndex(dim=WIDE_D, capacity=WIDE_N)`` in
    bf16 and in int8, WIDE_N unit rows made from SEED upserted through
    ``FlatIndex.upsert`` (N_TICKERS tickers x 3 document types), and an
    ``IVFIndex`` built over each on the card; a batch of 32 queries (eight
    unfiltered, the rest by ticker, some also by document type; query 1 a
    copy of row 70,000) through each index's ``search_device`` at k 15
    and at k 1024, each call one launch of the wide kernel
    (``masked_topk_wide``, ``ivf_probe_wide``) and nothing else of the
    kernels; each index saved and loaded on the CPU, where the same calls
    (the plain versions) hold the card's: int8 bit for bit, bf16 within
    1e-4 with ids where clear of that noise.  Returns the run (its
    launches, counted from 0)."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.index.ivf import IVFIndex

    rng = np.random.default_rng(SEED + 30)
    vecs = rng.standard_normal((WIDE_N, WIDE_D), dtype=np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    tick = rng.integers(0, N_TICKERS, WIDE_N)
    dtyp = rng.integers(0, len(DOC_TYPES), WIDE_N)
    payloads = [{"ticker": f"T{a:02d}", "document_type": DOC_TYPES[b]}
                for a, b in zip(tick, dtyp)]
    qv = rng.standard_normal((B, WIDE_D), dtype=np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    qv[1] = vecs[70_000]
    filters = [(None, None)] * 8 + [
        (f"T{rng.integers(0, N_TICKERS):02d}", DOC_TYPES[j % 3] if j % 2 else None)
        for j in range(B - 8)]
    reset_launches()
    t0 = time.perf_counter()
    for dtype in (torch.bfloat16, torch.int8):
        label = "bf16" if dtype == torch.bfloat16 else "int8"
        t1 = time.perf_counter()
        flat = FlatIndex(WIDE_D, capacity=WIDE_N, dtype=dtype, device="cuda")
        for s in range(0, WIDE_N, 16_384):
            e = min(WIDE_N, s + 16_384)
            flat.upsert([f"wide-{r}" for r in range(s, e)], vecs[s:e], [""] * (e - s),
                        payloads[s:e])
        ivf = IVFIndex(flat, tile=128)
        torch.cuda.synchronize()
        log(f"[wide-path] {label}: FlatIndex(dim={WIDE_D}) of {flat.n_valid} rows and an "
            f"IVFIndex ({ivf.n_clusters} clusters, nprobe {ivf.nprobe}, "
            f"{ivf.tiles_per_cluster} tiles a cluster) in {time.perf_counter() - t1:.1f} s")
        qf = torch.tensor([flat.store.query_codes(tk, dt) for tk, dt in filters],
                          dtype=torch.int32, device="cuda")
        q = torch.tensor(qv, device="cuda")
        got = {}
        for tier, index in (("flat", flat), ("ivf", ivf)):
            for k in (K, 1024):
                t1 = time.perf_counter()
                s, i = index.search_device(q, qf, k)
                got[tier, k] = (s.cpu().numpy(), i.cpu().numpy())
                log(f"[wide-path] {smi}: {label} {tier} search_device, B={B}, k={k}: "
                    f"{(time.perf_counter() - t1) * 1e3:.2f} ms wall")
        directory = str(work / f"wide_{label}")
        ivf.save(directory)
        del flat, ivf
        torch.cuda.empty_cache()
        cpu = IVFIndex.load(directory, FlatIndex.load(directory, device="cpu"))
        shutil.rmtree(directory, ignore_errors=True)
        for tier, index in (("flat", cpu.flat), ("ivf", cpu)):
            for k in (K, 1024):
                s_ref, i_ref = (x.numpy() for x in index.search_device(q.cpu(), qf.cpu(), k))
                s, i = got[tier, k]
                what = f"[wide-path] {label} {tier} k={k}: card against the CPU"
                if i[1, 0] != 70_000:
                    raise AssertionError(f"{what}: query 1 does not find its own row first")
                if dtype == torch.int8:
                    if s.tobytes() != s_ref.tobytes() or i.tobytes() != i_ref.tobytes():
                        raise AssertionError(f"{what}: not bit for bit")
                    log(f"{what}: bit for bit ({int(np.isfinite(s).sum())} finite entries)")
                else:
                    err, n_diff = clear_ids_agree(np, s, i, s_ref, i_ref, what)
                    log(f"{what}: max_abs_err {err:.3g}, finite ids differing {n_diff} of "
                        f"{int(np.isfinite(s_ref).sum())}")
        del cpu
    run = {"label": "wide-path", "launches": read_launches()}
    want = want_launches(masked_topk_wide=4, ivf_probe_wide=4)
    if run["launches"] != want:
        raise AssertionError(f"[wide-path] launches {run['launches']} != {want}")
    log(f"[wide-path] {smi}: D {WIDE_D} flat and IVF indexes in both types served through "
        f"search_device at k {K} and 1024 on the wide kernel (launches {run['launches']}), "
        f"agreeing with the CPU; {time.perf_counter() - t0:.1f} s")
    return run


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
    keys (:func:`mufu_ms`)."""
    s = mask_np.shape[1]
    return mufu_ms(torch, float(h * s * attended_keys(np, mask_np).sum()))


def mufu_ms(torch, exps: float) -> float:
    """``exps`` exponentials at 16 ``MUFU.EX2`` a clock on each SM at the
    top SM clock that ``nvidia-smi`` reports."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return exps / (sms * 16 * mhz * 1e6) * 1e3


def attention_launcher(torch, lib, qs, kb, vb, mask):
    """A launch of kernel 2 from ``lib`` (this checkout's build or an
    earlier one) on the wrapper's padded inputs, by its C entry
    alone (no wrapper checks, no launch count), so that two builds are
    timed alike: an earlier build's ``pair_attention_wide`` at widths
    other than 32 where it has one, else ``pair_attention``.  Returns a
    function that launches it and returns the (P, S, H, d) bf16 context."""
    import ctypes

    from financial_rag_system_tpu_torch.ops import _cuda

    p, s, h, d = qs.shape
    fn = lib.pair_attention_wide if d != 32 and hasattr(lib, "pair_attention_wide") \
        else lib.pair_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    out = torch.empty_like(qs)

    def launch():
        _cuda.launch(fn, "pair_attention", qs.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                     mask.data_ptr(), out.data_ptr(), p, s, h, d)
        return out
    return launch


def in_chunks(torch, plain, q, k, v, mask, inv: float, chunk: int | None):
    """A call of ``plain`` (a plain attention version) over all pairs, run
    ``chunk`` pairs at a time (all at once when it is None): at phase 15's
    served shapes one (480, H, S, S) f32 tensor is over 20 GB."""
    n = chunk or q.shape[0]
    return lambda: torch.cat([plain(q[i:i + n], k[i:i + n], v[i:i + n], mask[i:i + n], inv)
                              for i in range(0, q.shape[0], n)])


def time_attention_mask(torch, np, smi: str, label: str, q, k, v, mask_np,
                        baseline=None, exact: bool = False, rtol: float = 0.0,
                        chunk: int | None = None) -> dict:
    """Kernel 2 on one mask: against its plain version (1e-2), its time
    beside the plain version's, SDPA's (a yardstick with the same additive
    bias; the port never calls it), the mask's bound and MUFU floor, and
    the mask's kend (1 + a pair's last valid key) spread.  With
    ``baseline`` (an earlier build of the kernel, ``--attn-baseline``): the
    largest difference between its context and this kernel's on the same
    inputs, and both timed in turns (old, new, new, old); with ``exact``
    the two contexts must be equal bit for bit.  ``rtol``: the check
    against the plain version is |got - ref| <= 1e-2 + rtol |ref|.
    ``chunk``: the plain version runs that many pairs at a time."""
    from financial_rag_system_tpu_torch.ops import attention as attn

    p, s, h, d = q.shape
    mask = torch.tensor(mask_np, device=q.device)
    inv = 1.0 / d ** 0.5
    plain = in_chunks(torch, attn.encoder_self_attention_plain, q, k, v, mask, inv, chunk)
    got = attn.encoder_self_attention(q, k, v, mask, inv)
    torch.cuda.synchronize()
    ref = plain()
    if not torch.isfinite(got).all():
        raise AssertionError(f"attention, {label} mask, S={s} d={d}: non-finite output")
    err = float((got - ref).abs().max())
    excess = float(((got - ref).abs() - rtol * ref.abs()).max())
    del got, ref
    if excess > 1e-2:
        raise AssertionError(f"attention, {label} mask, S={s} d={d}: differs by {err} (beyond "
                             f"1e-2 + {rtol} |ref|)")
    qs, kb, vb = attn.kernel_inputs(q, k, v, inv)  # heads padded to 32, 64 or 128

    def kernel():
        return attn.pair_attention_kernel(qs, kb, vb, mask)

    ms = median_ms(kernel, reps=20)
    plain_ms = median_ms(plain, reps=5)
    # yardstick only: one PyTorch call for the same function (the port never calls it)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (qs, kb, vb))
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = median_ms(lambda: sdpa(qh, kh, vh, attn_mask=bias, scale=1.0), reps=20)
    kend = attn.key_ends(mask).cpu().numpy()
    blocks = attn.ring_blocks(mask).float().mean().item()
    b_ms, b_by = attention_bound(np, mask_np, h, d)
    mufu = mufu_floor_ms(torch, np, mask_np, h)
    line = (f"[attention] {smi}: {label} mask, P={p} S={s} H={h} d={d} (kernel width "
            f"{qs.shape[-1]}): max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, sdpa {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), MUFU floor "
            f"{mufu:.4f} ms, kernel at {b_ms / ms:.3f} of its bound; kend min {kend.min()} mean "
            f"{kend.mean():.1f} max {kend.max()}, 128-key blocks a pair {blocks:.3f}")
    if baseline is not None:
        from financial_rag_system_tpu_torch.ops import _cuda

        old_fn = attention_launcher(torch, baseline, qs, kb, vb, mask)
        new_fn = attention_launcher(torch, _cuda.library("pair_attention"), qs, kb, vb, mask)
        diff = float((new_fn().float() - old_fn().float()).abs().max())
        if exact and diff != 0.0:
            raise AssertionError(f"attention, {label} mask, S={s} d={d}: the context differs "
                                 f"from the baseline build's by {diff}")
        turns = [median_ms(fn, reps=20) for fn in (old_fn, new_fn, new_fn, old_fn)]
        line += (f"; baseline: context max abs diff {diff:.3g}, old, new, new, old (both by "
                 f"their C entries) {[round(t, 4) for t in turns]} ms")
    del qs, kb, vb, qh, kh, vh, bias
    log(line)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by, "mufu_ms": mufu}


def check_attention_at(torch, np, smi: str, p: int, s: int, h: int = 12,
                       all_valid: bool = False, baseline=None, d: int = 32) -> dict:
    """Kernel 2 at one shape on the table's mask (uniform lengths) and,
    with ``all_valid``, on a mask with every key valid (nothing to skip);
    returns the uniform mask's figures."""
    q, k, v, mask_np = attention_inputs(torch, np, p, s, h, d)
    if all_valid:
        time_attention_mask(torch, np, smi, "all-valid", q, k, v, np.ones_like(mask_np),
                            baseline)
    return time_attention_mask(torch, np, smi, "uniform-length", q, k, v, mask_np, baseline)


# kernel 2's widths at the rerank shape: (heads, head width), the served
# rerank (12 of 32), BERT-base (12 of 64) and 6 heads of 128
ATTN_WIDTHS = ((12, 32), (12, 64), (6, 128))
# widths the wrapper pads: to 32 (24), 64 (40, 48) and 128 (80, 112)
ATTN_PADDED = (24, 40, 48, 80, 112)


def check_attention(torch, np, smi: str, baseline=None) -> list:
    """Phase 2's kernel 2: each of ``ATTN_WIDTHS`` at the rerank shape (P
    480, S 400) on the uniform and the all-valid mask; the query embed's
    shape (P 32, S 32, heads of 32: the main paths take the einsum path
    there, RAG_TPU_PAIR_ATTN=1 sends it to the kernel); 12 heads of each
    of ``ATTN_PADDED``; then ``nvcc -Xptxas -v`` of the source, where no
    instantiation may spill.  Returns the ``kernels`` line's entries: the
    persistent kernel at 12 heads of 32, the ring kernel at 12 of 64."""
    res = {d: check_attention_at(torch, np, smi, PAIRS, 400, h=h, d=d, all_valid=True,
                                 baseline=baseline)
           for h, d in ATTN_WIDTHS}
    check_attention_at(torch, np, smi, B, 32)
    for d in ATTN_PADDED:
        check_attention_at(torch, np, smi, PAIRS, 400, h=12, d=d, baseline=baseline)
    report = ptxas_report("pair_attention")
    log(f"[attention] ptxas -v of csrc/pair_attention.cu (registers, spill store and load "
        f"bytes): {report}")
    ring = [k for k in report if "ring_kernel" in k]
    if (len(ring) != 2 or not any("pair_attention_kernel" in k for k in report)
            or not any("long_pair_kernel" in k for k in report)
            or any(r[1] or r[2] for r in report.values())):
        raise AssertionError(f"[attention] a kernel-2 instantiation spills, or ptxas named "
                             f"other kernels: {report}")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    entry = {"route": "cuda", "source": f"{PACKAGE}/csrc/pair_attention.cu",
             "replaces": "financial_rag_system_tpu/ops/attention.py:48"}
    return [{"name": "pair_attention", **entry, **{key: res[32][key] for key in keys}},
            {"name": "pair_attention_ring", **entry, **{key: res[64][key] for key in keys}}]


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
    hole, the documents' lengths), with random q, k and v, at each of
    ``ATTN_WIDTHS``."""
    mask_np = rerank_batch_mask(torch, np, main)
    p, s = mask_np.shape
    for h, d in ATTN_WIDTHS:
        q, k, v, _ = attention_inputs(torch, np, p, s, h, d)
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
                embed=None, n: int = N, dlen: int = DLEN) -> None:
    """``n`` unit rows (131,072), ~``n_tickers`` tickers x 3 doc types, a
    ``dlen``-wide token store of random wordpiece ids (368; documents of
    ``dlen`` / 2 to ``dlen`` tokens), short texts as payloads, saved to
    ``work / name``.  The rows are random, or ``embed(dtok)`` of the (n,
    dlen) token store."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.models.tokenizer import SEP_ID

    rng = np.random.default_rng(SEED + 1)
    emb = rng.standard_normal((n, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    lens = rng.integers(dlen // 2, dlen + 1, n)
    dtok = rng.integers(1000, 30522, (n, dlen)).astype(np.int32)
    dtok[np.arange(n), lens - 1] = SEP_ID
    dtok *= np.arange(dlen)[None, :] < lens[:, None]
    if embed is not None:
        emb = embed(dtok)
    tick = rng.integers(0, n_tickers, n)
    dtyp = rng.integers(0, len(DOC_TYPES), n)
    index = FlatIndex(D, capacity=n, token_store_len=dlen, device="cpu")
    codes = np.empty((2, n), np.int32)
    for r in range(n):
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
    apart from their bf16 branches, their select path above k 32
    (``*_select``, no entry of the line: every main path launches it 0
    times) apart from both, and their wide kernel (``*_wide``: rows of
    more than 1,024 values, either type and path; launched by phase 2's
    wide path only) apart from all three."""
    from financial_rag_system_tpu_torch.index.ivf import ivf_probe
    from financial_rag_system_tpu_torch.ops import fused_bert
    from financial_rag_system_tpu_torch.ops.attention import encoder_self_attention
    from financial_rag_system_tpu_torch.ops.flash_attention import encoder_flash_attention
    from financial_rag_system_tpu_torch.ops.topk import masked_topk

    return {"masked_topk": (masked_topk, "launches"),
            "masked_topk_int8": (masked_topk, "launches_int8"),
            "masked_topk_select": (masked_topk, "launches_select"),
            "pair_attention": (encoder_self_attention, "launches"),
            "pair_attention_ring": (encoder_self_attention, "launches_ring"),
            "pair_attention_long": (encoder_self_attention, "launches_long"),
            "flash_attention": (encoder_flash_attention, "launches"),
            "flash_attention_long": (encoder_flash_attention, "launches_long"),
            "flash_attention_wide": (encoder_flash_attention, "launches_wide"),
            "flash_attention_slab": (encoder_flash_attention, "launches_slab"),
            "flash_attention_bwd_dkv": (encoder_flash_attention, "launches_bwd_dkv"),
            "flash_attention_bwd_dq": (encoder_flash_attention, "launches_bwd_dq"),
            "flash_attention_bwd_wide_dkv": (encoder_flash_attention, "launches_bwd_wide_dkv"),
            "flash_attention_bwd_wide_dq": (encoder_flash_attention, "launches_bwd_wide_dq"),
            "ivf_probe": (ivf_probe, "launches"),
            "ivf_probe_int8": (ivf_probe, "launches_int8"),
            "ivf_probe_select": (ivf_probe, "launches_select"),
            "masked_topk_wide": (masked_topk, "launches_wide"),
            "ivf_probe_wide": (ivf_probe, "launches_wide"),
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
                    index: str = "index", rounds: int = 2, mesh=None,
                    attention: str = "pair_attention", reranker: str = "reranker",
                    rerank_layers: int = 6, n: int = N, dlen: int = DLEN) -> dict:
    """The flat tier through ``build_default_engine(device="cuda")`` over
    the index saved in ``work / index``: 3 single asks, ``rounds`` bursts
    of 32 and a cache hit.  ``label`` tags the log lines and, past the
    first run, the questions, so that no ask of a later run is a cache hit
    of an earlier one.  Kernel 1's bf16 or int8 branch launches once a
    batch, as the index is; kernel 2 once a rerank layer (the query embed,
    below S 256, takes the einsum path); the fused-block kernels 18 times
    a batch when the caller has set their opt-in, else never.  With
    ``mesh`` (a device list) the engine shards the corpus over it: kernel
    1 launches once a shard and kernel 2 once a shard's rerank chunk a
    layer.  ``attention`` names the kernel that the rerank layers launch
    (``flash_attention`` under phase 12's ``FLASH_ENV``,
    ``pair_attention_ring`` for phase 13's heads of 64,
    ``flash_attention_wide`` for phase 14's heads of 256); ``reranker`` the
    checkpoint in ``work``, of ``rerank_layers`` layers; ``n`` and ``dlen``
    the index's rows and token-store width."""
    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.models.tokenizer import pad_batch
    from financial_rag_system_tpu_torch.obs.tracing import get_tracer
    from financial_rag_system_tpu_torch.serving.app import build_default_engine
    from financial_rag_system_tpu_torch.utils.config import reset_config

    os.environ.update({
        "RAG_TPU_BGE_DIR": str(work / "bge"),
        "RAG_TPU_RERANKER_DIR": str(work / reranker),
        "INDEX_DIR": str(work / index),
        "TESTING": "true",
        "DATABASE_URL": str(work / "cache.db"),
        "RAG_TPU_CB_PATH": str(work / "breaker.json"),
        # a fixed window long enough that 32 concurrent asks form one batch
        "RAG_TPU_BATCH_WINDOW_S": "0.25",
        "RAG_TPU_BATCH_EAGER_IDLE_S": "0",
    })
    reset_config()
    engine = build_default_engine(device="cuda", mesh_devices=mesh)
    if engine.queue_status()["fused_kind"] != "full":
        raise AssertionError(f"fused_kind {engine.queue_status()['fused_kind']!r}")
    if engine.index.n_valid != n or engine.index.token_store_len != dlen:
        raise AssertionError("the persisted index did not load whole")
    shards = len(mesh) if mesh else 1

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
    # per fused batch: one top-k, attention once a rerank layer, and the
    # fused-block kernels once a layer (12 embed + 6 rerank) under their
    # opt-in
    topk = "masked_topk_int8" if engine.index.quantized else "masked_topk"
    want = want_launches(**{topk: shards * n_batches,
                            attention: rerank_layers * shards * n_batches},
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
        f"{lq + dlen} ({lq} query + {dlen} doc); batch walls (size, ms) {batches}")
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


def profile_run(torch, fn, label: str, smi: str, stats: dict | None = None):
    """Wall time and device time by kernel (torch.profiler) of one call of
    ``fn`` after a warm-up; returns its output.  ``stats``, where given,
    receives the wall and device milliseconds and the (device ms, count,
    kernel) rows."""
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
    if stats is not None:
        stats.update(wall_ms=wall, device_ms=total, rows=rows)
    log(f"[profile] {smi}: {label} on {B} queries: wall {wall:.2f} ms, device "
        f"{total:.2f} ms in {len(rows)} kernels")
    for ms, count, key in rows[:15]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    return out


def flat_batch(torch, engine, queries, dev, index, models, n_valid: int = N):
    """``fused_two_stage`` on ``dev`` over the first ``n_valid`` rows of
    ``index`` with ``models`` (embedder, reranker); the first
    ``len(queries)`` rows of its outputs as numpy arrays."""
    from financial_rag_system_tpu_torch.ops.fused_query import fused_two_stage

    e, r = models
    emb, idx_codes, dtok = index._arrays
    out = fused_two_stage(e.model, r.model, *fused_inputs(torch, engine, queries, dev),
                          emb, idx_codes, dtok, n_valid, rerank_cfg=r.cfg, k=K)
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
                           probe_entry_fn(torch, baseline_lib("ivf_probe", baseline), real, tile),
                           lambda: ivf_probe(*real, tile=tile), exact=quantized or name == "real",
                           new_entry=probe_entry_fn(torch, probe_library(), real, tile))
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
    times of a short kernel are mostly that).  NaN if five profiles in a
    row hold none (the profiler has been seen to drop them)."""
    for _ in range(5):
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
    profiler has been seen to drop and to repeat records), or, for a
    kernel launched several times a call with different work (the select
    path's digit passes), its launches' sum over the calls; empty if three
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
            return {name: (sum(t.values()) / calls if len(t) % calls == 0 and len(t) > calls
                           else statistics.median(t.values()) * max(1, round(len(t) / calls)))
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
                       topk_entry_fn(torch, baseline_lib("masked_topk", baseline), args),
                       lambda: masked_topk(*args),
                       new_entry=topk_entry_fn(torch, topk_library(), args))
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

# -- phase 9: the training path ---------------------------------------------------

# the stack's flags: evaluate.py's canonical trained stack at full width
TRAIN_FLAGS = ("--trained-arch", "bge", "--chunk-chars", "1000", "--train-steps", "150",
               "--two-stage", "--filler-negatives", "--neg-weight", "0.5", "--distill", "50")
HARD_CORPUS = 65_536
TEACHER_BATCH = 64      # triples a teacher batch (train/distill.py teacher_margins)
# one step of each objective on the card against the CPU (tanh GELU on both)
# from the same weights at full width, on TRAIN_ROWS rows
TRAIN_ROWS = 4
# the losses: bf16's unit roundoff, 2^-8.  Each side rounds the activations
# to bf16 before every product, and where the f32 sums before a rounding
# differ in their last bits an element lands one bf16 step away (measured
# 9.8e-5 to 6.3e-4 from the trained towers, and 1.31e-3 for BCE from the
# reranker that BCE's deterministic run trained after the type table's
# gradient became a product)
TRAIN_LOSS_RTOL = 2 ** -8
# the gradients' L2 difference over their norm, from the trained towers
# (measured 1.3e-3 to 3.5e-3 on an H100; at random init InfoNCE sits at
# chance and its gradient is mostly bf16 rounding noise: 4.3e-2)
TRAIN_GRAD_TOL = 2e-2
# the updated weights: one Adam step from zero moments moves a weight by
# lr * g / (|g| + eps), at most lr plus the decay's lr * 1e-4 * |w|, so two
# steps of opposite sign part by 2 lr: a gradient within the rounding noise
# of 0 takes either sign.  Where both gradients share a sign and are at
# least TRAIN_SIGN_FLOOR (1000 eps) after clipping, the steps agree.
TRAIN_LR_UNITS = 2.001
TRAIN_SIGN_FLOOR = 1e-5
TRAIN_SURE_LR_UNITS = 1e-2
REPRO_STEPS = 12        # cross-encoder steps run twice from the same weights


class StepLog:
    """One trainer's steps as a wrapped ``make_*_step`` saw them: CUDA
    events around each, its loss, its batches' real (mask) and padded
    tokens and shapes, kernel 2's launches inside it, and the peak of
    ``torch.cuda.max_memory_allocated`` from the step maker on."""

    def __init__(self, cfg, batches_of):
        self.cfg, self.batches_of = cfg, batches_of
        self.events, self.losses, self.shapes = [], [], []
        self.real = self.padded = self.attn = self.peak = 0

    def add(self, torch, start, end, loss, args, attn: int) -> None:
        self.events.append((start, end))
        self.losses.append(loss)
        shapes = []
        for batch in self.batches_of(args):
            mask = batch[2]
            self.real += int(mask.sum())
            self.padded += int(mask.size)
            shapes.append(tuple(mask.shape))
        self.shapes.append(shapes)
        self.attn += attn
        self.peak = max(self.peak, torch.cuda.max_memory_allocated())

    def forward_flops(self, shapes) -> float:
        """Dense and attention forward FLOPs of one step's encoder calls on
        their padded (B, S): 2 B S L (4 H^2 + 2 H I) + 4 B S^2 H L."""
        c = self.cfg
        return sum(2 * b * s * c.layers * (4 * c.hidden ** 2 + 2 * c.hidden * c.intermediate)
                   + 4 * b * s * s * c.hidden * c.layers for b, s in shapes)

    def report(self, name: str, smi: str) -> dict:
        ms = [a.elapsed_time(b) for a, b in self.events]
        losses = [float(x) for x in self.losses]
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"{name}: a loss is not finite")
        flops = [self.forward_flops(s) for s in self.shapes]
        secs = sum(ms) / 1e3
        mfu = 3 * sum(flops) / (secs * BF16_FLOP_PER_S)
        out = {"steps": len(ms), "loss_first": losses[0], "loss_last": losses[-1],
               "step_ms_median": statistics.median(ms), "tokens_per_s": self.real / secs,
               "peak_gib": self.peak / 2 ** 30, "train_mfu": mfu}
        log(f"[train] {smi}: {name}: {len(ms)} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
            f"median step {out['step_ms_median']:.2f} ms (CUDA events; "
            f"{min(ms):.2f}-{max(ms):.2f}); "
            f"{out['tokens_per_s']:.0f} real tokens/s ({self.real} real of {self.padded} padded "
            f"tokens over {secs:.2f} s of steps); peak {out['peak_gib']:.2f} GiB "
            f"(torch.cuda.max_memory_allocated); train_mfu {mfu:.4f} = 3 x {sum(flops):.4e} "
            f"forward FLOP (2 B S L (4 H^2 + 2 H I) + 4 B S^2 H L over each step's padded "
            f"shapes, first step {self.shapes[0]}) / ({secs:.3f} s x 989 TFLOP/s)")
        return out


@contextlib.contextmanager
def step_logs(torch, cross_cfg=None):
    """Wrap the three step makers and ``teacher_margins`` of ``train/`` for
    the block: each step is timed and counted (:class:`StepLog`; the
    cross-encoder's FLOPs from ``cross_cfg``, MiniLM-L6's unless given),
    and the teacher pass's kernel-2 launches and scoring calls are kept."""
    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.ops.attention import encoder_self_attention
    from financial_rag_system_tpu_torch.train import contrastive, cross_encoder, distill

    logs = {"contrastive": StepLog(bert.BGE_SMALL, lambda a: [b for b in a[:3] if b is not None]),
            "cross_encoder": StepLog(cross_cfg or bert.MINILM_L6_CROSS, lambda a: [a[:3]]),
            "distill": StepLog(bert.BGE_SMALL, lambda a: a[:3])}
    teacher = {"launches": 0, "calls": 0, "seconds": 0.0, "lengths": []}
    saved = [(contrastive, "make_train_step", logs["contrastive"]),
             (cross_encoder, "make_cross_step", logs["cross_encoder"]),
             (distill, "make_distill_step", logs["distill"])]
    originals = [getattr(m, n) for m, n, _ in saved]
    score = bert.cross_score

    def timed_maker(make, slog):
        def maker(*a, **k):
            step = make(*a, **k)
            torch.cuda.reset_peak_memory_stats()

            def logged(*args):
                n0 = encoder_self_attention.launches
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                loss = step(*args)
                end.record()
                slog.add(torch, start, end, loss, args, encoder_self_attention.launches - n0)
                return loss
            return logged
        return maker

    teacher_margins = distill.teacher_margins

    def timed_teacher(*a, **k):
        n0 = encoder_self_attention.launches
        t0 = time.perf_counter()

        def counted_score(model, ids, types, mask):
            teacher["calls"] += 1
            teacher["lengths"].append(int(ids.shape[1]))
            return score(model, ids, types, mask)

        bert.cross_score = counted_score
        try:
            out = teacher_margins(*a, **k)
        finally:
            bert.cross_score = score
        torch.cuda.synchronize()
        teacher["seconds"] += time.perf_counter() - t0
        teacher["launches"] += encoder_self_attention.launches - n0
        return out

    for module, name, slog in saved:
        setattr(module, name, timed_maker(getattr(module, name), slog))
    distill.teacher_margins = timed_teacher
    try:
        yield logs, teacher
    finally:
        for (module, name, _), orig in zip(saved, originals):
            setattr(module, name, orig)
        distill.teacher_margins = teacher_margins
        bert.cross_score = score


def hit_at_5(questions, answers) -> float:
    hits = 0
    for q, a in zip(questions, answers):
        texts = [s["text"].lower() for s in a["sources"][:5]]
        hits += any(kw.lower() in t for kw in q["expected_keywords"] for t in texts)
    return hits / len(questions)


def serve_stack(torch, np, work: Path, ckpt: Path, corpus, smi: str, label: str) -> dict:
    """``build_default_engine(device="cuda")`` over the checkpoints in
    ``ckpt`` (``bge``, ``reranker``) and an empty index in ``work``, the
    hard corpus ingested with its embedder (``engine.ingest_chunks``), and
    the 56 hard-set questions served as two bursts (32, then 24: one
    fused batch each)."""
    from financial_rag_system_tpu_torch.data.synthetic import make_hard_set
    from financial_rag_system_tpu_torch.serving.app import build_default_engine
    from financial_rag_system_tpu_torch.utils.config import reset_config

    os.environ.update({
        "RAG_TPU_BGE_DIR": str(ckpt / "bge"), "RAG_TPU_RERANKER_DIR": str(ckpt / "reranker"),
        "INDEX_DIR": str(work / f"index_{label}"), "TESTING": "true",
        "DATABASE_URL": str(work / f"cache_{label}.db"),
        "RAG_TPU_CB_PATH": str(work / f"breaker_{label}.json"),
        "RAG_TPU_BATCH_WINDOW_S": "0.25", "RAG_TPU_BATCH_EAGER_IDLE_S": "0",
    })
    reset_config()
    engine = build_default_engine(device="cuda")
    t0 = time.perf_counter()
    asyncio.run(engine.ingest_chunks(*corpus))
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    if engine.index.n_valid != HARD_CORPUS or engine.queue_status()["fused_kind"] != "full":
        raise AssertionError(f"[{label}] {engine.index.n_valid} rows, "
                             f"fused_kind {engine.queue_status()['fused_kind']!r}")
    batches: list[tuple[int, float]] = []
    inner = engine.batcher.batch_fn

    def timed_batch(queries, filters):
        t1 = time.perf_counter()
        out = inner(queries, filters)
        batches.append((len(queries), (time.perf_counter() - t1) * 1e3))
        return out

    engine.batcher.batch_fn = timed_batch
    engine.llm_semaphore = asyncio.Semaphore(B)
    questions = make_hard_set()

    async def scenario():
        await engine.startup()
        try:
            out = []
            for burst in (questions[:B], questions[B:]):
                out += await asyncio.gather(*[engine.ask(q["query"], q["ticker"], 5)
                                              for q in burst])
            return out
        finally:
            await engine.shutdown()

    answers = asyncio.run(scenario())
    if [n for n, _ in batches] != [B, len(questions) - B]:
        raise AssertionError(f"[{label}] batch sizes {[n for n, _ in batches]}")
    check_answers(np, answers, 5)
    hit = hit_at_5(questions, answers)
    log(f"[train] {smi}: {label} stack: {HARD_CORPUS} chunks of 1000 characters ingested in "
        f"{ingest_s:.1f} s (token store {engine.index.token_store_len} wide, reranker max_len "
        f"{engine.reranker.max_len}); 56 hard-set questions in bursts {batches} (size, ms); "
        f"Hit@5 {hit:.4f}")
    return {"engine": engine, "questions": questions, "hit5": hit, "batches": batches}


def objective_loss(torch, model, objective: str, rows: dict):
    """``objective``'s loss on ``rows`` for ``model`` (a graded forward
    when the caller runs it under ``train.optim.graded``)."""
    from financial_rag_system_tpu_torch.train import contrastive, cross_encoder, distill

    dev = model.device
    if objective == "bce":
        return cross_encoder.bce_loss(model, *contrastive.on_device(rows["pairs"], dev),
                                      rows["pos_weight"])
    q, d, n = (contrastive.on_device(b, dev) for b in rows["triples"])
    if objective == "infonce":
        return contrastive.info_nce_loss(model, q, d, 0.05, n, 0.5)
    return distill.margin_mse_loss(model, q, d, n, rows["margins"].to(dev))


def step_objective(torch, model, objective: str, rows: dict, lr: float):
    """One step of ``objective`` on ``rows`` from ``model``'s weights:
    (loss, grads by name on the CPU, the updated weights by name on the
    CPU)."""
    from financial_rag_system_tpu_torch.train.optim import ClippedAdamW, graded

    with graded(model):
        loss = objective_loss(torch, model, objective, rows)
        loss.backward()
    grads = {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    ClippedAdamW(model, lr).step()
    return float(loss.detach()), grads, {k: p.detach().cpu().clone()
                                         for k, p in model.named_parameters()}


def compare_steps(torch, lr: float, card: tuple, cpu: tuple) -> dict:
    """Two steps' (loss, grads, weights) held to the TRAIN_* tolerances;
    the figures compared, by name."""
    (loss_c, g_c, w_c), (loss_r, g_r, w_r) = card, cpu
    if g_c.keys() != g_r.keys():
        raise AssertionError(f"gradients of {set(g_c) ^ set(g_r)} on one side only")
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in g_r.values())))
    total_c = float(torch.sqrt(sum((g.double() ** 2).sum() for g in g_c.values())))
    # the gradients as the step takes them, after clipping to a norm of 1
    clip_r, clip_c = min(1.0, 1.0 / total), min(1.0, 1.0 / total_c)
    out = {"loss_rel": abs(loss_c - loss_r) / abs(loss_r),
           "grad_rel": float(torch.sqrt(sum(((g_c[k] - g_r[k]).double() ** 2).sum()
                                            for k in g_r))) / total,
           "moved_lr": 0.0, "sure_lr": 0.0, "sure": 0, "unsure": 0}
    for k in w_r:
        dw = (w_c[k] - w_r[k]).abs() / lr
        out["moved_lr"] = max(out["moved_lr"], float(dw.max()))
        if k in g_r:
            sure = ((clip_r * g_r[k].abs() >= TRAIN_SIGN_FLOOR)
                    & (clip_c * g_c[k].abs() >= TRAIN_SIGN_FLOOR)
                    & (torch.sign(g_r[k]) == torch.sign(g_c[k])))
            out["sure"] += int(sure.sum())
            out["unsure"] += int((~sure & (dw > 0.5)).sum())
            if sure.any():
                out["sure_lr"] = max(out["sure_lr"], float(dw[sure].max()))
    out["ok"] = (out["loss_rel"] <= TRAIN_LOSS_RTOL and out["grad_rel"] <= TRAIN_GRAD_TOL
                 and out["moved_lr"] <= TRAIN_LR_UNITS and out["sure_lr"] <= TRAIN_SURE_LR_UNITS)
    return out


def train_rows(torch, np, rr_len: int) -> dict:
    """TRAIN_ROWS rows of each objective's supervision, tokenized as the
    trainers tokenize them."""
    from financial_rag_system_tpu_torch.data.synthetic import make_filler_triples
    from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer, pad_batch
    from financial_rag_system_tpu_torch.train.contrastive import tokenize_pairs
    from financial_rag_system_tpu_torch.train.cross_encoder import make_cross_examples

    tok = Tokenizer()
    triples = make_filler_triples(chunk_chars=1000)[:: 97][:TRAIN_ROWS]
    examples = make_cross_examples(seed=1, chunk_chars=1000)[:TRAIN_ROWS]
    ids, types, mask = pad_batch([tok.encode_pair(q, d, rr_len) for q, d, _ in examples])
    labels = np.zeros(ids.shape[0], np.float32)
    labels[: len(examples)] = [lbl for *_, lbl in examples]
    return {"triples": tokenize_pairs(tok, triples),
            "pairs": (ids, types, mask, torch.from_numpy(labels)), "pos_weight": 5.0,
            "margins": torch.tensor([1.5, -0.5, 3.0, 0.25])}


def check_train_against_cpu(torch, np, trained: Path, rr_len: int, smi: str) -> None:
    """One step of each objective at full width on the card and on the CPU
    from the same weights, the exported trained towers in ``trained``
    (at random init InfoNCE sits at chance and its gradient is mostly
    rounding noise), held to the TRAIN_* tolerances
    (:func:`compare_steps`)."""
    from financial_rag_system_tpu_torch.models.hf_loader import load_bert_checkpoint

    rows = train_rows(torch, np, rr_len)
    lr = 1e-4
    for objective, tower, labels in (("infonce", "bge", 0), ("bce", "reranker", 1),
                                     ("margin_mse", "bge", 0)):
        out = {}
        for dev in ("cuda", "cpu"):
            with env_set(**(CPU_TANH if dev == "cpu" else {})):
                model, _ = load_bert_checkpoint(str(trained / tower), num_labels=labels,
                                                device=dev)
                out[dev] = step_objective(torch, model, objective, rows, lr)
        c = compare_steps(torch, lr, out["cuda"], out["cpu"])
        log(f"[train] {smi}: {objective}, one step of the trained {tower} on {TRAIN_ROWS} rows, "
            f"card vs CPU: loss {out['cuda'][0]:.6f} vs {out['cpu'][0]:.6f} "
            f"(rel {c['loss_rel']:.2e}; "
            f"tolerance {TRAIN_LOSS_RTOL}); gradients {c['grad_rel']:.2e} of their norm "
            f"(tolerance {TRAIN_GRAD_TOL}); updated weights within {c['moved_lr']:.4f} lr "
            f"(tolerance {TRAIN_LR_UNITS}), and within {c['sure_lr']:.2e} lr (tolerance "
            f"{TRAIN_SURE_LR_UNITS}) at the {c['sure']} whose clipped gradients share a sign "
            f"and are at least {TRAIN_SIGN_FLOOR} on both; {c['unsure']} others more than lr/2 "
            f"apart")
        if not c["ok"]:
            raise AssertionError(f"{objective}: the card's step differs from the CPU's")


def check_resume(torch, np, work: Path, smi: str) -> None:
    """Checkpoint resume at full width on the card: two InfoNCE steps, a
    checkpoint, a third step; then a fresh model and optimizer restored
    from the checkpoint take the third step again.  The loss and the
    weights bit for bit (the graded embedding backward sums in a fixed
    order, ``models/bert.py _Lookup``)."""
    from financial_rag_system_tpu_torch.data.synthetic import make_filler_triples
    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer
    from financial_rag_system_tpu_torch.train import checkpoint, contrastive, stack
    from financial_rag_system_tpu_torch.train.optim import ClippedAdamW

    lr, tok = 1e-4, Tokenizer()
    triples = make_filler_triples(chunk_chars=1000)[:12]
    batches = [contrastive.tokenize_pairs(tok, triples[i: i + 4]) for i in range(0, 12, 4)]
    model = stack.init_model(bert.BGE_SMALL, 0, "cuda")
    opt = ClippedAdamW(model, lr)
    step = contrastive.make_train_step(model, opt, neg_weight=0.5)
    for b in batches[:2]:
        step(*b)
    ck = work / "resume"
    checkpoint.save_state(str(ck), 2, {"model": model.state_dict(), "opt": opt.state_dict()})
    loss_a = float(step(*batches[2]))
    restored = stack.init_model(bert.BGE_SMALL, 5, "cuda")
    opt_b = ClippedAdamW(restored, lr)
    n, state = checkpoint.restore_state(str(ck), map_location="cuda")
    restored.load_state_dict(state["model"])
    restored.weights_changed()
    opt_b.load_state_dict(state["opt"])
    loss_b = float(contrastive.make_train_step(restored, opt_b, neg_weight=0.5)(*batches[2]))
    dw = max(float((p - q).abs().max()) for p, q in zip(model.parameters(), restored.parameters()))
    log(f"[train] {smi}: resume at step {n}: step 3 loss {loss_a!r} uninterrupted, {loss_b!r} "
        f"resumed; weights {dw!r} apart (want bit for bit)")
    if n != 2 or loss_a != loss_b or dw != 0:
        raise AssertionError("the resumed step differs from the uninterrupted one")


def check_reproducible(torch, np, rr_len: int, smi: str) -> None:
    """The cross-encoder trainer twice at full width from the same weights,
    REPRO_STEPS steps of 32 pairs at ``rr_len`` tokens: the losses and the
    weights bit for bit."""
    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.train import cross_encoder, stack

    examples = cross_encoder.make_cross_examples(seed=1, chunk_chars=1000)
    order = np.random.default_rng(1).permutation(len(examples))[: 32 * REPRO_STEPS]
    examples = [examples[i] for i in order]
    runs = []
    for _ in range(2):
        model = stack.init_model(bert.MINILM_L6_CROSS, 1, "cuda")
        _, losses = cross_encoder.train_cross_encoder(model, examples, batch_size=32, lr=1e-4,
                                                      max_len=rr_len, seed=1)
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
        del model
    (la, wa), (lb, wb) = runs
    dw = max(float((a - b).abs().max()) for a, b in zip(wa, wb))
    log(f"[train] {smi}: the cross-encoder trained twice from the same weights, {len(la)} steps "
        f"of 32 pairs at {rr_len} tokens: losses {la[0]!r} -> {la[-1]!r} and {lb[0]!r} -> "
        f"{lb[-1]!r}, equal {la == lb}; weights {dw!r} apart (want bit for bit)")
    if la != lb or dw != 0:
        raise AssertionError("two runs of the cross-encoder trainer differ")


def kind_of(ev) -> str:
    """A profiled kernel's kind, from the ops above the event that launched it."""
    names = []
    while ev is not None:
        names.append(ev.name)
        ev = ev.cpu_parent
    chain = " | ".join(names)
    if "train_optimizer" in chain:
        return "optimizer"
    bwd = "autograd::engine" in chain
    if "_FlashAttention" in chain:  # kernels 7-9 and the torch work around them
        return "flash attention (autograd function), " + ("backward" if bwd else "forward")
    if any(k in chain for k in ("aten::bmm", "aten::_softmax", "BmmBackward", "SoftmaxBackward")):
        return "einsum attention, " + ("backward" if bwd else "forward")
    if "_BF16ProductBackward" in chain:
        return "dense products' backward (f32)"
    if not bwd and "aten::mm" in chain:
        return "dense products, forward (bf16)"
    if "EmbeddingBackward" in chain or "_LookupBackward" in chain:
        return "embedding backward"
    return "elementwise and other, " + ("backward" if bwd else "forward")


def profile_train_step(torch, name: str, step_fn, smi: str) -> None:
    """Device time by kind (:func:`kind_of`) over one training step, after
    a warm-up step and beside the median of 3 steps' CUDA-event times
    without the profiler (the idle share's denominator)."""
    from torch.profiler import ProfilerActivity, profile

    wall = median_ms(step_fn, reps=3, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_fn()
        torch.cuda.synchronize()
    kinds: dict[str, list] = {}
    for ev in prof.events():
        for k in getattr(ev, "kernels", []):
            row = kinds.setdefault(kind_of(ev), [0.0, 0])
            row[0] += k.duration / 1e3
            row[1] += 1
    device = sum(ms for ms, _ in kinds.values())
    log(f"[train] {smi}: profile of one {name} step: {wall:.2f} ms a step (CUDA events), device "
        f"{device:.2f} ms in {sum(n for _, n in kinds.values())} kernels, idle share "
        f"{max(0.0, 1 - device / wall):.3f}")
    for kind, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        log(f"[train]   {ms:9.3f} ms  x{n:<5d} {kind}")
    if device <= 0:
        raise AssertionError(f"the {name} step's profile holds no device time")


def profile_train_steps(torch, rr_len: int, smi: str) -> None:
    """One step of each tower at the trainers' shapes (32 filler triples at
    64 tokens; 32 pairs at the reranker's length) from fresh weights."""
    from torch.profiler import record_function

    from financial_rag_system_tpu_torch.data.synthetic import make_filler_triples
    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer, pad_batch
    from financial_rag_system_tpu_torch.train import contrastive, cross_encoder, stack
    from financial_rag_system_tpu_torch.train.cross_encoder import make_cross_examples
    from financial_rag_system_tpu_torch.train.optim import ClippedAdamW, graded

    tok = Tokenizer()
    tri = contrastive.tokenize_pairs(tok, make_filler_triples(chunk_chars=1000)[:B])
    ex = make_cross_examples(seed=1, chunk_chars=1000)[:B]
    pairs = pad_batch([tok.encode_pair(q, d, rr_len) for q, d, _ in ex])
    labels = torch.tensor([lbl for *_, lbl in ex], device="cuda")
    for name, cfg, seed, loss_of in (
        ("bi-encoder InfoNCE", bert.BGE_SMALL, 0, lambda m: contrastive.info_nce_loss(
            m, *(contrastive.on_device(b, "cuda") for b in tri[:2]), 0.05,
            contrastive.on_device(tri[2], "cuda"), 0.5)),
        ("cross-encoder BCE", bert.MINILM_L6_CROSS, 1, lambda m: cross_encoder.bce_loss(
            m, *contrastive.on_device(pairs, "cuda"), labels, 5.0)),
    ):
        model = stack.init_model(cfg, seed, "cuda")
        opt = ClippedAdamW(model, 1e-4)

        def step_fn(model=model, opt=opt, loss_of=loss_of):
            with graded(model):
                loss_of(model).backward()
            with record_function("train_optimizer"):
                opt.step()

        profile_train_step(torch, name, step_fn, smi)
        del model, opt


def drive_training_path(torch, np, work: Path, smi: str) -> dict:
    """Phase 9: ``train/stack.py``'s entry with TRAIN_FLAGS on the card
    (both towers at full width, then distillation on ``evaluate.py``'s
    unpadded triples), the export served through ``build_default_engine``
    over the 65,536-chunk hard corpus, with every kernel's launches read around
    that run."""
    from financial_rag_system_tpu_torch.data.synthetic import make_hard_corpus
    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.ops.attention import encoder_self_attention
    from financial_rag_system_tpu_torch.train import stack

    out = work / "trained"
    t0 = time.perf_counter()
    corpus = make_hard_corpus(HARD_CORPUS, chunk_chars=1000)
    log(f"[train] hard corpus of {HARD_CORPUS} chunks made in {time.perf_counter() - t0:.1f} s")
    reset_launches()
    t0 = time.perf_counter()
    with step_logs(torch) as (logs, teacher):
        emb, rr = stack.main([*TRAIN_FLAGS, "--save-trained", str(out)])
    train_s = time.perf_counter() - t0
    serve = serve_stack(torch, np, work, out, corpus, smi, "trained")
    launches = read_launches()
    report = {name: slog.report(name, smi) for name, slog in logs.items()}
    graded_attn = {name: slog.attn for name, slog in logs.items()}
    n_triples = len(stack.distill_triples("both"))
    want_calls = 2 * -(-n_triples // TEACHER_BATCH)
    # the teacher scores through the serving forward: kernel 2 once a layer
    # in each call whose pair bucket passes the gate (256 tokens or more)
    cfg = rr.cfg
    want_teacher = cfg.layers * sum(bert._pair_attn_enabled(s, cfg.hidden // cfg.heads)
                                    for s in teacher["lengths"])
    log(f"[train] {smi}: stack trained, distilled and exported in {train_s:.1f} s; teacher pass "
        f"{teacher['seconds']:.2f} s, {teacher['calls']} cross_score calls over {n_triples} "
        f"unpadded triples at pair lengths {dict(collections.Counter(teacher['lengths']))}, "
        f"kernel 2 launches {teacher['launches']} (want {want_teacher}); kernel 2 launches "
        f"inside the graded steps {graded_attn}; launches over the run {launches}")
    if any(graded_attn.values()):
        raise AssertionError(f"kernel 2 launched inside graded steps: {graded_attn}")
    if teacher["calls"] != want_calls or teacher["launches"] != want_teacher:
        raise AssertionError(f"teacher pass: {teacher['calls']} calls and {teacher['launches']} "
                             f"kernel 2 launches, want {want_calls} and {want_teacher}")
    n_batches = len(serve["batches"])
    want = want_launches(masked_topk=n_batches,
                         pair_attention=teacher["launches"] + 6 * n_batches)
    if launches != want:
        raise AssertionError(f"[train] launches {launches}, want {want}")
    for name, r in report.items():
        if not r["loss_last"] < r["loss_first"]:
            raise AssertionError(f"{name}: the loss did not fall ({r})")
    # a graded CUDA input handed to the attention kernel's wrapper raises
    q = torch.zeros(1, 8, 2, 32, device="cuda", requires_grad=True)
    try:
        encoder_self_attention(q, q, q, torch.ones(1, 8, device="cuda"), 0.1)
    except RuntimeError as exc:
        if "no backward" not in str(exc):
            raise
    else:
        raise AssertionError("encoder_self_attention took an input that requires grad")
    return {"launches": launches, "serve": serve, "emb": emb, "rr": rr, "corpus": corpus}


def save_random_stack(torch, work: Path, run: dict) -> Path:
    """The trained stack's starting point exported as it was exported:
    the stack's seeded init (seeds 0 and 1), the same architectures and
    the same trained lengths (``work / "random"``)."""
    from financial_rag_system_tpu_torch.models.embedder import BiEncoder
    from financial_rag_system_tpu_torch.models.reranker import CrossEncoderReranker
    from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer
    from financial_rag_system_tpu_torch.train import stack

    emb, rr = run["emb"], run["rr"]
    out = work / "random"
    stack.save_trained(
        BiEncoder(stack.init_model(emb.cfg, 0, "cuda"), emb.cfg, Tokenizer(), max_len=emb.max_len),
        CrossEncoderReranker(stack.init_model(rr.cfg, 1, "cuda"), rr.cfg, Tokenizer(),
                             max_len=rr.max_len),
        str(out))
    return out


def check_trained_against_cpu(torch, np, run: dict, work: Path) -> None:
    """One fused batch of the trained stack on the card against the same
    pipeline on the CPU (the exported checkpoints, the index saved on the
    card and loaded on the CPU)."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.models.embedder import get_embedder
    from financial_rag_system_tpu_torch.models.reranker import get_reranker
    from financial_rag_system_tpu_torch.utils.config import get_config

    engine = run["serve"]["engine"]
    engine.index.save(get_config().index_dir)
    cpu_index = FlatIndex.load(get_config().index_dir, device="cpu")
    queries = [(q["query"], q["ticker"], None) for q in run["serve"]["questions"][:2]]
    n = engine.index.n_valid
    got = flat_batch(torch, engine, queries, "cuda", engine.index,
                     (engine.embedder, engine.reranker), n)
    with env_set(**CPU_TANH):
        models = (get_embedder(device="cpu"), get_reranker(device="cpu"))
        ref = flat_batch(torch, engine, queries, "cpu", cpu_index, models, n)
    compare_batches(np, "[train] trained stack, card vs CPU", got, ref)


# -- phase 10: the mesh-sharded tier --------------------------------------------------

# four corpus shards on the one card: their launches run one after another
SHARDS = 4
MESH = ["cuda:0"] * SHARDS
SHARDED_DIR = "index_sharded"
RECALL_FLOOR = 0.9  # mean recall@15 of the IVF and HNSW tiers against exact


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def to_sharded_dir(np, work: Path, src: str, dst: str) -> None:
    """``work / src``'s flat_index.npz rewritten as the JAX package's
    sharded_index.npz of the same rows (meta [dim, tile, capacity,
    quantized, dlen]), with its store.json, in ``work / dst``."""
    data = np.load(work / src / "flat_index.npz")
    dim, tile, capacity, dlen, quantized = (int(x) for x in data["meta"])
    (work / dst).mkdir(parents=True, exist_ok=True)
    np.savez(work / dst / "sharded_index.npz", emb=data["emb"], codes=data["codes"],
             dtok=data["doc_tok"], meta=np.asarray([dim, tile, capacity, quantized, dlen]))
    shutil.copy(work / src / "store.json", work / dst / "store.json")


def to_sharded(torch, flat, n: int, capacity: int):
    """A ShardedFlatIndex over MESH holding rows [0, n) of ``flat`` (its
    tensors cut into the shards' blocks on the card) and its store."""
    from financial_rag_system_tpu_torch.index.sharded import ShardedFlatIndex
    from financial_rag_system_tpu_torch.parallel.mesh import create_mesh

    idx = ShardedFlatIndex(create_mesh(devices=MESH), D, capacity=capacity, tile=1024,
                           dtype=flat.dtype, token_store_len=flat.token_store_len,
                           tokenizer=flat.tokenizer)
    emb, codes, dtok = flat._arrays
    p = idx.per_shard
    idx._arrays = (idx._blocks(emb[:n], p, 0, flat.dtype),
                   idx._blocks(codes[:, :n], p, -2, torch.int32, dim=1),
                   idx._blocks(dtok[:n], p, 0, torch.int32))
    idx.store = flat.store
    return idx


def shard_valid(idx) -> list[int]:
    """Each shard's valid rows: clamp(n_valid - base, 0, P)."""
    return [min(max(idx.n_valid - idx.shard_base(i), 0), idx.per_shard)
            for i in range(len(idx.mesh.devices))]


def engine_batch(torch, engine, queries):
    """(rows, bi, ce) of the engine's fused program on ``queries``, as the
    batcher hands it a batch (host inputs; the program reads the index's
    snapshot), the first ``len(queries)`` rows as numpy arrays."""
    from financial_rag_system_tpu_torch.models.tokenizer import pad_batch

    tok = engine.embedder.tokenizer
    ids, types, mask = pad_batch([tok.encode(q, 64) for q, _, _ in queries])
    codes = [engine.index.store.query_codes(t, d) for _, t, d in queries]
    out = engine._fused_exec(ids, types, mask, codes)
    if out is None:
        raise AssertionError("the fused program did not take the batch")
    return [x.cpu().numpy()[: len(queries)] for x in out[:3]]


def same_rows(np, what: str, got, ref, *, bi_tol: float, ce_tol: float | None,
              exact: bool = False) -> str:
    """The sharded batch's rows are the single device's; bi within
    ``bi_tol`` (bit for bit with ``exact``), ce within ``ce_tol``."""
    (rows, bi, ce), (rows_1, bi_1, ce_1) = got, ref
    if not np.array_equal(rows, rows_1):
        raise AssertionError(f"{what}: rows differ in {int((rows != rows_1).sum())} slots")
    fin = np.isfinite(bi_1)
    bi_err = float(np.abs(bi[fin] - bi_1[fin]).max())
    ce_err = float(np.abs(ce[fin] - ce_1[fin]).max()) if ce_tol is not None else 0.0
    if (exact and bi.tobytes() != bi_1.tobytes()) or bi_err > bi_tol or (
            ce_tol is not None and ce_err > ce_tol):
        raise AssertionError(f"{what}: bi err {bi_err}, ce err {ce_err}")
    return f"rows identical ({rows.size} slots), bi err {bi_err:.3g}, ce err {ce_err:.3g}"


def sharded_flat_path(torch, np, work: Path, main: dict, smi: str, label: str, src: str,
                      rounds: int, exact: bool) -> dict:
    """(a) and (b): ``work / src`` rewritten as a sharded_index.npz and
    served through ``build_default_engine(mesh_devices=MESH)``, then the
    burst's batch against the single-device program over the same rows."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.ops.fused_query import fused_two_stage

    t0 = time.perf_counter()
    dst = f"{SHARDED_DIR}_{label}"
    to_sharded_dir(np, work, src, dst)
    log(f"[{label}] {src} rewritten as {dst}/sharded_index.npz in "
        f"{time.perf_counter() - t0:.1f} s")
    run = drive_main_path(torch, np, work, smi, label=label, index=dst, rounds=rounds, mesh=MESH)
    engine = run["engine"]
    idx = engine.index
    n_batches = 3 + rounds
    sfx = "_int8" if idx.quantized else ""
    log(f"[{label}] {smi}: {idx.n_shards} shards of {idx.per_shard} rows, valid rows a shard "
        f"{shard_valid(idx)}; a batch launches kernel 1 "
        f"{run['launches']['masked_topk' + sfx] / n_batches:g} times and kernel 2 "
        f"{run['launches']['pair_attention'] / n_batches:g} times ({SHARDS} rerank chunks of "
        f"{-(-PAIRS // SHARDS)} pairs x 6 layers at the burst)")
    single = FlatIndex.load(str(work / src), device="cuda")
    queries = run["burst"]
    got = engine_batch(torch, engine, queries)
    m = main["engine"]
    ref = [x.cpu().numpy()[: len(queries)] for x in fused_two_stage(
        m.embedder.model, m.reranker.model, *fused_inputs(torch, engine, queries, "cuda"),
        *single._arrays, N, rerank_cfg=m.reranker.cfg, k=K)]
    log(f"[{label}] {smi}: the burst's sharded batch against one device's: "
        + same_rows(np, label, got, ref, bi_tol=1e-6, ce_tol=1e-2, exact=exact))
    run["single"] = single
    return run


def profile_sharded(torch, run: dict, smi: str) -> None:
    """Wall and device time of the sharded fused batch of 32 beside the
    single-device program's over the same rows."""
    from financial_rag_system_tpu_torch.models.tokenizer import pad_batch
    from financial_rag_system_tpu_torch.ops.fused_query import fused_two_stage

    engine, single = run["engine"], run["single"]
    tok = engine.embedder.tokenizer
    queries = run["burst"]
    ids, types, mask = pad_batch([tok.encode(q, 64) for q, _, _ in queries])
    codes = [engine.index.store.query_codes(t, d) for _, t, d in queries]
    profile_run(torch, lambda: engine._fused_exec(ids, types, mask, codes),
                f"sharded fused_two_stage ({SHARDS} shards on one card)", smi)
    args = fused_inputs(torch, engine, queries, "cuda")
    profile_run(torch, lambda: fused_two_stage(
        engine.embedder.model, engine.reranker.model, *args, *single._arrays, N,
        rerank_cfg=engine.reranker.cfg, k=K), "fused_two_stage (one device, same rows)", smi)


def serve_sharded_tier(torch, np, engine, smi: str, label: str, burst, fresh=None) -> dict:
    """A burst of 32 (one fused batch) and, with ``fresh``, an upsert and
    an ask that must find it, through the batched engine; the launches
    read around the run."""
    engine.llm_semaphore = asyncio.Semaphore(B)

    async def scenario():
        await engine.startup()
        try:
            answers = await asyncio.gather(*[engine.ask(f"{q} ({label})", t, 5, d)
                                             for q, t, d in burst])
            found = None
            if fresh:
                await engine.ingest_chunks([f"fresh-{label}-{i}" for i in range(len(fresh))],
                                           fresh, [{"ticker": "T05", "document_type": "10-K"}]
                                           * len(fresh))
                found = await engine.ask(fresh[0], "T05", K)
            await asyncio.sleep(0.2)
        finally:
            await engine.shutdown()
        return answers, found

    reset_launches()
    t0 = time.perf_counter()
    answers, found = asyncio.run(scenario())
    secs = time.perf_counter() - t0
    launches = read_launches()
    check_answers(np, answers, 5)
    if fresh:
        check_answers(np, [found], K)
        if not any(s["text"] in fresh for s in found["sources"]):
            raise AssertionError(f"[{label}] the ask after the upsert did not find it")
    log(f"[{label}] {smi}: burst{' + upsert + ask' if fresh else ''} served in {secs:.2f} s; "
        f"launches {launches}")
    return launches


def sharded_recall(torch, np, engine, queries, label: str, smi: str,
                   floor_served: float | None) -> None:
    """Recall@15 against the exact top-15 of the sharded flat index
    (kernel 1 on every shard): the fused batch as served, and the tier's
    search on 32 queries drawn like the corpus (a row plus the topics'
    noise) with no filter.  Fails when the mean of the latter is below
    RECALL_FLOOR, or that of the batch as served below ``floor_served``
    (None: reported only)."""
    from financial_rag_system_tpu_torch.ops.fused_query import _embed

    idx, flat = engine.index, engine.index.flat
    args = fused_inputs(torch, engine, queries, "cuda")
    rows = engine_batch(torch, engine, queries)[0]
    qv = _embed(engine.embedder.model, *args[:3])
    lines, means = [], []
    for what, q, qf, got in (("the fused batch as served", qv, args[3], rows),
                             ("queries drawn like the corpus, unfiltered",
                              *near_queries(torch, flat), None)):
        if got is None:
            got = idx.search_device(q, qf, K)[1].cpu().numpy()
        exact_s, exact_r = flat.search_device(q, qf, K)
        rec = recall_at_k(np, got[:B], exact_s[:B], exact_r[:B])
        means.append(float(np.mean(rec)))
        lines.append(f"{what} mean {means[-1]:.4f}, lowest {min(rec):.4f}, "
                     f"at 1.0 {rec.count(1.0)} of {len(rec)}")
    log(f"[{label}] {smi}: recall@{K} against the exact sharded flat top-{K}: "
        + "; ".join(lines))
    if means[1] < RECALL_FLOOR or (floor_served is not None and means[0] < floor_served):
        raise AssertionError(f"[{label}] recall@{K} {means}: floors {RECALL_FLOOR} drawn like "
                             f"the corpus, {floor_served} as served")


def near_queries(torch, flat):
    """32 unit queries near random valid rows of ``flat`` (a row plus the
    topics' noise) and their (B, 2) wildcard filters, on the card."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    near = flat.gathered(0)[torch.randint(0, flat.n_valid, (B,), generator=g,
                                          device="cuda")].float()
    near = torch.nn.functional.normalize(
        near + TOPIC_NOISE / D**0.5 * torch.randn((B, D), generator=g, device="cuda"), dim=1)
    return near, torch.full((B, 2), -1, dtype=torch.int32, device="cuda")


def check_row_scores(torch, np, flat, q, qf, rows, bi, what: str, tol: float) -> None:
    """Each returned row, looked up in the sharded flat index by its
    global id, scores its query (``q`` as the tier scores it) as returned
    within ``tol`` and passes the query's filter; empty slots are -1."""
    fin = np.isfinite(bi)
    if not (rows[~fin] == -1).all() or (rows[fin] < 0).any():
        raise AssertionError(f"{what}: empty slots and rows disagree")
    r = torch.as_tensor(np.where(fin, rows, 0), device="cuda").long()
    emb, codes = flat.gathered(0)[r].float(), flat.gathered(1, dim=1)[:, r]
    score = (q[: len(rows)].float()[:, None, :] * emb).sum(-1).cpu().numpy()
    qf = qf[: len(rows)]
    ok = (((qf[:, :1] == -1) | (codes[0] == qf[:, :1]))
          & ((qf[:, 1:] == -1) | (codes[1] == qf[:, 1:]))).cpu().numpy()
    err = float(np.abs(score[fin] - bi[fin]).max()) if fin.any() else 0.0
    if err > tol or not ok[fin].all():
        raise AssertionError(f"{what}: rows score their queries {err} off the returned "
                             f"scores; filter misses {int((~ok[fin]).sum())}")


def check_sharded_ivf(torch, np, engine, queries, label: str, smi: str) -> None:
    """(c) on the card: each shard's packing holds each row of its block
    once (bar the tail) with the row's own embedding and codes; the
    burst's fused batch (kernel 3 on each shard) against every shard's
    packing scored by ``ivf_probe_plain`` with the same probe list and
    merged here by a stable descending sort (ties to the lower shard):
    empty slots alike, rows identical wherever neighbouring scores differ
    by more than HNSW_NEAR (the count that differ printed), bi within
    kernel 3's 1e-4; and each returned row scores its query as returned."""
    from financial_rag_system_tpu_torch.index.ivf import ivf_probe_plain
    from financial_rag_system_tpu_torch.ops import fused_query as fq

    idx = engine.index
    flat = idx.flat
    emb, codes, _ = flat._arrays
    p = flat.per_shard
    seen = np.zeros(flat.n_valid, np.int64)
    for i in range(SHARDS):
        gids = idx.packed_gids[i][0]
        live = torch.nonzero(gids >= 0).squeeze(1)
        g = gids[live].long()
        local = g - i * p
        if bool(((local < 0) | (local >= p)).any()):
            raise AssertionError(f"[{label}] shard {i} packs rows outside its block")
        if not (torch.equal(idx.packed_emb[i][live], emb[i][local])
                and torch.equal(idx.packed_codes[i][:, live], codes[i][:, local])):
            raise AssertionError(f"[{label}] shard {i}'s packing differs from its rows")
        np.add.at(seen, g.cpu().numpy(), 1)
    want = np.ones(flat.n_valid, np.int64)
    want[list(idx._tail_rows)] = 0
    if not np.array_equal(seen, want):
        raise AssertionError(f"[{label}] the packings hold {int((seen != want).sum())} rows "
                             f"other than once (tail rows: none)")

    rows, bi, _ = engine_batch(torch, engine, queries)
    args = fused_inputs(torch, engine, queries, "cuda")
    with torch.inference_mode():
        q = fq._prep_queries(fq._embed(engine.embedder.model, *args[:3]),
                             idx.packed_emb[0].dtype)
    tile_ids = fq._probe_tiles(q, idx.centroids, nprobe=idx.nprobe,
                               tiles_per_cluster=idx.tiles_per_cluster,
                               num_tiles=idx.num_tiles_local)
    parts = [ivf_probe_plain(q, args[3], idx.packed_emb[i], idx.packed_codes[i],
                             idx.packed_gids[i], tile_ids, K, tile=idx.tile)
             for i in range(SHARDS)]
    s_all = np.concatenate([x[0].cpu().numpy() for x in parts], axis=1)[: len(queries)]
    r_all = np.concatenate([x[1].cpu().numpy() for x in parts], axis=1)[: len(queries)]
    order = np.argsort(-s_all, axis=1, kind="stable")[:, :K]
    s_ref = np.take_along_axis(s_all, order, 1)
    r_ref = np.where(np.isfinite(s_ref), np.take_along_axis(r_all, order, 1), -1)
    fin = np.isfinite(s_ref)
    if not (np.isfinite(bi) == fin).all():
        raise AssertionError(f"[{label}] the batch's empty slots differ from the plain merge")
    n_diff = rows_where_clear(np, rows, s_ref, r_ref, f"[{label}] kernel 3 vs plain")
    err = float(np.abs(bi[fin] - s_ref[fin]).max())
    if err > 1e-4:
        raise AssertionError(f"[{label}] bi differs from the plain merge by {err}")
    check_row_scores(torch, np, flat, q, args[3], rows, bi, f"[{label}] fused batch", 1e-4)
    log(f"[{label}] {smi}: each shard's packing holds its block's rows once with their "
        f"embeddings and codes; the burst's batch against ivf_probe_plain on the "
        f"{int((tile_ids >= 0).sum())} probed tiles of every shard, merged: rows differing "
        f"{n_diff} of {int(fin.sum())} (only where neighbouring scores lie within {HNSW_NEAR}), "
        f"bi err {err:.3g}; every row scores its query as returned and passes its filter")


def check_sharded_hnsw(torch, np, engine, queries, label: str, smi: str) -> None:
    """(d) on the card: the four graphs on the card are the host stacks;
    the four card walks (``search_device``) against the same graphs and
    rows walked on a CPU mesh, for the burst's vectors with its filters
    and for queries drawn like the corpus: rows identical wherever
    neighbouring scores differ by more than HNSW_NEAR, scores within
    2 * HNSW_NEAR (phase 8's terms); the fused batch as served against
    the card walk alike; each returned row scores its query as returned."""
    from financial_rag_system_tpu_torch.index.hnsw import walk_queries
    from financial_rag_system_tpu_torch.index.sharded import ShardedFlatIndex
    from financial_rag_system_tpu_torch.index.sharded_hnsw import ShardedHNSWIndex
    from financial_rag_system_tpu_torch.ops.fused_query import _embed
    from financial_rag_system_tpu_torch.parallel.mesh import create_mesh

    idx = engine.index
    flat = idx.flat
    adj, ent = idx._graph_state[:2]
    for i in range(SHARDS):
        if not (np.array_equal(adj[i].cpu().numpy(), idx._host_graphs[0][i])
                and np.array_equal(ent[i].cpu().numpy(), idx._host_graphs[1][i])):
            raise AssertionError(f"[{label}] shard {i}'s graph on the card differs from its stack")
    t0 = time.perf_counter()
    twin = ShardedFlatIndex(create_mesh(devices=["cpu"] * SHARDS), flat.dim,
                            capacity=flat.capacity, tile=flat.tile, dtype=flat.dtype)
    twin._arrays = tuple(None if part is None else tuple(x.cpu() for x in part)
                         for part in flat._arrays)
    twin.store = flat.store
    cpu = ShardedHNSWIndex(twin, m=idx.m, ef=idx.ef, frontier=idx.frontier, steps=idx.steps,
                           entries_cap=idx.entries_cap, pool_seeds=idx.pool_seeds,
                           graphs=idx._host_graphs, pools=idx._host_pools)
    setup_s = time.perf_counter() - t0
    args = fused_inputs(torch, engine, queries, "cuda")
    qv = _embed(engine.embedder.model, *args[:3])
    n = len(queries)
    lines = []
    served = engine_batch(torch, engine, queries)
    for what, q, qf in (("the burst's vectors and filters", qv, args[3]),
                        ("queries drawn like the corpus", *near_queries(torch, flat))):
        s_c, r_c = (x.cpu().numpy()[:n] for x in idx.search_device(q, qf, K))
        t0 = time.perf_counter()
        s_h, r_h = (x.numpy()[:n] for x in cpu.search_device(q.cpu(), qf.cpu(), K))
        cpu_s = time.perf_counter() - t0
        fin = np.isfinite(s_h)
        if not (np.isfinite(s_c) == fin).all():
            raise AssertionError(f"[{label}] {what}: empty slots differ card vs CPU")
        n_diff = rows_where_clear(np, r_c, s_h, r_h, f"[{label}] {what}: card vs CPU walks")
        err = float(np.abs(s_c[fin] - s_h[fin]).max())
        if err > 2 * HNSW_NEAR:
            raise AssertionError(f"[{label}] {what}: card vs CPU scores differ by {err}")
        check_row_scores(torch, np, flat, walk_queries(q, flat.dtype), qf, r_c, s_c,
                         f"[{label}] {what}", 1e-4)
        lines.append(f"{what}: rows differing {n_diff} of {int(fin.sum())}, score err "
                     f"{err:.3g} (CPU walk {cpu_s:.1f} s)")
        if qf is args[3]:
            rows, bi, _ = served
            n_srv = rows_where_clear(np, rows, s_c, r_c, f"[{label}] served vs card walk")
            srv_err = float(np.abs(bi[fin] - s_c[fin]).max())
            if not (np.isfinite(bi) == fin).all() or srv_err > 2 * HNSW_NEAR:
                raise AssertionError(f"[{label}] the batch as served differs from the walk: "
                                     f"bi err {srv_err}")
            lines.append(f"the batch as served against the card walk: rows differing {n_srv}, "
                         f"bi err {srv_err:.3g}")
    log(f"[{label}] {smi}: the four card walks against the same graphs walked on a CPU mesh "
        f"(set up in {setup_s:.1f} s), rows compared where neighbouring scores differ by more "
        f"than {HNSW_NEAR}, every row scoring its query as returned: " + "; ".join(lines))


def sharded_ivf_path(torch, np, main: dict, smi: str) -> dict:
    """(c) ``rebuild_index("ivf")`` over phase 4's 1,048,576-row corpus on
    MESH (4 x 262,144 rows): the one codebook, each shard's packing, a
    burst (kernel 3 once a shard), recall@15 against the sharded flat,
    then an upsert (the tail) and an ask that finds it (staged)."""
    from financial_rag_system_tpu_torch.index.sharded_ivf import ShardedIVFIndex
    from financial_rag_system_tpu_torch.serving.engine import RAGEngine
    from financial_rag_system_tpu_torch.utils.config import get_config

    label = "sharded-ivf"
    base = main["engine"]
    t0 = time.perf_counter()
    flat = clustered_flat(torch, np, N_IVF, base.embedder.tokenizer, SEED + 2,
                          torch.device("cuda"))
    sharded = to_sharded(torch, flat, N_IVF, N_IVF)
    del flat
    torch.cuda.synchronize()
    log(f"[{label}] phase 4's {N_IVF} rows made and cut into {SHARDS} shards of "
        f"{sharded.per_shard} in {time.perf_counter() - t0:.1f} s; valid rows a shard "
        f"{shard_valid(sharded)}")
    engine = RAGEngine(get_config(), sharded, base.embedder, base.reranker)
    t0 = time.perf_counter()
    built = engine.rebuild_index("ivf")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    idx = engine.index
    kind = engine.queue_status()["fused_kind"]
    if not isinstance(idx, ShardedIVFIndex) or kind != "ivf_full" or built["tail_rows"]:
        raise AssertionError(f"[{label}] rebuild_index: {built}, fused_kind {kind!r}")
    log(f"[{label}] {smi}: rebuild_index('ivf') {build_s:.2f} s; {idx.n_clusters} clusters, "
        f"nprobe {idx.nprobe}, c_max {idx.c_max}, {idx.num_tiles_local} tiles a shard")
    burst = [(f"{q} (sharded ivf)", t, d) for q, t, d in main["burst"]]
    check_sharded_ivf(torch, np, engine, burst, label, smi)
    sharded_recall(torch, np, engine, burst, label, smi, floor_served=RECALL_FLOOR)
    fresh = [f"fresh filing note {i} ({label}): the board approved a special dividend"
             for i in range(4)]
    launches = serve_sharded_tier(torch, np, engine, smi, label, burst, fresh)
    # the burst: kernel 3 on each shard, kernel 2 on each rerank chunk a
    # layer; the ask after the upsert (a tail row: staged): kernel 3 on
    # each shard and kernel 1 once over the tail rows
    want = want_launches(ivf_probe=2 * SHARDS, masked_topk=1, pair_attention=6 * SHARDS)
    if launches != want or len(idx._tail_rows) != len(fresh):
        raise AssertionError(f"[{label}] launches {launches}, want {want}; tail "
                             f"{idx._tail_rows}")
    return {"engine": engine, "launches": launches, "build_s": build_s}


def sharded_hnsw_path(torch, np, work: Path, smi: str) -> dict:
    """(d) phase 8's 131,072 clustered rows as a sharded_index.npz behind
    ``build_default_engine(mesh_devices=MESH)``, ``rebuild_index("hnsw")``
    (four native graphs of 32,768 rows), a burst, recall@15 against the
    sharded flat, and the four walks' wall time against their device
    time."""
    from financial_rag_system_tpu_torch.index.sharded_hnsw import ShardedHNSWIndex
    from financial_rag_system_tpu_torch.serving.app import build_default_engine
    from financial_rag_system_tpu_torch.utils.config import reset_config

    label = "sharded-hnsw"
    dst = f"{SHARDED_DIR}_hnsw"
    to_sharded_dir(np, work, HNSW_DIR, dst)
    with env_set(INDEX_DIR=str(work / dst), DATABASE_URL=str(work / "cache_sharded.db")):
        reset_config()
        engine = build_default_engine(device="cuda", mesh_devices=MESH)
    t0 = time.perf_counter()
    built = engine.rebuild_index("hnsw")
    build_s = time.perf_counter() - t0
    idx = engine.index
    kind = engine.queue_status()["fused_kind"]
    if not isinstance(idx, ShardedHNSWIndex) or kind != "hnsw_full" or built["tail_rows"]:
        raise AssertionError(f"[{label}] rebuild_index: {built}, fused_kind {kind!r}")
    st = idx._graph_state
    log(f"[{label}] {smi}: rebuild_index('hnsw') {build_s:.2f} s on {os.cpu_count()} host "
        f"threads: {SHARDS} graphs of {st[2]} rows, valid rows a shard {shard_valid(idx.flat)}, "
        f"pool seeds {st[7]}, ef {max(idx.ef, idx.entries_cap + st[7])}, steps {idx.steps}")
    tickers = [f"T{i:02d}" for i in range(HNSW_TICKERS)]
    burst = [(f"sharded hnsw question {i} about segment results", tickers[i % HNSW_TICKERS],
              DOC_TYPES[i % 3] if i % 2 else None) for i in range(B)]
    check_sharded_hnsw(torch, np, engine, burst, label, smi)
    # the burst's questions lie off the clustered corpus and its filters
    # keep 1/8 or 1/24 of the rows: the walk's recall there is reported
    # only (phase 8's single graph: 0.3667 as served)
    sharded_recall(torch, np, engine, burst, label, smi, floor_served=None)
    launches = serve_sharded_tier(torch, np, engine, smi, label, burst)
    want = want_launches(pair_attention=6 * SHARDS)
    if launches != want:
        raise AssertionError(f"[{label}] launches {launches}, want {want}")
    # the walks alone: four shards' torch-op loops, host-bound
    from financial_rag_system_tpu_torch.ops.fused_query import _embed

    args = fused_inputs(torch, engine, burst, "cuda")
    qv = _embed(engine.embedder.model, *args[:3])
    profile_run(torch, lambda: idx.search_device(qv, args[3], K),
                f"sharded HNSW search ({SHARDS} walks)", smi)
    return {"engine": engine, "launches": launches, "build_s": build_s}


def nccl_one_rank_path(torch, np, work: Path, flat_run: dict, smi: str) -> dict:
    """(e) a one-rank NCCL process group (JAX_NUM_PROCESSES=1 on a free
    port) serving (a)'s index through ``attach_control_plane`` (a
    ControlServer with no workers and a BroadcastIndex): a burst whose
    batch goes through the op lock and NCCL's all-gather and psum, rows
    and scores as (a)'s."""
    import torch.distributed as dist

    from financial_rag_system_tpu_torch.parallel.distributed import initialize_distributed
    from financial_rag_system_tpu_torch.serving.app import attach_control_plane, build_default_engine
    from financial_rag_system_tpu_torch.utils.config import get_config, reset_config

    label = "nccl-1-rank"
    env = dict(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}", JAX_NUM_PROCESSES="1",
               JAX_PROCESS_ID="0", FRS_CONTROL_HOST="127.0.0.1",
               FRS_CONTROL_PORT=str(free_port()),
               INDEX_DIR=str(work / f"{SHARDED_DIR}_sharded"),
               DATABASE_URL=str(work / "cache_nccl.db"))
    with env_set(**env):
        reset_config()
        t0 = time.perf_counter()
        if not initialize_distributed():
            raise AssertionError("no process group")
        try:
            engine = build_default_engine(device="cuda", mesh_devices=MESH)
            server = attach_control_plane(engine, get_config())
            try:
                status = engine.queue_status()
                if (dist.get_backend() != "nccl" or not engine.index.inner.mesh.distributed
                        or status["index_tier"] != "Broadcast[ShardedFlatIndex]"
                        or status["fused_kind"] != "full"):
                    raise AssertionError(f"[{label}] {dist.get_backend()} {status}")
                log(f"[{label}] NCCL group of 1, control plane and warm-up in "
                    f"{time.perf_counter() - t0:.1f} s")
                queries = flat_run["burst"]
                hits = engine._fused_batch([q for q, _, _ in queries],
                                           [(t, d) for _, t, d in queries])
                ref = flat_run["engine"]._fused_batch([q for q, _, _ in queries],
                                                      [(t, d) for _, t, d in queries])
                got, want = ([np.asarray([[h[f] for h in hl] for _, hl in out], np.float64)
                              for f in ("row", "score", "rerank_score")] for out in (hits, ref))
                err = [float(np.abs(a - b).max()) for a, b in zip(got[1:], want[1:])]
                if not np.array_equal(got[0], want[0]) or err[0] > 1e-6 or err[1] > 1e-2:
                    raise AssertionError(f"[{label}] the batch differs from (a)'s: score "
                                         f"errors {err}")
                burst = [(f"{q} (nccl)", t, d) for q, t, d in queries]
                launches = serve_sharded_tier(torch, np, engine, smi, label, burst)
                want = want_launches(masked_topk=SHARDS, pair_attention=6 * SHARDS)
                if launches != want:
                    raise AssertionError(f"[{label}] launches {launches}, want {want}")
            finally:
                server.shutdown()
        finally:
            dist.destroy_process_group()
    log(f"[{label}] {smi}: the batch through the BroadcastIndex op lock and NCCL gives (a)'s "
        f"rows; bi and ce errors {err}")
    return {"launches": launches}


def empty_shard_path(torch, np, main: dict, smi: str) -> dict:
    """(f) the phase-3 rows in a sharded index whose capacity is twice the
    corpus: shards 2 and 3 hold no valid rows (kernel 1 runs on them with
    local_valid 0); three asks, and a batch with the single device's rows."""
    from financial_rag_system_tpu_torch.serving.engine import RAGEngine
    from financial_rag_system_tpu_torch.utils.config import get_config

    label = "empty-shards"
    base = main["engine"]
    idx = to_sharded(torch, base.index, N, 2 * N)
    if shard_valid(idx) != [2 * N // SHARDS] * 2 + [0, 0]:
        raise AssertionError(f"[{label}] valid rows a shard {shard_valid(idx)}")
    engine = RAGEngine(get_config(), idx, base.embedder, base.reranker)
    got = engine_batch(torch, engine, main["burst"])
    ref = flat_batch(torch, base, main["burst"], "cuda", base.index,
                     (base.embedder, base.reranker))
    log(f"[{label}] {smi}: valid rows a shard {shard_valid(idx)}; a batch against one "
        f"device's: " + same_rows(np, label, got, ref, bi_tol=1e-6, ce_tol=1e-2))
    launches = serve_sharded_tier(torch, np, engine, smi, label, main["singles"])
    want = want_launches(masked_topk=SHARDS, pair_attention=6 * SHARDS)
    if launches != want:
        raise AssertionError(f"[{label}] launches {launches}, want {want}")
    return {"launches": launches}


def drive_sharded_tier(torch, np, work: Path, main: dict, int8: dict, smi: str) -> list[dict]:
    """Phase 10: (a) bf16 flat, (b) int8 flat, (c) IVF, (d) HNSW, (e) one
    NCCL rank through the control plane, (f) shards with no valid rows;
    each part's seconds."""
    runs = []
    for part, fn in (
        ("a", lambda: sharded_flat_path(torch, np, work, main, smi, "sharded", "index", 1,
                                        exact=False)),
        ("b", lambda: sharded_flat_path(torch, np, work, main, smi, "sharded-int8",
                                        int8["dir"], 1, exact=True)),
        ("c", lambda: sharded_ivf_path(torch, np, main, smi)),
        ("d", lambda: sharded_hnsw_path(torch, np, work, smi)),
        ("e", lambda: nccl_one_rank_path(torch, np, work, runs[0], smi)),
        ("f", lambda: empty_shard_path(torch, np, main, smi)),
    ):
        t0 = time.perf_counter()
        runs.append(fn())
        if part == "a":
            profile_sharded(torch, runs[0], smi)
        log(f"[sharded] part ({part}) took {time.perf_counter() - t0:.1f} s")
        if part in "bcd":
            runs[-1].pop("engine", None)
            runs[-1].pop("single", None)
    return runs


# -- phase 11: the data-parallel trainer, ingestion, trace exports, timing ----------

DP_SHARDS = 4
DP_MESH = ["cuda:0"] * DP_SHARDS   # four data shards on the one card, one after another
DP_BATCH, DP_STEPS, DP_LR = 32, 3, 1e-4   # phase 9's bi-encoder batch and learning rate
DP_LOSS_TOL = 2e-3      # rtol and atol, JAX's test_train.py:78
DP_LEAF_RTOL = 1e-2     # the trainer tests' bound: each gradient leaf within 1e-2 of its norm
INGEST_TICKER, INGEST_FILES = "ZQXW", 3


class GradTap:
    """The trainer's optimizer with its first step's gradients (as the
    step hands them over, after ``pmean``) kept on the CPU by name."""

    def __init__(self, model, lr: float):
        from financial_rag_system_tpu_torch.train.optim import ClippedAdamW

        self.model, self.opt, self.grads = model, ClippedAdamW(model, lr), None

    def step(self):
        if self.grads is None:
            self.grads = {k: p.grad.detach().cpu().clone()
                          for k, p in self.model.named_parameters() if p.grad is not None}
        return self.opt.step()


def dp_batches(n_steps: int, offset: int = 0):
    """``n_steps`` global batches of DP_BATCH filler triples at 64 tokens,
    as phase 9's bi-encoder trains on them."""
    from financial_rag_system_tpu_torch.data.synthetic import make_filler_triples
    from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer
    from financial_rag_system_tpu_torch.train.contrastive import tokenize_pairs

    triples = make_filler_triples(chunk_chars=1000)[offset:offset + n_steps * DP_BATCH]
    tok = Tokenizer()
    return triples, [tokenize_pairs(tok, triples[s * DP_BATCH:(s + 1) * DP_BATCH])
                     for s in range(n_steps)]


def dp_step_check(torch, np, bge_dir: Path, smi: str) -> dict:
    """(a) the data-parallel step on the full-width BGE-small bi-encoder
    (phase 9's trained tower): ``data:4`` over ``[cuda:0] * 4`` (micro-
    batches of 8) against the one-device step from the same weights, three
    steps: each loss within DP_LOSS_TOL, step 1's gradient leaves within
    DP_LEAF_RTOL of their norms (the attention key bias, whose exact
    gradient is zero, within DP_LEAF_RTOL of the whole gradient's norm),
    and the weights after step 3 at JAX's bounds."""
    from financial_rag_system_tpu_torch.models.hf_loader import load_bert_checkpoint
    from financial_rag_system_tpu_torch.parallel.mesh import create_mesh
    from financial_rag_system_tpu_torch.train.contrastive import make_train_step

    _, batches = dp_batches(DP_STEPS)
    mesh = create_mesh(f"data:{DP_SHARDS}", devices=DP_MESH)
    out = {}
    for label, m in (("one device", None), (f"data:{DP_SHARDS}", mesh)):
        model, _ = load_bert_checkpoint(str(bge_dir), device="cuda")
        tap = GradTap(model, DP_LR)
        step = make_train_step(model, tap, temperature=0.05, neg_weight=0.5, mesh=m)
        losses, ms = [], []
        for batch in batches:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(*batch)
            end.record()
            torch.cuda.synchronize()
            losses.append(float(loss))
            ms.append(start.elapsed_time(end))
        out[label] = {"losses": losses, "ms": ms, "grads": tap.grads,
                      "weights": {k: v.detach().cpu() for k, v in model.state_dict().items()}}
    one, dp = out["one device"], out[f"data:{DP_SHARDS}"]
    if not np.allclose(dp["losses"], one["losses"], rtol=DP_LOSS_TOL, atol=DP_LOSS_TOL):
        raise AssertionError(f"[dp] losses {dp['losses']} against {one['losses']}")
    g1, g2 = one["grads"], dp["grads"]
    if g1.keys() != g2.keys():
        raise AssertionError(f"[dp] gradients of {set(g1) ^ set(g2)} on one side only")
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in g1.values())))
    worst = (0.0, "")
    for k in g1:
        err = float((g2[k] - g1[k]).double().norm())
        norm = total if k.endswith("k.bias") else float(g1[k].double().norm())
        worst = max(worst, (err / norm, k))
    if worst[0] > DP_LEAF_RTOL:
        raise AssertionError(f"[dp] step 1 gradient leaf {worst[1]} at {worst[0]:.3e}")
    w_err, w_cos = 0.0, 1.0
    for k, a in one["weights"].items():
        a, b = a.double(), dp["weights"][k].double()
        w_err = max(w_err, float((a - b).abs().max()))
        na, nb = float(a.norm()), float(b.norm())
        if na > 0.5 and nb > 0.5:
            w_cos = min(w_cos, float((a.ravel() @ b.ravel()) / (na * nb)))
    if w_err >= 5e-2 or w_cos <= 0.995:
        raise AssertionError(f"[dp] weights after {DP_STEPS} steps: max abs {w_err}, "
                             f"cosine {w_cos}")
    log(f"[dp] {smi}: data:{DP_SHARDS} over {DP_MESH} (micro-batches of "
        f"{DP_BATCH // DP_SHARDS}) against one device, BGE-small at full width, "
        f"{DP_BATCH} triples at 64 tokens, w 0.5, lr {DP_LR}: losses {dp['losses']} vs "
        f"{one['losses']}; step 1's worst gradient leaf {worst[1]} at {worst[0]:.3e} of its "
        f"norm (tolerance {DP_LEAF_RTOL}); weights after {DP_STEPS} steps max abs {w_err:.3e}, "
        f"min cosine {w_cos:.6f}")
    log(f"[dp] {smi}: step times (CUDA events, median of {DP_STEPS}): one device "
        f"{statistics.median(one['ms']):.2f} ms {one['ms']}, data:{DP_SHARDS} "
        f"{statistics.median(dp['ms']):.2f} ms {dp['ms']}")
    return {"one_ms": statistics.median(one["ms"]), "dp_ms": statistics.median(dp["ms"])}


def dp_nccl_check(torch, np, bge_dir: Path, work: Path, smi: str) -> None:
    """(b) a one-rank NCCL group with the ``data`` axis over the ranks:
    three steps of ``train(mesh=...)`` (rank 0 writes a checkpoint after
    each, behind a barrier) bit for bit with ``train()`` without a mesh."""
    import torch.distributed as dist

    from financial_rag_system_tpu_torch.models.hf_loader import load_bert_checkpoint
    from financial_rag_system_tpu_torch.parallel.distributed import initialize_distributed
    from financial_rag_system_tpu_torch.parallel.mesh import AXIS_DATA, create_mesh
    from financial_rag_system_tpu_torch.train.checkpoint import latest_step
    from financial_rag_system_tpu_torch.train.contrastive import train

    triples, _ = dp_batches(DP_STEPS, offset=DP_STEPS * DP_BATCH)
    kw = dict(batch_size=DP_BATCH, lr=DP_LR, neg_weight=0.5, seed=3)
    ref, ref_losses = train(load_bert_checkpoint(str(bge_dir), device="cuda")[0], triples, **kw)
    with env_set(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}", JAX_NUM_PROCESSES="1",
                 JAX_PROCESS_ID="0"):
        if not initialize_distributed():
            raise AssertionError("no process group")
        try:
            mesh = create_mesh("data:1", devices=["cuda:0"], ranks_axis=AXIS_DATA)
            if dist.get_backend() != "nccl" or not mesh.data_distributed:
                raise AssertionError(f"[dp-nccl] {dist.get_backend()} {mesh}")
            ckpt = work / "dp_nccl_ckpt"
            got, losses = train(load_bert_checkpoint(str(bge_dir), device="cuda")[0], triples,
                                mesh=mesh, checkpoint_dir=str(ckpt), checkpoint_every=1, **kw)
        finally:
            dist.destroy_process_group()
    if latest_step(str(ckpt)) != DP_STEPS:
        raise AssertionError(f"[dp-nccl] checkpoint at step {latest_step(str(ckpt))}")
    same = losses == ref_losses and all(
        torch.equal(v, got.state_dict()[k]) for k, v in ref.state_dict().items())
    if not same:
        raise AssertionError(f"[dp-nccl] losses {losses} against {ref_losses}, or weights differ")
    log(f"[dp-nccl] {smi}: {DP_STEPS} steps of train(mesh=data:1 over a one-rank NCCL group, "
        f"checkpoint after each) bit for bit with train() without a mesh: losses {losses}")


def filing_texts(np, n_files: int) -> list[str]:
    """Seeded filings of INGEST_TICKER: paragraphs of segment notes."""
    rng = np.random.default_rng(SEED + 11)
    words = ["revenue", "margin", "widget", "segment", "backlog", "guidance", "liquidity",
             "capital", "expenditure", "inventory", "demand", "pricing", "contract"]
    out = []
    for f in range(n_files):
        paras = []
        for p in range(12):
            body = " ".join(rng.choice(words, 60))
            paras.append(f"{INGEST_TICKER} filing {f} note {p}: the quiet widget segment "
                         f"reported {body}.")
        out.append("\n\n".join(paras))
    return out


def ingest_path(torch, np, work: Path, smi: str) -> dict:
    """(c) ``data/ingest.ingest_files`` of INGEST_FILES seeded ``.txt``
    filings of a new ticker into a new engine over phase 3's checkpoints
    and index (the port's embedder, EMBED_BATCH and UPSERT_BATCH as the
    reference's): the new rows, a re-ingest that adds none (md5 point
    ids), the ticker's cache entries cleared, and two asks for the ticker
    (one fused batch each: kernel 1 once, kernel 2 once a rerank layer)
    whose sources are ingested chunks."""
    from financial_rag_system_tpu_torch.data.ingest import (
        EMBED_BATCH,
        UPSERT_BATCH,
        chunks_from_file,
        ingest_files,
    )
    from financial_rag_system_tpu_torch.obs.tracing import get_tracer
    from financial_rag_system_tpu_torch.serving.app import build_default_engine
    from financial_rag_system_tpu_torch.utils.config import reset_config

    label = "ingest"
    folder = work / "filings"
    folder.mkdir()
    paths = []
    for i, text in enumerate(filing_texts(np, INGEST_FILES)):
        paths.append(str(folder / f"{INGEST_TICKER.lower()}_10k_{i}.txt"))
        Path(paths[-1]).write_text(text)
    batches = [chunks_from_file(p, INGEST_TICKER, "10-K") for p in paths]
    texts = {t for b in batches for t in b.texts}
    n_chunks = sum(len(b.ids) for b in batches)
    with env_set(RAG_TPU_BGE_DIR=str(work / "bge"), RAG_TPU_RERANKER_DIR=str(work / "reranker"),
                 INDEX_DIR=str(work / "index"), TESTING="true",
                 DATABASE_URL=str(work / "cache_ingest.db"),
                 RAG_TPU_CB_PATH=str(work / "breaker_ingest.json"),
                 RAG_TPU_BATCH_WINDOW_S="0.01", RAG_TPU_BATCH_EAGER_IDLE_S="0"):
        reset_config()
        engine = build_default_engine(device="cuda")
        before = engine.index.n_valid
        engine.cache.save("probe-hash", INGEST_TICKER, "an old question", "an old answer")
        engine.cache.save("other-hash", "T03", "an old question", "an old answer")
        get_tracer().reset()  # (d) reads this run's traces
        reset_launches()
        t0 = time.perf_counter()
        new_rows = ingest_files(engine.index, engine.embedder, INGEST_TICKER, "10-K", paths,
                                cache=engine.cache)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        again = ingest_files(engine.index, engine.embedder, INGEST_TICKER, "10-K", paths)
        ingest_launches = read_launches()
        if (new_rows != n_chunks or again != 0 or engine.index.n_valid != before + new_rows
                or engine.cache.lookup("probe-hash", INGEST_TICKER) is not None
                or engine.cache.lookup("other-hash", "T03") != "an old answer"):
            raise AssertionError(f"[{label}] {new_rows} new rows of {n_chunks} chunks, "
                                 f"re-ingest {again}, rows {before} -> {engine.index.n_valid}")
        asks = [(f"what did {INGEST_TICKER} say about widget segment backlog", None),
                (f"{INGEST_TICKER} liquidity and capital expenditure guidance", "10-K")]

        async def scenario():
            await engine.startup()
            try:
                return [await engine.ask(q, INGEST_TICKER, 5, d) for q, d in asks]
            finally:
                await engine.shutdown()

        answers = asyncio.run(scenario())
        launches = read_launches()
    reset_config()
    check_answers(np, answers, 5)
    for a in answers:
        if not all(s["text"] in texts for s in a["sources"]):
            raise AssertionError(f"[{label}] a source is not an ingested chunk: {a['sources']}")
    # the asks: one fused batch each (kernel 1 once, kernel 2 once a rerank
    # layer); the ingest embeds its chunks, whose padded length may reach
    # the attention gate's 256 (kernel 2 once an embed layer then)
    asked = {k: launches[k] - ingest_launches[k] for k in launches}
    want = want_launches(masked_topk=len(asks), pair_attention=6 * len(asks))
    if asked != want or any(v for k, v in ingest_launches.items() if k != "pair_attention"):
        raise AssertionError(f"[{label}] launches {ingest_launches} ingesting, {asked} asking; "
                             f"want {want} asking")
    log(f"[{label}] {smi}: {new_rows} new rows from {INGEST_FILES} filings of {INGEST_TICKER} "
        f"(EMBED_BATCH {EMBED_BATCH}, UPSERT_BATCH {UPSERT_BATCH}) in {ingest_s:.2f} s; rows "
        f"{before} -> {engine.index.n_valid}; re-ingest added {again}; the ticker's cache entry "
        f"cleared; {len(asks)} asks, each source an ingested chunk (top "
        f"{answers[0]['sources'][0]['text'][:60]!r}); launches {ingest_launches} ingesting, "
        f"{asked} asking")
    return {"launches": launches, "answers": answers}


def trace_export_check(smi: str) -> None:
    """(d) the trace-export pump over (c)'s traces with an in-memory sink:
    only complete traces ship (each with its root; a child whose root is
    still open waits), and their OTLP and MLflow encodings hold every
    shipped span.  No sink of the environment is wired, so nothing goes
    to the network."""
    from financial_rag_system_tpu_torch.obs.export_loop import TraceExportLoop, env_sinks
    from financial_rag_system_tpu_torch.obs.mlflow_export import to_mlflow_traces
    from financial_rag_system_tpu_torch.obs.otlp_export import to_otlp
    from financial_rag_system_tpu_torch.obs.tracing import get_tracer

    if env_sinks():
        raise AssertionError("[traces] the environment wires a sink")
    tracer = get_tracer()
    shipped: list[list[dict]] = []
    loop = TraceExportLoop(tracer, [lambda spans: shipped.append(spans) or True])
    with tracer.span("phase11_probe", kind="CHAIN"):
        with tracer.span("phase11_child"):
            pass
        n_open = loop.pump_once()
        held = sum(len(v) for v in loop._pending.values())
    n = loop.pump_once()
    spans = [d for batch in shipped for d in batch]
    if n_open + n != len(spans) or not spans:
        raise AssertionError(f"[traces] shipped {n_open} + {n}, sink saw {len(spans)}")
    by_trace: dict[str, list[dict]] = collections.defaultdict(list)
    for d in spans:
        by_trace[d["trace_id"]].append(d)
    rootless = [t for t, group in by_trace.items() if not any(not d.get("parent_id")
                                                              for d in group)]
    if rootless or held < 1:
        raise AssertionError(f"[traces] traces without their root {rootless}; held {held}")
    otlp = to_otlp(spans)["resourceSpans"][0]["scopeSpans"][0]["spans"]
    mlflow = to_mlflow_traces(spans)
    if (len(otlp) != len(spans) or len(mlflow) != len(by_trace)
            or sum(len(t["data"]["spans"]) for t in mlflow) != len(spans)):
        raise AssertionError("[traces] the encodings lost spans")
    names = collections.Counter(d["name"] for d in spans if not d.get("parent_id"))
    log(f"[traces] {smi}: the pump shipped {len(spans)} spans of {len(by_trace)} complete "
        f"traces ({n_open} while a root was open, {held} child span held until its root "
        f"finished); roots {dict(names)}; OTLP {len(otlp)} spans, MLflow {len(mlflow)} traces; "
        f"{len(loop._pending)} traces pending; no sink of the environment")


def timing_check(torch, main: dict, smi: str) -> dict:
    """(e) ``utils/timing`` on the phase-3 fused batch of 32: one call
    with its outputs fetched (``fetched_ms``), and four in flight
    (``sustained_ms(depth=4)``).  Reported, not gated."""
    from financial_rag_system_tpu_torch.ops.fused_query import fused_two_stage
    from financial_rag_system_tpu_torch.utils.timing import fetched_ms, sustained_ms

    engine = main["engine"]
    emb, codes, dtok = engine.index._arrays
    args = fused_inputs(torch, engine, main["burst"], "cuda")

    def batch():
        return fused_two_stage(engine.embedder.model, engine.reranker.model, *args, emb, codes,
                               dtok, N, rerank_cfg=engine.reranker.cfg, k=K)

    with torch.inference_mode():
        fetched = fetched_ms(batch)
        sustained = sustained_ms(batch, depth=4)
    log(f"[timing] {smi}: the phase-3 fused batch of {B} (flat, {N} rows): fetched_ms "
        f"{fetched:.3f} (20 calls, outputs fetched each), sustained_ms(depth=4) "
        f"{sustained:.3f} (40 calls, four in flight)")
    return {"fetched_ms": fetched, "sustained_ms": sustained}


def drive_phase_11(torch, np, work: Path, main: dict, bge_dir: Path, smi: str) -> list[dict]:
    """Phase 11: (a) the data-parallel step, (b) one NCCL rank with
    ``data`` over the ranks, (c) ingestion, (d) trace exports, (e) timing;
    each part's seconds.  Returns (c)'s run for the launch counts."""
    runs = []
    for part, fn in (
        ("a", lambda: dp_step_check(torch, np, bge_dir, smi)),
        ("b", lambda: dp_nccl_check(torch, np, bge_dir, work, smi)),
        ("c", lambda: runs.append(ingest_path(torch, np, work, smi))),
        ("d", lambda: trace_export_check(smi)),
        ("e", lambda: timing_check(torch, main, smi)),
    ):
        t0 = time.perf_counter()
        fn()
        log(f"[phase-11] part ({part}) took {time.perf_counter() - t0:.1f} s")
    return runs


# -- phase 12: the flash-attention path (RAG_TPU_FLASH) ---------------------------

# the served flash path: the flash gate on, the pair-attention gate off (it
# comes first at S >= 256, as in JAX's encode)
FLASH_ENV = {"RAG_TPU_FLASH": "1", "RAG_TPU_PAIR_ATTN": "0"}
FLASH_SEQ = 512  # kernel 7's longest S, where (a) times its other widths


def flash_len(main: dict) -> int:
    """The rerank pairs' length on the flash path: phase 3's 400 tokens
    rounded up to the 128-key blocks, 512."""
    return -(-(main["lq"] + DLEN) // 128) * 128


def segment_pairs(np, mask_np) -> float:
    """The (query, key) pairs that share a segment id, over all pairs: the
    keys the function attends (a pad row attends the pad keys)."""
    total = 0
    for row in mask_np:
        _, counts = np.unique(row, return_counts=True)
        total += int((counts.astype(np.int64) ** 2).sum())
    return float(total)


def flash_bound(torch, np, mask_np, h: int, d: int) -> tuple[float, str, float]:
    """Kernel 7's bound on one mask: q, k and v in and the context out in
    bf16 for every row (every key is attended by the rows of its
    segment), the segment ids; QK^T and P.V over the (query, key) pairs
    that share a segment.  And its MUFU floor: one exponential a pair
    (:func:`mufu_ms`)."""
    p, s = mask_np.shape
    pairs = segment_pairs(np, mask_np)
    b_ms, b_by = bound_ms(4 * p * s * h * d * 2 + p * s * 4, 4.0 * h * d * pairs)
    return b_ms, b_by, mufu_ms(torch, h * pairs)


def flash_skip_share(np, mask_np) -> float:
    """The share of (pair, 64-row tile, 128-key block) pairs that kernel 7's
    skip rule leaves out on a mask: no query row of the tile shares a
    segment id with any key of the block.  Worked out from the mask, not
    counted in the kernel."""
    p, s = mask_np.shape
    ids = np.unique(mask_np)
    onehot = mask_np[:, :, None] == ids[None, None, :]          # (P, S, ids)
    tiles = onehot.reshape(p, s // 64, 64, -1).any(axis=2)      # (P, tiles, ids)
    blocks = onehot.reshape(p, s // 128, 128, -1).any(axis=2)   # (P, blocks, ids)
    need = (tiles[:, :, None, :] & blocks[:, None, :, :]).any(axis=-1)
    return float(1.0 - need.mean())


def ptxas_kernels(text: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from the output of ``nvcc -Xptxas -v``."""
    report, kernel = {}, None
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            kernel = entry.group(1)
            report[kernel] = [0, 0, 0]
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills and kernel:
            report[kernel][1:] = [int(spills.group(1)), int(spills.group(2))]
        regs = re.search(r"Used (\d+) registers", line)
        if regs and kernel:
            report[kernel][0] = int(regs.group(1))
    return {k: tuple(v) for k, v in report.items()}


PTXAS_SOURCES = ("pair_attention", "flash_attention", "flash_attention_bwd", "masked_topk",
                 "ivf_probe")
_ptxas_runs: dict = {}  # name: its nvcc -Xptxas -v process, started by start_ptxas_reports


def start_ptxas(name: str):
    """``csrc/<name>.cu`` compiled with ``nvcc -Xptxas -v`` into a scratch
    library beside the build, in the background."""
    from financial_rag_system_tpu_torch.ops import _cuda

    out = _cuda.BUILD_DIR.parent / "torch_kernels_ptxas" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
                             str(_cuda.CSRC_DIR / f"{name}.cu")], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def start_ptxas_reports() -> None:
    """Start the ``-Xptxas -v`` compiles the checks read (PTXAS_SOURCES)
    beside phase 1's build, one process each, so that no phase waits on
    one compile after another."""
    atexit.register(stop_ptxas_reports)  # none outlives the run, whatever ends it
    for name in PTXAS_SOURCES:
        _ptxas_runs[name] = start_ptxas(name)


def stop_ptxas_reports() -> None:
    for proc in _ptxas_runs.values():
        proc.kill()
        proc.wait()
    _ptxas_runs.clear()


def ptxas_report(name: str) -> dict:
    """:func:`ptxas_kernels` of ``csrc/<name>.cu``'s ``nvcc -Xptxas -v``
    (the compile started beside phase 1, or now)."""
    proc = _ptxas_runs.pop(name, None) or start_ptxas(name)
    out = proc.communicate(timeout=600)[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc -Xptxas -v of csrc/{name}.cu failed:\n{out}")
    return ptxas_kernels(out)


def time_flash(torch, np, smi: str, label: str, q, k, v, mask_np, baseline=None,
               exact: bool = False, chunk: int | None = None) -> dict:
    """Kernel 7 on one mask: against its plain version on every row (pad
    rows and all-padding pairs included) at 1e-2, then its CUDA-event
    median, its device time (profiler), the plain version's time, SDPA's
    with the boolean segment-equality mask (a yardstick; the port never
    calls it), its bound, MUFU floor and the share its skip rule leaves
    out (from the mask).  With ``baseline``
    (an earlier build of the kernel, ``--flash-baseline``): the largest
    difference between its context and this kernel's on the same inputs,
    both timed in turns (old, new, new, old) and both device times; with
    ``exact`` the two contexts must be equal bit for bit.  ``chunk``: the
    plain version runs that many pairs at a time."""
    from financial_rag_system_tpu_torch.ops import flash_attention as fa

    p, s, h, d = q.shape
    mask = torch.tensor(mask_np, device=q.device)
    inv = 1.0 / d ** 0.5
    plain = in_chunks(torch, fa.flash_attention_plain, q, k, v, mask, inv, chunk)
    got = fa.encoder_flash_attention(q, k, v, mask, inv)
    torch.cuda.synchronize()
    ref = plain()
    if not torch.isfinite(got).all():
        raise AssertionError(f"flash attention, {label}: non-finite output")
    err = float((got - ref).abs().max())
    del got, ref
    if err > 1e-2:
        raise AssertionError(f"flash attention, {label}: differs from its plain version by "
                             f"{err} > 1e-2")
    qb, kb, vb = fa.kernel_inputs(q, k, v)
    seg = mask.to(torch.int32)

    def kernel():
        return fa.flash_attention_kernel(qb, kb, vb, seg, inv)

    ms = median_ms(kernel, reps=20)
    dp = qb.shape[-1]
    dev = device_ms(torch, kernel, "slab_kernel" if dp > 256 else
                    "long_kernel" if fa.launch_counter(dp, s) == "launches_long" else "flash")
    plain_ms = median_ms(plain, reps=3, warmup=1)
    qh, kh, vh = (t.transpose(1, 2) for t in (qb, kb, vb))
    same = seg[:, None, :, None] == seg[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = median_ms(lambda: sdpa(qh, kh, vh, attn_mask=same, scale=inv), reps=10)
    del same
    b_ms, b_by, mufu = flash_bound(torch, np, mask_np, h, d)
    line = (f"[flash] {smi}: {label}, P={p} S={s} H={h} d={d}: max_abs_err {err:.3g}, kernel "
            f"{ms:.4f} ms (device {dev:.4f} ms), plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} "
            f"ms, bound {b_ms:.4f} ms ({b_by}), MUFU floor {mufu:.4f} ms, kernel at "
            f"{b_ms / ms:.3f} of its bound; (tile, block) pairs skippable by the rule "
            f"{flash_skip_share(np, mask_np):.4f}")
    if baseline is not None:
        new = kernel()
        with kernel_lib("flash_attention", baseline):
            old = kernel()
            torch.cuda.synchronize()
            old_dev = device_ms(torch, kernel, "kernel")
        diff = float((new.float() - old.float()).abs().max())
        del new, old
        if exact and diff != 0.0:
            raise AssertionError(f"flash attention, {label}, S={s} d={d}: the context differs "
                                 f"from the baseline build's by {diff}")

        def old_ms():
            with kernel_lib("flash_attention", baseline):
                return median_ms(kernel, reps=20)

        turns = [old_ms(), median_ms(kernel, reps=20), median_ms(kernel, reps=20), old_ms()]
        line += (f"; baseline: context max abs diff {diff:.3g}, old, new, new, old "
                 f"{[round(t, 4) for t in turns]} ms, device old {old_dev:.4f} ms")
    log(line)
    return {"max_abs_err": err, "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def check_flash_kernel(torch, np, main: dict, smi: str, baseline=None) -> list:
    """(a) kernel 7 against its plain version and timed: at the served
    shape (P 480, S 512, 12 heads of 32) on phase 3's rerank mask padded
    to 512 (the kernels line's numbers), and on that mask at 3 heads of
    256 (``d256::flash256_kernel``, the line's ``flash_attention_wide``);
    on the uniform-length mask (pair 0 whole, the last pair all padding)
    at S 512; at S 128 and 256; at heads of 64
    (12) and 128 (6) at S 512; ``baseline`` (``--flash-baseline``)
    timed beside it at each.  Then ``-Xptxas -v`` of its source: no
    kernel of it (``flash_kernel<D>`` at heads of 32-128, the D-256
    kernel) may spill.  Returns the ``kernels`` line's two entries."""
    plen, s = main["lq"] + DLEN, flash_len(main)
    served = np.pad(rerank_batch_mask(torch, np, main), ((0, 0), (0, s - plen)))
    q, k, v, _ = attention_inputs(torch, np, PAIRS, s)
    res = time_flash(torch, np, smi, f"phase-3 rerank mask padded to {s}", q, k, v, served,
                     baseline)
    # D 256 on the served mask, 3 heads (phase 14's width)
    q, k, v, _ = attention_inputs(torch, np, PAIRS, s, 3, 256)
    wide = time_flash(torch, np, smi, f"phase-3 rerank mask padded to {s}", q, k, v, served,
                      baseline)
    for s, h, d in ((FLASH_SEQ, 12, 32), (128, 12, 32), (256, 12, 32), (FLASH_SEQ, 12, 64),
                    (FLASH_SEQ, 6, 128)):
        q, k, v, mask_np = attention_inputs(torch, np, PAIRS, s, h, d)
        time_flash(torch, np, smi, "uniform-length mask", q, k, v, mask_np, baseline)
    del q, k, v
    report = ptxas_report("flash_attention")
    log(f"[flash] ptxas -v of csrc/flash_attention.cu (registers, spill store and load bytes): "
        f"{report}")
    ring = [k for k in report if "12flash_kernel" in k]
    d256 = [k for k in report if "15flash256_kernel" in k]
    slab = [k for k in report if "11slab_kernel" in k]
    long_row = [k for k in report if "11long_kernel" in k]
    if (len(ring) != 3 or len(d256) != 2 or len(slab) != 6 or len(long_row) != 1
            or any(r[1] or r[2] for r in report.values())):
        raise AssertionError(f"[flash] a kernel-7 kernel spills, or ptxas named other kernels: "
                             f"{report}")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    entry = {"route": "cuda", "source": f"{PACKAGE}/csrc/flash_attention.cu",
             "replaces": "financial_rag_system_tpu/models/bert.py:160"}
    return [{"name": "flash_attention", **entry, **{key: res[key] for key in keys}},
            {"name": "flash_attention_wide", **entry, **{key: wide[key] for key in keys}}]


def attention_calls(torch, fn):
    """``fn()`` with the launches of kernels 2 and 7 it made and the
    sequence lengths kernel 2 saw."""
    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.ops.attention import encoder_self_attention
    from financial_rag_system_tpu_torch.ops.flash_attention import encoder_flash_attention

    seqs = []
    original = bert.encoder_self_attention

    def spy(q, *args, **kwargs):
        seqs.append(q.shape[1])
        return original(q, *args, **kwargs)

    n2, n7 = encoder_self_attention.launches, encoder_flash_attention.launches
    bert.encoder_self_attention = spy
    try:
        out = fn()
    finally:
        bert.encoder_self_attention = original
    return (out, encoder_self_attention.launches - n2, encoder_flash_attention.launches - n7,
            sorted(set(seqs)))


def check_flash_batches(torch, np, run: dict, main: dict, cpu_models, smi: str) -> None:
    """(b) the flat batch of 32 on the flash path against phase 3's default
    batch (rows and bi scores identical, logits within compare_batches'
    5e-2) and, for 2 queries, against the port on the CPU under the same
    variables; kernel 7 six times a batch and kernel 2 never; both
    batches profiled.  (c) ``RAG_TPU_FLASH=1`` alone: the pairs pad to 512
    and kernel 2 takes them (6 launches at S 512, kernel 7 none), its
    logits against (b)'s."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.utils.config import get_config

    engine = run["engine"]
    card = (engine.embedder, engine.reranker)

    def batch(queries=main["burst"]):
        return flat_batch(torch, engine, queries, "cuda", engine.index, card)

    default, n2, n7, _ = attention_calls(torch, batch)
    if (n2, n7) != (6, 0):
        raise AssertionError(f"the default batch launched kernel 2 {n2} and kernel 7 {n7} times")
    with env_set(**FLASH_ENV):
        flash, n2, n7, _ = attention_calls(torch, batch)
    if (n2, n7) != (0, 6):
        raise AssertionError(f"the flash batch launched kernel 2 {n2} and kernel 7 {n7} times")
    if not (np.array_equal(flash[0], default[0]) and np.array_equal(flash[1], default[1])):
        raise AssertionError("[flash] rows or bi scores differ from the default batch's")
    compare_batches(np, "[flash] card, flash path vs phase 3's default batch", flash, default)
    queries = main["burst"][:2]
    cpu_index = FlatIndex.load(get_config().index_dir, device="cpu")
    with env_set(**FLASH_ENV):
        got = batch(queries)
        with env_set(**CPU_TANH):
            ref = flat_batch(torch, engine, queries, "cpu", cpu_index, cpu_models)
    compare_batches(np, "[flash] card vs CPU (plain versions), both on the flash path", got, ref)
    with env_set(RAG_TPU_FLASH="1"):
        alone, n2, n7, seqs = attention_calls(torch, batch)
    if (n2, n7, seqs) != (6, 0, [flash_len(main)]):
        raise AssertionError(f"RAG_TPU_FLASH=1 alone: kernel 2 {n2} times at S {seqs}, "
                             f"kernel 7 {n7} times")
    if not np.array_equal(alone[0], flash[0]):
        raise AssertionError("[flash] RAG_TPU_FLASH=1 alone gave other rows")
    compare_batches(np, "[flash] card, kernel 2 at S 512 (RAG_TPU_FLASH=1 alone) vs the "
                    "flash path", alone, flash)
    log(f"[flash] {smi}: launches a batch: default (kernel 2, S {main['lq'] + DLEN}) 6 / 0, "
        f"flash path 0 / 6, RAG_TPU_FLASH=1 alone 6 / 0 at S {seqs}")
    profile_batch(torch, main, smi, "fused_two_stage, default (kernel 2)")
    with env_set(**FLASH_ENV):
        profile_batch(torch, main, smi, "fused_two_stage, flash path (kernel 7)")
    with env_set(RAG_TPU_FLASH="1"):
        profile_batch(torch, main, smi, "fused_two_stage, RAG_TPU_FLASH=1 alone (kernel 2 at "
                      "the padded length)")


def check_flash_graded(torch, np, run: dict, smi: str) -> None:
    """(d) a graded cross-encoder step at full width under both variables:
    the graded forward takes the flash attention with its backward,
    kernel 7 six times and kernels 8 and 9 six times each, and
    the loss and gradients stay within phase 9's tolerances of the step
    without the variables (the einsum path; :func:`compare_steps`)."""
    from financial_rag_system_tpu_torch.models import bert

    served = run["engine"].reranker.model
    rows = train_rows(torch, np, FLASH_SEQ)
    lr, out = 1e-4, {}
    for key, env in (("einsum", {}), ("flash", FLASH_ENV)):
        model = bert.BertModel(served.cfg, device="cuda")
        model.load_state_dict(served.state_dict())
        with env_set(**env):
            n0 = flash_step_launches()
            out[key] = step_objective(torch, model, "bce", rows, lr)
            launched = tuple(b - a for a, b in zip(n0, flash_step_launches()))
        want = (6, 6, 6) if key == "flash" else (0, 0, 0)
        if launched != want:
            raise AssertionError(f"[flash] graded step ({key}): kernels 7, 8 and 9 launched "
                                 f"{launched} times (want {want})")
        del model
    c = compare_steps(torch, lr, out["flash"], out["einsum"])
    if c["loss_rel"] > TRAIN_LOSS_RTOL or c["grad_rel"] > TRAIN_GRAD_TOL:
        raise AssertionError(f"[flash] graded step: loss {out['flash'][0]} against "
                             f"{out['einsum'][0]}, gradients {c['grad_rel']} of their norm")
    log(f"[flash] {smi}: a graded cross-encoder step at S {rows['pairs'][0].shape[1]} under "
        f"{FLASH_ENV}: kernels 7, 8 and 9 six times each; loss {out['flash'][0]:.6f} against "
        f"{out['einsum'][0]:.6f} without the variables (rel {c['loss_rel']:.2e}), gradients "
        f"{c['grad_rel']:.2e} of their norm")


def check_flash_staged(torch, np, run: dict, smi: str) -> None:
    """(e) the staged reranker (``CrossEncoderReranker.score``) at the 128
    bucket under ``RAG_TPU_FLASH=1`` with pair attention on ``auto``:
    kernel 7 six times (one chunk of pairs), kernel 2 never; the logits
    against the same call without the variable (the einsum path)."""
    reranker = run["engine"].reranker
    texts = [f"segment {i} revenue rose while operating margin and liquidity "
             f"improved in the quarter " * (1 + i % 3) for i in range(12)]

    def score():
        return reranker.score("what was revenue growth in the last quarter", texts)

    plain, n2, n7, _ = attention_calls(torch, score)
    with env_set(RAG_TPU_FLASH="1"):
        flash, n2f, n7f, _ = attention_calls(torch, score)
    if (n2, n7, n2f, n7f) != (0, 0, 0, 6):
        raise AssertionError(f"[flash] staged: kernels 2 and 7 launched {n2}, {n7} without and "
                             f"{n2f}, {n7f} with RAG_TPU_FLASH=1")
    err = float(np.abs(flash - plain).max())
    if err > 5e-2:
        raise AssertionError(f"[flash] staged logits differ from the einsum path's by {err}")
    log(f"[flash] {smi}: staged reranker, {len(texts)} pairs at the 128 bucket under "
        f"RAG_TPU_FLASH=1: kernel 7 {n7f} launches, kernel 2 {n2f}; logits within {err:.3g} "
        f"of the einsum path's")


def drive_phase_12(torch, np, work: Path, main: dict, cpu_models, smi: str,
                   kernels: list, baseline=None) -> dict:
    """Phase 12: (a) kernel 7 against its plain version and timed, (b) the
    flat tier served on the flash path (``FLASH_ENV``: a new engine over
    phase 3's checkpoints and index, 3 asks, a burst of 32, a cache hit,
    kernel 7 six times a batch) and its batch checks, (c) the flash
    variable alone, (d) a graded step, (e) the staged reranker; each
    part's seconds.  Returns (b)'s run for the launch counts."""
    runs = {}

    def serve():
        with env_set(**FLASH_ENV):
            runs["b"] = drive_main_path(torch, np, work, smi, label="flash", rounds=1,
                                        attention="flash_attention")

    for part, fn in (
        ("a", lambda: kernels.extend(check_flash_kernel(torch, np, main, smi, baseline))),
        ("b", serve),
        ("b-c", lambda: check_flash_batches(torch, np, runs["b"], main, cpu_models, smi)),
        ("d", lambda: check_flash_graded(torch, np, runs["b"], smi)),
        ("e", lambda: check_flash_staged(torch, np, runs["b"], smi)),
    ):
        t0 = time.perf_counter()
        fn()
        log(f"[phase-12] part ({part}) took {time.perf_counter() - t0:.1f} s")
    del runs["b"]["engine"]
    return runs["b"]


# -- phase 13: a BERT-base-shaped reranker (kernel 2's ring kernel) -------------------

# google-bert/bert-base-uncased's config.json (hidden 768, 12 layers, 12
# heads of 64, intermediate 3072, vocab 30522, 512 positions), with a
# pooler and a one-logit classifier: the shape of the BERT-base MS MARCO
# cross-encoders.  Random weights from a seed; nothing is downloaded.
BERT_BASE_SHAPE = dict(vocab_size=30522, hidden=768, layers=12, heads=12, intermediate=3072,
                       max_positions=512, with_pooler=True, num_labels=1)
BERT_BASE_DIR = "reranker_bert_base"


def write_bert_base(torch, work: Path, shape: dict = BERT_BASE_SHAPE, name: str = BERT_BASE_DIR,
                    seed: int = 2, max_seq_length: int | None = None) -> None:
    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.models.hf_export import save_bert_checkpoint

    cfg = bert.BertConfig(**shape)
    model = bert.BertModel(cfg, device="cpu")
    bert.load_jax_params(model, bert.init_params(torch.Generator().manual_seed(seed), cfg))
    save_bert_checkpoint(model, cfg, str(work / name), cross_encoder=True,
                         max_seq_length=max_seq_length)


def drive_phase_13(torch, np, work: Path, smi: str) -> dict:
    """Phase 13: ``build_default_engine(device="cuda")`` with phase 3's
    BGE-small and index and a BERT-base-shaped reranker (12 layers, 12
    heads of 64): 3 single asks, a burst of 32 and a cache hit, kernel 2's
    ring kernel 12 times a batch (once a rerank layer) and its persistent
    kernel never; then the batch of 32 against the same batch under
    ``RAG_TPU_PAIR_ATTN=0`` (the einsum attention) on the card: rows and
    bi scores identical, logits within ``compare_batches``' 5e-2; the
    batch's wall and device milliseconds and the ring kernel's share of
    its device time (profiler)."""
    from financial_rag_system_tpu_torch.ops.fused_query import fused_two_stage

    t0 = time.perf_counter()
    write_bert_base(torch, work)
    log(f"[bert-base] {smi}: the BERT-base-shaped reranker {BERT_BASE_SHAPE} written in "
        f"{time.perf_counter() - t0:.1f} s")
    run = drive_main_path(torch, np, work, smi, label="bert-base", reranker=BERT_BASE_DIR,
                          rounds=1, attention="pair_attention_ring", rerank_layers=12)
    engine = run["engine"]
    card = (engine.embedder, engine.reranker)

    def batch():
        before = read_launches()
        out = flat_batch(torch, engine, run["burst"], "cuda", engine.index, card)
        after = read_launches()
        return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}

    got, launched = batch()
    if launched != {"masked_topk": 1, "pair_attention_ring": 12}:
        raise AssertionError(f"[bert-base] the batch launched {launched}")
    with env_set(RAG_TPU_PAIR_ATTN="0"):
        ref, launched_ref = batch()
    if launched_ref != {"masked_topk": 1}:
        raise AssertionError(f"[bert-base] the einsum batch launched {launched_ref}")
    if not (np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])):
        raise AssertionError("[bert-base] rows or bi scores differ from the einsum batch's")
    compare_batches(np, "[bert-base] card, ring kernel vs RAG_TPU_PAIR_ATTN=0 (einsum)", got, ref)
    log(f"[bert-base] {smi}: the einsum batch's logits span [{float(ref[2].min()):.4g}, "
        f"{float(ref[2].max()):.4g}] (std {float(ref[2].std()):.4g}) at random init")
    emb, codes, dtok = engine.index._arrays
    args = fused_inputs(torch, engine, run["burst"], "cuda")
    stats = {}
    profile_run(torch, lambda: fused_two_stage(
        engine.embedder.model, engine.reranker.model, *args, emb, codes, dtok, N,
        rerank_cfg=engine.reranker.cfg, k=K), "fused_two_stage, BERT-base reranker", smi, stats)
    ring = [(ms, n) for ms, n, key in stats["rows"] if "ring_kernel" in key]
    ring_ms = sum(ms for ms, _ in ring)
    share = (f"{ring_ms / stats['device_ms']:.4f}" if stats["device_ms"] > 0
             else "not measured (the profiler returned no kernels)")
    log(f"[bert-base] {smi}: the batch of {B}: wall {stats['wall_ms']:.2f} ms, device "
        f"{stats['device_ms']:.2f} ms; kernel 2 (ring kernel, {sum(n for _, n in ring)} "
        f"launches in the profile) {ring_ms:.3f} ms, {share} of the device time")
    del run["engine"]
    return run


# -- phase 14: BERT-base widths in 3 heads of 256 (kernel 7's D-256 kernel) ---------

# BERT_BASE_SHAPE with the hidden 768 split into 3 heads of 256: no
# published checkpoint has heads of 256; the shape keeps BERT-base's widths
# and FLOPs and puts the rerank on the one width the D-256 kernel serves
# (jax's flash kernel takes head widths that are multiples of 128 above
# 128, so the JAX package accepts it too).  Random weights from a seed.
BERT_BASE_D256_SHAPE = {**BERT_BASE_SHAPE, "heads": 3}
BERT_BASE_D256_DIR = "reranker_bert_base_d256"


def drive_phase_14(torch, np, work: Path, smi: str) -> dict:
    """Phase 14: ``build_default_engine(device="cuda")`` with phase 3's
    BGE-small and index and a BERT-base-wide reranker of 3 heads of 256
    under ``RAG_TPU_FLASH=1`` (the pair gates stay off above 128, so its
    attention is kernel 7's D-256 kernel, the pairs padded from 400 to
    512): 3 single asks, a burst of 32 and a cache hit, the D-256 kernel
    12 times a batch (once a rerank layer) and kernel 2 never; then the
    batch of 32 against the same batch without the variable (the einsum
    attention, pairs of 400) on the card: rows and bi scores identical,
    logits within ``compare_batches``' 5e-2; the batch's wall and device
    milliseconds and the D-256 kernel's share of its device time
    (profiler)."""
    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.ops.fused_query import fused_two_stage

    t0 = time.perf_counter()
    write_bert_base(torch, work, BERT_BASE_D256_SHAPE, BERT_BASE_D256_DIR, seed=3)
    log(f"[bert-base-d256] {smi}: the reranker {BERT_BASE_D256_SHAPE} written in "
        f"{time.perf_counter() - t0:.1f} s")
    with env_set(RAG_TPU_FLASH="1"):
        run = drive_main_path(torch, np, work, smi, label="bert-base-d256",
                              reranker=BERT_BASE_D256_DIR, rounds=1,
                              attention="flash_attention_wide", rerank_layers=12)
    engine = run["engine"]
    card = (engine.embedder, engine.reranker)
    seqs = []
    original = bert.encoder_flash_attention

    def spy(q, *args, **kwargs):
        seqs.append((q.shape[1], q.shape[3]))
        return original(q, *args, **kwargs)

    def batch():
        before = read_launches()
        out = flat_batch(torch, engine, run["burst"], "cuda", engine.index, card)
        after = read_launches()
        return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}

    bert.encoder_flash_attention = spy
    try:
        with env_set(RAG_TPU_FLASH="1"):
            got, launched = batch()
    finally:
        bert.encoder_flash_attention = original
    if launched != {"masked_topk": 1, "flash_attention_wide": 12} or set(seqs) != {(512, 256)}:
        raise AssertionError(f"[bert-base-d256] the batch launched {launched} at (S, d) "
                             f"{sorted(set(seqs))}")
    ref, launched_ref = batch()
    if launched_ref != {"masked_topk": 1}:
        raise AssertionError(f"[bert-base-d256] the einsum batch launched {launched_ref}")
    if not (np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])):
        raise AssertionError("[bert-base-d256] rows or bi scores differ from the einsum batch's")
    compare_batches(np, "[bert-base-d256] card, kernel 7 at D 256 vs the einsum path", got, ref)
    log(f"[bert-base-d256] {smi}: the einsum batch's logits span [{float(ref[2].min()):.4g}, "
        f"{float(ref[2].max()):.4g}] (std {float(ref[2].std()):.4g}) at random init")
    emb, codes, dtok = engine.index._arrays
    stats = {}
    with env_set(RAG_TPU_FLASH="1"):
        args = fused_inputs(torch, engine, run["burst"], "cuda")
        profile_run(torch, lambda: fused_two_stage(
            engine.embedder.model, engine.reranker.model, *args, emb, codes, dtok, N,
            rerank_cfg=engine.reranker.cfg, k=K), "fused_two_stage, BERT-base-wide reranker, "
            "3 heads of 256, RAG_TPU_FLASH=1", smi, stats)
    wide = [(ms, n) for ms, n, key in stats["rows"] if "flash256_kernel" in key]
    wide_ms = sum(ms for ms, _ in wide)
    share = (f"{wide_ms / stats['device_ms']:.4f}" if stats["device_ms"] > 0
             else "not measured (the profiler returned no kernels)")
    log(f"[bert-base-d256] {smi}: the batch of {B}: wall {stats['wall_ms']:.2f} ms, device "
        f"{stats['device_ms']:.2f} ms; kernel 7 (D 256, {sum(n for _, n in wide)} launches in "
        f"the profile) {wide_ms:.3f} ms, {share} of the device time")
    del run["engine"]
    return run


# -- phase 15: pairs above 512 tokens (kernels 2 and 7 at every length) -------------

# synthetic filings chunked at about 2,500 characters: documents of 480-960
# wordpieces (960 / 368 is 2,500 / 1,000 characters), 32,768 chunks
LONG_DLEN = 960
N_LONG = 32_768
# cross-encoder/ms-marco-MiniLM-L-6-v2's widths (hidden 384, 6 layers, 12
# heads of 32, intermediate 1,536) with 1,024 positions, trained (and so
# truncating) at 1,024: a long-context MiniLM reranker.  Random weights
# from a seed; nothing is downloaded.
LONG_MINILM_SHAPE = dict(vocab_size=30522, hidden=384, layers=6, heads=12, intermediate=1536,
                         max_positions=1024, with_pooler=True, num_labels=1)
LONG_MINILM_DIR = "reranker_long"
# BERT-base widths in 2 heads of 384 (hidden 768, intermediate 3,072; no
# published checkpoint has such heads: the shape puts a served rerank on
# kernel 7's slab kernel, which jax's kernel also takes), 1,024 positions,
# cut to 4 layers
SLAB_SHAPE = dict(vocab_size=30522, hidden=768, layers=4, heads=2, intermediate=3072,
                  max_positions=1024, with_pooler=True, num_labels=1)
SLAB_DIR = "reranker_slab"
LONG_ENV = {"RAG_TPU_TOKEN_STORE_LEN": str(LONG_DLEN)}
# the card checks of the new branches: kernel 2 above S 512, kernel 7
# above S 512, kernel 7 at heads of 384 and 512; (heads, width) at each
LONG_ATTN_SEQS = (513, 640, 1024, 2048, 4096)
LONG_ATTN_WIDTHS = ((12, 32), (12, 64), (6, 128))
LONG_FLASH_SEQS = (640, 1024, 2048)
LONG_FLASH_WIDTHS = ((12, 32), (12, 64), (6, 128), (3, 256))
SLAB_SEQS = (128, 512, 1024)
SLAB_WIDTHS = ((2, 384), (2, 512))
# --flash-baseline: the parent's build in turns beside the redesigned
# branches (heads of 32 above S 512, heads of 384, 512 and 640) and beside
# the unchanged ones above S 512 (heads of 64-256)
FLASH_BASELINE_LONG = ((1024, 12, 32), (2048, 12, 32), (1024, 12, 64), (1024, 6, 128),
                       (1024, 3, 256), (1024, 2, 384), (2048, 2, 384), (1024, 2, 512),
                       (1024, 2, 640))
# the shapes of those that are timed (the rest are checked only)
LONG_TIMED = {(1024, 32), (1024, 64), (1024, 128), (4096, 32), (1024, 256), (2048, 32),
              (1024, 384), (1024, 512), (128, 384)}
LONG_COMPARE_QUERIES = 8  # 120 pairs: the einsum batch's (P, 12, S, S) f32 scores fit
# kernel 2 beside the parent's build under --attn-baseline (S, heads, width):
# every width up to S 512 and heads of 64 and 128 above it bit for bit,
# heads of 32 above it (the long-pair kernel) within 1e-2 + rtol 1e-2
ATTN_BASELINE_CASES = ((400, 12, 32), (512, 12, 32), (400, 12, 64), (512, 6, 128),
                       (1024, 12, 32), (2048, 12, 32), (4096, 12, 32), (1024, 12, 64),
                       (1024, 6, 128))


def stretch_mask(np, mask_np, s: int, lq: int):
    """A rerank mask stretched to ``s`` keys: the query part (below
    ``lq``) kept, the document part's positions scaled by (s - lq) / (S -
    lq), so each pair's hole and tail scale with it."""
    p, s0 = mask_np.shape
    src = lq + (np.arange(s - lq) * (s0 - lq)) // (s - lq)
    return np.concatenate([mask_np[:, :lq], mask_np[:, src]], axis=1)


def card_inputs(torch, np, p: int, s: int, h: int, d: int):
    """``attention_inputs``' shapes and uniform-length mask with q, k and v
    drawn on the card (a torch generator seeded from SEED + s): numpy's
    draws took tens of seconds at phase 15's served shapes."""
    g = torch.Generator(device="cuda").manual_seed(SEED + s)
    q, k, v = (torch.randn((p, s, h, d), generator=g, device="cuda") for _ in range(3))
    lens = np.random.default_rng(SEED + s).integers(1, s + 1, p)
    lens[0] = s
    mask_np = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    mask_np[-1] = 0                              # a fully padded pair
    return q, k, v, mask_np


def long_pairs(s: int, h: int) -> int:
    """Pairs for a card check at S: as many as keep the plain version's
    (P, H, S, S) f32 scores near 2 GB, from 2 to 48."""
    return int(max(2, min(48, 2 ** 29 // (h * s * s))))


def check_kernel_case(torch, label: str, fn, plain, counter, want: int = 1,
                      rtol: float = 0.0) -> float:
    """``fn()`` against ``plain()`` on every row, |got - ref| <= 1e-2 +
    ``rtol`` |ref| (finite), and ``counter()`` (the launches it made) equal
    to ``want``: the largest difference."""
    before = counter()
    got = fn()
    torch.cuda.synchronize()
    launched = counter() - before
    ref = plain()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite output")
    err = float((got - ref).abs().max())
    excess = float(((got - ref).abs() - rtol * ref.abs()).max())
    if excess > 1e-2 or launched != want:
        raise AssertionError(f"{label}: differs from its plain version by {err} (1e-2 + "
                             f"{rtol} |ref|), {launched} launches (want {want})")
    return err


def check_long_kernels(torch, np, main: dict, smi: str, attn_baseline=None,
                       flash_baseline=None) -> None:
    """Tentpole item 6: kernel 2 at heads of 32, 64 and 128 at S 513,
    640, 1,024, 2,048 and 4,096; kernel 7 at heads of 32-256 at S 640,
    1,024 and 2,048, and at heads of 384 and 512 at S 128, 512 and 1,024;
    each on phase 3's rerank mask stretched to S and on the uniform-length
    mask, against its plain version (1e-2) with its launch counter (heads
    of 32 above S 512 on the long-pair kernel); the
    shapes of ``LONG_TIMED`` timed beside the plain version, SDPA, the
    bound and the MUFU floor.  Kernel 2 is held to atol 1e-2 and rtol
    1e-2, as ``tests/test_torch_kernels_cuda.py`` holds it: its probs are
    rounded to bf16 against a running max, the plain version's against
    the row's, so a context near 2-4 (a pair with a few valid keys) may
    round to the neighbouring bf16 value, 0.0156 away.  With a baseline build (``--attn-baseline``,
    ``--flash-baseline``: the parent's), kernels 2 and 7 at S <= 512 on
    the same masks, bit for bit with it, every width; kernel 2 at the
    shapes of ``ATTN_BASELINE_CASES`` above S 512 in turns with it."""
    from financial_rag_system_tpu_torch.ops import attention as attn
    from financial_rag_system_tpu_torch.ops import flash_attention as fa

    rerank = rerank_batch_mask(torch, np, main)
    lq = main["lq"]

    def masks(p, s, h, d):
        q, k, v, uniform = card_inputs(torch, np, p, s, h, d)
        return q, k, v, (("stretched rerank", stretch_mask(np, rerank[:p], s, lq)),
                         ("uniform-length", uniform))

    for h, d in LONG_ATTN_WIDTHS:
        for s in LONG_ATTN_SEQS:
            q, k, v, cases = masks(long_pairs(s, h), s, h, d)
            for name, mask_np in cases:
                label = f"[long] kernel 2, {name} mask, S {s}, {h} heads of {d}"
                if (s, d) in LONG_TIMED:
                    time_attention_mask(torch, np, smi, name, q, k, v, mask_np, rtol=1e-2)
                    continue
                mask = torch.tensor(mask_np, device="cuda")
                inv = d ** -0.5
                err = check_kernel_case(
                    torch, label, lambda: attn.encoder_self_attention(q, k, v, mask, inv),
                    lambda: attn.encoder_self_attention_plain(q, k, v, mask, inv),
                    lambda: attn.encoder_self_attention.launches_long, rtol=1e-2)
                log(f"{label}: P {q.shape[0]}, max_abs_err {err:.3g}")
    for s, h, d in ATTN_BASELINE_CASES:
        if attn_baseline is None:
            break
        # the long-pair kernel (heads of 32 above S 512) sums in another
        # order than the parent's build; every other case is unchanged
        exact = s <= 512 or d != 32
        q, k, v, cases = masks(48 if s <= 512 else long_pairs(s, h), s, h, d)
        for name, mask_np in cases:
            time_attention_mask(torch, np, smi, f"{name} (S {s} against the baseline)",
                                q, k, v, mask_np, attn_baseline, exact=exact, rtol=1e-2,
                                chunk=None if s <= 512 else long_pairs(s, h))

    def flash_case(s, h, d, timed):
        q, k, v, cases = masks(long_pairs(s, h), s, h, d)
        for name, mask_np in cases:
            label = f"[long] kernel 7, {name} mask, S {s}, {h} heads of {d}"
            if timed:
                time_flash(torch, np, smi, name, q, k, v, mask_np)
                continue
            mask = torch.tensor(mask_np, device="cuda")
            inv = d ** -0.5
            counter = fa.launch_counter(fa.padded_head_dim(d, s), s)
            err = check_kernel_case(
                torch, label, lambda: fa.encoder_flash_attention(q, k, v, mask, inv),
                lambda: fa.flash_attention_plain(q, k, v, mask, inv),
                lambda: getattr(fa.encoder_flash_attention, counter))
            log(f"{label}: P {q.shape[0]}, max_abs_err {err:.3g}")

    for h, d in LONG_FLASH_WIDTHS:
        for s in LONG_FLASH_SEQS:
            flash_case(s, h, d, (s, d) in LONG_TIMED)
    for h, d in SLAB_WIDTHS:
        for s in SLAB_SEQS:
            flash_case(s, h, d, (s, d) in LONG_TIMED)
    for s, h, d in ((512, 12, 32), (256, 12, 64), (512, 6, 128), (512, 3, 256), (128, 3, 256)):
        if flash_baseline is None:
            break
        q, k, v, cases = masks(48, s, h, d)
        for name, mask_np in cases:
            time_flash(torch, np, smi, f"{name} (S <= 512 against the baseline)", q, k, v,
                       mask_np, flash_baseline, exact=True)
    # the redesigned branches beside the parent's (not bit for bit: their
    # order differs within the tolerance), and kernel 7 at heads of 64 and
    # 128 above S 512, which keeps flash_kernel<D> (bit for bit)
    for s, h, d in FLASH_BASELINE_LONG:
        if flash_baseline is None:
            break
        q, k, v, cases = masks(long_pairs(s, h), s, h, d)
        for name, mask_np in cases:
            time_flash(torch, np, smi, f"{name} (S {s} against the baseline)", q, k, v, mask_np,
                       flash_baseline, exact=d in (64, 128, 256), chunk=long_pairs(s, h))


def served_shapes(torch, fn, wrapper: str):
    """``fn()`` with the (S, d) of each call of the encoder's ``wrapper``
    (``encoder_self_attention`` or ``encoder_flash_attention``)."""
    from financial_rag_system_tpu_torch.models import bert

    seen = []
    original = getattr(bert, wrapper)

    def spy(q, *args, **kwargs):
        seen.append((q.shape[1], q.shape[3]))
        return original(q, *args, **kwargs)

    setattr(bert, wrapper, spy)
    try:
        out = fn()
    finally:
        setattr(bert, wrapper, original)
    return out, seen


def serve_long(torch, np, work: Path, smi: str, part: str, reranker: str, layers: int,
               env: dict, kernel: str, wrapper: str, width: int, profile_key: str) -> dict:
    """One part of phase 15: ``build_default_engine(device="cuda")`` with
    phase 3's BGE-small over the long index and ``reranker`` under
    ``env`` (3 asks, a burst of 32, a cache hit: ``kernel`` ``layers``
    times a batch, nothing else of kernels 2 and 7);
    then ``LONG_COMPARE_QUERIES`` queries' batch against the einsum batch
    (``RAG_TPU_PAIR_ATTN=0``, no ``RAG_TPU_FLASH``) on the card (rows and
    bi scores identical, logits within ``compare_batches``' 5e-2), the
    (S, d) its attention saw (the query's and the token store's lengths,
    rounded up to 128s on the flash path), and the batch of 32's wall and
    device ms and the kernel's share of the device time (profiler)."""
    from financial_rag_system_tpu_torch.ops.fused_query import fused_two_stage

    with env_set(**LONG_ENV, **env):
        run = drive_main_path(torch, np, work, smi, label=f"long-{part}", index="index_long",
                              reranker=reranker, rounds=1, attention=kernel,
                              rerank_layers=layers, n=N_LONG, dlen=LONG_DLEN)
    engine = run["engine"]
    card = (engine.embedder, engine.reranker)
    queries = run["burst"][:LONG_COMPARE_QUERIES]

    def batch():
        before = read_launches()
        out = flat_batch(torch, engine, queries, "cuda", engine.index, card, N_LONG)
        after = read_launches()
        return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}

    with env_set(**env):
        (got, launched), seen = served_shapes(torch, batch, wrapper)
    # the pairs' length: the query's and the token store's, up to 128s on the flash path
    plen = run["lq"] + LONG_DLEN
    want = (-(-plen // 128) * 128 if env.get("RAG_TPU_FLASH") == "1" else plen, width)
    if launched != {"masked_topk": 1, kernel: layers} or seen != [want] * layers:
        raise AssertionError(f"[long-{part}] the batch launched {launched} at (S, d) {seen}")
    with env_set(RAG_TPU_PAIR_ATTN="0", RAG_TPU_FLASH="0"):
        ref, launched_ref = batch()
    if launched_ref != {"masked_topk": 1}:
        raise AssertionError(f"[long-{part}] the einsum batch launched {launched_ref}")
    if not (np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])):
        raise AssertionError(f"[long-{part}] rows or bi scores differ from the einsum batch's")
    compare_batches(np, f"[long-{part}] card, {kernel} at (S, d) {seen[0]} vs the einsum "
                    f"path", got, ref)
    emb, codes, dtok = engine.index._arrays
    stats = {}
    with env_set(**env):
        args = fused_inputs(torch, engine, run["burst"], "cuda")
        profile_run(torch, lambda: fused_two_stage(
            engine.embedder.model, engine.reranker.model, *args, emb, codes, dtok, N_LONG,
            rerank_cfg=engine.reranker.cfg, k=K), f"fused_two_stage, phase 15 ({part}), {env}",
            smi, stats)
    rows = [(ms, n) for ms, n, key in stats["rows"] if profile_key in key]
    ms = sum(ms for ms, _ in rows)
    share = (f"{ms / stats['device_ms']:.4f}" if stats["device_ms"] > 0
             else "not measured (the profiler returned no kernels)")
    log(f"[long-{part}] {smi}: the batch of {B} at (S, d) {seen[0]}: wall "
        f"{stats['wall_ms']:.2f} ms, device {stats['device_ms']:.2f} ms; {kernel} "
        f"({sum(n for _, n in rows)} launches in the profile) {ms:.3f} ms, {share} of the "
        f"device time")
    run["seen"] = seen[0]
    return run


def long_served_kernel(torch, np, run: dict, smi: str, kernel: str, baseline=None) -> dict:
    """A ``kernels`` line entry at the served shape of ``run``: the
    burst's rerank mask (as the encoder hands it to attention) with random
    q, k and v at its (S, d) and 480 pairs, timed by ``time_attention_mask``
    or ``time_flash`` with the plain version in chunks of pairs, beside
    ``baseline`` (the parent's build, ``--attn-baseline`` or
    ``--flash-baseline``) in turns; its device time (and the baseline's),
    and the L2 -> shared bytes its plan stages."""
    from financial_rag_system_tpu_torch.models import bert

    engine = run["engine"]
    flash = kernel != "pair_attention_long"
    name = "encoder_flash_attention" if flash else "encoder_self_attention"
    seen = []
    original = getattr(bert, name)

    def spy(q, k, v, attention_mask, *args, **kwargs):
        seen.append(attention_mask.to(torch.int32).cpu().numpy())
        return original(q, k, v, attention_mask, *args, **kwargs)

    setattr(bert, name, spy)
    try:
        with env_set(**run["env"]):
            flat_batch(torch, engine, run["burst"], "cuda", engine.index,
                       (engine.embedder, engine.reranker), N_LONG)
    finally:
        setattr(bert, name, original)
    mask_np = seen[0]
    p, s = mask_np.shape
    h = engine.reranker.cfg.heads
    d = engine.reranker.cfg.hidden // h
    q, k, v, _ = card_inputs(torch, np, p, s, h, d)
    label = f"phase 15's served mask ({kernel})"
    if flash:
        res = time_flash(torch, np, smi, label, q, k, v, mask_np, baseline,
                         chunk=long_pairs(s, h))
        from financial_rag_system_tpu_torch.ops import flash_attention as fa

        plan, mirror = ((fa.slab_plan(p, s, h, d), "slab_plan") if kernel == "flash_attention_slab"
                        else (fa.long_plan(p, s, h, d), "long_plan"))
        log(f"[flash] {smi}: phase 15's served mask ({kernel}), P={p} S={s} H={h} d={d}: L2 -> "
            f"shared bytes staged with no (tile, block) skipped {plan.staged_bytes / 1e9:.2f} GB, "
            f"computed from the plan (ops/flash_attention.py {mirror}), not measured")
    else:
        res = time_attention_mask(torch, np, smi, label, q, k, v, mask_np, baseline,
                                  chunk=long_pairs(s, h))
        from financial_rag_system_tpu_torch.ops import _cuda
        from financial_rag_system_tpu_torch.ops import attention as attn

        qs, kb, vb = attn.kernel_inputs(q, k, v, d ** -0.5)
        on_card = torch.tensor(mask_np, device="cuda")
        dev = device_ms(torch, attention_launcher(torch, _cuda.library("pair_attention"), qs, kb,
                                                  vb, on_card), "long_pair_kernel")
        old_dev = ("" if baseline is None else ", the parent's build " + format(device_ms(
            torch, attention_launcher(torch, baseline, qs, kb, vb, on_card), "kernel"), ".4f")
            + " ms")
        del qs, kb, vb
        mask = torch.tensor(mask_np)
        plan = attn.long_pair_plan(mask, h, d)
        parent = attn.staged_kv_bytes(mask, h, 3, False, d)
        log(f"[attention] {smi}: phase 15's served mask ({kernel}), P={p} S={s} H={h} d={d}: "
            f"device time {dev:.4f} ms a launch (profiler){old_dev}; "
            f"L2 -> shared bytes of K and V {plan.kv_bytes / 1e9:.3f} GB (q "
            f"{plan.q_bytes / 1e9:.3f} GB), the parent's units of three without the tail "
            f"{parent / 1e9:.3f} GB ({plan.kv_bytes / parent:.3f}); {plan.units} units of "
            f"{plan.unit} row tiles, {plan.idle} (unit, warpgroup) pairs idle; computed from the "
            f"plan (ops/attention.py long_pair_plan), not measured")
    source = "flash_attention.cu" if flash else "pair_attention.cu"
    replaces = ("financial_rag_system_tpu/models/bert.py:160" if flash
                else "financial_rag_system_tpu/ops/attention.py:48")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"name": kernel, "route": "cuda", "source": f"{PACKAGE}/csrc/{source}",
            "replaces": replaces, **{key: res[key] for key in keys}}


def drive_phase_15(torch, np, work: Path, main: dict, smi: str, kernels: list,
                   attn_baseline=None, flash_baseline=None) -> list:
    """Phase 15: a 1,024-position MiniLM-wide reranker served over pairs
    of about 1,000 tokens (phase 3's BGE-small, a 32,768-chunk index of
    960-token documents): (a) the default gate, kernel 2's long branch
    (the long-pair kernel) 6 times a batch at S 992, beside
    ``attn_baseline`` (the parent's build) in turns; (b) ``RAG_TPU_FLASH=1 RAG_TPU_PAIR_ATTN=0``,
    kernel 7 6 times a batch at S 1,024; (c) a reranker of 2 heads of 384
    under ``RAG_TPU_FLASH=1``, kernel 7's slab kernel 4 times a batch at S
    1,024; each batch against the einsum batch, profiled; then the kernel
    checks (``check_long_kernels``) and the ``kernels`` line entries of
    the new branches at the served shapes.  Each part's seconds."""
    runs, t0 = {}, time.perf_counter()
    write_index(torch, np, work, "index_long", n=N_LONG, dlen=LONG_DLEN)
    write_bert_base(torch, work, LONG_MINILM_SHAPE, LONG_MINILM_DIR, seed=4,
                    max_seq_length=1024)
    write_bert_base(torch, work, SLAB_SHAPE, SLAB_DIR, seed=5, max_seq_length=1024)
    log(f"[long] {smi}: {N_LONG} chunks of {LONG_DLEN // 2}-{LONG_DLEN} tokens, the "
        f"rerankers {LONG_MINILM_SHAPE} and {SLAB_SHAPE} written in "
        f"{time.perf_counter() - t0:.1f} s")
    parts = (
        ("a", LONG_MINILM_DIR, LONG_MINILM_SHAPE, {}, "pair_attention_long",
         "encoder_self_attention", "long_pair_kernel"),
        ("b", LONG_MINILM_DIR, LONG_MINILM_SHAPE, FLASH_ENV, "flash_attention_long",
         "encoder_flash_attention", "long_kernel"),
        ("c", SLAB_DIR, SLAB_SHAPE, {"RAG_TPU_FLASH": "1"}, "flash_attention_slab",
         "encoder_flash_attention", "slab_kernel"),
    )
    for part, reranker, shape, env, kernel, wrapper, key in parts:
        t0 = time.perf_counter()
        runs[part] = serve_long(torch, np, work, smi, part, reranker, shape["layers"], env,
                                kernel, wrapper, shape["hidden"] // shape["heads"], key)
        runs[part]["env"] = {**LONG_ENV, **env}
        log(f"[phase-15] part ({part}) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels.append(long_served_kernel(torch, np, runs["a"], smi, "pair_attention_long",
                                      attn_baseline))
    kernels.append(long_served_kernel(torch, np, runs["c"], smi, "flash_attention_slab",
                                      flash_baseline))
    kernels.append(long_served_kernel(torch, np, runs["b"], smi, "flash_attention_long",
                                      flash_baseline))
    for run in runs.values():
        del run["engine"]
    log(f"[phase-15] the served shapes' kernel figures took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_long_kernels(torch, np, main, smi, attn_baseline, flash_baseline)
    log(f"[phase-15] the kernel checks took {time.perf_counter() - t0:.1f} s")
    return list(runs.values())


# -- phase 16: the flash attention's backward (kernels 8 and 9) and the flash trainer --

FLASH_TRAIN_STEPS = 6   # cross-encoder steps of 32 pairs a run under RAG_TPU_FLASH=1
FLASH_TRAIN_LEN = 512   # the pairs' length: pad_batch's 512 bucket (phase 9's reranker)
# kernels 8 and 9 against their plain twins: each gradient within 2^-7 of
# the plain one's largest magnitude (one bf16 step of it: both round p and
# dS to bf16 at the same points and store bf16; their f32 sums differ in
# order); the forward's m within 1e-3 and l within 1e-3 relative (ex2.approx)
FLASH_BWD_RTOL = 2.0 ** -7
FLASH_RES_TOL = 1e-3
BWD_ENTRY = {"route": "cuda", "source": f"{PACKAGE}/csrc/flash_attention_bwd.cu"}
BWD_REPLACES = {
    "flash_attention_bwd_dkv": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
    "flash_attention_bwd_dq": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
}


def bwd_mask(np, kind: str, p: int, s: int, seed: int):
    """Key masks for (a): prefix lengths, the rerank layout (query tokens,
    a hole up to 32, document tokens, tail padding) or random holes; the
    last pair all padding."""
    rng = np.random.default_rng(seed)
    if kind == "prefix":
        mask = (np.arange(s)[None, :] < rng.integers(1, s + 1, p)[:, None]).astype(np.int32)
    elif kind == "rerank":
        mask = np.zeros((p, s), np.int32)
        for i in range(p):
            mask[i, :rng.integers(3, 33)] = 1
            mask[i, 32:32 + rng.integers(1, s - 31)] = 1
    else:
        mask = (rng.random((p, s)) < 0.7).astype(np.int32)
    mask[-1] = 0
    return mask


def flash_bwd_case(torch, np, p: int, s: int, h: int, d: int, mask_np, seed: int) -> dict:
    """Kernel 7's inputs at (p, s, h, d) on the card (padded as the wrapper
    pads them), its context with residuals and without, a cotangent and
    di, as the autograd function hands them to kernels 8 and 9."""
    from financial_rag_system_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(seed)
    q, k, v, g = (torch.randn((p, s, h, d), device="cuda", generator=gen) for _ in range(4))
    inv = 1.0 / d ** 0.5
    qb, kb, vb = fa.kernel_inputs(q, k, v)
    seg = torch.tensor(mask_np, dtype=torch.int32, device="cuda")
    out, m, l = fa.flash_attention_kernel(qb, kb, vb, seg, inv, residuals=True)
    served = fa.flash_attention_kernel(qb, kb, vb, seg, inv)
    do = g.to(torch.bfloat16)
    di = (out[..., :d].float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()
    dob = torch.nn.functional.pad(do, (0, qb.shape[-1] - d)).contiguous()
    return {"qb": qb, "kb": kb, "vb": vb, "seg": seg, "out": out, "served": served, "m": m,
            "l": l, "dob": dob, "di": di, "inv": inv, "d": d}


def bwd_args(c: dict) -> tuple:
    """The case's arguments of ``flash_attention_bwd_kernel`` and of the
    plain twin, in order."""
    return c["qb"], c["kb"], c["vb"], c["seg"], c["m"], c["l"], c["dob"], c["di"], c["inv"]


def check_flash_bwd_case(torch, label: str, c: dict) -> dict:
    """One case of (a): the residuals against the plain forward's, the
    context with residuals bit for bit the served one, kernels 8 and 9
    (each launched once) against ``flash_attention_bwd_plain``.  Returns
    the errors: m's, l's relative, each gradient's over its largest
    magnitude and absolute."""
    from financial_rag_system_tpu_torch.ops import flash_attention as fa

    fn = fa.encoder_flash_attention
    counters = tuple(fa.bwd_counter(c["qb"].shape[-1], dkv) for dkv in (True, False))
    n0 = tuple(getattr(fn, name) for name in counters)
    got = fa.flash_attention_bwd_kernel(*bwd_args(c))
    torch.cuda.synchronize()
    if tuple(getattr(fn, name) - n for name, n in zip(counters, n0)) != (1, 1):
        raise AssertionError(f"[flash-bwd] {label}: kernels 8 and 9 did not launch once each "
                             f"({', '.join(counters)})")
    _, m_ref, l_ref = fa.flash_attention_fwd_plain(c["qb"], c["kb"], c["vb"], c["seg"], c["inv"])
    qb, kb, vb, seg, m, l, dob, di, inv = bwd_args(c)
    ref = fa.flash_attention_bwd_plain(qb, kb, vb, seg, dob, m, l, di, inv)
    out = {"m": float((m - m_ref).abs().max()), "l": float(((l - l_ref).abs() / l_ref).max()),
           "served_equal": torch.equal(c["out"], c["served"])}
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        a, r = a.float(), r.float()
        if not torch.isfinite(a).all() or a[..., c["d"]:].any():
            raise AssertionError(f"[flash-bwd] {label}: {name} not finite, or its padding not 0")
        out[name + "_abs"] = float((a - r).abs().max())
        out[name] = out[name + "_abs"] / float(r.abs().max())
    if (max(out["dq"], out["dk"], out["dv"]) > FLASH_BWD_RTOL or out["m"] > FLASH_RES_TOL
            or out["l"] > FLASH_RES_TOL or not out["served_equal"]):
        raise AssertionError(f"[flash-bwd] {label}: {out} (gradients within {FLASH_BWD_RTOL} "
                             f"of their largest magnitude, m and l within {FLASH_RES_TOL}, "
                             f"the context bit for bit)")
    return out


def check_flash_bwd_grid(torch, np, main: dict, smi: str) -> None:
    """(a) the residuals and kernels 8 and 9 against their plain twins at
    S 128, 256, 512 and 1,024, heads of 32, 64, 128 and 256 and 2 heads of
    384, on the prefix, rerank-layout and holed masks (each with an
    all-padding pair); phase 3's served shape (P 480, S 512, 12 heads of
    32 on its rerank mask padded to 512) with residuals asked for, bit for
    bit the served context; ``ptxas -v`` of ``csrc/flash_attention_bwd.cu``
    (no spill; the unit kernel's four ``walk_kernel`` instantiations,
    heads of 32 and 64, and the wide kernel's six ``wide_kernel`` ones,
    walked blocks of 64, 32 and 16 rows for each of dK/dV and dQ)."""
    from financial_rag_system_tpu_torch.ops import flash_attention as fa

    worst, cases = {}, 0
    for s in (128, 256, 512, 1024):
        for h, d in ((4, 32), (4, 64), (2, 128), (2, 256), (2, 384)):
            for kind in ("prefix", "rerank", "holes"):
                mask_np = bwd_mask(np, kind, 3, s, seed=s + d)
                c = flash_bwd_case(torch, np, 3, s, h, d, mask_np, seed=s + d)
                errs = check_flash_bwd_case(torch, f"S {s}, {h} heads of {d}, {kind}", c)
                for key in ("m", "l", "dq", "dk", "dv"):
                    worst[key] = max(worst.get(key, 0.0), errs[key])
                cases += 1
    log(f"[flash-bwd] {smi}: {cases} cases (S 128-1,024 x heads of 32, 64, 128, 256 and 384 x "
        f"prefix, rerank-layout and holed masks): largest errors against the plain twins "
        f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} } (gradients over their largest "
        f"magnitude, tolerance {FLASH_BWD_RTOL:.4g}; m absolute and l relative, {FLASH_RES_TOL}); "
        f"every context with residuals bit for bit the served one")
    plen, s = main["lq"] + DLEN, flash_len(main)
    served = np.pad(rerank_batch_mask(torch, np, main), ((0, 0), (0, s - plen)))
    q, k, v, _ = attention_inputs(torch, np, PAIRS, s)
    qb, kb, vb = fa.kernel_inputs(q, k, v)
    seg = torch.tensor(served, dtype=torch.int32, device="cuda")
    with_res, _, _ = fa.flash_attention_kernel(qb, kb, vb, seg, 1.0 / 32 ** 0.5, residuals=True)
    if not torch.equal(with_res, fa.flash_attention_kernel(qb, kb, vb, seg, 1.0 / 32 ** 0.5)):
        raise AssertionError("[flash-bwd] the served context with residuals differs")
    log(f"[flash-bwd] {smi}: P {PAIRS}, S {s}, 12 heads of 32 on phase 3's rerank mask: the "
        f"context with residuals asked for is bit for bit the served one")
    del q, k, v, qb, kb, vb, with_res
    report = ptxas_report("flash_attention_bwd")
    log(f"[flash-bwd] ptxas -v of csrc/flash_attention_bwd.cu (registers, spill store and load "
        f"bytes): {report}")
    if (len([k for k in report if "walk_kernel" in k]) != 4
            or len([k for k in report if "wide_kernel" in k]) != 6 or len(report) != 10
            or any(r[1] or r[2] for r in report.values())):
        raise AssertionError(f"[flash-bwd] a backward kernel spills, or ptxas named other "
                             f"kernels: {report}")


def trainer_examples(np, steps: int) -> list:
    """The cross-encoder supervision at serving length (chunks of 1000
    characters), ``steps`` batches of 32 of it in a fixed order."""
    from financial_rag_system_tpu_torch.train import cross_encoder

    examples = cross_encoder.make_cross_examples(seed=1, chunk_chars=1000)
    order = np.random.default_rng(16).permutation(len(examples))[: 32 * steps]
    return [examples[i] for i in order]


def first_batch(torch, np, examples: list, seed: int = 0) -> dict:
    """The batch ``train_cross_encoder(examples, seed=seed)`` takes first,
    as ``step_objective`` takes its rows (with the trainer's pos_weight)."""
    from financial_rag_system_tpu_torch.models.tokenizer import Tokenizer, pad_batch

    tok = Tokenizer()
    chunk = [examples[i] for i in np.random.default_rng(seed).permutation(len(examples))[:32]]
    ids, types, mask = pad_batch([tok.encode_pair(q, d, FLASH_TRAIN_LEN) for q, d, _ in chunk])
    labels = np.zeros(ids.shape[0], np.float32)
    labels[: len(chunk)] = [lbl for *_, lbl in chunk]
    n_pos = sum(1 for *_, lbl in examples if lbl > 0.5) or 1
    return {"pairs": (ids, types, mask, torch.from_numpy(labels)),
            "pos_weight": max(1.0, (len(examples) - n_pos) / n_pos)}


def bwd_entry_fn(torch, lib, name: str, c: dict):
    """A launch of kernel 8 or 9 by the C entry ``name`` of ``lib`` (a
    build of ``flash_attention_bwd.cu``: an earlier checkout's, or this
    one's) alone, on the case's arguments, into buffers of its own;
    returns the gradients."""
    import ctypes

    from financial_rag_system_tpu_torch.ops import _cuda

    qb, kb, vb, seg, m, l, dob, di, inv = bwd_args(c)
    b, s, h, dp = qb.shape
    outs = [torch.empty_like(qb) for _ in range(2 if name.endswith("dkv") else 1)]
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * (8 + len(outs)) + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ptrs = [t.data_ptr() for t in (qb, kb, vb, seg, m, l, dob, di, *outs)]

    def launch():
        _cuda.launch(fn, name, *ptrs, b, s, h, dp, inv)
        return outs
    return launch


def bwd_against_parent(torch, smi: str, shape: str, c: dict, parent) -> None:
    """``--bwd-baseline``: each C entry of the parent's build beside this
    build's on the case (``shape``): the gradients within FLASH_BWD_RTOL of
    the parent's largest magnitude (the sums run in another order), then
    both timed in turns (parent, new, new, parent), CUDA events and device
    time (profiler), the C entries alone."""
    from financial_rag_system_tpu_torch.ops import _cuda

    new_lib = _cuda.library("flash_attention_bwd")
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        old, new = bwd_entry_fn(torch, parent, name, c), bwd_entry_fn(torch, new_lib, name, c)
        got, want = [x.float() for x in new()], [x.float() for x in old()]
        torch.cuda.synchronize()
        rel = max(float((a - r).abs().max()) / float(r.abs().max()) for a, r in zip(got, want))
        if rel > FLASH_BWD_RTOL:
            raise AssertionError(f"[flash-bwd] {name}: {rel:.3g} of the parent's largest "
                                 f"magnitude apart (tolerance {FLASH_BWD_RTOL:.4g})")
        order = (old, new, new, old)
        events = [median_ms(fn, reps=30) for fn in order]
        device = [sum(device_split(torch, fn).values()) for fn in order]
        log(f"[flash-bwd] {smi}: {name} against the parent's build at {shape}: "
            f"gradients {rel:.3g} of the parent's largest magnitude apart; in turns (parent, "
            f"new, new, parent; C entries alone): events {', '.join(f'{t:.4f}' for t in events)} "
            f"ms; device {', '.join(f'{t:.4f}' for t in device)} ms; "
            f"{(events[0] + events[3]) / (events[1] + events[2]):.2f}x")


# (a)'s wide widths, timed at the trainer's B 32 and S 512 on its first
# batch's mask: H D 768, as BERT-base splits it into heads of 128, 256 and
# 384; the kernels line's wide entries are phase 16 (c)'s width, 256
BWD_WIDE_SHAPES = ((6, 128), (3, 256), (2, 384))
BWD_WIDE_ENTRY_D = 256
BWD_NAMES = {False: ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"),
             True: ("flash_attention_bwd_wide_dkv", "flash_attention_bwd_wide_dq")}


def time_bwd_width(torch, np, smi: str, mask_np, h: int, d: int, baseline=None) -> list:
    """Kernels 8 and 9 at (B, S) of ``mask_np`` and ``h`` heads of ``d``:
    against the plain twins, CUDA-event and profiler times, the plain
    twins' times (dK/dV alone, dQ alone), the backward of SDPA with the
    boolean segment mask timed alone (a yardstick: dQ, dK and dV in one
    call), each kernel's bound (its bytes, and its products over the
    (query, key) pairs that share a segment) and MUFU floor (one
    exponential a pair), the L2 -> shared bytes it stages (``bwd_plan`` or
    ``wide_bwd_plan``, beside the first design's ``parent_bwd_staged``;
    computed, not measured); ``baseline`` (``--bwd-baseline``) beside it
    in turns.  Returns the two ``kernels`` line entries of this width."""
    from financial_rag_system_tpu_torch.ops import flash_attention as fa

    p, s = mask_np.shape
    wide = d >= fa.BWD_WIDE_MIN
    c = flash_bwd_case(torch, np, p, s, h, d, mask_np, seed=d)
    shape = f"B {p}, S {s}, {h} heads of {d}"
    errs = check_flash_bwd_case(torch, shape, c)
    qb, kb, vb, seg, m, l, dob, di, inv = bwd_args(c)
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True) for t in (qb, kb, vb))
    same = seg[:, None, :, None] == seg[:, None, None, :]
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=same,
                                                               scale=inv)
    go = dob.transpose(1, 2)
    library_ms = median_ms(lambda: torch.autograd.grad(sdpa_out, (qh, kh, vh), go,
                                                       retain_graph=True), reps=10)
    del sdpa_out, same, qh, kh, vh
    pairs = segment_pairs(np, mask_np)
    tensor = p * s * h * d * 2
    rows = 3 * p * h * s * 4 + p * s * 4  # m, l, di and the segment ids
    mufu = mufu_ms(torch, h * pairs)
    entries = []
    for name, kw, products, tensors, errs_of in (
        (BWD_NAMES[wide][0], {"dq": False}, 4, 6, ("dk_abs", "dv_abs")),
        (BWD_NAMES[wide][1], {"dkv": False}, 3, 5, ("dq_abs",)),
    ):
        def kernel(kw=kw):
            return fa.flash_attention_bwd_kernel(*bwd_args(c), **kw)

        def plain(kw=kw):
            return fa.flash_attention_bwd_plain(qb, kb, vb, seg, dob, m, l, di, inv, **kw)

        ms = median_ms(kernel, reps=20)
        dev = (sum(device_split(torch, kernel).values()) if wide
               else device_ms(torch, kernel, "walk_kernel"))
        plain_ms = median_ms(plain, reps=3, warmup=1)
        b_ms, b_by = bound_ms(tensors * tensor + rows, 2.0 * products * h * d * pairs)
        err = max(errs[e] for e in errs_of)
        log(f"[flash-bwd] {smi}: {name}, {shape}, the trainer's first batch mask: max_abs_err "
            f"{err:.3g} ({max(errs[e[:2]] for e in errs_of):.3g} of the largest magnitude), "
            f"kernel {ms:.4f} ms (device {dev:.4f} ms), plain {plain_ms:.4f} ms, SDPA backward "
            f"(dQ, dK, dV) {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; dense "
            f"{bound_ms(tensors * tensor + rows, 2.0 * products * h * d * p * s * s)[0]:.4f} ms),"
            f" MUFU floor {mufu:.4f} ms; kernel at {b_ms / ms:.3f} of its bound (device "
            f"{b_ms / dev:.3f})")
        dkv = name.endswith("dkv")
        parent = fa.parent_bwd_staged(p, s, h, d, dkv)
        if wide:
            plan = fa.wide_bwd_plan(p, s, h, d, dkv)
            layout = (f"walked blocks of {plan.walk} rows, {plan.groups} column group(s) of "
                      f"{plan.group_chunks} 64-column chunks, own tile "
                      f"{'resident' if plan.resident else 'staged a window at a time'}, "
                      f"{plan.units} units of a cluster of {plan.cluster}")
        else:
            plan = fa.bwd_plan(p, s, h, d, dkv)
            layout = f"units of {plan.unit} row tiles ({plan.units} units)"
        log(f"[flash-bwd] {smi}: {name}, {shape}: {layout}, {plan.consumer_regs} / "
            f"{plan.producer_regs} registers, {plan.stages} stages, {plan.smem} B of shared "
            f"memory; L2 -> shared bytes staged with no (tile, block) skipped "
            f"{plan.staged_bytes / 1e6:.1f} MB against the first design's {parent / 1e6:.1f} MB "
            f"({parent / plan.staged_bytes:.2f}x); computed from the plans "
            f"(ops/flash_attention.py), not measured")
        entries.append({"name": name, **BWD_ENTRY, "replaces": BWD_REPLACES[BWD_NAMES[False][
            0 if dkv else 1]], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms})
    if baseline is not None:
        bwd_against_parent(torch, smi, shape, c, baseline)
    del c
    return entries


def time_flash_backward(torch, np, smi: str, mask_np, baseline=None) -> dict:
    """(a) kernels 8 and 9 at the trainer's shape (B 32, S 512, 12 heads of
    32) and at H D 768 in heads of 128, 256 and 384 (BWD_WIDE_SHAPES) on
    its first batch's mask (:func:`time_bwd_width`).  Returns the
    ``kernels`` line's entries by width: heads of 32 (phase 16 (b)'s) and
    BWD_WIDE_ENTRY_D (phase 16 (c)'s)."""
    out = {32: time_bwd_width(torch, np, smi, mask_np, 12, 32, baseline)}
    for h, d in BWD_WIDE_SHAPES:
        entries = time_bwd_width(torch, np, smi, mask_np, h, d, baseline)
        if d == BWD_WIDE_ENTRY_D:
            out[d] = entries
    return out


def flash_step_launches(wide: bool = False) -> tuple:
    """Kernel 7's and kernels 8 and 9's counters: at heads of 32-128, or
    (``wide``) the D-256 kernel's and the wide backward's."""
    from financial_rag_system_tpu_torch.ops.flash_attention import encoder_flash_attention as f

    if wide:
        return f.launches_wide, f.launches_bwd_wide_dkv, f.launches_bwd_wide_dq
    return f.launches, f.launches_bwd_dkv, f.launches_bwd_dq


def check_flash_first_step(torch, np, rows: dict, smi: str, label: str, cfg=None,
                           wide: bool = False) -> None:
    """The trainer's first step (one BCE step at full width from
    ``init_model``'s weights: MiniLM-L6, or ``cfg``) under
    ``RAG_TPU_FLASH=1`` against the same step without it (the einsum path):
    kernel 7 and kernels 8 and 9 once a layer each (on the wide counters
    when ``wide``), the loss within TRAIN_LOSS_RTOL and the gradients
    within TRAIN_GRAD_TOL (:func:`compare_steps`; the updated weights are
    logged)."""
    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.train import stack

    cfg = cfg or bert.MINILM_L6_CROSS
    lr, out = 1e-4, {}
    for key, env in (("einsum", {}), ("flash", {"RAG_TPU_FLASH": "1"})):
        model = stack.init_model(cfg, 1, "cuda")
        with env_unset("RAG_TPU_FLASH"), env_set(**env):
            n0 = flash_step_launches(wide)
            out[key] = step_objective(torch, model, "bce", rows, lr)
            launched = tuple(b - a for a, b in zip(n0, flash_step_launches(wide)))
        want = (cfg.layers,) * 3 if key == "flash" else (0, 0, 0)
        if launched != want:
            raise AssertionError(f"[flash-train] {label}: the {key} step launched kernels 7, 8 "
                                 f"and 9 {launched} times (want {want})")
        del model
    c = compare_steps(torch, lr, out["flash"], out["einsum"])
    log(f"[flash-train] {smi}: {label}: loss {out['flash'][0]:.6f} under RAG_TPU_FLASH=1 "
        f"against {out['einsum'][0]:.6f} on the einsum path (rel {c['loss_rel']:.2e}, tolerance "
        f"{TRAIN_LOSS_RTOL}); gradients {c['grad_rel']:.2e} of their norm (tolerance "
        f"{TRAIN_GRAD_TOL}); updated weights within {c['moved_lr']:.4f} lr, {c['sure_lr']:.2e} "
        f"lr at the {c['sure']} sure of their sign; kernels 7, 8 and 9 {cfg.layers} times each")
    if c["loss_rel"] > TRAIN_LOSS_RTOL or c["grad_rel"] > TRAIN_GRAD_TOL:
        raise AssertionError(f"[flash-train] {label}: the flash step differs from the einsum "
                             f"step's")


def train_flash_run(torch, examples: list, env: dict, cfg=None) -> tuple:
    """``train_cross_encoder`` on ``examples`` from ``init_model``'s
    weights (MiniLM-L6's shape, or ``cfg``) under ``env``
    (``RAG_TPU_FLASH`` unset first): its losses, final weights and step
    log."""
    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.train import cross_encoder, stack

    model = stack.init_model(cfg or bert.MINILM_L6_CROSS, 1, "cuda")
    with env_unset("RAG_TPU_FLASH"), env_set(**env), step_logs(torch, cfg) as (logs, _):
        _, losses = cross_encoder.train_cross_encoder(model, examples, batch_size=32, lr=1e-4,
                                                      max_len=FLASH_TRAIN_LEN, seed=0)
    torch.cuda.synchronize()
    return losses, [p.detach().clone() for p in model.parameters()], logs["cross_encoder"]


def profile_flash_steps(torch, rows: dict, smi: str, cfg=None, what: str = "cross-encoder") -> None:
    """One BCE step (MiniLM-L6, or ``cfg``) on the trainer's first batch
    under ``RAG_TPU_FLASH=1`` and without it, each's device time by kind
    (:func:`profile_train_step`: kernels 7-9 and the torch work inside the
    autograd function apart)."""
    from torch.profiler import record_function

    from financial_rag_system_tpu_torch.models import bert
    from financial_rag_system_tpu_torch.train import contrastive, cross_encoder, stack
    from financial_rag_system_tpu_torch.train.optim import ClippedAdamW, graded

    ids, types, mask, labels = rows["pairs"]
    batch = contrastive.on_device((ids, types, mask), "cuda")
    labels = labels.to("cuda")
    for name, env in ((f"{what} BCE, RAG_TPU_FLASH=1", {"RAG_TPU_FLASH": "1"}),
                      (f"{what} BCE, einsum attention", {})):
        model = stack.init_model(cfg or bert.MINILM_L6_CROSS, 1, "cuda")
        opt = ClippedAdamW(model, 1e-4)

        def step_fn(model=model, opt=opt):
            with graded(model):
                cross_encoder.bce_loss(model, *batch, labels, rows["pos_weight"]).backward()
            with record_function("train_optimizer"):
                opt.step()

        with env_unset("RAG_TPU_FLASH"), env_set(**env):
            profile_train_step(torch, name, step_fn, smi)
        del model, opt


def train_flash_path(torch, np, smi: str, tag: str, what: str, steps: int, cfg=None,
                     wide: bool = False) -> dict:
    """``train_cross_encoder`` under ``RAG_TPU_FLASH=1`` over ``steps``
    batches of 32 x FLASH_TRAIN_LEN from ``init_model``'s weights
    (MiniLM-L6's shape, or ``cfg``): its first step against the einsum
    step, the run (the main path: every count set to 0 before it and read
    after; kernel 7 and kernels 8 and 9 once a layer a step, on the wide
    counters when ``wide``, nothing else), a second run bit for bit, the
    einsum run's step time and peak memory beside it, and both steps'
    device time by kind.  Returns the run's launches."""
    from financial_rag_system_tpu_torch.models import bert

    layers = (cfg or bert.MINILM_L6_CROSS).layers
    examples = trainer_examples(np, steps)
    rows = first_batch(torch, np, examples)
    if np.asarray(rows["pairs"][2]).shape != (32, FLASH_TRAIN_LEN):
        raise AssertionError(f"[{tag}] the trainer's first batch is "
                             f"{np.asarray(rows['pairs'][2]).shape}")
    check_flash_first_step(torch, np, rows, smi, f"{what}: the first step, 32 x "
                           f"{FLASH_TRAIN_LEN}", cfg, wide)
    reset_launches()
    losses, weights, step_log = train_flash_run(torch, examples, {"RAG_TPU_FLASH": "1"}, cfg)
    launches = read_launches()
    n = len(losses)
    names = (("flash_attention_wide", *BWD_NAMES[True]) if wide
             else ("flash_attention", *BWD_NAMES[False]))
    want = want_launches(**{name: layers * n for name in names})
    if n != steps or launches != want:
        raise AssertionError(f"[{tag}] {n} steps launched {launches} (want {want})")
    flash = step_log.report(f"{what} under RAG_TPU_FLASH=1 ({n} x 32 x {FLASH_TRAIN_LEN})", smi)
    again, weights_b, _ = train_flash_run(torch, examples, {"RAG_TPU_FLASH": "1"}, cfg)
    dw = max(float((a - b).abs().max()) for a, b in zip(weights, weights_b))
    log(f"[{tag}] {smi}: {what} trained twice from the same weights under RAG_TPU_FLASH=1, {n} "
        f"steps: losses {losses[0]!r} -> {losses[-1]!r} and {again[0]!r} -> {again[-1]!r}, "
        f"equal {losses == again}; weights {dw!r} apart (want bit for bit)")
    if losses != again or dw != 0:
        raise AssertionError(f"[{tag}] two runs of the flash trainer differ")
    del weights, weights_b
    ein_losses, _, ein_log = train_flash_run(torch, examples, {}, cfg)
    einsum = ein_log.report(f"{what}, einsum attention ({n} x 32 x {FLASH_TRAIN_LEN})", smi)
    log(f"[{tag}] {smi}: {what}: median step {flash['step_ms_median']:.2f} ms under "
        f"RAG_TPU_FLASH=1 against {einsum['step_ms_median']:.2f} ms on the einsum path; peak "
        f"{flash['peak_gib']:.2f} against {einsum['peak_gib']:.2f} GiB; losses "
        f"{losses[-1]:.6f} against {ein_losses[-1]:.6f} after {n} steps; kernels 7, 8 and 9 "
        f"{', '.join(str(launches[k]) for k in names)} times over the run")
    profile_flash_steps(torch, rows, smi, cfg, what)
    return {"launches": launches}


FLASH_WIDE_STEPS = 3    # (c)'s steps a run: BERT-base widths, 12 layers


def drive_phase_16(torch, np, main: dict | None, smi: str, kernels: list, bwd_baseline=None,
                   parts: str = "abc") -> list:
    """Phase 16, the ``parts`` asked for: (a) the forward's residuals and
    kernels 8 and 9 against their plain twins over the grid, the served
    context with residuals, ``ptxas -v``, the two kernels timed at the
    trainer's shape and at H D 768 in heads of 128-384 (the ``kernels``
    line's entries of the parts that launch them); (b) the cross-encoder
    trainer (MiniLM-L6) at full width under ``RAG_TPU_FLASH=1``
    (:func:`train_flash_path`: kernel 7 and kernels 8 and 9 six times a
    step); (c) the same trainer on phase 14's reranker (BERT-base widths in
    3 heads of 256, 12 layers): kernel 7's D-256 kernel and the wide
    backward kernels twelve times a step, kernel 2 never.  Returns (b)'s
    and (c)'s runs for the launch counts."""
    from financial_rag_system_tpu_torch.models import bert

    runs = []
    if "a" in parts:
        t0 = time.perf_counter()
        check_flash_bwd_grid(torch, np, main, smi)
        mask_np = np.asarray(first_batch(torch, np, trainer_examples(np, FLASH_TRAIN_STEPS))
                             ["pairs"][2])
        if mask_np.shape != (32, FLASH_TRAIN_LEN):
            raise AssertionError(f"the trainer's first batch is {mask_np.shape}")
        entries = time_flash_backward(torch, np, smi, mask_np, bwd_baseline)
        kernels += (entries[32] if "b" in parts else []) + (
            entries[BWD_WIDE_ENTRY_D] if "c" in parts else [])
        log(f"[phase-16] part (a) took {time.perf_counter() - t0:.1f} s")
    if "b" in parts:
        t0 = time.perf_counter()
        runs.append(train_flash_path(torch, np, smi, "flash-train", "cross-encoder",
                                     FLASH_TRAIN_STEPS))
        log(f"[phase-16] part (b) took {time.perf_counter() - t0:.1f} s")
    if "c" in parts:
        t0 = time.perf_counter()
        runs.append(train_flash_path(torch, np, smi, "flash-train-wide",
                                     "cross-encoder of BERT-base widths in 3 heads of 256",
                                     FLASH_WIDE_STEPS, bert.BertConfig(**BERT_BASE_D256_SHAPE),
                                     wide=True))
        log(f"[phase-16] part (c) took {time.perf_counter() - t0:.1f} s")
    return runs


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
        help="csrc/ directory of an earlier checkout with pair_attention_wide: time its "
             "pair_attention.cu (pair_attention at heads of 32, pair_attention_wide at 64 "
             "and 128) beside kernel 2 on the same inputs, and log their contexts' difference",
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
    parser.add_argument(
        "--flash-baseline", type=Path, default=None, metavar="CSRC",
        help="csrc/ directory of an earlier checkout: time its flash_attention.cu beside "
             "kernel 7 at each shape of phase 12 (a) and at phase 15's, in turns, and log "
             "their contexts' difference",
    )
    parser.add_argument(
        "--bwd-baseline", type=Path, default=None, metavar="CSRC",
        help="csrc/ directory of an earlier checkout: hold its flash_attention_bwd.cu's two "
             "C entries to kernels 8 and 9 at the trainer's shape and time them in turns",
    )
    parser.add_argument(
        "--phases", default=None, metavar="LIST",
        help="run only these phases, comma-separated (e.g. 2,16 or 16a,16c: phase 16's parts "
             "apart), with the phases they need (phase 1 always; 3 for 4-6, 8, 10-12, 15 and "
             "16 (a); 6 for 10; 9 for 11); the kernels line then lists and checks only the "
             "selected phases' kernels; every phase when absent",
    )
    opts = parser.parse_args()
    try:
        phases, parts16 = selected_phases(opts.phases)
    except ValueError as err:
        print(f"chip_smoke: --phases: {err}", file=sys.stderr)
        return 2
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
    if opts.phases is not None:
        log(f"[phases] {smi}: running phases {sorted(phases)} (asked for {opts.phases}; "
            f"phase 16's parts {parts16 if 16 in phases else 'none'})")
    t0 = time.perf_counter()
    start_ptxas_reports()
    phase_build()
    log(f"[build] phase 1 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    attn_baseline = (baseline_lib("pair_attention", opts.attn_baseline)
                     if opts.attn_baseline else None)
    ffn_baseline = (baseline_lib("fused_bert", opts.ffn_baseline)
                    if opts.ffn_baseline else None)
    resid_baseline = (baseline_lib("fused_bert", opts.resid_baseline)
                      if opts.resid_baseline else None)
    flash_baseline = (baseline_lib("flash_attention", opts.flash_baseline)
                      if opts.flash_baseline else None)
    bwd_baseline = (baseline_lib("flash_attention_bwd", opts.bwd_baseline)
                    if opts.bwd_baseline else None)
    kernels, runs = [], []
    if 2 in phases:
        kernels += [check_topk(torch, np, smi, opts.topk_baseline),
                    *check_attention(torch, np, smi, attn_baseline)]
        check_large_k(torch, np, smi, opts.topk_baseline, opts.ivf_baseline)
        kernels += check_wide_rows(torch, np, smi, opts.topk_baseline, opts.ivf_baseline)
        log(f"[kernels] phase 2 took {time.perf_counter() - t0:.1f} s")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    main_run = None
    try:
        if 2 in phases:
            t0 = time.perf_counter()
            runs.append(drive_wide_path(torch, np, work, smi))
            log(f"[wide-path] phase 2's wide path took {time.perf_counter() - t0:.1f} s")
        if phases & set(range(3, 16)):  # their checkpoints and index
            t0 = time.perf_counter()
            write_checkpoints(torch, work)
            write_index(torch, np, work)
            log(f"[main] checkpoints and index written in {time.perf_counter() - t0:.1f} s")
        if 3 in phases:
            t0 = time.perf_counter()
            main_run = drive_main_path(torch, np, work, smi)
            from financial_rag_system_tpu_torch.models.embedder import get_embedder
            from financial_rag_system_tpu_torch.models.reranker import get_reranker

            cpu_models = (get_embedder(device="cpu"), get_reranker(device="cpu"))
            check_against_cpu(torch, np, main_run, cpu_models)
            check_attention_gate(torch, np, main_run, smi)
            check_attention_batch_mask(torch, np, main_run, smi, attn_baseline)
            profile_batch(torch, main_run, smi)
            runs.append(main_run)
            log(f"[main] phase 3 took {time.perf_counter() - t0:.1f} s")
        if 4 in phases:
            t0 = time.perf_counter()
            ivf_run = drive_ivf_path(torch, np, main_run, smi)
            kernels.append(check_ivf_kernel(torch, np, ivf_run, smi, opts.ivf_baseline))
            check_ivf_against_cpu(torch, np, main_run, work, cpu_models)
            log(f"[ivf] phase 4 took {time.perf_counter() - t0:.1f} s")
            del ivf_run["engine"]
            runs.append(ivf_run)
        if 5 in phases:
            t0 = time.perf_counter()
            with env_set(**FUSED_BLOCK_ENV):
                block_run = drive_main_path(torch, np, work, smi, label="fused-block")
                check_fused_block_batch(torch, np, block_run, cpu_models, smi)
                kernels += check_fused_block_kernels(torch, block_run, smi, ffn_baseline,
                                                     resid_baseline)
            log(f"[fused-block] phase 5 took {time.perf_counter() - t0:.1f} s")
            del block_run["engine"]
            runs.append(block_run)
        if 6 in phases:
            t0 = time.perf_counter()
            int8 = write_int8_index(torch, np, work, main_run)
            with env_set(RAG_TPU_INDEX_DTYPE="int8"):
                int8_run = drive_main_path(torch, np, work, smi, label="int8",
                                           index=int8["dir"], rounds=1)
            check_int8_against_cpu(torch, np, int8_run, int8, work, cpu_models)
            int8_overlap(torch, np, int8_run, int8, smi)
            kernels.append(check_topk_int8(torch, np, smi, opts.topk_baseline))
            del int8_run["engine"], int8["bf16"]
            ivf8_run = drive_ivf_path(torch, np, main_run, smi, label="ivf-int8",
                                      dtype=torch.int8, rounds=1)
            kernels.append(check_ivf_kernel(torch, np, ivf8_run, smi, opts.ivf_baseline))
            del ivf8_run["engine"]
            runs += [int8_run, ivf8_run]
            log(f"[int8] phase 6 took {time.perf_counter() - t0:.1f} s")
        if 7 in phases:
            t0 = time.perf_counter()
            runs += drive_hash_path(torch, np, work, smi)
            log(f"[hash] phase 7 took {time.perf_counter() - t0:.1f} s")
        if 8 in phases:
            t0 = time.perf_counter()
            hnsw_run = drive_hnsw_path(torch, np, work, smi)
            check_hnsw_recall(torch, np, hnsw_run, smi)
            check_hnsw_against_cpu(torch, np, hnsw_run, work, cpu_models)
            profile_hnsw_batch(torch, np, hnsw_run, smi)
            hnsw8_run = drive_hnsw_int8(torch, np, hnsw_run, smi)
            del hnsw_run["engine"]
            runs += [hnsw_run, hnsw8_run]
            log(f"[hnsw] phase 8 took {time.perf_counter() - t0:.1f} s")
        if 9 in phases:
            t0 = time.perf_counter()
            train_run = drive_training_path(torch, np, work, smi)
            check_trained_against_cpu(torch, np, train_run, work)
            random_run = serve_stack(torch, np, work, save_random_stack(torch, work, train_run),
                                     train_run["corpus"], smi, "random-init")
            log(f"[train] {smi}: hard-set Hit@5 over the same 56 questions (reported, not "
                f"gated): trained stack {train_run['serve']['hit5']:.4f}, random-init stack "
                f"{random_run['hit5']:.4f}")
            del random_run["engine"], train_run["serve"]["engine"]
            rr_len = train_run["rr"].max_len
            del train_run["emb"], train_run["rr"]
            check_train_against_cpu(torch, np, work / "trained", rr_len, smi)
            check_resume(torch, np, work, smi)
            check_reproducible(torch, np, rr_len, smi)
            profile_train_steps(torch, rr_len, smi)
            runs.append(train_run)
            log(f"[train] phase 9 took {time.perf_counter() - t0:.1f} s")
        if 10 in phases:
            t0 = time.perf_counter()
            runs += drive_sharded_tier(torch, np, work, main_run, int8, smi)
            log(f"[sharded] phase 10 took {time.perf_counter() - t0:.1f} s")
        if 11 in phases:
            t0 = time.perf_counter()
            runs += drive_phase_11(torch, np, work, main_run, work / "trained" / "bge", smi)
            log(f"[phase-11] phase 11 took {time.perf_counter() - t0:.1f} s")
        if 12 in phases:
            t0 = time.perf_counter()
            runs.append(drive_phase_12(torch, np, work, main_run, cpu_models, smi, kernels,
                                       flash_baseline))
            log(f"[flash] phase 12 took {time.perf_counter() - t0:.1f} s")
        if 13 in phases:
            t0 = time.perf_counter()
            runs.append(drive_phase_13(torch, np, work, smi))
            log(f"[bert-base] phase 13 took {time.perf_counter() - t0:.1f} s")
        if 14 in phases:
            t0 = time.perf_counter()
            runs.append(drive_phase_14(torch, np, work, smi))
            log(f"[bert-base-d256] phase 14 took {time.perf_counter() - t0:.1f} s")
        if 15 in phases:
            t0 = time.perf_counter()
            runs += drive_phase_15(torch, np, work, main_run, smi, kernels, attn_baseline,
                                   flash_baseline)
            log(f"[long] phase 15 took {time.perf_counter() - t0:.1f} s")
        if 16 in phases:
            t0 = time.perf_counter()
            runs += drive_phase_16(torch, np, main_run, smi, kernels, bwd_baseline, parts16)
            log(f"[flash-train] phase 16 took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # launches over the main paths, each counted from 0 around its run
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


ALL_PHASES = frozenset(range(1, 17))
# what a phase reads from an earlier one: phase 3's main run or the CPU
# models it loads (4-6, 8, 10-12, 15, 16 (a)), phase 6's int8 index (10),
# phase 9's trained encoder (11)
PHASE_NEEDS = {4: {3}, 5: {3}, 6: {3}, 8: {3}, 10: {3, 6}, 11: {3, 9}, 12: {3}, 15: {3}}


def selected_phases(arg: str | None) -> tuple[frozenset, str]:
    """``--phases``' list as the phases to run, with the phases they need
    and phase 1 (the build), and phase 16's parts ("abc" unless the list
    names some: ``16a``, ``16c``); every phase when ``arg`` is None."""
    if arg is None:
        return ALL_PHASES, "abc"
    phases, parts = {1}, ""
    for tok in filter(None, (t.strip() for t in arg.split(","))):
        m = re.fullmatch(r"(\d+)([abc]*)", tok)
        if not m or int(m.group(1)) not in ALL_PHASES or (m.group(2) and m.group(1) != "16"):
            raise ValueError(f"unknown phase {tok!r} (1-16; 16a, 16b, 16c)")
        phases.add(int(m.group(1)))
        if m.group(1) == "16":
            parts += m.group(2) or "abc"
    parts = "".join(sorted(set(parts)))
    if "a" in parts:
        phases.add(3)
    todo = list(phases)
    while todo:
        for need in PHASE_NEEDS.get(todo.pop(), ()):
            if need not in phases:
                phases.add(need)
                todo.append(need)
    return frozenset(phases), parts or "abc"


if __name__ == "__main__":
    sys.exit(main())
