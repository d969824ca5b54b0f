"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``financial_rag_system_tpu_torch`` end to end on the card, in
four phases; any failure raises and the script exits non-zero:

0. the card: name, power limit and compute capability (Hopper, 9.0);
1. build: every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a``
   into ``build/torch_kernels/`` (all sources in parallel);
2. each kernel against its plain PyTorch version at the main path's
   shapes, with its time, the plain version's, a PyTorch library call's
   where one computes the same function, and its bound on the H100;
3. the main path: ``build_default_engine(device="cuda")`` over
   random-init full-width BGE-small and MiniLM-L6 checkpoints and a
   persisted 131,072-row flat index with a 368-wide token store; three
   single asks, two bursts of 32 concurrent asks (one fused batch each)
   and a cache hit,
   with the kernels' launch counts read around the run, then one batch
   checked against the same pipeline run on the CPU.

The last lines are the ``kernels`` JSON line, the card's name and power
limit as ``nvidia-smi`` gives them, and ``{"ok": true, "device": ...}``.
Nothing is fetched; weights and data come from fixed seeds.
"""

from __future__ import annotations

import asyncio
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

# main-path shapes
B, N, D, K = 32, 131_072, 384, 15
N_TICKERS, DOC_TYPES = 50, ("10-K", "10-Q", "8-K")
DLEN = 368        # token-store width measured at 1000-character chunks
PAIRS = B * K     # 480 rerank pairs per fused batch of 32
SEED = 0


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
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


def check_topk(torch, np, smi: str) -> dict:
    from financial_rag_system_tpu_torch.ops.topk import masked_topk, masked_topk_plain

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
    return {
        "name": "masked_topk", "route": "cuda",
        "source": f"{PACKAGE}/csrc/masked_topk.cu",
        "replaces": "financial_rag_system_tpu/ops/topk.py:99",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def check_attention_at(torch, np, smi: str, p: int, s: int, h: int = 12) -> dict:
    from financial_rag_system_tpu_torch.ops import attention as attn

    rng = np.random.default_rng(SEED + s)
    dev = torch.device("cuda")
    q, k, v = (torch.tensor(rng.standard_normal((p, s, h, 32)), dtype=torch.float32,
                            device=dev) for _ in range(3))
    lens = rng.integers(1, s + 1, p)
    lens[0] = s
    mask_np = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    mask_np[-1] = 0                              # a fully padded pair
    mask = torch.tensor(mask_np, device=dev)
    inv = 1.0 / 32 ** 0.5
    got = attn.encoder_self_attention(q, k, v, mask, inv)
    torch.cuda.synchronize()
    ref = attn.encoder_self_attention_plain(q, k, v, mask, inv)
    if not torch.isfinite(got).all():
        raise AssertionError(f"attention at S={s}: non-finite output")
    err = float((got - ref).abs().max())
    if err > 1e-2:
        raise AssertionError(f"attention at S={s} differs by {err} > 1e-2")
    qs, kb, vb = (t.contiguous() for t in attn._scaled_inputs(q, k, v, inv))
    ms = median_ms(lambda: attn.pair_attention_kernel(qs, kb, vb, mask), reps=20)
    plain_ms = median_ms(
        lambda: attn.encoder_self_attention_plain(q, k, v, mask, inv), reps=5
    )
    # yardstick only: one PyTorch call for the same function (the port never calls it)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (qs, kb, vb))
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = median_ms(lambda: sdpa(qh, kh, vh, attn_mask=bias, scale=1.0), reps=20)
    nbytes = 4 * p * s * h * 32 * 2 + p * s * 4   # q, k, v in and context out, bf16
    b_ms, b_by = bound_ms(nbytes, 4.0 * p * h * s * s * 32)
    log(f"[attention] {smi}: P={p} S={s} H={h} d=32: max_abs_err {err:.3g}, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def check_attention(torch, np, smi: str) -> dict:
    rerank = check_attention_at(torch, np, smi, PAIRS, 400)
    check_attention_at(torch, np, smi, B, 32)     # the query embed's shape
    return {
        "name": "pair_attention", "route": "cuda",
        "source": f"{PACKAGE}/csrc/pair_attention.cu",
        "replaces": "financial_rag_system_tpu/ops/attention.py:48",
        **rerank,
    }


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


def write_index(torch, np, work: Path) -> None:
    """131,072 unit rows, ~50 tickers x 3 doc types, a 368-wide token
    store of random wordpiece ids, short texts as payloads."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.models.tokenizer import SEP_ID

    rng = np.random.default_rng(SEED + 1)
    emb = rng.standard_normal((N, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    lens = rng.integers(DLEN // 2, DLEN + 1, N)
    dtok = rng.integers(1000, 30522, (N, DLEN)).astype(np.int32)
    dtok[np.arange(N), lens - 1] = SEP_ID
    dtok *= np.arange(DLEN)[None, :] < lens[:, None]
    tick = rng.integers(0, N_TICKERS, N)
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
    index.save(str(work / "index"))


def drive_main_path(torch, np, work: Path, smi: str) -> dict:
    from financial_rag_system_tpu_torch.models.tokenizer import pad_batch
    from financial_rag_system_tpu_torch.obs.tracing import get_tracer
    from financial_rag_system_tpu_torch.ops.attention import encoder_self_attention
    from financial_rag_system_tpu_torch.ops.topk import masked_topk
    from financial_rag_system_tpu_torch.serving.app import build_default_engine
    from financial_rag_system_tpu_torch.utils.config import reset_config

    os.environ.update({
        "RAG_TPU_BGE_DIR": str(work / "bge"),
        "RAG_TPU_RERANKER_DIR": str(work / "reranker"),
        "INDEX_DIR": str(work / "index"),
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
    singles = [("what was revenue growth in the last quarter", tickers[3], None),
               ("analyze the margin trajectory", tickers[7], "10-K"),
               ("supply chain risk", tickers[11], None)]
    burst = [(f"question {i} about segment results and liquidity", tickers[i % N_TICKERS],
              DOC_TYPES[i % 3] if i % 2 else None) for i in range(B)]

    async def scenario():
        await engine.startup()
        try:
            answers = [await engine.ask(q, t, 5, d) for q, t, d in singles]
            # two bursts: the first pays the one-time costs of a new batch
            # shape (allocator growth, GEMM heuristics); the second is warm
            for n in range(2):
                answers += await asyncio.gather(*[
                    engine.ask(f"{q} (round {n})", t, 5, d) for q, t, d in burst
                ])
            await asyncio.sleep(0.2)  # write-behind cache saves land
            repeat = await engine.ask(*singles[0][:2], 5, singles[0][2])
        finally:
            await engine.shutdown()
        return answers, repeat

    masked_topk.launches = 0
    encoder_self_attention.launches = 0
    answers, repeat = asyncio.run(scenario())
    launches = {"masked_topk": masked_topk.launches,
                "pair_attention": encoder_self_attention.launches}

    n_batches = len(batches)
    if [n for n, _ in batches] != [1, 1, 1, B, B]:
        raise AssertionError(f"batch sizes {[n for n, _ in batches]} != [1, 1, 1, {B}, {B}]")
    if launches["masked_topk"] != n_batches:
        raise AssertionError(f"top-k launches {launches} for {n_batches} batches")
    if launches["pair_attention"] != 18 * n_batches:
        raise AssertionError(f"attention launches {launches}: want 18 per fused batch")
    for a in answers:
        scores = [s["score"] for s in a["sources"]]
        if a["cached"] or not 1 <= len(scores) <= 5 or scores != sorted(scores, reverse=True):
            raise AssertionError(f"bad answer {a}")
        if not np.isfinite(scores).all():
            raise AssertionError("non-finite rerank score")
    if not (repeat["cached"] and repeat["provider"] == "Cache"):
        raise AssertionError("the repeated query was not a cache hit")

    tok = engine.embedder.tokenizer
    lq = pad_batch([tok.encode(q, 64) for q, _, _ in burst])[0].shape[1]
    snap = get_tracer().metrics_snapshot()
    stage = {m: snap[m] for m in ("fused_tokenize_ms", "fused_device_ms", "fused_assemble_ms")}
    log(f"[main] {smi}: launches {launches} over {n_batches} fused batches; pair length "
        f"{lq + DLEN} ({lq} query + {DLEN} doc); batch walls (size, ms) {batches}")
    log(f"[main] {smi}: stage split over all batches: {json.dumps(stage)}")
    return {"launches": launches, "engine": engine, "burst": burst, "lq": lq}


def fused_inputs(torch, engine, queries, device):
    """Tokenized batch + filters for ``fused_two_stage``, as the engine
    builds them (ids padded to the batch and length buckets)."""
    from financial_rag_system_tpu_torch.models.tokenizer import pad_batch

    tok = engine.embedder.tokenizer
    ids, types, mask = pad_batch([tok.encode(q, 64) for q, _, _ in queries])
    codes = [engine.index.store.query_codes(t, d) for _, t, d in queries]
    qf = torch.tensor(codes + [(-3, -3)] * (ids.shape[0] - len(codes)),
                      dtype=torch.int32, device=device)
    return [torch.as_tensor(a, device=device) for a in (ids, types, mask)] + [qf]


def profile_batch(torch, main: dict, smi: str) -> None:
    """Device time by kernel over one fused batch of 32 (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from financial_rag_system_tpu_torch.ops.fused_query import fused_two_stage

    engine = main["engine"]
    emb, codes, dtok = engine.index._arrays
    args = fused_inputs(torch, engine, main["burst"], "cuda")

    def run():
        out = fused_two_stage(engine.embedder.model, engine.reranker.model, *args,
                              emb, codes, dtok, N, rerank_cfg=engine.reranker.cfg, k=K)
        torch.cuda.synchronize()
        return out

    run()
    t0 = time.perf_counter()
    run()
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
    log(f"[profile] {smi}: fused_two_stage on {B} queries: wall {wall:.2f} ms, device "
        f"{total:.2f} ms in {len(rows)} kernels")
    for ms, count, key in rows[:15]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<4d} {key[:90]}")


def check_against_cpu(torch, np, main: dict) -> None:
    """One small fused batch on the card against the same pipeline on the
    CPU (plain attention and top-k), from the same checkpoints and index."""
    from financial_rag_system_tpu_torch.index.flat import FlatIndex
    from financial_rag_system_tpu_torch.models.embedder import get_embedder
    from financial_rag_system_tpu_torch.models.reranker import get_reranker
    from financial_rag_system_tpu_torch.ops.fused_query import fused_two_stage
    from financial_rag_system_tpu_torch.utils.config import get_config

    engine = main["engine"]
    cpu_index = FlatIndex.load(get_config().index_dir, device="cpu")
    emb_cpu, rr_cpu = get_embedder(device="cpu"), get_reranker(device="cpu")
    queries = main["burst"][:2]
    outs = []
    for dev, index, e, r in (("cuda", engine.index, engine.embedder, engine.reranker),
                             ("cpu", cpu_index, emb_cpu, rr_cpu)):
        emb, idx_codes, dtok = index._arrays
        out = fused_two_stage(e.model, r.model, *fused_inputs(torch, engine, queries, dev),
                              emb, idx_codes, dtok, N, rerank_cfg=r.cfg, k=K)
        outs.append([x.cpu().numpy()[: len(queries)] for x in out])
    (rows_g, bi_g, ce_g), (rows_c, bi_c, ce_c) = outs
    bi_err = float(np.abs(bi_g - bi_c).max())
    if bi_err > 2e-3:
        raise AssertionError(f"bi scores: card vs CPU differ by {bi_err}")
    ce_errs, overlap = [], []
    for q in range(len(queries)):
        pos_c = {int(r): j for j, r in enumerate(rows_c[q])}
        common = [(j, pos_c[int(r)]) for j, r in enumerate(rows_g[q]) if int(r) in pos_c]
        overlap.append(len(common))
        ce_errs += [abs(float(ce_g[q, a]) - float(ce_c[q, b])) for a, b in common]
    ce_err = max(ce_errs)
    if min(overlap) < K - 2 or ce_err > 5e-2:
        raise AssertionError(f"card vs CPU: row overlap {overlap}, ce err {ce_err}")
    log(f"[main] card vs CPU on {len(queries)} queries: bi err {bi_err:.3g}, "
        f"rows shared {overlap} of {K}, ce err {ce_err:.3g}")


def main() -> int:
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
    phase_build()
    kernels = [check_topk(torch, np, smi), check_attention(torch, np, smi)]
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        t0 = time.perf_counter()
        write_checkpoints(torch, work)
        write_index(torch, np, work)
        log(f"[main] checkpoints and index written in {time.perf_counter() - t0:.1f} s")
        main_run = drive_main_path(torch, np, work, smi)
        check_against_cpu(torch, np, main_run)
        profile_batch(torch, main_run, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for kern in kernels:
        kern["launches"] = main_run["launches"][kern["name"]]
        if kern["launches"] < 1:
            raise AssertionError(f"{kern['name']} never launched on the main path")
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
