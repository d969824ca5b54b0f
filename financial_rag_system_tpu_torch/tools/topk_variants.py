"""Time variants of the masked top-k kernels (kernel 1, flat; kernel 3, IVF probe) on one NVIDIA GPU.

    python3 financial_rag_system_tpu_torch/tools/topk_variants.py [--parent OLD/.../csrc]
                                                                  [--only NAME,NAME]
                                                                  [--width D]

Builds copies of ``financial_rag_system_tpu_torch/csrc/masked_topk.cu`` and
``ivf_probe.cu`` with their sources changed in one way, and runs each at
the main path's shapes: kernel 1 over B 32 x N 131,072 x D 384 in
bf16 and int8 and over 1,048,576 bf16 rows, kernel 3 over a 1M-row
packing of 16,384 tiles of 128 (512 clusters of 32 tiles, each about
half live) on a list of 544 active tiles (17 clusters, as the phase-4
batch of random-init queries probes) and on one of 10,496 (328 clusters,
as a diverse batch probes), in bf16 and int8.  ``--width D`` gives every
row D values in place of 384 (``--width 1536``: rows above WIDE_ABOVE_D
values, which take the wide kernel in both types; the 1M-row flat case is
left out there).
Variants:

- ``as_is``: the kernels as the port builds them, on the plan
  ``topk_plan`` / ``probe_plan`` makes (two blocks an SM, 8 stages of
  8 KB at D 384; the wide kernel's one block an SM and its ring);
- ``stages_3``, ``stages_4``, ``stages_6``: the ring that deep;
- ``per_sm_1``, ``per_sm_1_16``: one block an SM, with 8 and 16 stages
  (the wide kernel: 8 stages, and as many up to 16 as fit);
- ``bulk_2``, ``bulk_8``, ``no_bulk``: a batch is sorted and merged
  whole where more than 2 or 8 of its candidates enter, or never (the
  kernel: more than 4); below that each entering candidate is inserted
  on its own;
- ``merge_8``, ``merge_16``: pass 2 with 8 or 16 warps a query (the
  kernel: 4);
- ``no_select``: the scores are read but no candidate is offered to a
  list (wrong output): what the selection costs;
- ``loads_only``: no product and no selection (wrong output): what the
  TMA walk alone takes (the wide kernel: its scoring warpgroup waits for
  each box and releases it, and issues no ``wgmma``);
- ``wide_bufs_1``: the wide kernel with one score buffer (the kernel:
  two), so a tile is scored only once the selecting warps are done with
  the one before;
- ``wide_selectors_8``: the wide kernel with 8 selecting warps of four
  queries each (the kernel: 16 of two), 13 warps a block;
- ``old_select``: the selection of the design before, with the new
  loads: each lane keeps one query's 32-entry list in registers, inserts
  its warp's 8 rows of each tile with a compare-and-swap chain, and the 8
  warps' lists merge in shared memory at the end (``merge_warp_lists``)
  before pass 2.

The select path above k 32 (``topk_select.cuh``) has variants of its own,
run on its cases: kernel 1 over B 32 x N 131,072 x D 384 at k 100, 1024
and 2048 in bf16, at k 1024 in int8 and on tie-heavy exact bf16 rows (six
distinct vectors), over 1,048,580 bf16 rows at k 1024, and kernel 3 on the
diverse list at k 1024:

- ``select_as_is``: the path as the port builds it (digits of 11, 11 and
  10 bits; one block sorts up to 4,096 survivors);
- ``select_digits_8``, ``select_digits_12``: digits of 8 bits (four
  passes over the score table) or of 12 (12, 12 and 8);
- ``select_sort_1024``, ``select_sort_2048``: a block sorts at most 1,024
  or 2,048 survivors, the rest merge in device memory;
- ``select_chunk_2048``, ``select_chunk_8192``: a block of the passes
  over the table loads 2 or 8 float4 a thread at once (the kernel: 4);
- ``select_sweeps_4``, ``select_sweeps_16``: 4 or 16 blocks an SM sweep
  the table (the kernel: 8);
- ``select_one_wave``: the digit and collect kernels' launch bounds ask
  for 8 blocks an SM (32 registers), so the passes' grid runs in one wave;
- ``select_two_walks``: the walk over the corpus launched twice: what a
  second walk costs, the least that a design of two walks in place of the
  score table would add.

With ``--parent``, an earlier checkout's two-pass kernels (its C entries:
1,024 rows a split for kernel 1, min(entries, 512) splits for kernel 3)
run on the same inputs too.  Each line gives the variant's device time
a call (the profiler's kernel times over 10 calls: pass 1 + pass 2), its
median CUDA-event time a call (20 calls, each waited for) and
over 20 calls queued back to back, and whether its output equals
``as_is``'s bit for bit; before them, each variant's ``ptxas -v``
registers and spills, and the host time of kernel 1's wrapper beside its
C entry alone.  A select-path line gives the device time by kernel (the
walk, the digit passes, collect, sort and merges) instead of by pass,
and ``select_as_is`` also each launch's in the order launched.  The card's name and power limit head the output.  The variants
build in parallel, into ``build/topk_variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

CSRC = Path(__file__).resolve().parents[1] / "csrc"
OUT = REPO / "build" / "topk_variants"
B, N, D, K = 32, 131_072, 384, 15
N_BIG = 1_048_576
N_BIG_FLAT = 1_048_580  # the IVF corpus's flat size, the select path's large case
TILE, CLUSTER_TILES = 128, 32


def patched(text: str, old: str, new: str, name: str = "topk_common.cuh") -> str:
    if old not in text:
        raise RuntimeError(f"{name} no longer holds {old[:60]!r}")
    return text.replace(old, new)


OFFER = "offer<Q>(ls, li, ts, ti, fresh, cs, ci, ok, enter, lane, k);"
# keeps each lane's best score (and a real id) so nothing is optimised away
KEEP_BEST = ("for (int qq = 0; qq < Q; ++qq) "
             "if (ok[qq] && cs[qq] > ls[qq]) { ls[qq] = cs[qq]; li[qq] = ci[qq]; }")
SCORE = ("score_box<T>(acc, qs + b * kQBox, ring + s * kBox, "
         "min(4, (row_bytes - b * kBoxBytes) / 32),\n                 warp, lane);")
# the wide kernel's products of a box (score_walk)
WIDE_SCORE = ("        Elem<T>::wgmma(acc, wgmma_desc_sw128(rows + 32 * kk), "
              "wgmma_desc_sw128(qs + 32 * kk),\n                       (b | kk) != 0);")

# the two-pass design's selection: lane = query, a 32-entry sorted list in
# registers, the warp's 8 rows of each tile inserted by a swap chain, the
# warps' lists merged in shared memory (the score buffers) at the end
OLD_SELECT_FNS = r'''
constexpr int kOldK = 32;  // the two-pass design's list: 32 entries a lane
__device__ __forceinline__ bool old_insert(float (&ls)[kOldK], int (&li)[kOldK], float s, int id) {
  if (!before(s, id, ls[kOldK - 1], li[kOldK - 1])) return false;
  ls[kOldK - 1] = s;
  li[kOldK - 1] = id;
#pragma unroll
  for (int p = kOldK - 1; p > 0; --p) {
    if (before(ls[p], li[p], ls[p - 1], li[p - 1])) {
      const float t = ls[p]; ls[p] = ls[p - 1]; ls[p - 1] = t;
      const int u = li[p]; li[p] = li[p - 1]; li[p - 1] = u;
    }
  }
  return true;
}

template <typename T, bool kIvf, bool kWide>
__device__ __forceinline__ void consume_old(const Smem& m, int nbox, int row_bytes, int stages,
                                            int B, int qb0, int n, int n_valid, int k,
                                            const int32_t* __restrict__ qf, int warp, int lane,
                                            float (&ls)[kQueries<kWide>],
                                            int (&li)[kQueries<kWide>]) {
  if constexpr (kWide) {  // the wide kernel keeps its own selection
    consume<T, kIvf, true>(m, nbox, row_bytes, stages, B, qb0, n, n_valid, k, qf, warp, lane, ls,
                           li);
    return;
  }
  using Acc = typename Elem<T>::Acc;
  const int q = qb0 + lane;
  const bool live = q < B;
  const int tq = live ? qf[2 * q] : -3, dq = live ? qf[2 * q + 1] : -3;
  float os[kOldK];
  int oi[kOldK];
#pragma unroll
  for (int j = 0; j < kOldK; ++j) { os[j] = -INFINITY; oi[j] = kNoId; }
  const uint32_t qs = smem_addr(m.q), ring = smem_addr(m.ring);
  mbar_wait(m.qbar, 0);
  int s = 0, ph = 0;
  for (int tile = 0;; ++tile) {
    const int slot = tile % kSlots;
    mbar_wait(&m.sfull[slot], (tile / kSlots) & 1);
    const unsigned char* sl = m.slots + slot * kSlotBytes;
    const int base = *reinterpret_cast<const volatile int*>(sl + kSlotBase);
    if (base < 0) break;
    Acc acc[2][4] = {};
    for (int b = 0; b < nbox; ++b) {
      mbar_wait(&m.full[s], ph);
      score_box<T>(acc, qs + b * kQBox, ring + s * kBox, min(4, (row_bytes - b * kBoxBytes) / 32),
                   warp, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&m.empty[s]);
      if (++s == stages) { s = 0; ph ^= 1; }
    }
    float* sc = m.sc + (tile & 1) * kQB * kScStride;
    store_scores(sc, acc, warp, lane);
    __syncwarp();
    const int32_t* codes0 = reinterpret_cast<const int32_t*>(sl);
    const int32_t* codes1 = reinterpret_cast<const int32_t*>(sl + kSlotCodes1) + (n & 3);
    const int32_t* gids = reinterpret_cast<const int32_t*>(sl + kSlotGids);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = warp * 8 + j;
      const bool ok = live && (kIvf ? gids[r] >= 0 : base + r < n_valid) &&
                      (tq == -1 || tq == codes0[r]) && (dq == -1 || dq == codes1[r]);
      if (ok) old_insert(os, oi, sc[lane * kScStride + r], base + r);
    }
    named_barrier(1, kConsumers * 32);
    __syncwarp();
    if (lane == 0) mbar_arrive(&m.sempty[slot]);
  }
  // the warps' lists merge into warp 0's, one warp at a time, through
  // the score buffers
  float* ms = m.sc;
  int* mi = reinterpret_cast<int*>(m.sc + kQB * kOldK);
  for (int w = 1; w < kConsumers; ++w) {
    named_barrier(1, kConsumers * 32);
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < kOldK; ++j) { ms[lane * kOldK + j] = os[j]; mi[lane * kOldK + j] = oi[j]; }
    }
    named_barrier(1, kConsumers * 32);
    if (warp == 0) {
      for (int j = 0; j < kOldK; ++j)
        if (!old_insert(os, oi, ms[lane * kOldK + j], mi[lane * kOldK + j])) break;
    }
  }
  // warp 0's lists to the warps that own the queries, through shared memory
  named_barrier(1, kConsumers * 32);
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < kOldK; ++j) { ms[lane * kOldK + j] = os[j]; mi[lane * kOldK + j] = oi[j]; }
  }
  named_barrier(1, kConsumers * 32);
#pragma unroll
  for (int qq = 0; qq < kQPW; ++qq) {
    const int qi = warp * kQPW + qq;
    ls[qq] = lane < k ? ms[qi * kOldK + lane] : -INFINITY;
    li[qq] = lane < k ? mi[qi * kOldK + lane] : kNoId;
  }
}

// the block's lists: entry j'''


SOURCES = ("sm90.cuh", "mma_bf16.cuh", "topk_common.cuh", "topk_select.cuh", "masked_topk.cu",
           "ivf_probe.cu")
# the walk's launch in each kernel's source (select_two_walks repeats the
# select path's)
WALK_LAUNCH = {
    "masked_topk.cu":
        "  masked_topk_kernel<T, kSelect, kWide><<<grid, kWide ? kWideThreads : kThreads, smem, st>>>(",
    "ivf_probe.cu":
        "  ivf_probe_kernel<T, kSelect, kWide><<<grid, kWide ? kWideThreads : kThreads, smem, st>>>(",
}


def select_variant_sources() -> dict[str, dict[str, str]]:
    """Each select-path variant's changed sources, by file name."""
    sel = (CSRC / "topk_select.cuh").read_text()

    def const(name: str, value: int) -> dict[str, str]:
        m = re.search(rf"constexpr int {name} = (\d+);", sel)
        if m is None:
            raise RuntimeError(f"topk_select.cuh no longer holds {name}")
        return {"topk_select.cuh": sel.replace(m[0], f"constexpr int {name} = {value};")}

    return {
        "select_as_is": {},
        "select_digits_8": const("kDigitBits", 8),
        "select_digits_12": const("kDigitBits", 12),
        "select_sort_1024": const("kSortCap", 1024),
        "select_sort_2048": const("kSortCap", 2048),
        "select_chunk_2048": const("kChunk", 2048),
        "select_chunk_8192": const("kChunk", 8192),
        "select_sweeps_4": const("kSweepsAnSm", 4),
        "select_sweeps_16": const("kSweepsAnSm", 16),
        "select_one_wave": {"topk_select.cuh": patched(patched(
            sel, "__global__ void __launch_bounds__(kSelThreads)\ndigit_kernel(",
            "__global__ void __launch_bounds__(kSelThreads, kSweepsAnSm)\ndigit_kernel(",
            "topk_select.cuh"),
            "__global__ void __launch_bounds__(kSelThreads) collect_kernel(",
            "__global__ void __launch_bounds__(kSelThreads, kSweepsAnSm) collect_kernel(",
            "topk_select.cuh")},
        "select_two_walks": {f: patched((CSRC / f).read_text(), launch,
                                        "  for (int twice = 0; twice < (kSelect ? 2 : 1); ++twice)\n"
                                        + launch, f)
                             for f, launch in WALK_LAUNCH.items()},
    }


def variant_sources() -> dict[str, dict[str, str]]:
    """Each variant's changed sources, by file name: the list path's
    change topk_common.cuh, the select path's their own."""
    base = (CSRC / "topk_common.cuh").read_text()
    lists = {
        "as_is": base,
        "bulk_2": patched(base, "constexpr int kBulk = 4;", "constexpr int kBulk = 2;"),
        "bulk_8": patched(base, "constexpr int kBulk = 4;", "constexpr int kBulk = 8;"),
        "no_bulk": patched(base, "constexpr int kBulk = 4;", "constexpr int kBulk = 32;"),
        "merge_8": patched(patched(base, "constexpr int kMergeWarps = 4;",
                                   "constexpr int kMergeWarps = 8;"),
                           "constexpr int kMaxChunks = 3;", "constexpr int kMaxChunks = 2;"),
        "merge_16": patched(patched(base, "constexpr int kMergeWarps = 4;",
                                    "constexpr int kMergeWarps = 16;"),
                            "constexpr int kMaxChunks = 3;", "constexpr int kMaxChunks = 1;"),
        "no_select": patched(base, OFFER, KEEP_BEST),
        "loads_only": patched(patched(patched(base, OFFER, KEEP_BEST), SCORE, ""), WIDE_SCORE,
                              "        ;"),
        "wide_bufs_1": patched(base, "constexpr int kScBufs = 2;", "constexpr int kScBufs = 1;"),
        "wide_selectors_8": patched(base, "constexpr int kSelectors = 16;",
                                    "constexpr int kSelectors = 8;"),
        "old_select": patched(base, "\n// the block's lists: entry j", OLD_SELECT_FNS),
    }
    out = {name: {"topk_common.cuh": text} for name, text in lists.items()}
    for f in ("masked_topk.cu", "ivf_probe.cu"):
        out["old_select"][f] = patched((CSRC / f).read_text(), "consume<T, ", "consume_old<T, ", f)
    return {**out, **select_variant_sources()}


# plan changes: (stages, blocks an SM) in place of the plan's
PLAN_VARIANTS = {"stages_3": (3, 2), "stages_4": (4, 2), "stages_6": (6, 2), "per_sm_1": (8, 1),
                 "per_sm_1_16": (16, 1)}


def build(names: list[str]) -> dict[str, dict[str, ctypes.CDLL]]:
    """Each variant's two libraries, compiled in parallel; prints ptxas's
    registers and spills for each kernel."""
    from financial_rag_system_tpu_torch.ops import _cuda

    sources = variant_sources()
    procs = []
    for name in names:
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in SOURCES:
            (d / f).write_text(sources[name].get(f) or (CSRC / f).read_text())
        for lib in ("masked_topk", "ivf_probe"):
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(d / f"{lib}.so"),
                   str(d / f"{lib}.cu")]
            procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True)))
    libs: dict[str, dict[str, ctypes.CDLL]] = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}/{lib} did not build:\n{log}")
        regs = re.findall(r"Function properties for (\S*(?:topk|probe|digit|collect|sort)_kernel"
                          r"\S*)\n.*?"
                          r"(\d+) bytes spill stores, (\d+) bytes spill loads\n.*?Used (\d+) registers",
                          log, re.S)
        for fn, st, ld, r in regs:
            kind = "int8" if "Ia" in fn or "signed" in fn else "bf16"
            wide = " wide" if re.search(r"Lb[01]ELb1EE", fn) else ""
            print(f"[ptxas] {name:11s} {lib} {kind}{wide}: {r} registers, spill stores {st} B, "
                  f"loads {ld} B", flush=True)
        for line in sorted(set(re.findall(r"^.*warning.*$", log, re.M | re.I))):
            print(f"[ptxas] {name:11s} {lib}: {line.strip()}", flush=True)
        cdll = ctypes.CDLL(str(OUT / name / f"{lib}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        if lib == "masked_topk":
            for fn in (cdll.masked_topk, cdll.masked_topk_s8):
                fn.argtypes = [p] * 4 + [i] * 7 + [p] * 3
        else:
            for fn in (cdll.ivf_probe, cdll.ivf_probe_s8):
                fn.argtypes = [p] * 6 + [i] * 8 + [p] * 3
        libs.setdefault(name, {})[lib] = cdll
    return libs


def kernel_split(torch, fn, calls: int = 10) -> dict[str, float]:
    """Device ms a call by kernel (its short name): the profiler's kernel
    times over `calls` calls, each launch counted once."""
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = {(e.name, e.time_range.start): e.device_time for e in prof.events()
                if e.device_time > 0 and not e.name.startswith(("Memcpy", "Memset"))}
        if seen:
            split: dict[str, float] = {}
            for (name, _), us in seen.items():
                short = name.replace("(anonymous namespace)::", "").removeprefix("void ")
                short = short.split("(")[0].split("<")[0].split("::")[-1]
                split[short] = split.get(short, 0.0) + us / calls / 1e3
            return split
    return {}


def launch_sequence(torch, fn, calls: int = 5) -> list[tuple[str, float]]:
    """Each launch of a call in the order launched: (kernel, device us),
    the mean over `calls` calls; empty if the profiler's records do not
    split evenly into the calls."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    seen = sorted({(e.time_range.start, e.name, e.device_time) for e in prof.events()
                   if e.device_time > 0 and not e.name.startswith(("Memcpy", "Memset"))})
    if not seen or len(seen) % calls:
        return []
    n = len(seen) // calls
    short = [s[1].replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
             .split("<")[0].split("::")[-1] for s in seen[:n]]
    return [(short[j], statistics.mean(seen[i * n + j][2] for i in range(calls)))
            for j in range(n)]


def device_ms(torch, fn, calls: int = 10) -> tuple[float, float]:
    """Device ms a call: (pass 1, pass 2), the profiler's kernel times
    (each launch counted once) over `calls` calls."""
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = {(e.name, e.time_range.start): e.device_time for e in prof.events()
                if e.device_time > 0 and not e.name.startswith(("Memcpy", "Memset"))}
        if seen:
            merge = sum(t for (name, _), t in seen.items() if "merge_kernel" in name)
            return (sum(seen.values()) - merge) / calls / 1e3, merge / calls / 1e3
    return float("nan"), float("nan")


def events_ms(torch, fn, reps: int = 20) -> tuple[float, float]:
    """(median a call with each waited for, mean over reps queued back to back)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    one = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        one.append(a.elapsed_time(b))
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return statistics.median(one), a.elapsed_time(b) / reps


def cases(torch):
    """The inputs: (name, kind, args, n_rows) with kind 'flat' or 'probe'."""
    from financial_rag_system_tpu_torch.index.flat import quantize_int8

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")

    def unit(rows):
        return torch.nn.functional.normalize(torch.randn((rows, D), generator=g, device=dev), dim=1)

    q = unit(B)
    qf = torch.stack([torch.randint(-1, 50, (B,), generator=g, device=dev),
                      torch.randint(-1, 3, (B,), generator=g, device=dev)], 1).int()
    qf[:8] = -1  # a quarter of the batch unfiltered
    out = []
    for n in (N, N_BIG) if D == 384 else (N,):
        rows = unit(n)
        codes = torch.stack([torch.randint(0, 50, (n,), generator=g, device=dev),
                             torch.randint(0, 3, (n,), generator=g, device=dev)]).int()
        out.append((f"k1 bf16 N={n}", "flat", (q.bfloat16(), rows.bfloat16(), codes, qf, n, K)))
        if n == N:
            out.append((f"k1 int8 N={n}", "flat",
                        (quantize_int8(q), quantize_int8(rows), codes, qf, n, K)))
        del rows
    packed, codes, gids, lists = packing(torch, g, unit)
    for label, tl, n_tiles in lists:
        for dtype in ("bf16", "int8"):
            emb = packed.bfloat16() if dtype == "bf16" else quantize_int8(packed)
            qq = q.bfloat16() if dtype == "bf16" else quantize_int8(q)
            out.append((f"k3 {dtype} {label} ({n_tiles} tiles)", "probe",
                        (qq, qf, emb, codes, gids, tl, K)))
    return out


def packing(torch, g, unit):
    """The IVF packing: 512 clusters of 32 tiles of 128 slots, each holding
    a cluster of 1,024-3,072 rows from its start, the rest padding; and
    the real and the diverse batch's lists, (label, list, active tiles)."""
    dev = torch.device("cuda")
    n_packed = N_BIG
    packed = unit(n_packed)
    fill = torch.randint(1024, 3073, (512,), generator=g, device=dev)
    slot = torch.arange(n_packed, device=dev)
    live = (slot % (CLUSTER_TILES * TILE)) < fill[slot // (CLUSTER_TILES * TILE)]
    gids = torch.where(live, torch.randperm(n_packed, generator=g, device=dev),
                       -1).int()[None, :].contiguous()
    codes = torch.stack([torch.randint(0, 50, (n_packed,), generator=g, device=dev),
                         torch.randint(0, 3, (n_packed,), generator=g, device=dev)]).int()
    lists = []
    for label, clusters in (("real", 17), ("diverse", 328)):
        chosen = torch.randperm(512, generator=g, device=dev)[:clusters].sort().values
        tiles = (chosen[:, None] * CLUSTER_TILES + torch.arange(CLUSTER_TILES, device=dev))
        tl = torch.full((16_384,), -1, dtype=torch.int32, device=dev)
        tl[: tiles.numel()] = tiles.reshape(-1).int()
        lists.append((label, tl, tiles.numel()))
    return packed, codes, gids, lists


def select_cases(torch):
    """The select path's inputs, as cases() gives them: kernel 1 over N rows
    at k 100, 1024 and 2048 (bf16), at k 1024 in int8 and on tie-heavy
    exact bf16 rows, over N_BIG_FLAT bf16 rows at k 1024; kernel 3 on the
    diverse list at k 1024."""
    from financial_rag_system_tpu_torch.index.flat import quantize_int8

    g = torch.Generator(device="cuda").manual_seed(1)
    dev = torch.device("cuda")

    def unit(rows):
        return torch.nn.functional.normalize(torch.randn((rows, D), generator=g, device=dev), dim=1)

    def codes_for(n):
        return torch.stack([torch.randint(0, 50, (n,), generator=g, device=dev),
                            torch.randint(0, 3, (n,), generator=g, device=dev)]).int()

    q = unit(B)
    qf = torch.stack([torch.randint(-1, 50, (B,), generator=g, device=dev),
                      torch.randint(-1, 3, (B,), generator=g, device=dev)], 1).int()
    qf[:8] = -1
    rows, codes = unit(N), codes_for(N)
    out = [(f"k1 bf16 N={N} k={k}", "flat", (q.bfloat16(), rows.bfloat16(), codes, qf, N, k))
           for k in (100, 1024, 2048)]
    out.append((f"k1 int8 N={N} k=1024", "flat",
                (quantize_int8(q), quantize_int8(rows), codes, qf, N, 1024)))
    base = torch.randint(-3, 4, (6, D), generator=g, device=dev).float() / 16
    pick = lambda n: base[torch.randint(0, 6, (n,), generator=g, device=dev)].bfloat16()  # noqa: E731
    out.append((f"k1 bf16 tie-heavy N={N} k=1024", "flat", (pick(B), pick(N), codes, qf, N, 1024)))
    out.append((f"k1 bf16 N={N_BIG_FLAT} k=1024", "flat",
                (q.bfloat16(), unit(N_BIG_FLAT).bfloat16(), codes_for(N_BIG_FLAT), qf, N_BIG_FLAT,
                 1024)))
    packed, pcodes, gids, lists = packing(torch, g, unit)
    label, tl, n_tiles = lists[1]
    out.append((f"k3 bf16 {label} ({n_tiles} tiles) k=1024", "probe",
                (q.bfloat16(), qf, packed.bfloat16(), pcodes, gids, tl, 1024)))
    return out


def launcher(torch, libs, kind, args, plan_change=None):
    """A call of one variant's C entry on `args` with its own scratch."""
    from financial_rag_system_tpu_torch.index.ivf import probe_plan
    from financial_rag_system_tpu_torch.ops import _cuda
    from financial_rag_system_tpu_torch.ops.topk import TILE_ROWS, WIDE_ABOVE_D, plan_for, topk_plan

    sms = _cuda.sm_count(torch.device("cuda"))
    if kind == "flat":
        q, c, codes, qf, nv, k = args
        (b, d), n = q.shape, c.shape[0]
        plan = topk_plan(b, n, d, c.element_size(), k, sms)
        tiles = -(-n // TILE_ROWS)
    else:
        q, qf, emb, codes, gids, tl, k = args
        (b, d), n = q.shape, emb.shape[0]
        plan = probe_plan(b, tl.numel(), TILE, d, emb.element_size(), k, sms)
        tiles = tl.numel() * TILE // TILE_ROWS
    if plan_change is not None:  # the wide kernel's plan keeps one block an SM
        stages, per_sm = plan_change
        plan = plan_for(b, tiles, d * q.element_size(), k, sms, per_sm=per_sm, stages=stages,
                        ivf=kind == "probe", wide=d > WIDE_ABOVE_D)
    # a select-path variant may take larger histograms (12-bit digits), a
    # second survivor buffer (a smaller sort) or more sweeping blocks: room
    extra = b * (1 << 12) + 2 * b * k + 2 * b * plan.sweeps * (1 << 10) + 64
    words = plan.scratch + (extra if plan.path == "select" else 0)
    scratch = torch.empty(words, dtype=torch.int32, device=q.device)
    out = torch.empty(2 * b * k, dtype=torch.int32, device=q.device)
    s8 = q.dtype == torch.int8
    if kind == "flat":
        fn = libs["masked_topk"].masked_topk_s8 if s8 else libs["masked_topk"].masked_topk
        ptrs = (q.data_ptr(), c.data_ptr(), codes.data_ptr(), qf.data_ptr(), b, n, d, nv, k)
    else:
        fn = libs["ivf_probe"].ivf_probe_s8 if s8 else libs["ivf_probe"].ivf_probe
        ptrs = (q.data_ptr(), emb.data_ptr(), codes.data_ptr(), gids.data_ptr(), tl.data_ptr(),
                qf.data_ptr(), b, d, n, TILE, tl.numel(), k)

    def call():
        _cuda.launch(fn, "variant", *ptrs, plan.blocks, plan.stages, scratch.data_ptr(),
                     out.data_ptr())
        return out
    return call, plan


def parent_launcher(torch, csrc: Path, kind, args):
    """A call of an earlier checkout's two-pass C entry on `args`."""
    from financial_rag_system_tpu_torch.ops import _cuda

    name = "masked_topk" if kind == "flat" else "ivf_probe"
    d = OUT / "parent"
    d.mkdir(parents=True, exist_ok=True)
    so = d / f"{name}.so"
    if not so.exists():
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so), str(csrc / f"{name}.cu")],
                       check=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    if kind == "flat":
        q, c, codes, qf, nv, k = args
        (b, dd), n = q.shape, c.shape[0]
        splits = -(-n // 1024)
        fn = lib.masked_topk_s8 if q.dtype == torch.int8 else lib.masked_topk
        fn.argtypes = [p] * 4 + [i] * 6 + [p] * 5
        ptrs = (q.data_ptr(), c.data_ptr(), codes.data_ptr(), qf.data_ptr(), b, n, dd, nv, k, 1024)
    else:
        q, qf, emb, codes, gids, tl, k = args
        (b, dd), n = q.shape, emb.shape[0]
        splits = min(tl.numel(), 512)
        fn = lib.ivf_probe_s8 if q.dtype == torch.int8 else lib.ivf_probe
        fn.argtypes = [p] * 6 + [i] * 7 + [p] * 5
        ptrs = (q.data_ptr(), emb.data_ptr(), codes.data_ptr(), gids.data_ptr(), tl.data_ptr(),
                qf.data_ptr(), b, dd, n, TILE, tl.numel(), k, splits)
    part = torch.empty((2, b, splits, k), dtype=torch.int32, device=q.device)
    out = torch.empty(2 * b * k, dtype=torch.int32, device=q.device)

    def call():
        _cuda.launch(fn, "parent", *ptrs, part[0].data_ptr(), part[1].data_ptr(), out.data_ptr(),
                     out[b * k:].data_ptr())
        return out
    return call


def host_times(torch, args) -> None:
    """Kernel 1's wrapper against its C entry alone, host microseconds a
    call (200 calls queued; the device runs behind)."""
    from financial_rag_system_tpu_torch.ops import _cuda
    from financial_rag_system_tpu_torch.ops.topk import _library, masked_topk, topk_plan

    q, c, codes, qf, nv, k = args
    (b, d), n = q.shape, c.shape[0]
    plan = topk_plan(b, n, d, c.element_size(), k, _cuda.sm_count(c.device))
    scratch = _cuda.stream_scratch(c.device, plan.scratch)
    out = torch.empty(2 * b * k, dtype=torch.int32, device=c.device)
    fn, stream = _library().masked_topk, _cuda.current_stream()
    ptrs = (q.data_ptr(), c.data_ptr(), codes.data_ptr(), qf.data_ptr(), b, n, d, nv, k,
            plan.blocks, plan.stages, scratch.data_ptr(), out.data_ptr(), stream)
    for label, call in (("wrapper (masked_topk)", lambda: masked_topk(*args)),
                        ("C entry alone", lambda: fn(*ptrs)),
                        ("torch.empty of the output", lambda: torch.empty(2 * b * k,
                                                                          dtype=torch.int32,
                                                                          device=c.device))):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        print(f"[host] k1 bf16 N={n}: {label}: {us:.1f} us a call", flush=True)


def main() -> int:
    global D
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None, metavar="CSRC")
    parser.add_argument("--only", default=None, help="comma-separated variant names")
    parser.add_argument("--width", type=int, default=D, metavar="D",
                        help="values a row (a multiple of 32), 384 by default")
    opts = parser.parse_args()
    D = opts.width
    import torch

    if not torch.cuda.is_available():
        print("topk_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}; rows of {D} values", flush=True)
    code_variants = list(variant_sources())
    names = [*code_variants, *PLAN_VARIANTS]
    if opts.only:
        names = [n for n in names if n in opts.only.split(",")]
    select_names = [n for n in names if n.startswith("select_")]
    names = [n for n in names if not n.startswith("select_")]
    base = {"select_as_is"} if select_names else set()
    libs = build(sorted({n for n in names + select_names if n in code_variants} | {"as_is"}
                        | base))
    inputs = cases(torch) if names else []
    if names:
        host_times(torch, inputs[0][2])
    for label, kind, args in inputs:
        ref_call, plan = launcher(torch, libs["as_is"], kind, args)
        ref = ref_call().cpu().numpy().tobytes()
        print(f"[plan] {label}: {plan.blocks} blocks, {plan.stages} stages, {plan.smem} B",
              flush=True)
        runs = [(n, libs.get(n, libs["as_is"]), PLAN_VARIANTS.get(n)) for n in names]
        for name, lib, change in runs:
            call, _ = launcher(torch, lib, kind, args, change)
            same = call().cpu().numpy().tobytes() == ref
            one, queued = events_ms(torch, call)
            p1, p2 = device_ms(torch, call)
            print(f"[variant] {label}: {name:11s} device {p1 + p2:.4f} ms ({p1:.4f} + {p2:.4f}), "
                  f"events {one:.4f} ms a call, {queued:.4f} ms queued; same as as_is: {same}",
                  flush=True)
        if opts.parent is not None:
            call = parent_launcher(torch, opts.parent, kind, args)
            one, queued = events_ms(torch, call)
            p1, p2 = device_ms(torch, call)
            print(f"[variant] {label}: {'parent':11s} device {p1 + p2:.4f} ms ({p1:.4f} + {p2:.4f}), "
                  f"events {one:.4f} ms a call, {queued:.4f} ms queued", flush=True)
    del inputs
    for label, kind, args in select_cases(torch) if select_names else []:
        ref_call, plan = launcher(torch, libs["select_as_is"], kind, args)
        ref = ref_call().cpu().numpy().tobytes()
        print(f"[plan] {label}: {plan.blocks} blocks, {plan.stages} stages, {plan.cols} table "
              f"columns, {plan.sweeps} sweeping blocks and {plan.runs} sort run(s) a query, scratch "
              f"{4 * plan.scratch} B", flush=True)
        for name in select_names:
            call, _ = launcher(torch, libs[name], kind, args)
            same = call().cpu().numpy().tobytes() == ref
            one, queued = events_ms(torch, call)
            split = kernel_split(torch, call)
            parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
            print(f"[variant] {label}: {name:17s} device {sum(split.values()):.4f} ms ({parts}), "
                  f"events {one:.4f} ms a call, {queued:.4f} ms queued; same as select_as_is: "
                  f"{same}", flush=True)
            if name == "select_as_is":
                seq = ", ".join(f"{k} {us:.1f}" for k, us in launch_sequence(torch, call))
                print(f"[launches] {label}: {seq} us", flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
