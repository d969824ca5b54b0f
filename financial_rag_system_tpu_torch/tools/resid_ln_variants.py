"""Time variants of the o-proj + residual + LayerNorm kernel (kernel 6) on one NVIDIA GPU.

    python3 financial_rag_system_tpu_torch/tools/resid_ln_variants.py [--parent OLD/.../csrc]
                                                                      [--only NAME,NAME]

Builds copies of ``financial_rag_system_tpu_torch/csrc/fused_bert.cu``,
each changed in one way, and runs each at the main path's shapes (H 384;
rerank R 192,000 with a bf16 context, embed R 1,024 with an f32 one) on
``resid_plan``'s plans.  Variants:

- ``as_is``: the kernel as the port builds it;
- ``cluster_8``: at H 384, clusters of 8 blocks of 48 columns (the plan
  takes 4 of 96): twice the blocks' ctx reads from L2 and partners in each
  exchange, half the W_o slice and x tiles, more ctx stages;
- ``cluster_3``: at H 384, clusters of 3 blocks of 128 columns: more of
  the card's SMs in clusters, a third fewer ctx reads from L2, fewer ctx
  stages, two 64-register accumulators a thread;
- ``multicast``: each ctx box loaded once for the cluster by TMA multicast
  (by the block of rank box % C) into every block's stage, which every
  block's consumers free for the whole cluster: a quarter of the L2 reads,
  and the four blocks tied to one pace;
- ``three_groups``: three wgmma groups in flight in the product (a ctx
  stage freed two K boxes after its own), where the kernel keeps two;
- ``stream_w``: the design with no cluster (the alternative the
  redesign was held against): at H 384 a block takes row tiles of 128,
  each of its two consumer warpgroups 64 rows x all 384 columns (two
  m64n192 accumulators, so the layernorm needs no exchange), and W_o
  streams from L2 by TMA in 64-deep pieces beside the tile's ctx boxes
  through a ring of three stages (442 MB of L2 reads a launch at the
  rerank shape); x is read from device memory after an L2 prefetch a tile
  ahead, y stored from registers.  Its own kernel and C entry
  (``resid_stream_ln``), appended to the source; it rounds ctx to bf16 on
  the host first at the embed shape;
- ``x_tiles_2``: two x tiles a consumer warpgroup (the next tile's x lands
  while this one's sums are taken), fewer ctx stages;
- ``no_exchange``: each block normalises its rows by its own columns'
  statistics, with no exchange in the cluster (wrong outputs): what the
  two exchanges a tile cost;
- ``no_product``: no wgmma (wrong outputs): what the product costs;
- ``no_store``: y is not stored (no output): what the stores cost;
- ``loads_only``: no product, no exchange, no store: what the loads of
  ctx and x alone take through the rings.

With ``--parent``, the o-proj kernel of an earlier checkout's
``fused_bert.cu`` (a C entry that took no plan) runs on the same
inputs too (``chip_smoke.py``'s ``--resid-baseline`` launch).  Each line
gives the variant's median time (CUDA events, 20 launches) and its
median device time (the profiler's kernel times over 10 launches), its
largest difference from the plain version (``fused_resid_ln_plain``, the
tolerance is atol = rtol = 2e-3) and the count of elements outside that
tolerance, and the card's name and power limit.  Before them, each
variant's ``ptxas -v`` registers and spills for ``resid_ln_kernel`` at H
384.  The variants build in parallel, into ``build/resid_ln_variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

SRC = Path(__file__).resolve().parents[1] / "csrc" / "fused_bert.cu"
OUT = REPO / "build" / "resid_ln_variants"


def patched(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"fused_bert.cu no longer holds {old[:60]!r}")
    return text.replace(old, new)


PLANS = "#define RESID_PLANS(X) X(64, 64)"
INCLUDES = '#include "sm90.cuh"\n'


def wgmma_ss(n: int) -> str:
    """wgmma m64n{n}k16 with both operands in shared memory (d: n / 2 f32 a
    thread), for a variant whose slice width the port's kernels do not
    take."""
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    body = (f"{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
            f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{{regs}}}, %{r}, %{r + 1}, p, "
            "1, 1, 0, 0;\\n}\\n")
    return (f"__device__ __forceinline__ void wgmma_ss(float (&d)[{r}], uint64_t a, uint64_t b, "
            "uint32_t scale_d) {\n  asm volatile(\"" + body + "\" : " + outs
            + " : \"l\"(a), \"l\"(b), \"r\"(scale_d));\n}\n")


def cluster_8(s: str) -> str:
    s = patched(s, INCLUDES, INCLUDES + wgmma_ss(48))
    return patched(s, PLANS, PLANS.replace("X(64, 64)", "X(384, 48) X(64, 64)"))


SLICE = "N % 16 == 0 && N <= 96 && kC <= 8"


def cluster_3(s: str) -> str:
    s = patched(s, INCLUDES, INCLUDES + wgmma_ss(128))
    s = patched(s, SLICE, SLICE.replace("96", "128"))
    return patched(s, PLANS, PLANS.replace("X(64, 64)", "X(384, 128) X(64, 64)"))


XTILES = "constexpr int kResXTiles = 1;"
CTX_LOAD = "      tma_load_2d(sm.stage(wg, s), cmap, sm.cfull(wg, s), b * (BF ? 64 : 32), tile * kResRows);"
CTX_EMPTY = "        mbar_init(sm.cempty(wg, s), 4);"
MULTICAST_HELPERS = """
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// a consumer warp's release of a ctx stage in every block of the cluster
template <int C>
__device__ __forceinline__ void release_cluster(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) < C)
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\\n" ::"r"(
                     mapa(smem_addr(bar), threadIdx.x & 31))
                 : "memory");
}
"""


def multicast(s: str) -> str:
    s = patched(s, INCLUDES, INCLUDES + MULTICAST_HELPERS)
    s = patched(s, CTX_LOAD, "      if (b % F::kC == (int)cluster_rank())\n"
                "        tma_load_2d_multicast(sm.stage(wg, s), cmap, sm.cfull(wg, s), "
                "b * (BF ? 64 : 32), tile * kResRows, (uint16_t)((1u << F::kC) - 1));")
    s = patched(s, "release(sm.cempty(", "release_cluster<F::kC>(sm.cempty(")
    return patched(s, CTX_EMPTY, CTX_EMPTY.replace("4);", "4 * F::kC);"))
SEND = "  if constexpr (F::kC > 1) {\n    const int idx"
TOTAL = "  if constexpr (F::kC == 1) {\n    return make_float2(s0, s1);"
PRODUCT = "      wgmma_ss(acc, da + ((kk * 32) >> 4)"
STORES = ("    if (row0 < R)\n", "    if (row0 + 8 < R)\n")


GROUPS = """      wgmma_wait<1>();
      if (kb > 0) release(sm.cempty(wg, (n - 1) % F::kStages));"""
GROUPS_END = "  if constexpr (BF) release(sm.cempty(wg, (n - 1) % F::kStages));"


def three_groups(s: str) -> str:
    s = patched(s, GROUPS, """      wgmma_wait<2>();
      if (kb > 1) release(sm.cempty(wg, (n - 2) % F::kStages));""")
    return patched(s, GROUPS_END, """  if constexpr (BF) {
    if (F::kKB > 1) release(sm.cempty(wg, (n - 2) % F::kStages));
    release(sm.cempty(wg, (n - 1) % F::kStages));
  }""")


STREAM_KERNEL = r"""
// -- the variants tool's stream_w: W_o streamed from L2, no cluster (H 384) --
namespace {
constexpr int kStH = 384, kStRows = 128, kStKB = 6, kStStages = 3;
constexpr int kStWBox = 192 * 128;                 // 192 rows of W_o x 64 bf16
constexpr int kStCBox = kStRows * 128;             // 128 ctx rows x 64 bf16
constexpr int kStStage = 2 * kStWBox + kStCBox;    // a piece of W_o and its ctx box
constexpr int kStSmem = 1024 + kStStages * kStStage + 16 * kStStages;

__global__ void __launch_bounds__(384, 1)
resid_stream_kernel(const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap wmap,
                    const float* __restrict__ x, const float* __restrict__ b,
                    const float* __restrict__ ln_s, const float* __restrict__ ln_b, float eps,
                    float* __restrict__ y, int R) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStStages * kStStage);
  uint64_t* empty = full + kStStages;
  const int tiles = (R + kStRows - 1) / kStRows;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (warp >= 8) {
    setmaxnreg_dec<24>();  // 24 x 128 + 240 x 256 <= 65,536, or the increase never returns
    if (threadIdx.x == 256) {
      int n = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int next = (tile + gridDim.x) * kStRows;
        if (next < R) prefetch_l2(x + (size_t)next * kStH, (uint32_t)(min(kStRows, R - next) * kStH * 4));
        for (int kb = 0; kb < kStKB; ++kb, ++n) {
          const int s = n % kStStages;
          mbar_wait(&empty[s], ((n / kStStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], kStStage);
          unsigned char* st = base + s * kStStage;
          tma_load_2d(st, &wmap, &full[s], kb * 64, 0);
          tma_load_2d(st + kStWBox, &wmap, &full[s], kb * 64, 192);
          tma_load_2d(st + 2 * kStWBox, &cmap, &full[s], kb * 64, tile * kStRows);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();
  const int wg = warp >> 2, tid = threadIdx.x & 127, t = tid & 3;
  const int ra = 16 * (tid >> 5) + ((tid & 31) >> 2);
  float a0[96], a1[96];  // columns 0..191 and 192..383
  int n = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#pragma unroll 1
    for (int kb = 0; kb < kStKB; ++kb, ++n) {
      const int s = n % kStStages;
      mbar_wait(&full[s], (n / kStStages) & 1);
      const unsigned char* st = base + s * kStStage;
      const uint64_t da = wgmma_desc_sw128(st + 2 * kStWBox + wg * 64 * 128);
      const uint64_t d0 = wgmma_desc_sw128(st), d1 = wgmma_desc_sw128(st + kStWBox);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss(a0, da + ((kk * 32) >> 4), d0 + ((kk * 32) >> 4), (kb | kk) != 0);
        wgmma_ss(a1, da + ((kk * 32) >> 4), d1 + ((kk * 32) >> 4), (kb | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kb > 0) release(&empty[(n - 1) % kStStages]);
    }
    wgmma_wait<0>();
    wgmma_pin(a0);
    wgmma_pin(a1);
    release(&empty[(n - 1) % kStStages]);
    const int row0 = tile * kStRows + wg * 64 + ra;
    const bool v0 = row0 < R, v1 = row0 + 8 < R;
    const float* x0p = x + (size_t)row0 * kStH + 2 * t;
    const float* x1p = x0p + 8 * kStH;
    float s0 = 0.f, s1 = 0.f;
    auto add = [&](float (&acc)[96], int c0) {
#pragma unroll
      for (int j = 0; j < 24; ++j) {
        const int c = c0 + 8 * j;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b + c + 2 * t));
        const float2 xa = v0 ? __ldg(reinterpret_cast<const float2*>(x0p + c)) : make_float2(0.f, 0.f);
        const float2 xb = v1 ? __ldg(reinterpret_cast<const float2*>(x1p + c)) : make_float2(0.f, 0.f);
        acc[4 * j] = xa.x + (acc[4 * j] + bb.x);
        acc[4 * j + 1] = xa.y + (acc[4 * j + 1] + bb.y);
        acc[4 * j + 2] = xb.x + (acc[4 * j + 2] + bb.x);
        acc[4 * j + 3] = xb.y + (acc[4 * j + 3] + bb.y);
        s0 += acc[4 * j] + acc[4 * j + 1];
        s1 += acc[4 * j + 2] + acc[4 * j + 3];
      }
    };
    add(a0, 0);
    add(a1, 192);
    const float mu0 = quad_sum(s0) / kStH, mu1 = quad_sum(s1) / kStH;
    s0 = s1 = 0.f;
    auto squares = [&](const float (&acc)[96]) {
#pragma unroll
      for (int j = 0; j < 24; ++j) {
        const float d0 = acc[4 * j] - mu0, d1 = acc[4 * j + 1] - mu0;
        const float d2 = acc[4 * j + 2] - mu1, d3 = acc[4 * j + 3] - mu1;
        s0 += d0 * d0 + d1 * d1;
        s1 += d2 * d2 + d3 * d3;
      }
    };
    squares(a0);
    squares(a1);
    const float rs0 = rsqrtf(quad_sum(s0) / kStH + eps), rs1 = rsqrtf(quad_sum(s1) / kStH + eps);
    float* y0p = y + (size_t)row0 * kStH + 2 * t;
    float* y1p = y0p + 8 * kStH;
    auto out = [&](const float (&acc)[96], int c0) {
#pragma unroll
      for (int j = 0; j < 24; ++j) {
        const int c = c0 + 8 * j;
        const float2 sc = __ldg(reinterpret_cast<const float2*>(ln_s + c + 2 * t));
        const float2 lb = __ldg(reinterpret_cast<const float2*>(ln_b + c + 2 * t));
        if (v0)
          *reinterpret_cast<float2*>(y0p + c) = make_float2(
              (acc[4 * j] - mu0) * rs0 * sc.x + lb.x, (acc[4 * j + 1] - mu0) * rs0 * sc.y + lb.y);
        if (v1)
          *reinterpret_cast<float2*>(y1p + c) =
              make_float2((acc[4 * j + 2] - mu1) * rs1 * sc.x + lb.x,
                          (acc[4 * j + 3] - mu1) * rs1 * sc.y + lb.y);
      }
    };
    out(a0, 0);
    out(a1, 192);
  }
}
}  // namespace

// y = LN(x + ctx W_o^T + b) at H 384: x f32, ctx and W_o bf16; `ctas`
// persistent blocks, at most the row tiles of 128.
extern "C" int resid_stream_ln(const void* x, const void* ctx, const void* w, const void* b,
                               const void* ln_s, const void* ln_b, float eps, void* y, int R,
                               int ctas, void* stream) {
  CUtensorMap cmap, wmap;
  if (!tensor_map(&cmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ctx, 1, R, kStH, kStRows, 64) ||
      !tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, 1, kStH, kStH, 192, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(resid_stream_kernel, kStSmem);
  if (err != cudaSuccess) return (int)err;
  resid_stream_kernel<<<ctas, 384, kStSmem, (cudaStream_t)stream>>>(
      cmap, wmap, (const float*)x, (const float*)b, (const float*)ln_s, (const float*)ln_b, eps,
      (float*)y, R);
  return (int)cudaGetLastError();
}
"""


def stream_w(s: str) -> str:
    return s + STREAM_KERNEL


def stream_launch(fb, lib, x, c, w16, b, ln, sms):
    """A launch of stream_w's kernel on the same inputs, into a new y."""
    import torch

    fn = lib.resid_stream_ln
    p = ctypes.c_void_p
    fn.argtypes = [p] * 6 + [ctypes.c_float, p, ctypes.c_int, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    c16 = c.to(torch.bfloat16)
    r = x.shape[0]

    def launch():
        y = torch.empty_like(x)
        fb._cuda.check(fn(x.data_ptr(), c16.data_ptr(), w16.data_ptr(), b.data_ptr(),
                          ln[0].data_ptr(), ln[1].data_ptr(), 1e-12, y.data_ptr(), r,
                          min(-(-r // 128), sms), torch.cuda.current_stream().cuda_stream),
                       "resid_stream_ln")
        return y

    return launch


def no_store(s: str) -> str:
    for old in STORES:
        s = patched(s, old, old.replace("< R", "< 0"))
    return s


def no_exchange(s: str) -> str:
    s = patched(s, SEND, SEND.replace("F::kC > 1", "false"))
    return patched(s, TOTAL, TOTAL.replace("F::kC == 1", "true"))


VARIANTS = {
    "as_is": (lambda s: s, None),
    "cluster_8": (cluster_8, {"cluster": 8}),
    "cluster_3": (cluster_3, {"cluster": 3}),
    "multicast": (multicast, None),
    "three_groups": (three_groups, None),
    "stream_w": (stream_w, None),
    "x_tiles_2": (lambda s: patched(s, XTILES, XTILES.replace("1", "2")), {"RESID_XTILES": 2}),
    "no_exchange": (no_exchange, None),
    "no_product": (lambda s: patched(s, PRODUCT, "      if (kk < 0) " + PRODUCT.lstrip()), None),
    "no_store": (no_store, None),
    "loads_only": (lambda s: no_store(no_exchange(patched(s, PRODUCT, "      if (kk < 0) "
                                                          + PRODUCT.lstrip()))), None),
}


def ptxas_lines(log: str) -> list[str]:
    """Registers and spills of each resid_ln_kernel instantiation at H 384
    (and of stream_w's kernel)."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"resid_ln_kernelILi(384)ELi(\d+)ELb(\d)E", m.group(1))
            name = f"H {k.group(1)} N {k.group(2)} {'bf16' if k.group(3) == '1' else 'f32'} ctx" if k else None
            if "resid_stream_kernel" in m.group(1):
                name = "stream_w kernel"
        elif name and ("spill" in line or "Used" in line):
            out.append(f"{name}: {line.split('info    :')[-1].strip()}")
    return out


def variant_plan(fb, changes: dict, h: int, r: int, sms: int, ctx_bf16: bool):
    """The plan a variant's kernel is built for: ``resid_plan``'s, with its
    cluster size forced (``cluster``) or a constant of the plan changed as
    the variant's source changes it (``RESID_XTILES``)."""
    saved = {k: getattr(fb, k) for k in changes if k != "cluster"}
    try:
        for k, v in saved.items():
            setattr(fb, k, changes[k])
        plan = fb.resid_plan.__wrapped__(h, r, sms, ctx_bf16)
        cluster = changes.get("cluster")
        if cluster is not None:
            stages = max(s for s in range(2, fb.RESID_MAX_STAGES + 1)
                         if fb.resid_smem(h, h // cluster, ctx_bf16, s) <= fb.SMEM_LIMIT)
            plan = plan._replace(cluster=cluster, stages=stages,
                                 ctas=cluster * min(plan.tiles, sms // cluster),
                                 smem=fb.resid_smem(h, h // cluster, ctx_bf16, stages))
        return plan
    finally:
        for k, v in saved.items():
            setattr(fb, k, v)


def main() -> int:
    import torch

    import chip_smoke as cs
    from financial_rag_system_tpu_torch.ops import _cuda
    from financial_rag_system_tpu_torch.ops import fused_bert as fb

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None, metavar="CSRC",
                        help="csrc/ of an earlier checkout: run its o-proj kernel too")
    parser.add_argument("--only", default=",".join(VARIANTS), metavar="NAME,NAME",
                        help="the variants to build and run (default: all)")
    opts = parser.parse_args()
    names = opts.only.split(",")
    if not set(names) <= set(VARIANTS):
        parser.error(f"--only takes names of {sorted(VARIANTS)}")
    if not torch.cuda.is_available():
        print("resid_ln_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    OUT.mkdir(parents=True, exist_ok=True)
    source = SRC.read_text()
    builds = {}  # one nvcc a variant, all at once
    for name in names:
        src = OUT / f"{name}.cu"
        patch = VARIANTS[name][0]
        src.write_text(patch(source))
        builds[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", f"-I{_cuda.CSRC_DIR}",
             "-o", str(OUT / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    g = torch.Generator(device="cuda").manual_seed(9)

    def randn(*shape, scale=1.0, loc=0.0):
        return loc + scale * torch.randn(shape, generator=g, device="cuda")

    h = 384
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    w, b = randn(h, h, scale=0.05), randn(h, scale=0.01)
    ln = (randn(h, scale=0.1, loc=1.0), randn(h, scale=0.1))
    shapes = {"rerank": (randn(cs.PAIRS * 400, h), randn(cs.PAIRS * 400, h).bfloat16()),
              "embed": (randn(cs.B * 32, h), randn(cs.B * 32, h))}
    plain = {k: fb.fused_resid_ln_plain(x, c, w, b, *ln, 1e-12) for k, (x, c) in shapes.items()}

    def report(label: str, fn, ref, kernel: str = "resid_ln_kernel") -> str:
        got = fn()
        err = (got - ref).abs()
        bad = int((~torch.isclose(got, ref, atol=2e-3, rtol=2e-3)).sum())
        ms = cs.median_ms(fn, reps=20)
        return (f"{label} {ms:.4f} ms, device {cs.device_ms(torch, fn, kernel):.4f} "
                f"ms (max abs err {float(err.max()):.3g}, {bad} outside)")

    if opts.parent is not None:
        parent = cs.baseline_lib("fused_bert", opts.parent)
        parts = []
        for shape, (x, c) in shapes.items():
            y = torch.empty_like(plain[shape])
            parts.append(report(shape, cs.resid_baseline_fn(parent, (x, c, w, b, *ln, 1e-12), y),
                                plain[shape]))
        print(f"[variants] {smi}: parent: " + "; ".join(parts), flush=True)
    for name, proc in builds.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            print(f"[variants] {name}: build failed\n{log}")
            return 1
        for line in ptxas_lines(log):
            print(f"[variants] {name}: {line}", flush=True)
        changes = VARIANTS[name][1] or {}
        parts = []
        with cs.kernel_lib("fused_bert", ctypes.CDLL(str(OUT / f"{name}.so"))):
            fb._library.cache_clear()  # the wrappers' entry points from this build
            pack = fb.pack_resid(w, b)  # W_o's maps encoded by this build
            for shape, (x, c) in shapes.items():
                if name == "stream_w":
                    parts.append(report(f"{shape} (row tiles of 128, three stages)",
                                        stream_launch(fb, fb._library(), x, c, pack.w, b, ln, sms),
                                        plain[shape], "resid_stream_kernel"))
                    continue
                plan = variant_plan(fb, changes, h, x.shape[0], sms, c.dtype == torch.bfloat16)
                parts.append(report(f"{shape} (cluster {plan.cluster}, stages {plan.stages})",
                                    lambda: fb._resid_launch(x, c, pack, *ln, 1e-12, plan),
                                    plain[shape]))
        fb._library.cache_clear()
        print(f"[variants] {smi}: {name}: " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
