"""The o-proj kernel's host side, on the CPU: its plan and its packed weights.

The kernel (``csrc/fused_bert.cu resid_ln_kernel``) runs only on the card
(``tests/test_torch_kernels_cuda.py``); what ``resid_plan`` decides for it
is checked here for every width it takes, either context type, and row
counts from one row to the rerank shape, together with the list of plans
the kernel is compiled for.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from financial_rag_system_tpu_torch.models import bert as tbert
from financial_rag_system_tpu_torch.models.hf_export import save_bert_checkpoint
from financial_rag_system_tpu_torch.models.hf_loader import load_bert_checkpoint
from financial_rag_system_tpu_torch.ops import fused_bert as tfb

H100_SMS = 132
WIDTHS = range(64, tfb.MAX_HIDDEN + 1, 64)
ROWS = (1, 63, 1024, 192_000)
CONSUMER_REGS = 232  # the consumer warpgroups' setmaxnreg budget
OTHER_REGS = 48      # what a consumer thread holds beside its accumulators and columns
SOURCE = Path(tfb.__file__).resolve().parent.parent / "csrc" / "fused_bert.cu"
SMALL = tbert.BertConfig(vocab_size=100, hidden=128, layers=2, heads=4, intermediate=512,
                         max_positions=64)


def compiled_plans() -> set[tuple[int, int]]:
    """(H, N) of every instantiation of the kernel: its RESID_PLANS list."""
    line = next(ln for ln in SOURCE.read_text().splitlines()
                if ln.startswith("#define RESID_PLANS(X)"))
    return {(int(h), int(n)) for h, n in re.findall(r"X\((\d+), (\d+)\)", line)}


@pytest.mark.parametrize("r", ROWS)
@pytest.mark.parametrize("ctx_bf16", [True, False])
@pytest.mark.parametrize("h", WIDTHS)
def test_resid_plan_fits_the_card(h, ctx_bf16, r):
    plan = tfb.resid_plan(h, r, H100_SMS, ctx_bf16)
    c = plan.cluster
    n = h // c
    # the slice: H / C columns, one wgmma N (a multiple of 8 up to 256), in
    # x boxes of 16 or 32 f32
    assert h % c == 0 and 1 <= c <= tfb.RESID_MAX_CLUSTER
    assert n % 16 == 0 and n <= tfb.RESID_MAX_SLICE <= 256
    # shared memory: the kernel's sum, within a block's limit; as many ctx
    # stages as fit; no smaller cluster fits
    assert plan.smem == tfb.resid_smem(h, n, ctx_bf16, plan.stages) <= tfb.SMEM_LIMIT
    assert 2 <= plan.stages <= tfb.RESID_MAX_STAGES
    assert (plan.stages == tfb.RESID_MAX_STAGES
            or tfb.resid_smem(h, n, ctx_bf16, plan.stages + 1) > tfb.SMEM_LIMIT)
    assert all(tfb._resid_stages(h, smaller, ctx_bf16) == 0 for smaller in range(1, c))
    # blocks: whole clusters, at most a cluster a tile and a block an SM
    assert plan.rows == 64 and plan.tiles == -(-r // 64)
    assert plan.ctas % c == 0 and c <= plan.ctas <= H100_SMS
    assert plan.ctas // c == min(plan.tiles, H100_SMS // c)
    # registers: two 64 x N f32 accumulators (N / 2 each a thread) and the
    # thread's columns of b, ln_scale and ln_bias (3 N / 4)
    assert 2 * (n // 2) + 3 * n // 4 + OTHER_REGS <= CONSUMER_REGS


@pytest.mark.parametrize("ctx_bf16", [True, False])
@pytest.mark.parametrize("h", WIDTHS)
def test_resid_plan_is_compiled(h, ctx_bf16):
    """The kernel is instantiated for every (H, N) a plan asks for, and
    for no other (the C entry refuses those)."""
    plans = {h // tfb.resid_plan(h, r, H100_SMS, ctx_bf16).cluster for r in ROWS}
    assert {(h, n) for n in plans} <= compiled_plans()
    assert {n for hh, n in compiled_plans() if hh == h} == plans


def test_resid_smem_is_the_kernel_layout():
    """The sum the kernel's static layout asserts, term by term, at H 384."""
    # 1 KB alignment, the 96 x 384 bf16 slice, six 8 KB ctx stages for each
    # of two warpgroups, one 64 x 96 f32 x tile each, four exchange buffers
    # of 4 blocks x 64 rows each, barriers (W_o, full and empty ctx stages,
    # full and empty x tiles, the exchanges)
    assert tfb.resid_smem(384, 96, True, 6) == (1024 + 73_728 + 2 * 6 * 8192 + 2 * 24_576
                                                + 2 * 4 * 4 * 256 + 8 * (1 + 24 + 4 + 8))
    # an f32 context adds a bf16 K box a warpgroup to round it into
    assert tfb.resid_smem(384, 96, False, 5) == tfb.resid_smem(384, 96, True, 5) + 2 * 8192


def test_resid_plan_at_the_main_path_shapes():
    """BGE-small and MiniLM-L6 (H 384): clusters of 4 blocks of 96 columns
    at both shapes (2 blocks of 192 do not fit beside their x tiles); the
    rerank shape (bf16 context) on a block an SM, six ctx stages a
    warpgroup (a whole tile); the embed shape (f32 context, 16 tiles) on 64
    blocks."""
    rerank = tfb.resid_plan(384, 480 * 400, H100_SMS, True)
    assert rerank == tfb.ResidPlan(cluster=4, rows=64, tiles=3000, ctas=132, stages=6,
                                   smem=230_696)
    embed = tfb.resid_plan(384, 32 * 32, H100_SMS, False)
    assert (embed.cluster, embed.tiles, embed.ctas, embed.stages) == (4, 16, 64, 5)
    assert tfb._resid_stages(384, 2, True) == 0  # 147 KB of slice and 96 KB of x
    # H 448: 7 blocks of 64 columns (4 of 112 do not fit); H 512: 8 of 64
    assert tfb.resid_plan(448, 192_000, H100_SMS, True).cluster == 7
    assert tfb.resid_plan(512, 1, H100_SMS, False).cluster == 8


def test_pack_resid_is_the_bf16_weight():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    pack = tfb.pack_resid(w, b)
    assert pack.w.dtype == torch.bfloat16 and pack.w.is_contiguous()
    assert torch.equal(pack.w, w.to(torch.bfloat16))
    assert pack.b.dtype == torch.float32 and torch.equal(pack.b, b) and pack.maps == {}
    assert torch.equal(tfb.pack_resid(w.bfloat16(), b).w, pack.w)  # bf16 W_o packs the same
    with pytest.raises(ValueError):
        tfb.pack_resid(w[:, :64], b)


def test_fused_resid_ln_takes_a_pack_on_the_cpu():
    rng = np.random.default_rng(1)
    x, ctx = (torch.from_numpy(rng.standard_normal((70, 128)).astype(np.float32))
              for _ in range(2))
    w = torch.from_numpy((0.05 * rng.standard_normal((128, 128))).astype(np.float32))
    b, s, lb = (torch.from_numpy((0.1 * rng.standard_normal(128)).astype(np.float32))
                for _ in range(3))
    before = tfb.fused_resid_ln.launches
    got = tfb.fused_resid_ln(x, ctx, w, b, s, lb, 1e-12, tfb.pack_resid(w, b))
    assert got.shape == (70, 128)
    assert torch.equal(got, tfb.fused_resid_ln_plain(x, ctx, w, b, s, lb, 1e-12))
    assert tfb.fused_resid_ln.launches == before


def _model(seed: int) -> tbert.BertModel:
    model = tbert.BertModel(SMALL, device="cpu")
    tbert.load_jax_params(model, tbert.init_params(torch.Generator().manual_seed(seed), SMALL))
    return model


def test_o_pack_is_made_once_and_follows_the_loaders(tmp_path):
    model = _model(0)
    lp = model.layers[1]
    pack = lp.o_pack()
    assert lp.o_pack() is pack  # cast once, then kept
    assert torch.equal(pack.w, lp.o.weight.to(torch.bfloat16)) and torch.equal(pack.b, lp.o.bias)
    tbert.load_jax_params(model, tbert.init_params(torch.Generator().manual_seed(1), SMALL))
    fresh = lp.o_pack()
    assert fresh is not pack and not torch.equal(fresh.w, pack.w)
    assert torch.equal(fresh.w, lp.o.weight.to(torch.bfloat16))
    # the HF loader's model packs the weights it loaded
    save_bert_checkpoint(model, SMALL, str(tmp_path / "ckpt"))
    loaded, _ = load_bert_checkpoint(str(tmp_path / "ckpt"), device="cpu")
    assert torch.equal(loaded.layers[1].o_pack().w, fresh.w)
    # int8 PTQ rewrites the weights: the pack goes with them
    tbert.quantize_params(model)
    assert lp._o_pack is None
