"""The QKV kernel's host side, on the CPU: its tile plan and its packed weights.

The kernel (``csrc/fused_bert.cu qkv_kernel``) runs only on the card
(``tests/test_torch_kernels_cuda.py``); what the wrapper decides for it is
checked here for every width the kernel takes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from financial_rag_system_tpu_torch.models import bert as tbert
from financial_rag_system_tpu_torch.models.hf_export import save_bert_checkpoint
from financial_rag_system_tpu_torch.models.hf_loader import load_bert_checkpoint
from financial_rag_system_tpu_torch.ops import fused_bert as tfb

H100_SMS = 132
WIDTHS = range(64, tfb.MAX_HIDDEN + 1, 64)
SMALL = tbert.BertConfig(vocab_size=100, hidden=128, layers=2, heads=4, intermediate=512,
                         max_positions=64)


@pytest.mark.parametrize("h", WIDTHS)
def test_qkv_plan_fits_the_card(h):
    for r in (1, 65, 1024, 64 * 137 + 5, 192_000):
        plan = tfb.qkv_plan(h, r, H100_SMS)
        bn = plan.bn
        assert bn % 8 == 0 and bn <= 256 and (3 * h) % bn == 0  # a wgmma N width
        assert plan.slices == 3 * h // bn
        for s in range(plan.slices):  # each slice lies inside one of q, k, v
            assert (s * bn) // h == ((s + 1) * bn - 1) // h
        assert plan.stages >= 4 and plan.stages % 2 == 0
        # weights, x ring, one output box per consumer warpgroup, barriers
        assert plan.smem == (1024 + bn * h * 2 + (plan.stages + 2) * 8192
                             + (2 * plan.stages + 1) * 8)
        assert plan.smem <= tfb.SMEM_LIMIT
        tiles = -(-r // 64)
        assert plan.ctas % plan.slices == 0 and plan.slices <= plan.ctas <= H100_SMS
        assert plan.ctas // plan.slices <= tiles  # no block without a tile
        if tiles * plan.slices >= H100_SMS:  # enough units: every slice fills its share
            assert plan.ctas > H100_SMS - plan.slices


def test_qkv_plan_at_the_main_path_shapes():
    """BGE-small and MiniLM-L6 (H 384): six slices of 192 columns, whose
    147,456 B of weights leave room for two 8 KB output boxes and eight x
    boxes; one block per multiprocessor at the rerank shape, one per unit
    at the embed shape."""
    rerank = tfb.qkv_plan(384, 480 * 400, H100_SMS)
    assert rerank == tfb.QKVPlan(bn=192, slices=6, stages=8, ctas=132, smem=230_536)
    assert tfb.qkv_plan(384, 32 * 32, H100_SMS).ctas == 96  # 16 row tiles x 6 slices
    assert tfb.qkv_plan(512, 1, H100_SMS) == tfb.QKVPlan(128, 12, 10, 12, 230_568)
    assert tfb.qkv_plan(64, 1, H100_SMS).stages == 24  # as many boxes as fit


def test_pack_qkv_is_the_stacked_bf16_weight():
    rng = np.random.default_rng(0)
    ws = [torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)) for _ in range(3)]
    bs = [torch.from_numpy(rng.standard_normal(64).astype(np.float32)) for _ in range(3)]
    w, b = tfb.pack_qkv(ws[0], bs[0], ws[1], bs[1], ws[2], bs[2])
    assert w.dtype == torch.bfloat16 and w.is_contiguous()
    assert torch.equal(w, torch.cat(ws).to(torch.bfloat16))
    assert b.dtype == torch.float32 and torch.equal(b, torch.cat(bs))
    # bf16 weights pack to the same bits
    assert torch.equal(tfb.pack_qkv(*(t.bfloat16() if t.dim() == 2 else t
                                      for p in zip(ws, bs) for t in p))[0], w)


def test_fused_qkv_takes_a_pack_on_the_cpu():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((70, 128)).astype(np.float32))
    args = [torch.from_numpy((0.05 * rng.standard_normal(s)).astype(np.float32))
            for _ in range(3) for s in ((128, 128), (128,))]
    before = tfb.fused_qkv.launches
    got = tfb.fused_qkv(x, *args, tfb.pack_qkv(*args))
    for g, want in zip(got, tfb.fused_qkv_plain(x, *args)):
        assert g.shape == (70, 128) and torch.equal(g, want)
    assert tfb.fused_qkv.launches == before


def _model(seed: int) -> tbert.BertModel:
    model = tbert.BertModel(SMALL, device="cpu")
    tbert.load_jax_params(model, tbert.init_params(torch.Generator().manual_seed(seed), SMALL))
    return model


def _stacked(lp: tbert.BertLayer) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.cat([lp.q.weight, lp.k.weight, lp.v.weight]).to(torch.bfloat16),
            torch.cat([lp.q.bias, lp.k.bias, lp.v.bias]))


def test_layer_pack_is_made_once_and_follows_the_loaders(tmp_path):
    model = _model(0)
    lp = model.layers[1]
    pack = lp.qkv_pack()
    assert lp.qkv_pack() is pack  # cast once, then kept
    assert all(torch.equal(a, b) for a, b in zip(pack, _stacked(lp)))
    tbert.load_jax_params(model, tbert.init_params(torch.Generator().manual_seed(1), SMALL))
    fresh = lp.qkv_pack()
    assert fresh is not pack and not torch.equal(fresh[0], pack[0])
    assert all(torch.equal(a, b) for a, b in zip(fresh, _stacked(lp)))
    # the HF loader's model packs the weights it loaded
    save_bert_checkpoint(model, SMALL, str(tmp_path / "ckpt"))
    loaded, _ = load_bert_checkpoint(str(tmp_path / "ckpt"), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(loaded.layers[1].qkv_pack(), fresh))
    # int8 PTQ rewrites the weights: the pack goes with them
    tbert.quantize_params(model)
    assert lp._qkv_pack is None
