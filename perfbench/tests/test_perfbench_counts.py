"""The operation and byte counts of the rooflines, against numbers worked
out by hand for one shape each, and the model FLOPs of the ``mfu``
metrics against ``torch.utils.flop_counter.FlopCounterMode`` over the
program's forward on a small configuration."""
from __future__ import annotations


import pytest
import torch

from perfbench.counts import flash_attention_fwd, grouped_matmul_bwd, model, ssm_scan_bwd
from perfbench.lib import peaks
from perfbench.lib.harness import program_config
from perfbench.tests import tiny

BF16 = torch.bfloat16


def test_scan_backward_by_hand():
    # B 1, S 4, H 2, P 3, N 5; b and c one group broadcast over the heads
    x = torch.zeros(1, 4, 2, 3, dtype=BF16)
    a = torch.zeros(1, 4, 2)
    b = torch.zeros(1, 4, 1, 5).expand(1, 4, 2, 5)
    flops, byts, peak = ssm_scan_bwd.count(x, a, b, b, x, None, None, (True,) * 4)
    assert flops == 12 * 4 * 2 * 5 * 3 + 2 * 4 * 2 == 1456
    # x, dy read and dx written (bf16) 144; a read, da written 64; b, c read 160;
    # db, dc written a head 320
    assert byts == 144 + 64 + 160 + 320 == 688
    assert peak == peaks.FLOPS_PER_S["tf32"]


def test_grouped_matmul_backward_by_hand():
    x, w = torch.zeros(2, 3, 4, dtype=BF16), torch.zeros(2, 4, 5, dtype=BF16)
    dy = torch.zeros(2, 3, 5, dtype=BF16)
    flops, byts, peak = grouped_matmul_bwd.count(x, w, dy, (True, True))
    assert flops == 2 * 2 * 2 * 3 * 4 * 5 == 480
    # dy 30, w 40 and dx 24, x 24 and dw 40 elements of 2 bytes
    assert byts == 2 * (30 + 40 + 24 + 24 + 40) == 316
    assert grouped_matmul_bwd.count(x, w, dy, (False, True))[:2] == (240.0, 2 * (30 + 24 + 40))
    assert peak == peaks.FLOPS_PER_S["bfloat16"]


def test_flash_forward_by_hand():
    q = torch.zeros(1, 2, 4, 8, dtype=BF16)
    k = torch.zeros(1, 1, 4, 8, dtype=BF16)
    assert flash_attention_fwd.visible(4, 4, True) == 10
    flops, byts, _ = flash_attention_fwd.count(q, k, k, causal=True)
    assert flops == 4 * 8 * 2 * 10 == 640
    assert byts == 2 * (2 * 2 * 4 * 8 + 2 * 1 * 4 * 8) == 384
    assert flash_attention_fwd.count(q, k, k, causal=True, return_lse=True)[1] == 384 + 4 * 8


def _counted(cfg: dict, batch: int, seq: int) -> float:
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models.model import forward, init_params
    m = init_params(program_config(cfg), seed=0, device="cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (batch, seq))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        forward(m, tokens=tokens)
    return fc.get_total_flops()


@pytest.mark.parametrize("base", [tiny.HYBRID, tiny.MOE], ids=lambda c: c["name"])
def test_model_flops_against_the_flop_counter(base):
    """The counter sees the plain versions: attention over the whole S x S
    square, the plain scan's readout products, the experts over their
    capacity slots and the padded vocabulary, and not the depthwise conv
    (elementwise products, which the model count takes as parameters a
    token touches).  Those terms set apart, the projections agree exactly."""
    cfg = tiny.full(base)
    b, s = 2, 24
    t = b * s
    d, hd, h = cfg["d_model"], cfg["head_dim"], cfg["num_heads"]
    vpad = -(-cfg["vocab_size"] // 2048) * 2048
    attn_layers = model._attention_layers(cfg)
    projections = 2 * model.applied_params(cfg) * t + 2 * d * (vpad - cfg["vocab_size"]) * t
    square = 4 * b * h * s * s * hd * attn_layers
    extra = 0
    if cfg["family"] == "hybrid":
        din = cfg["ssm_expand"] * d
        extra = 2 * t * cfg["ssm_state"] * din * cfg["num_layers"]         # y_t = c_t . h_t
        extra -= 2 * t * 4 * din * cfg["num_layers"]                        # the conv
    else:
        from perfbench.reference.moe import capacity
        g = 3 * d * cfg["d_ff"]
        layers, e, k = cfg["num_layers"], cfg["num_experts"], cfg["experts_per_token"]
        extra = layers * 2 * g * (e * capacity(t, cfg) - k * t)
    assert _counted(cfg, b, s) == pytest.approx(projections + square + extra, rel=1e-9)
    # and the attention term's difference is the causal half the count leaves out
    causal = model.attention_fwd(cfg, b, s)
    assert model.prefill(cfg, b, s) == 2 * model.applied_params(cfg) * t + causal
    assert causal == pytest.approx(square * (s + 1) / (2 * s))
