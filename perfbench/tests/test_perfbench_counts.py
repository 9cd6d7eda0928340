"""The operation and byte counts of the rooflines, against numbers worked
out by hand for one shape each, the model FLOPs of the ``mfu`` metrics
against ``torch.utils.flop_counter.FlopCounterMode`` over the program's
forward on a small configuration, and the rules by which the benchmark
draws each parameter."""
from __future__ import annotations


import pytest
import torch

from perfbench.counts import flash_attention_fwd, grouped_matmul_bwd, model, ssm_scan_bwd
from perfbench.lib import peaks
from perfbench.lib.harness import program_config
from perfbench.reference.common import init_kind
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


# B 4, S 4,096, 112 heads, P 64, N 64 (Zamba2-7B's scan at 4 x 4,096).  Every
# case: x, dy read and dx written, 3 x 117,440,512 bf16 = 704,643,072; a read
# and da written, 2 x 4 x 1,835,008 = 14,680,064.  b and c read a group,
# 2 x 4 x 4 x 4,096 x G x 64: 8,388,608 for one group broadcast over the
# heads, 16,777,216 for Zamba2-7B's two, 939,524,096 for one a head.  db and
# dc written in b's shape, 2 x 4 x 4 x 4,096 x 64 a head or group: 939,524,096
# a head (the broadcast group's gradient comes back a head), 16,777,216 for
# two groups.
@pytest.mark.parametrize("groups,byts", [(1, 1_667_235_840), (2, 752_877_568),
                                         (112, 2_598_371_328)])
def test_scan_backward_groups_by_hand(groups, byts):
    x = torch.empty(4, 4096, 112, 64, dtype=BF16, device="meta")
    a = torch.empty(4, 4096, 112, device="meta")
    b = torch.empty(4, 4096, groups, 64, device="meta")
    if groups == 1:
        b = b.expand(4, 4096, 112, 64)
    flops, got, _ = ssm_scan_bwd.count(x, a, b, b, x, None, None, (True,) * 4)
    assert got == byts
    assert flops == 12 * 7_516_192_768 + 2 * 1_835_008 == 90_197_983_232


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


@pytest.mark.parametrize("name,shape,want", [
    ("blocks.0.ln.scale", (32,), ("ones", 0.0)),
    ("blocks.0.mamba.d_skip", (112,), ("ones", 0.0)),              # Mamba2's D, as published
    ("blocks.0.mamba.conv_bias", (8192,), ("zeros", 0.0)),
    ("blocks.0.attn.bq", (64,), ("zeros", 0.0)),
    ("blocks.0.mamba.dt_bias", (112,), ("dt_bias", 0.0)),          # its own rule, not zeros
    ("blocks.0.mamba.a_log", (112,), ("a_log", 0.0)),
    ("blocks.0.mamba.conv", (4, 64), ("normal", 0.1)),
    ("blocks.0.mamba.w_in", (32, 128), ("normal", 32 ** -0.5)),
    ("blocks.0.l0.attn.wo", (64, 32), ("normal", 64 ** -0.5 / 2.0)),    # 1 / sqrt(2 x 2)
    ("embed.tok", (256, 32), ("normal", 1.0))])
def test_init_kind_rules(name, shape, want):
    kind, std = init_kind(name, shape, {"num_layers": 2, "tie_embeddings": False})
    assert kind == want[0] and std == pytest.approx(want[1], rel=1e-15)


def test_init_kind_refuses_an_unnamed_1d_leaf():
    with pytest.raises(ValueError, match="blocks.3.mamba.d_gain"):
        init_kind("blocks.3.mamba.d_gain", (112,), {"num_layers": 2, "tie_embeddings": True})
