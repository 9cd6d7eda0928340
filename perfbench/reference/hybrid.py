"""Plain reference of the hybrid family (Zamba2): Mamba2 blocks, one shared
attention + MLP block applied after every ``attn_every``-th of them.

Zamba2 (arXiv:2411.15242): a Mamba2 backbone; one transformer block whose
weights are shared by all its sites.  Each Mamba2 block: RMSNorm, then
``w_in`` to z and x, a depthwise causal conv of width 4 on x and SiLU,
dt = softplus(x W_dt + dt_bias), the decay a = exp(-dt exp(a_log)) a head,
one B/C group of state size N shared by the heads, the selective scan
h_t = a_t h_{t-1} + B_t (x) (dt_t x_t), y_t = C_t . h_t, a gated RMSNorm
(RMSNorm(y) * SiLU(z)) and ``w_out``; a residual around it.  Departures
from the published model, as the program has them: no D skip term, no
LoRA adapters on the shared block, RoPE in the shared attention.

The scan is computed chunk by chunk (the SSD decomposition: within a chunk
as masked matrix products, across chunks a recurrence on the states), in
float32.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import common as C

CONV_W = 4


def dims(cfg: dict) -> Tuple[int, int, int, int]:
    """(inner width, heads, head width, state size)."""
    din = cfg["ssm_expand"] * cfg["d_model"]
    nh = cfg["ssm_heads"] or cfg["num_heads"]
    return din, nh, din // nh, cfg["ssm_state"]


def padded_vocab(cfg: dict) -> int:
    return -(-cfg["vocab_size"] // 2048) * 2048


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, dtype) of every parameter, in the program's order."""
    d, f, v = cfg["d_model"], cfg["d_ff"], padded_vocab(cfg)
    din, nh, _, n = dims(cfg)
    hd = cfg["head_dim"] or d // cfg["num_heads"]
    h, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    pdt = cfg["param_dtype"]
    out = [("embed.tok", (v, d), pdt)]
    if not cfg["tie_embeddings"]:
        out.append(("embed.out", (v, d), pdt))
    for i in range(cfg["num_layers"]):
        pre = f"blocks.{i}."
        out += [(pre + "ln.scale", (d,), pdt), (pre + "mamba.w_in", (d, 2 * din), pdt),
                (pre + "mamba.conv", (CONV_W, din), pdt), (pre + "mamba.w_b", (d, n), pdt),
                (pre + "mamba.w_c", (d, n), pdt), (pre + "mamba.w_dt", (d, nh), pdt),
                (pre + "mamba.a_log", (nh,), "float32"),
                (pre + "mamba.dt_bias", (nh,), "float32"),
                (pre + "mamba.w_out", (din, d), pdt), (pre + "mamba.norm.scale", (din,), pdt)]
    if cfg["attn_every"]:
        pre = "shared_attn."
        out += [(pre + "ln1.scale", (d,), pdt), (pre + "attn.wq", (d, h * hd), pdt),
                (pre + "attn.wk", (d, hkv * hd), pdt), (pre + "attn.wv", (d, hkv * hd), pdt),
                (pre + "attn.wo", (h * hd, d), pdt), (pre + "ln2.scale", (d,), pdt),
                (pre + "mlp.wi", (d, f), pdt), (pre + "mlp.wo", (f, d), pdt),
                (pre + "mlp.wg", (d, f), pdt)]
    out.append(("final_norm.scale", (d,), pdt))
    return out


def ssd_scan(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             chunk: int = 128) -> torch.Tensor:
    """y of h_t = a_t h_{t-1} + b_t (x) x_t, y_t = c_t . h_t from h = 0.
    x (B, S, H, P), log_a (B, S, H), b and c (B, S, N) (one group)."""
    bsz, s, nh, p = x.shape
    n = b.shape[-1]
    pad = -s % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        log_a = F.pad(log_a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    xc = x.reshape(bsz, nc, chunk, nh, p).permute(0, 3, 1, 2, 4)      # (B, H, nc, L, P)
    cum = torch.cumsum(log_a.reshape(bsz, nc, chunk, nh).permute(0, 3, 1, 2), dim=-1)
    bc = b.reshape(bsz, nc, chunk, n)
    cc = c.reshape(bsz, nc, chunk, n)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(~causal, float("-inf"))
    weights = torch.exp(seg) * (cc @ bc.transpose(-1, -2))[:, None]   # (B, H, nc, L, L)
    y = weights @ xc                                                  # within the chunk
    last = cum[..., -1:]
    states = (bc.transpose(-1, -2)[:, None] * torch.exp(last - cum)[..., None, :]) @ xc
    h = x.new_zeros(bsz, nh, n, p)
    before = []
    decay = torch.exp(last[..., 0])                                   # (B, H, nc)
    for i in range(nc):
        before.append(h)
        h = decay[:, :, i, None, None] * h + states[:, :, i]
    hprev = torch.stack(before, dim=2)                                # (B, H, nc, N, P)
    y = y + (cc[:, None] * torch.exp(cum)[..., None]) @ hprev
    return y.permute(0, 2, 3, 1, 4).reshape(bsz, nc * chunk, nh, p)[:, :s]


def mamba2(p: C.Params, pre: str, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    bsz, s, _ = x.shape
    din, nh, ph, _ = dims(cfg)
    zx = C.mm(x, p[pre + "w_in"])
    z, xin = zx[..., :din], zx[..., din:]
    conv = p[pre + "conv"]
    xp = F.pad(xin, (0, 0, CONV_W - 1, 0))
    xin = F.silu(sum(xp[:, i:i + s] * conv[i] for i in range(CONV_W)))
    dt = F.softplus(x @ p[pre + "w_dt"] + p[pre + "dt_bias"])           # (B, S, H)
    log_a = -dt * torch.exp(p[pre + "a_log"])
    bm, cm = C.mm(x, p[pre + "w_b"]), C.mm(x, p[pre + "w_c"])
    y = ssd_scan(xin.reshape(bsz, s, nh, ph) * dt[..., None], log_a, bm, cm)
    y = C.rmsnorm(y.reshape(bsz, s, din), p[pre + "norm.scale"], cfg["norm_eps"]) * F.silu(z)
    return C.mm(y, p[pre + "w_out"])


def _hybrid_block(p, i, x, cfg, site):
    pre = f"blocks.{i}."
    x = x + mamba2(p, pre + "mamba.", C.rmsnorm(x, p[pre + "ln.scale"], cfg["norm_eps"]), cfg)
    if site:
        sp = "shared_attn."
        eps = cfg["norm_eps"]
        x = x + C.attention(p, sp + "attn.", C.rmsnorm(x, p[sp + "ln1.scale"], eps), cfg)
        x = x + C.swiglu(p, sp + "mlp.", C.rmsnorm(x, p[sp + "ln2.scale"], eps))
    return x


def hidden(p: C.Params, tokens: torch.Tensor, cfg: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final hidden states (B, S, d) after the final norm, auxiliary loss 0)."""
    x = C.act(C.embed(p, tokens))
    k = cfg["attn_every"]
    for i in range(cfg["num_layers"]):
        site = bool(k) and (i + 1) % k == 0
        x = C.act(C.remat(lambda xx, i=i, site=site: _hybrid_block(p, i, xx, cfg, site), x))
    x = C.rmsnorm(x, p["final_norm.scale"], cfg["norm_eps"])
    return x, x.new_zeros(())
