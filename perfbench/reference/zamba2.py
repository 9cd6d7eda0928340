"""Plain reference of the published Zamba2 (Zyphra's Zamba2-7B, arXiv:2411.15242),
as ``transformers``' ``models/zamba2/modeling_zamba2.py`` computes it on its
``torch_forward`` path, in float32 PyTorch with no kernel of the program.

e is the token embeddings, x the residual stream, d the model width.

- A plain layer i: ``x = x + Mamba2_i(RMSNorm(x))``.
- A hybrid layer i that is site j (the j-th entry of ``hybrid_layers``):
  ``t = Shared_{j mod shared_blocks}(x, e)``, then
  ``x = x + Mamba2_i(RMSNorm(x + t @ linear_j))``: the site's output is
  added to the mixer's input, not to the residual.
- Shared block k at site j: ``a = RMSNorm_2d([x, e])``; ``o = Attn(a)``,
  ``num_heads`` heads of ``head_dim`` over the 2d-wide input, RoPE on q and
  k, causal, the scale (head_dim / 2)^-1/2, ``wo`` back to d;
  ``t = MLP_j(RMSNorm_d(o))``.  No residual inside the block.
- ``MLP_j``: ``gelu(g) * u @ wo`` with ``[g | u] = h @ [wg | wi] +
  (h @ adapter_in_j) @ adapter_out_j``, site j's own low-rank adapter; the
  exact (erf) GELU.
- ``Mamba2_i``: ``w_in`` gives z and x, ``w_b`` and ``w_c`` give B and C
  (``ssm_groups`` groups of ``ssm_state``), ``w_dt`` the step; a depthwise
  causal conv of width 4 with a bias over ``[x | B | C]``, then SiLU;
  ``dt = softplus(dt + dt_bias)``, the decay ``exp(-dt exp(a_log))``; head h
  reads group ``h // (heads / groups)``; ``y = scan + d_skip * x``;
  ``RMSNorm(y * silu(z))`` over each group's ``din / groups`` channels,
  then ``w_out``.
- Final: RMSNorm, then logits against the tied table (``common.logits``).

Configuration keys read: ``num_layers`` (the mixers), ``d_model``,
``num_heads``, ``num_kv_heads``, ``head_dim`` (else 2 d / heads, as
published), ``d_ff``, ``vocab_size``, ``norm_eps``, ``rope_theta``,
``tie_embeddings``, ``ssm_state``, ``ssm_heads``, ``ssm_expand``,
``param_dtype``, and ``ssm_groups`` (B/C groups), ``shared_blocks`` (the
shared blocks, used in turn), ``hybrid_layers`` (the layers that are sites,
ascending) and ``adapter_rank``.

Parameters, the names, shapes and dtypes the program's have to meet
(``lib/weights.load_into``); matrices are (d_in, d_out); every leaf is
``param_dtype`` unless marked; din = ssm_expand d, nh = ssm_heads, G N =
ssm_groups x ssm_state, r = adapter_rank; V is padded to a multiple of 2,048:

| Leaves | Shape |
|---|---|
| ``embed.tok`` (tied) | (padded V, d) |
| ``blocks.{i}.ln.scale`` | (d) |
| ``blocks.{i}.mamba.w_in`` | (d, 2 din), columns ``[z | x]`` |
| ``blocks.{i}.mamba.w_b``, ``.w_c`` | (d, G N) |
| ``blocks.{i}.mamba.w_dt`` | (d, nh) |
| ``blocks.{i}.mamba.conv`` | (4, din + 2 G N), channels ``[x | B | C]`` |
| ``blocks.{i}.mamba.conv_bias`` | (din + 2 G N) |
| ``blocks.{i}.mamba.a_log``, ``.dt_bias``, ``.d_skip`` | (nh), float32 |
| ``blocks.{i}.mamba.norm.scale`` | (din) |
| ``blocks.{i}.mamba.w_out`` | (din, d) |
| ``sites.{j}.linear`` | (d, d) |
| ``sites.{j}.adapter_in`` | (d, r) |
| ``sites.{j}.adapter_out`` | (r, 2 d_ff), columns ``[gate | up]`` |
| ``shared.{k}.ln1.scale`` | (2 d) |
| ``shared.{k}.attn.wq`` | (2 d, heads hd) |
| ``shared.{k}.attn.wk``, ``.wv`` | (2 d, kv heads hd) |
| ``shared.{k}.attn.wo`` | (heads hd, d) |
| ``shared.{k}.ln2.scale`` | (d) |
| ``shared.{k}.mlp.wg``, ``.wi`` | (d, d_ff) |
| ``shared.{k}.mlp.wo`` | (d_ff, d) |
| ``final_norm.scale`` | (d) |

Departures from ``transformers``' model:

- dt is not clamped from below: the ``torch_forward`` path clamps it at
  ``time_step_min`` (1e-3); ``mamba_ssm``'s kernels, which the model is
  trained with, clamp it only to ``time_step_limit``, null in Zamba2-7B's
  config, and so does this reference.
- The gated norm's eps is ``norm_eps`` (``transformers`` fixes it at 1e-5,
  Zamba2-7B's ``rms_norm_eps``).
- Token 0, the published ``pad_token_id``, is an ordinary token: its row of
  the table takes a gradient through the lookup as well as through the
  logits.
- RoPE always, and no adapters on q, k and v: Zamba2-7B sets
  ``use_mem_rope`` and not ``use_shared_attention_adapter``.
- The table is padded to a multiple of 2,048 rows, which are not scored.
- The scan is computed by ``hybrid.ssd_scan`` in chunks of 128, once a
  group (``transformers``: 256, all heads at once): the same sums in
  another order.

Each layer runs under ``common.remat`` and attention in row blocks
(``common.causal_attention``), so a step fits at the cut's full size.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import common as C
from perfbench.reference.hybrid import CONV_W, padded_vocab, ssd_scan

# common.causal_attention scales the scores by head_dim^-1/2; q times
# sqrt(2) makes that the published (head_dim / 2)^-1/2
Q_GAIN = math.sqrt(2.0)


def dims(cfg: dict) -> Tuple[int, int, int, int, int]:
    """(inner width, heads, head width, state size, B/C groups)."""
    din = cfg["ssm_expand"] * cfg["d_model"]
    nh = cfg["ssm_heads"]
    return din, nh, din // nh, cfg["ssm_state"], cfg["ssm_groups"]


def head_dim(cfg: dict) -> int:
    return cfg["head_dim"] or 2 * cfg["d_model"] // cfg["num_heads"]


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, dtype) of every parameter."""
    d, f, v = cfg["d_model"], cfg["d_ff"], padded_vocab(cfg)
    din, nh, _, n, g = dims(cfg)
    h, hkv, hd, r = cfg["num_heads"], cfg["num_kv_heads"], head_dim(cfg), cfg["adapter_rank"]
    pdt = cfg["param_dtype"]
    out = [("embed.tok", (v, d), pdt)]
    if not cfg["tie_embeddings"]:
        out.append(("embed.out", (v, d), pdt))
    for i in range(cfg["num_layers"]):
        pre = f"blocks.{i}."
        out += [(pre + "ln.scale", (d,), pdt), (pre + "mamba.w_in", (d, 2 * din), pdt),
                (pre + "mamba.w_b", (d, g * n), pdt), (pre + "mamba.w_c", (d, g * n), pdt),
                (pre + "mamba.w_dt", (d, nh), pdt),
                (pre + "mamba.conv", (CONV_W, din + 2 * g * n), pdt),
                (pre + "mamba.conv_bias", (din + 2 * g * n,), pdt),
                (pre + "mamba.a_log", (nh,), "float32"),
                (pre + "mamba.dt_bias", (nh,), "float32"),
                (pre + "mamba.d_skip", (nh,), "float32"),
                (pre + "mamba.norm.scale", (din,), pdt), (pre + "mamba.w_out", (din, d), pdt)]
    for j in range(len(cfg["hybrid_layers"])):
        pre = f"sites.{j}."
        out += [(pre + "linear", (d, d), pdt), (pre + "adapter_in", (d, r), pdt),
                (pre + "adapter_out", (r, 2 * f), pdt)]
    for k in range(cfg["shared_blocks"]):
        pre = f"shared.{k}."
        out += [(pre + "ln1.scale", (2 * d,), pdt), (pre + "attn.wq", (2 * d, h * hd), pdt),
                (pre + "attn.wk", (2 * d, hkv * hd), pdt),
                (pre + "attn.wv", (2 * d, hkv * hd), pdt),
                (pre + "attn.wo", (h * hd, d), pdt), (pre + "ln2.scale", (d,), pdt),
                (pre + "mlp.wg", (d, f), pdt), (pre + "mlp.wi", (d, f), pdt),
                (pre + "mlp.wo", (f, d), pdt)]
    out.append(("final_norm.scale", (d,), pdt))
    return out


def scan(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
         groups: int) -> torch.Tensor:
    """The selective scan, head h reading B/C group h // (heads / groups);
    x (B, S, H, P), log_a (B, S, H), b and c (B, S, groups N)."""
    per, n = x.shape[2] // groups, b.shape[-1] // groups
    return torch.cat([ssd_scan(x[:, :, k * per:(k + 1) * per], log_a[..., k * per:(k + 1) * per],
                               b[..., k * n:(k + 1) * n], c[..., k * n:(k + 1) * n])
                      for k in range(groups)], dim=2)


def gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, groups: int,
               eps: float) -> torch.Tensor:
    """RMSNorm(y * silu(z)) over each group's channels; y, z (B, S, din)."""
    shape = y.shape
    yz = (y * F.silu(z)).reshape(*shape[:-1], groups, shape[-1] // groups)
    return C.rmsnorm(yz, scale.reshape(groups, -1), eps).reshape(shape)


def mamba2(p: C.Params, pre: str, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    bsz, s, _ = x.shape
    din, nh, ph, n, g = dims(cfg)
    zx = C.mm(x, p[pre + "w_in"])
    z = zx[..., :din]
    xbc = torch.cat([zx[..., din:], C.mm(x, p[pre + "w_b"]), C.mm(x, p[pre + "w_c"])], dim=-1)
    conv = p[pre + "conv"]
    xp = F.pad(xbc, (0, 0, CONV_W - 1, 0))
    xbc = F.silu(sum(xp[:, i:i + s] * conv[i] for i in range(CONV_W)) + p[pre + "conv_bias"])
    xs, bm, cm = xbc.split([din, g * n, g * n], dim=-1)
    dt = F.softplus(C.mm(x, p[pre + "w_dt"]) + p[pre + "dt_bias"])      # (B, S, H)
    log_a = -dt * torch.exp(p[pre + "a_log"])
    xh = xs.reshape(bsz, s, nh, ph)
    y = scan(xh * dt[..., None], log_a, bm, cm, g) + p[pre + "d_skip"][:, None] * xh
    y = gated_norm(y.reshape(bsz, s, din), z, p[pre + "norm.scale"], g, cfg["norm_eps"])
    return C.mm(y, p[pre + "w_out"])


def attention(p: C.Params, pre: str, a: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Causal attention over the 2d-wide a (B, S, 2d), back to d."""
    b, s, _ = a.shape
    h, hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], head_dim(cfg)
    q = C.mm(a, p[pre + "wq"]).reshape(b, s, h, hd).transpose(1, 2)
    k = C.mm(a, p[pre + "wk"]).reshape(b, s, hkv, hd).transpose(1, 2)
    v = C.mm(a, p[pre + "wv"]).reshape(b, s, hkv, hd).transpose(1, 2)
    q, k = C.rope(q, cfg["rope_theta"]), C.rope(k, cfg["rope_theta"])
    o = C.causal_attention(q * Q_GAIN, k, v).transpose(1, 2).reshape(b, s, h * hd)
    return C.mm(o, p[pre + "wo"])


def site(p: C.Params, j: int, x: torch.Tensor, e: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Site j's output, ``Shared_{j mod shared_blocks}(x, e) @ linear_j``."""
    pre, sp = f"shared.{j % cfg['shared_blocks']}.", f"sites.{j}."
    eps, f = cfg["norm_eps"], cfg["d_ff"]
    a = C.rmsnorm(torch.cat([x, e], dim=-1), p[pre + "ln1.scale"], eps)
    hid = C.rmsnorm(attention(p, pre + "attn.", a, cfg), p[pre + "ln2.scale"], eps)
    low = C.mm(C.mm(hid, p[sp + "adapter_in"]), p[sp + "adapter_out"])
    gate = C.mm(hid, p[pre + "mlp.wg"]) + low[..., :f]
    up = C.mm(hid, p[pre + "mlp.wi"]) + low[..., f:]
    t = C.mm(F.gelu(gate) * up, p[pre + "mlp.wo"])
    return C.mm(t, p[sp + "linear"])


def layer(p: C.Params, i: int, x: torch.Tensor, e: torch.Tensor, cfg: dict,
          j: Optional[int]) -> torch.Tensor:
    """Layer i; j is its site's index, None for a plain layer."""
    pre = f"blocks.{i}."
    inp = x if j is None else x + site(p, j, x, e, cfg)
    return x + mamba2(p, pre + "mamba.", C.rmsnorm(inp, p[pre + "ln.scale"], cfg["norm_eps"]),
                      cfg)


def hidden(p: C.Params, tokens: torch.Tensor, cfg: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final hidden states (B, S, d) after the final norm, auxiliary loss 0)."""
    e = C.act(C.embed(p, tokens))
    sites = {i: j for j, i in enumerate(cfg["hybrid_layers"])}
    x = e
    for i in range(cfg["num_layers"]):
        x = C.act(C.remat(lambda xx, ee, i=i: layer(p, i, xx, ee, cfg, sites.get(i)), x, e))
    x = C.rmsnorm(x, p["final_norm.scale"], cfg["norm_eps"])
    return x, x.new_zeros(())
