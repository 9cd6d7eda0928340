"""Plain reference of the moe family (Granite 3.0 MoE): every layer is
attention + a mixture of experts.

Each layer: RMSNorm, GQA attention with RoPE, a residual; RMSNorm, the MoE,
a residual.  The MoE: a float32 router (softmax over the experts), the top
k experts of each token (descending, ties to the lower id), their
probabilities renormalised over the k; the Switch load-balance loss
E * sum(mean probability * share of first choices), added x 0.01 to the
loss.  Dispatch with a capacity of ceil(T k 1.25 / E) slots an expert
(at least 8, a multiple of 8): the (token, choice) pairs in token order,
stably grouped by expert, and those past the capacity dropped.  Each
expert is a SwiGLU MLP; a token's output is the sum of its kept choices'
outputs weighted by the gates.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import common as C
from perfbench.reference.hybrid import padded_vocab


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, dtype) of every parameter, in the program's order."""
    d, f, v, e = cfg["d_model"], cfg["d_ff"], padded_vocab(cfg), cfg["num_experts"]
    hd = cfg["head_dim"] or d // cfg["num_heads"]
    h, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    pdt = cfg["param_dtype"]
    if cfg["moe_every"] != 1 or cfg["shared_expert"]:
        raise NotImplementedError("moe_every 1 without a shared expert only")
    out = [("embed.tok", (v, d), pdt)]
    if not cfg["tie_embeddings"]:
        out.append(("embed.out", (v, d), pdt))
    for i in range(cfg["num_layers"]):
        pre = f"blocks.{i}.l0."
        out += [(pre + "ln1.scale", (d,), pdt), (pre + "attn.wq", (d, h * hd), pdt),
                (pre + "attn.wk", (d, hkv * hd), pdt), (pre + "attn.wv", (d, hkv * hd), pdt),
                (pre + "attn.wo", (h * hd, d), pdt), (pre + "ln2.scale", (d,), pdt),
                (pre + "moe.router", (d, e), "float32"), (pre + "moe.wi", (e, d, f), pdt),
                (pre + "moe.wg", (e, d, f), pdt), (pre + "moe.wo", (e, f, d), pdt)]
    out.append(("final_norm.scale", (d,), pdt))
    return out


def capacity(tokens: int, cfg: dict) -> int:
    cap = int(math.ceil(tokens * cfg["experts_per_token"] * cfg["capacity_factor"]
                        / cfg["num_experts"]))
    return max(8, -(-cap // 8) * 8)


def moe(p: C.Params, pre: str, x: torch.Tensor, cfg: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    e, k = cfg["num_experts"], cfg["experts_per_token"]
    t = b * s
    xf = x.reshape(t, d)
    probs = torch.softmax(xf @ p[pre + "router"], dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = top.values[:, :k], top.indices[:, :k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    aux = e * torch.sum(probs.mean(dim=0) * F.one_hot(ids[:, 0], e).float().mean(dim=0))

    cap = capacity(t, cfg)
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    starts = torch.searchsorted(se, torch.arange(e, device=x.device))
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(t * k, device=x.device) - starts[se]
    keep = rank < cap                                          # (T k,), token order
    src = torch.arange(t, device=x.device).repeat_interleave(k)
    slot = flat_e * cap + rank
    buf = x.new_zeros(e * cap, d)
    buf = buf.index_put((slot[keep],), xf[src[keep]])
    buf = buf.reshape(e, cap, d)
    wg, wi, wo = p[pre + "wg"], p[pre + "wi"], p[pre + "wo"]
    hidden = F.silu(C.mm(buf, wg)) * C.mm(buf, wi)
    y = C.mm(hidden, wo).reshape(e * cap, d)
    contrib = torch.where(keep[:, None], y[slot.clamp(max=e * cap - 1)], 0.0)
    out = (contrib * gates.reshape(-1)[:, None]).reshape(t, k, d).sum(dim=1)
    return out.reshape(b, s, d), aux


def _layer(p, i, x, cfg):
    pre = f"blocks.{i}.l0."
    eps = cfg["norm_eps"]
    x = x + C.attention(p, pre + "attn.", C.rmsnorm(x, p[pre + "ln1.scale"], eps), cfg)
    y, aux = moe(p, pre + "moe.", C.rmsnorm(x, p[pre + "ln2.scale"], eps), cfg)
    return x + y, aux


def hidden(p: C.Params, tokens: torch.Tensor, cfg: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final hidden states (B, S, d) after the final norm, the summed
    load-balance loss)."""
    x = C.act(C.embed(p, tokens))
    aux = x.new_zeros(())
    for i in range(cfg["num_layers"]):
        x, a = C.remat(lambda xx, i=i: _layer(p, i, xx, cfg), x)
        x = C.act(x)
        aux = aux + a
    x = C.rmsnorm(x, p["final_norm.scale"], cfg["norm_eps"])
    return x, aux
