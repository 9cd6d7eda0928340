"""Mixture-of-Experts layer: top-k routing with sort-based capacity dispatch.

The port of ``repro.models.moe``.  Tokens are replicated k ways, sorted by
expert id (a stable sort, as ``jnp.argsort`` is), ranked within their
expert, dropped beyond capacity, added into the (E, cap, d) buffer that the
grouped matmul consumes (``index_add_`` into ``E * cap + 1`` rows, the
overflow row last), and combined back in f32 weighted by the router
probabilities.  The combine sums each token's k contributions in choice
order rather than by a scatter-add (the reference's ``.at[ssrc].add``): on
the card ``index_add_`` adds with atomics in no fixed order, and with a
near-uniform router the last bit of one sum can flip a later layer's expert
choice.  The expert computation is three ``ops.grouped_matmul``
calls, which pick the CUDA kernel or its plain version by device.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from .layers import _normal, dtype_of


class SharedExpert(nn.Module):
    def __init__(self, d: int, f: int, pdt: torch.dtype, device):
        super().__init__()
        self.wi = nn.Parameter(torch.empty(d, f, dtype=pdt, device=device), requires_grad=False)
        self.wg = nn.Parameter(torch.empty(d, f, dtype=pdt, device=device), requires_grad=False)
        self.wo = nn.Parameter(torch.empty(f, d, dtype=pdt, device=device), requires_grad=False)

    def reset_parameters(self, generator=None):
        d, f = self.wi.shape
        for w, std in ((self.wi, d ** -0.5), (self.wg, d ** -0.5), (self.wo, f ** -0.5)):
            w.copy_(_normal(w.shape, std, w.dtype, w.device, generator))


class MoE(nn.Module):
    """Router (d, E) in f32; expert weights wi, wg (E, d, f) and wo (E, f, d)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        pdt = dtype_of(cfg.param_dtype)

        def param(*shape, dtype=pdt):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)
        self.router = param(d, e, dtype=torch.float32)
        self.wi, self.wg, self.wo = param(e, d, f), param(e, d, f), param(e, f, d)
        self.shared = SharedExpert(d, f, pdt, device) if cfg.shared_expert else None

    def reset_parameters(self, generator=None):
        _, d, f = self.wi.shape
        for w, std in ((self.router, d ** -0.5), (self.wi, d ** -0.5), (self.wg, d ** -0.5),
                       (self.wo, f ** -0.5)):
            w.copy_(_normal(w.shape, std, w.dtype, w.device, generator))


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: tokens * k * capacity_factor / E, at least 8 and
    rounded up to a multiple of 8."""
    cap = int(math.ceil(tokens * cfg.experts_per_token * cfg.capacity_factor
                        / cfg.num_experts))
    return max(8, -(-cap // 8) * 8)


def route(p: MoE, xf: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router of tokens xf (T, d): (probs (T, E) f32, gate values (T, k),
    expert ids (T, k)).  The top k in lax.top_k's order: descending, ties to
    the lower expert id (a stable sort); with k > 1 the values are
    renormalised over the k."""
    k = cfg.experts_per_token
    probs = torch.softmax(xf.float() @ p.router, dim=-1)
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_ids = ranked.values[:, :k], ranked.indices[:, :k]
    if k > 1:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return probs, gate_vals, gate_ids


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), load-balance aux loss (f32 scalar))."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xf = x.reshape(t, d)
    probs, gate_vals, gate_ids = route(p, xf, cfg)

    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_ids[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(me * ce)

    # sort-based dispatch
    cap = capacity(t, cfg)
    flat_e = gate_ids.reshape(-1)                                   # (T*k,)
    flat_g = gate_vals.reshape(-1)
    flat_src = torch.arange(t, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, sg, ssrc = flat_e[order], flat_g[order], flat_src[order]
    starts = torch.searchsorted(se, torch.arange(e, device=x.device), side="left")
    rank = torch.arange(t * k, device=x.device) - starts[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, torch.full_like(se, e * cap))

    buf = torch.zeros(e * cap + 1, d, dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot, torch.where(keep[:, None], xf[ssrc], torch.zeros((), dtype=x.dtype,
                                                                             device=x.device)))
    buf = buf[:-1].reshape(e, cap, d)

    # expert computation (grouped matmuls)
    h = F.silu(ops.grouped_matmul(buf, p.wg)) * ops.grouped_matmul(buf, p.wi)
    y = ops.grouped_matmul(h.to(x.dtype), p.wo)
    yflat = torch.cat([y.reshape(e * cap, d), y.new_zeros(1, d)], dim=0)

    # combine, in f32: each token's k contributions back in choice order and
    # summed in that order (no atomics, so a run on the card is repeatable)
    contrib = yflat[slot].float() * (sg * keep.float())[:, None]
    unsorted = torch.empty_like(contrib)
    unsorted[order] = contrib
    out = unsorted.reshape(t, k, d).sum(dim=1).to(x.dtype).reshape(b, s, d)

    if p.shared is not None:
        sp = p.shared
        hs = F.silu(xf @ sp.wg) * (xf @ sp.wi)
        out = out + (hs @ sp.wo).reshape(b, s, d)
    return out, aux
