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
calls, which pick the CUDA kernel or its plain version by device.  They
take each expert's filled rows, min(count, cap) from the sort's expert
starts (a kept pair's rank is its slot, so the filled slots of an expert
are its first ones): the kernels skip the empty rows' products and store
zeros there, which is what the empty rows computed before.
Its three phases are the spans ``repro.moe.dispatch`` (router, aux loss,
sort, ranks, the ``index_add_``), ``repro.moe.experts`` (the grouped
matmuls and the gate) and ``repro.moe.combine``; while a sink records, the
forward run (not the remat's re-run) counts ``moe.rows_computed`` and
``moe.rows_filled`` (``core/telemetry``'s ``REGISTRY``).

Inside a mesh context the layer keeps the reference's global semantics, as
GSPMD computes its sharded ``moe_apply``: the router's outputs are gathered
over the batch shards, so the capacity is ``capacity(B * S)`` of the global
batch, the stable sort and the ranks run over the global token order and
the aux loss takes global means.  Each rank adds its own tokens into the
(E, cap, d) buffer, which the all-reduce over the batch shards makes the
reference's buffer, replicated over ``data``: the slots are disjoint, so
the sum is exact.  With ``experts`` sharded over ``model`` each rank keeps
the slots of its experts only and runs the grouped matmuls on them; the
combine's partial sums are all-reduced over ``model``.  The gradient of a
buffer row comes only from the same row of the expert outputs (the grouped
matmul and the gating are row-wise), so the buffer's all-reduce passes the
gradient back unchanged.

Under sequence parallelism the layer first gathers its input along the
sequence over ``model``, entering as a replicated layer does
(``copy_to_model(x, None)``: its f's make the input gradient whole), so
that each rank
holds its batch shard's (b, s) tokens in the reference's order before they
are flattened and gathered over the batch shards: the capacity drops then
land on the reference's tokens.  Everything above runs as it is, f inside
(``collectives.to_shards``), and the output leaves through
``reduce_from_model``'s reduce-scatter along the sequence.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import telemetry
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import shard_hint
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
    probs = torch.softmax(xf.float() @ C.param(p.router), dim=-1)
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_ids = ranked.values[:, :k], ranked.indices[:, :k]
    if k > 1:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return probs, gate_vals, gate_ids


def _count_rows(rows: int, filled) -> None:
    """The layer's counters: the rows each grouped matmul runs (``el * cap``)
    and those of them holding a kept (token, choice) pair, a host int where
    capacity keeps every pair (cap >= T), else the device sum of ``keep``
    (no wait for the device).  Dropped pairs are T k less the filled rows."""
    telemetry.REGISTRY.counter("moe.rows_computed").inc(rows)
    telemetry.REGISTRY.counter("moe.rows_filled").inc(filled)


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), load-balance aux loss (f32 scalar)).
    In a mesh context x is this rank's batch shard (the module docstring
    says how the layer keeps the global semantics)."""
    with telemetry.span("repro.moe.dispatch"):
        x = C.copy_to_model(x, None)                  # under SP: the whole sequence
        b, s, d = x.shape
        e, k = cfg.num_experts, cfg.experts_per_token
        t = b * s
        xf = x.reshape(t, d)
        probs, gate_vals, gate_ids = route(p, xf, cfg)
        tp = C.tp((p.wi, 0), (p.wg, 0), (p.wo, 0), divides=(e,))
        part, parts = C.batch_place()                 # this rank's token range
        lo = part * t
        probs_all, ids_all = C.gather_batch(probs), C.gather_batch(gate_ids)
        tg = t * parts

        # load-balance auxiliary loss (Switch-style)
        me = probs_all.mean(dim=0)
        ce = F.one_hot(ids_all[:, 0], e).float().mean(dim=0)
        aux = e * torch.sum(me * ce)

        # sort-based dispatch over the global token order
        cap = capacity(tg, cfg)
        flat_e = ids_all.reshape(-1)                                    # (T*k,)
        flat_g = C.gather_batch(gate_vals).reshape(-1)
        flat_src = torch.arange(tg, device=x.device).repeat_interleave(k)
        order = torch.argsort(flat_e, stable=True)
        se, sg, ssrc = flat_e[order], flat_g[order], flat_src[order]
        bounds = torch.searchsorted(se, torch.arange(e + 1, device=x.device), side="left",
                                    out_int32=True)           # each expert's start, then T*k
        starts = bounds[:-1]
        rank = torch.arange(tg * k, device=x.device) - starts[se]
        keep = rank < cap
        # this rank's entries: its own tokens, and with experts over ``model``
        # its own experts; every other entry goes to the overflow row
        el = e // tp.size if tp is not None else e
        e0 = tp.rank * el if tp is not None else 0
        # the filled rows of this rank's experts in the buffer the batch sum
        # makes (global ranks: every batch shard's pairs)
        rows = (bounds[e0 + 1:e0 + el + 1] - bounds[e0:e0 + el]).clamp_(max=cap)
        if parts > 1:
            keep = keep & (ssrc >= lo) & (ssrc < lo + t)
        if el < e:
            keep = keep & (se >= e0) & (se < e0 + el)
        slot = torch.where(keep, (se - e0) * cap + rank, torch.full_like(se, el * cap))
        src = (ssrc - lo).clamp(0, t - 1) if parts > 1 else ssrc
        xd = C.to_shards(xf, tp)

        buf = torch.zeros(el * cap + 1, d, dtype=x.dtype, device=x.device)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        buf.index_add_(0, slot, torch.where(keep[:, None], xd[src], zero))
        buf = C.batch_sum(buf[:-1].reshape(el, cap, d))
        buf = shard_hint(buf, ("experts", "expert_cap", "embed"))
    if telemetry.on() and torch._C._current_graph_task_id() == -1:
        # the forward run only, not the remat's re-run inside the backward
        _count_rows(el * cap, tg * k if cap >= tg and parts == 1 and el == e else keep.sum())

    # expert computation (grouped matmuls)
    with telemetry.span("repro.moe.experts"):
        wg, wi, wo = (C.param(w, tp) for w in (p.wg, p.wi, p.wo))
        # h's empty rows are silu(0) * 0 = 0, so the counts hold for wo too
        h = F.silu(ops.grouped_matmul(buf, wg, rows)) * ops.grouped_matmul(buf, wi, rows)
        y = ops.grouped_matmul(h.to(x.dtype), wo, rows)
        y = shard_hint(y, ("experts", "expert_cap", "embed"))

    # combine, in f32: each token's k contributions back in choice order and
    # summed in that order (no atomics, so a run on the card is repeatable)
    with telemetry.span("repro.moe.combine"):
        yflat = torch.cat([y.reshape(el * cap, d), y.new_zeros(1, d)], dim=0)
        contrib = yflat[slot].float() * (C.to_shards(sg, tp) * keep.float())[:, None]
        unsorted = torch.empty_like(contrib)
        unsorted[order] = contrib
        if parts > 1:
            unsorted = unsorted[lo * k:(lo + t) * k]
        out = C.reduce_from_model(unsorted.reshape(t, k, d).sum(dim=1).reshape(b, s, d), tp)
        out = out.to(x.dtype)

    if p.shared is not None:
        sh = p.shared
        stp = C.tp((sh.wi, 1), (sh.wg, 1), (sh.wo, 0))
        local = (tp is not None and tp.local, stp is not None and stp.local)
        xs = xd if local[0] == local[1] else C.to_shards(xf, stp)   # one f where both are
        hs = F.silu(xs @ C.param(sh.wg, stp)) * (xs @ C.param(sh.wi, stp))
        out = out + C.reduce_from_model((hs @ C.param(sh.wo, stp)).reshape(b, s, d), stp)
    return out, aux
