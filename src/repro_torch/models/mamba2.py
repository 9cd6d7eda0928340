"""Mamba2 block (SSD, scalar decay per head): the zamba2 backbone.

The port of ``repro.models.mamba2``.  The forward runs the chunked scan
(``ops.ssm_scan``: the CUDA kernel on the card, its plain version on the
CPU) with the single B/C group broadcast over the heads by a stride-0 view;
decode keeps (h, conv) states and does O(1) work per token.

Inside a mesh context the block runs on this rank's ``ssm_heads`` when
``model`` divides them: ``conv``, ``w_dt``, ``a_log``, ``dt_bias``, the
norm and the ``w_out`` rows are its shards, and the norm's mean over the
inner width is all-reduced over ``model``.  ``w_in`` is gathered over
``model`` and applied replicated: its columns are ``z`` followed by ``x``,
so the reference's ``("embed", "mlp")`` shard is not whole heads (at
``model`` 2, rank 0 would hold all of ``z``); each rank then takes its
heads' part of ``z`` and ``x``.  ``w_b`` and ``w_c`` are replicated, their
products consumed by this rank's heads (f after them).

Under sequence parallelism the causal conv and the scan need the whole
sequence: the block enters as a replicated layer does, gathering its
input along the sequence (``copy_to_model(x, None)``, before ``x @
w_in``: its f's below make the input gradient whole), runs as above with
f inside (``collectives.to_shards``), and leaves through
``reduce_from_model``'s reduce-scatter after ``w_out``.  The prefill keeps
no state, so no sequence-sharded conv window is ever sliced.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops
from .layers import RMSNorm, _normal, dtype_of, rmsnorm

CONV_W = 4
State = Dict[str, torch.Tensor]


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(inner width, heads, head width, state size)."""
    din = cfg.ssm_expand * cfg.d_model
    nh = cfg.ssm_heads or cfg.num_heads
    return din, nh, din // nh, cfg.ssm_state


class Mamba2(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        din, nh, _, n = dims(cfg)
        pdt = dtype_of(cfg.param_dtype)

        def param(*shape, dtype=pdt):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)
        self.w_in = param(d, 2 * din)
        self.conv = param(CONV_W, din)
        self.w_b, self.w_c = param(d, n), param(d, n)
        self.w_dt = param(d, nh)
        self.a_log = param(nh, dtype=torch.float32)
        self.dt_bias = param(nh, dtype=torch.float32)
        self.w_out = param(din, d)
        self.norm = RMSNorm(din, pdt, device)

    def reset_parameters(self, generator=None):
        d, din = self.w_in.shape[0], self.w_out.shape[0]
        for w, std in ((self.w_in, d ** -0.5), (self.conv, 0.1), (self.w_b, d ** -0.5),
                       (self.w_c, d ** -0.5), (self.w_dt, d ** -0.5), (self.w_out, din ** -0.5)):
            w.copy_(_normal(w.shape, std, w.dtype, w.device, generator))
        nn.init.zeros_(self.a_log)
        nn.init.zeros_(self.dt_bias)


def _causal_conv(xin: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width CONV_W.  xin: (B, S, din)."""
    s = xin.shape[1]
    pads = F.pad(xin, (0, 0, CONV_W - 1, 0))
    return sum(pads[:, i:i + s, :] * w[i] for i in range(CONV_W))


def _tp(p: Mamba2, cfg: ModelConfig):
    """The block's ``TP``: local on whole ``ssm_heads``."""
    _, nh, _, _ = dims(cfg)
    return C.tp((p.conv, 1), (p.w_dt, 1), (p.a_log, 0), (p.dt_bias, 0), (p.w_out, 0),
                (p.norm.scale, 0), divides=(nh,))


def _in_proj(p: Mamba2, x: torch.Tensor, cfg: ModelConfig, tp):
    """(z, xin) of this rank's heads: ``x @ w_in``, replicated (``w_in``
    gathered), then each half's local columns."""
    din = dims(cfg)[0]
    zx = C.to_shards(x @ C.param(p.w_in), tp)
    z, xin = zx[..., :din], zx[..., din:]
    if tp is not None and tp.size > 1:
        n = din // tp.size
        z, xin = z[..., tp.rank * n:(tp.rank + 1) * n], xin[..., tp.rank * n:(tp.rank + 1) * n]
    return z, xin


def _gates(p: Mamba2, x: torch.Tensor, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    x = C.to_shards(x, tp)
    dt = F.softplus(x.float() @ C.param(p.w_dt, tp).float() + C.param(p.dt_bias, tp))
    return dt, torch.exp(-dt * torch.exp(C.param(p.a_log, tp)))   # decay in (0, 1]


def _bc(p: Mamba2, x: torch.Tensor, tp) -> Tuple[torch.Tensor, torch.Tensor]:
    return (C.to_shards(x @ C.param(p.w_b), tp).float(),
            C.to_shards(x @ C.param(p.w_c), tp).float())


def mamba2_apply(p: Mamba2, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = C.copy_to_model(x, None)                  # under SP: the whole sequence
    b, s, _ = x.shape
    din, nh, ph, n = dims(cfg)
    tp = _tp(p, cfg)
    m = tp.size if tp is not None else 1
    z, xin = _in_proj(p, x, cfg, tp)
    xin = F.silu(_causal_conv(xin, C.param(p.conv, tp)))
    dt, a = _gates(p, x, tp)
    bmat, cmat = _bc(p, x, tp)
    bmat = bmat[:, :, None, :].expand(b, s, nh // m, n)              # one group, stride 0
    cmat = cmat[:, :, None, :].expand(b, s, nh // m, n)
    xh = xin.reshape(b, s, nh // m, ph) * dt[..., None].to(xin.dtype)
    y, _ = ops.ssm_scan(xh, a, bmat, cmat)
    y = rmsnorm(p.norm, y.reshape(b, s, din // m), cfg.norm_eps, tp) * F.silu(z)
    return C.reduce_from_model(y @ C.param(p.w_out, tp), tp)


def mamba2_init_state(cfg: ModelConfig, batch: int, layers: int, device) -> State:
    """Decode state of ``layers`` stacked blocks: h (L, B, nh, N, ph) and
    the conv window (L, B, CONV_W - 1, din), both f32."""
    din, nh, ph, n = dims(cfg)
    return {"h": torch.zeros(layers, batch, nh, n, ph, dtype=torch.float32, device=device),
            "conv": torch.zeros(layers, batch, CONV_W - 1, din, dtype=torch.float32,
                                device=device)}


def mamba2_decode(p: Mamba2, x: torch.Tensor, h_state: torch.Tensor, conv_state: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """x: (B, 1, d) -> out (B, 1, d).  ``h_state`` (B, nh, N, ph) and
    ``conv_state`` (B, CONV_W - 1, din) are updated in place (this rank's
    heads in a mesh context)."""
    b = x.shape[0]
    din, nh, ph, _ = dims(cfg)
    tp = _tp(p, cfg)
    m = tp.size if tp is not None else 1
    z, xin = _in_proj(p, x, cfg, tp)
    window = torch.cat([conv_state, xin.float()], dim=1)           # (B, CONV_W, din)
    conv = C.param(p.conv, tp)
    conv_out = sum(window[:, i, :] * conv[i].float() for i in range(CONV_W))
    xin1 = F.silu(conv_out)[:, None, :]
    dt, a = _gates(p, x, tp)                                        # (B, 1, nh)
    bmat, cmat = _bc(p, x, tp)
    xh = (xin1.reshape(b, nh // m, ph) * dt[:, 0, :, None]).float()
    h = h_state * a[:, 0, :, None, None] + bmat[:, 0, None, :, None] * xh[:, :, None, :]
    y = torch.einsum("bn,bhnp->bhp", cmat[:, 0], h).reshape(b, 1, din // m)
    y = rmsnorm(p.norm, y.to(x.dtype), cfg.norm_eps, tp) * F.silu(z)
    h_state.copy_(h)
    conv_state.copy_(window[:, 1:, :])
    return C.reduce_from_model(y @ C.param(p.w_out, tp), tp)
