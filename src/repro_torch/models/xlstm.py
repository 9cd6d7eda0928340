"""xLSTM blocks: mLSTM (matrix memory, chunk-scanned) and sLSTM (scalar
memory, sequential).

The port of ``repro.models.xlstm``.  The mLSTM recurrence
C_t = f_t C_{t-1} + i_t k_t (x) v_t is the ``ops.ssm_scan`` form (a = f,
b = i * k, x = v, c = q), plus a normaliser scan with x = 1 (P = 1), so the
forward runs the chunked scan twice per block (the JAX package runs the
normaliser on its sequential reference; here it takes the kernel on the
card like any other scan).  The sLSTM is a data-dependent scalar recurrence
with no chunked form, which the reference runs as a ``lax.scan``: here
``ops.slstm_scan``, one kernel launch over time (``csrc/slstm.cu``) and
one for its backward.  Its decode step is one time step in plain PyTorch.

Inside a mesh context the blocks are replicated over ``model`` (the
reference's ``mlstm``/``slstm`` rule, ``partition._axes_for``): each
weight is gathered over ``data`` where it is used and nothing else changes.
Under sequence parallelism the mLSTM and sLSTM scans run over the
whole sequence, replicated over ``model``: each block enters and leaves
as a replicated layer (``copy_to_model`` / ``reduce_from_model`` with no
``TP``): it gathers its input along the sequence and keeps this rank's
chunk of its output.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops
from .layers import RMSNorm, _normal, dtype_of, rmsnorm

State = Dict[str, torch.Tensor]


def _sigmoid(v: torch.Tensor) -> torch.Tensor:
    """exp(-softplus(-v)), the reference's stable sigmoid."""
    return torch.exp(-F.softplus(-v))


def _params(module: nn.Module, shapes: Dict[str, tuple], pdt, device) -> None:
    for name, shape in shapes.items():
        setattr(module, name, nn.Parameter(torch.empty(shape, dtype=pdt, device=device),
                                           requires_grad=False))


class MLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
        pdt = dtype_of(cfg.param_dtype)
        _params(self, {"wq": (d, h * hd), "wk": (d, h * hd), "wv": (d, h * hd),
                       "wif": (d, 2 * h), "wo": (h * hd, d), "wup": (d, 2 * d)}, pdt, device)
        self.norm = RMSNorm(h * hd, pdt, device)

    def reset_parameters(self, generator=None):
        d = self.wq.shape[0]
        for w in (self.wq, self.wk, self.wv, self.wif, self.wo, self.wup):
            w.copy_(_normal(w.shape, d ** -0.5, w.dtype, w.device, generator))


class SLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
        _params(self, {"wz": (d, h * hd), "wg": (d, 3 * h), "wo": (h * hd, d)},
                dtype_of(cfg.param_dtype), device)

    def reset_parameters(self, generator=None):
        d = self.wz.shape[0]
        for w in (self.wz, self.wg, self.wo):
            w.copy_(_normal(w.shape, d ** -0.5, w.dtype, w.device, generator))


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------
def _mlstm_qkvif(p: MLSTM, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q = (x @ C.param(p.wq)).reshape(b, s, h, hd)
    k = (x @ C.param(p.wk)).reshape(b, s, h, hd) * hd ** -0.5
    v = (x @ C.param(p.wv)).reshape(b, s, h, hd)
    gif = (x @ C.param(p.wif)).float().reshape(b, s, h, 2)
    return q, k, v, _sigmoid(gif[..., 0]), _sigmoid(gif[..., 1])


def _mlstm_out(p: MLSTM, x: torch.Tensor, y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """y: (B, S, h * hd) normalised cell output -> the block's output."""
    d = cfg.d_model
    y = rmsnorm(p.norm, y.to(x.dtype), cfg.norm_eps)
    up = x @ C.param(p.wup)
    return (y * F.silu(up[..., :d])) @ C.param(p.wo)


def mlstm_apply(p: MLSTM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = C.copy_to_model(x, None)
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v, ig, fg = _mlstm_qkvif(p, x, cfg)
    bk = k.float() * ig[..., None]
    qf = q.float()
    y, _ = ops.ssm_scan(v, fg, bk, qf)
    nrm, _ = ops.ssm_scan(torch.ones(b, s, h, 1, dtype=torch.float32, device=x.device),
                          fg, bk, qf)
    y = y / torch.clamp(nrm.abs(), min=1.0)
    return C.reduce_from_model(_mlstm_out(p, x, y.reshape(b, s, h * hd), cfg), None)


def mlstm_init_state(cfg: ModelConfig, batch: int, layers: int, device) -> State:
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    return {"C": torch.zeros(layers, batch, h, hd, hd, dtype=torch.float32, device=device),
            "n": torch.zeros(layers, batch, h, hd, dtype=torch.float32, device=device)}


def mlstm_decode(p: MLSTM, x: torch.Tensor, C: torch.Tensor, n: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """x: (B, 1, d) -> out (B, 1, d); C (B, h, hd, hd) and n (B, h, hd) are
    updated in place."""
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v, ig, fg = _mlstm_qkvif(p, x, cfg)
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    ig, fg = ig[:, 0], fg[:, 0]
    C.mul_(fg[..., None, None]).add_((ig[..., None] * k)[..., :, None] * v[..., None, :])
    n.mul_(fg[..., None]).add_(ig[..., None] * k)
    y = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.clamp(torch.einsum("bhk,bhk->bh", q, n).abs()[..., None], min=1.0)
    return _mlstm_out(p, x, (y / den).reshape(b, 1, h * hd), cfg)


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------
def _slstm_gates(p: SLSTM, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    z = torch.tanh((x @ C.param(p.wz)).float()).reshape(b, s, h, hd)
    g = (x @ C.param(p.wg)).float().reshape(b, s, h, 3)
    return z, _sigmoid(g[..., 0]), _sigmoid(g[..., 1]), _sigmoid(g[..., 2])


def slstm_apply(p: SLSTM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = C.copy_to_model(x, None)
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    y = ops.slstm_scan(*_slstm_gates(p, x, cfg)).reshape(b, s, h * hd).to(x.dtype)
    return C.reduce_from_model(y @ C.param(p.wo), None)


def slstm_init_state(cfg: ModelConfig, batch: int, layers: int, device) -> State:
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    return {"c": torch.zeros(layers, batch, h, hd, dtype=torch.float32, device=device),
            "n": torch.zeros(layers, batch, h, dtype=torch.float32, device=device)}


def slstm_decode(p: SLSTM, x: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """x: (B, 1, d) -> out (B, 1, d); c (B, h, hd) and n (B, h) are updated
    in place."""
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    z, i, f, o = (g[:, 0] for g in _slstm_gates(p, x, cfg))
    c.mul_(f[..., None]).add_(i[..., None] * z)
    n.mul_(f).add_(i)
    y = o[..., None] * c / torch.clamp(n[..., None], min=1.0)
    return y.reshape(b, 1, h * hd).to(x.dtype) @ C.param(p.wo)
