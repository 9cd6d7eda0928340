"""AdamW with global-norm clipping and configurable state dtypes (the port
of ``repro.optim.adamw``).

State dtype matters at scale: ``state_dtype='bfloat16'`` halves the first
moment's 4 bytes a parameter; the second moment keeps f32 unless
``second_dtype`` says otherwise.  Parameters, gradients and both moments are
dicts keyed by the module's ``named_parameters()`` names.  The update runs
in f32 as the reference's does and casts back to each tensor's dtype; unlike
the reference (whose arrays are immutable) it writes the new parameters and
moments into the existing tensors, so a step allocates no second copy of
either.  ``step``, ``grad_norm`` and the learning rate stay 0-d device
tensors: nothing here waits for the device.

Sharded (``distributed/step.py``): the tensors are this rank's shards, and
the squared norm of each gradient is summed over the mesh axes it is
sharded on (``reduce``), and only those, before the global norm is taken;
the update itself is elementwise on the shards.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.layers import dtype_of

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor       # 0-d int32: updates applied so far
    m: Tree
    v: Tree


def adamw_init(params: Mapping[str, torch.Tensor], state_dtype: str = "float32",
               second_dtype: Optional[str] = None) -> AdamWState:
    dt1 = dtype_of(state_dtype)
    dt2 = dtype_of(second_dtype or "float32")
    m = {n: torch.zeros(p.shape, dtype=dt1, device=p.device) for n, p in params.items()}
    v = {n: torch.zeros(p.shape, dtype=dt2, device=p.device) for n, p in params.items()}
    device = next(iter(params.values())).device if params else "cpu"
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device), m, v)


Reduce = Callable[[Tree], Tree]


@torch.no_grad()
def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float,
                        reduce: Optional[Reduce] = None) -> Tuple[Tree, torch.Tensor]:
    """(grads scaled so that their global f32 norm is at most ``max_norm``,
    each in its own dtype; the norm before clipping, 0-d f32).  ``reduce``
    maps each gradient's local squared norm to its global one (shards)."""
    sq = {n: torch.sum(torch.square(g.float())) for n, g in grads.items()}
    if reduce is not None:
        sq = reduce(sq)
    gn = torch.sqrt(sum(sq.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: AdamWState,
                 params: Mapping[str, torch.Tensor], *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 max_grad_norm: float = 1.0, reduce: Optional[Reduce] = None
                 ) -> Tuple[Mapping[str, torch.Tensor], AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step on ``params`` (updated in place, and returned), with
    the moments of ``state`` updated in place.  Returns (params, the new
    state, {"grad_norm": the norm before clipping}).  ``reduce``: as
    ``clip_by_global_norm``'s."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm, reduce)
    step = state.step + 1
    b1c = 1.0 - b1 ** step.float()
    b2c = 1.0 - b2 ** step.float()
    for name, p in params.items():
        m, v = state.m[name], state.v[name]
        gf = grads[name].float()
        mn = b1 * m.float() + (1 - b1) * gf
        vn = b2 * v.float() + (1 - b2) * gf * gf
        mh = mn / b1c
        vh = vn / b2c
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(mn.to(m.dtype))
        v.copy_(vn.to(v.dtype))
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm}
