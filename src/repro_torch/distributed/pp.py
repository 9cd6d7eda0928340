"""Pipeline parallelism: GPipe over a mesh axis with point-to-point sends
(the port of ``repro.distributed.pp``).

Layers are grouped into ``n_stages`` contiguous stages; stage s holds layers
[s*L/S, (s+1)*L/S).  Microbatches stream through: at step t, stage s
processes microbatch (t - s) -- the classic GPipe schedule with S-1 bubble
steps on each side.  Activations move stage->stage with ``isend`` /
``irecv`` between the stage ranks (the reference's ``ppermute`` inside
``shard_map``); a stage idles through its bubble steps rather than computing
on padding.

This maps the 'pod' axis of the production mesh to pipeline stages: a
2-pod mesh runs 2 stages with inter-pod hops only between layer blocks,
which is the standard multi-pod topology answer (TP inside a pod, PP across
pods).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .sharding import MeshContext


def _slice(tree, i):
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    return tree[i]


def _layers(tree) -> int:
    if isinstance(tree, dict):
        return _layers(next(iter(tree.values())))
    return tree.shape[0]


def gpipe_forward(layer_fn: Callable, stacked_params, x_microbatched: torch.Tensor,
                  mesh, stage_axis: str = "stage", n_microbatches: int = None) -> torch.Tensor:
    """Run ``layer_fn`` stack as a GPipe pipeline.

    layer_fn: (params_slice, h) -> h  (one layer)
    stacked_params: leading axis = total layers (divisible by #stages); a
        tensor or a dict of them, whole on every rank (each stage uses its
        own layers)
    x_microbatched: (n_mb, batch_per_mb, ...) activations, on every rank
    mesh: a ``DeviceMesh`` or ``MeshContext`` with axis ``stage_axis``
    Returns activations with the same shape as x_microbatched, on every
    rank (the last stage's, broadcast over the stage axis)."""
    mc = mesh if isinstance(mesh, MeshContext) else MeshContext(mesh)
    n_stages = mc.shape[stage_axis]
    n_layers = _layers(stacked_params)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} stages")
    per_stage = n_layers // n_stages
    n_mb = x_microbatched.shape[0] if n_microbatches is None else n_microbatches
    if x_microbatched.shape[0] != n_mb:
        raise ValueError(f"{x_microbatched.shape[0]} microbatches given, {n_mb} asked for")

    group = mc.group(stage_axis)
    ranks = dist.get_process_group_ranks(group)        # stage s -> global rank
    sid = mc.coords[stage_axis]

    def run_stage(h):
        for i in range(sid * per_stage, (sid + 1) * per_stage):
            h = layer_fn(_slice(stacked_params, i), h)
        return h

    outs = torch.zeros_like(x_microbatched)
    sends = []
    for t in range(n_mb + n_stages - 1):
        mb = t - sid                     # the microbatch this stage holds at step t
        if not 0 <= mb < n_mb:
            continue                     # a bubble step
        if sid == 0:
            h_in = x_microbatched[mb]
        else:
            h_in = torch.empty_like(x_microbatched[0])
            dist.irecv(h_in, ranks[sid - 1]).wait()
        h_out = run_stage(h_in)
        if sid == n_stages - 1:
            outs[mb] = h_out             # the last stage commits its finished microbatch
        else:
            h_out = h_out.contiguous()
            sends.append((dist.isend(h_out, ranks[sid + 1]), h_out))
    for work, _ in sends:
        work.wait()
    dist.broadcast(outs, ranks[-1], group=group)
    return outs
