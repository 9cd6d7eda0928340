"""Gradient compression: blockwise int8 quantization with error feedback
(the port of ``repro.distributed.compression``; plain PyTorch, as the
reference's is jnp outside any Pallas kernel).

The DP gradient sync is the collective-bound term of data-parallel training;
int8 halves->quarters the bytes on the wire vs bf16/f32 all-reduce.  Error
feedback (Seide et al. / EF-SGD) keeps the quantization residual locally and
re-injects it next step, preserving convergence.

``compressed_psum`` runs on each rank of a process group (the reference's
runs inside ``shard_map`` over the data axes): each rank quantizes its
local gradient, all-gathers the int8 payload + f32 block scales, and
dequantize-sums locally.  Wire bytes ~= N * (1 + 4/block) per hop vs 4N for
f32 ring all-reduce.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist

BLOCK = 256


def quantize_int8(x: torch.Tensor, block: int = BLOCK):
    """Blockwise symmetric int8.  Returns (q int8 (nb, block), scale f32 (nb,),
    original size)."""
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    blocks = torch.nn.functional.pad(flat, (0, (-n) % block)).reshape(-1, block)
    scale = blocks.abs().amax(dim=1) / 127.0
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127).to(torch.int8)
    return q, scale, n


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, n: int, shape) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)[:n]
    return flat.reshape(shape)


def ef_quantize(g: torch.Tensor, residual: torch.Tensor, block: int = BLOCK):
    """Error-feedback quantization: q = Q(g + r); r' = (g + r) - deq(q)."""
    target = g.float() + residual
    q, scale, n = quantize_int8(target, block)
    deq = dequantize_int8(q, scale, n, g.shape)
    return q, scale, target - deq


def compressed_psum(g: torch.Tensor, residual: torch.Tensor, group=None,
                    block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """On every rank of ``group``: EF-quantize, all-gather the int8 payload
    and the scales, dequantize and sum.  Returns (summed gradient f32, new
    residual)."""
    q, scale, r_new = ef_quantize(g, residual, block)
    world = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(world)]
    ss = [torch.empty_like(scale) for _ in range(world)]
    dist.all_gather(qs, q.contiguous(), group=group)
    dist.all_gather(ss, scale.contiguous(), group=group)
    # (world, nb, block): dequantize and sum over the ranks
    deq = torch.stack(qs).float() * torch.stack(ss)[..., None]
    total = deq.sum(dim=0).reshape(-1)[: g.numel()]
    return total.reshape(g.shape), r_new


def init_ef_state(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}
