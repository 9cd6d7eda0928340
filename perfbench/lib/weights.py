"""Seeded weights, made on the device by the benchmark.

One ``torch.randn`` call a dtype draws every normal parameter of that dtype
at once (the few uniform ones, Mamba2's step biases and decay rates, are
drawn after it), from a ``torch.Generator`` on the device seeded with the run's
seed; each parameter is then its slice of the draw times its standard
deviation, computed in its own dtype.  The same seed gives the same
tensors, so the reference gets the program's weights by drawing them again.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

from perfbench.reference import common

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
WEIGHT_STREAM = 0x5EED


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of numbers of a run."""
    return torch.Generator(device=device).manual_seed((int(seed) * 0x10001 + stream) % (1 << 63))


def draw(specs: List[Tuple[str, Tuple[int, ...], str]], cfg: dict, seed: int,
         device) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) for every spec, in the spec's dtype."""
    g = generator(seed, WEIGHT_STREAM, device)
    by_dtype: Dict[str, List] = {}
    for name, shape, dt in specs:
        by_dtype.setdefault(dt, []).append((name, shape))
    for dt, leaves in by_dtype.items():
        dtype = DTYPES[dt]
        sizes = [torch.Size(s).numel() if common.init_kind(n, s, cfg)[0] == "normal" else 0
                 for n, s in leaves]
        flat = torch.randn(sum(sizes), generator=g, device=device, dtype=dtype)
        off = 0
        for (name, shape), size in zip(leaves, sizes):
            kind, std = common.init_kind(name, shape, cfg)
            if kind == "normal":
                yield name, flat[off:off + size].view(shape) * std
                off += size
            elif kind == "ones":
                yield name, torch.ones(shape, dtype=dtype, device=device)
            elif kind == "dt_bias":     # softplus(bias) log-uniform in [1e-3, 1e-1]
                u = torch.rand(shape, generator=g, device=device)
                dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
                yield name, (dt + torch.log(-torch.expm1(-dt))).to(dtype)
            elif kind == "a_log":       # the decay rate U(1, 16)
                u = torch.rand(shape, generator=g, device=device)
                yield name, torch.log(1 + 15 * u).to(dtype)
            else:
                yield name, torch.zeros(shape, dtype=dtype, device=device)
        del flat


@torch.no_grad()
def load_into(model: torch.nn.Module, specs, cfg: dict, seed: int) -> None:
    """Fills the program's parameters with the seeded weights; every
    parameter has to match a spec's name, shape and dtype."""
    params = dict(model.named_parameters())
    want = {n: (tuple(s), DTYPES[d]) for n, s, d in specs}
    have = {n: (tuple(p.shape), p.dtype) for n, p in params.items()}
    if want != have:
        missing = sorted(set(want) ^ set(have))[:5]
        differ = [n for n in want if n in have and want[n] != have[n]][:5]
        raise RuntimeError(f"the program's parameters are not the reference's: names "
                           f"{missing}, shapes or dtypes {differ}")
    device = next(iter(params.values())).device
    for name, t in draw(specs, cfg, seed, device):
        params[name].copy_(t)


def reference_params(specs, cfg: dict, seed: int, device,
                     requires_grad: bool = False) -> Dict[str, torch.Tensor]:
    """The same weights as float32 leaves for the reference."""
    out = {}
    for name, t in draw(specs, cfg, seed, device):
        out[name] = t.float().requires_grad_(requires_grad)
    return out
