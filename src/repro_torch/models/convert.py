"""Carry the JAX package's parameters into the port's ``Model``.

``from_jax_params`` takes the tree that ``repro.models.init_params`` returns,
as nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, p)``),
and copies each leaf into the port's module.  Layouts and names agree, so
the only reshaping is the split of the stacked ``blocks`` leaves along their
leading axis (layers; super-blocks of ``moe_every`` layers for the moe
family, whose ``blocks.l{j}`` sub-trees map to ``blocks.{i}.l{j}``).
zamba2's ``shared_attn`` is not stacked and maps as it is; ``jax_path``
gives the reference's path of a port name.  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from .model import Model, num_blocks


def _tensor(a) -> torch.Tensor:
    a = np.array(a)                       # a writable copy: JAX's buffers are read-only
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _copy(dst: torch.Tensor, src, name: str) -> None:
    t = _tensor(src)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != port's {tuple(dst.shape)}")
    dst.copy_(t.to(dst.dtype))


def jax_path(name: str) -> str:
    """The reference's ``/``-joined path of the port's parameter ``name``,
    its block index dropped: ``blocks.3.attn.wq`` -> ``blocks/attn/wq``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        del parts[1]
    return "/".join(parts)


def _leaves(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@torch.no_grad()
def from_jax_params(tree: Mapping, cfg: ModelConfig, device="cuda") -> Model:
    """The port's model holding the parameters of the JAX tree ``tree``."""
    model = Model(cfg, resolve_device(device))
    params = dict(model.named_parameters())
    seen = set()
    n = num_blocks(cfg)
    for name, arr in _leaves(tree):
        if name.startswith("blocks."):
            rest = name[len("blocks."):]
            arr = np.asarray(arr)
            if arr.shape[0] != n:
                raise ValueError(f"{name}: {arr.shape[0]} stacked blocks, config has {n}")
            for i in range(n):
                key = f"blocks.{i}.{rest}"
                if key not in params:
                    raise KeyError(f"JAX leaf {name} has no counterpart {key} in the port")
                _copy(params[key], arr[i], key)
                seen.add(key)
        else:
            if name not in params:
                raise KeyError(f"JAX leaf {name} has no counterpart in the port")
            _copy(params[name], arr, name)
            seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"port parameters not in the JAX tree: {missing}")
    return model
