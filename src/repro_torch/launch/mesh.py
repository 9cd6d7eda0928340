"""Mesh construction (the port of ``repro.launch.mesh``).

Functions, not module constants: importing this module touches no process
group and no device.  ``make_mesh`` sets up the default process group on
first use: from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``) when it is set, else a
one-rank group on localhost.  The backend follows the device: NCCL on
``cuda`` (the default), gloo on ``cpu``; a group set up with the other
backend is refused, never used instead.
"""
from __future__ import annotations

import math
import os
import socket
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch import resolve_device

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _init_process_group(device="cuda") -> int:
    """Sets up the default process group for ``device`` unless one exists;
    returns the world size.  Raises ``RuntimeError`` when the existing group
    runs another backend than ``device`` needs."""
    dev = resolve_device(device)
    want = _backend(dev)
    if dist.is_initialized():
        if dist.get_backend() != want:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, a mesh on "
                               f"{dev.type} needs {want}")
        return dist.get_world_size()
    if all(k in os.environ for k in _ENV):
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(want)
    else:
        dist.init_process_group(want, init_method=f"tcp://localhost:{_free_port()}",
                                rank=0, world_size=1)
    return dist.get_world_size()


def _world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over every
    rank of the world (ranks laid out row-major, the last axis fastest)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    if _world_size() != n:
        raise RuntimeError(f"mesh {shape} needs {n} devices, found {_world_size()} -- run "
                           f"under torchrun with --nproc-per-node {n}")
    dev = resolve_device(device)
    _init_process_group(dev)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16x16 = 256 chips per pod; 2 pods = 512 chips with the 'pod' axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if _world_size() < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, found {_world_size()} -- run under "
            f"torchrun with {n} processes")
    return make_mesh(shape, axes, device)
