"""Public wrappers over the port's kernels (the ``ops.py`` contract).

Every op but ``jacobi2d`` (which takes no ``schedule=``, as in the JAX
package; its sweeps a launch come from ``autotune.pom_jacobi_schedule``) and
``slstm_scan`` (the reference's ``lax.scan`` has no blocks to search)
takes ``schedule='pom' | 'naive'`` (POM-DSE block sizes from ``autotune``
vs fixed defaults).  There is no ``impl`` and no ``interpret``:
the device of the tensors decides.  A CUDA tensor goes to the hand-written
kernel, a CPU tensor to its plain PyTorch version.  ``grouped_matmul`` and
``attention`` have two kernels each, ``matmul`` three; the pure functions
``autotune.matmul_route`` / ``gmm_route`` / ``attention_route`` pick one
from the shape, the dtype and whether every operand is 16-byte aligned (the
tensor cores for bf16 that TMA can describe, the f32 ring for f32 matmuls
its 16-byte copies can stage, the CUDA cores otherwise), and the schedule,
given the same flag, then picks a tile of that route.

Every op passes ``.contiguous()`` of its operands to the kernel wrappers
(a copy only for a non-contiguous view, e.g. ``matmul(x.t(), y)``), since
the kernels take row-major contiguous tensors; the wrappers themselves
still raise on a non-contiguous tensor, and on a tensor-core tile for an
operand TMA cannot describe.  ``decode_attention`` copies an operand that is
not 16-byte aligned (its kernel loads 16 bytes a lane; the models' caches
always are).  So an op computes every input its plain
version computes.  Inside ``plain_versions()`` every op takes the plain
version on any device: that is how a model is run on the card as the
reference its kernels are held to.
"""
from __future__ import annotations

import contextlib

import torch

from . import ref
from .autotune import pom_attention_schedule, pom_decode_schedule, pom_matmul_schedule
from .decode_attention import decode_attention as _decode_cuda
from .flash_attention import FlashAttention
from .flash_attention import flash_attention as _flash_cuda
from .grouped_matmul import GroupedMatmul
from .grouped_matmul import grouped_matmul as _gmm_cuda
from .grouped_matmul import pom_tile as _gmm_tile
from .matmul_pom import matmul as _matmul_cuda
from .slstm import SlstmScan
from .slstm import slstm_scan as _slstm_cuda
from .ssm_scan import SsmScan
from .ssm_scan import pom_tile as _scan_tile
from .ssm_scan import ssm_scan as _scan_cuda
from .stencil import jacobi2d as _jacobi_cuda

_plain = False


@contextlib.contextmanager
def plain_versions():
    """Within the block (process-wide), every op computes with its kernel's
    plain PyTorch version, whatever the device; kernels do not launch."""
    global _plain
    before, _plain = _plain, True
    try:
        yield
    finally:
        _plain = before


def _check(schedule: str) -> None:
    if schedule not in ("pom", "naive"):
        raise ValueError(f"schedule must be 'pom' or 'naive', got {schedule!r}")


def _under_grad(*ts) -> bool:
    """Autograd records this call: grad mode is on and an operand requires a
    gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _aligned(*ts) -> bool:
    """Every tensor's data starts on a 16-byte boundary (what TMA needs)."""
    return all(t.data_ptr() % 16 == 0 for t in ts)


def matmul(x, y, *, schedule: str = "pom"):
    """x: (M, K) @ y: (K, N) -> (M, N) in x's dtype, f32 sums."""
    _check(schedule)
    if _plain:
        return ref.matmul(x, y)
    x, y = x.contiguous(), y.contiguous()
    if schedule == "naive":
        return _matmul_cuda(x, y)          # the fixed tile of the route
    s = pom_matmul_schedule(x.shape[0], y.shape[1], x.shape[1], x.element_size(),
                            aligned=_aligned(x, y))
    return _matmul_cuda(x, y, bm=s.bm, bn=s.bn, bk=s.bk, route=s.route)


def jacobi2d(x, steps: int = 1):
    """``steps`` Jacobi-2D sweeps of x (M, N), the boundary passing through."""
    if _plain:
        return ref.jacobi2d(x, steps)
    return _jacobi_cuda(x.contiguous(), steps)


def attention(q, k, v, *, causal: bool = True, schedule: str = "pom"):
    """q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D).

    Where autograd needs a gradient (grad mode on and q, k or v requiring
    one) the call goes through ``FlashAttention``: the same forward kernel,
    which then also writes each row's log-sum-exp, and the backward kernel.
    Inside ``plain_versions()`` it is ``ref.attention``, which autograd
    differentiates."""
    _check(schedule)
    if _plain:
        return ref.attention(q, k, v, causal=causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bq = bkv = None                        # naive: the fixed tile of the route
    if schedule == "pom":
        s = pom_attention_schedule(q.shape[2], k.shape[2], q.shape[3], q.element_size(),
                                   causal, aligned=_aligned(q, k, v))
        bq, bkv = s.bq, s.bkv
    if _under_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, None, bq, bkv)
    return _flash_cuda(q, k, v, causal=causal, bq=bq, bkv=bkv)


def decode_attention(q, k, v, *, length=None, schedule: str = "pom", return_lse: bool = False):
    """q: (B, Hq, D), k/v: (B, Hkv, S, D), length: (B,) int32 -> (B, Hq, D);
    with ``return_lse`` also each row's log-sum-exp (B, Hq) f32 (-inf for a
    row with no valid key)."""
    _check(schedule)
    if _plain:
        return ref.decode_attention(q, k, v, length=length, return_lse=return_lse)
    q, k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    (b, hq, d), (hkv, s) = q.shape, k.shape[1:3]
    splits = 1
    if schedule == "pom":
        splits = pom_decode_schedule(b * hkv, s, hq // hkv, d, q.element_size()).splits
    return _decode_cuda(q, k, v, length=length, splits=splits, return_lse=return_lse)


def grouped_matmul(x, w, rows=None, *, schedule: str = "pom"):
    """x: (E, cap, d) @ w: (E, d, f) -> (E, cap, f) in x's dtype; with
    ``rows`` (E,) int32, each expert's filled rows, the rows of out[e] at or
    past rows[e] are zeros and the kernels skip their products.

    Where autograd needs a gradient the call goes through ``GroupedMatmul``
    (the same forward kernel, and the backward's dX and dW on it too, dense)."""
    _check(schedule)
    if _plain:
        return ref.grouped_matmul(x, w, rows)
    x, w = x.contiguous(), w.contiguous()
    rows = None if rows is None else rows.contiguous()
    tile = {} if schedule == "naive" else _gmm_tile(x, w)   # naive: the route's fixed tile
    if _under_grad(x, w):
        return GroupedMatmul.apply(x, w, tile, rows)
    return _gmm_cuda(x, w, rows, **tile)


def ssm_scan(x, a, b, c, *, schedule: str = "pom"):
    """x: (B, S, H, P), a: (B, S, H), b/c: (B, S, H, N) -> (y (B, S, H, P) in
    x's dtype, final h (B, H, N, P) f32), from h = 0.

    Where autograd needs a gradient the call goes through ``SsmScan`` (the
    same forward kernels; the backward runs them again, with the schedule
    of each operand shape, and the decay-gradient kernel)."""
    _check(schedule)
    if _plain:
        return ref.ssm_scan(x, a, b, c)
    tile = _scan_tile(x, b, c) if schedule == "pom" else {}   # naive: the fixed chunk, P tile
    if _under_grad(x, a, b, c):
        return SsmScan.apply(x, a, b, c, tile)
    return _scan_cuda(x, a, b, c, **tile)


def slstm_scan(z, i, f, o):
    """The sLSTM recurrence: z (B, S, H, hd), the gates i, f, o (B, S, H), f32
    -> y (B, S, H, hd) f32, from c = n = 0 (``ref.slstm_scan``).

    Where autograd needs a gradient the call goes through ``SlstmScan`` (the
    same forward kernel, which then also saves c and n, and the reverse-time
    backward kernel on them).  Inside ``plain_versions()`` it is the plain
    loop, which autograd differentiates."""
    if _plain:
        return ref.slstm_scan(z, i, f, o)
    if _under_grad(z, i, f, o):
        return SlstmScan.apply(z, i, f, o)
    return _slstm_cuda(z, i, f, o)
