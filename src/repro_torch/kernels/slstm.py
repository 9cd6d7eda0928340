"""The sLSTM recurrence of the xLSTM family (``models/xlstm.py``).

No TPU counterpart: the reference runs the recurrence as a ``jax.lax.scan``
(``src/repro/models/xlstm.py:132-146``), which its jitted train, prefill
and serve steps compile into one loop on the device.  Here it is the
hand-written CUDA kernels of ``csrc/slstm.cu``, one counted call a forward
and one a backward:

    c_t = f_t c_{t-1} + i_t z_t,  n_t = f_t n_{t-1} + i_t,
    y_t = o_t c_t / max(n_t, 1),  from c = 0, n = 0.

* Bound on the H100: bytes (z read and y written; c and n written too where
  a gradient is asked for; the backward reads z, c and dy and writes dz).
  Only the multiply and add of c and n (of dC and dN) depend on the step
  before.
* Design: each direction is an exact carry pass, sequential in t and
  parallel over the B*H*hd lanes only (32 lanes a block, their inputs
  streamed into a shared-memory ring by ``cp.async``), beside passes
  parallel over (b, t, h) or (b, t, h, lane).  The forward: the carry pass
  writes c and n (the saved buffers, or scratch from the caching
  allocator), then the readout writes y; the operations are the plain
  loop's, in its order, so y is bit-equal to ``ref.slstm_scan``.  The
  backward: the chain pass runs dC in reverse t in one warp while helper
  warps divide dy o / m ahead of it, write dz and sum each step's products
  over the block's lanes; a rows pass adds the blocks' sums and writes do
  and dN's direct term; a dN pass runs the scalar chain a (batch, head) and
  writes di and df.  Sums in a fixed order with no atomics, so the bits
  repeat.  Above the bound: c and n written and read back (the forward),
  the sums' scratch (the backward).

A CUDA tensor goes to the kernels (or the wrapper raises); a CPU tensor
goes to the plain versions ``ref.slstm_scan`` and
``ref.slstm_scan_backward``; a ``meta`` tensor to a shape-only branch that
counts the kernels' work (``meta.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from . import meta as _meta
from .ref import slstm_scan as slstm_scan_plain
from .ref import slstm_scan_backward as slstm_scan_backward_plain

# process-wide counts of calls on the card: forward calls (``slstm_scan``,
# ``SlstmScan``; two kernels each) and backward calls (``scan_backward``; up
# to three kernels each)
launches = 0
launches_bwd = 0

MAX_LANES = 512        # hd: the row passes hold a row in a warp, 16 lanes a thread (csrc/slstm.cu)

_FN = {}


def _kernel(entry: str):
    """A C entry point of ``csrc/slstm.cu``: ``slstm_fwd_launch``,
    ``slstm_bwd_launch`` or ``slstm_bwd_scratch_floats``."""
    if entry not in _FN:
        import ctypes
        p, i, strides = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
        fn = getattr(_build.load("slstm"), entry)
        fn.restype = i
        if entry == "slstm_fwd_launch":      # z, i, f, o; strides; y, c, n
            fn.argtypes = [p] * 4 + [strides] + [p] * 3 + [i] * 4 + [p]
        elif entry == "slstm_bwd_launch":    # z, i, f, o, dy, c, n; strides; dz, di, df, do,
            fn.argtypes = [p] * 7 + [strides] + [p] * 5 + [i] * 4 + [p]     # scratch
        else:                                # B, S, H, hd
            fn.argtypes = [i] * 4
            fn.restype = ctypes.c_int64
        _FN[entry] = fn
    return _FN[entry]


def _check(z, i, f, o, what: str) -> None:
    """Raises on what the kernels do not take."""
    if z.dim() != 4 or any(g.shape != z.shape[:3] for g in (i, f, o)) or 0 in z.shape:
        raise ValueError(f"{what}: bad shapes z{tuple(z.shape)} i{tuple(i.shape)} "
                         f"f{tuple(f.shape)} o{tuple(o.shape)}")
    if z.shape[3] > MAX_LANES:
        raise ValueError(f"{what}: head width {z.shape[3]} > {MAX_LANES}")
    for name, t in (("z", z), ("i", i), ("f", f), ("o", o)):
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}; need float32")
        if t.device != z.device:
            raise ValueError(f"{what}: {name} on {t.device}, z on {z.device}")
    if z.shape[3] > 1 and z.stride(3) != 1:
        raise ValueError(f"{what}: the last dim of z must be contiguous")
    if z.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {z.device}")


def _strides(*ts):
    import ctypes
    return (ctypes.c_int64 * (3 * len(ts)))(*[st for t in ts for st in t.stride()[:3]])


def slstm_scan(z: torch.Tensor, i: torch.Tensor, f: torch.Tensor,
               o: torch.Tensor) -> torch.Tensor:
    """z: (B, S, H, hd), i/f/o: (B, S, H), all f32 -> y (B, S, H, hd) f32, from
    c = n = 0."""
    return _forward(z, i, f, o, save=False)[0]


def _forward(z, i, f, o, save: bool):
    """(y, the saved (c, n) or None) of one counted forward call (a CPU
    tensor: the plain version's y and None)."""
    global launches
    if z.device.type == "cpu":
        return slstm_scan_plain(z, i, f, o), None
    if z.device.type == "meta":
        _meta.add("slstm_scan", *_meta.slstm_scan(z, save))
        return torch.empty(z.shape, dtype=z.dtype, device="meta"), None
    _check(z, i, f, o, "slstm_scan")
    bsz, s, nh, hd = z.shape
    y = torch.empty((bsz, s, nh, hd), dtype=torch.float32, device=z.device)
    c = torch.empty_like(y)                  # the saved states, or the carry pass's scratch
    n = torch.empty((bsz, s, nh), dtype=torch.float32, device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    rc = _kernel("slstm_fwd_launch")(
        z.data_ptr(), i.data_ptr(), f.data_ptr(), o.data_ptr(), _strides(z, i, f, o),
        y.data_ptr(), c.data_ptr(), n.data_ptr(), bsz, s, nh, hd, stream)
    if rc != 0:
        raise RuntimeError(f"slstm forward kernel launch failed: CUDA error {rc}")
    launches += 1
    return y, ((c, n) if save else None)


def scan_backward(z: torch.Tensor, i: torch.Tensor, f: torch.Tensor, o: torch.Tensor,
                  dy: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                  needs: Tuple[bool, bool, bool, bool] = (True, True, True, True)
                  ) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients (dz, di, df, do) of ``slstm_scan(z, i, f, o)`` for the output
    gradient ``dy`` (B, S, H, hd) f32, each None where ``needs`` (z, i, f, o)
    does not ask for it, from the forward's saved c (B, S, H, hd) and n (B, S,
    H), contiguous f32.  CUDA tensors only (``SlstmScan.backward`` takes the
    plain version on the CPU): one call of the backward kernels (one
    ``launches_bwd``).  A dy whose last dim is not contiguous is copied.
    Where di, df or do is asked for, the lane sums go through a scratch
    tensor (``slstm_bwd_scratch_floats``: 3 (ceil(hd / 32) + 1) B*S*H
    floats)."""
    global launches_bwd
    _check(z, i, f, o, "slstm scan_backward")
    if dy.shape != z.shape or dy.dtype != torch.float32 or dy.device != z.device:
        raise ValueError(f"slstm scan_backward: dy {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device}; need z's {tuple(z.shape)} float32 on {z.device}")
    bsz, s, nh, hd = z.shape
    if c.shape != z.shape or n.shape != z.shape[:3] or not (c.is_contiguous()
                                                           and n.is_contiguous()):
        raise ValueError("slstm scan_backward: c and n must be the forward's saved states")
    if hd > 1 and dy.stride(3) != 1:
        dy = dy.contiguous()
    dz = torch.empty_like(c) if needs[0] else None
    di, df, do = (torch.empty_like(n) if need else None for need in needs[1:])
    scratch = None
    if any(needs[1:]):
        scratch = torch.empty(_kernel("slstm_bwd_scratch_floats")(bsz, s, nh, hd),
                              dtype=torch.float32, device=z.device)

    def ptr(t):
        return t.data_ptr() if t is not None else None
    stream = torch.cuda.current_stream(z.device).cuda_stream
    rc = _kernel("slstm_bwd_launch")(
        z.data_ptr(), i.data_ptr(), f.data_ptr(), o.data_ptr(), dy.data_ptr(), c.data_ptr(),
        n.data_ptr(), _strides(z, i, f, o, dy), ptr(dz), ptr(di), ptr(df), ptr(do),
        ptr(scratch), bsz, s, nh, hd, stream)
    if rc != 0:
        raise RuntimeError(f"slstm backward kernel launch failed: CUDA error {rc}")
    launches_bwd += 1
    return dz, di, df, do


class SlstmScan(torch.autograd.Function):
    """The recurrence with its gradient: the forward kernels, whose c and n
    are kept where a gradient is asked for, and the backward kernels on
    them (on a CPU tensor ``ref.slstm_scan`` and ``ref.slstm_scan_backward``).
    ``SlstmScan.apply(z, i, f, o)`` returns y as ``slstm_scan`` does."""

    @staticmethod
    def forward(ctx, z, i, f, o):
        y, saved = _forward(z, i, f, o, save=any(ctx.needs_input_grad))
        ctx.save_for_backward(z, i, f, o, *(saved or ()))
        return y

    @staticmethod
    def backward(ctx, dy):
        z, i, f, o, *saved = ctx.saved_tensors
        needs = tuple(ctx.needs_input_grad)
        if z.device.type == "cpu":
            return tuple(g if need else None for g, need in
                         zip(slstm_scan_backward_plain(z, i, f, o, dy), needs))
        if z.device.type == "meta":
            _meta.add("slstm_scan_bwd", *_meta.slstm_scan_backward(z))
            return tuple(torch.empty(t.shape, dtype=t.dtype, device="meta") if need else None
                         for t, need in zip((z, i, f, o), needs))
        return scan_backward(z, i, f, o, dy, *saved, needs=needs)
