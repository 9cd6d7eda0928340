"""Chunked selective scan (Mamba2 / SSD form) of the hybrid and ssm families.

Replaces the Pallas TPU kernel ``_ssm_kernel`` / ``ssm_scan`` of
``src/repro/kernels/ssm_scan.py`` (:28, :73) with the hand-written CUDA
kernels of ``csrc/ssm_scan.cu``.

* Bound on the H100: the products on the tensor cores at zamba2's and
  xlstm's shapes (C B^T, the chunk states, the intra-chunk output and the
  readout of the carried state), and the device traffic of the chunk states.
* Design: the TPU grid's sequential chunk axis becomes the SSD
  decomposition, four device kernels a call (one ``launches`` count): C B^T
  once per (batch, B/C group, chunk) in tiles on and below the diagonal (so
  once for all of zamba2's 32 heads), each chunk's N x P state, a pass over
  the chunk states (sequential only over the chunks, parallel over b * h *
  N * P), and the readout (parallel over (b * h, chunk, P tile)).  The
  products run as mma.sync TF32 with every f32 operand split into two TF32
  parts (three passes; two for the products with a bf16 x, which is exact
  in TF32), so the result keeps f32 accuracy; tiles stream through shared
  memory with cp.async, two stages deep.  ``autotune.pom_scan_schedule``
  picks the chunk length and the P tile.  The tail chunk is padded (a = 1,
  b = c = 0, x = 0), so any S runs (the TPU kernel asserts S % L == 0).  b
  and c may broadcast one group over the heads with a head stride of 0
  (zamba2), without copies.  x's dtype names the precision route
  (``autotune.SCAN_ROUTES``).

A CUDA tensor goes to the kernels (or the wrapper raises); a CPU tensor goes
to the plain version ``ref.ssm_scan``.

The gradient (``SsmScan``; no TPU counterpart: the reference lets XLA
differentiate its pure-jnp scan) is ``scan_backward``: three more runs of
the same forward kernels on time-reversed or role-swapped operands, and the
decay's gradient from their outputs by one small kernel,
``csrc/ssm_scan_bwd.cu`` (``ssm_scan_da``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from . import _build
from .autotune import SCAN_NAIVE, SCAN_TILES, pom_scan_schedule, scan_smem_bytes
from .ref import A_FLOOR
from .ref import ssm_scan as ssm_scan_plain
from .ref import ssm_scan_backward as ssm_scan_backward_plain
from .ref import ssm_scan_da as ssm_scan_da_plain
from repro_torch.core.cost_model import H100

# process-wide counts: forward calls through ``ssm_scan`` (four device kernels
# each); calls of the same kernels made by a backward pass (``scan_backward``
# on the card: up to three a gradient); calls of the decay-gradient kernels
# (two each)
launches = 0
launches_bwd = 0
launches_da = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = {}


def _kernel(name: str = "ssm_scan"):
    """The C entry point of the scan (``ssm_scan``) or of the decay-gradient
    kernel (``ssm_scan_bwd``)."""
    if name not in _FN:
        import ctypes
        p, i, strides = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
        if name == "ssm_scan":
            fn = _build.load(name).ssm_scan_launch
            fn.argtypes = [p, p, p, p, p, p, p, p, p, strides, i, i, i, i, i, i, i, i, i, p]
        else:
            fn = _build.load(name).ssm_scan_da_launch
            fn.argtypes = [p, p, p, p, p, p, p, strides, i, i, i, i, p]
        fn.restype = i
        _FN[name] = fn
    return _FN[name]


def bc_groups(b: torch.Tensor, c: torch.Tensor) -> int:
    """B/C groups a batch: 1 where b and c both broadcast one group over the
    heads (a head stride of 0, or one head), else the number of heads."""
    nh = b.shape[2]
    return 1 if nh == 1 or (b.stride(2) == 0 and c.stride(2) == 0) else nh


def pom_tile(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> dict:
    """The (chunk, P tile) ``autotune.pom_scan_schedule`` picks for these
    operands, as ``ssm_scan``'s keyword arguments."""
    bsz, s, nh, p = x.shape
    sc = pom_scan_schedule(s, p, b.shape[3], x.element_size(), bsz * nh,
                           bc_groups=bsz * bc_groups(b, c))
    return {"chunk": sc.chunk, "p_tile": sc.p_tile}


def ssm_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
             chunk: int = SCAN_NAIVE[0],
             p_tile: int = SCAN_NAIVE[1]) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, H, P), a: (B, S, H), b/c: (B, S, H, N) -> (y (B, S, H, P) in
    x's dtype, final h (B, H, N, P) f32), from h = 0."""
    global launches
    if x.device.type == "cpu":
        return ssm_scan_plain(x, a, b, c)
    out = _launch(x, a, b, c, chunk, p_tile)
    launches += 1
    return out


def _launch(x, a, b, c, chunk: int, p_tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of the four scan kernels on CUDA tensors (not counted)."""
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {x.device}")
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 4 or c.shape != b.shape \
            or a.shape != x.shape[:3] or b.shape[:3] != x.shape[:3]:
        raise ValueError(f"ssm_scan: bad shapes x{tuple(x.shape)} a{tuple(a.shape)} "
                         f"b{tuple(b.shape)} c{tuple(c.shape)}")
    bsz, s, nh, p = x.shape
    n = b.shape[3]
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssm_scan: x is {x.dtype}; need float32 or bfloat16")
    for name, t in (("a", a), ("b", b), ("c", c)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssm_scan: {name} is {t.dtype}; need float32")
        if t.device != x.device:
            raise ValueError(f"ssm_scan: {name} on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"ssm_scan: the last dim of {name} must be contiguous")
    if (chunk, p_tile) not in SCAN_TILES:
        raise ValueError(f"ssm_scan: (chunk {chunk}, P tile {p_tile}) not in {SCAN_TILES}")
    if scan_smem_bytes(chunk, p_tile) > H100.smem_bytes:
        raise ValueError(f"ssm_scan: chunk {chunk}, P tile {p_tile} exceed the shared memory "
                         "of one block")
    groups = bc_groups(b, c)
    nc = -(-s // chunk)
    y = torch.empty((bsz, s, nh, p), dtype=x.dtype, device=x.device)
    h = torch.empty((bsz, nh, n, p), dtype=torch.float32, device=x.device)
    gmat = torch.empty((bsz * groups * nc * chunk * chunk,), dtype=torch.float32,
                       device=x.device)
    states = torch.empty((bsz * nh * nc * n * p,), dtype=torch.float32, device=x.device)
    cums = torch.empty((bsz * nh * nc * chunk,), dtype=torch.float32, device=x.device)
    import ctypes
    strides = (ctypes.c_int64 * 12)(*[st for t in (x, a, b, c) for st in t.stride()[:3]])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
                   h.data_ptr(), gmat.data_ptr(), states.data_ptr(), cums.data_ptr(), strides,
                   bsz, nh, s, p, n, groups, chunk, p_tile, _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {rc}")
    return y, h


def ssm_scan_da(c: torch.Tensor, dc: torch.Tensor, b: torch.Tensor, db: torch.Tensor,
                a: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The decay's gradient (B, S, H) f32 from the gradients of the readout
    and the input projection (``ref.ssm_scan_da`` says what it computes).
    c, b: (B, S, H, N) f32, any batch, time and head strides (a head stride
    of 0 broadcasts one group), the last dim contiguous; dc, db: (B, S, H, N)
    f32, the same; a: (B, S, H) f32, any strides; bias: (B, H) f32 or None.

    Two kernels of ``csrc/ssm_scan_bwd.cu`` a call (one ``launches_da``):
    a warp a time step for the dots over N (16-byte loads where every row
    allows them), then a block a (batch, head) for the reverse cumulative
    sum in f64.  Bound on the H100: the bytes of c, dc, b and db."""
    global launches_da
    if c.device.type == "cpu":
        return ssm_scan_da_plain(c, dc, b, db, a, bias)
    if c.device.type != "cuda":
        raise ValueError(f"ssm_scan_da: unsupported device {c.device}")
    if c.dim() != 4 or a.dim() != 3 or a.shape != c.shape[:3] or \
            any(t.shape != c.shape for t in (dc, b, db)):
        raise ValueError(f"ssm_scan_da: bad shapes c{tuple(c.shape)} dc{tuple(dc.shape)} "
                         f"b{tuple(b.shape)} db{tuple(db.shape)} a{tuple(a.shape)}")
    bsz, s, nh, n = c.shape
    if bias is not None and (bias.shape != (bsz, nh) or not bias.is_contiguous()):
        raise ValueError(f"ssm_scan_da: bias{tuple(bias.shape)} must be a contiguous "
                         f"({bsz}, {nh})")
    named = (("c", c), ("dc", dc), ("b", b), ("db", db), ("a", a)) + \
        ((("bias", bias),) if bias is not None else ())
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"ssm_scan_da: {name} is {t.dtype}; need float32")
        if t.device != c.device:
            raise ValueError(f"ssm_scan_da: {name} on {t.device}, c on {c.device}")
        if name != "a" and t.dim() == 4 and n > 1 and t.stride(3) != 1:
            raise ValueError(f"ssm_scan_da: the last dim of {name} must be contiguous")
    da = torch.empty((bsz, s, nh), dtype=torch.float32, device=c.device)
    import ctypes
    strides = (ctypes.c_int64 * 15)(*[st for t in (c, dc, b, db, a) for st in t.stride()[:3]])
    stream = torch.cuda.current_stream(c.device).cuda_stream
    rc = _kernel("ssm_scan_bwd")(c.data_ptr(), dc.data_ptr(), b.data_ptr(), db.data_ptr(),
                                 a.data_ptr(), bias.data_ptr() if bias is not None else None,
                                 da.data_ptr(), strides, bsz, nh, s, n, stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan_da kernel launch failed: CUDA error {rc}")
    launches_da += 1
    return da


def _flip(t: torch.Tensor) -> torch.Tensor:
    """t reversed in time (dim 1), contiguous; a (B, S, H, N) tensor that
    broadcasts one group over the heads (head stride 0) stays such a view,
    so the reversed scan still computes C B^T once a group."""
    if t.dim() == 4 and t.shape[2] > 1 and t.stride(2) == 0:
        return t[:, :, :1].flip(1).expand(t.shape)
    return t.flip(1)


def scan_backward(scan: Callable, x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, dy: Optional[torch.Tensor],
                  dh_final: Optional[torch.Tensor] = None,
                  h_final: Optional[torch.Tensor] = None,
                  needs: Tuple[bool, bool, bool, bool] = (True, True, True, True)):
    """Gradients (dx, da, db, dc) of ``ssm_scan(x, a, b, c)`` for the output
    gradients ``dy`` (B, S, H, P; None: 0) and ``dh_final`` (B, H, N, P; None:
    0), each None where ``needs`` (x, a, b, c) does not ask for it.

    ``scan(x, a, b, c) -> (y, h)`` is a forward scan: the kernels on the card
    (``_bwd_scan``), ``ref.ssm_scan_chunked`` in a CPU test.  With
    ``flip`` reversing time and shift(a)_t = a_{t+1} (1 at the end), so that
    the reverse state lambda_t = c_t (x) dy_t + a_{t+1} lambda_{t+1} is a
    forward scan of the reversed sequence:

    * dx_t = b_t . lambda_t: flip(scan(flip dy, flip shift a, flip c,
      flip b).y), in x's dtype;
    * db_t = lambda_t x_t: flip(scan(flip c, flip shift a, flip dy,
      flip x).y), lambda transposed (the state's roles of N and P swap);
    * dc_t = h_t dy_t: scan(b, a, x, dy).y, h transposed;
    * da from the decay-gradient kernel ``ssm_scan_da``: d log a_t =
      sum_{u >= t} (c_u . dc_u - b_u . db_u) + <dh_final, h_final>, and
      da_t = d log a_t / a_t (0 where a_t < A_FLOOR, below which the forward
      does not depend on a_t).

    Proof of the identity for d log a.  With cum the inclusive cumsum of
    log a, y_u = sum_{s <= u} (c_u . b_s) e^{cum_u - cum_s} x_s and h_final =
    sum_s e^{cum_{S-1} - cum_s} b_s (x) x_s.  log a_t enters the pair (s, u)
    iff s < t <= u, so with L = <dy, y> + <dh_final, h_final>,
    d log a_t = sum_{u >= t} sum_{s < t} dy_u . (c_u . b_s) e^{..} x_s
    + sum_{s < t} e^{..} <dh_final, b_s (x) x_s>.  Split each s < t as all
    s <= u minus t <= s <= u: the first part sums to
    sum_{u >= t} dy_u . y_u + <dh_final, h_final>; the second, regrouped by
    s, is sum_{s >= t} x_s . dx_s, since dx_s = sum_{u >= s} (c_u . b_s)
    e^{cum_u - cum_s} dy_u + e^{cum_{S-1} - cum_s} b_s . dh_final.  So
    d log a_t = sum_{u >= t} (dy_u . y_u - x_u . dx_u) + <dh_final, h_final>.
    Both dots are traces of the state: dy_u . y_u = sum_{n,p} c_u[n] h_u[n,
    p] dy_u[p] = c_u . dc_u, and x_u . dx_u = sum_{n,p} b_u[n] lambda_u[n,
    p] x_u[p] = b_u . db_u.  The kernel takes the N-wide form: dc and db
    come out of their scans in f32 (y and dx of a bf16 x in bf16), and it
    needs no dx, which the mLSTM normaliser (x = 1) does not ask for.

    A non-zero dh_final adds e^{cum_{S-1} - cum_t} (b_t . dh_final) to dx_t
    and e^{cum_{S-1} - cum_t} dh_final x_t to db_t, in plain PyTorch (no
    model passes one); ``h_final`` is then the forward's final state (None:
    recomputed)."""
    need_x, need_a, need_b, need_c = needs
    if dy is None:
        dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    a_rev = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1).flip(1)
    tail = dh_final is not None
    if tail:
        cum = torch.cumsum(torch.log(torch.clamp(a.float(), min=A_FLOOR)), dim=1)
        decay = torch.exp(cum[:, -1:] - cum)[..., None]      # from step t + 1 to the end
        dhf = dh_final.float()
    dx = da = db = dc = None
    if need_x:
        dx = scan(_flip(dy.float() if tail else dy), a_rev, _flip(c), _flip(b))[0].flip(1)
        if tail:
            dx = dx + decay * torch.einsum("bshn,bhnp->bshp", b.float(), dhf)
        dx = dx.to(x.dtype)
    if need_a or need_b or need_c:
        dyf, xf = dy.float().contiguous(), x.float().contiguous()
    if need_a or need_b:
        db = scan(_flip(c), a_rev, _flip(dyf), _flip(xf))[0].flip(1)
        if tail:
            db = db + decay * torch.einsum("bhnp,bshp->bshn", dhf, xf)
    if need_a or need_c:
        dc = scan(b, a, xf, dyf)[0]
    if need_a:
        bias = None
        if tail:
            if h_final is None:
                h_final = scan(x, a, b, c)[1]
            bias = (dhf * h_final.float()).sum((-1, -2)).contiguous()
        da = ssm_scan_da(c, dc, b, db, a, bias)
    return dx, da, db if need_b else None, dc if need_c else None


def _bwd_scan(x, a, b, c) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels as ``scan_backward`` runs them on the card, with
    the schedule ``pom_scan_schedule`` picks for each operand shape (counted
    in ``launches_bwd``)."""
    global launches_bwd
    out = _launch(x, a, b, c, **pom_tile(x, b, c))
    launches_bwd += 1
    return out


class SsmScan(torch.autograd.Function):
    """The scan with its gradient: the forward kernels, and ``scan_backward``
    on the saved x, a, b, c and final h (on a CPU tensor ``ref.ssm_scan`` and
    ``ref.ssm_scan_backward``).  ``SsmScan.apply(x, a, b, c, tile)`` returns
    (y, h) as ``ssm_scan(x, a, b, c, **tile)`` does (``tile``: ``pom_tile``'s,
    or {} for the fixed chunk and P tile)."""

    @staticmethod
    def forward(ctx, x, a, b, c, tile):
        y, h = ssm_scan(x, a, b, c, **tile)
        ctx.save_for_backward(x, a, b, c, h)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, a, b, c, h = ctx.saved_tensors
        needs = tuple(ctx.needs_input_grad[:4])
        if x.device.type == "cpu":
            if dy is None:
                dy = torch.zeros_like(x)
            grads = tuple(g if need else None for g, need in
                          zip(ssm_scan_backward_plain(x, a, b, c, dy, dh), needs))
        else:
            grads = scan_backward(_bwd_scan, x, a, b, c, dy, dh, h, needs=needs)
        return (*grads, None)
