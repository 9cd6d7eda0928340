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
to the plain version ``ref.ssm_scan``; a ``meta`` tensor to a shape-only
branch that counts the kernels' work (``meta.py``).

The gradient (``SsmScan``; no TPU counterpart: the reference lets XLA
differentiate its pure-jnp scan) is ``scan_backward``: one chunked reverse
pass of ``csrc/ssm_scan_bwd.cu`` on the forward's saved G = C B^T, chunk
states and cum (the reverse chunk states, a pass over the chunks, D = dY
X^T once per (head, chunk), dX, and dB with dC in one kernel whose epilogue
forms the decay gradient's per-step dots), and the decay gradient's f64
reverse sum (``da_sum``).  Its plain mirror is
``ref.ssm_scan_backward_chunked``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from . import meta as _meta
from .autotune import SCAN_NAIVE, SCAN_TILES, pom_scan_schedule, scan_smem_bytes
from .ref import ssm_scan as ssm_scan_plain
from .ref import ssm_scan_backward as ssm_scan_backward_plain
from .ref import ssm_scan_da_sum as ssm_scan_da_sum_plain
from repro_torch.core.cost_model import H100

# process-wide counts: forward calls through ``ssm_scan`` (four device kernels
# each); backward calls on the card (``scan_backward``: up to five kernels
# each); calls of the decay gradient's sum kernel (``da_sum``)
launches = 0
launches_bwd = 0
launches_da = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = {}


class Saved(NamedTuple):
    """What a forward call on the card leaves for the backward: the final h,
    G = C B^T (the tiles on and below the diagonal), the chunk states (h_c,
    the state entering chunk c, for c >= 1), each chunk's cum, and the chunk
    length."""
    h: torch.Tensor
    gmat: torch.Tensor
    states: torch.Tensor
    cums: torch.Tensor
    chunk: int


def _kernel(entry: str = "ssm_scan_launch"):
    """A C entry point: the forward (``ssm_scan_launch`` in
    ``csrc/ssm_scan.cu``), the backward (``ssm_scan_bwd_launch``), the part
    counts of its decay gradient (``ssm_scan_bwd_parts``) or the decay
    gradient's sum (``ssm_scan_da_launch``, all three ``csrc/ssm_scan_bwd.cu``)."""
    if entry not in _FN:
        import ctypes
        p, i, strides = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
        if entry == "ssm_scan_launch":
            fn = _build.load("ssm_scan").ssm_scan_launch
            fn.argtypes = [p] * 9 + [strides] + [i] * 9 + [p]
        elif entry == "ssm_scan_bwd_launch":
            fn = _build.load("ssm_scan_bwd").ssm_scan_bwd_launch
            fn.argtypes = [p] * 17 + [strides] + [i] * 8 + [p]
        elif entry == "ssm_scan_bwd_parts":
            fn = _build.load("ssm_scan_bwd").ssm_scan_bwd_parts
            fn.argtypes = [i] * 3 + [ctypes.POINTER(i)] * 2
        else:
            fn = _build.load("ssm_scan_bwd").ssm_scan_da_launch
            fn.argtypes = [p] * 4 + [strides] + [i] * 5 + [p]
        fn.restype = i
        _FN[entry] = fn
    return _FN[entry]


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
    return _forward(x, a, b, c, chunk, p_tile)[:2]


def _forward(x, a, b, c, chunk: int, p_tile: int):
    """(y, h, Saved) of one counted forward call (a CPU tensor: the plain
    version's y and h, and None)."""
    global launches
    if x.device.type == "cpu":
        return (*ssm_scan_plain(x, a, b, c), None)
    if x.device.type == "meta":
        _meta.add("ssm_scan", *_meta.ssm_scan(x, b, bc_groups(b, c)))
        bsz, _, nh, p = x.shape
        return torch.empty_like(x), x.new_empty((bsz, nh, b.shape[3], p),
                                                dtype=torch.float32), None
    out = _launch(x, a, b, c, chunk, p_tile)
    launches += 1
    return out


def _check(x, a, b, c, what: str) -> None:
    """Raises on what the scan kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 4 or c.shape != b.shape \
            or a.shape != x.shape[:3] or b.shape[:3] != x.shape[:3]:
        raise ValueError(f"{what}: bad shapes x{tuple(x.shape)} a{tuple(a.shape)} "
                         f"b{tuple(b.shape)} c{tuple(c.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: x is {x.dtype}; need float32 or bfloat16")
    for name, t in (("a", a), ("b", b), ("c", c)):
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}; need float32")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"{what}: the last dim of {name} must be contiguous")


def _launch(x, a, b, c, chunk: int, p_tile: int):
    """One call of the four scan kernels on CUDA tensors (not counted):
    (y, h, Saved)."""
    _check(x, a, b, c, "ssm_scan")
    bsz, s, nh, p = x.shape
    n = b.shape[3]
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
    return y, h, Saved(h, gmat, states, cums, chunk)


def bwd_parts(n: int, p: int, chunk: int) -> Tuple[int, int]:
    """The decay gradient's parts the backward kernels write at (N, P,
    chunk), as ``csrc/ssm_scan_bwd.cu`` reports them: a step (one a dB/dC N
    tile) and a (batch, head) (one a block of the reverse pass)."""
    import ctypes
    kg, kb = ctypes.c_int(), ctypes.c_int()
    rc = _kernel("ssm_scan_bwd_parts")(n, p, chunk, ctypes.byref(kg), ctypes.byref(kb))
    if rc != 0:
        raise ValueError(f"scan_backward: chunk {chunk} is not one the backward takes")
    return kg.value, kb.value


def scan_backward(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  dy: Optional[torch.Tensor], dh_final: Optional[torch.Tensor], saved: Saved,
                  needs: Tuple[bool, bool, bool, bool] = (True, True, True, True)):
    """Gradients (dx, da, db, dc) of ``ssm_scan(x, a, b, c)`` for the output
    gradients ``dy`` (B, S, H, P) in x's dtype (None: 0) and ``dh_final`` (B,
    H, N, P; None: 0), each None where ``needs`` (x, a, b, c) does not ask
    for it: dx in x's dtype, da (B, S, H), db and dc (B, S, H, N) in f32 (for
    a b or c that broadcasts one group over the heads, the per-head gradient:
    autograd's ``expand`` sums it).

    CUDA tensors only (``SsmScan.backward`` takes the plain version on the
    CPU): one call of the kernels of ``csrc/ssm_scan_bwd.cu`` on ``saved``,
    the forward call's ``Saved`` (one ``launches_bwd``; dx's kernel only
    where dx is asked for), then, where da is asked for, ``da_sum`` on the
    per-step dots their epilogue leaves.  The operands are read in place;
    only a dy whose last dim is not contiguous, or a dh_final that is not a
    contiguous f32 tensor, is copied (the models pass neither).

    The decay's gradient.  With cum the inclusive cumsum of log a,
    y_u = sum_{s <= u} (c_u . b_s) e^{cum_u - cum_s} x_s and h_final =
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
    p] x_u[p] = b_u . db_u (lambda_u the gradient of h_u).  The kernels take
    the N-wide form, so da needs no dx, which the mLSTM normaliser (x = 1)
    does not ask for: d log a_t = sum_{u >= t} (c_u . dc_u - b_u . db_u) +
    <dh_final, h_final>, and da_t = d log a_t / a_t (0 where a_t < A_FLOOR,
    below which the forward does not depend on a_t)."""
    global launches_bwd
    need_x, need_a, need_b, need_c = needs
    _check(x, a, b, c, "scan_backward")
    if dy is None:
        dy = torch.zeros_like(x)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"scan_backward: dy {tuple(dy.shape)} {dy.dtype} on {dy.device}; "
                         f"need x's {tuple(x.shape)} {x.dtype} on {x.device}")
    bsz, s, nh, p = x.shape
    n, chunk = b.shape[3], saved.chunk
    if p > 1 and dy.stride(3) != 1:
        dy = dy.contiguous()
    dh = None
    if dh_final is not None:
        if dh_final.shape != (bsz, nh, n, p):
            raise ValueError(f"scan_backward: dh_final{tuple(dh_final.shape)}; need "
                             f"{(bsz, nh, n, p)}")
        dh = dh_final.to(device=x.device, dtype=torch.float32).contiguous()
    nc = -(-s // chunk)
    kg, kb = bwd_parts(n, p, chunk)
    f32 = {"dtype": torch.float32, "device": x.device}
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device) if need_x else None
    db = torch.empty((bsz, s, nh, n), **f32) if need_b else None
    dc = torch.empty((bsz, s, nh, n), **f32) if need_c else None
    lam = torch.empty((bsz * nh * nc * n * p,), **f32)
    dd = torch.empty((bsz * nh * nc * chunk * chunk,), **f32) \
        if need_a or need_b or need_c else None
    gpart = torch.empty((bsz, nh, s, kg), **f32) if need_a else None
    biasp = torch.empty((bsz, nh, kb), **f32) if need_a and dh is not None else None
    import ctypes
    strides = (ctypes.c_int64 * 15)(*[st for t in (x, a, b, c, dy) for st in t.stride()[:3]])
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def ptr(t):
        return t.data_ptr() if t is not None else None
    rc = _kernel("ssm_scan_bwd_launch")(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), dy.data_ptr(),
        saved.gmat.data_ptr(), saved.states.data_ptr(), saved.cums.data_ptr(),
        saved.h.data_ptr(), ptr(dh), lam.data_ptr(), ptr(dd), ptr(dx), ptr(db), ptr(dc),
        ptr(gpart), ptr(biasp), strides, bsz, nh, s, p, n, bc_groups(b, c), chunk,
        _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan backward kernel launch failed: CUDA error {rc}")
    launches_bwd += 1
    da = da_sum(gpart, a, biasp) if need_a else None
    return dx, da, db, dc


def da_sum(g: torch.Tensor, a: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The decay's gradient da (B, S, H) f32 from its per-step parts ``g`` (B,
    H, S, K) f32 contiguous (the backward's N tiles' c_u . dc_u - b_u . db_u)
    and the parts of <dh_final, h_final> ``bias`` (B, H, Kb) f32 contiguous
    or None: d log a_t = sum_{u >= t} sum_k g[.., u, k] + sum_k bias[.., k],
    da_t = d log a_t / a_t, 0 where a_t < A_FLOOR.  a: (B, S, H) f32, any
    strides.

    One kernel of ``csrc/ssm_scan_bwd.cu`` a call (one ``launches_da``): a
    block a (batch, head), the parts summed in a fixed order and the reverse
    cumulative sum in f64.  Bound on the H100: the bytes of g, a and da.  A
    CPU tensor takes the plain version ``ref.ssm_scan_da_sum``."""
    global launches_da
    if g.device.type == "cpu":
        return ssm_scan_da_sum_plain(g, a, bias)
    if g.device.type != "cuda":
        raise ValueError(f"da_sum: unsupported device {g.device}")
    if g.dim() != 4 or a.dim() != 3 or a.shape != (g.shape[0], g.shape[2], g.shape[1]):
        raise ValueError(f"da_sum: bad shapes g{tuple(g.shape)} a{tuple(a.shape)}")
    bsz, nh, s, k = g.shape
    if bias is not None and (bias.dim() != 3 or bias.shape[:2] != (bsz, nh)
                             or not bias.is_contiguous()):
        raise ValueError(f"da_sum: bias must be a contiguous ({bsz}, {nh}, Kb), not "
                         f"{tuple(bias.shape)}")
    for name, t in (("g", g), ("a", a)) + ((("bias", bias),) if bias is not None else ()):
        if t.dtype != torch.float32:
            raise TypeError(f"da_sum: {name} is {t.dtype}; need float32")
        if t.device != g.device:
            raise ValueError(f"da_sum: {name} on {t.device}, g on {g.device}")
    if not g.is_contiguous():
        raise ValueError("da_sum: g must be contiguous")
    da = torch.empty((bsz, s, nh), dtype=torch.float32, device=g.device)
    import ctypes
    strides = (ctypes.c_int64 * 3)(*a.stride())
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = _kernel("ssm_scan_da_launch")(g.data_ptr(), a.data_ptr(),
                                       bias.data_ptr() if bias is not None else None,
                                       da.data_ptr(), strides, bsz, nh, s, k,
                                       bias.shape[2] if bias is not None else 0, stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan_da kernel launch failed: CUDA error {rc}")
    launches_da += 1
    return da


class SsmScan(torch.autograd.Function):
    """The scan with its gradient: the forward kernels, which keep their
    scratch (``Saved``) where a gradient is asked for, and ``scan_backward``
    on it (on a CPU tensor ``ref.ssm_scan`` and ``ref.ssm_scan_backward``).
    ``SsmScan.apply(x, a, b, c, tile)`` returns (y, h) as ``ssm_scan(x, a, b,
    c, **tile)`` does (``tile``: ``pom_tile``'s, or {} for the fixed chunk
    and P tile)."""

    @staticmethod
    def forward(ctx, x, a, b, c, tile):
        tile = {"chunk": SCAN_NAIVE[0], "p_tile": SCAN_NAIVE[1], **tile}
        y, h, saved = _forward(x, a, b, c, tile["chunk"], tile["p_tile"])
        if saved is not None and any(ctx.needs_input_grad[:4]):
            ctx.chunk = saved.chunk
            ctx.save_for_backward(x, a, b, c, h, saved.gmat, saved.states, saved.cums)
        else:
            ctx.chunk = None
            ctx.save_for_backward(x, a, b, c, h)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, a, b, c, h, *scratch = ctx.saved_tensors
        needs = tuple(ctx.needs_input_grad[:4])
        if x.device.type == "cpu":
            if dy is None:
                dy = torch.zeros_like(x)
            grads = tuple(g if need else None for g, need in
                          zip(ssm_scan_backward_plain(x, a, b, c, dy, dh), needs))
        elif x.device.type == "meta":
            _meta.add("ssm_scan_bwd", *_meta.ssm_scan_backward(x, b, bc_groups(b, c)))
            grads = tuple(torch.empty(t.shape, dtype=t.dtype if t is x else torch.float32,
                                      device="meta") if need else None
                          for t, need in zip((x, a, b, c), needs))
        else:
            grads = scan_backward(x, a, b, c, dy, dh, Saved(h, *scratch, ctx.chunk),
                                  needs=needs)
        return (*grads, None)
