"""CUDA backend: lower a POM-scheduled statement to the contraction kernel.

The port of ``repro.core.backend_pallas`` for the H100.  The schedule
analysis is the reference's, so the two backends accept and reject exactly
the same statements:

  * non-unrolled loop dims  -> the reference's Pallas **grid**; here the
    output grid dims are the outer part of the CUDA thread space and the
    reduction grid dims a loop inside the thread,
  * fully-unrolled dims     -> the reference's **block**; here the inner
    part of the thread space (output block dims) and the inner reduction
    loop (reduction block dims),
  * BlockSpec index maps    -> per-dim linear offset coefficients of every
    array (``ContractionDesc``), computed once at lowering.

One statement shape is supported, the *contraction* ``D = D + X * Y`` —
the paper's linear-algebra benchmarks (GEMM / 2MM / 3MM / BICG / GESUMMV)
and the conv nests.  Anything else raises ``CudaLowerError``; a program
then runs that statement on its whole-program step's own executor, on the
same device (``CudaProgram``).

Deliberate differences from the reference: no interpret mode and no
pin-to-interpret fallback.  On a ``cuda`` device a kernel that fails to
build or launch raises, and an injected ``backend.lower`` fault raises
``CudaLowerError``.  On the ``cpu`` device the kernel's plain PyTorch
version runs (``kernels/ref.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .affine import LinExpr, ceil_div
from .errors import warn_structured
from .ir import BinOp, Call, Const, Expr, Function, IterVal, Load, Placeholder, Statement
from .ir import loads_of
from . import faultinject, telemetry
from .. import DeviceLike, resolve_device
from ..kernels import contraction as _contraction
from ..kernels.contraction import ContractionDesc
from ..kernels.probe import probe as _probe


class CudaLowerError(Exception):
    pass


# --------------------------------------------------------------------------
# schedule analysis (the reference's, verbatim but for the error type)
# --------------------------------------------------------------------------
def _dim_extents(stmt: Statement) -> Dict[str, int]:
    return stmt.trip_counts()


def _classify_dims(stmt: Statement) -> Tuple[List[str], List[str]]:
    """(grid_dims, block_dims): block dims must be fully unrolled."""
    trips = _dim_extents(stmt)
    grid, block = [], []
    for d in stmt.dims:
        f = stmt.unrolls.get(d, 1)
        t = trips.get(d, 1)
        if f >= t and f > 1:
            block.append(d)
        elif f > 1:
            raise CudaLowerError(f"partial unroll of {d} unsupported")
        else:
            grid.append(d)
    return grid, block


def _lower_bounds(stmt: Statement) -> Dict[str, int]:
    out = {}
    s = stmt.domain
    for i, d in enumerate(s.dims):
        los, _ = s.bounds_of(d, s.dims[i + 1:])
        const = [b for b in los if b.expr.is_const()]
        if not const:
            raise CudaLowerError(f"non-constant lower bound on {d}")
        out[d] = max(ceil_div(b.expr.const, b.div) for b in const)
    return out


def _check_block_alignment(stmt: Statement, arr: Placeholder,
                           idx: Sequence[LinExpr], grid: List[str],
                           block: List[str], trips: Dict[str, int],
                           lbs: Dict[str, int]) -> None:
    """The reference's ``_array_spec`` checks: every grid-dim stride and the
    constant offset of an access must be a multiple of its block extent."""
    for p, e in enumerate(idx):
        span = 1
        for d in block:
            c = e.coeff(d)
            if c != 0:
                span += abs(c) * (trips[d] - 1)
        base = LinExpr.cst(e.const)
        for d, c in e.coeffs.items():
            if d in block:
                base = base + LinExpr.cst(c * lbs.get(d, 0))
            else:
                base = base + LinExpr.var(d) * c
        for d in grid:
            c = base.coeff(d)
            if c % span != 0:
                raise CudaLowerError(
                    f"{arr.name} dim {p}: grid stride {c} not aligned to block {span}")
        if base.const % span != 0:
            raise CudaLowerError(f"{arr.name} dim {p}: offset not tile-aligned")


def _match_contraction(stmt: Statement) -> Optional[Tuple[Load, Load, Load]]:
    """D = D + X*Y  (accumulation contraction). Returns (acc, X, Y)."""
    b = stmt.body
    if not (isinstance(b, BinOp) and b.op == "+"):
        return None
    sides = [(b.lhs, b.rhs), (b.rhs, b.lhs)]
    for acc, mulexpr in sides:
        if (isinstance(acc, Load) and acc.array.name == stmt.store.array.name
                and isinstance(mulexpr, BinOp) and mulexpr.op == "*"
                and isinstance(mulexpr.lhs, Load) and isinstance(mulexpr.rhs, Load)):
            if all((a - b_).key() == ((), 0) for a, b_ in zip(acc.idx, stmt.store.idx)):
                return acc, mulexpr.lhs, mulexpr.rhs
    return None


def _match_contraction_composed(stmt: Statement):
    """Contraction match on *composed* (current-dim) access functions."""
    m = _match_contraction(stmt)
    if m is None:
        return None
    _, xl, yl = m
    x_idx = tuple(stmt.subst_lin(e) for e in xl.idx)
    y_idx = tuple(stmt.subst_lin(e) for e in yl.idx)
    return (xl.array, x_idx), (yl.array, y_idx)


# --------------------------------------------------------------------------
# dtypes and tensors
# --------------------------------------------------------------------------
_KERNEL_DTYPES = {"p_float32": torch.float32, "p_bfloat16": torch.bfloat16,
                  "p_float64": torch.float64}


def torch_dtype(ph: Placeholder) -> torch.dtype:
    """The tensor dtype of a placeholder; bfloat16 where the DType has no
    numpy type (the reference's ``_dtype_of``)."""
    np_t = ph.dtype.np
    if np_t is None:
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, dtype=np_t)).dtype


def to_device(v: Any, device: torch.device, dtype: Optional[torch.dtype] = None,
              shape: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """``v`` (a numpy array, a tensor or a number) as a contiguous tensor on
    ``device``; ``v=None`` gives zeros of ``shape``.  May share memory with
    ``v``: callers that update in place copy first."""
    if v is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return t.to(device=device, dtype=dtype).contiguous()


# --------------------------------------------------------------------------
# the contraction descriptor
# --------------------------------------------------------------------------
def _strides(shape: Sequence[int]) -> List[int]:
    out, s = [], 1
    for n in reversed(shape):
        out.append(s)
        s *= n
    return out[::-1]


def _linearise(arr: Placeholder, idx: Sequence[LinExpr], dims: Sequence[str],
               lbs: Dict[str, int]) -> Tuple[Dict[str, int], int]:
    """Per-dim element offset coefficients of an access, and its constant
    offset at the lower bounds (dim value = lower bound + loop index)."""
    if len(idx) != len(arr.shape):
        raise CudaLowerError(f"{arr.name}: {len(idx)} indices for rank {len(arr.shape)}")
    coef = {d: 0 for d in dims}
    const = 0
    for e, st in zip(idx, _strides(arr.shape)):
        for d, c in e.coeffs.items():
            if d not in coef:
                raise CudaLowerError(f"{arr.name}: index uses {d}, not a loop dim")
            coef[d] += c * st
        const += e.const * st
    const += sum(coef[d] * lbs[d] for d in dims)
    return coef, const


def _check_box_and_bounds(stmt: Statement, trips: Dict[str, int],
                          lbs: Dict[str, int],
                          accesses: Sequence[Tuple[Placeholder, Sequence[LinExpr]]]
                          ) -> None:
    """The kernel walks the box of trip counts from the lower bounds: every
    domain constraint must hold on the whole box, and every access must
    stay inside its array on it."""
    lo = {d: lbs[d] for d in stmt.dims}
    hi = {d: lbs[d] + trips[d] - 1 for d in stmt.dims}

    def extent(e: LinExpr) -> Tuple[int, int]:
        mn = mx = e.const
        for d, c in e.coeffs.items():
            if d not in lo:
                raise CudaLowerError(f"{stmt.name}: symbol {d} is not a loop dim")
            a, b = c * lo[d], c * hi[d]
            mn += min(a, b)
            mx += max(a, b)
        return mn, mx

    for con in stmt.domain.constraints:
        mn, mx = extent(con.expr)
        if (con.is_eq and (mn, mx) != (0, 0)) or (not con.is_eq and mn < 0):
            raise CudaLowerError(f"{stmt.name}: iteration domain is not a box")
    for arr, idx in accesses:
        for p, e in enumerate(idx):
            mn, mx = extent(e)
            if mn < 0 or mx >= arr.shape[p]:
                raise CudaLowerError(
                    f"{arr.name} dim {p}: index range [{mn}, {mx}] outside "
                    f"[0, {arr.shape[p] - 1}]")


def _descriptor(stmt: Statement, grid_dims: List[str], block_dims: List[str],
                trips: Dict[str, int], lbs: Dict[str, int],
                store: Tuple[Placeholder, Sequence[LinExpr]],
                x: Tuple[Placeholder, Sequence[LinExpr]],
                y: Tuple[Placeholder, Sequence[LinExpr]]) -> ContractionDesc:
    (o_arr, o_idx), (x_arr, x_idx), (y_arr, y_idx) = store, x, y
    for arr in (o_arr, x_arr, y_arr):
        if arr.dtype.name not in _KERNEL_DTYPES:
            raise CudaLowerError(
                f"{arr.name}: dtype {arr.dtype.name} has no contraction kernel "
                f"(float32, bfloat16, float64)")
    _check_box_and_bounds(stmt, trips, lbs, [store, x, y])
    dims = list(stmt.dims)
    oc, o0 = _linearise(o_arr, o_idx, dims, lbs)
    xc, x0 = _linearise(x_arr, x_idx, dims, lbs)
    yc, y0 = _linearise(y_arr, y_idx, dims, lbs)
    stored = {d for e in o_idx for d in e.vars()}
    out = ([d for d in grid_dims if d in stored]
           + [d for d in block_dims if d in stored])
    red = [d for d in dims if d not in stored]
    if len(out) > _contraction.MAX_DIMS or len(red) > _contraction.MAX_DIMS:
        raise CudaLowerError(f"{stmt.name}: more than {_contraction.MAX_DIMS} "
                             "output or reduction dims")
    numel = lambda a: int(np.prod(a.shape, dtype=np.int64))  # noqa: E731
    return ContractionDesc(
        out_trips=tuple(trips[d] for d in out), out_x=tuple(xc[d] for d in out),
        out_y=tuple(yc[d] for d in out), out_o=tuple(oc[d] for d in out),
        red_trips=tuple(trips[d] for d in red), red_x=tuple(xc[d] for d in red),
        red_y=tuple(yc[d] for d in red), x0=x0, y0=y0, o0=o0,
        x_numel=numel(x_arr), y_numel=numel(y_arr), o_numel=numel(o_arr))


# --------------------------------------------------------------------------
# the probe
# --------------------------------------------------------------------------
# Once-per-process probe of the CUDA toolchain and card: build the probe
# kernel with nvcc, launch it, check o == x + 1.  The answer never selects
# the CPU: a ``cuda`` program raises with ``_PROBE_ERROR`` when it is False.
_PROBE: Optional[bool] = None
_PROBE_ERROR: Optional[str] = None


def cuda_supported() -> bool:
    """Whether the probe kernel builds and runs on the current card (probed
    once per process).  ``False`` without calling ``nvcc`` on a host with
    no CUDA device."""
    global _PROBE, _PROBE_ERROR
    if _PROBE is None:
        if not torch.cuda.is_available():
            _PROBE, _PROBE_ERROR = False, "torch.cuda.is_available() is False"
        else:
            try:
                x = torch.arange(8, dtype=torch.float32, device="cuda")
                o = _probe(x)
                torch.cuda.synchronize()
                _PROBE = bool(torch.equal(o.cpu(), torch.arange(8.0) + 1))
                if not _PROBE:
                    _PROBE_ERROR = f"the probe kernel returned {o.cpu().tolist()}"
            except Exception as e:  # nvcc, ctypes and CUDA raise their own types
                _PROBE, _PROBE_ERROR = False, f"{type(e).__name__}: {e}"
    return _PROBE


# --------------------------------------------------------------------------
# statement lowering
# --------------------------------------------------------------------------
# (schedule signature, array names/shapes/dtypes, device) -> runner
_CUDA_RUNNER_CACHE: Dict[Tuple, Callable] = {}
_CUDA_RUNNER_CACHE_MAX = 1024


def lower_stmt_cuda(stmt: Statement, device: DeviceLike = None) -> Callable:
    """Lower one scheduled statement to a contraction-kernel runner.

    Returns ``f(arrays: dict[str, ndarray | Tensor]) -> Tensor``: X, Y and
    D are moved to the device (``cuda`` by default) in D's placeholder
    dtype and the updated destination array is returned (a new tensor; the
    inputs are not modified).  A leading batch dim on the arrays is a batch
    of statements.  Lowerings are memoized on
    (statement schedule signature, array names/shapes/dtypes, device).
    """
    dev = resolve_device(device)
    from . import caching
    key = None
    if caching.ENABLED:
        arrays_sig = tuple((a.name, a.shape, a.dtype.name) for a in
                           [stmt.store.array] + [ld.array
                                                 for ld in loads_of(stmt.body)])
        key = (stmt.schedule_signature(), arrays_sig, str(dev))
        hit = _CUDA_RUNNER_CACHE.get(key)
        if hit is not None:
            return hit
    # span covers only the actual lowering work; memoized hits return above
    with telemetry.span("backend.lower", _cat="backend", backend="cuda",
                        statement=stmt.name, device=str(dev)):
        run = _lower_stmt_cuda_compute(stmt, dev)
    if key is not None:
        if len(_CUDA_RUNNER_CACHE) >= _CUDA_RUNNER_CACHE_MAX:
            _CUDA_RUNNER_CACHE.clear()
        _CUDA_RUNNER_CACHE[key] = run
    return run


def _lower_stmt_cuda_compute(stmt: Statement, device: torch.device,
                             pure: bool = False) -> Callable:
    grid_dims, block_dims = _classify_dims(stmt)
    trips = _dim_extents(stmt)
    lbs = _lower_bounds(stmt)
    for d in grid_dims:
        if lbs[d] != 0:
            raise CudaLowerError(f"grid dim {d} must start at 0")

    store_arr, store_idx = stmt.store_access()
    contraction = _match_contraction_composed(stmt)
    if contraction is None:
        raise CudaLowerError("statement is not a supported contraction; "
                             "use the numpy oracle")
    (x_arr, x_idx), (y_arr, y_idx) = contraction
    for arr, idx in [(x_arr, x_idx), (y_arr, y_idx), (store_arr, store_idx)]:
        _check_block_alignment(stmt, arr, idx, grid_dims, block_dims, trips, lbs)
    desc = _descriptor(stmt, grid_dims, block_dims, trips, lbs,
                       (store_arr, store_idx), (x_arr, x_idx), (y_arr, y_idx))
    dt = _KERNEL_DTYPES[store_arr.dtype.name]

    def run(arrays: Dict[str, Any]) -> torch.Tensor:
        o = arrays[store_arr.name]
        if isinstance(o, torch.Tensor) and o.is_meta:   # shape-only evaluation
            return torch.empty_like(o, dtype=dt)
        o = to_device(o, device, dt)
        x = to_device(arrays[x_arr.name], device, dt)
        y = to_device(arrays[y_arr.name], device, dt)
        if not pure and faultinject.fires("backend.lower"):
            raise CudaLowerError(f"{stmt.name}: contraction kernel failed") \
                from RuntimeError("injected kernel launch failure")
        return _contraction.contraction(desc, x, y, o)

    run.desc = desc
    return run


# ==========================================================================
# Serving path: the whole program as one eager step, batching, scan
# ==========================================================================
# The statement runners above execute one statement each.  A program runs
# the whole loop AST as one step over a dict of tensors (``_build_step``):
# top-level contraction nests go to the contraction kernel, vectorizable
# statement nests become index grids + ``index_put_``, fused nests of
# independent statements are distributed, in-place nests with uniform
# offsets run one hyperplane at a time, other loops are Python loops (so
# every guard is static), and ``ScanRegion`` nodes run their template block
# once per block over the per-block arrays.  ``batched(B)`` runs the same
# step over buffers with a leading batch dimension.


class TraceError(Exception):
    """The program cannot run as one step: on the CPU it then runs on the
    numpy oracle, on a card it raises."""


def _call(tensor_fn, scalar_fn):
    """A ``Call`` over tensors and/or Python numbers: the tensor function
    when any argument is a tensor (numbers become tensors of its dtype),
    the scalar one otherwise."""
    def g(*args):
        t = next((a for a in args if isinstance(a, torch.Tensor)), None)
        if t is None:
            return scalar_fn(*args)
        return tensor_fn(*[torch.as_tensor(a, dtype=t.dtype, device=t.device)
                           for a in args])
    return g


_TORCH_CALLS = {
    "exp": _call(torch.exp, math.exp), "sqrt": _call(torch.sqrt, math.sqrt),
    "abs": _call(torch.abs, abs),
    "max": _call(torch.maximum, max), "min": _call(torch.minimum, min),
    "relu": _call(lambda x: torch.clamp_min(x, 0.0), lambda x: max(x, 0.0)),
    "tanh": _call(torch.tanh, math.tanh),
}


def _lin_val(e: LinExpr, env: Dict):
    """Evaluate a LinExpr over an env of ints / index grids (broadcasting
    makes the mixed cases just work)."""
    v = None
    for k, c in e.coeffs.items():
        if c:
            t = env[k] if c == 1 else env[k] * c
            v = t if v is None else v + t
    if v is None:
        return e.const
    return v + e.const if e.const else v


def _tdiv(a: int, d: int, is_lower: bool) -> int:
    """ceil_div (lower bounds) / floor_div (upper bounds) over ints."""
    if d == 1:
        return a
    return -((-a) // d) if is_lower else a // d


def _bound_val(lb, env: Dict) -> int:
    vals = [_tdiv(_lin_val(b.expr, env), b.div, lb.is_lower) for b in lb.bounds]
    return max(vals) if lb.is_lower else min(vals)


def _stmt_accesses(sn) -> Tuple:
    """(store_arr, store_idx, load_idx_by_id) with every index expression
    composed through ``iter_subst`` and renamed into loop-var space."""
    s = sn.stmt
    ren = sn.dim_map
    arr, sidx = s.store_access()
    store_idx = tuple(e.rename(ren) for e in sidx)
    by_id = {}
    for ld, (a, idx) in zip(loads_of(s.body), s.load_accesses()):
        by_id[id(ld)] = (a, tuple(e.rename(ren) for e in idx))
    return arr, store_idx, by_id


class _Ctx:
    """What an evaluation needs besides the env: the buffers' device, the
    batch (``None`` unbatched) and the rank of the index grids in play."""

    def __init__(self, device: torch.device, batch: Optional[int], nd: int = 0):
        self.device, self.batch, self.nd = device, batch, nd

    def index(self, idx: Tuple) -> Tuple:
        return idx if self.batch is None else (slice(None),) + idx

    def load(self, buf: torch.Tensor, idx: Tuple):
        v = buf[self.index(idx)]
        if self.batch is not None and v.dim() < self.nd + 1:
            # an all-constant index gives (B,): put the batch axis in front
            # of the grid axes it must broadcast against
            v = v.reshape((v.shape[0],) + (1,) * (self.nd + 1 - v.dim()) + v.shape[1:])
        return v


def _eval_expr(sn, e: Expr, env: Dict, bufs: Dict, by_id: Dict, ctx: _Ctx):
    """Evaluate an expression of the statement over scalars or index grids."""
    s = sn.stmt
    ren = sn.dim_map

    def ev(e: Expr):
        if isinstance(e, Const):
            return e.value
        if isinstance(e, IterVal):
            return _lin_val(s.subst_lin(e.expr).rename(ren), env)
        if isinstance(e, Load):
            _, idx = by_id[id(e)]
            return ctx.load(bufs[e.array.name], tuple(_lin_val(x, env) for x in idx))
        if isinstance(e, BinOp):
            a, b = ev(e.lhs), ev(e.rhs)
            if e.op == "+":
                return a + b
            if e.op == "-":
                return a - b
            if e.op == "*":
                return a * b
            if e.op == "/":
                return a / b
            raise TraceError(f"unknown op {e.op}")
        if isinstance(e, Call):
            fn = _TORCH_CALLS.get(e.fn)
            if fn is None:
                raise TraceError(f"unknown call {e.fn}")
            return fn(*[ev(a) for a in e.args])
        raise TraceError(f"unknown expr {e!r}")

    return ev(e)


def _const_chain(node) -> Optional[Tuple[List[Tuple[str, int, int]], Any]]:
    """``(chain, sn)`` when ``node`` is a perfect ForNode chain with constant
    bounds over one StmtNode: ``chain`` lists ``(var, lo, hi)`` outermost
    first."""
    from .loop_ir import ForNode, StmtNode
    chain: List[Tuple[str, int, int]] = []
    n = node
    while isinstance(n, ForNode):
        if not (n.lo.is_constant() and n.hi.is_constant()):
            return None
        chain.append((n.var, n.lo.const_value(), n.hi.const_value()))
        if len(n.body) != 1:
            return None
        n = n.body[0]
    if not isinstance(n, StmtNode) or not chain:
        return None
    return chain, n


def _store_positions(store_idx: Tuple, chain) -> Optional[Dict[str, int]]:
    """var -> store position for the chain vars the store moves with: each
    such var in exactly one position with coefficient ±1, at most one chain
    var per position.  ``None`` when the store is not of that form."""
    remaining = {v for v, _, _ in chain}
    kept: Dict[str, int] = {}
    for p, e in enumerate(store_idx):
        vs = [v for v in e.vars() if v in remaining]
        if len(vs) > 1:
            return None
        if vs:
            v = vs[0]
            if v in kept or abs(e.coeff(v)) != 1:
                return None
            kept[v] = p
    return kept


def _vec_plan(node) -> Optional[Tuple]:
    """Whole-nest vectorization plan for a single-statement ForNode chain.

    Returns ``(chain, sn, kept, red, rest_body)`` when the remaining nest
    can be evaluated all-iterations-at-once: constant bounds, one straight
    StmtNode leaf, an injective store over the kept dims (each kept var in
    exactly one store position, coefficient ±1), and no load of the stored
    array except the accumulator pattern ``D = D + rest`` (reduction dims)
    or a same-index read (pure map).  ``None`` → execute sequentially.
    """
    cs = _const_chain(node)
    if cs is None:
        return None
    chain, sn = cs
    s = sn.stmt
    arr, store_idx, _ = _stmt_accesses(sn)
    kept = _store_positions(store_idx, chain)
    if kept is None:
        return None
    red = [v for v, _, _ in chain if v not in kept]

    # loads of the stored array: allowed only at exactly the store index
    acc_load = None
    rest_body = s.body
    if red:
        b = s.body
        if not (isinstance(b, BinOp) and b.op == "+"):
            return None
        for acc, rest in ((b.lhs, b.rhs), (b.rhs, b.lhs)):
            if (isinstance(acc, Load) and acc.array.name == arr.name
                    and all((a - b_).key() == ((), 0)
                            for a, b_ in zip(acc.idx, s.store.idx))):
                acc_load, rest_body = acc, rest
                break
        if acc_load is None:
            return None
        if any(ld.array.name == arr.name for ld in loads_of(rest_body)):
            return None
    else:
        for ld in loads_of(s.body):
            if ld.array.name == arr.name:
                if not all((a - b_).key() == ((), 0)
                           for a, b_ in zip(ld.idx, s.store.idx)):
                    return None
    return chain, sn, kept, red, rest_body


def _wave_plan(node) -> Optional[Tuple]:
    """Wavefront plan for a single-statement nest updated in place, such as
    Gauss-Seidel: the store moves with every loop of the nest (injective)
    and every read of the stored array sits at a constant offset ``e`` from
    the store.  In the nest's order an instance ``x`` reads the new value
    of ``x + e`` when ``e`` is lexicographically negative and the old one
    when it is positive.  Instances on one hyperplane ``sum(x) = L`` run as
    one vectorized update (all reads before all writes) in increasing ``L``
    when every negative ``e`` has ``sum(e) <= -1`` (its writer lies on a
    lower hyperplane) and every positive one ``sum(e) >= 0`` (its writer on
    the same or a higher one).  When no read sees another instance's
    location every instance is independent and the whole nest is one
    hyperplane.  Returns ``(chain, sn, theta)`` (the hyperplane's normal) or
    ``None``.
    """
    cs = _const_chain(node)
    if cs is None:
        return None
    chain, sn = cs
    arr, store_idx, by_id = _stmt_accesses(sn)
    kept = _store_positions(store_idx, chain)
    if kept is None or len(kept) != len(chain):
        return None
    theta = 0
    for ld in loads_of(sn.stmt.body):
        if ld.array.name != arr.name:
            continue
        _, idx = by_id[id(ld)]
        diffs = [a - b for a, b in zip(idx, store_idx)]
        if any(d.vars() for d in diffs):
            return None
        if any(d.const for p, d in enumerate(diffs) if p not in kept.values()):
            continue    # a location the nest never writes
        e = [diffs[kept[v]].const * store_idx[kept[v]].coeff(v) for v, _, _ in chain]
        lead = next((c for c in e if c), 0)
        if (lead < 0 and sum(e) > -1) or (lead > 0 and sum(e) < 0):
            return None
        theta = theta or int(lead != 0)
    return chain, sn, theta


def _wave_levels(chain, theta: int,
                 device) -> Tuple[Dict[str, torch.Tensor], List[Tuple[int, int]]]:
    """Every point of the nest's box ordered by hyperplane
    ``theta * sum(x)``: one coordinate tensor per var and the
    ``(start, stop)`` slice of each hyperplane."""
    axes = np.meshgrid(*[np.arange(lo, hi + 1) for _, lo, hi in chain], indexing="ij")
    level = theta * sum(a.reshape(-1) for a in axes)
    order = np.argsort(level, kind="stable")
    counts = np.bincount(level - level.min())
    stops = np.cumsum(counts)
    coords = {v: torch.as_tensor(a.reshape(-1)[order], device=device)
              for (v, _, _), a in zip(chain, axes)}
    return coords, [(int(b - c), int(b)) for b, c in zip(stops, counts) if c]


def _run_wavefront(plan, levels, bufs: Dict, env: Dict, ctx: _Ctx) -> None:
    """Execute a ``_wave_plan`` nest in place, one hyperplane at a time."""
    chain, sn, _ = plan
    arr, store_idx, by_id = _stmt_accesses(sn)
    coords, slices = levels
    vctx = _Ctx(ctx.device, ctx.batch, 1)
    dest = bufs[arr.name]
    if ctx.device.type == "meta":
        slices = slices[:1]     # a dry run: every hyperplane runs the same ops
    for a, b in slices:
        lenv = dict(env)
        for v, _, _ in chain:
            lenv[v] = coords[v][a:b]
        val = _eval_expr(sn, sn.stmt.body, lenv, bufs, by_id, vctx)
        full = (b - a,) if ctx.batch is None else (ctx.batch, b - a)
        val = torch.as_tensor(val, device=ctx.device).broadcast_to(full)
        sidx = _full_index(tuple(_lin_val(e, lenv) for e in store_idx), ctx)
        dest.index_put_(sidx, val.to(dest.dtype))


def _distribute(node) -> Optional[List]:
    """The loop distribution of a nest of several statements: one nest per
    statement, each keeping the loops and guards around it, in the nest's
    order.  Legal when no statement writes an array that another statement
    of the nest reads or writes, for then the only dependences are between
    instances of one statement, and each distributed nest runs them in the
    original order.  ``None`` when the nest holds fewer than two statements,
    shares an array between them, or holds a node other than loops, guards
    and statements."""
    from .loop_ir import ForNode, IfNode, StmtNode, walk
    stmts = [n.stmt for n in walk(node) if isinstance(n, StmtNode)]
    if len(stmts) < 2 or len({id(s) for s in stmts}) < len(stmts):
        return None
    for a in stmts:
        for b in stmts:
            touched = {b.store.array.name} | {ld.array.name for ld in loads_of(b.body)}
            if a is not b and a.store.array.name in touched:
                return None

    def parts(n) -> Optional[List]:
        if isinstance(n, StmtNode):
            return [n]
        if not isinstance(n, (ForNode, IfNode)):
            return None
        out = []
        for c in n.body:
            ps = parts(c)
            if ps is None:
                return None
            out += [dataclasses.replace(n, body=[p]) for p in ps]
        return out

    return parts(node)


def _grid(lo: int, hi: int, ax: int, nd: int, device) -> torch.Tensor:
    g = lo + torch.arange(hi - lo + 1, device=device)
    return g.reshape((1,) * ax + (len(g),) + (1,) * (nd - 1 - ax))


def _full_index(sidx: Tuple, ctx: _Ctx) -> Tuple[torch.Tensor, ...]:
    """``index_put_`` indices: every position a tensor, the batch in front."""
    idx = tuple(i if isinstance(i, torch.Tensor)
                else torch.tensor(i, device=ctx.device) for i in sidx)
    if ctx.batch is None:
        return idx
    nd = max([i.dim() for i in idx] + [0])
    b = torch.arange(ctx.batch, device=ctx.device).reshape((ctx.batch,) + (1,) * nd)
    return (b,) + idx


def _run_vectorized(plan, bufs: Dict, env: Dict, ctx: _Ctx) -> None:
    """Execute a ``_vec_plan`` nest in place: build per-dim index grids,
    evaluate the body as one broadcasted expression, reduce over the
    reduction axes, and scatter into the destination (``index_put_``,
    accumulating for ``D = D + rest``)."""
    chain, sn, kept, red, rest_body = plan
    arr, store_idx, by_id = _stmt_accesses(sn)
    shape = tuple(hi - lo + 1 for _, lo, hi in chain)
    nd = len(chain)
    vctx = _Ctx(ctx.device, ctx.batch, nd)
    grids = dict(env)
    for ax, (v, lo, hi) in enumerate(chain):
        grids[v] = _grid(lo, hi, ax, nd, ctx.device)

    # store index arrays over the *kept* axes only
    kvars = [v for v, _, _ in chain if v in kept]
    kenv = dict(env)
    for ax, v in enumerate(kvars):
        lo = next(l for vv, l, _ in chain if vv == v)
        hi = next(h for vv, _, h in chain if vv == v)
        kenv[v] = _grid(lo, hi, ax, len(kvars), ctx.device)
    sidx = _full_index(tuple(_lin_val(e, kenv) for e in store_idx), ctx)

    full = shape if ctx.batch is None else (ctx.batch,) + shape
    dest = bufs[arr.name]
    if red:
        # D = D + sum(rest) over the reduction axes
        val = _eval_expr(sn, rest_body, grids, bufs, by_id, vctx)
        val = torch.as_tensor(val, device=ctx.device).broadcast_to(full)
        off = 0 if ctx.batch is None else 1
        red_axes = tuple(ax + off for ax, (v, _, _) in enumerate(chain) if v in red)
        reduced = val.sum(dim=red_axes)
        dest.index_put_(sidx, reduced.to(dest.dtype), accumulate=True)
    else:
        val = _eval_expr(sn, sn.stmt.body, grids, bufs, by_id, vctx)
        val = torch.as_tensor(val, device=ctx.device).broadcast_to(full)
        dest.index_put_(sidx, val.to(dest.dtype))


def _exec_stmt_scalar(sn, bufs: Dict, env: Dict, ctx: _Ctx) -> None:
    """One statement instance with every loop var bound to an int."""
    arr, store_idx, by_id = _stmt_accesses(sn)
    val = _eval_expr(sn, sn.stmt.body, env, bufs, by_id, ctx)
    idx = tuple(_lin_val(e, env) for e in store_idx)
    bufs[arr.name][ctx.index(idx)] = val


def _build_step(fn: Function, ast, device: torch.device):
    """The loop AST as ``step(bufs, batch=None) -> bufs``.

    ``bufs`` maps every placeholder to a tensor on one device (a leading
    batch dim of ``batch`` when given); the step updates fresh copies in
    place and returns them.  Top-level single-statement nests that the
    contraction matcher accepts run on the contraction kernel (its plain
    version on the CPU).  Other nests run on the step's own executor: as
    one vectorized update where legal, distributed into one nest per
    statement where the statements share no array, one hyperplane at a
    time where a wavefront is legal, and as Python loops otherwise.
    ``step.generic`` collects the statements the own executor ran.  Raises
    ``TraceError`` when some construct has no rendition here.
    """
    from .loop_ir import (DataflowRegion, ForNode, IfNode, ProgramAST,
                          ScanRegion, StmtNode, TaskNode)
    generic: set = set()

    def run_nodes(nodes, bufs, env, ctx):
        for n in nodes:
            run_node(n, bufs, env, ctx)

    def run_node(node, bufs, env, ctx):
        if isinstance(node, (ProgramAST, DataflowRegion, TaskNode)):
            return run_nodes(node.body, bufs, env, ctx)
        if isinstance(node, ScanRegion):
            return run_scan(node, bufs, env, ctx)
        if isinstance(node, ForNode):
            runner = _nest_kernel_runner(node, env)
            if runner is not None:
                dest, run = runner
                bufs[dest] = run(bufs)
                return
            plan = _vec_plan(node)
            if plan is not None:
                generic.add(plan[1].stmt.name)
                return _run_vectorized(plan, bufs, env, ctx)
            parts = _memo(distributed, node, _distribute)
            if parts is not None:
                return run_nodes(parts, bufs, env, ctx)
            wave = _memo(waves, node, _wave_plan)
            if wave is not None:
                generic.add(wave[1].stmt.name)
                key = (id(node), str(ctx.device))
                if key not in levels:
                    levels[key] = _wave_levels(wave[0], wave[2], ctx.device)
                return _run_wavefront(wave, levels[key], bufs, env, ctx)
            lo = _bound_val(node.lo, env)
            hi = _bound_val(node.hi, env)
            for v in range(lo, hi + 1):
                run_nodes(node.body, bufs, {**env, node.var: v}, ctx)
            return
        if isinstance(node, IfNode):
            for c in node.conds:
                v = _lin_val(c.expr, env)
                p = (v == 0) if c.is_eq else (v >= 0)
                if not isinstance(p, bool):
                    raise TraceError("guard over a non-constant expression")
                if not p:
                    return
            return run_nodes(node.body, bufs, env, ctx)
        if isinstance(node, StmtNode):
            generic.add(node.stmt.name)
            return _exec_stmt_scalar(node, bufs, env, ctx)
        raise TraceError(f"unknown node {type(node).__name__}")

    # plans per nest, made once (keyed by id: the AST and the distributed
    # nests, which ``distributed`` keeps alive, outlive the step)
    nest_runners: Dict[int, Optional[Tuple[str, Callable]]] = {}
    distributed: Dict[int, Optional[List]] = {}
    waves: Dict[int, Optional[Tuple]] = {}
    levels: Dict[Tuple[int, str], Tuple] = {}

    def _memo(table, node, make):
        if id(node) not in table:
            table[id(node)] = make(node)
        return table[id(node)]

    def _nest_kernel_runner(node, env):
        """The contraction kernel for a single-statement nest at top level
        (no outer env) whose schedule the contraction matcher supports."""
        if env:
            return None
        return _memo(nest_runners, node, _lower_nest)

    def _lower_nest(node):
        n = node
        while isinstance(n, ForNode):
            if len(n.body) != 1:
                return None
            n = n.body[0]
        if not isinstance(n, StmtNode):
            return None
        s = n.stmt
        try:
            with telemetry.span("backend.lower", _cat="backend", backend="cuda",
                                statement=s.name, device=str(device)):
                run = _lower_stmt_cuda_compute(s, device, pure=True)
        except CudaLowerError:
            return None
        arr, _ = s.store_access()
        return arr.name, run

    def run_scan(node, bufs, env, ctx):
        """The template block once per block, on that block's arrays: the
        stacked reads and the written arrays of block b are bound to the
        template's names, the carry to the previous block's carry-out.  The
        detection rules (writes globally distinct, stacked reads never
        written inside the chain) make updating block b's arrays in place
        equal to scanning over stacked copies."""
        if env:  # a scan region nested under live loops: run unrolled
            return run_nodes(node.body, bufs, env, ctx)
        template = node.body[:node.template_len]
        carry = bufs[node.carry_in] if node.carry_in else None
        for b in range(node.n):
            local = dict(bufs)
            if node.carry_in:
                local[node.carry_in] = carry
            for tn, names in node.reads.items():
                local[tn] = bufs[names[b]]
            for tn, names in node.writes.items():
                local[tn] = bufs[names[b]]
            run_nodes(template, local, {}, ctx)
            for tn, names in node.writes.items():
                bufs[names[b]] = local[tn]
            if node.carry_out:
                carry = local[node.carry_out]

    def step(bufs: Dict[str, torch.Tensor],
             batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
        bufs = {k: v.clone() for k, v in bufs.items()}
        dev = next(iter(bufs.values())).device if bufs else device
        run_node(ast, bufs, {}, _Ctx(dev, batch))
        return bufs

    step.generic = generic
    return step


def _probe_card(device: torch.device) -> None:
    """The probe kernel on ``device``; raises ``CudaLowerError`` unless it
    gives x + 1."""
    x = torch.arange(8, dtype=torch.float32, device=device)
    o = _probe(x)
    if not torch.equal(o.cpu(), torch.arange(8.0) + 1):
        raise CudaLowerError(f"the probe kernel on {device} returned {o.cpu().tolist()}")


class BatchedRunner:
    """The whole-program step over buffers with a leading batch dimension:
    one call serves a batch of invocations.  A program the step cannot
    express runs lane by lane through ``CudaProgram.__call__``: on the numpy
    oracle on the CPU, and not at all on a card (the call raises).

    Over cards (the reference's ``shard_map`` over ``jax.local_devices()``):
    where the program's device is a card, the host holds more than one
    (``torch.cuda.device_count()``) and they divide ``batch_size``, each
    card runs its own step (lowered for it, after the probe kernel passed
    on it) on its share of the lanes, and the results are gathered on the
    program's device.  ``devices`` says how many served.  Nothing falls
    back: a card whose probe, lowering or step fails raises.  ``devices=``
    gives the device list in place of the host's cards (the tests' seam:
    two CPU devices)."""

    def __init__(self, program: "CudaProgram", batch_size: Optional[int], step,
                 devices: Optional[List[torch.device]] = None):
        self.program = program
        self.batch_size = batch_size
        self._sequential = step is None
        self._step = step
        self._steps = None                 # [(device, step)] where the batch splits
        self.devices = 1
        if step is None:
            return
        if devices is None:
            dev = program.device
            devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                       if dev.type == "cuda" else [dev])
        devices = [torch.device(d) for d in devices]
        n = len(devices)
        if n > 1 and batch_size and batch_size % n == 0:
            steps = []
            for d in devices:
                if d.type == "cuda":
                    _probe_card(d)
                steps.append((d, step if d == program.device else
                              _build_step(program.fn, program.ast, d)))
            self._steps = steps
            self.devices = n

    def _infer_batch(self, arrays: Dict[str, Any]) -> int:
        if arrays:
            return next(iter(arrays.values())).shape[0]
        if self.batch_size is None:
            raise ValueError(
                "cannot infer batch size: no input arrays were passed and "
                "the runner was built with batch_size=None")
        return self.batch_size

    def __call__(self, arrays: Dict[str, Any]) -> Dict[str, Any]:
        prog = self.program
        if self._sequential:
            b = self._infer_batch(arrays)
            outs = [prog(dict((k, v[i]) for k, v in arrays.items()))
                    for i in range(b)]
            return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        b = self._infer_batch(arrays)
        if self.batch_size is not None and b != self.batch_size:
            raise ValueError(
                f"batched runner built for batch {self.batch_size}, "
                f"got {b}")
        bufs = prog._batch_bufs(arrays, b)
        with telemetry.span("backend.execute", _cat="backend",
                            backend="cuda_batched", fn=prog.fn.name,
                            batch=b, devices=self.devices):
            if self._steps is None:
                return self._step(bufs, batch=b)
            n = b // self.devices
            outs = [step({k: v[i * n:(i + 1) * n].to(dev) for k, v in bufs.items()}, batch=n)
                    for i, (dev, step) in enumerate(self._steps)]
            return {k: torch.cat([o[k].to(prog.device) for o in outs]) for k in outs[0]}


class CudaProgram:
    """The ``compile(fn, target="cuda")`` artifact.

    Calling it runs the whole program once as one eager step on ``device``
    (the same executor as ``jitted()``): contraction nests on the kernel,
    every other nest on the step's own executor (vectorized nests, loop
    distribution, wavefronts, Python loops for sequential loops, a loop over
    the blocks of detected ``ScanRegion``s).  ``mode`` reports whether the
    kernel runs every statement: ``"cuda"`` when it does, ``"oracle"`` when
    some statement runs on the step's own executor, which evaluates it with
    the numpy oracle's semantics on the program's device.  The serving
    surface on top:

    * ``jitted()``  — the step as a single-invocation executor;
    * ``batched(B)`` — the same step over buffers with a leading batch dim.

    A program the step cannot express runs on the numpy oracle when the
    device is the CPU (``batched`` then loops over the lanes, with a
    one-time structured warning); on a card calling it raises
    ``CudaLowerError``: nothing moves to the host.  On a ``cuda`` device the
    CUDA probe runs first; a failed probe raises ``CudaLowerError`` with its
    cause.
    """

    def __init__(self, fn: Function, ast, device: torch.device):
        if device.type == "cuda" and not cuda_supported():
            raise CudaLowerError(f"{fn.name}: the CUDA probe failed: {_PROBE_ERROR}")
        self.fn = fn
        self.ast = ast
        self.device = device
        self._step = None
        self._step_ok: Optional[bool] = None
        self._step_error = ""
        self._jit = None
        self._oracle = None
        self._batched: Dict[Optional[int], BatchedRunner] = {}

    @property
    def mode(self) -> str:
        """``"cuda"`` when the step runs every statement on the contraction
        kernel, ``"oracle"`` otherwise (see the class docstring)."""
        if self.traceable() and not self._step.generic:
            return "cuda"
        return "oracle"

    def __call__(self, arrays: Dict[str, Any]) -> Dict[str, Any]:
        if self.traceable():
            return self.jitted()(arrays)
        if self.device.type != "cpu":
            raise CudaLowerError(
                f"{self.fn.name}: the step cannot run this program "
                f"({self._step_error}); on {self.device} nothing falls back")
        if self._oracle is None:
            from .backend_jax import compile_jax
            self._oracle = compile_jax(self.fn, self.ast)
        host = {}
        for k, v in arrays.items():
            t = to_device(v, self.device)
            host[k] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        phs = self.fn.placeholders
        return {k: to_device(v, self.device, torch_dtype(phs[k]) if k in phs else None)
                for k, v in self._oracle(host).items()}

    def _full_bufs(self, arrays: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        bufs = {}
        for ph in self.fn.placeholders.values():
            bufs[ph.name] = to_device(arrays.get(ph.name), self.device,
                                      torch_dtype(ph), ph.shape)
        return bufs

    def _batch_bufs(self, arrays: Dict[str, Any], b: int) -> Dict[str, torch.Tensor]:
        bufs = {}
        for ph in self.fn.placeholders.values():
            full = (b,) + tuple(ph.shape)
            v = to_device(arrays.get(ph.name), self.device, torch_dtype(ph), full)
            if tuple(v.shape) != full:
                raise ValueError(
                    f"{ph.name}: expected batched shape {full}, got {tuple(v.shape)}")
            bufs[ph.name] = v
        return bufs

    def traceable(self) -> bool:
        """Whether the whole program runs as one step (checked once, by
        running it on ``meta`` tensors — shapes only, no FLOPs spent)."""
        if self._step_ok is None:
            try:
                step = _build_step(self.fn, self.ast, self.device)
                spec = {ph.name: torch.empty(ph.shape, dtype=torch_dtype(ph),
                                             device="meta")
                        for ph in self.fn.placeholders.values()}
                step(spec)
                self._step = step
                self._step_ok = True
            except (TraceError, NotImplementedError) as e:
                warn_structured("backend_cuda", "cuda_trace_fallback",
                                fn=self.fn.name, error=type(e).__name__)
                self._step_error = f"{type(e).__name__}: {e}"
                self._step_ok = False
        return self._step_ok

    def jitted(self):
        """Single-invocation whole-program executor: ``run(arrays) -> dict``
        (the program itself when the step cannot express it)."""
        if not self.traceable():
            return self
        if self._jit is None:
            step = self._step

            def run(arrays: Dict[str, Any]) -> Dict[str, Any]:
                with telemetry.span("backend.execute", _cat="backend",
                                    backend="cuda_jit", fn=self.fn.name):
                    return step(self._full_bufs(arrays))

            self._jit = run
        return self._jit

    def batched(self, batch_size: Optional[int] = None) -> BatchedRunner:
        """Batched executor: every input carries a leading batch dim."""
        br = self._batched.get(batch_size)
        if br is None:
            step = self._step if self.traceable() else None
            br = BatchedRunner(self, batch_size, step)
            self._batched[batch_size] = br
        return br
