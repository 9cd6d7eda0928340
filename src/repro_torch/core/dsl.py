"""POM DSL (paper SS IV): var / placeholder / compute + scheduling primitives.

A Python-embedded rendition of the paper's C++-embedded DSL, e.g. the
matrix-multiplication of Fig. 4:

    from repro_torch.core import dsl as pom

    with pom.function("gemm") as f:
        i, j, k = pom.var("i", 0, 32), pom.var("j", 0, 32), pom.var("k", 0, 32)
        A = pom.placeholder("A", (32, 32))
        B = pom.placeholder("B", (32, 32))
        C = pom.placeholder("C", (32, 32))
        s = pom.compute("s", [k, i, j], A(i, j) + B(i, k) * C(k, j), A(i, j))
    s.tile("i", "j", 4, 4, "i0", "j0", "i1", "j1")
    s.pipeline("j0", 1)
    s.unroll("i1", 4); s.unroll("j1", 4)
    A.partition({0: 4, 1: 4}, "cyclic")

Scheduling primitives (Table II) are methods on the returned compute handle;
``f.auto_DSE()`` invokes the two-stage DSE engine (SS VI).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .affine import BasicSet, LinExpr, ge, le
from .errors import PomError, PomUserError, PomWarning
from .ir import (DType, Expr, Function, IterVal, Load, Placeholder, Statement,
                 loads_of, p_float32, walk_expr, wrap)
from .pipeline import CompileService, ServiceResult, compile_many, serve
from .telemetry import metrics
from . import telemetry
from . import transforms as T


# --------------------------------------------------------------------------
# iterator variables & affine index expressions
# --------------------------------------------------------------------------
class IndexExpr:
    """Affine expression over iterator vars, usable as an array index."""

    def __init__(self, lin: LinExpr):
        self.lin = lin

    def __add__(self, o): return IndexExpr(self.lin + _lin(o))
    def __radd__(self, o): return IndexExpr(_lin(o) + self.lin)
    def __sub__(self, o): return IndexExpr(self.lin - _lin(o))
    def __rsub__(self, o): return IndexExpr(_lin(o) - self.lin)

    def __mul__(self, k):
        if isinstance(k, int):
            return IndexExpr(self.lin * k)
        raise TypeError("affine index may only be scaled by int")
    __rmul__ = __mul__

    def __repr__(self):
        return f"idx({self.lin})"


class Var(IndexExpr):
    """Loop iterator: ``var i("i", 0, 32)`` iterates [lo, hi)  (paper Fig. 4)."""

    def __init__(self, name: str, lo: Optional[int] = None, hi: Optional[int] = None):
        super().__init__(LinExpr.var(name))
        self.name, self.lo, self.hi = name, lo, hi

    def __repr__(self):
        return f"var({self.name}, {self.lo}, {self.hi})"


def _lin(x) -> LinExpr:
    if isinstance(x, IndexExpr):
        return x.lin
    if isinstance(x, int):
        return LinExpr.cst(x)
    if isinstance(x, LinExpr):
        return x
    raise TypeError(f"not affine: {x!r}")


def var(name: str, lo: Optional[int] = None, hi: Optional[int] = None) -> Var:
    return Var(name, lo, hi)


def placeholder(name: str, shape: Sequence[int], dtype: DType = p_float32) -> Placeholder:
    return Placeholder(name, shape, dtype)


# --------------------------------------------------------------------------
# function context
# --------------------------------------------------------------------------
_current: List["PomFunction"] = []


class PomFunction:
    """User handle around ``ir.Function`` + DSE entry point.

    ``outputs`` names the externally observable arrays of the function
    (``pom.function("net", outputs=["out"])``); every other written array
    is an internal temporary, so graph-level dead-op elimination may prune
    computes that cannot reach an output.  The default (None) keeps the
    conservative behavior: every written array is an output, nothing is
    dead.
    """

    def __init__(self, name: str, outputs: Optional[Sequence[str]] = None,
                 dataflow: Optional[bool] = None):
        self.fn = Function(name)
        self.outputs: Optional[List[str]] = (
            None if outputs is None else [str(o) for o in outputs])
        if dataflow is not None:
            self.fn.dataflow = bool(dataflow)
        self._entered = False

    # context manager so computes auto-register
    def __enter__(self):
        _current.append(self)
        return self

    def __exit__(self, *exc):
        _current.pop()
        return False

    @property
    def statements(self):
        return self.fn.statements

    def stmt(self, name: str) -> "ComputeHandle":
        return ComputeHandle(self.fn.stmt(name))

    def set_dataflow(self, flag: Optional[bool]) -> "PomFunction":
        """Pin task-level pipelining for this function: ``True``/``False``
        override the ``POM_DATAFLOW`` environment default, ``None``
        restores it (and lets the stage-2 DSE decide)."""
        self.fn.dataflow = None if flag is None else bool(flag)
        return self

    def auto_DSE(self, target: str = "fpga", **kw):
        """paper: f.auto_DSE("PATH") -- run the two-stage DSE engine
        (itself a PassManager pipeline, see ``pipeline``/``dse``)."""
        from .dse import auto_dse
        kw.setdefault("outputs", self.outputs)
        return auto_dse(self.fn, target=target, **kw)

    def codegen(self, backend: str = "hls", **kw):
        """Lower through the three-level pass pipeline to ``backend``
        (``"hls"``, ``"jax"``, or ``"cuda"``)."""
        from .pipeline import compile
        kw.setdefault("outputs", self.outputs)
        return compile(self.fn, target=backend, **kw)

    def compile(self, target: str = "hls", **kw):
        """Alias of ``codegen`` matching the pipeline entry-point name."""
        return self.codegen(target, **kw)

    def runner(self, batch_size: Optional[int] = None, device=None, **kw):
        """Executable CUDA serving entry point.

        ``batch_size=None`` returns the whole-program single-invocation
        executor (``run(arrays) -> dict``); an int returns the
        ``batched(B)`` executor (every input carries a leading batch
        dimension).  ``device`` defaults to ``cuda``.  Sugar for
        ``codegen("cuda", device=device).jitted()/.batched(B)``."""
        program = self.codegen("cuda", device=device, **kw)
        return (program.jitted() if batch_size is None
                else program.batched(batch_size))

    def __repr__(self):
        return f"PomFunction({self.fn.name})"


def cuda_supported() -> bool:
    """Whether this host builds and launches the port's CUDA kernels
    (probed once per process; lazy so the base import path stays
    torch-free)."""
    from .backend_cuda import cuda_supported as probe
    return probe()


def function(name: str, outputs: Optional[Sequence[str]] = None,
             dataflow: Optional[bool] = None) -> PomFunction:
    """Open a POM function scope; ``outputs`` optionally names the
    externally observable arrays (enables graph-level dead-op elimination
    in the pipeline — see ``graph_ir.eliminate_dead_ops``); ``dataflow``
    pins task-level pipelining on or off for the function (default: the
    ``POM_DATAFLOW`` environment toggle + the stage-2 DSE decision)."""
    return PomFunction(name, outputs=outputs, dataflow=dataflow)


# --------------------------------------------------------------------------
# compute
# --------------------------------------------------------------------------
class ComputeHandle:
    """Schedule-primitive surface of a compute (paper Table II)."""

    def __init__(self, stmt: Statement):
        self._s = stmt

    # -- loop transformations ---------------------------------------------------
    def interchange(self, i, j):
        T.interchange(self._s, _name(i), _name(j))
        return self

    def split(self, i, t: int, i0, i1):
        T.split(self._s, _name(i), t, _name(i0), _name(i1))
        return self

    def tile(self, i, j, t1: int, t2: int, i0, j0, i1, j1):
        T.tile(self._s, _name(i), _name(j), t1, t2,
               _name(i0), _name(j0), _name(i1), _name(j1))
        return self

    def skew(self, i, j, f: int, ip, jp):
        T.skew(self._s, _name(i), _name(j), f, _name(ip), _name(jp))
        return self

    def after(self, other: "ComputeHandle", level):
        lvl = level if isinstance(level, int) else self._s.dims.index(_name(level))
        T.set_after(self._s, other._s, lvl)
        return self

    # -- hardware optimizations ---------------------------------------------------
    def pipeline(self, i, ii: int = 1):
        self._s.pipeline_at = _name(i)
        self._s.pipeline_ii = ii
        return self

    def unroll(self, i, t: Optional[int] = None):
        d = _name(i)
        if t is None:
            t = self._s.trip_counts().get(d, 1)
        self._s.unrolls[d] = int(t)
        return self

    # -- introspection ------------------------------------------------------------
    @property
    def stmt(self) -> Statement:
        return self._s

    @property
    def dims(self) -> List[str]:
        return self._s.dims

    def __repr__(self):
        return f"compute({self._s.name}, dims={self._s.dims})"


def _name(x: Union[str, Var]) -> str:
    return x.name if isinstance(x, Var) else str(x)


def _validate_compute(name: str, declared: Sequence[str], body: Expr,
                      dest: Load) -> None:
    """Reject malformed programs at the DSL boundary with a
    :class:`PomUserError` naming the statement, array, and expected rank —
    instead of a bare ``KeyError``/``IndexError`` from deep inside
    ``graph_ir``/``affine`` long after the user's call site."""
    if not isinstance(dest, Load):
        raise PomUserError(
            f"compute({name!r}): dest must be an array access like A(i, j), "
            f"got {type(dest).__name__}")
    known = set(declared)
    for load in loads_of(body) + [dest]:
        arr = load.array
        if len(load.idx) != len(arr.shape):
            raise PomUserError(
                f"compute({name!r}): array {arr.name!r} has rank "
                f"{len(arr.shape)} (shape {arr.shape}) but is accessed "
                f"with {len(load.idx)} "
                f"{'index' if len(load.idx) == 1 else 'indices'}: {load!r}")
        for e in load.idx:
            for v in e.vars():
                if v not in known:
                    raise PomUserError(
                        f"compute({name!r}): access {load!r} of array "
                        f"{arr.name!r} references undeclared iterator "
                        f"{v!r} (declared iterators: "
                        f"{', '.join(declared)})")
    for node in walk_expr(body):
        if isinstance(node, IterVal):
            for v in node.expr.vars():
                if v not in known:
                    raise PomUserError(
                        f"compute({name!r}): expression references "
                        f"undeclared iterator {v!r} (declared iterators: "
                        f"{', '.join(declared)})")


def compute(name: str, iters: Sequence[Var], expr, dest: Load,
            where: Sequence = ()) -> ComputeHandle:
    """paper Fig. 4 L8: ``compute s("s", [k,i,j], A(i,j)+B(i,k)*C(k,j), A(i,j))``.

    ``iters`` order == loop-nest order (outermost first).  ``where`` adds
    extra affine constraints (non-rectangular domains, e.g. triangular).
    """
    cons = []
    for it in iters:
        if it.lo is None or it.hi is None:
            raise ValueError(f"iterator {it.name} needs bounds for compute")
        cons.append(ge(LinExpr.var(it.name), it.lo))
        cons.append(le(LinExpr.var(it.name), it.hi - 1))
    for c in where:
        cons.append(c)
    dom = BasicSet([it.name for it in iters], cons)
    body = wrap(expr)
    _validate_compute(name, [it.name for it in iters], body, dest)
    stmt = Statement(name, dom, body, dest, [it.name for it in iters])
    if _current:
        _current[-1].fn.add(stmt)
    return ComputeHandle(stmt)
