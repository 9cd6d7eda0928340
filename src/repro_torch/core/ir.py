"""Core IR shared by all POM layers: expression trees, placeholders, statements.

The DSL (``dsl.py``) builds these objects; the dependence-graph IR
(``depgraph.py``), the polyhedral transforms (``transforms.py``), the AST
builder (``astbuild.py``) and the backends consume them.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .affine import BasicSet, Constraint, LinExpr, ge, le
from . import caching


# --------------------------------------------------------------------------
# dtypes (paper SS IV-A: int8..64, uint8..64, fp32, fp64)
# --------------------------------------------------------------------------
class DType:
    def __init__(self, name: str, bits: int, is_float: bool, is_signed: bool = True):
        self.name, self.bits, self.is_float, self.is_signed = name, bits, is_float, is_signed

    def __repr__(self):
        return self.name

    @property
    def np(self):
        import numpy as np
        return {
            "p_int8": np.int8, "p_int16": np.int16, "p_int32": np.int32,
            "p_int64": np.int64, "p_uint8": np.uint8, "p_uint16": np.uint16,
            "p_uint32": np.uint32, "p_uint64": np.uint64,
            "p_float32": np.float32, "p_float64": np.float64,
            "p_bfloat16": None,  # resolved by jax backends
        }[self.name]

    @property
    def c_name(self) -> str:
        return {
            "p_int8": "int8_t", "p_int16": "int16_t", "p_int32": "int32_t",
            "p_int64": "int64_t", "p_uint8": "uint8_t", "p_uint16": "uint16_t",
            "p_uint32": "uint32_t", "p_uint64": "uint64_t",
            "p_float32": "float", "p_float64": "double", "p_bfloat16": "bfloat16",
        }[self.name]


p_int8 = DType("p_int8", 8, False)
p_int16 = DType("p_int16", 16, False)
p_int32 = DType("p_int32", 32, False)
p_int64 = DType("p_int64", 64, False)
p_uint8 = DType("p_uint8", 8, False, False)
p_uint16 = DType("p_uint16", 16, False, False)
p_uint32 = DType("p_uint32", 32, False, False)
p_uint64 = DType("p_uint64", 64, False, False)
p_float32 = DType("p_float32", 32, True)
p_float64 = DType("p_float64", 64, True)
p_bfloat16 = DType("p_bfloat16", 16, True)


# --------------------------------------------------------------------------
# Expressions
# --------------------------------------------------------------------------
class Expr:
    """Base of the computation expression tree inside a ``compute``."""

    def __add__(self, o): return BinOp("+", self, wrap(o))
    def __radd__(self, o): return BinOp("+", wrap(o), self)
    def __sub__(self, o): return BinOp("-", self, wrap(o))
    def __rsub__(self, o): return BinOp("-", wrap(o), self)
    def __mul__(self, o): return BinOp("*", self, wrap(o))
    def __rmul__(self, o): return BinOp("*", wrap(o), self)
    def __truediv__(self, o): return BinOp("/", self, wrap(o))
    def __rtruediv__(self, o): return BinOp("/", wrap(o), self)
    def __neg__(self): return BinOp("-", Const(0.0), self)


@dataclass
class Const(Expr):
    value: float


@dataclass
class IterVal(Expr):
    """An affine expression over iterators used as a *value*."""
    expr: LinExpr


@dataclass
class BinOp(Expr):
    op: str
    lhs: Expr
    rhs: Expr


@dataclass
class Call(Expr):
    fn: str          # 'exp', 'max', 'min', 'abs', 'sqrt', 'relu', ...
    args: Tuple[Expr, ...]


class Load(Expr):
    def __init__(self, array: "Placeholder", idx: Sequence[LinExpr]):
        self.array = array
        self.idx: Tuple[LinExpr, ...] = tuple(idx)

    def __repr__(self):
        return f"{self.array.name}[{', '.join(map(repr, self.idx))}]"


def wrap(x) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, (int, float)):
        return Const(float(x))
    # DSL vars / index expressions
    from .dsl import Var, IndexExpr
    if isinstance(x, Var):
        return IterVal(LinExpr.var(x.name))
    if isinstance(x, IndexExpr):
        return IterVal(x.lin)
    raise TypeError(f"cannot use {x!r} in a compute expression")


def walk_expr(e: Expr):
    yield e
    if isinstance(e, BinOp):
        yield from walk_expr(e.lhs)
        yield from walk_expr(e.rhs)
    elif isinstance(e, Call):
        for a in e.args:
            yield from walk_expr(a)


def loads_of(e: Expr) -> List[Load]:
    return [n for n in walk_expr(e) if isinstance(n, Load)]


# --------------------------------------------------------------------------
# Placeholder (arrays)
# --------------------------------------------------------------------------
class Placeholder:
    """A named multi-dimensional array (paper SS IV-A)."""

    def __init__(self, name: str, shape: Sequence[int], dtype: DType = p_float32):
        self.name = name
        self.shape: Tuple[int, ...] = tuple(int(s) for s in shape)
        self.dtype = dtype
        # HLS array-partition annotation: dim -> (factor, kind)
        self._partitions: Dict[int, Tuple[int, str]] = {}
        # memoized ``part_sig``; rebinding ``partitions`` (the property
        # setter) or the in-place mutators below reset it
        self._psig: Optional[Tuple] = None

    @property
    def partitions(self) -> Dict[int, Tuple[int, str]]:
        return self._partitions

    @partitions.setter
    def partitions(self, value: Dict[int, Tuple[int, str]]) -> None:
        self._partitions = value
        self._psig = None

    def part_sig(self) -> Tuple:
        """Sorted structural signature of the partition annotation (what
        every cost-model / search cache key embeds)."""
        sig = self._psig
        if sig is None:
            sig = tuple(sorted(self.partitions.items()))
            self._psig = sig
        return sig

    def __call__(self, *idx) -> Load:
        return Load(self, [to_lin(i) for i in idx])

    def __getitem__(self, idx) -> Load:
        if not isinstance(idx, tuple):
            idx = (idx,)
        return Load(self, [to_lin(i) for i in idx])

    def partition(self, factors, kind: str = "cyclic"):
        """``A.partition({4,4},"cyclic")`` (paper Table II)."""
        if isinstance(factors, dict):
            items = factors.items()
        else:
            items = enumerate(factors)
        for dim, f in items:
            if f and f > 1:
                self.partitions[int(dim)] = (int(f), kind)
        self._psig = None
        return self

    def __repr__(self):
        return f"placeholder({self.name}, {self.shape}, {self.dtype})"


def to_lin(i) -> LinExpr:
    from .dsl import Var, IndexExpr
    if isinstance(i, LinExpr):
        return i
    if isinstance(i, int):
        return LinExpr.cst(i)
    if isinstance(i, Var):
        return LinExpr.var(i.name)
    if isinstance(i, IndexExpr):
        return i.lin
    raise TypeError(f"bad array index {i!r}")


# --------------------------------------------------------------------------
# Statement (one ``compute``) and Function
# --------------------------------------------------------------------------
_stmt_counter = itertools.count()


class Statement:
    """A single ``compute``: iteration domain + body expression + store target.

    ``domain.dims`` is the *current* (possibly transformed) loop order.
    ``iter_subst`` maps each *original* iterator name to a LinExpr over the
    current dims, so load/store index functions stay written against the
    original iterators and are composed lazily.

    Incremental evaluation: the mutable schedule state is exactly
    ``(domain, iter_subst, unrolls, pipeline_at, pipeline_ii, after_spec)``
    — the body/store never change after construction — so
    ``schedule_signature()`` (and the dependence-relevant projection
    ``dep_signature()``) fully determine every derived analysis.  The
    per-statement caches below are keyed on those signatures, recomputed
    from current state on each lookup, so restoring a snapshot or mutating
    a schedule can never serve a stale entry.
    """

    def __init__(self, name: str, domain: BasicSet, body: Expr, store: Load,
                 original_iters: Sequence[str]):
        self.name = name
        self.uid = next(_stmt_counter)
        self.domain = domain
        self.body = body
        self.store = store
        self.original_iters: List[str] = list(original_iters)
        self.iter_subst: Dict[str, LinExpr] = {i: LinExpr.var(i) for i in original_iters}
        # schedule annotations
        self.pipeline_at: Optional[str] = None
        self.pipeline_ii: int = 1
        self.unrolls: Dict[str, int] = {}          # dim -> factor
        # program order: (predecessor statement, shared-level) from `after`
        self.after_spec: Optional[Tuple["Statement", int]] = None
        self.function: Optional["Function"] = None
        # signature-keyed memo tables (see class docstring)
        self._trip_cache: Dict[Tuple, Dict[str, Tuple[int, int]]] = {}
        self._acc_cache: Dict[Tuple, Tuple] = {}
        self._selfdep_cache: Dict[Tuple, list] = {}
        self._legal_cache: Dict[Tuple, bool] = {}
        self._part_cache: Dict[Tuple, list] = {}
        # analytic-transfer state (PR 4): ``_basis_trace`` links each
        # schedule state reached by a transform to its parent state plus
        # the positional basis step applied (``affine.BasisMap`` step) and
        # the trip-bound transfer op; ``_xfer_keys`` marks cache entries
        # whose values came from the transfer algebra rather than FM (the
        # parallel replay-merge and the II counter split both need the
        # origin).  Both are metadata only — results are identical with
        # the trace cleared, just re-derived by FM.
        self._basis_trace: Dict[Tuple, Tuple] = {}
        self._xfer_keys: Dict[str, set] = {
            "selfdep": set(), "trip": set(), "legal": set()}
        # lazily rebuilt by ``subst_signature`` / ``schedule_signature``;
        # every site that mutates a signature component — ``iter_subst``
        # (the transform primitives, ``search._restore``), the domain,
        # unrolls, the pipeline marker, or ``after_spec`` — resets the
        # corresponding slot to None
        self._subst_sig: Optional[Tuple] = None

    # -- schedule signatures ----------------------------------------------------
    def subst_signature(self) -> Tuple:
        """Signature of the change-of-basis map (with the domain, determines
        dependences, legality, and composed access functions)."""
        sig = self._subst_sig
        if sig is None:
            sig = tuple(sorted(
                (k, v.key()) for k, v in self.iter_subst.items()))
            self._subst_sig = sig
        return sig

    def dep_signature(self) -> Tuple:
        return (self.uid, self.domain.key(), self.subst_signature())

    def xfer_sig(self) -> Tuple:
        """The state key the analytic-transfer layer links through: exactly
        what determines self-dependences and legality."""
        return (self.domain.key(), self.subst_signature())

    def is_original_order(self) -> bool:
        """True when the schedule is the untransformed program order (the
        root of every basis trace — legal by construction)."""
        if self.domain.dims != self.original_iters:
            return False
        return all(v.key() == (((k, 1),), 0)
                   for k, v in self.iter_subst.items())

    def record_basis_step(self, parent_sig: Tuple, parent_original: bool,
                          dep_step: Tuple, trip_op: Optional[Tuple]) -> None:
        """Link the current (post-transform) state to its parent with the
        basis step just applied.

        ``trip_op`` is the loop-bound transfer op: ``("split", d, t, d0,
        d1)``, ``("shift", d, c)``, ``("rename", mapping)``, ``("permute",
        new_dims)`` or None (bounds must be re-derived, e.g. after a skew).
        A permute is validated here against the live split-pair set — the
        per-dim bound extraction holds outer dims symbolic, so a (tile,
        intra) pair's constant bounds survive only while the tile dim
        stays outside the intra dim."""
        if not caching.analytic_on():
            return
        new_sig = self.xfer_sig()
        if new_sig == parent_sig or new_sig in self._basis_trace:
            return
        node = self._basis_trace.get(parent_sig)
        pairs = node[3] if node is not None else (() if parent_original else None)
        dep_ok = True
        if trip_op is not None and trip_op[0] == "skew":
            # vectors transfer through a skew only when neither skewed dim
            # is a split sub-dim: a tile dim's zero entry is pinned by
            # *rational rounding* of the coupled t*d0+d1 constraints, and
            # scaling it by the skew factor un-rounds it — FM then reports
            # a free entry where the algebra would predict a constant
            if pairs is None:
                dep_ok = False
            else:
                members = {d for p in pairs for d in p}
                dep_ok = (trip_op[1] not in members
                          and trip_op[2] not in members)
            trip_op, pairs = None, None   # skewed bounds: re-derive by FM
        else:
            order = trip_op[1] if trip_op is not None and trip_op[0] == "permute" else None
            trip_op, pairs = _resolve_trip_op(trip_op, pairs)
            if dep_step[0] == "permute":
                # a permute flipping a (tile, intra) pair puts the same
                # rational relaxation in play: FM only.  So does one that
                # moves another dim between a tile dim and its intra dim:
                # a dependence carried there leaves the intra entry tied to
                # the tile entry only through ``t*d0 + d1``, which FM's
                # constant-bound extraction reports as free ('*') where the
                # algebra pins it (gemm, split(i, 2) then interchange(i_b, k))
                dep_ok = (trip_op is not None
                          and _pairs_contiguous(pairs, order))
        if len(self._basis_trace) >= 8192:
            for k in list(self._basis_trace)[:4096]:
                del self._basis_trace[k]
        self._basis_trace[new_sig] = (parent_sig, dep_step, trip_op, pairs,
                                      parent_original, dep_ok)

    def _walk_trace(self, have, max_depth: int = 16):
        """Walk the basis trace back from the current state to the nearest
        ancestor satisfying ``have(sig, is_original)``; returns
        (root_sig, steps) with ``steps`` as (dep_step, trip_op, dep_ok)
        triples in application order, or None."""
        sig = self.xfer_sig()
        steps = []
        for _ in range(max_depth):
            node = self._basis_trace.get(sig)
            if node is None:
                return None
            parent_sig, dep_step, trip_op, _pairs, parent_orig, dep_ok = node
            steps.append((dep_step, trip_op, dep_ok))
            if have(parent_sig, parent_orig):
                steps.reverse()
                return parent_sig, steps
            sig = parent_sig
        return None

    def schedule_signature(self) -> Tuple:
        """Cheap structural signature of the full schedule state.

        Built live on every call (so raw writes to ``unrolls`` /
        ``pipeline_*`` / ``after_spec`` can never observe a stale value);
        the two expensive components — ``domain.key()`` and
        ``subst_signature()`` — are memoized on their own objects.
        """
        after = (None if self.after_spec is None
                 else (self.after_spec[0].uid, self.after_spec[1]))
        return (self.uid, self.domain.key(), self.subst_signature(),
                tuple(sorted(self.unrolls.items())),
                self.pipeline_at, self.pipeline_ii, after)

    # -- composed access functions -------------------------------------------
    def subst_lin(self, e: LinExpr) -> LinExpr:
        out = LinExpr.cst(e.const)
        for k, v in e.coeffs.items():
            repl = self.iter_subst.get(k, LinExpr.var(k))
            out = out + repl * v
        return out

    def _composed_accesses(self) -> Tuple:
        """(store_access, load_accesses) composed through iter_subst, memoized
        on the substitution signature; LinExprs are interned."""
        if not caching.ENABLED:
            caching.COUNTS["access_evals"] += 1
            return ((self.store.array,
                     tuple(self.subst_lin(i) for i in self.store.idx)),
                    [(ld.array, tuple(self.subst_lin(i) for i in ld.idx))
                     for ld in loads_of(self.body)])
        key = self.subst_signature()
        hit = self._acc_cache.get(key)
        if hit is not None:
            caching.COUNTS["access_hits"] += 1
            return hit
        caching.COUNTS["access_evals"] += 1
        store = (self.store.array,
                 tuple(self.subst_lin(i).interned() for i in self.store.idx))
        loads = [(ld.array, tuple(self.subst_lin(i).interned() for i in ld.idx))
                 for ld in loads_of(self.body)]
        self._acc_cache[key] = (store, loads)
        return store, loads

    def store_access(self) -> Tuple[Placeholder, Tuple[LinExpr, ...]]:
        return self._composed_accesses()[0]

    def load_accesses(self) -> List[Tuple[Placeholder, Tuple[LinExpr, ...]]]:
        return list(self._composed_accesses()[1])

    # -- info -------------------------------------------------------------------
    @property
    def dims(self) -> List[str]:
        return self.domain.dims

    def trip_counts(self) -> Dict[str, int]:
        """Constant trip count per loop dim (domain must be bounded-constant
        once outer dims are fixed; uses point counts for exactness)."""
        return {d: max(0, up - lo + 1)
                for d, (lo, up) in self.dim_bounds().items()}

    def dim_bounds(self) -> Dict[str, Tuple[int, int]]:
        """Constant (lo, up) loop bounds per dim — the quantity trip counts
        derive from and the transfer algebra pushes through splits/shifts.

        Memoized on the domain signature (the FM projections this runs are
        a DSE hot path, re-queried for every candidate schedule); when the
        domain was produced by a recorded basis step, the bounds are
        *transferred* from the parent state instead of re-projected."""
        if not caching.ENABLED:
            caching.COUNTS["trip_evals"] += 1
            return self._dim_bounds_compute()
        key = self.domain.key()
        hit = self._trip_cache.get(key)
        if hit is not None:
            caching.COUNTS["trip_hits"] += 1
            return dict(hit)
        # cross-statement reuse: bounds are positional, so domains equal
        # modulo renaming (3MM's nests, repeated conv layers) share one entry
        from .affine import NameCanon
        ckey = NameCanon().set_key(self.domain)
        bnds = _TRIP_CANON_CACHE.get(ckey)
        if bnds is not None:
            caching.COUNTS["trip_hits"] += 1
            out = {d: b for d, b in zip(self.domain.dims, bnds)
                   if b is not None}
            self._trip_cache[key] = out
            return dict(out)
        out = self._bounds_via_transfer()
        if out is not None:
            caching.COUNTS["trip_transfers"] += 1
            self._trip_cache[key] = out
            self._xfer_keys["trip"].add(key)
            return dict(out)
        caching.COUNTS["trip_evals"] += 1
        out = self._dim_bounds_compute()
        if len(_TRIP_CANON_CACHE) >= _TRIP_CANON_CACHE_MAX:
            _TRIP_CANON_CACHE.clear()
        _TRIP_CANON_CACHE[ckey] = tuple(out.get(d) for d in self.domain.dims)
        self._trip_cache[key] = out
        return dict(out)

    def _dim_bounds_compute(self) -> Dict[str, Tuple[int, int]]:
        out = {}
        s = self.domain
        for i, d in enumerate(s.dims):
            los, ups = s.bounds_of(d, s.dims[i + 1:])
            lo = _cbound(los, True)
            up = _cbound(ups, False)
            if lo is not None and up is not None:
                out[d] = (lo, up)
        return out

    def _bounds_via_transfer(self) -> Optional[Dict[str, Tuple[int, int]]]:
        if not caching.analytic_on():
            return None
        walk = self._walk_trace(lambda sig, _orig: sig[0] in self._trip_cache)
        if walk is None:
            return None
        root_sig, steps = walk
        bounds = self._trip_cache[root_sig[0]]
        for _dep, op, _dep_ok in steps:
            if op is None:
                return None
            bounds = _apply_trip_op(bounds, op)
            if bounds is None:
                return None
        return bounds

    def reduction_dims(self) -> List[str]:
        """Iteration dims absent from the store access (paper Fig. 8(3))."""
        _, idx = self.store_access()
        used = set()
        for e in idx:
            used |= set(e.vars())
        return [d for d in self.dims if d not in used]

    def describe(self) -> str:
        """One-statement dump for the ``POM_DUMP_IR=poly`` stage."""
        lines = [f"{self.name}: domain {self.domain!r}"]
        subst = {k: v for k, v in self.iter_subst.items()
                 if v.key() != LinExpr.var(k).key()}
        if subst:
            lines.append("  subst " + ", ".join(
                f"{k} = {v!r}" for k, v in subst.items()))
        arr, idx = self.store_access()
        lines.append(f"  store {arr.name}[{', '.join(map(repr, idx))}]")
        for a, ix in self.load_accesses():
            lines.append(f"  load  {a.name}[{', '.join(map(repr, ix))}]")
        ann = []
        if self.pipeline_at is not None:
            ann.append(f"pipeline@{self.pipeline_at} II={self.pipeline_ii}")
        for d, f in sorted(self.unrolls.items()):
            ann.append(f"unroll {d}x{f}")
        if self.after_spec is not None:
            ann.append(f"after {self.after_spec[0].name}@{self.after_spec[1]}")
        if ann:
            lines.append("  " + "  ".join(ann))
        return "\n".join(lines)

    def __repr__(self):
        return f"Statement({self.name}, dims={self.dims})"


# name-canonical domain key -> per-dim (lo, up) bounds (None = unbounded)
_TRIP_CANON_CACHE: Dict[Tuple, Tuple] = {}
_TRIP_CANON_CACHE_MAX = 100_000


def _pairs_contiguous(pairs, order: Optional[Sequence[str]]) -> bool:
    """Whether every dim strictly between a (tile, intra) pair's dims in
    ``order`` belongs to the same split family (is itself an intra dim of
    that tile dim)."""
    if pairs is None or order is None:
        return False
    pos = {d: i for i, d in enumerate(order)}
    family: Dict[str, set] = {}
    for a, b in pairs:
        family.setdefault(a, set()).add(b)
    for a, b in pairs:
        if a not in pos or b not in pos:
            continue
        lo, hi = sorted((pos[a], pos[b]))
        if any(order[k] not in family[a] for k in range(lo + 1, hi)):
            return False
    return True


def _resolve_trip_op(op: Optional[Tuple], pairs):
    """Validate/normalize a trip-bound transfer op at record time and push
    the split-pair set forward.  A permutation is checked against the live
    pairs (tile dim must stay outside its intra dim) and normalized to the
    no-op ``("id",)``; an unverifiable op breaks the bound-transfer chain
    (op None), which also poisons the pair set for descendants."""
    if op is None:
        return None, None
    kind = op[0]
    if kind == "chain":
        for sub in op[1]:
            sub_ok, pairs = _resolve_trip_op(sub, pairs)
            if sub_ok is None:
                return None, None
        return op, pairs
    if kind == "split":
        _, d, t, d0, d1 = op
        if pairs is not None:
            np_ = []
            for a, b in pairs:
                if a == d:
                    np_ += [(d0, b), (d1, b)]
                elif b == d:
                    np_ += [(a, d0), (a, d1)]
                else:
                    np_.append((a, b))
            np_.append((d0, d1))
            pairs = tuple(np_)
        return op, pairs
    if kind == "rename":
        mapping = op[1]
        if pairs is not None:
            pairs = tuple((mapping.get(a, a), mapping.get(b, b))
                          for a, b in pairs)
        return op, pairs
    if kind in ("shift", "id"):
        return op, pairs
    if kind == "permute":
        if pairs is None:
            return None, None
        order = {d: i for i, d in enumerate(op[1])}
        if all(a in order and b in order and order[a] < order[b]
               for a, b in pairs):
            return ("id",), pairs
        return None, None
    return None, None


def _apply_trip_op(bounds: Dict[str, Tuple[int, int]],
                   op: Tuple) -> Optional[Dict[str, Tuple[int, int]]]:
    """Apply one recorded loop-bound transfer op (see
    ``Statement.record_basis_step``).  The split formula mirrors exactly
    what FM derives on the substituted domain: the tile dim's constraints
    ``t*d0 + d1 in [lo, up]`` with ``d1 in [0, t-1]`` eliminate to
    ``d0 in [ceil((lo - t + 1)/t), floor(up/t)]`` after gcd tightening,
    and the intra dim keeps its pure-constant ``[0, t-1]`` range."""
    from .affine import ceil_div, floor_div
    kind = op[0]
    if kind == "id":
        return bounds
    if kind == "chain":
        for sub in op[1]:
            bounds = _apply_trip_op(bounds, sub)
            if bounds is None:
                return None
        return bounds
    if kind == "split":
        _, d, t, d0, d1 = op
        if d not in bounds:
            return None
        lo, up = bounds[d]
        nb = {k: v for k, v in bounds.items() if k != d}
        nb[d0] = (ceil_div(lo - t + 1, t), floor_div(up, t))
        nb[d1] = (0, t - 1)
        return nb
    if kind == "shift":
        _, d, c = op
        nb = dict(bounds)
        if d in nb:
            lo, up = nb[d]
            nb[d] = (lo + c, up + c)
        return nb
    if kind == "rename":
        m = op[1]
        return {m.get(d, d): v for d, v in bounds.items()}
    return None


def _cbound(bs, is_lower):
    from .affine import ceil_div, floor_div
    best = None
    for b in bs:
        if b.expr.is_const():
            v = ceil_div(b.expr.const, b.div) if is_lower else floor_div(b.expr.const, b.div)
            best = v if best is None else (max(best, v) if is_lower else min(best, v))
    return best


class Function:
    """A POM function: an ordered collection of computes + placeholders."""

    def __init__(self, name: str):
        self.name = name
        self.statements: List[Statement] = []
        self.placeholders: Dict[str, Placeholder] = {}
        # task-level pipelining toggle: None follows the POM_DATAFLOW
        # environment default; True/False is an explicit per-function
        # decision (DSL toggle, compile(dataflow=...), or the stage-2
        # dataflow search step).  See graph_ir.dataflow_effective.
        self.dataflow: Optional[bool] = None

    def add(self, stmt: Statement):
        stmt.function = self
        self.statements.append(stmt)
        ph, _ = stmt.store_access()
        self.placeholders.setdefault(ph.name, ph)
        for arr, _ in stmt.load_accesses():
            self.placeholders.setdefault(arr.name, arr)

    def stmt(self, name: str) -> Statement:
        for s in self.statements:
            if s.name == name:
                return s
        raise KeyError(name)

    def describe(self) -> str:
        parts = [f"function {self.name}"]
        for ph in self.placeholders.values():
            p = ""
            if ph.partitions:
                p = "  partition " + ", ".join(
                    f"dim{d}:{k}x{f}" for d, (f, k) in sorted(ph.partitions.items()))
            parts.append(f"  {ph.name}: {ph.dtype} {list(ph.shape)}{p}")
        for s in self.statements:
            parts.append("\n".join("  " + ln for ln in s.describe().splitlines()))
        return "\n".join(parts)

    def __repr__(self):
        return f"Function({self.name}, {[s.name for s in self.statements]})"
