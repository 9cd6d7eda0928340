"""Mini-isl: integer sets, affine maps, and Fourier-Motzkin elimination.

This module is the polyhedral substrate of POM's *polyhedral IR* layer
(paper SS V-B).  It implements the subset of isl that POM relies on:

  * ``LinExpr``    -- affine expressions over named dimensions + parameters.
  * ``Constraint`` -- ``expr >= 0`` or ``expr == 0``.
  * ``BasicSet``   -- a conjunction of affine constraints over an *ordered*
                      list of dimensions (order == loop-nest order).
  * Fourier-Motzkin elimination (rational, with gcd tightening on integer
    bounds) for projection, emptiness tests, and per-dimension loop-bound
    derivation (the ``ast_build`` analogue).
  * Dependence polyhedra construction + distance/direction vector
    extraction (used by the dependence-graph IR, paper SS V-A).

All arithmetic is exact (Python ints / Fractions).  Loop bounds involving a
coefficient > 1 are returned as (expr, divisor) pairs so the AST builder can
emit ``floordiv``/``ceildiv`` -- exactly what isl's AST build does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import caching


# --------------------------------------------------------------------------
# Affine expressions
# --------------------------------------------------------------------------
class LinExpr:
    """Affine expression: sum(coeff[d] * d) + const, integer coefficients.

    Instances are immutable by convention (no method mutates ``coeffs`` or
    ``const`` after construction); ``key()`` is therefore computed once and
    cached, and ``interned()`` hash-conses equal expressions onto a single
    canonical instance so schedule signatures and composed access functions
    share storage across DSE candidates.
    """

    __slots__ = ("coeffs", "const", "_key")

    def __init__(self, coeffs: Optional[Dict[str, int]] = None, const: int = 0):
        self.coeffs: Dict[str, int] = {k: int(v) for k, v in (coeffs or {}).items() if v != 0}
        self.const: int = int(const)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def var(name: str, coeff: int = 1) -> "LinExpr":
        return LinExpr({name: coeff})

    @staticmethod
    def cst(c: int) -> "LinExpr":
        return LinExpr({}, c)

    @staticmethod
    def of(x) -> "LinExpr":
        if isinstance(x, LinExpr):
            return x
        if isinstance(x, int):
            return LinExpr.cst(x)
        if isinstance(x, str):
            return LinExpr.var(x)
        raise TypeError(f"cannot build LinExpr from {x!r}")

    # -- arithmetic ----------------------------------------------------------
    def __add__(self, other) -> "LinExpr":
        o = LinExpr.of(other)
        c = dict(self.coeffs)
        for k, v in o.coeffs.items():
            c[k] = c.get(k, 0) + v
        return LinExpr(c, self.const + o.const)

    __radd__ = __add__

    def __neg__(self) -> "LinExpr":
        return LinExpr({k: -v for k, v in self.coeffs.items()}, -self.const)

    def __sub__(self, other) -> "LinExpr":
        return self + (-LinExpr.of(other))

    def __rsub__(self, other) -> "LinExpr":
        return LinExpr.of(other) + (-self)

    def __mul__(self, k: int) -> "LinExpr":
        if not isinstance(k, int):
            raise TypeError("LinExpr may only be scaled by an int")
        return LinExpr({d: v * k for d, v in self.coeffs.items()}, self.const * k)

    __rmul__ = __mul__

    # -- queries -------------------------------------------------------------
    def coeff(self, name: str) -> int:
        return self.coeffs.get(name, 0)

    def vars(self) -> Tuple[str, ...]:
        return tuple(self.coeffs.keys())

    def is_const(self) -> bool:
        return not self.coeffs

    def substitute(self, name: str, repl: "LinExpr") -> "LinExpr":
        c = self.coeffs.get(name, 0)
        if c == 0:
            return self
        rest = LinExpr({k: v for k, v in self.coeffs.items() if k != name}, self.const)
        return rest + repl * c

    def rename(self, mapping: Dict[str, str]) -> "LinExpr":
        return LinExpr({mapping.get(k, k): v for k, v in self.coeffs.items()}, self.const)

    def eval(self, env: Dict[str, int]) -> int:
        return self.const + sum(v * env[k] for k, v in self.coeffs.items())

    def content(self) -> int:
        """gcd of all coefficients and the constant (0 if identically zero)."""
        g = 0
        for v in self.coeffs.values():
            g = math.gcd(g, abs(v))
        return math.gcd(g, abs(self.const))

    def interned(self) -> "LinExpr":
        """Canonical shared instance for this expression's value."""
        k = self.key()
        e = _INTERN.get(k)
        if e is None:
            if len(_INTERN) >= _INTERN_MAX:
                _INTERN.clear()
            _INTERN[k] = self
            return self
        return e

    # -- hash/eq/repr ---------------------------------------------------------
    def key(self) -> Tuple:
        try:
            return self._key
        except AttributeError:
            k = (tuple(sorted(self.coeffs.items())), self.const)
            self._key = k
            return k

    def __eq__(self, other) -> bool:
        return isinstance(other, LinExpr) and self.key() == other.key()

    def __hash__(self) -> int:
        return hash(self.key())

    def __repr__(self) -> str:
        parts = []
        for k in sorted(self.coeffs):
            v = self.coeffs[k]
            if v == 1:
                parts.append(f"{k}")
            elif v == -1:
                parts.append(f"-{k}")
            else:
                parts.append(f"{v}*{k}")
        if self.const or not parts:
            parts.append(str(self.const))
        s = " + ".join(parts).replace("+ -", "- ")
        return s


# hash-consing table for LinExpr.interned(); cleared when full so long-lived
# processes building many programs don't accumulate expressions forever
_INTERN: Dict[Tuple, "LinExpr"] = {}
_INTERN_MAX = 200_000


# --------------------------------------------------------------------------
# Constraints
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Constraint:
    """expr >= 0 (ineq) or expr == 0 (eq)."""

    expr: LinExpr
    is_eq: bool = False

    def normalized(self) -> "Constraint":
        g = self.expr.content()
        if g <= 1:
            return self
        if self.is_eq:
            if self.expr.const % g == 0:
                e = LinExpr({k: v // g for k, v in self.expr.coeffs.items()},
                            self.expr.const // g)
                return Constraint(e, True)
            return self  # leave: may be infeasible (caught by gcd test)
        # inequality sum(c_i x_i) + c0 >= 0  ->  divide coeffs by g', tighten const
        gc = 0
        for v in self.expr.coeffs.values():
            gc = math.gcd(gc, abs(v))
        if gc > 1:
            e = LinExpr({k: v // gc for k, v in self.expr.coeffs.items()},
                        math.floor(Fraction(self.expr.const, gc)))
            return Constraint(e, False)
        return self

    def substitute(self, name: str, repl: LinExpr) -> "Constraint":
        return Constraint(self.expr.substitute(name, repl), self.is_eq)

    def rename(self, mapping: Dict[str, str]) -> "Constraint":
        return Constraint(self.expr.rename(mapping), self.is_eq)

    def involves(self, name: str) -> bool:
        return self.expr.coeff(name) != 0

    def holds(self, env: Dict[str, int]) -> bool:
        v = self.expr.eval(env)
        return v == 0 if self.is_eq else v >= 0

    def key(self) -> Tuple:
        return (self.expr.key(), self.is_eq)

    def __repr__(self) -> str:
        return f"{self.expr} {'==' if self.is_eq else '>='} 0"


def ge(lhs, rhs) -> Constraint:
    """lhs >= rhs"""
    return Constraint(LinExpr.of(lhs) - LinExpr.of(rhs))


def le(lhs, rhs) -> Constraint:
    """lhs <= rhs"""
    return Constraint(LinExpr.of(rhs) - LinExpr.of(lhs))


def eq(lhs, rhs) -> Constraint:
    return Constraint(LinExpr.of(lhs) - LinExpr.of(rhs), True)


# --------------------------------------------------------------------------
# Bounds (for AST build): expr/divisor pairs
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Bound:
    """A loop bound:  ceil(expr/div) for lower bounds, floor(expr/div) for upper."""

    expr: LinExpr
    div: int = 1

    def __repr__(self) -> str:
        if self.div == 1:
            return repr(self.expr)
        return f"({self.expr})/{self.div}"


# --------------------------------------------------------------------------
# BasicSet
# --------------------------------------------------------------------------
class BasicSet:
    """Conjunction of affine constraints over ordered dims (+ named params).

    ``dims`` order is semantically meaningful: it is the loop-nest order used
    by the AST builder.  ``params`` are symbolic constants (problem sizes).
    """

    def __init__(self, dims: Sequence[str], constraints: Iterable[Constraint] = (),
                 params: Sequence[str] = ()):
        self.dims: List[str] = list(dims)
        self.params: List[str] = list(params)
        self.constraints: List[Constraint] = [c.normalized() for c in constraints]
        self._key: Optional[Tuple] = None

    def key(self) -> Tuple:
        """Structural signature: dim order + params + constraint *multiset*.

        All set transforms build fresh BasicSets (no in-place mutation), so
        the key is computed once per instance.  The constraint list is
        sorted: two sets describing the same polyhedron in the same dim
        order get the same key even if constraint order differs, and every
        bound/dependence query derives max/min over constraints and is thus
        order-independent.
        """
        if self._key is None:
            self._key = (tuple(self.dims), tuple(self.params),
                         tuple(sorted(c.key() for c in self.constraints)))
        return self._key

    # -- construction helpers -------------------------------------------------
    @staticmethod
    def box(bounds: Dict[str, Tuple[int, int]], params: Sequence[str] = ()) -> "BasicSet":
        """{dims : lo <= d <= hi} (inclusive)."""
        cons = []
        for d, (lo, hi) in bounds.items():
            cons.append(ge(LinExpr.var(d), lo))
            cons.append(le(LinExpr.var(d), hi))
        return BasicSet(list(bounds.keys()), cons, params)

    def copy(self) -> "BasicSet":
        return BasicSet(self.dims, self.constraints, self.params)

    def with_constraints(self, extra: Iterable[Constraint]) -> "BasicSet":
        return BasicSet(self.dims, list(self.constraints) + list(extra), self.params)

    # -- transforms ------------------------------------------------------------
    def rename_dim(self, old: str, new: str) -> "BasicSet":
        mapping = {old: new}
        dims = [new if d == old else d for d in self.dims]
        return BasicSet(dims, [c.rename(mapping) for c in self.constraints], self.params)

    def substitute_dim(self, name: str, repl: LinExpr, new_dims: Sequence[str],
                       extra: Iterable[Constraint] = ()) -> "BasicSet":
        """Replace dim ``name`` by expression ``repl`` over ``new_dims``.

        ``new_dims`` take name's position in the dim order.
        """
        i = self.dims.index(name)
        dims = self.dims[:i] + list(new_dims) + self.dims[i + 1:]
        cons = [c.substitute(name, repl) for c in self.constraints]
        cons += list(extra)
        return BasicSet(dims, cons, self.params)

    def permute(self, order: Sequence[str]) -> "BasicSet":
        assert sorted(order) == sorted(self.dims), (order, self.dims)
        return BasicSet(list(order), self.constraints, self.params)

    # -- FM elimination ----------------------------------------------------------
    def project_out(self, name: str) -> "BasicSet":
        """Rational Fourier-Motzkin elimination of ``name`` (sound for
        emptiness / bound queries; exact on the rational relaxation)."""
        eqs = [c for c in self.constraints if c.is_eq and c.involves(name)]
        if eqs:
            # use an equality to substitute name away:  a*name + rest == 0
            c0 = eqs[0]
            a = c0.expr.coeff(name)
            rest = LinExpr({k: v for k, v in c0.expr.coeffs.items() if k != name},
                           c0.expr.const)
            out = []
            for c in self.constraints:
                if c is c0:
                    continue
                b = c.expr.coeff(name)
                if b == 0:
                    out.append(c)
                    continue
                # a*c.expr - b*(a*name + rest)  eliminates name; careful with sign of a
                scaled = c.expr * abs(a) - (LinExpr.var(name, a) + rest) * (
                    b if a > 0 else -b)
                out.append(Constraint(scaled, c.is_eq).normalized())
            dims = [d for d in self.dims if d != name]
            return BasicSet(dims, out, self.params)

        lowers, uppers, others = [], [], []
        for c in self.constraints:
            a = c.expr.coeff(name)
            if a == 0:
                others.append(c)
            elif a > 0:
                lowers.append((a, c.expr))   # a*name + e >= 0 -> name >= -e/a
            else:
                uppers.append((-a, c.expr))  # -b*name + e >= 0 -> name <= e/b
        for (a, el) in lowers:
            for (b, eu) in uppers:
                # combine: b*el + a*eu >= 0 with name eliminated
                combo = el * b + eu * a
                combo = LinExpr({k: v for k, v in combo.coeffs.items() if k != name},
                                combo.const)
                others.append(Constraint(combo).normalized())
        dims = [d for d in self.dims if d != name]
        return BasicSet(dims, others, self.params)

    def project_onto(self, keep: Sequence[str]) -> "BasicSet":
        s = self
        for d in list(self.dims):
            if d not in keep:
                s = s.project_out(d)
        return s

    # -- queries ---------------------------------------------------------------
    def is_empty(self) -> bool:
        """Rational emptiness + gcd infeasibility on equalities.

        Conservative in the usual direction: returns True only when provably
        empty over the rationals (or gcd-infeasible), which is exact for the
        structured sets POM generates.
        """
        # gcd test on equalities
        for c in self.constraints:
            if c.is_eq:
                g = 0
                for v in c.expr.coeffs.values():
                    g = math.gcd(g, abs(v))
                if g and c.expr.const % g != 0:
                    return True
                if not c.expr.coeffs and c.expr.const != 0:
                    return True
            else:
                if not c.expr.coeffs and c.expr.const < 0:
                    return True
        s = self
        for d in list(s.dims) + list(s.params):
            s = s.project_out(d)
            for c in s.constraints:
                if not c.expr.coeffs:
                    if c.is_eq and c.expr.const != 0:
                        return True
                    if not c.is_eq and c.expr.const < 0:
                        return True
        return False

    def bounds_of(self, name: str, inner: Sequence[str]) -> Tuple[List[Bound], List[Bound]]:
        """Loop bounds of ``name`` in terms of outer dims/params.

        Projects out the dims *inner* (nested inside ``name``), then reads the
        lower/upper bounds on ``name``.  Returns (lowers, uppers) as Bound
        lists; lower bound value is max(ceildiv(b.expr, b.div)), upper is
        min(floordiv(b.expr, b.div)).
        """
        s = self
        for d in inner:
            s = s.project_out(d)
        lowers: List[Bound] = []
        uppers: List[Bound] = []
        for c in s.constraints:
            a = c.expr.coeff(name)
            if a == 0:
                continue
            rest = LinExpr({k: v for k, v in c.expr.coeffs.items() if k != name},
                           c.expr.const)
            cons_list = [(a, rest)]
            if c.is_eq:
                cons_list = [(a, rest), (-a, -rest)]
            for (aa, rr) in cons_list:
                if aa > 0:   # aa*name + rr >= 0  ->  name >= ceil(-rr/aa)
                    lowers.append(Bound(-rr, aa))
                else:        # name <= floor(rr/|aa|)
                    uppers.append(Bound(rr, -aa))
        return dedup_bounds(lowers), dedup_bounds(uppers)

    def constraints_on(self, names: Sequence[str]) -> List[Constraint]:
        keep = set(names)
        return [c for c in self.constraints
                if any(k in keep for k in c.expr.vars())]

    def contains(self, env: Dict[str, int]) -> bool:
        return all(c.holds(env) for c in self.constraints)

    def enumerate_points(self, param_env: Optional[Dict[str, int]] = None,
                         limit: int = 2_000_000) -> List[Tuple[int, ...]]:
        """Enumerate all integer points in dim order (testing oracle)."""
        env = dict(param_env or {})
        pts: List[Tuple[int, ...]] = []

        def rec(i: int):
            if len(pts) > limit:
                raise RuntimeError("enumeration limit exceeded")
            if i == len(self.dims):
                pts.append(tuple(env[d] for d in self.dims))
                return
            d = self.dims[i]
            los, ups = self.bounds_of(d, self.dims[i + 1:])
            lo = max(ceil_div(b.expr.eval(env), b.div) for b in los) if los else None
            up = min(floor_div(b.expr.eval(env), b.div) for b in ups) if ups else None
            if lo is None or up is None:
                raise RuntimeError(f"dim {d} unbounded")
            for v in range(lo, up + 1):
                env[d] = v
                # guard against rational-relaxation slack: check constraints
                ok = True
                for c in self.constraints:
                    if set(c.expr.vars()) <= set(self.dims[:i + 1]) | set(self.params):
                        if not c.holds(env):
                            ok = False
                            break
                if ok:
                    rec(i + 1)
            env.pop(d, None)

        rec(0)
        return pts

    def __repr__(self) -> str:
        return ("{ [" + ", ".join(self.dims) + "] : "
                + " and ".join(map(repr, self.constraints)) + " }")


def dedup_bounds(bs: List[Bound]) -> List[Bound]:
    seen = set()
    out = []
    for b in bs:
        k = (b.expr.key(), b.div)
        if k not in seen:
            seen.add(k)
            out.append(b)
    return out


def ceil_div(a: int, b: int) -> int:
    return -((-a) // b)


def floor_div(a: int, b: int) -> int:
    return a // b


# --------------------------------------------------------------------------
# Name-canonical structural keys (cross-statement memoization)
# --------------------------------------------------------------------------
class NameCanon:
    """Maps names to dense ids in first-seen order, producing structural keys
    that are invariant under dim/param renaming.  Two statements that differ
    only in iterator names (3MM's s1/s2/s3, repeated conv layers) therefore
    share one cache entry for every polyhedral query, since all query
    results (distances, directions, legality, trip counts) are positional.
    """

    __slots__ = ("ids",)

    def __init__(self):
        self.ids: Dict[str, int] = {}

    def id(self, name: str) -> int:
        i = self.ids.get(name)
        if i is None:
            i = len(self.ids)
            self.ids[name] = i
        return i

    def expr(self, e: LinExpr) -> Tuple:
        return (tuple(sorted((self.id(k), v) for k, v in e.coeffs.items())),
                e.const)

    def set_key(self, s: "BasicSet") -> Tuple:
        dims = tuple(self.id(d) for d in s.dims)
        params = tuple(self.id(p) for p in s.params)
        cons = tuple(sorted((self.expr(c.expr), c.is_eq) for c in s.constraints))
        return (dims, params, cons)


# --------------------------------------------------------------------------
# Dependence analysis on polyhedra
# --------------------------------------------------------------------------
@dataclass
class DependenceInfo:
    """Result of a dependence test between two access functions.

    distance[k] is an int when the k-th entry of the distance vector is a
    single constant over the whole dependence polyhedron, else None.
    direction[k] in {'<', '=', '>', '*'} summarizes sign information.
    ``levels`` maps each 1-based carried level to the distance vector of the
    dependences carried at exactly that level (a polyhedron usually carries
    dependences at several levels — e.g. Seidel carries at t, i AND j).
    ``exists`` is False when the dependence polyhedron is empty.

    ``classes`` is the transfer-algebra view of ``levels``: per carried
    level, a tuple of per-entry *states* (see ``BasisMap``) precise enough
    to push the whole info through an affine change of basis without
    re-running Fourier–Motzkin.  ``None`` when the polyhedron does not fit
    the supported state algebra — such infos always fall back to FM.
    """

    exists: bool
    distance: Tuple[Optional[int], ...] = ()
    direction: Tuple[str, ...] = ()
    loop_carried_level: Optional[int] = None  # outermost carried level
    levels: Dict[int, Tuple[Optional[int], ...]] = field(default_factory=dict)
    classes: Optional[Tuple] = None           # transferable class states

    def is_uniform(self) -> bool:
        return self.exists and all(d is not None for d in self.distance)

    def transform(self, basis: "BasisMap") -> Optional["DependenceInfo"]:
        """Push this dependence through an affine change of basis.

        Returns the info FM would compute on the transformed domain, or
        ``None`` when the transfer is not exact (the caller then falls
        back to the FM path).  A transfer is refused outright when any
        dependence class would become lexicographically non-positive —
        that is a *reordered* dependence, i.e. an illegal transform, and
        the transformed statement's own dependence set is then not a
        transfer of this one (use ``transfer_legality`` for the verdict).
        """
        if not self.exists or self.classes is None:
            return None
        classes = _fold_steps(self.classes, basis)
        if classes is None or any(rev for (_, rev, _) in classes):
            return None
        return _classes_to_info(classes, basis.n_out)


_DEPVEC_CACHE: Dict[Tuple, DependenceInfo] = {}
_DEPVEC_CACHE_MAX = 200_000


def _depvec_cache_limit() -> int:
    """Effective depvec cache bound: ``POM_DEPVEC_CACHE_MAX`` when set
    (tests use a tiny bound to force mid-search eviction), else the
    module attribute (which tests may also monkeypatch directly)."""
    import os
    raw = os.environ.get("POM_DEPVEC_CACHE_MAX")
    if raw:
        try:
            return max(2, int(raw))
        except ValueError:
            pass
    return _DEPVEC_CACHE_MAX


def _evict_half(cache: Dict) -> None:
    """Drop the older half of a memo table (insertion order) instead of
    clearing it: mid-search overflow keeps the recent working set warm."""
    for k in list(cache.keys())[: len(cache) // 2]:
        del cache[k]


def dependence_vector(domain_src: BasicSet, acc_src: Sequence[LinExpr],
                      domain_sink: BasicSet, acc_sink: Sequence[LinExpr],
                      shared_levels: Optional[int] = None) -> DependenceInfo:
    """Distance/direction vectors of the dependence  src -> sink.

    Both domains must have the same dim count for distance vectors to make
    sense (POM computes them per loop nest, where src/sink are statements in
    the same nest or the nest is compared level-wise).  ``shared_levels``
    limits the comparison to the outermost n common loops (defaults to
    min(#dims)).

    Builds {(s, t) : acc_src(s) == acc_sink(t), s in D_src, t in D_sink,
    s lexicographically < t (per level)} and projects onto d = t - s.

    Memoized under a *name-canonical* key: the result is positional
    (distance/direction/level tuples), so any two queries that are equal
    after renaming dims/params share one entry.  The returned
    DependenceInfo is a shared read-only instance.
    """
    n = shared_levels or min(len(domain_src.dims), len(domain_sink.dims))
    key = None
    if caching.ENABLED:
        c = NameCanon()
        key = (c.set_key(domain_src), tuple(c.expr(e) for e in acc_src),
               c.set_key(domain_sink), tuple(c.expr(e) for e in acc_sink), n)
        hit = _DEPVEC_CACHE.get(key)
        if hit is not None:
            return hit
    info = _dependence_vector_compute(domain_src, acc_src, domain_sink,
                                      acc_sink, n)
    if key is not None:
        if len(_DEPVEC_CACHE) >= _depvec_cache_limit():
            _evict_half(_DEPVEC_CACHE)
        _DEPVEC_CACHE[key] = info
    return info


def _dependence_vector_compute(domain_src: BasicSet, acc_src: Sequence[LinExpr],
                               domain_sink: BasicSet, acc_sink: Sequence[LinExpr],
                               n: int) -> DependenceInfo:
    sdims = [f"__s{i}" for i in range(len(domain_src.dims))]
    tdims = [f"__t{i}" for i in range(len(domain_sink.dims))]
    smap = dict(zip(domain_src.dims, sdims))
    tmap = dict(zip(domain_sink.dims, tdims))
    cons: List[Constraint] = []
    cons += [c.rename(smap) for c in domain_src.constraints]
    cons += [c.rename(tmap) for c in domain_sink.constraints]
    if len(acc_src) != len(acc_sink):
        return DependenceInfo(False)
    for ea, eb in zip(acc_src, acc_sink):
        cons.append(Constraint(ea.rename(smap) - eb.rename(tmap), True))

    ddims = [f"__d{i}" for i in range(n)]
    for i in range(n):
        cons.append(eq(LinExpr.var(ddims[i]),
                       LinExpr.var(tdims[i]) - LinExpr.var(sdims[i])))

    params = sorted(set(domain_src.params) | set(domain_sink.params))
    full = BasicSet(sdims + tdims + ddims, cons, params)

    # Lexicographic positivity: union over levels l of {d1=..=d_{l-1}=0, d_l>=1}
    # plus the same-iteration case for intra-statement (excluded: needs >=1 somewhere).
    distance: List[Optional[int]] = [None] * n
    direction: List[str] = ["*"] * n
    carried: Optional[int] = None
    levels: Dict[int, Tuple[Optional[int], ...]] = {}
    level_bounds: Dict[int, Tuple[Tuple[Optional[int], Optional[int]], ...]] = {}
    any_exists = False
    for lvl in range(n):
        lc = [eq(LinExpr.var(ddims[j]), 0) for j in range(lvl)]
        lc.append(ge(LinExpr.var(ddims[lvl]), 1))
        sub = full.with_constraints(lc)
        if sub.is_empty():
            continue
        any_exists = True
        if carried is None:
            carried = lvl + 1
        proj = sub.project_onto(ddims)
        lvl_dist: List[Optional[int]] = [0] * lvl + [None] * (n - lvl)
        lvl_b: List[Tuple[Optional[int], Optional[int]]] = [(0, 0)] * lvl
        for k in range(lvl, n):
            los_l, ups_l = proj.bounds_of(ddims[k], [d for d in ddims[k + 1:]])
            lo_l = _const_bound(los_l, proj.params, True)
            up_l = _const_bound(ups_l, proj.params, False)
            lvl_b.append((lo_l, up_l))
            if lo_l is not None and up_l is not None and lo_l == up_l:
                lvl_dist[k] = lo_l
            elif lo_l is not None and lo_l >= 1:
                lvl_dist[k] = lo_l
            elif up_l is not None and up_l <= -1:
                lvl_dist[k] = up_l
        levels[lvl + 1] = tuple(lvl_dist)
        level_bounds[lvl + 1] = tuple(lvl_b)
        for k in range(n):
            los, ups = proj.bounds_of(ddims[k], [d for d in ddims[k + 1:]])
            lo = _const_bound(los, proj.params, True)
            up = _const_bound(ups, proj.params, False)
            if lo is not None and up is not None and lo == up:
                dk = lo
            elif lo is not None and lo >= 1:
                # non-uniform positive entry: report the *minimum* distance —
                # the paper's convention for reductions (Fig. 8: GEMM ->
                # (0,0,1)) and the quantity recurrence-II analysis needs.
                dk = lo
            elif up is not None and up <= -1:
                dk = up
            else:
                dk = None
            # merge across levels: keep if consistent
            if distance[k] is None and direction[k] == "*":
                distance[k] = dk
                if dk is not None:
                    direction[k] = "<" if dk > 0 else ("=" if dk == 0 else ">")
                elif lo is not None and lo >= 1:
                    direction[k] = "<"
                elif up is not None and up <= -1:
                    direction[k] = ">"
                elif lo is not None and up is not None and lo == up == 0:
                    direction[k] = "="
                else:
                    direction[k] = "*"
            else:
                if distance[k] != dk:
                    distance[k] = None
                    direction[k] = "*"
    if not any_exists:
        return DependenceInfo(False)
    return DependenceInfo(True, tuple(distance), tuple(direction), carried,
                          levels, _classify_classes(level_bounds, n))


def _const_bound(bs: List[Bound], params: Sequence[str], is_lower: bool) -> Optional[int]:
    """Extract the tightest constant bound from a Bound list, if any."""
    best: Optional[int] = None
    for b in bs:
        if b.expr.is_const():
            v = ceil_div(b.expr.const, b.div) if is_lower else floor_div(b.expr.const, b.div)
            if best is None:
                best = v
            else:
                best = max(best, v) if is_lower else min(best, v)
    return best


# --------------------------------------------------------------------------
# Analytic dependence transfer: change-of-basis algebra on dependence vectors
# --------------------------------------------------------------------------
# A dependence polyhedron's per-level distance vectors fit a tiny per-entry
# state algebra for the access patterns POM's dependence test produces (one
# store paired with one load, both affine over a shared iteration space):
#
#   'Z'       entry is 0 on the whole polyhedron (pinned by an access
#             equality, or genuinely single-valued)
#   ('C', d)  entry is the constant d != 0 on the whole polyhedron
#   'LZ'      entry is 0 on this class only because the class's carried-
#             level slice pins it (other classes of the same info carry a
#             nonzero there)
#   'P'       the class's carried entry: reported minimum distance 1, free
#             above (the canonical reduction/recurrence shape)
#   'F'       free: FM reports no constant (None)
#
# A class is (carried_pos, reversed, entries).  ``reversed`` marks a class
# whose transfer produced a lexicographically negative leading entry — an
# illegal (order-reversing) basis change; legality transfer consumes the
# flag, dependence transfer refuses it.
#
# The transfer of each primitive basis step below is written to reproduce
# *exactly* what ``_dependence_vector_compute`` reports on the transformed
# domain — including its reporting quirks (a split sub-dim of an eq-pinned
# entry reports None because its bound is coupled to an earlier dim the
# per-entry bound extraction keeps symbolic; a min-distance carried entry
# splits into a tile-level class and an intra-tile class for every factor).
# Anything outside the verified algebra returns None and falls back to FM;
# the differential tests in ``tests/test_dep_transfer.py`` pin the
# equivalence on every workload family.
def _classify_classes(level_bounds: Dict[int, Tuple], n: int) -> Optional[Tuple]:
    """Translate per-level FM const bounds into transferable class states."""
    if not level_bounds:
        return None
    pinned_zero = [all(b[k] == (0, 0) for b in level_bounds.values())
                   for k in range(n)]
    classes = []
    for lvl in sorted(level_bounds):
        c = lvl - 1
        bnds = level_bounds[lvl]
        entries: List = []
        for k, (lo, up) in enumerate(bnds):
            if k == c:
                # carried entry: support only the canonical min-1 shape;
                # an exact carried constant cannot be told apart from an
                # extent-forced [1,1] range, so both fall back to FM
                if lo == 1 and (up is None or up > 1):
                    entries.append("P")
                else:
                    return None
            elif k < c:
                if (lo, up) != (0, 0):
                    return None
                entries.append("Z" if pinned_zero[k] else "LZ")
            else:
                if lo is not None and lo == up:
                    entries.append("Z" if lo == 0 else ("C", lo))
                elif (lo is not None and lo >= 1) or (up is not None and up <= -1):
                    return None          # one-sided non-constant summary
                else:
                    entries.append("F")
        classes.append((c, False, tuple(entries)))
    return tuple(classes)


def _entry_reported(state) -> Optional[int]:
    if state == "Z" or state == "LZ":
        return 0
    if state == "P":
        return 1
    if state == "F":
        return None
    return state[1]                      # ('C', d)


class BasisMap:
    """Composition of primitive affine changes of basis on a dim list.

    Built by the loop transforms (``transforms.py``) as they mutate a
    statement's domain; consumed by ``DependenceInfo.transform`` /
    ``transfer_trip_bounds`` / ``transfer_legality`` to carry analysis
    facts across the transform instead of re-deriving them.

    Steps (all positional — names never appear, so transferred facts stay
    valid under the name-canonical memo tables):

      ('permute', perm)        perm[i] = old position at new position i
      ('split', pos, t)        dim at pos -> (pos: tile, pos+1: intra, t)
      ('skew', src, dst, f)    entry[dst] += f * entry[src]
      ('shift',) / ('rename',) identity on dependence vectors
    """

    __slots__ = ("n_in", "n_out", "steps")

    def __init__(self, n_in: int, steps: Sequence[Tuple] = ()):
        self.n_in = n_in
        self.steps: Tuple[Tuple, ...] = tuple(steps)
        n = n_in
        for st in self.steps:
            if st[0] == "split":
                n += 1
        self.n_out = n

    def then(self, step: Tuple) -> "BasisMap":
        return BasisMap(self.n_in, self.steps + (step,))

    def __repr__(self) -> str:
        return f"BasisMap({self.n_in}->{self.n_out}, {list(self.steps)})"


def _fold_steps(classes: Tuple, basis: "BasisMap") -> Optional[Tuple]:
    """Push a class set through every step of a basis map; None on the
    first step the algebra cannot express exactly.  Shared by dependence
    transfer and legality transfer so the two can never desynchronize on
    step handling — they differ only in how they read the rev flags."""
    for step in basis.steps:
        classes = _transfer_step(classes, step)
        if classes is None:
            return None
    return classes


def _transfer_step(classes: Tuple, step: Tuple) -> Optional[Tuple]:
    kind = step[0]
    if kind in ("shift", "rename"):
        return classes
    if kind == "permute":
        return _transfer_permute(classes, step[1])
    if kind == "split":
        return _transfer_split(classes, step[1], step[2])
    if kind == "skew":
        return _transfer_skew(classes, step[1], step[2], step[3])
    return None


def _transfer_permute(classes: Tuple, perm: Sequence[int]) -> Optional[Tuple]:
    out = []
    seen = set()
    for carried, rev, entries in classes:
        new_entries = tuple(entries[p] for p in perm)
        pos = None
        new_rev = False
        for i, st in enumerate(new_entries):
            if st == "Z":
                continue
            if st == "LZ":
                # slice-pinned zero: sound to skip only while it stays on
                # the pinned side of the carried entry; moved after it, the
                # new slice no longer pins it and the class merges with
                # parts of its siblings — not expressible here
                continue
            if st == "F":
                return None              # class splits by this entry's sign
            if st == "P":
                pos = i
                break
            d = st[1]
            pos = i
            new_rev = d < 0
            break
        if pos is None:
            return None
        if any(new_entries[i] == "LZ" for i in range(pos + 1, len(new_entries))):
            return None
        key = (pos, new_rev)
        if key in seen:
            return None                  # two classes merge at one level
        seen.add(key)
        out.append((pos, rev or new_rev, new_entries))
    return tuple(out)


def _transfer_split(classes: Tuple, pos: int, t: int) -> Optional[Tuple]:
    out = []
    seen = set()
    for carried, rev, entries in classes:
        st = entries[pos]
        base_carried = carried + 1 if carried > pos else carried
        before, after = entries[:pos], entries[pos + 1:]
        if t == 1:
            # degenerate split: the intra dim is pinned to [0, 0]
            subs = [(base_carried, (st, "Z"))]
        elif st == "Z":
            subs = [(base_carried, ("Z", "F"))]
        elif st == "LZ":
            return None                  # slice-pinned; sub-dims re-partition
        elif st == "F":
            subs = [(base_carried, ("F", "F"))]
        elif st == "P":
            if carried != pos or rev:
                return None              # P only arises as the carried entry
            # tile-level class (carried at the tile dim, intra free) plus
            # intra-tile class (tile dim pinned by the slice, intra min-1);
            # both exist for every factor 2 <= t <= extent (the tile-level
            # slice stays rationally non-empty even at t == extent)
            subs = [(pos, ("P", "F")), (pos + 1, ("LZ", "P"))]
        else:
            d = st[1]
            if d % t != 0:
                return None              # class straddles a tile boundary
            subs = [(base_carried, (("C", d // t), "F"))]
        for new_carried, pair in subs:
            key = (new_carried, rev)
            if key in seen:
                return None
            seen.add(key)
            entries_out = before + pair + after
            # a free sub-dim that lands before the class's carried entry is
            # pinned to 0 by the carried-level slice: FM reports 0 there,
            # and further transfers must treat it as slice-pinned
            entries_out = tuple(
                "LZ" if (i < new_carried and st2 == "F") else st2
                for i, st2 in enumerate(entries_out))
            out.append((new_carried, rev, entries_out))
    return tuple(out)


def _transfer_skew(classes: Tuple, src: int, dst: int, f: int) -> Optional[Tuple]:
    # supported only when both the source and destination entries are
    # pinned constants in every class: the skew substitutes the
    # destination *variable*, so a free/min-summary entry's reported
    # bounds on the skewed domain are not derivable from the class states
    out = []
    for carried, rev, entries in classes:
        a, b = entries[src], entries[dst]
        if not (a == "Z" or isinstance(a, tuple)):
            return None
        if not (b == "Z" or isinstance(b, tuple)):
            return None
        da = 0 if a == "Z" else a[1]
        db = 0 if b == "Z" else b[1]
        d = db + f * da
        if dst < carried and d != 0:
            return None                  # class's carried level would move
        if dst == carried and d <= 0:
            return None
        e = list(entries)
        e[dst] = "Z" if d == 0 else ("C", d)
        out.append((carried, rev, tuple(e)))
    return tuple(out)


def _classes_to_info(classes: Tuple, n: int) -> DependenceInfo:
    """Rebuild a DependenceInfo from transferred classes, replicating the
    FM reporter's per-level vectors and cross-level distance/direction
    merge branch for branch."""
    levels: Dict[int, Tuple[Optional[int], ...]] = {}
    for carried, _rev, entries in sorted(classes, key=lambda c: c[0]):
        levels[carried + 1] = tuple(_entry_reported(s) for s in entries)
    distance: List[Optional[int]] = [None] * n
    direction: List[str] = ["*"] * n
    for lvl in sorted(levels):
        vec = levels[lvl]
        for k in range(n):
            dk = vec[k]
            if distance[k] is None and direction[k] == "*":
                distance[k] = dk
                if dk is not None:
                    direction[k] = "<" if dk > 0 else ("=" if dk == 0 else ">")
                else:
                    direction[k] = "*"
            else:
                if distance[k] != dk:
                    distance[k] = None
                    direction[k] = "*"
    return DependenceInfo(True, tuple(distance), tuple(direction),
                          min(levels), levels, tuple(classes))


def transfer_dependences(deps: Sequence[DependenceInfo],
                         basis: BasisMap) -> Optional[List[DependenceInfo]]:
    """Transfer a statement's whole self-dependence list; None if any info
    resists exact transfer (the caller falls back to FM for all of them,
    keeping the list's composition identical to a fresh derivation)."""
    out = []
    for dep in deps:
        info = dep.transform(basis)
        if info is None:
            return None
        out.append(info)
    return out


def transfer_legality(deps: Sequence[DependenceInfo],
                      basis: BasisMap) -> Optional[bool]:
    """Legality of a basis change applied to a *legal* schedule state.

    Every dependence class must stay lexicographically positive through
    the change of basis: a reversed class is an integer dependence pair
    whose execution order flips, which is exactly what the FM legality
    check rejects.  Returns None when any class resists exact transfer.
    """
    for dep in deps:
        if not dep.exists:
            continue
        if dep.classes is None:
            return None
        classes = _fold_steps(dep.classes, basis)
        if classes is None:
            return None
        if any(rev for (_, rev, _) in classes):
            return False
    return True


