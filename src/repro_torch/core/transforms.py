"""Polyhedral loop transformations (paper SS V-B, Table II).

Each transform manipulates a ``Statement``'s iteration domain (an integer
set), its loop-dim order, and its ``iter_subst`` composition map -- never the
user-written body.  All transforms verify *legality* against the statement's
own dependences when ``check=True``: every loop-carried dependence must stay
lexicographically positive after the change of basis.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .affine import (BasicSet, BasisMap, Constraint, LinExpr,
                     dependence_vector, eq, ge, le, transfer_dependences,
                     transfer_legality)
from .ir import Statement
from . import caching


class IllegalTransform(Exception):
    pass


# --------------------------------------------------------------------------
# basis-step recording (analytic dependence transfer, PR 4)
# --------------------------------------------------------------------------
# Every transform links the state it produces to the state it consumed,
# together with the positional ``BasisMap`` step it applied, so that the
# next dependence/trip/legality query *inherits* the parent state's facts
# through the change-of-basis algebra instead of re-running FM.
def _pre_step(stmt: Statement):
    if not caching.analytic_on():
        return None
    return (stmt.xfer_sig(), stmt.is_original_order())

def _post_step(stmt: Statement, pre, dep_step: Tuple,
               trip_op: Optional[Tuple]) -> None:
    # every transform primitive mutates ``iter_subst``/``domain`` in place
    # before calling here; drop the memoized subst signature before anything
    # (the basis trace below included) reads them
    stmt._subst_sig = None
    if pre is not None:
        stmt.record_basis_step(pre[0], pre[1], dep_step, trip_op)


# --------------------------------------------------------------------------
# self-dependence helper
# --------------------------------------------------------------------------
def self_dependences(stmt: Statement):
    """All data dependences of a statement onto itself (write->read,
    write->write), in *current* dim space.

    Memoized per statement on (domain, iter_subst) signature: the result is
    a pure function of those plus the immutable body accesses, so stage-1
    tightness checks, the II model, and depgraph construction stop
    re-deriving identical dependence polyhedra.  When the state was
    produced by a recorded basis step and the parent state's dependences
    fit the transfer algebra, the list is *transferred* (pure integer
    arithmetic) instead of recomputed — counted under
    ``selfdep_transfers``.  The returned list is shared — callers must
    treat it as read-only.
    """
    if not caching.ENABLED:
        caching.COUNTS["selfdep_evals"] += 1
        return _self_dependences_compute(stmt)
    key = stmt.xfer_sig()
    hit = stmt._selfdep_cache.get(key)
    if hit is not None:
        caching.COUNTS["selfdep_hits"] += 1
        return hit
    deps = _self_dependences_transfer(stmt)
    if deps is not None:
        caching.COUNTS["selfdep_transfers"] += 1
        stmt._selfdep_cache[key] = deps
        stmt._xfer_keys["selfdep"].add(key)
        return deps
    caching.COUNTS["selfdep_evals"] += 1
    deps = _self_dependences_compute(stmt)
    stmt._selfdep_cache[key] = deps
    return deps


def _steps_transferable(steps) -> bool:
    """Steps are dependence-transferable only while they stay clear of the
    rational FM relaxation around split sub-dims: a permutation must keep
    every (tile, intra) pair in order, and a skew must not touch a
    sub-dim (a tile entry is zero only by rational *rounding* of the
    coupled ``t*d0 + d1`` constraints, which a flip or a scale undoes —
    FM's reported bounds and legality verdicts then differ from the pure
    vector algebra).  Validated against the live pair set when each step
    is recorded (``record_basis_step``)."""
    return all(dep_ok for _dep, _trip, dep_ok in steps)


def _self_dependences_transfer(stmt: Statement):
    """Transferred self-dependence list, or None (fall back to FM)."""
    if not caching.analytic_on():
        return None
    walk = stmt._walk_trace(
        lambda sig, _orig: sig in stmt._selfdep_cache)
    if walk is None:
        return None
    root_sig, steps = walk
    if not _steps_transferable(steps):
        return None
    basis = BasisMap(len(root_sig[0][0]), [d for d, _t, _ok in steps])
    return transfer_dependences(stmt._selfdep_cache[root_sig], basis)


def _self_dependences_compute(stmt: Statement):
    deps = []
    w_arr, w_idx = stmt.store_access()
    # write -> read (true dep incl. reduction self-reads)
    for arr, idx in stmt.load_accesses():
        if arr.name != w_arr.name:
            continue
        info = dependence_vector(stmt.domain, list(w_idx), stmt.domain, list(idx))
        if info.exists:
            deps.append(info)
        # also read -> write (anti) matters for legality
        info2 = dependence_vector(stmt.domain, list(idx), stmt.domain, list(w_idx))
        if info2.exists:
            deps.append(info2)
    # write -> write (output dep)
    info3 = dependence_vector(stmt.domain, list(w_idx), stmt.domain, list(w_idx))
    if info3.exists:
        deps.append(info3)
    return deps


def _legal(stmt: Statement) -> bool:
    """Exact polyhedral legality: every self-dependence pair — *defined by the
    original program order* (lex order over ``original_iters``, recovered via
    ``iter_subst``) — must still execute source-before-sink in the *current*
    lexicographic order.

    For each access pair we check emptiness of
        {(s, t) : domains ∧ same-address ∧ s ≺_orig t ∧ t ⪯_cur s}
    level by level; any non-empty cell is a reversed dependence.

    Memoized twice: per statement on the (domain, iter_subst) signature (the
    stage-2 ladder replays the same split/permute sequences from per-node
    base snapshots), and globally under a *name-canonical* key so that
    statements identical modulo dim/array renaming (3MM's three matmuls,
    repeated conv layers) share one legality verdict.
    """
    if not caching.ENABLED:
        caching.COUNTS["legal_evals"] += 1
        return _legal_compute(stmt)
    key = stmt.xfer_sig()
    hit = stmt._legal_cache.get(key)
    if hit is not None:
        caching.COUNTS["legal_hits"] += 1
        return hit
    ckey = _legal_canon_key(stmt)
    ok = _LEGAL_CACHE.get(ckey)
    if ok is None:
        ok = _legal_transfer(stmt)
        if ok is not None:
            caching.COUNTS["legal_transfers"] += 1
            stmt._legal_cache[key] = ok
            stmt._xfer_keys["legal"].add(key)
            return ok
        caching.COUNTS["legal_evals"] += 1
        ok = _legal_compute(stmt)
        if len(_LEGAL_CACHE) >= 100_000:
            _LEGAL_CACHE.clear()
        _LEGAL_CACHE[ckey] = ok
    else:
        caching.COUNTS["legal_hits"] += 1
    stmt._legal_cache[key] = ok
    return ok


_LEGAL_CACHE: dict = {}


def _legal_transfer(stmt: Statement) -> Optional[bool]:
    """Legality by dependence transfer: walk back to the nearest ancestor
    state that is *known legal* (cached True verdict, or the original
    program order, which is legal by construction) and whose dependence
    list is cached, then check that every dependence class stays
    lexicographically positive through the accumulated basis steps.
    Sound because legality w.r.t. the original order composes: a legal
    ancestor plus an order-preserving basis change is legal, and an exact
    transfer that reverses a class exhibits an integer dependence pair
    whose execution order flips."""
    if not caching.analytic_on():
        return None

    def rooted(sig, is_original):
        known = is_original or stmt._legal_cache.get(sig) is True
        return known and sig in stmt._selfdep_cache

    walk = stmt._walk_trace(rooted)
    if walk is None:
        return None
    root_sig, steps = walk
    if not _steps_transferable(steps):
        return None
    basis = BasisMap(len(root_sig[0][0]), [d for d, _t, _ok in steps])
    return transfer_legality(stmt._selfdep_cache[root_sig], basis)


def _legal_canon_key(stmt: Statement) -> tuple:
    """Name-canonical key over everything ``_legal_compute`` reads: the
    domain, the original->current substitution (in original-iterator order),
    and the composed store/load access functions (a load only matters
    through whether it aliases the store array)."""
    from .affine import NameCanon
    c = NameCanon()
    dkey = c.set_key(stmt.domain)
    subst = tuple(c.expr(stmt.iter_subst[k]) for k in stmt.original_iters)
    w_arr, w_idx = stmt.store_access()
    store_key = tuple(c.expr(e) for e in w_idx)
    loads_key = tuple((arr.name == w_arr.name,
                       tuple(c.expr(e) for e in idx))
                      for arr, idx in stmt.load_accesses())
    return (dkey, subst, store_key, loads_key)


def _legal_compute(stmt: Statement) -> bool:
    dims = stmt.dims
    n = len(dims)
    orig = stmt.original_iters
    w_arr, w_idx = stmt.store_access()
    pairs: List[Tuple[Sequence[LinExpr], Sequence[LinExpr]]] = []
    for arr, idx in stmt.load_accesses():
        if arr.name == w_arr.name:
            pairs.append((w_idx, idx))   # flow (write -> later read)
            pairs.append((idx, w_idx))   # anti (read -> later write)
    pairs.append((w_idx, w_idx))         # output

    scopy = [f"__ls{i}" for i in range(n)]
    tcopy = [f"__lt{i}" for i in range(n)]
    smap = dict(zip(dims, scopy))
    tmap = dict(zip(dims, tcopy))
    base = ([c.rename(smap) for c in stmt.domain.constraints]
            + [c.rename(tmap) for c in stmt.domain.constraints])
    orig_s = [stmt.iter_subst[k].rename(smap) for k in orig]
    orig_t = [stmt.iter_subst[k].rename(tmap) for k in orig]
    cur_s = [LinExpr.var(v) for v in scopy]
    cur_t = [LinExpr.var(v) for v in tcopy]

    for (src, sink) in pairs:
        acc = [Constraint(a.rename(smap) - b.rename(tmap), True)
               for a, b in zip(src, sink)]
        for l in range(len(orig)):
            lexpos = [Constraint(orig_s[a] - orig_t[a], True) for a in range(l)]
            lexpos.append(ge(orig_t[l] - orig_s[l], 1))
            # violation: t strictly before s in current order ...
            for m in range(n):
                viol = [Constraint(cur_s[a] - cur_t[a], True) for a in range(m)]
                viol.append(ge(cur_s[m] - cur_t[m], 1))
                cell = BasicSet(scopy + tcopy, base + acc + lexpos + viol,
                                stmt.domain.params)
                if not cell.is_empty():
                    return False
            # ... or t == s in current order (non-injective schedule)
            same = [Constraint(cur_s[a] - cur_t[a], True) for a in range(n)]
            cell = BasicSet(scopy + tcopy, base + acc + lexpos + same,
                            stmt.domain.params)
            if not cell.is_empty():
                return False
    return True


# --------------------------------------------------------------------------
# transforms
# --------------------------------------------------------------------------
def permute_dims(stmt: Statement, order: Sequence[str]) -> None:
    """Reorder the statement's loop dims to ``order`` (no legality check —
    callers decide), recording the positional basis step so dependence and
    bound facts transfer across the permutation."""
    old_dims = list(stmt.dims)
    order = list(order)
    if order == old_dims:
        return
    pre = _pre_step(stmt)
    stmt.domain = stmt.domain.permute(order)
    perm = tuple(old_dims.index(d) for d in order)
    _post_step(stmt, pre, ("permute", perm), ("permute", tuple(order)))


def interchange(stmt: Statement, a: str, b: str, check: bool = True) -> None:
    dims = list(stmt.dims)
    ia, ib = dims.index(a), dims.index(b)
    dims[ia], dims[ib] = dims[ib], dims[ia]
    old = stmt.domain
    permute_dims(stmt, dims)
    if check and not _legal(stmt):
        stmt.domain = old
        raise IllegalTransform(f"interchange({a},{b}) violates dependences of {stmt.name}")


def split(stmt: Statement, d: str, t: int, d0: str, d1: str, check: bool = True) -> None:
    """d = t*d0 + d1, 0 <= d1 < t.  (paper: s.split(i, t, i0, i1))"""
    assert t >= 1
    pre = _pre_step(stmt)
    pos = stmt.dims.index(d)
    repl = LinExpr.var(d0) * t + LinExpr.var(d1)
    extra = [ge(LinExpr.var(d1), 0), le(LinExpr.var(d1), t - 1)]
    stmt.domain = stmt.domain.substitute_dim(d, repl, [d0, d1], extra)
    for k in list(stmt.iter_subst):
        stmt.iter_subst[k] = stmt.iter_subst[k].substitute(d, repl)
    _post_step(stmt, pre, ("split", pos, t), ("split", d, t, d0, d1))
    # splitting never reorders iterations => always legal; check for safety
    if check and not _legal(stmt):
        raise IllegalTransform(f"split({d}) unexpectedly illegal on {stmt.name}")


def tile(stmt: Statement, i: str, j: str, t1: int, t2: int,
         i0: str, j0: str, i1: str, j1: str, check: bool = True) -> None:
    """Tile (i, j) with (t1, t2) -> order (i0, j0, i1, j1) (paper Table II)."""
    split(stmt, i, t1, i0, i1, check=False)
    split(stmt, j, t2, j0, j1, check=False)
    # current order: ... i0 i1 ... j0 j1 ... ; target: i0 j0 i1 j1 in i's slot
    dims = [d for d in stmt.dims if d not in (i0, i1, j0, j1)]
    pos = stmt.dims.index(i0)
    # count non-tile dims before i0
    before = [d for d in stmt.dims[:pos] if d not in (i0, i1, j0, j1)]
    order = before + [i0, j0, i1, j1] + [d for d in dims if d not in before]
    old = stmt.domain
    permute_dims(stmt, order)
    if check and not _legal(stmt):
        stmt.domain = old
        raise IllegalTransform(f"tile({i},{j}) violates dependences of {stmt.name}")


def skew(stmt: Statement, i: str, j: str, f: int, ip: str, jp: str,
         check: bool = True) -> None:
    """(i, j) -> (ip, jp) = (i, j + f*i): wavefront skew (paper Table II).

    Substitution: i = ip, j = jp - f*ip.
    """
    pre = _pre_step(stmt)
    pos_i, pos_j = stmt.dims.index(i), stmt.dims.index(j)
    stmt.domain = stmt.domain.rename_dim(i, ip)
    repl_j = LinExpr.var(jp) - LinExpr.var(ip) * f
    stmt.domain = stmt.domain.substitute_dim(j, repl_j, [jp])
    for k in list(stmt.iter_subst):
        e = stmt.iter_subst[k].rename({i: ip})
        stmt.iter_subst[k] = e.substitute(j, repl_j)
    # loop bounds of the skewed dim are order-dependent: re-derive by FM
    _post_step(stmt, pre, ("skew", pos_i, pos_j, f), ("skew", i, j))
    if check and not _legal(stmt):
        raise IllegalTransform(f"skew({i},{j},{f}) violates dependences of {stmt.name}")


def shift(stmt: Statement, d: str, c: int, new: Optional[str] = None) -> None:
    """d -> d' = d + c (always legal)."""
    pre = _pre_step(stmt)
    nd = new or d
    ops = []
    if nd != d:
        stmt.domain = stmt.domain.rename_dim(d, nd)
        for k in list(stmt.iter_subst):
            stmt.iter_subst[k] = stmt.iter_subst[k].rename({d: nd})
        ops.append(("rename", {d: nd}))
        d = nd
    repl = LinExpr.var(d) - c
    stmt.domain = stmt.domain.substitute_dim(d, repl, [d])
    for k in list(stmt.iter_subst):
        stmt.iter_subst[k] = stmt.iter_subst[k].substitute(d, repl)
    ops.append(("shift", d, c))
    _post_step(stmt, pre, ("shift",), ("chain", tuple(ops)))


def rename_dim(stmt: Statement, old: str, new: str) -> None:
    pre = _pre_step(stmt)
    stmt.domain = stmt.domain.rename_dim(old, new)
    for k in list(stmt.iter_subst):
        stmt.iter_subst[k] = stmt.iter_subst[k].rename({old: new})
    _post_step(stmt, pre, ("rename",), ("rename", {old: new}))
    if stmt.pipeline_at == old:
        stmt.pipeline_at = new
    if old in stmt.unrolls:
        stmt.unrolls[new] = stmt.unrolls.pop(old)


# --------------------------------------------------------------------------
# fusion (program-order): s1 executes after s2 sharing levels [0..level]
# --------------------------------------------------------------------------
def set_after(s1: Statement, s2: Statement, level: int) -> None:
    """paper: s1.after(s2, j) -- share loops up to and incl. position of j."""
    s1.after_spec = (s2, level)


def fuse_legal(s1: Statement, s2: Statement, levels: int) -> bool:
    """May ``s1`` (currently *after all of* ``s2``) share its first
    ``levels`` loops with ``s2``?

    In the sequential order every cross-statement access pair with a write
    on one side is ordered s2-instance-first.  Fusion reorders a pair
    exactly when the s1 instance's shared loop prefix is lexicographically
    *before* the s2 instance's (equal prefixes keep s2's body first, which
    preserves the original order).  Legality is therefore emptiness of the
    reversed-pair polyhedron

        { (s, t) : s in D_s2, t in D_s1, acc_s2(s) = acc_s1(t),
                   t <_lex s  on the shared levels }

    for every flow (s2 writes → s1 reads), output, and anti (s2 reads →
    s1 writes) access pair — which is ``dependence_vector`` queried with
    s1 as the source side.  Conservative: every same-address pair counts
    as a dependence (no last-writer refinement).
    """
    w2, w2i = s2.store_access()
    w1, w1i = s1.store_access()
    pairs = []
    for arr, idx in s1.load_accesses():
        if arr.name == w2.name:
            pairs.append((list(w2i), list(idx)))       # s2 writes -> s1 reads
    if w1.name == w2.name:
        pairs.append((list(w2i), list(w1i)))           # output dep
    for arr, idx in s2.load_accesses():
        if arr.name == w1.name:
            pairs.append((list(idx), list(w1i)))       # anti dep s2 reads -> s1 writes
    for src, sink in pairs:
        reversed_pairs = dependence_vector(s1.domain, sink, s2.domain, src,
                                           shared_levels=levels)
        if reversed_pairs.exists:
            return False
    return True
