"""Pluggable DSE search subsystem (paper §VI-B, generalized).

``dse.stage2`` used to be a single greedy ladder hard-wired into the DSE
engine.  This module factors the three concerns of bottleneck-oriented
search — **candidate generation** (``unroll_candidates`` /
``apply_parallel``), **candidate evaluation** (serial or a
``multiprocessing`` worker pool), and **candidate selection** (a
``SearchStrategy``) — into independently pluggable pieces behind a
strategy registry:

* ``greedy``   — the paper's ladder, re-expressed on the new interface and
  bit-identical (schedules, reports, action logs, *and* evaluation
  counters) to the pre-subsystem engine;
* ``beam``     — anchored beam search: keep the top-k parallelization
  states per rung.  The pure-greedy trajectory is pinned into the beam
  ("anchored"), so the final design is never worse than greedy's, while
  the other ``k-1`` slots explore runner-up candidates and early-exit
  branches.  Beams share the schedule-signature-keyed report caches of
  the incremental engine (PR 1), so revisiting a design another beam
  already evaluated is a dictionary hit.  Each iteration with several
  live states runs as a **wave**: all rung preambles first, then one
  evaluation pass, then per-state decisions — and states whose pending
  rung is identical (same base design, statement, and target
  parallelism: sibling branches of one rung always are) share a single
  evaluation (*dedup-and-credit*), so ``beam:8`` costs far less than 8
  greedy ladders.  ``beam:k:parallel[:n]`` additionally dispatches each
  wave's deduplicated candidate union to the warm worker pool below,
  with per-state schedule snapshots and cache deltas primed per worker
  and the replay merge generalized per state — selected designs,
  actions, eval counters, and ``CostStats`` stay bit-identical to the
  serial beam for any worker count;
* ``parallel`` — the greedy ladder with the per-rung candidate set
  evaluated concurrently by a **supervised pool of warm worker
  processes** (forked once per search, primed per rung with the parent's
  schedule snapshot and cache delta, so every candidate evaluation still
  starts from exactly the serial engine's rung-start state).  Results
  are merged back **in candidate order** (never completion order), with
  ``CostStats`` counters and the name-canonical memo tables deduplicated
  by replay so the merged ``CostStats`` and every evaluation counter
  equal a serial run's exactly (hit counters can exceed serial's by a
  few repeated dictionary lookups — see ``_merge_candidate_result``).
  A worker that crashes, hangs past its deadline
  (``POM_WORKER_DEADLINE_S``), or returns a malformed reply is killed
  and its candidate retried with backoff on a fresh worker; after
  ``POM_WORKER_MAX_FAILURES`` consecutive failures the evaluator
  degrades to the serial path for the rest of the search with a
  structured :class:`~repro_torch.core.errors.PomWarning` instead of an
  exception — same results, same eval counters, no crash.

Every evaluated design additionally lands in a :class:`ParetoArchive` of
``(latency, DSP, BRAM18, schedule signature)`` points with
dominated-point pruning, so a DSE run exports the latency/resource
*frontier* rather than a single winner (``auto_dse(..., archive=...)``;
``POM_DUMP_PARETO=<path>`` dumps it as JSON).

Strategies are selected by ``auto_dse(strategy="beam", beam_width=4)``,
by the ``POM_DSE_STRATEGY`` environment variable (``greedy`` /
``beam[:k][:latency|scalar][:parallel[:n]]`` / ``parallel[:n]``), or by
registering the matching stage-2 pass from ``pipeline.STAGE2_PASSES``
directly.
"""
from __future__ import annotations

import copy
import functools
import json
import multiprocessing
import os
import sys
from multiprocessing import connection as _mpc
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import caching
from . import faultinject
from . import telemetry
from .errors import warn_structured
from .cost_model import CostStats, DesignReport, HlsModel
from .depgraph import DepGraph, build_depgraph
from .ir import Function, Statement
from . import transforms as T


# --------------------------------------------------------------------------
# schedule snapshot / restore (search backtracking)
# --------------------------------------------------------------------------
def _snapshot(stmt: Statement):
    # the domain object is shared, not copied: BasicSet is immutable by
    # convention (every transform builds a fresh set), and sharing keeps
    # its memoized structural key alive across restore cycles
    return (stmt.domain, dict(stmt.iter_subst), dict(stmt.unrolls),
            stmt.pipeline_at, stmt.pipeline_ii, stmt.after_spec)


def _restore(stmt: Statement, snap) -> None:
    stmt.domain, subst, unrolls, pat, pii, after = snap
    stmt.iter_subst = dict(subst)
    stmt._subst_sig = None          # rebound in place: drop the memoized sig
    stmt.unrolls = dict(unrolls)
    stmt.pipeline_at, stmt.pipeline_ii, stmt.after_spec = pat, pii, after


def _snapshot_fn(fn: Function):
    return {s.uid: _snapshot(s) for s in fn.statements}, \
        {ph.name: dict(ph.partitions) for ph in fn.placeholders.values()}


def _restore_fn(fn: Function, snap) -> None:
    stmts, parts = snap
    for s in fn.statements:
        _restore(s, stmts[s.uid])
    for ph in fn.placeholders.values():
        ph.partitions = dict(parts[ph.name])


# --------------------------------------------------------------------------
# candidate generation
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _unroll_candidates_cached(P: int) -> Tuple[Tuple[int, ...], ...]:
    out = [(P,)]
    f = 2
    while f * f <= P * 2 and f <= P:
        if P % f == 0:
            out.append((P // f, f))
        f *= 2
    if P > 1:
        out.append((P, 1))
    return tuple(out)


def unroll_candidates(P: int) -> List[Tuple[int, ...]]:
    """Factor splits of P over the two innermost dims (innermost-only,
    mixed, and outer-only — the outer-only shape parallelises independent
    recurrence chains, e.g. BICG's row dimension).  A pure function of
    ``P``, recomputed several times per rung (generation, dispatch,
    wave tallies) — memoized, returning a fresh list per call so callers
    may mutate their copy."""
    return list(_unroll_candidates_cached(P))


def apply_parallel(stmt: Statement, factors: Tuple[int, ...]) -> bool:
    """Split+unroll the innermost len(factors) dims by ``factors`` (outermost
    factor first), pipeline the level right above the unrolled loops, and
    cyclic-partition the touched arrays (paper Fig. 6)."""
    dims = list(stmt.dims)
    k = len(factors)
    if k > len(dims):
        return False
    trips = stmt.trip_counts()
    targets = dims[-k:]
    for d, f in zip(targets, factors):
        if f > trips.get(d, 1):
            return False
    # split each target dim and unroll the intra-tile loop; strip-mining
    # never reorders iterations (bijective, lex-order-preserving), so the
    # ladder skips the redundant legality check the user-facing DSL keeps
    new_inner: List[str] = []
    for d, f in zip(targets, factors):
        if f <= 1:
            continue
        d0, d1 = d + "_o", d + "_u"
        try:
            T.split(stmt, d, f, d0, d1, check=False)
        except T.IllegalTransform:
            return False
        new_inner.append(d1)
    # move all intra-tile loops innermost (keeping relative order)
    order = [x for x in stmt.dims if x not in new_inner] + new_inner
    try:
        old = stmt.domain
        T.permute_dims(stmt, order)
        if not T._legal(stmt):
            stmt.domain = old
            return False
    except Exception:
        return False
    for d1 in new_inner:
        stmt.unrolls[d1] = stmt.trip_counts().get(d1, 1)
    # pipeline right above the unrolled band
    outer_dims = [x for x in stmt.dims if x not in new_inner]
    if outer_dims:
        stmt.pipeline_at = outer_dims[-1]
        stmt.pipeline_ii = 1
    return True


# --------------------------------------------------------------------------
# transformed-node memo (cross-rung / cross-state candidate applies)
# --------------------------------------------------------------------------
# (uid, base schedule sig, factors) -> node snapshot with the candidate
# applied, or None when ``apply_parallel`` rejects the factors.  A rung
# always restores its node to the state-independent clean base recorded at
# first visit before splitting, so the transformed schedule is a pure
# function of this key: distinct beam states re-proposing the same
# (statement, P) rung — the common case on multi-statement workloads —
# restore the memoized schedule instead of re-running the split/permute/
# legality machinery.  Worker processes grow their own (forked) copy from
# the candidates they evaluate — always a subset of what a serial run has
# seen at the same point, which keeps the replay-merge premise intact.
# Cleared by ``caching.clear_all``.
_APPLY_CACHE: Dict[Tuple, Optional[tuple]] = {}
_APPLY_MISS = object()


def _snap_sched_sig(uid: int, snap) -> Tuple:
    """``schedule_signature`` of a node snapshot, without restoring it
    (``after_spec`` is irrelevant to the node-local transform)."""
    domain, subst, unrolls, pat, pii, _after = snap
    return (uid, domain.key(),
            tuple(sorted((k, v.key()) for k, v in subst.items())),
            tuple(sorted(unrolls.items())), pat, pii)


def _apply_candidate(fn: Function, model: HlsModel, s: Statement,
                     base_snap, base_key: Optional[Tuple], sweep,
                     factors: Tuple[int, ...]) -> bool:
    """Restore ``s`` to its rung base and apply ``factors`` — through the
    transformed-node memo when enabled.  On a memo hit the split/permute
    work (and the redundant base restore) is skipped; the restored
    schedule is bit-identical to a fresh apply, and the primed recurrence
    II plus the partition refresh run either way."""
    if base_key is None or not caching.ENABLED:
        _restore_node(fn, s, base_snap)
        ok = apply_parallel(s, tuple(factors))
        if ok:
            model.prime_recurrence_ii(s, sweep, tuple(factors))
            _refresh_partitions(fn)
        return ok
    key = (s.uid, base_key, tuple(factors))
    hit = _APPLY_CACHE.get(key, _APPLY_MISS)
    if hit is not _APPLY_MISS:
        if hit is None:
            return False
        _restore(s, hit)
        model.prime_recurrence_ii(s, sweep, tuple(factors))
        _refresh_partitions(fn)
        return True
    _restore_node(fn, s, base_snap)
    ok = apply_parallel(s, tuple(factors))
    if len(_APPLY_CACHE) >= 8192:
        _APPLY_CACHE.clear()
    if not ok:
        _APPLY_CACHE[key] = None
        return False
    model.prime_recurrence_ii(s, sweep, tuple(factors))
    _refresh_partitions(fn)
    _APPLY_CACHE[key] = _snapshot(s)
    return True


def design_signature(fn: Function) -> Tuple:
    """Structural signature of the whole design (schedules + partitions +
    the effective dataflow toggle); the same shape the cost model keys its
    whole-design cache on.  The dataflow flag distinguishes the sequential
    and task-pipelined aggregations of one schedule in the Pareto archive
    (same loops, different latency/BRAM point)."""
    from .graph_ir import dataflow_effective
    return (tuple(s.schedule_signature() for s in fn.statements),
            tuple(sorted((ph.name, ph.part_sig())
                         for ph in fn.placeholders.values())),
            dataflow_effective(fn))


# --------------------------------------------------------------------------
# Pareto archive of evaluated designs
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class DesignPoint:
    """One evaluated design: the archive's objective axes + identity."""
    latency: int
    dsp: int
    bram18: int
    signature: Tuple
    strategy: str
    feasible: bool
    # steady-state per-invocation II (DesignReport.ii_region): reported
    # metadata, NOT an objective axis — it is derived from the same
    # schedule the latency axis already ranks, so adding it would only
    # thin the frontier with duplicates of the latency ordering
    ii_region: int = 0

    def objectives(self) -> Tuple[int, int, int]:
        return (self.latency, self.dsp, self.bram18)

    def dominates(self, other: "DesignPoint") -> bool:
        a, b = self.objectives(), other.objectives()
        return all(x <= y for x, y in zip(a, b)) and a != b


class ParetoArchive:
    """Archive of every evaluated design with dominated-point pruning.

    Points minimize ``(latency, DSP, BRAM18)``.  ``frontier()`` is the
    non-dominated set among *feasible* designs; infeasible evaluations are
    counted but never archived as points.  ``add`` is deduplicated on the
    design's schedule signature, so cache-hit re-evaluations (stage-2
    backtracking restores previous designs constantly) cost one set
    lookup.
    """

    def __init__(self, keep_dominated: bool = False):
        self.points: List[DesignPoint] = []      # current non-dominated set
        self.dominated: List[DesignPoint] = []   # kept only on request
        self.keep_dominated = keep_dominated
        self.evaluated = 0                       # distinct designs seen
        self.infeasible = 0
        self._seen: set = set()

    def add(self, fn: Function, report: DesignReport,
            strategy: str = "?") -> Optional[DesignPoint]:
        """Record one evaluated design; returns the archived point (or None
        for duplicates / infeasible / dominated-on-arrival designs)."""
        sig = design_signature(fn)
        if sig in self._seen:
            return None
        self._seen.add(sig)
        self.evaluated += 1
        if not report.feasible:
            self.infeasible += 1
            return None
        dsp, bram18 = report.resource_vector
        pt = DesignPoint(report.latency, dsp, bram18,
                         sig, strategy, report.feasible,
                         getattr(report, "ii_region", 0))
        return self._insert(pt)

    def _insert(self, pt: DesignPoint) -> Optional[DesignPoint]:
        for p in self.points:
            if p.dominates(pt) or p.objectives() == pt.objectives():
                if self.keep_dominated:
                    self.dominated.append(pt)
                return None
        survivors, newly_dominated = [], []
        for p in self.points:
            (newly_dominated if pt.dominates(p) else survivors).append(p)
        if self.keep_dominated:
            self.dominated.extend(newly_dominated)
        survivors.append(pt)
        self.points = survivors
        return pt

    def frontier(self) -> List[DesignPoint]:
        """Non-dominated feasible designs, latency-ascending."""
        return sorted(self.points, key=lambda p: p.objectives())

    def best(self) -> Optional[DesignPoint]:
        front = self.frontier()
        return front[0] if front else None

    def __len__(self) -> int:
        return len(self.points)

    def to_json(self) -> Dict[str, Any]:
        return {
            "evaluated": self.evaluated,
            "infeasible": self.infeasible,
            "frontier": [
                {"latency": p.latency, "dsp": p.dsp, "bram18": p.bram18,
                 "ii_region": p.ii_region, "strategy": p.strategy}
                for p in self.frontier()
            ],
        }

    def dump(self, dest: str = "-") -> None:
        """Write the frontier as JSON to ``dest`` — the ``POM_DUMP_PARETO``
        hook.  ``-`` means stdout, ``stderr`` standard error, anything
        else a path; the stream cases flush explicitly
        (``telemetry.dump_stream``, shared with ``POM_TRACE=-``) so dumps
        interleave correctly with pytest capture and service logs."""
        telemetry.dump_stream(json.dumps(self.to_json(), indent=2), dest)


# --------------------------------------------------------------------------
# search context + ladder state
# --------------------------------------------------------------------------
@dataclass
class SearchContext:
    """Everything a strategy needs: the design under search, the evaluator
    model, the budget, and the (optional) Pareto archive."""
    fn: Function
    model: HlsModel
    max_parallel: int = 256
    archive: Optional[ParetoArchive] = None
    strategy_name: str = "greedy"
    g: Optional[DepGraph] = None
    by_uid: Dict[int, Statement] = field(default_factory=dict)

    def record(self, report: DesignReport) -> None:
        if self.archive is not None:
            self.archive.add(self.fn, report, self.strategy_name)

    def design_report(self) -> DesignReport:
        rep = self.model.design_report(self.fn)
        self.record(rep)
        return rep


@dataclass
class Candidate:
    """One evaluated parallelization candidate of a rung."""
    factors: Tuple[int, ...]
    report: DesignReport
    snap: tuple                       # node snapshot with candidate applied


@dataclass
class RungInfo:
    """What happened in one ladder rung (consumed by beam branching)."""
    uid: int
    P: int
    prev: tuple                       # node snapshot before the rung
    cands: List[Candidate]
    chosen: Optional[Candidate]       # accepted candidate (None = exit)
    sweep: Any = None                 # closed-form ii(unroll_vector), if any


@dataclass
class LadderState:
    """One point of the search: a full design plus the ladder's bookkeeping."""
    parallel_of: Dict[int, int]
    active: List[int]
    base_snaps: Dict[int, tuple]
    report: DesignReport
    actions: List[str]
    guard: int = 0
    lineage: bool = False             # on the pure-greedy trajectory
    snap: Any = None                  # _snapshot_fn when not live
    sig: Optional[Tuple] = None
    last_rung: Optional[RungInfo] = None

    def clone(self) -> "LadderState":
        return LadderState(dict(self.parallel_of), list(self.active),
                           dict(self.base_snaps), self.report,
                           list(self.actions), self.guard, False, self.snap,
                           self.sig, None)


def _refresh_partitions(fn: Function) -> None:
    from .dse import refresh_partitions
    refresh_partitions(fn)


def _restore_node(fn: Function, stmt: Statement, snap) -> None:
    _restore(stmt, snap)
    _refresh_partitions(fn)


def _init_ladder(ctx: SearchContext) -> LadderState:
    """Mirror of the pre-subsystem ``stage2`` preamble (order matters: the
    evaluation counters of the incremental engine must be bit-identical)."""
    fn = ctx.fn
    ctx.g = build_depgraph(fn)
    parallel_of = {s.uid: 1 for s in fn.statements}
    active = [s.uid for s in fn.statements]
    ctx.by_uid = {s.uid: s for s in fn.statements}
    # give every node a baseline pipeline (innermost) before the ladder
    for s in fn.statements:
        if s.pipeline_at is None and s.dims:
            s.pipeline_at = s.dims[-1]
            s.pipeline_ii = 1
    _refresh_partitions(fn)
    report = ctx.design_report()
    return LadderState(parallel_of, active, {}, report, [])


def _critical_bottleneck(ctx: SearchContext, st: LadderState) -> Optional[int]:
    paths = ctx.g.paths()
    if not paths:
        return None

    def path_lat(p):
        return sum(st.report.nodes[ctx.by_uid[u].name].latency for u in p)

    best = max(paths, key=path_lat)
    cands = [u for u in best if u in st.active]
    if not cands:
        cands = [u for u in st.active]
        if not cands:
            return None
    return max(cands, key=lambda u: st.report.nodes[ctx.by_uid[u].name].latency)


# --------------------------------------------------------------------------
# bound-and-confirm rung planning (POM_BOUND_PRUNE)
# --------------------------------------------------------------------------
# A rung's closed-form sweep yields an *admissible latency lower bound*
# per candidate (``HlsModel.latency_lower_bound``): the exact pipelined-
# node latency formula with the closed-form recurrence II substituted for
# the achieved II (achieved = max(recurrence, memory-port, ...) >= it).
# The evaluators use it in two ways, both preserving bit-identity with
# exhaustive evaluation:
#
# * **static rule** (branching beams): confirm exactly the candidates
#   whose bound could still beat the rung's pre-evaluation bottleneck
#   latency (``bound is None or bound < cutoff``).  A pruned candidate
#   has node latency >= bound >= cutoff, so it can neither win
#   ``_rung_finish``'s strict-improvement accept nor pass ``_branches``'s
#   strict-improvement filter — the full candidate list minus provable
#   losers.
# * **two-round rule** (single-trajectory ladders, where only the argmin
#   matters): round 1 confirms every unbounded candidate plus the lowest-
#   bounded one; round 2 confirms only candidates whose bound could still
#   beat round 1's best confirmed node latency (generation-order tiebreak:
#   an equal bound survives only if it precedes the incumbent, since the
#   argmin's first-strict-improvement rule lets an earlier equal-latency
#   candidate win).  Both the serial and pooled evaluators run this same
#   deterministic plan, so merged counters stay equal to serial's.
def _bound_plan(model: HlsModel, sweep,
                factor_list: Sequence[Tuple[int, ...]], cutoff: int
                ) -> Tuple[List[Optional[int]], List[int]]:
    """Per-candidate latency lower bounds + the static confirm frontier
    (generation-order indices).  Charges ``pruned_candidates`` for the
    statically excluded ones."""
    bounds = [model.latency_lower_bound(sweep, f) for f in factor_list]
    frontier = [i for i, b in enumerate(bounds) if b is None or b < cutoff]
    dropped = len(factor_list) - len(frontier)
    if dropped:
        model.stats.pruned_candidates += dropped
        telemetry.REGISTRY.counter("dse.pruned_candidates").inc(dropped)
    return bounds, frontier


def _round_one(bounds: List[Optional[int]], frontier: List[int]
               ) -> Tuple[List[int], List[int]]:
    """Split the frontier into round 1 (all unbounded candidates + the
    lowest-bounded one, in generation order) and the remaining bounded
    candidates in (bound, generation index) order."""
    bounded = sorted((i for i in frontier if bounds[i] is not None),
                     key=lambda i: (bounds[i], i))
    first = [i for i in frontier if bounds[i] is None]
    if bounded:
        first = sorted(first + bounded[:1])
    return first, bounded[1:]


def _round_two(model: HlsModel, bounds: List[Optional[int]],
               rest: List[int], best: Optional[Tuple[int, int]]
               ) -> List[int]:
    """Candidates of ``rest`` whose bound could still beat round 1's best
    confirmed ``(node latency, generation index)``; the others are pruned.
    With no feasible round-1 candidate every remaining one is confirmed."""
    if best is None:
        keep = sorted(rest)
    else:
        lat1, i1 = best
        keep = sorted(j for j in rest
                      if bounds[j] < lat1 or (bounds[j] == lat1 and j < i1))
    dropped = len(rest) - len(keep)
    if dropped:
        model.stats.pruned_candidates += dropped
        telemetry.REGISTRY.counter("dse.pruned_candidates").inc(dropped)
    return keep


def _best_candidate(s: Statement, cands: Sequence["Candidate"]
                    ) -> Optional["Candidate"]:
    """The rung argmin: feasible candidate with the lowest bottleneck-node
    latency, first strict improvement winning ties (shared by
    ``_rung_finish`` and the two-round confirm plan)."""
    best = None
    for c in cands:
        if not c.report.feasible:
            continue
        if best is None or (c.report.nodes[s.name].latency
                            < best.report.nodes[s.name].latency):
            best = c
    return best


def _round_best(s: Statement, cands: Sequence["Candidate"],
                pos: Dict[Tuple[int, ...], int]
                ) -> Optional[Tuple[int, int]]:
    best = _best_candidate(s, cands)
    if best is None:
        return None
    return best.report.nodes[s.name].latency, pos[best.factors]


# --------------------------------------------------------------------------
# candidate evaluation (serial / worker pool)
# --------------------------------------------------------------------------
class SerialEvaluator:
    """Evaluate the rung's candidates in order on the live function —
    exactly the inner loop of the pre-subsystem greedy ladder.  When the
    rung has a closed-form sweep, each applied candidate's recurrence II
    is primed from it (``prime_recurrence_ii``), so the design report's
    II lookup is a dictionary hit; with bound pruning on
    (``POM_BOUND_PRUNE``) the sweep additionally prunes candidates whose
    latency lower bound proves they cannot win the rung."""

    workers = 1

    def close(self) -> None:
        """Evaluators own no resources by default (pool symmetry)."""

    def evaluate(self, ctx: SearchContext, st: LadderState, s: Statement,
                 uid: int, P: int, sweep=None, cutoff: Optional[int] = None,
                 branching: bool = False) -> List[Candidate]:
        factor_list = [tuple(f) for f in unroll_candidates(P)]
        if not (caching.bound_prune_on() and sweep is not None):
            return self.evaluate_factors(ctx, st, s, uid, factor_list, sweep)
        if cutoff is None:
            cutoff = st.report.nodes[s.name].latency
        bounds, frontier = _bound_plan(ctx.model, sweep, factor_list, cutoff)
        if branching:
            return self.evaluate_factors(
                ctx, st, s, uid, [factor_list[i] for i in frontier], sweep)
        first, rest = _round_one(bounds, frontier)
        pre = self.evaluate_factors(
            ctx, st, s, uid, [factor_list[i] for i in first], sweep)
        pos = {f: i for i, f in enumerate(factor_list)}
        confirm = _round_two(ctx.model, bounds, rest,
                             _round_best(s, pre, pos))
        out = self.evaluate_factors(
            ctx, st, s, uid, [factor_list[i] for i in confirm], sweep)
        return sorted(pre + out, key=lambda c: pos[c.factors])

    def evaluate_factors(self, ctx: SearchContext, st: LadderState,
                         s: Statement, uid: int,
                         factor_list: Sequence[Tuple[int, ...]],
                         sweep) -> List[Candidate]:
        """Confirm an explicit candidate subset with full design reports,
        in the given (generation) order — the pre-pruning evaluator loop."""
        out: List[Candidate] = []
        base = st.base_snaps[uid]
        base_key = _snap_sched_sig(uid, base)
        t_on = telemetry.on()
        for factors in factor_list:
            if not _apply_candidate(ctx.fn, ctx.model, s, base, base_key,
                                    sweep, tuple(factors)):
                if t_on:
                    telemetry.event("stage2.candidate_illegal", _cat="dse",
                                    statement=s.name, factors=str(factors))
                continue
            if t_on:
                with telemetry.span("stage2.candidate", _cat="dse",
                                    statement=s.name,
                                    factors=str(factors)) as sp:
                    rep = ctx.design_report()
                    sp.add(feasible=rep.feasible, latency=rep.latency)
            else:
                rep = ctx.design_report()
            ctx.model.stats.confirmed_evals += 1
            out.append(Candidate(tuple(factors), rep, _snapshot(s)))
        return out


# ---- worker-pool evaluation ------------------------------------------------
# Warm workers are forked once per search and inherit the parent's whole
# object graph copy-on-write; per-rung state travels over a Pipe.


def _stmt_cache_tables(s: Statement) -> Dict[str, dict]:
    # "trace" (the basis-step links of the analytic-transfer layer) rides
    # along so the parent can keep transferring from states a worker
    # reached: entries are deterministic metadata, collisions carry no
    # counter conversion
    return {"trip": s._trip_cache, "acc": s._acc_cache,
            "selfdep": s._selfdep_cache, "legal": s._legal_cache,
            "part": s._part_cache, "trace": s._basis_trace}


def _model_cache_tables(model: HlsModel) -> Dict[str, dict]:
    return {"node": model._node_cache, "design": model._design_cache,
            "expr": model._expr_cache}


def _cache_key_snapshot(fn: Function, model: HlsModel) -> Dict:
    snap = {"global": caching.snapshot_memo_keys(),
            "global_xfer": {n: set(t)
                            for n, t in caching.global_xfer_sets().items()},
            "stmt": {s.uid: {n: set(t) for n, t in _stmt_cache_tables(s).items()}
                     for s in fn.statements},
            "stmt_xfer": {s.uid: {n: set(t) for n, t in s._xfer_keys.items()}
                          for s in fn.statements},
            "model": {n: set(t) for n, t in _model_cache_tables(model).items()}}
    return snap


def _cache_delta(fn: Function, model: HlsModel, before: Dict) -> Dict:
    """New cache entries since ``before``, in insertion order per table.

    ``xfer`` carries the *origin marks* of entries the analytic-transfer
    layer produced (vs FM evaluations): the merge conversion must charge a
    key collision against the counter the worker actually incremented."""
    delta: Dict[str, Any] = {"global": caching.memo_delta(before["global"]),
                             "stmt": {}, "model": {}, "xfer": {"stmt": {}}}
    delta["xfer"]["global"] = {
        n: set(t) - before["global_xfer"].get(n, set())
        for n, t in caching.global_xfer_sets().items()}
    for s in fn.statements:
        olds = before["stmt"][s.uid]
        per = {}
        for name, table in _stmt_cache_tables(s).items():
            new = {k: v for k, v in table.items() if k not in olds[name]}
            if new:
                per[name] = new
        if per:
            delta["stmt"][s.uid] = per
        oldx = before["stmt_xfer"][s.uid]
        perx = {n: set(t) - oldx.get(n, set())
                for n, t in s._xfer_keys.items()}
        if any(perx.values()):
            delta["xfer"]["stmt"][s.uid] = perx
    for name, table in _model_cache_tables(model).items():
        old = before["model"][name]
        new = {k: v for k, v in table.items() if k not in old}
        if new:
            delta["model"][name] = new
    return delta


def _translate_placeholders(fn: Function, delta: Dict) -> None:
    """Rewrite worker-side Placeholder references in merged cache values to
    the parent's placeholder objects (matched by name); everything in the
    engine is name-keyed, but handing back foreign objects would make
    identity-based reasoning fragile."""
    def xlat(arr):
        return fn.placeholders.get(arr.name, arr)

    for per in delta.get("stmt", {}).values():
        acc = per.get("acc")
        if acc:
            for k, (store, loads) in list(acc.items()):
                acc[k] = ((xlat(store[0]), store[1]),
                          [(xlat(a), idx) for a, idx in loads])
        part = per.get("part")
        if part:
            for k, triples in list(part.items()):
                part[k] = [(xlat(a), d, f) for a, d, f in triples]


@dataclass
class _Checkpoint:
    """Counter + cache-key snapshot for one accounting phase."""
    counts: Dict[str, int]
    stats: CostStats
    keys: Dict


def _checkpoint(fn: Function, model: HlsModel) -> _Checkpoint:
    return _Checkpoint(dict(caching.COUNTS), copy.copy(model.stats),
                       _cache_key_snapshot(fn, model))


def _phase_delta(fn: Function, model: HlsModel, cp: _Checkpoint
                 ) -> Tuple[Dict[str, int], CostStats, Dict]:
    import dataclasses
    counts = caching.counts_delta(cp.counts)
    st = model.stats
    stats = CostStats(**{f.name: getattr(st, f.name)
                         - getattr(cp.stats, f.name)
                         for f in dataclasses.fields(CostStats)})
    return counts, stats, _cache_delta(fn, model, cp.keys)


@dataclass
class _CandidateResult:
    """Worker result split into two accounting phases: *apply* (restore +
    split/permute/unroll + partition refresh) and *report* (the
    ``design_report`` call).  The split lets the parent drop the report
    phase wholesale when the candidate's design was already evaluated by
    an earlier candidate — which is exactly what a serial run's
    whole-design cache hit does."""
    ok: bool
    report: Optional[DesignReport]
    snap: Optional[tuple]
    apply_counts: Dict[str, int]
    apply_stats: CostStats
    apply_delta: Dict
    report_counts: Optional[Dict[str, int]] = None
    report_stats: Optional[CostStats] = None
    report_delta: Optional[Dict] = None
    # telemetry events recorded worker-side during this evaluation (the
    # trace twin of the cache deltas above): shipped back on the same
    # reply and absorbed by the parent's tracer, where the recording pid
    # separates them into per-worker lanes.  None when tracing is off.
    trace: Optional[List[dict]] = None


def _candidate_eval_body(fn: Function, model: HlsModel, s: Statement,
                         base_snap, sweep,
                         factors: Tuple[int, ...]) -> _CandidateResult:
    """Worker-side evaluation of one candidate against the current cache
    state — the counter-accounting twin of one ``SerialEvaluator`` loop
    iteration, split into apply/report phases for the replay merge.  A
    warm worker's caches hold the parent's rung-start state (per-rung
    sync) plus entries from candidates this worker already evaluated —
    always a subset of what a serial run would hold at the same point, so
    the merge conversion reproduces serial's counters exactly."""
    cp0 = _checkpoint(fn, model)
    ok = _apply_candidate(fn, model, s, base_snap,
                          _snap_sched_sig(s.uid, base_snap), sweep,
                          tuple(factors))
    apply_counts, apply_stats, apply_delta = _phase_delta(fn, model, cp0)
    if not ok:
        return _CandidateResult(False, None, None,
                                apply_counts, apply_stats, apply_delta)
    cp1 = _checkpoint(fn, model)
    rep = model.design_report(fn)
    report_counts, report_stats, report_delta = _phase_delta(fn, model, cp1)
    # after_spec references a worker-side Statement copy; the parent
    # substitutes its own (apply_parallel never changes after_spec)
    snap = _snapshot(s)[:5] + (None,)
    return _CandidateResult(True, rep, snap, apply_counts, apply_stats,
                            apply_delta, report_counts, report_stats,
                            report_delta)


# which cache tables correspond 1:1 to an eval counter: a key collision at
# merge time converts that eval into a hit.  Per-statement ``trip`` /
# ``legal`` tables are *not* listed — their FM-origin entries are inserted
# on both the eval and the (canonical-table hit) paths, so the conversion
# is accounted on the global canonical table alone.  Transfer-origin
# entries (``_xfer_keys`` marks) never touch the canonical tables, so
# *their* collisions convert the transfer counter instead (_XFER_CONV).
_GLOBAL_CONV = {"trip_canon": "trip", "legal": "legal"}
_STMT_CONV = {"acc": "access", "selfdep": "selfdep"}
_XFER_CONV = {"selfdep": "selfdep", "trip": "trip", "legal": "legal"}


def _merge_phase(ctx: SearchContext, delta: Dict,
                 counts: Dict[str, int], stats: CostStats) -> None:
    """Replay one phase of a worker result into the parent: insert fresh
    cache entries, convert entries an earlier-merged candidate already
    computed from evaluations (or transfers) into hits, then fold the
    adjusted counters."""
    _translate_placeholders(ctx.fn, delta)
    conv = {"trip_canon": 0, "legal": 0, "depvec": 0, "rec_ii": 0,
            "acc": 0, "selfdep": 0, "node": 0, "design": 0}
    xconv = {name: 0 for name in _XFER_CONV}
    xfer = delta.get("xfer", {})
    gconv = caching.merge_memo_delta(delta.get("global", {}),
                                     xfer.get("global"))
    rec_ii_xfer = gconv.pop("rec_ii_xfer", 0)
    for name in list(gconv):
        if name.endswith("_xfer"):
            gconv.pop(name)
    conv.update(gconv)
    for uid, per in delta.get("stmt", {}).items():
        s = ctx.by_uid.get(uid)
        if s is None:
            continue
        tables = _stmt_cache_tables(s)
        marks = xfer.get("stmt", {}).get(uid, {})
        for name, entries in per.items():
            table = tables[name]
            mk = marks.get(name, ())
            for k, v in entries.items():
                if k in table:
                    if k in mk and name in _XFER_CONV:
                        xconv[name] += 1
                    elif name in _STMT_CONV:
                        conv[name] += 1
                else:
                    table[k] = v
                    if k in mk:
                        s._xfer_keys[name].add(k)
    mtables = _model_cache_tables(ctx.model)
    for name, entries in delta.get("model", {}).items():
        table = mtables[name]
        for k, v in entries.items():
            if k in table:
                if name in ("node", "design"):
                    conv[name] += 1
            else:
                table[k] = v
    counts = dict(counts)
    for key, cnt in {**_GLOBAL_CONV, **_STMT_CONV}.items():
        counts[f"{cnt}_evals"] -= conv[key]
        counts[f"{cnt}_hits"] += conv[key]
    for key, cnt in _XFER_CONV.items():
        counts[f"{cnt}_transfers"] -= xconv[key]
        counts[f"{cnt}_hits"] += xconv[key]
    caching.merge_counts(counts)
    ms = ctx.model.stats
    ms.node_evals += stats.node_evals - conv["node"]
    ms.node_cache_hits += stats.node_cache_hits + conv["node"]
    ms.full_node_evals += stats.full_node_evals - conv["rec_ii"]
    ms.analytic_node_evals += stats.analytic_node_evals - rec_ii_xfer
    ms.design_evals += stats.design_evals
    ms.design_cache_hits += stats.design_cache_hits + conv["design"]
    # bound-and-confirm counters are charged parent-side only (workers
    # never move them); the pass-through keeps the merge future-proof
    ms.confirmed_evals += stats.confirmed_evals
    ms.pruned_candidates += stats.pruned_candidates


def _merge_candidate_result(ctx: SearchContext, res: _CandidateResult) -> None:
    """Deterministic replay-merge of one worker result into the parent.

    Results are merged in **candidate order** (never completion order).
    The apply phase is always replayed.  The report phase is replayed only
    if the candidate's whole-design cache entry is new; when an earlier
    candidate already produced the identical design (e.g. factor splits
    ``(2,)`` and ``(1, 2)`` both end up splitting only the innermost dim),
    a serial run would have served the report from the whole-design cache
    without recomputing a single node — so the parent drops the worker's
    redundant report-phase work and books exactly that cache hit.  This is
    what makes the merged ``CostStats`` and every *eval* counter in
    ``caching.COUNTS`` equal to a serial run's, not just the search
    result.  (*Hit* counters may exceed a serial run's by a few percent:
    a fork-isolated worker re-derives canonical keys whose
    statement-level entries a serial run short-circuits on — pure
    dictionary lookups, no analysis work, and never fewer than serial.)
    """
    _merge_phase(ctx, res.apply_delta, res.apply_counts, res.apply_stats)
    if not res.ok:
        return
    design_entries = (res.report_delta or {}).get("model", {}).get("design", {})
    already = [k for k in design_entries if k in ctx.model._design_cache]
    if already:
        ms = ctx.model.stats
        ms.design_evals += res.report_stats.design_evals
        ms.design_cache_hits += len(already)
    else:
        _merge_phase(ctx, res.report_delta, res.report_counts,
                     res.report_stats)


def _pool_min_candidates() -> int:
    """Smallest rung (candidate count) worth a fork fan-out.

    Forking workers costs more than serially evaluating a couple of
    candidates against warm caches (``BENCH_dse_speed.json``: gemm's
    3-candidate rungs ran 3x slower pooled), so small rungs fall back to
    the serial evaluator — which is the counter-reference path, so eval
    counters stay exact either way.  Tune with POM_POOL_MIN_CANDIDATES.
    """
    try:
        return max(2, int(os.environ.get("POM_POOL_MIN_CANDIDATES", "4")))
    except ValueError:
        return 4


# ---- warm-worker pool ------------------------------------------------------
def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _ship_fn_snapshot(fn: Function):
    """Picklable image of the parent's live schedule state: per-statement
    snapshots *without* ``after_spec`` (it holds Statement object
    references; workers keep their own — stage 2 never changes it) plus
    the placeholder partition maps."""
    return ({s.uid: _snapshot(s)[:5] for s in fn.statements},
            {ph.name: dict(ph.partitions) for ph in fn.placeholders.values()})


def _ship_from_snapshot(fn_snap):
    """Picklable image of a *stored* ``_snapshot_fn`` state (a beam state's
    ``snap``) — the wave dispatch ships every live state's schedule without
    restoring any of them on the parent first."""
    stmts, parts = fn_snap
    return ({uid: tuple(s6[:5]) for uid, s6 in stmts.items()},
            {name: dict(p) for name, p in parts.items()})


def _apply_shipped_snapshot(fn: Function, shipped) -> None:
    stmts, parts = shipped
    for s in fn.statements:
        snap5 = stmts.get(s.uid)
        if snap5 is not None:
            _restore(s, tuple(snap5) + (s.after_spec,))
    for ph in fn.placeholders.values():
        if ph.name in parts:
            ph.partitions = dict(parts[ph.name])


def _insert_delta(fn: Function, model: HlsModel, delta: Dict) -> None:
    """Raw (uncounted, unconditional) insert of a ``_cache_delta`` into
    this process's caches — the worker side of the per-rung sync.  Keys
    are structural, so an overwrite re-inserts the identical value."""
    gtables = caching.global_memo_tables()
    for name, entries in delta.get("global", {}).items():
        gtables[name].update(entries)
    xfer = delta.get("xfer", {})
    gx = caching.global_xfer_sets()
    for name, keys in xfer.get("global", {}).items():
        if name in gx:
            gx[name].update(keys)
    by_uid = {s.uid: s for s in fn.statements}
    for uid, per in delta.get("stmt", {}).items():
        s = by_uid.get(uid)
        if s is None:
            continue
        tables = _stmt_cache_tables(s)
        for name, entries in per.items():
            tables[name].update(entries)
    for uid, perx in xfer.get("stmt", {}).items():
        s = by_uid.get(uid)
        if s is None:
            continue
        for name, keys in perx.items():
            s._xfer_keys[name].update(keys)
    mtables = _model_cache_tables(model)
    for name, entries in delta.get("model", {}).items():
        mtables[name].update(entries)


def _warm_worker_main(conn, fn: Function, model: HlsModel) -> None:
    """Warm-worker loop: forked once, primed per rung, evaluates candidates
    until told to stop (or killed by the supervisor).

    Messages: ``("rung", fn_snap|None, uid, base5, sweep, delta)`` syncs
    this worker to the parent's rung-start state (``fn_snap=None`` for a
    worker forked mid-search, whose inherited state is already current);
    ``("cand", idx, factors, poison)`` evaluates one candidate and
    replies ``("result", idx, _CandidateResult)``.  ``poison`` carries an
    injected fault from the parent's ``worker.dispatch`` site — the
    worker SIGKILLs itself, hangs past the deadline, or replies with a
    malformed tuple, exercising each supervision path deterministically.

    Wave mode (parallel beam): ``("wave", delta, states)`` installs the
    cache delta once and stores, per beam state, the state's full
    schedule snapshot plus rung header; ``("wcand", sid, idx, factors,
    poison)`` evaluates one candidate of state ``sid``, switching the
    worker's live schedule to that state's snapshot on a ``sid`` change.
    Each state's closed-form sweep is recomputed locally on first touch
    (cheap integer arithmetic), *outside* the checkpointed eval phases —
    its cache entries never reach the parent's merge; the parent charges
    the authoritative sweep at each state's serial position instead.
    """
    import signal
    import time
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    rung = None
    wave = {}
    wave_sid = None
    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break
            tag = msg[0]
            if tag == "stop":
                break
            if tag == "rung":
                _, fn_snap, uid, base5, sweep, delta = msg
                if fn_snap is not None:
                    _apply_shipped_snapshot(fn, fn_snap)
                if delta:
                    _translate_placeholders(fn, delta)
                    _insert_delta(fn, model, delta)
                s = next(x for x in fn.statements if x.uid == uid)
                rung = (s, tuple(base5) + (s.after_spec,), sweep)
                continue
            if tag == "wave":
                _, delta, heads = msg
                if delta:
                    _translate_placeholders(fn, delta)
                    _insert_delta(fn, model, delta)
                wave = {}
                for sid, fn_snap, uid, base5, facs in heads:
                    s = next(x for x in fn.statements if x.uid == uid)
                    # [snap, stmt, base, factors, sweep, sweep_ready]
                    wave[sid] = [fn_snap, s,
                                 tuple(base5) + (s.after_spec,), facs,
                                 None, False]
                wave_sid = None
                continue
            if tag == "wcand":
                _, sid, idx, factors, poison = msg
                ent = wave[sid]
                if wave_sid != sid:
                    _apply_shipped_snapshot(fn, ent[0])
                    wave_sid = sid
                if not ent[5]:
                    if caching.analytic_on():
                        s, base = ent[1], ent[2]
                        _restore_node(fn, s, base)
                        sw = model.closed_form_ii(s)
                        if sw is not None:
                            sw.prefetch(ent[3])
                        ent[4] = sw
                    ent[5] = True
                rung = (ent[1], ent[2], ent[4])
            else:
                _, idx, factors, poison = msg
            if poison == "crash":
                os.kill(os.getpid(), signal.SIGKILL)
            if poison == "hang":
                time.sleep(3600.0)
            s, base, sweep = rung
            if telemetry.on():
                # the tracer was inherited across the fork; ship this
                # evaluation's events back on the reply (worker lane)
                mark = telemetry.buffer_mark()
                with telemetry.span("worker.candidate", _cat="pool",
                                    statement=s.name, idx=idx,
                                    factors=str(factors)):
                    res = _candidate_eval_body(fn, model, s, base, sweep,
                                               factors)
                res.trace = telemetry.buffer_delta(mark)
            else:
                res = _candidate_eval_body(fn, model, s, base, sweep,
                                           factors)
            if poison == "pickle":
                conn.send(("garbled", idx, "<malformed-reply>"))
            else:
                conn.send(("result", idx, res))
    except BaseException:
        pass  # any worker-side failure surfaces to the parent as EOF
    finally:
        try:
            conn.close()
        except OSError:
            pass
        os._exit(0)   # forked child: skip inherited atexit/JAX teardown


class _WarmWorker:
    __slots__ = ("proc", "conn")

    def __init__(self, proc, conn):
        self.proc = proc
        self.conn = conn


_CAND_ATTEMPTS_MAX = 3
_PIPELINE_DEPTH = 2


class PoolEvaluator:
    """Evaluate a rung's candidates concurrently on supervised warm workers.

    Requires the ``fork`` start method (Linux).  Workers are forked once
    per search (inheriting the incremental-cache state copy-on-write) and
    re-primed each rung with the parent's schedule snapshot plus the
    cache delta since the last sync, so every candidate evaluation starts
    from exactly the serial engine's rung-start state — the invariant the
    replay merge's counter parity rests on — without the old
    fork-per-candidate re-import cost.

    Supervision: each dispatched candidate has a deadline
    (``POM_WORKER_DEADLINE_S``); a worker that dies, exceeds it, or
    returns a malformed reply is killed and replaced, and the candidate
    is retried with backoff (``POM_WORKER_RETRY_BACKOFF_S``) on a fresh
    worker, up to 3 attempts.  After ``POM_WORKER_MAX_FAILURES``
    consecutive failures the evaluator emits a structured ``PomWarning``
    and degrades to the serial path for the rest of the search.
    Candidates without a pooled result are evaluated serially *in
    candidate order during the merge* — at that point the parent's caches
    hold exactly a serial run's state, so counters stay exact either way.

    Falls back to serial evaluation when ``fork`` is unavailable,
    ``workers <= 1``, or the rung has fewer candidates than
    ``POM_POOL_MIN_CANDIDATES``.
    """

    def __init__(self, workers: Optional[int] = None,
                 min_candidates: Optional[int] = None):
        self.workers = int(workers) if workers else (os.cpu_count() or 1)
        self.min_candidates = (int(min_candidates)
                               if min_candidates is not None
                               else _pool_min_candidates())
        self.deadline_s = _env_float("POM_WORKER_DEADLINE_S", 30.0)
        self.max_failures = max(1, _env_int("POM_WORKER_MAX_FAILURES", 3))
        self.backoff_s = _env_float("POM_WORKER_RETRY_BACKOFF_S", 0.02)
        self._serial = SerialEvaluator()
        self._procs: List[_WarmWorker] = []
        self._pool_fn: Optional[Function] = None
        self._pool_model: Optional[HlsModel] = None
        self._sync_keys: Optional[Dict] = None
        self._wave_header: Optional[bytes] = None
        self._degraded = False
        self._consec_failures = 0

    @staticmethod
    def _fork_available() -> bool:
        return "fork" in multiprocessing.get_all_start_methods()

    # -- pool lifecycle ------------------------------------------------------
    def _spawn(self, ctx: SearchContext) -> _WarmWorker:
        mp = multiprocessing.get_context("fork")
        parent_conn, child_conn = mp.Pipe()
        proc = mp.Process(target=_warm_worker_main,
                          args=(child_conn, ctx.fn, ctx.model), daemon=True)
        proc.start()
        child_conn.close()
        w = _WarmWorker(proc, parent_conn)
        self._procs.append(w)
        telemetry.REGISTRY.counter("pool.spawns").inc()
        telemetry.event("pool.spawn", _cat="pool", worker=proc.pid)
        return w

    def _ensure_pool(self, ctx: SearchContext, n_cands: int) -> bool:
        if self._pool_fn is not ctx.fn or self._pool_model is not ctx.model:
            # a new search reuses the evaluator: fresh pool, fresh health
            self.close()
            self._degraded = False
            self._consec_failures = 0
        if self._procs:
            return True
        try:
            # nothing may touch the caches between this snapshot and the
            # forks below: a fresh worker's inherited state must equal
            # the delta baseline exactly
            self._sync_keys = _cache_key_snapshot(ctx.fn, ctx.model)
            for _ in range(max(2, min(self.workers, n_cands))):
                self._spawn(ctx)
        except OSError as e:
            self._degrade(ctx, f"fork_failed:{type(e).__name__}")
            return False
        self._pool_fn, self._pool_model = ctx.fn, ctx.model
        return True

    def _kill(self, w: _WarmWorker) -> None:
        if w in self._procs:
            self._procs.remove(w)
        telemetry.REGISTRY.counter("pool.kills").inc()
        telemetry.event("pool.kill", _cat="pool", worker=w.proc.pid)
        try:
            w.proc.kill()
        except OSError:
            pass
        w.proc.join(timeout=5.0)
        try:
            w.conn.close()
        except OSError:
            pass

    def close(self) -> None:
        """Stop and reap every warm worker (end of search / pool reset)."""
        for w in list(self._procs):
            try:
                w.conn.send(("stop",))
            except (OSError, ValueError):
                pass
        for w in list(self._procs):
            try:
                w.conn.close()
            except OSError:
                pass
            w.proc.join(timeout=1.0)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(timeout=5.0)
        self._procs = []
        self._pool_fn = self._pool_model = None
        self._sync_keys = None

    def _degrade(self, ctx: SearchContext, reason: str) -> None:
        self._degraded = True
        consec = self._consec_failures
        self.close()
        self._degraded = True   # close() must not clear the degrade flag
        telemetry.REGISTRY.counter("pool.degrades").inc()
        warn_structured("search.pool", "degraded_to_serial", reason=reason,
                        consecutive_failures=consec,
                        max_failures=self.max_failures)

    # -- supervision ---------------------------------------------------------
    def _send(self, w: _WarmWorker, msg) -> bool:
        try:
            w.conn.send(msg)
            return True
        except (OSError, ValueError):
            return False

    def _send_bytes(self, w: _WarmWorker, payload: bytes) -> bool:
        try:
            w.conn.send_bytes(payload)
            return True
        except (OSError, ValueError):
            return False

    def _respawn(self, ctx: SearchContext, uid: int, base, sweep) -> None:
        """Replace a killed worker mid-rung.  The fork inherits the
        parent's caches exactly as they were at rung start (results merge
        only after collection), so it needs the rung header but no
        snapshot or delta."""
        try:
            w = self._spawn(ctx)
        except OSError as e:
            self._degrade(ctx, f"respawn_failed:{type(e).__name__}")
            return
        if not self._send(w, ("rung", None, uid, base[:5], sweep, {})):
            self._kill(w)
            self._degrade(ctx, "respawn_sync_failed")

    def _broadcast(self, ctx: SearchContext, header: bytes,
                   respawn) -> bool:
        """Send a pickled sync header to every worker, replacing workers
        whose pipe is already dead.  Returns False once degraded."""
        for w in list(self._procs):
            if not self._send_bytes(w, header):
                self._kill(w)
                self._consec_failures += 1
                if self._consec_failures >= self.max_failures:
                    self._degrade(ctx, "sync_send_failed")
                    return False
                respawn()
        return not self._degraded

    def _pooled_results(self, ctx: SearchContext, s: Statement, uid: int,
                        base, sweep, factor_list: List[Tuple[int, ...]]
                        ) -> List[Optional[_CandidateResult]]:
        """Dispatch the rung's candidates across the warm pool under
        supervision; ``None`` slots fall back to in-order serial
        evaluation during the merge."""
        import pickle
        n = len(factor_list)
        if not self._ensure_pool(ctx, n):
            return [None] * n
        # per-rung sync: the parent's schedule state plus its cache delta
        # since the last sync makes every worker's cache key-set equal the
        # parent's rung-start key-set (fresh-fork semantics, no fork)
        delta = _cache_delta(ctx.fn, ctx.model, self._sync_keys)
        self._sync_keys = _cache_key_snapshot(ctx.fn, ctx.model)
        header = pickle.dumps(
            ("rung", _ship_fn_snapshot(ctx.fn), uid, base[:5], sweep, delta))
        respawn = lambda: self._respawn(ctx, uid, base, sweep)
        if not self._broadcast(ctx, header, respawn):
            return [None] * n
        msgs = [("cand", i, factor_list[i]) for i in range(n)]
        return self._collect(ctx, msgs, respawn)

    def _collect(self, ctx: SearchContext, msgs: List[tuple], respawn
                 ) -> List[Optional[_CandidateResult]]:
        """Supervised dispatch of prepared candidate messages across the
        warm pool.  ``msgs[i]`` is the worker message for slot ``i``
        *without* the trailing poison field; its index field must equal
        ``i`` (workers echo it back in the reply).  ``respawn()``
        replaces a killed worker, re-sending whatever header it needs."""
        import time
        from collections import deque
        n = len(msgs)
        results: List[Optional[_CandidateResult]] = [None] * n
        pending = deque(range(n))
        attempts = [0] * n
        # in-flight candidates per worker, in dispatch order, as
        # (idx, deadline) pairs.  Keeping up to _PIPELINE_DEPTH queued per
        # worker lets workers stream results back-to-back instead of
        # idling one parent round-trip between candidates.
        flight: Dict[_WarmWorker, deque] = {}

        def fail(w: _WarmWorker, reason: str) -> None:
            lost = [i for i, _ in flight.pop(w, ())]
            self._kill(w)
            self._consec_failures += 1
            telemetry.REGISTRY.counter("pool.worker_failures").inc()
            warn_structured("search.pool", "worker_failed", reason=reason,
                            candidates=",".join(map(str, lost)) or "-",
                            consecutive_failures=self._consec_failures)
            if self._consec_failures >= self.max_failures:
                self._degrade(ctx, reason)
                return
            retry = [i for i in lost if attempts[i] < _CAND_ATTEMPTS_MAX]
            if retry:
                telemetry.REGISTRY.counter("pool.retries").inc(len(retry))
                telemetry.event("pool.retry", _cat="pool",
                                candidates=",".join(map(str, retry)),
                                reason=reason)
                time.sleep(self.backoff_s
                           * max(attempts[i] for i in retry))
                for i in reversed(retry):
                    pending.appendleft(i)
            # exhausted candidates keep results[i] = None -> serial fill-in
            respawn()

        while (pending or any(flight.values())) and not self._degraded:
            for w in list(self._procs):
                q = flight.setdefault(w, deque())
                while pending and len(q) < _PIPELINE_DEPTH:
                    i = pending.popleft()
                    attempts[i] += 1
                    telemetry.REGISTRY.counter("pool.dispatches").inc()
                    kind = faultinject.fires("worker.dispatch")
                    poison = kind if kind in ("crash", "hang", "pickle") \
                        else None
                    if not self._send(w, msgs[i] + (poison,)):
                        q.append((i, 0.0))
                        fail(w, "dispatch_send_failed")
                        break
                    q.append((i, time.monotonic() + self.deadline_s))
                if self._degraded:
                    return results
            active = {w: q for w, q in flight.items() if q}
            if not active:
                if pending and not self._procs:
                    self._degrade(ctx, "no_workers_left")
                continue
            now = time.monotonic()
            timeout = max(0.0, min(q[0][1] for q in active.values()) - now)
            ready = _mpc.wait([w.conn for w in active], timeout=timeout)
            for conn in ready:
                if self._degraded:
                    break
                w = next(x for x in active if x.conn is conn)
                q = flight.get(w)
                if not q:
                    continue   # worker already failed this round
                try:
                    reply = w.conn.recv()
                except (EOFError, OSError):
                    fail(w, "worker_died")
                    continue
                head = q[0][0]
                if (not isinstance(reply, tuple) or len(reply) != 3
                        or reply[0] != "result" or reply[1] != head
                        or not isinstance(reply[2], _CandidateResult)):
                    fail(w, "malformed_reply")
                    continue
                results[head] = reply[2]
                # worker-lane trace events ride back on the reply; absorb
                # immediately (events are timestamped, order irrelevant)
                telemetry.absorb(reply[2].trace)
                q.popleft()
                if q:
                    # the queued-behind candidate only starts running now:
                    # its deadline clock starts here, not at dispatch
                    i2, _ = q.popleft()
                    q.appendleft((i2, time.monotonic() + self.deadline_s))
                self._consec_failures = 0
            now = time.monotonic()
            for w in [w for w, q in flight.items() if q and now >= q[0][1]]:
                if self._degraded:
                    break
                fail(w, "deadline_exceeded")
        return results

    # -- evaluation ----------------------------------------------------------
    def _merge_results(self, ctx: SearchContext, s: Statement, base, sweep,
                       factor_list: List[Tuple[int, ...]],
                       results: List[Optional[_CandidateResult]]
                       ) -> List[Candidate]:
        """Merge pooled results **in candidate order**.  A ``None`` slot
        (failed / degraded candidate) is evaluated serially in place — the
        merges before it have brought the parent's caches to exactly a
        serial run's state there, so counters stay exact either way."""
        out: List[Candidate] = []
        for i, factors in enumerate(factor_list):
            res = results[i]
            if res is None:
                _restore_node(ctx.fn, s, base)
                if not apply_parallel(s, factors):
                    continue
                ctx.model.prime_recurrence_ii(s, sweep, factors)
                _refresh_partitions(ctx.fn)
                rep = ctx.model.design_report(ctx.fn)
                ctx.model.stats.confirmed_evals += 1
                out.append(Candidate(factors, rep, _snapshot(s)))
                continue
            _merge_candidate_result(ctx, res)
            if not res.ok:
                continue
            ctx.model.stats.confirmed_evals += 1
            out.append(Candidate(factors, res.report, res.snap[:5] + (base[5],)))
        return out

    def _record_archive(self, ctx: SearchContext, s: Statement,
                        out: List[Candidate]) -> None:
        if ctx.archive is not None:
            # archive points carry the *candidate's* design signature, so
            # the candidate schedule must be live on ctx.fn when recorded
            # (exactly as the serial evaluator records mid-loop); restores
            # are counter-free and the decision path restores again anyway
            for c in out:
                _restore_node(ctx.fn, s, c.snap)
                ctx.record(c.report)

    def _pool_worth_it(self, n: int) -> bool:
        return not (self.workers <= 1 or n < self.min_candidates
                    or self._degraded or not self._fork_available())

    def evaluate(self, ctx: SearchContext, st: LadderState, s: Statement,
                 uid: int, P: int, sweep=None, cutoff: Optional[int] = None,
                 branching: bool = False) -> List[Candidate]:
        factor_list = [tuple(f) for f in unroll_candidates(P)]
        if not (caching.bound_prune_on() and sweep is not None):
            if not self._pool_worth_it(len(factor_list)):
                return self._serial.evaluate(ctx, st, s, uid, P, sweep,
                                             cutoff=cutoff,
                                             branching=branching)
            base = st.base_snaps[uid]
            results = self._pooled_results(ctx, s, uid, base, sweep,
                                           factor_list)
            out = self._merge_results(ctx, s, base, sweep, factor_list,
                                      results)
            self._record_archive(ctx, s, out)
            return out
        # bound-and-confirm: same deterministic plan as the serial
        # evaluator (the counter-parity reference); each confirmation
        # round of the bound-sorted frontier goes to the pool.  The
        # worth-it gate counts the rung's *full* candidate set, not the
        # round's subset, so whether a rung dispatches to the pool never
        # depends on the prune mode (fault-injection and degrade paths
        # pin dispatch behavior).
        if cutoff is None:
            cutoff = st.report.nodes[s.name].latency
        base = st.base_snaps[uid]
        bounds, frontier = _bound_plan(ctx.model, sweep, factor_list, cutoff)
        pos = {f: i for i, f in enumerate(factor_list)}

        def _round(idxs: List[int]) -> List[Candidate]:
            sub = [factor_list[i] for i in idxs]
            if not sub or not self._pool_worth_it(len(factor_list)):
                return self._serial.evaluate_factors(ctx, st, s, uid, sub,
                                                     sweep)
            results = self._pooled_results(ctx, s, uid, base, sweep, sub)
            out = self._merge_results(ctx, s, base, sweep, sub, results)
            self._record_archive(ctx, s, out)
            return out

        if branching:
            return _round(list(frontier))
        first, rest = _round_one(bounds, frontier)
        pre = _round(first)
        confirm = _round_two(ctx.model, bounds, rest,
                             _round_best(s, pre, pos))
        out = _round(confirm)
        return sorted(pre + out, key=lambda c: pos[c.factors])

    # -- wave evaluation (parallel beam) -------------------------------------
    def evaluate_wave(self, ctx: SearchContext,
                      entries: List[Tuple[Any, "_PendingRung"]],
                      factors: Optional[List[List[Tuple[int, ...]]]] = None
                      ) -> Dict[int, List[Optional[_CandidateResult]]]:
        """Dispatch the union of several beam states' rung candidates to
        the warm pool in one wave.

        ``entries`` holds ``(state_snap, pend)`` pairs, one per *distinct*
        pending rung (the beam dedups identical rung keys before
        dispatch).  Returns ``{entry_index: [Optional[_CandidateResult]]}``
        with one slot per candidate, or ``{}`` when the whole wave falls
        back to serial evaluation (too few candidates in total, no fork,
        ``workers <= 1``, degraded) — the beam then evaluates each rung
        serially in state order, which is the counter-reference path.

        Workers get one ``("wave", delta, states)`` header carrying the
        parent's cache delta since the last sync plus, per state, the
        state's full schedule snapshot and rung header; candidates are
        then ``("wcand", sid, idx, factors)`` messages.  The parent
        merges results in **state order, candidate order** — never
        completion order — via :meth:`merge_wave_rung`, so counters and
        designs replay a serial beam exactly.

        ``factors`` (bound-and-confirm pruning) optionally narrows each
        entry's dispatched candidate set to its confirmed frontier — the
        protocol is unchanged, workers simply receive the subset."""
        import pickle
        eff = ([list(f) for f in factors] if factors is not None
               else [list(p.factors) for _, p in entries])
        # the worth-it gate counts the rung's *full* candidate sets, not
        # the confirmed frontier: pruning shrinks the payload, but whether
        # a wave goes to the pool must not depend on the prune mode (the
        # fault-injection and degrade paths pin dispatch behavior)
        total = sum(len(p.factors) for _, p in entries)
        if (self.workers <= 1 or self._degraded or not entries
                or not self._fork_available()
                or total < self.min_candidates):
            return {}
        if not self._ensure_pool(ctx, total):
            return {}
        delta = _cache_delta(ctx.fn, ctx.model, self._sync_keys)
        self._sync_keys = _cache_key_snapshot(ctx.fn, ctx.model)
        heads = [(sid, _ship_from_snapshot(snap), p.uid, p.base[:5],
                  list(eff[sid]))
                 for sid, (snap, p) in enumerate(entries)]
        header = pickle.dumps(("wave", delta, heads))
        # a worker forked mid-wave inherits the parent's caches exactly as
        # they were at the sync above (results merge only after
        # collection), but the parent's *live* schedule is whatever state
        # it keyed last — the per-state snapshots in the header are what
        # put every wcand on the right beam state, so the respawn header
        # only drops the (already inherited) delta
        self._wave_header = pickle.dumps(("wave", {}, heads))
        respawn = lambda: self._respawn_wave(ctx)
        if not self._broadcast(ctx, header, respawn):
            return {}
        msgs: List[tuple] = []
        slots: List[Tuple[int, int]] = []
        for sid in range(len(entries)):
            for j, facs in enumerate(eff[sid]):
                msgs.append(("wcand", sid, len(msgs), facs))
                slots.append((sid, j))
        results = self._collect(ctx, msgs, respawn)
        out = {sid: [None] * len(eff[sid]) for sid in range(len(entries))}
        for (sid, j), r in zip(slots, results):
            out[sid][j] = r
        return out

    def _respawn_wave(self, ctx: SearchContext) -> None:
        """Replace a killed worker mid-wave (see ``_respawn``)."""
        try:
            w = self._spawn(ctx)
        except OSError as e:
            self._degrade(ctx, f"respawn_failed:{type(e).__name__}")
            return
        if not self._send_bytes(w, self._wave_header):
            self._kill(w)
            self._degrade(ctx, "respawn_sync_failed")

    def merge_wave_rung(self, ctx: SearchContext, s: Statement,
                        pend: "_PendingRung", sweep,
                        results: List[Optional[_CandidateResult]],
                        factors: Optional[List[Tuple[int, ...]]] = None
                        ) -> List[Candidate]:
        """Merge one state's slice of a wave — the wave twin of
        ``evaluate``'s tail: candidate-order replay merge, serial fill-in
        for missing slots, archive recording.  ``factors`` narrows the
        slice to the rung's confirmed frontier when pruning dispatched a
        subset."""
        out = self._merge_results(ctx, s, pend.base, sweep,
                                  pend.factors if factors is None
                                  else factors, results)
        self._record_archive(ctx, s, out)
        return out


# --------------------------------------------------------------------------
# one ladder rung (shared by greedy / beam / parallel)
# --------------------------------------------------------------------------
_GUARD_MAX = 64


@dataclass
class _PendingRung:
    """Rung state carried between ``_rung_begin`` and ``_rung_finish``.

    The phase split exists for the wave-parallel beam: a wave runs every
    live state's ``_rung_begin`` first, dispatches the union of all
    pending rungs' candidates to the warm pool at once, then finishes
    each state in state order."""
    uid: int
    P: int
    prev: tuple                       # node snapshot at rung start
    base: tuple                       # st.base_snaps[uid]
    factors: List[Tuple[int, ...]]    # the rung's candidate set
    key: Optional[Tuple] = None       # cross-state dedup key (waves only)


def _rung_begin(ctx: SearchContext, st: LadderState,
                want_key: bool = False) -> Tuple[str, Optional[_PendingRung]]:
    """Everything a rung does before candidate evaluation: termination
    checks, bottleneck selection, per-node base recording, and the
    max-parallelism exit.  Returns ``("done", None)`` when the ladder is
    finished, ``("exit", None)`` when the bottleneck hit its parallelism
    cap (state mutated, rung over), or ``("eval", pend)``."""
    st.last_rung = None
    if not st.active or st.guard >= _GUARD_MAX:
        return "done", None
    st.guard += 1
    uid = _critical_bottleneck(ctx, st)
    if uid is None:
        return "done", None
    s = ctx.by_uid[uid]
    if uid not in st.base_snaps:
        st.base_snaps[uid] = _snapshot(s)
    band_cap = 1
    for d in s.dims:
        if d not in s.unrolls:
            band_cap *= s.trip_counts().get(d, 1)
    band_cap *= st.parallel_of[uid]
    P = st.parallel_of[uid] * 2
    if P > min(ctx.max_parallel, band_cap):
        st.active.remove(uid)
        st.actions.append(f"exit {s.name}: max parallelism")
        return "exit", None
    prev = _snapshot(s)
    pend = _PendingRung(uid, P, prev, st.base_snaps[uid],
                        [tuple(f) for f in unroll_candidates(P)])
    if want_key:
        # cross-state dedup key: the whole-design signature with the rung
        # node put back on its per-node base.  Candidates re-apply their
        # factors to that base, so two states with equal keys evaluate
        # literally identical candidate sets — the beam evaluates once and
        # credits every state that proposed it.  Signature recomputation
        # and the restore dance are memo-hit-only here (the state was just
        # live), so the key costs no counter and no analysis work.
        _restore_node(ctx.fn, s, pend.base)
        pend.key = (design_signature(ctx.fn), uid, P)
        _restore_node(ctx.fn, s, prev)
    return "eval", pend


def _rung_sweep(ctx: SearchContext, st: LadderState, pend: _PendingRung):
    """Per-rung closed-form ii(unroll_vector): built once from the rung
    *base* (the state candidates re-apply their factors to — the live
    state diverges from it once a rung has been accepted), it both
    pre-warms the base dependence classes/loop bounds every candidate
    transfers from and primes each applied candidate's recurrence II
    (see the evaluators), so the design report's II lookup is a hit."""
    if not caching.analytic_on():
        return None
    s = ctx.by_uid[pend.uid]
    _restore_node(ctx.fn, s, pend.base)
    sweep = ctx.model.closed_form_ii(s)
    _restore_node(ctx.fn, s, pend.prev)
    if sweep is not None:
        # POM_II_THREADS > 1 shards the rung's pure-integer II sweep
        # across threads before the evaluators consume it (memoized, so
        # every later ii() lookup is a dictionary hit)
        sweep.prefetch(pend.factors)
    return sweep


def _rung_finish(ctx: SearchContext, st: LadderState, pend: _PendingRung,
                 cands: List[Candidate], sweep) -> bool:
    """Accept/reject decision of one rung (the tail of the pre-split
    ``_rung``): pick the candidate that most improves the bottleneck
    *node* (first strict improvement wins ties, matching the
    pre-subsystem ladder) and accept when it does so without regressing
    the design (paper §VI-B: optimize the bottleneck, switch when it no
    longer is one)."""
    uid, P, prev = pend.uid, pend.P, pend.prev
    s = ctx.by_uid[uid]
    best = _best_candidate(s, cands)
    if (best is not None
            and best.report.nodes[s.name].latency < st.report.nodes[s.name].latency
            and best.report.latency <= st.report.latency):
        _restore_node(ctx.fn, s, best.snap)
        st.parallel_of[uid] = P
        st.report = best.report
        st.actions.append(
            f"parallel {s.name} -> {P} "
            f"(lat {st.report.nodes[s.name].latency}, "
            f"II {st.report.nodes[s.name].ii})")
        st.last_rung = RungInfo(uid, P, prev, cands, best, sweep)
    else:
        _restore_node(ctx.fn, s, prev)
        st.report = ctx.design_report()
        st.active.remove(uid)
        st.actions.append(f"exit {s.name}: no feasible improvement at P={P}")
        st.last_rung = RungInfo(uid, P, prev, cands, None, sweep)
    return True


def _rung_impl(ctx: SearchContext, st: LadderState, evaluator,
               branching: bool = False) -> bool:
    kind, pend = _rung_begin(ctx, st)
    if kind == "done":
        return False
    if kind == "exit":
        return True
    s = ctx.by_uid[pend.uid]
    sweep = _rung_sweep(ctx, st, pend)
    cands = evaluator.evaluate(ctx, st, s, pend.uid, pend.P, sweep,
                               branching=branching)
    return _rung_finish(ctx, st, pend, cands, sweep)


def _rung_telemetry(ctx: SearchContext, counts0: Dict[str, int],
                    stats0: CostStats) -> Dict[str, Any]:
    """Eval-count / cache-delta span arguments for one rung or wave —
    read-only counter arithmetic, issued only when a trace is active."""
    c = caching.counts_delta(counts0)
    d = ctx.model.stats.delta(stats0)
    return {"analysis_evals": caching.analysis_evals(c),
            "cache_hits": (c["selfdep_hits"] + c["legal_hits"]
                           + c["trip_hits"] + c["access_hits"]),
            "transfers": (c["selfdep_transfers"] + c["legal_transfers"]
                          + c["trip_transfers"]),
            "node_evals": d["node_evals"],
            "design_evals": d["design_evals"],
            "design_cache_hits": d["design_cache_hits"],
            "confirmed_evals": d["confirmed_evals"],
            "pruned_candidates": d["pruned_candidates"]}


def _rung(ctx: SearchContext, st: LadderState, evaluator,
          branching: bool = False) -> bool:
    """Advance ``st`` by one rung of the bottleneck ladder (the loop body of
    the pre-subsystem ``stage2``).  Returns False when the ladder is done.

    ``branching`` tells the evaluator whether runner-up candidates feed
    beam branching (static bound pruning only) or only the argmin matters
    (two-round pruning).

    With a trace active, the rung runs under a ``stage2.rung`` span
    carrying the bottleneck statement, target parallelism, accept/reject
    outcome, and the rung's eval-count / cache-hit deltas — all read from
    counters the rung moves anyway, never adding queries of its own."""
    if not telemetry.on():
        return _rung_impl(ctx, st, evaluator, branching)
    counts0 = dict(caching.COUNTS)
    stats0 = copy.copy(ctx.model.stats)
    with telemetry.span("stage2.rung", _cat="dse") as sp:
        more = _rung_impl(ctx, st, evaluator, branching)
        sp.add(**_rung_telemetry(ctx, counts0, stats0))
        info = st.last_rung
        if info is not None:
            s = ctx.by_uid.get(info.uid)
            sp.add(statement=s.name if s is not None else info.uid,
                   P=info.P, candidates=len(info.cands),
                   accepted=info.chosen is not None)
    return more


# --------------------------------------------------------------------------
# strategies
# --------------------------------------------------------------------------
class SearchStrategy:
    """Base of the pluggable stage-2 searchers."""
    name: str = "?"

    def run(self, ctx: SearchContext) -> LadderState:
        raise NotImplementedError

    def describe(self) -> str:
        return self.name


STRATEGIES: Dict[str, Callable[..., "SearchStrategy"]] = {}


def register_strategy(name: str):
    def deco(cls):
        STRATEGIES[name] = cls
        cls.name = name
        return cls
    return deco


@register_strategy("greedy")
class GreedySearch(SearchStrategy):
    """The paper's single-trajectory bottleneck ladder (pre-subsystem
    ``stage2``), re-expressed as rung + serial evaluator + accept rule."""

    def __init__(self, evaluator=None):
        self.evaluator = evaluator or SerialEvaluator()

    def run(self, ctx: SearchContext) -> LadderState:
        st = _init_ladder(ctx)
        st.lineage = True
        try:
            while _rung(ctx, st, self.evaluator):
                pass
        finally:
            self.evaluator.close()
        return st


@register_strategy("parallel")
class ParallelSearch(GreedySearch):
    """Greedy ladder with pool-parallel candidate evaluation.  With
    ``workers=1`` this *is* the serial greedy ladder (same code path)."""

    def __init__(self, workers: Optional[int] = None):
        w = int(workers) if workers else (os.cpu_count() or 1)
        super().__init__(SerialEvaluator() if w <= 1 else PoolEvaluator(w))
        self.workers = w

    def describe(self) -> str:
        return f"parallel:{self.workers}"


@register_strategy("beam")
class BeamSearch(SearchStrategy):
    """Anchored beam search over ladder states.

    Slot 0 of the beam is pinned to the pure-greedy trajectory (its greedy
    successor always survives selection), so the final design is provably
    never worse than ``greedy``'s; the remaining ``width - 1`` slots hold
    the best other successors by design latency: runner-up candidates of
    an accepted rung and the early-exit branch (stop optimizing the
    bottleneck node, spend resources elsewhere).  With ``width=1`` the
    search degenerates to exactly the greedy trajectory.

    When several states are live, each iteration runs as a **wave**
    (``_wave``): all states' rung preambles first, then one pooled
    dispatch of the union of their candidate sets (when the evaluator is
    a :class:`PoolEvaluator` — ``beam:k:parallel``), then per-state
    merge/decide in state order.  States whose pending rung re-evaluates
    an identical ``(base design, statement, P)`` — sibling branches of
    one rung always do — share a single evaluation (**dedup-and-credit**,
    tallied in ``wave_stats``), which is what keeps ``beam:8`` within a
    small factor of ``greedy`` wall-clock even single-core.  Serial and
    pooled beams run the same wave code minus the dispatch, so results
    and counters are bit-identical for any worker count.
    """

    def __init__(self, width: int = 2, evaluator=None,
                 rank: Optional[str] = None):
        self.width = max(1, int(width))
        self.evaluator = evaluator or SerialEvaluator()
        self.rank = rank or os.environ.get("POM_BEAM_RANK", "latency")
        if self.rank not in ("latency", "scalar"):
            raise ValueError(f"beam rank must be 'latency' or 'scalar', "
                             f"got {self.rank!r} (constructor, 'beam:k:rank' "
                             f"spec, or POM_BEAM_RANK)")
        self._resources: Dict = {}
        # cross-state dedup accounting, reset per run(): rungs/candidates
        # actually evaluated vs credited from an identical sibling rung
        self.wave_stats: Dict[str, int] = {}

    def describe(self) -> str:
        out = f"beam:{self.width}"
        if self.rank != "latency":
            out += f":{self.rank}"
        if isinstance(self.evaluator, PoolEvaluator):
            out += ":parallel"
        return out

    def _rank_value(self, state: LadderState):
        """Beam-retention rank of a successor state.

        ``latency`` (default) keeps the PR-3 behavior; ``scalar`` ranks by
        a latency x resource scalarization over the Pareto axes
        (``DesignReport.resource_vector``), so the non-anchored slots
        prefer designs that buy their latency with fewer DSPs/BRAMs and
        keep headroom for later rungs.  The anchored greedy slot and the
        final state selection stay latency-based, which preserves the
        cost <= greedy guarantee under either ranking.
        """
        rep = state.report
        if self.rank == "latency":
            return rep.latency
        dsp_cap = max(1, self._resources.get("dsp", 1))
        bram18_cap = max(1.0, self._resources.get("bram_bits", 18_000.0)
                         / 18_000.0)
        dsp, bram18 = rep.resource_vector
        return rep.latency * (1.0 + dsp / dsp_cap + bram18 / bram18_cap)

    def run(self, ctx: SearchContext) -> LadderState:
        self._resources = ctx.model.resources
        self.wave_stats = {"rungs_evaluated": 0, "rungs_credited": 0,
                           "cands_evaluated": 0, "cands_credited": 0}
        st = _init_ladder(ctx)
        st.lineage = True
        st.snap = _snapshot_fn(ctx.fn)
        st.sig = design_signature(ctx.fn)
        live, done = [st], []
        pool = (self.evaluator
                if isinstance(self.evaluator, PoolEvaluator) else None)
        try:
            while live:
                if len(live) == 1:
                    successors = self._step_single(ctx, live[0], done)
                else:
                    successors = self._wave(ctx, live, done, pool)
                live = self._select(successors)
        finally:
            self.evaluator.close()
        # unify the per-run dedup tallies into the metrics registry
        telemetry.merge_counters(self.wave_stats, prefix="search.wave.")
        best = min(enumerate(done),
                   key=lambda t: (t[1].report.latency,
                                  0 if t[1].lineage else 1, t[0]))[1]
        _restore_fn(ctx.fn, best.snap)
        return best

    def _step_single(self, ctx: SearchContext, cur: LadderState,
                     done: List[LadderState]
                     ) -> List[Tuple[int, LadderState]]:
        """One iteration with a single live state: the plain rung path
        (with ``width=1`` this is exactly the greedy trajectory; a pooled
        evaluator parallelizes within the rung as in ``parallel:n``)."""
        successors: List[Tuple[int, LadderState]] = []
        _restore_fn(ctx.fn, cur.snap)
        pre = cur.clone()
        pre.lineage = False
        progressed = _rung(ctx, cur, self.evaluator,
                           branching=self.width > 1)
        if not progressed:
            done.append(cur)
            return successors
        ws = self.wave_stats
        if cur.last_rung is not None:
            ws["rungs_evaluated"] += 1
            ws["cands_evaluated"] += len(unroll_candidates(cur.last_rung.P))
        cur.snap = _snapshot_fn(ctx.fn)
        cur.sig = design_signature(ctx.fn)
        successors.append((0, cur))
        seq = 1
        if self.width > 1 and cur.last_rung is not None:
            for alt in self._branches(ctx, pre, cur.last_rung):
                successors.append((seq, alt))
                seq += 1
        return successors

    def _wave(self, ctx: SearchContext, live: List[LadderState],
              done: List[LadderState], pool: Optional[PoolEvaluator]
              ) -> List[Tuple[int, LadderState]]:
        """Traced wrapper of :meth:`_wave_impl`: a ``stage2.wave`` span
        carrying live-state count, dedup credits, and eval-count deltas
        for this wave (read-only; absent overhead when tracing is off)."""
        if not telemetry.on():
            return self._wave_impl(ctx, live, done, pool)
        ws0 = dict(self.wave_stats)
        counts0 = dict(caching.COUNTS)
        stats0 = copy.copy(ctx.model.stats)
        with telemetry.span("stage2.wave", _cat="dse",
                            states=len(live)) as sp:
            out = self._wave_impl(ctx, live, done, pool)
            sp.add(**_rung_telemetry(ctx, counts0, stats0))
            sp.add(**{k: v - ws0.get(k, 0)
                      for k, v in self.wave_stats.items()})
        return out

    def _wave_impl(self, ctx: SearchContext, live: List[LadderState],
                   done: List[LadderState], pool: Optional[PoolEvaluator]
                   ) -> List[Tuple[int, LadderState]]:
        """One beam iteration over several live states, in three phases.

        Phase A (state order): run every state's rung preamble
        (``_rung_begin``) and compute its cross-state dedup key — all
        memo-hit work, no counters move.  Phase B: dispatch the union of
        all *distinct* pending rungs' candidates to the warm pool in one
        wave (pooled evaluator only).  Phase C (state order): for each
        state, either **credit** a rung an earlier state in this wave
        already evaluated (identical key ⇒ literally identical candidate
        sets, reports and snapshots — sibling branches of one rung always
        collide here), or charge the authoritative sweep and merge that
        rung's results at its serial position; then decide accept/reject
        and branch exactly as the single-state path does.  A serial
        evaluator runs the same phases minus the dispatch, so pooled and
        serial beams are bit-identical — counters, reports, actions —
        for any worker count."""
        successors: List[Tuple[int, LadderState]] = []
        seq = 0
        plans = []
        for cur in live:
            _restore_fn(ctx.fn, cur.snap)
            pre = cur.clone()
            kind, pend = _rung_begin(ctx, cur, want_key=True)
            plans.append((cur, pre, kind, pend))
        # bound-and-confirm: sibling states sharing a rung key may sit at
        # different pre-rung bottleneck latencies; the shared evaluation
        # must confirm the union of what every proposer needs, so the
        # per-key cutoff is the MAX over proposing states (a superset
        # frontier — still only provable losers are pruned)
        prune = caching.bound_prune_on()
        key_cutoff: Dict = {}
        if prune:
            for cur, _, kind, pend in plans:
                if kind != "eval":
                    continue
                s = ctx.by_uid[pend.uid]
                c = cur.report.nodes[s.name].latency
                old = key_cutoff.get(pend.key)
                key_cutoff[pend.key] = c if old is None or c > old else old
        wave_results: Dict = {}
        wave_plans: Dict = {}
        if pool is not None:
            entries = []
            keyed = {}
            sub_lists: Optional[List] = [] if prune else None
            for cur, _, kind, pend in plans:
                if kind == "eval" and pend.key not in keyed:
                    keyed[pend.key] = len(entries)
                    entries.append((cur.snap, pend))
                    if sub_lists is not None:
                        # plan the confirmed frontier before dispatch (in
                        # first-proposer order — the serial beam's sweep
                        # order, so counters replay identically)
                        sweep = _rung_sweep(ctx, cur, pend)
                        if sweep is None:
                            sub = list(pend.factors)
                        else:
                            _, frontier = _bound_plan(
                                ctx.model, sweep, pend.factors,
                                key_cutoff[pend.key])
                            sub = [pend.factors[i] for i in frontier]
                        wave_plans[pend.key] = (sweep, sub)
                        sub_lists.append(sub)
            by_sid = pool.evaluate_wave(ctx, entries, factors=sub_lists)
            wave_results = {entries[sid][1].key: res
                            for sid, res in by_sid.items()}
        ws = self.wave_stats
        shared: Dict = {}
        for cur, pre, kind, pend in plans:
            if kind == "done":
                done.append(cur)
                continue
            if kind == "exit":
                # schedule untouched: keep snap/sig; no last_rung, so no
                # branches — same successor the single-state path yields
                successors.append((seq, cur))
                seq += 1
                continue
            _restore_fn(ctx.fn, cur.snap)
            s = ctx.by_uid[pend.uid]
            hit = shared.get(pend.key)
            if hit is not None:
                sweep, cands = hit
                ws["rungs_credited"] += 1
                ws["cands_credited"] += len(pend.factors)
            else:
                plan = wave_plans.get(pend.key)
                if plan is not None:
                    # pooled + pruning: sweep and confirmed frontier were
                    # computed at dispatch time; never re-plan (the
                    # pruned-candidate charge already happened there)
                    sweep, sub = plan
                    res_list = wave_results.get(pend.key)
                    if res_list is None:
                        cands = pool._serial.evaluate_factors(
                            ctx, cur, s, pend.uid, sub, sweep)
                    else:
                        cands = pool.merge_wave_rung(ctx, s, pend, sweep,
                                                     res_list, factors=sub)
                else:
                    sweep = _rung_sweep(ctx, cur, pend)
                    res_list = wave_results.get(pend.key)
                    if res_list is None:
                        serial = pool._serial if pool is not None \
                            else self.evaluator
                        cands = serial.evaluate(
                            ctx, cur, s, pend.uid, pend.P, sweep,
                            cutoff=key_cutoff.get(pend.key), branching=True)
                    else:
                        cands = pool.merge_wave_rung(ctx, s, pend, sweep,
                                                     res_list)
                shared[pend.key] = (sweep, cands)
                ws["rungs_evaluated"] += 1
                ws["cands_evaluated"] += len(pend.factors)
            _rung_finish(ctx, cur, pend, cands, sweep)
            cur.snap = _snapshot_fn(ctx.fn)
            cur.sig = design_signature(ctx.fn)
            successors.append((seq, cur))
            seq += 1
            if self.width > 1 and cur.last_rung is not None:
                for alt in self._branches(ctx, pre, cur.last_rung):
                    successors.append((seq, alt))
                    seq += 1
        return successors

    # -- branching ----------------------------------------------------------
    def _branches(self, ctx: SearchContext, pre: LadderState,
                  info: RungInfo) -> List[LadderState]:
        """Alternative successors of one rung, built from the evaluations
        the rung already paid for (no extra model calls beyond cache hits)."""
        out: List[LadderState] = []
        s = ctx.by_uid[info.uid]
        for c in info.cands:
            if info.chosen is not None and c is info.chosen:
                continue
            if not c.report.feasible:
                continue
            if c.report.latency > pre.report.latency:
                continue
            if (c.report.nodes[s.name].latency
                    >= pre.report.nodes[s.name].latency):
                continue
            alt = pre.clone()
            alt.guard = pre.guard + 1
            # the rung added base_snaps[uid] to the greedy successor AFTER
            # `pre` was cloned; alts must carry the same clean per-node
            # base (info.prev == the clean state on a first visit), or a
            # later rung would re-split on top of this candidate's splits
            alt.base_snaps.setdefault(info.uid, info.prev)
            _restore_fn(ctx.fn, pre.snap)
            _restore_node(ctx.fn, s, c.snap)
            alt.parallel_of[info.uid] = info.P
            alt.report = c.report
            alt.actions.append(
                f"parallel {s.name} -> {info.P} "
                f"(lat {c.report.nodes[s.name].latency}, "
                f"II {c.report.nodes[s.name].ii}) [beam-alt {c.factors}]")
            alt.snap = _snapshot_fn(ctx.fn)
            alt.sig = design_signature(ctx.fn)
            out.append(alt)
        if info.chosen is not None:
            # early-exit branch: keep the node at its current parallelism
            # and let the ladder move to the next bottleneck
            alt = pre.clone()
            alt.guard = pre.guard + 1
            alt.active = [u for u in alt.active if u != info.uid]
            alt.actions.append(f"exit {s.name}: beam early-exit at "
                               f"P={pre.parallel_of[info.uid]}")
            alt.snap = pre.snap
            alt.sig = pre.sig
            out.append(alt)
        return out

    # -- selection ----------------------------------------------------------
    def _select(self, successors: List[Tuple[int, LadderState]]
                ) -> List[LadderState]:
        if not successors:
            return []
        keep: List[LadderState] = []
        seen: set = set()

        def key_of(state: LadderState) -> Tuple:
            return (state.sig, tuple(sorted(state.active)),
                    tuple(sorted(state.parallel_of.items())))

        anchored = [s for _, s in successors if s.lineage]
        if anchored:
            keep.append(anchored[0])
            seen.add(key_of(anchored[0]))
        ranked = sorted(((self._rank_value(s), seq, s)
                         for seq, s in successors if not s.lineage),
                        key=lambda t: (t[0], t[1]))
        for _, _, s in ranked:
            if len(keep) >= self.width:
                break
            k = key_of(s)
            if k in seen:
                continue
            seen.add(k)
            keep.append(s)
        return keep


# --------------------------------------------------------------------------
# strategy resolution + entry point
# --------------------------------------------------------------------------
def resolve_strategy(spec=None, beam_width: Optional[int] = None,
                     workers: Optional[int] = None) -> SearchStrategy:
    """Turn a strategy spec into a strategy instance.

    ``spec`` may be a :class:`SearchStrategy`, a registered name
    (``"greedy"``, ``"beam"``, ``"parallel"``), or a parameterized name.
    The beam grammar is ``beam[:k][:latency|scalar][:parallel[:n]]`` with
    the segments in any order — ``"beam:4"``, ``"beam:scalar"``,
    ``"beam:4:scalar"``, ``"beam:8:parallel"``, ``"beam:parallel:4"`` are
    all valid; a duplicate or unknown segment is a ``ValueError`` naming
    the original spec.  ``parallel`` puts the beam's rung waves on the
    warm worker pool (``:n`` workers; default ``os.cpu_count()``) —
    results are identical for any ``n`` by construction, so the token
    changes wall-clock only.

    Precedence when ``spec`` is None: a strategy-selecting keyword wins
    over the ambient environment — ``beam_width`` selects ``beam``, else
    ``workers`` selects ``parallel`` (the call site is more explicit than
    ``POM_DSE_STRATEGY``); otherwise the ``POM_DSE_STRATEGY`` environment
    variable (same syntax) decides; otherwise ``greedy``.  When both a
    spec and a matching keyword are given, the keyword overrides the
    matching spec segment: ``beam_width`` overrides the beam's ``:k``,
    and ``workers`` sizes the beam's pool (making a ``beam`` spec pooled
    if it wasn't — ``auto_dse(strategy="beam:8", workers=4)`` is the
    kwargs spelling of ``"beam:8:parallel:4"``).  A ``:k`` suffix on a
    strategy that takes no parameter is an error, reported against the
    original spec.
    """
    if isinstance(spec, SearchStrategy):
        return spec
    if isinstance(spec, type) and issubclass(spec, SearchStrategy):
        return spec()
    if spec is None:
        if beam_width is not None:
            spec = "beam"
        elif workers is not None:
            spec = "parallel"
        else:
            spec = os.environ.get("POM_DSE_STRATEGY") or "greedy"
    name, _, arg = str(spec).partition(":")
    if name not in STRATEGIES:
        raise ValueError(f"unknown DSE strategy {name!r} "
                         f"(registered: {sorted(STRATEGIES)})")
    if name == "beam":
        width = rank = pool_workers = None
        pooled = False
        toks = [t for t in arg.split(":") if t] if arg else []
        i = 0
        while i < len(toks):
            t = toks[i]
            if t.lstrip("-").isdigit():
                if width is not None:
                    raise ValueError(f"duplicate beam width {t!r} in "
                                     f"{spec!r}")
                width = int(t)
            elif t in ("latency", "scalar"):
                if rank is not None:
                    raise ValueError(f"duplicate beam rank {t!r} in "
                                     f"{spec!r}")
                rank = t
            elif t == "parallel":
                if pooled:
                    raise ValueError(f"duplicate 'parallel' in {spec!r}")
                pooled = True
                if i + 1 < len(toks) and toks[i + 1].lstrip("-").isdigit():
                    i += 1
                    pool_workers = int(toks[i])
            else:
                raise ValueError(
                    f"bad beam spec segment {t!r} in {spec!r} (want "
                    f"beam[:k][:latency|scalar][:parallel[:n]])")
            i += 1
        if beam_width is not None:
            width = beam_width
        if workers is not None:
            pooled = True
            pool_workers = workers
        evaluator = PoolEvaluator(pool_workers) if pooled else None
        return BeamSearch(width=2 if width is None else width,
                          rank=rank, evaluator=evaluator)
    if name == "parallel":
        w = workers if workers is not None else (int(arg) if arg else None)
        return ParallelSearch(workers=w)
    if arg:
        raise ValueError(f"strategy {name!r} takes no ':{arg}' parameter "
                         f"(got {spec!r})")
    return STRATEGIES[name]()


def _dataflow_step(ctx: SearchContext, st: LadderState) -> None:
    """Stage-2 dataflow search dimension: evaluate the final design under
    both aggregations — sequential and task-pipelined — archive both
    points (latency vs channel-BRAM trade-off), and pin the winner on the
    function (``fn.dataflow``), so downstream codegen emits exactly the
    schedule the search chose.

    An explicit ``fn.dataflow = True`` pin (``auto_dse(dataflow=True)``,
    DSL toggle, or ``HlsModel(dataflow=True)``) is honored: the step
    records both archive points but never un-pins the function — codegen
    then emits the requested region even when the model judged the
    overlap not beneficial.

    Skipped entirely (zero model/analysis calls) when dataflow is off for
    the function (``POM_DATAFLOW=0`` or an explicit ``dataflow=False``) or
    the design has fewer than two tasks — which is what keeps the
    dataflow-off engine bit-identical to the sequential one."""
    from .graph_ir import dataflow_effective, fusion_tasks
    fn = ctx.fn
    if not dataflow_effective(fn):
        return
    if len(fusion_tasks(fn)) < 2:
        return
    pinned = fn.dataflow is True
    prev = fn.dataflow
    try:
        fn.dataflow = False
        rep_off = ctx.design_report()
        fn.dataflow = True
        rep_on = ctx.design_report()
    except Exception:
        fn.dataflow = prev
        raise
    applied = rep_on.dataflow is not None and rep_on.dataflow.applied
    if pinned or (applied and rep_on.latency < rep_off.latency and (
            rep_on.feasible or not rep_off.feasible)):
        fn.dataflow = True
        st.report = rep_on
        d = rep_on.dataflow
        kinds = ",".join(f"{c[0]}:{c[3]}" for c in (d.channels if d else ()))
        st.actions.append(
            f"dataflow on{' (pinned)' if pinned and not applied else ''}: "
            f"lat {rep_on.latency} vs {rep_off.latency} "
            f"sequential (+{rep_on.bram18 - rep_off.bram18} bram18; "
            f"channels {kinds or 'none'})")
    else:
        fn.dataflow = False
        st.report = rep_off
        reason = ("not beneficial" if rep_on.dataflow is None
                  else rep_on.dataflow.reason or "not beneficial")
        st.actions.append(f"dataflow off: {reason}")


def run_stage2(fn: Function, model: Optional[HlsModel] = None,
               max_parallel: int = 256,
               actions: Optional[List[str]] = None,
               strategy=None, archive: Optional[ParetoArchive] = None,
               beam_width: Optional[int] = None,
               workers: Optional[int] = None) -> DesignReport:
    """Stage-2 entry point: run the selected search strategy, then the
    dataflow on/off decision step (``_dataflow_step``).

    This is what ``dse.stage2`` and the stage-2 pipeline passes call; with
    the default (greedy) strategy — and dataflow off — it is bit-identical
    — schedules, reports, action logs, evaluation counters — to the
    pre-subsystem ladder.
    """
    model = model or HlsModel()
    # a model-level dataflow override is materialized on the function so
    # the search decision, the Pareto-archive signatures, and downstream
    # codegen all agree with what the evaluator actually modeled
    if fn.dataflow is None and model._dataflow_flag is not None:
        fn.dataflow = bool(model._dataflow_flag)
    strat = resolve_strategy(strategy, beam_width=beam_width, workers=workers)
    ctx = SearchContext(fn=fn, model=model, max_parallel=max_parallel,
                        archive=archive, strategy_name=strat.describe())
    st = strat.run(ctx)
    _dataflow_step(ctx, st)
    if actions is not None:
        actions.extend(st.actions)
    return st.report
