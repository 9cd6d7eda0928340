"""Two-stage design space exploration (paper SS VI).

``auto_dse`` runs both stages as passes of the ``pipeline.PassManager``
(graph build/verify → stage 1 → poly verify → stage 2 → poly verify), so
DSE candidates are evaluated against pipeline stages — the cost model is
the stage-2 evaluator handed in through the pipeline context — and the
per-stage verifiers re-check every search result.

Stage 1 — *dependence-aware code transformation*: iteratively re-check
loop-carried dependences and apply interchange / distribution /
skew(+interchange) until no node has a tight dependence or the iteration
bound is reached; conservatively re-fuse at the end (Fig. 10's
split-interchange-merge).

Stage 2 — *bottleneck-oriented code optimization*: estimate per-node latency,
order data paths by latency, pick the bottleneck node of the critical path,
and raise its parallelism degree (tile + pipeline + unroll + array
partition) step by step until resources run out, it stops being the
bottleneck, or max parallelism is reached (the exit mechanism of SS VI-B).

Stage 2 is pluggable (PR 3): the searcher lives in ``search.py`` behind a
strategy registry — ``greedy`` (the ladder above, bit-identical to the
pre-subsystem engine), ``beam`` (top-k parallelization states per rung),
and ``parallel`` (worker-pool candidate evaluation with deterministic
cache/counter merge).  Select with ``auto_dse(strategy=...)`` or
``POM_DSE_STRATEGY``; every evaluated design lands in an optional
``search.ParetoArchive`` (``archive=...`` / ``POM_DUMP_PARETO``).

Incremental evaluation
----------------------
The search loop is memoization-friendly by design and relies on the
signature-keyed caches in ``ir.py`` / ``transforms.py`` /
``cost_model.py`` (toggle: ``repro_torch.core.caching``):

* every candidate schedule is identified by its statements' structural
  ``schedule_signature()``s — signatures are recomputed from live state on
  each lookup, so snapshot/restore backtracking can never observe a stale
  cached value;
* a stage-2 candidate mutates ONE node, so ``design_report`` re-costs only
  that node plus statements sharing a repartitioned array (dirty set =
  cache-key mismatch), then re-aggregates the cheap design totals;
* rejected rungs restore the previous schedule, which is a whole-design
  cache hit; ``DepGraph.paths()`` is computed once because schedule
  transforms never change the coarse producer/consumer topology;
* ``refresh_partitions`` combines per-statement partition *contributions*
  memoized on (iter_subst, unrolls), so a single-statement mutation only
  recomputes that statement's contribution before the cheap max-merge.

Invariants (asserted by ``tests/test_incremental_dse.py`` and
``tests/test_search.py``): cached and uncached runs produce identical
``DesignReport`` numbers and identical action logs on every workload;
``strategy="greedy"`` is bit-identical to the pre-subsystem engine;
measured counts live in ``HlsModel.stats`` / ``DseResult.cost_stats``.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .cost_model import CostStats, DesignReport, HlsModel, XC7Z020
from .depgraph import NodeInfo
from .ir import Function, Statement
from . import transforms as T
# schedule snapshotting, candidate generation/application, and the search
# strategies themselves live in the search subsystem; re-exported here for
# backward compatibility (benchmarks/tests import them from ``dse``)
from .search import (ParetoArchive, _restore, _restore_fn, _snapshot,
                     _snapshot_fn, apply_parallel as _apply_parallel,
                     run_stage2, unroll_candidates as _unroll_candidates)
from . import caching


# --------------------------------------------------------------------------
# Stage 1: dependence-aware code transformation
# --------------------------------------------------------------------------
@dataclass
class Stage1Log:
    actions: List[str] = field(default_factory=list)
    # fusion specs *created* by stage 1 (consumer, producer, level) — the
    # poly verifier dependence-checks exactly these (user-authored `after`
    # specs define program semantics and are not re-fusion transforms)
    fused: List[Tuple[str, str, int]] = field(default_factory=list)

    def add(self, msg: str):
        self.actions.append(msg)


def _is_tight(stmt: Statement, threshold: int = 1) -> bool:
    g_node = NodeInfo(stmt, _self_deps(stmt), [])
    return bool(g_node.tight(threshold))


def _self_deps(stmt: Statement):
    from .transforms import self_dependences
    return self_dependences(stmt)


def _desired_inner_dims(stmt: Statement) -> List[str]:
    """Dims that can be innermost without a tight carried dependence."""
    deps = [d for d in _self_deps(stmt) if d.loop_carried_level is not None]
    out = []
    for k, d in enumerate(stmt.dims):
        ok = True
        for dep in deps:
            for dist in dep.levels.values():
                # this dep component would be carried at the innermost level
                # iff every *other* dim has zero distance and this dim's
                # entry is nonzero
                others_zero = all(
                    (dist[j] == 0) for j in range(len(stmt.dims)) if j != k)
                this_nonzero = dist[k] is None or dist[k] != 0
                if others_zero and this_nonzero:
                    ok = False
                    break
            if not ok:
                break
        if ok:
            out.append(d)
    return out


def _move_innermost(stmt: Statement, d: str) -> None:
    order = [x for x in stmt.dims if x != d] + [d]
    old = stmt.domain
    T.permute_dims(stmt, order)
    if not T._legal(stmt):
        stmt.domain = old
        raise T.IllegalTransform(f"cannot move {d} innermost in {stmt.name}")


def stage1(fn: Function, max_iters: int = 6, log: Optional[Stage1Log] = None) -> Stage1Log:
    log = log or Stage1Log()
    for it in range(max_iters):
        changed = False
        # --- conflict detection inside fusion groups -> distribution --------
        from .cost_model import _fusion_groups
        for grp in _fusion_groups(fn):
            if len(grp) < 2:
                continue
            wants: List[Optional[str]] = []
            for s in grp:
                if _is_tight(s):
                    cands = _desired_inner_dims(s)
                    wants.append(cands[0] if cands else None)
                else:
                    wants.append("__keep__")
            tight_members = [w for w in wants if w != "__keep__"]
            if tight_members and len(grp) > 1:
                # conflicting strategies (paper Fig. 10(1)): distribute
                for s in grp:
                    if s.after_spec is not None:
                        s.after_spec = None
                log.add(f"distribute group {[s.name for s in grp]}")
                changed = True
        # --- per-node transforms ------------------------------------------------
        for s in fn.statements:
            if not _is_tight(s):
                continue
            fixed = False
            # (a) interchange: move a dependence-free dim innermost
            for d in _desired_inner_dims(s):
                if d == s.dims[-1]:
                    continue
                try:
                    _move_innermost(s, d)
                    if not _is_tight(s):
                        log.add(f"interchange {s.name}: {d} -> innermost "
                                f"(order {s.dims})")
                        fixed = changed = True
                        break
                except T.IllegalTransform:
                    continue
            if fixed:
                continue
            # (b) skew(+interchange) for 2-deep bands (stencil wavefronts)
            if len(s.dims) >= 2:
                o, i = s.dims[-2], s.dims[-1]
                for f in (1, 2):
                    snap = _snapshot(s)
                    try:
                        T.skew(s, o, i, f, o + "_sk", i + "_sk")
                        T.interchange(s, o + "_sk", i + "_sk")
                        if not _is_tight(s):
                            log.add(f"skew+interchange {s.name} f={f} "
                                    f"(order {s.dims})")
                            fixed = changed = True
                            break
                        _restore(s, snap)
                    except T.IllegalTransform:
                        _restore(s, snap)
                if fixed:
                    continue
        if not changed:
            break
    # --- conservative re-fusion (paper Fig. 10(3)) -----------------------------
    stmts = fn.statements
    for a, b in zip(stmts, stmts[1:]):
        if b.after_spec is None and len(a.dims) == len(b.dims):
            ta, tb = a.trip_counts(), b.trip_counts()
            if list(ta.values()) == list(tb.values()):
                levels = len(a.dims)
                if T.fuse_legal(b, a, levels) and not _is_tight(a) and not _is_tight(b):
                    T.set_after(b, a, levels - 1)
                    log.add(f"fuse {b.name} after {a.name} at level {levels - 1}")
                    log.fused.append((b.name, a.name, levels - 1))
    return log


# --------------------------------------------------------------------------
# array partitioning (derived schedule state shared by all strategies)
# --------------------------------------------------------------------------
def _partition_contribution(stmt: Statement) -> List[Tuple]:
    """This statement's cyclic-partition demands as ordered
    ``(array, dim_no, capped_factor)`` triples — a pure function of
    (iter_subst, unrolls), memoized on that signature so a candidate
    evaluation only recomputes the mutated statement's contribution."""
    key = None
    if caching.ENABLED:
        key = (stmt.subst_signature(), tuple(sorted(stmt.unrolls.items())))
        hit = stmt._part_cache.get(key)
        if hit is not None:
            return hit
    contrib: List[Tuple] = []
    refs = [(stmt.store.array, stmt.store_access()[1])] + \
        [(arr, idx) for arr, idx in stmt.load_accesses()]
    for arr, idx in refs:
        for dim_no, e in enumerate(idx):
            f = 1
            for d1, uf in stmt.unrolls.items():
                if e.coeff(d1) != 0:
                    f *= max(uf, 1)
            if f > 1:
                contrib.append((arr, dim_no, min(f, 64)))
    if key is not None:
        stmt._part_cache[key] = contrib
    return contrib


# Whole-function partition-state memo: the derived partition maps are a
# pure function of every statement's (composed accesses, unrolls), so one
# rebuild serves every later revisit of the same design state — the search
# restores/reapplies the same few dozen schedule states hundreds of times
# per run.  Values are stored immutably (items + ready signature) and
# fresh dicts are installed on a hit.  Cleared by ``caching.clear_all``.
_REFRESH_CACHE: Dict[Tuple, Tuple] = {}


def refresh_partitions(fn: Function) -> None:
    """Derive array partitioning from every statement's current unrolls
    (paper Fig. 6: cyclic partition factors match the unroll factors touching
    each array dimension).  Partitions are pure derived state during DSE —
    recombined from per-statement memoized contributions (or restored from
    the whole-function memo) on every call — so backtracking stays
    consistent across statements sharing arrays."""
    if not caching.ENABLED:
        _refresh_partitions_compute(fn)
        return
    key = tuple((s.uid, s.subst_signature(), tuple(sorted(s.unrolls.items())))
                for s in fn.statements if s.unrolls)
    hit = _REFRESH_CACHE.get(key)
    if hit is not None:
        for ph, (items, psig) in zip(fn.placeholders.values(), hit):
            if ph._psig == psig:      # already in this exact state
                continue
            ph.partitions = dict(items)
            ph._psig = psig
        return
    _refresh_partitions_compute(fn)
    if len(_REFRESH_CACHE) >= 8192:
        _REFRESH_CACHE.clear()
    _REFRESH_CACHE[key] = tuple(
        (tuple(ph.partitions.items()), ph.part_sig())
        for ph in fn.placeholders.values())


def _refresh_partitions_compute(fn: Function) -> None:
    for ph in fn.placeholders.values():
        ph.partitions = {}
    for stmt in fn.statements:
        if not stmt.unrolls:
            continue
        for arr, dim_no, f in _partition_contribution(stmt):
            ph = fn.placeholders.get(arr.name, arr)
            prev = ph.partitions.get(dim_no, (1, "cyclic"))[0]
            ph.partitions[dim_no] = (max(prev, f), "cyclic")
    # cap total banks per array at 64 (BRAM reality: beyond that the banking
    # costs more BRAM18s than the data): shrink the largest factor; the II
    # model then charges the resulting port conflicts.
    for ph in fn.placeholders.values():
        def banks():
            b = 1
            for (f, _k) in ph.partitions.values():
                b *= f
            return b
        while banks() > 64:
            dim = max(ph.partitions, key=lambda d: ph.partitions[d][0])
            f, kind = ph.partitions[dim]
            if f <= 2:
                ph.partitions.pop(dim)
            else:
                ph.partitions[dim] = (f // 2, kind)


# --------------------------------------------------------------------------
# Stage 2: bottleneck-oriented code optimization (delegates to search.py)
# --------------------------------------------------------------------------
def stage2(fn: Function, model: Optional[HlsModel] = None,
           max_parallel: int = 256, actions: Optional[List[str]] = None,
           strategy=None, archive: Optional[ParetoArchive] = None,
           **strategy_kw) -> DesignReport:
    """Run the bottleneck ladder with the selected search strategy.

    With the default (greedy) strategy this is bit-identical to the
    pre-subsystem single-trajectory ladder; see ``search.py`` for the
    ``beam`` and ``parallel`` alternatives."""
    return run_stage2(fn, model, max_parallel, actions,
                      strategy=strategy, archive=archive, **strategy_kw)


@dataclass
class DseResult:
    report: DesignReport
    stage1_log: Stage1Log
    actions: List[str]
    dse_seconds: float
    tile_sizes: Dict[str, List[int]]     # per statement: unroll factor per dim
    cost_stats: Optional["CostStats"] = None   # model eval/hit counters
    archive: Optional[ParetoArchive] = None    # latency/resource frontier
    strategy: str = "greedy"                   # which searcher produced it
    dataflow: Optional[bool] = None            # stage-2 dataflow decision


# --------------------------------------------------------------------------
# entry point: f.auto_DSE()
# --------------------------------------------------------------------------
def auto_dse(fn: Function, target: str = "fpga", max_parallel: int = 256,
             resources: Dict = XC7Z020,
             model: Optional[HlsModel] = None,
             strategy=None, beam_width: Optional[int] = None,
             workers: Optional[int] = None,
             archive=None, graph_passes: Sequence[str] = (),
             outputs: Optional[Sequence[str]] = None,
             dataflow: Optional[bool] = None,
             trace_path: Optional[str] = None) -> DseResult:
    """Run both DSE stages as a ``pipeline.PassManager`` pipeline:

        build graph → verify graph → [dce if outputs narrow the graph]
        → CSE classes → [extra graph passes] → lower to poly
        → stage 1 → verify poly → stage 2 → verify poly

    The per-stage verifiers run counter-paused, so evaluation counts (and
    therefore the DSE-speed benchmarks) are identical to driving the two
    stages directly.  Pass an ``HlsModel`` to control caching
    (``HlsModel(cache=False)`` reproduces the pre-incremental engine) or to
    read back ``model.stats`` evaluation counters afterwards.

    ``strategy`` selects the stage-2 searcher (``"greedy"`` / ``"beam"`` /
    ``"parallel"``, a ``search.SearchStrategy``, or None → the
    ``POM_DSE_STRATEGY`` environment variable, default greedy);
    ``beam_width`` / ``workers`` parameterize it.  ``archive`` collects
    every evaluated design into a ``search.ParetoArchive`` (pass an
    instance or ``True``); ``POM_DUMP_PARETO=<path|->`` dumps the
    frontier after the run.  ``outputs`` names the externally observable
    arrays (enables graph-level dead-op elimination); ``graph_passes``
    inserts extra named graph passes (e.g. ``("fuse",)``) ahead of the
    polyhedral stages.  ``dataflow`` pins the task-level-pipelining toggle
    on the function (True/False; None keeps the ``POM_DATAFLOW``-defaulted
    stage-2 on/off search — see ``search._dataflow_step``).

    ``trace_path`` (or ``POM_TRACE``) opens a telemetry trace session for
    this run — Chrome trace-event JSON to a path, a compact tree summary
    to stdout for ``"-"``.  The returned ``report.telemetry`` carries the
    per-run metrics snapshot (analysis evals, cost-model counters,
    wave/pool deltas) whether or not tracing was on."""
    from . import caching, telemetry
    from .pipeline import (GRAPH_PASSES, BuildGraph, GraphCSE, GraphDCE,
                           LowerToPoly, PassManager, PipelineContext,
                           Stage1DSE, Stage2DSE, VerifyGraph, VerifyPoly)
    t0 = time.perf_counter()
    if dataflow is not None:
        fn.dataflow = bool(dataflow)
    model = model or HlsModel(resources)
    if archive is True:
        archive = ParetoArchive()
    ctx = PipelineContext(fn=fn, target=target,
                          options={"max_parallel": max_parallel,
                                   "model": model,
                                   "strategy": strategy,
                                   "beam_width": beam_width,
                                   "workers": workers,
                                   "archive": archive})
    # CSE classification only (warm=()): grouping feeds the dump/debug
    # surface while the name-canonical memos themselves are populated on
    # first use, keeping the engines' evaluation counts untouched.
    passes = [BuildGraph(outputs), VerifyGraph()]
    if outputs is not None:
        passes.append(GraphDCE())
    passes.append(GraphCSE(warm=()))
    for name in graph_passes:
        passes.append(GRAPH_PASSES[name]())
    passes += [LowerToPoly(), Stage1DSE(), VerifyPoly(),
               Stage2DSE(), VerifyPoly()]
    counts0 = dict(caching.COUNTS)
    stats0 = copy.copy(model.stats)
    pool0 = telemetry.REGISTRY.counter_values("pool.")
    with telemetry.maybe_trace(trace_path):
        with telemetry.span("auto_dse", _cat="dse", fn=fn.name,
                            target=target):
            PassManager(passes).run(ctx)
    log = ctx.records["stage1"]
    report = ctx.records["stage2"]["report"]
    actions = ctx.records["stage2"]["actions"]
    strat = ctx.records["stage2"].get("strategy", "greedy")
    # the stage-2 pass creates the archive when POM_DUMP_PARETO asked for
    # one and none was passed; surface it on the result either way
    archive = ctx.records["stage2"].get("archive", archive)
    dt = time.perf_counter() - t0
    tiles: Dict[str, List[int]] = {}
    for s in ctx.fn.statements:
        # report unroll factor per current loop dim (1 when untouched)
        tiles[s.name] = [s.unrolls.get(d, 1) for d in s.dims]
    # per-run metrics snapshot (the bench/CI telemetry schema): counter
    # *movement* over this run, never perturbing anything it reads
    counts = caching.counts_delta(counts0)
    pool1 = telemetry.REGISTRY.counter_values("pool.")
    strat_obj = ctx.records["stage2"].get("strategy_obj")
    wave = dict(getattr(strat_obj, "wave_stats", None) or {})
    report.telemetry = {
        "strategy": strat,
        "analysis_evals": caching.analysis_evals(counts),
        "caching": counts,
        "cost": model.stats.delta(stats0),
        "bound_prune": caching.bound_prune_on(),
        "wave": wave or None,
        "pool": {k[len("pool."):]: pool1.get(k, 0) - pool0.get(k, 0)
                 for k in sorted(set(pool0) | set(pool1))},
        "dse_seconds": dt,
    }
    return DseResult(report, log, actions, dt, tiles, model.stats,
                     archive, strat, ctx.fn.dataflow)
