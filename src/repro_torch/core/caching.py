"""Global switch + counters for POM's incremental-evaluation layer.

Every memoization cache in the analysis/search stack (composed accesses and
trip counts in ``ir.py``, ``self_dependences``/``_legal`` in
``transforms.py``, ``DepGraph.paths`` in ``depgraph.py``, per-node and
whole-design cost reports in ``cost_model.py``, partition contributions in
``dse.py``, kernel lowering in ``backend_cuda.py``) consults
``caching.ENABLED``.  Disabling it restores the pre-incremental engine
exactly: all results are recomputed from scratch on every query.

Cache keys are *structural signatures* recomputed from the current schedule
state on every lookup — never version counters — so a cache can return a
stale value only if two different schedule states produce the same
signature, which the signature definitions rule out by construction.  This
is what makes cached and uncached runs bit-for-bit identical (asserted by
``tests/test_incremental_dse.py``).

``COUNTS`` tracks evaluation/hit counters for the polyhedral layer; the
cost-model layer keeps its own per-model ``CostStats`` (a shared model can
be handed to ``auto_dse`` to read them back).
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Dict

ENABLED: bool = True

# Analytic dependence transfer (change-of-basis algebra on dependence
# vectors, ``affine.BasisMap``): when on, transforms push cached
# dependence/trip/legality facts through the basis map they apply instead
# of letting the next query re-derive them by Fourier–Motzkin.  The
# transfer layer rides on the signature-keyed caches, so it is only active
# when ``ENABLED`` is also true; ``POM_ANALYTIC_TRANSFER=0`` restores the
# exact (FM-only) engine.  Transfers that cannot be performed exactly fall
# back to FM automatically, which is what keeps analytic and exact runs
# bit-identical.
ANALYTIC: bool = os.environ.get("POM_ANALYTIC_TRANSFER", "1") != "0"

# Bound-and-confirm rung evaluation (branch-and-bound over a rung's
# candidate set): when on, the evaluators order candidates by an admissible
# closed-form latency lower bound and confirm with a full ``node_report``
# only those whose bound could still beat the best confirmed bottleneck
# latency.  The bound rides on the same ``ClosedFormII`` sweep the analytic
# layer builds per rung, so pruning is only active when ``analytic_on()``;
# ``POM_BOUND_PRUNE=0`` restores exhaustive per-candidate evaluation.
# Selected designs/actions/reports are bit-identical either way — pruning
# only skips candidates whose bound proves they cannot win the rung.
BOUND_PRUNE: bool = os.environ.get("POM_BOUND_PRUNE", "1") != "0"

COUNTS: Dict[str, int] = {
    "selfdep_evals": 0, "selfdep_hits": 0, "selfdep_transfers": 0,
    "legal_evals": 0, "legal_hits": 0, "legal_transfers": 0,
    "trip_evals": 0, "trip_hits": 0, "trip_transfers": 0,
    "access_evals": 0, "access_hits": 0,
}


def set_enabled(value: bool) -> None:
    global ENABLED
    ENABLED = bool(value)


def set_analytic(value: bool) -> None:
    global ANALYTIC
    ANALYTIC = bool(value)


def analytic_on() -> bool:
    """Analytic transfer is layered on the incremental caches."""
    return ENABLED and ANALYTIC


def set_bound_prune(value: bool) -> None:
    global BOUND_PRUNE
    BOUND_PRUNE = bool(value)


def bound_prune_on() -> bool:
    """Bound-and-confirm pruning is layered on the analytic sweep."""
    return analytic_on() and BOUND_PRUNE


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def analysis_evals(counts: Dict[str, int] = None) -> int:
    """The headline incremental-analysis work metric: polyhedral
    self-dependence + legality + trip-count evaluations (cache hits and
    analytic transfers excluded).  One definition shared by the perf-smoke
    budgets, ``bench_dse_speed --check``, and telemetry snapshots."""
    c = COUNTS if counts is None else counts
    return c["selfdep_evals"] + c["legal_evals"] + c["trip_evals"]


def clear_all() -> None:
    """Empty every process-global memo table (benchmark hygiene: measure a
    workload from a cold cache).  Per-statement / per-model caches die with
    their owning objects and need no clearing here."""
    import sys

    from .affine import _DEPVEC_CACHE, _INTERN
    from .ir import _TRIP_CANON_CACHE
    from .transforms import _LEGAL_CACHE
    from .cost_model import _REC_II_CACHE, _REC_II_XFER
    _DEPVEC_CACHE.clear()
    _INTERN.clear()
    _TRIP_CANON_CACHE.clear()
    _LEGAL_CACHE.clear()
    _REC_II_CACHE.clear()
    _REC_II_XFER.clear()
    from .graph_ir import (_EDGE_CACHE, _FUSION_CACHE, _SKELETON_CACHE,
                           _TASKGRAPH_CACHE)
    _TASKGRAPH_CACHE.clear()
    _EDGE_CACHE.clear()
    _SKELETON_CACHE.clear()
    _FUSION_CACHE.clear()
    from .search import _APPLY_CACHE
    _APPLY_CACHE.clear()
    from .dse import _REFRESH_CACHE
    _REFRESH_CACHE.clear()
    # don't *import* the CUDA backend (pulls in torch) just to clear it
    cuda = sys.modules.get("repro_torch.core.backend_cuda")
    if cuda is not None:
        cuda._CUDA_RUNNER_CACHE.clear()


# --------------------------------------------------------------------------
# counter / memo merge API (parallel candidate evaluation, PR 3)
# --------------------------------------------------------------------------
# The process-global name-canonical memo tables, by short name.  Worker
# processes (forked by ``search.PoolEvaluator``) compute new entries that
# the parent merges back deterministically; per-statement and per-model
# caches are handled by ``search`` on top of this API.
def global_memo_tables() -> Dict[str, dict]:
    from .affine import _DEPVEC_CACHE
    from .cost_model import _REC_II_CACHE
    from .ir import _TRIP_CANON_CACHE
    from .transforms import _LEGAL_CACHE
    return {"trip_canon": _TRIP_CANON_CACHE, "legal": _LEGAL_CACHE,
            "depvec": _DEPVEC_CACHE, "rec_ii": _REC_II_CACHE}


def snapshot_memo_keys() -> Dict[str, set]:
    """Key sets of every global memo table (delta baseline)."""
    return {name: set(table) for name, table in global_memo_tables().items()}


def memo_delta(before: Dict[str, set]) -> Dict[str, Dict]:
    """Entries added to the global memo tables since ``before``."""
    out: Dict[str, Dict] = {}
    for name, table in global_memo_tables().items():
        old = before.get(name, ())
        new = {k: v for k, v in table.items() if k not in old}
        if new:
            out[name] = new
    return out


def global_xfer_sets() -> Dict[str, set]:
    """Origin markers for analytic-transfer entries in the global memos.

    ``rec_ii`` entries computed by the closed-form (analytic) II path are
    tracked so the parallel-merge conversion decrements the right counter
    (``analytic_node_evals`` vs ``full_node_evals``) on a key collision.
    """
    from .cost_model import _REC_II_XFER
    return {"rec_ii": _REC_II_XFER}


def merge_memo_delta(delta: Dict[str, Dict],
                     xfer: Dict[str, set] = None) -> Dict[str, int]:
    """Merge a worker's new global-memo entries into this process.

    Returns, per table, the number of entries that were *already present*
    (computed by an earlier-merged candidate): the caller converts those
    from evaluations into cache hits so merged counters replay exactly
    what a serial run would have counted.  Signature keys are structural,
    so on a key collision both sides hold the identical value — insertion
    order across workers cannot change any result.

    ``xfer`` marks worker entries produced by the analytic-transfer path;
    their collisions are reported under ``<table>_xfer`` so the caller
    adjusts the analytic counter instead of the evaluation counter, and
    fresh ones keep their origin mark in this process.
    """
    tables = global_memo_tables()
    xfer = xfer or {}
    origin = global_xfer_sets()
    converted: Dict[str, int] = {}
    for name, entries in delta.items():
        table = tables[name]
        marks = xfer.get(name, ())
        dup = dup_x = 0
        for k, v in entries.items():
            if k in table:
                if k in marks:
                    dup_x += 1
                else:
                    dup += 1
            else:
                table[k] = v
                if k in marks and name in origin:
                    origin[name].add(k)
        converted[name] = dup
        converted[f"{name}_xfer"] = dup_x
    # a merged delta must respect the depvec bound too (a tiny
    # POM_DEPVEC_CACHE_MAX otherwise grows without limit through merges);
    # results stay bit-identical — eviction only forgets memo entries
    from . import affine
    while len(affine._DEPVEC_CACHE) > affine._depvec_cache_limit() > 1:
        affine._evict_half(affine._DEPVEC_CACHE)
    return converted


def counts_delta(before: Dict[str, int]) -> Dict[str, int]:
    return {k: COUNTS[k] - before.get(k, 0) for k in COUNTS}


def merge_counts(delta: Dict[str, int]) -> None:
    """Fold a worker's counter delta into this process's ``COUNTS``."""
    for k, v in delta.items():
        if k in COUNTS:
            COUNTS[k] += v


@contextmanager
def counting_paused():
    """Run a block without perturbing the evaluation counters.

    The pipeline's per-stage verifiers re-run legality / dependence /
    bound queries that the search has (in the cached engine) already
    computed; the counters exist to measure *candidate-evaluation* work,
    so verification must not shift them.  Counter state is snapshotted and
    restored; cache contents are untouched.  Each verifier runs *after*
    the stage that issues its queries (and search candidates always differ
    structurally from stage-boundary schedules), so verifier-warmed
    entries are never what turns a later genuine evaluation into a hit.
    """
    snap = dict(COUNTS)
    try:
        yield
    finally:
        COUNTS.clear()
        COUNTS.update(snap)


@contextmanager
def disabled():
    """Run a block with every incremental cache bypassed (baseline engine)."""
    global ENABLED
    prev = ENABLED
    ENABLED = False
    try:
        yield
    finally:
        ENABLED = prev


@contextmanager
def analytic_disabled():
    """Run a block on the exact (FM-only) engine: caches stay on, but every
    dependence/trip/legality/II fact is re-derived polyhedrally instead of
    transferred through the change-of-basis algebra."""
    global ANALYTIC
    prev = ANALYTIC
    ANALYTIC = False
    try:
        yield
    finally:
        ANALYTIC = prev


@contextmanager
def bound_prune_disabled():
    """Run a block with exhaustive rung evaluation: every candidate gets a
    full ``node_report``, no bound ordering, no early stop — the reference
    engine the bound-and-confirm bit-identity tests compare against."""
    global BOUND_PRUNE
    prev = BOUND_PRUNE
    BOUND_PRUNE = False
    try:
        yield
    finally:
        BOUND_PRUNE = prev


@contextmanager
def enabled():
    global ENABLED
    prev = ENABLED
    ENABLED = True
    try:
        yield
    finally:
        ENABLED = prev
