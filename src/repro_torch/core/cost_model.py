"""Analytical cost models for the DSE engine (paper SS VI-B uses the in-house
model of [35][38]; we provide our own calibrated equivalents).

Two targets:

* ``HlsModel`` — FPGA (Xilinx XC7Z020 @ 100 MHz, the paper's device):
  recurrence-constrained initiation interval (II), memory-port II, pipeline
  latency, and DSP/LUT/FF/BRAM resource usage.  Calibrated so the BICG
  unoptimized baseline reproduces the paper's Table IV cycle count
  (234,889,217 cycles at problem size 4096).

* ``HopperModel`` — one NVIDIA H100 SXM: two-term roofline (compute,
  HBM memory) and the shared memory a block can use.  Used to score the
  CUDA kernels' schedules (``repro_torch.kernels.autotune``).

Incremental evaluation (the DSE hot loop)
-----------------------------------------
``HlsModel`` memoizes at two granularities, both behind
``repro_torch.core.caching.ENABLED`` and the per-model ``cache`` flag:

* **per-node**: ``node_report(stmt, group)`` is a pure function of
  (statement schedule signature, the schedule signatures of its fusion
  group, the partition state of every array the group touches).  The cache
  key is exactly that tuple, so when stage 2 mutates one node only that
  node — plus statements sharing a mutated array's partitions — miss the
  cache; everything else returns its previous ``NodeReport`` unchanged.
  This *is* the dirty-set: dirtiness is detected structurally by key
  mismatch rather than tracked imperatively, which makes staleness
  impossible by construction.
* **whole-design**: ``design_report(fn)`` keys on all statement signatures
  plus all partition states; stage-2 backtracking revisits earlier design
  points constantly (every rejected ladder rung restores the previous
  schedule), turning those re-evaluations into dictionary hits.

Invariant (tested): with caching on or off, ``design_report`` returns
bit-identical latencies/resources and ``auto_dse`` produces identical
action logs.  ``HlsModel.stats`` counts evaluations vs hits; the
``bench_dse_speed`` suite and the perf smoke test are built on those
counters because they are stable across machines, unlike wall time.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .depgraph import DepGraph, NodeInfo
from .ir import BinOp, Call, Const, Expr, Function, IterVal, Load, Placeholder, Statement
from .ir import loads_of
from . import caching


# --------------------------------------------------------------------------
# FPGA resource/latency constants (XC7Z020, fp32, 100 MHz — Vitis-like)
# --------------------------------------------------------------------------
OP_LATENCY = {"+": 5, "-": 5, "*": 4, "/": 15,
              "exp": 20, "sqrt": 16, "max": 1, "min": 1, "abs": 1,
              "relu": 1, "tanh": 24}
# fp32 mul = 3 DSP48s, fp32 add = 2 DSP48s (Vitis 'full' DSP usage @100MHz)
OP_DSP = {"+": 2, "-": 2, "*": 3, "/": 0,
          "exp": 7, "sqrt": 0, "max": 0, "min": 0, "abs": 0, "relu": 0, "tanh": 9}
OP_LUT = {"+": 220, "-": 220, "*": 100, "/": 800,
          "exp": 1500, "sqrt": 600, "max": 60, "min": 60, "abs": 30,
          "relu": 40, "tanh": 2000}
LUT_PER_BANK = 60    # partition banking muxes (calibrated: paper's BICG
                     # design reaches ~1.1k banks within 82% of 53.2k LUTs)
LOAD_LATENCY = 2
STORE_LATENCY = 1
LOOP_OVERHEAD = 2            # increment/exit per sequential iteration

XC7Z020 = dict(dsp=220, lut=53_200, ff=106_400, bram_bits=4.9e6)


@dataclass
class ExprStats:
    latency: int = 0          # critical path (cycles)
    dsp: int = 0
    lut: int = 0
    n_flops: int = 0
    loads: List[Load] = field(default_factory=list)


def expr_stats(e: Expr) -> ExprStats:
    if isinstance(e, Const) or isinstance(e, IterVal):
        return ExprStats()
    if isinstance(e, Load):
        return ExprStats(LOAD_LATENCY, 0, 0, 0, [e])
    if isinstance(e, BinOp):
        a, b = expr_stats(e.lhs), expr_stats(e.rhs)
        return ExprStats(max(a.latency, b.latency) + OP_LATENCY[e.op],
                         a.dsp + b.dsp + OP_DSP[e.op],
                         a.lut + b.lut + OP_LUT[e.op],
                         a.n_flops + b.n_flops + 1,
                         a.loads + b.loads)
    if isinstance(e, Call):
        stats = [expr_stats(a) for a in e.args]
        return ExprStats(max([s.latency for s in stats] or [0]) + OP_LATENCY.get(e.fn, 4),
                         sum(s.dsp for s in stats) + OP_DSP.get(e.fn, 0),
                         sum(s.lut for s in stats) + OP_LUT.get(e.fn, 500),
                         sum(s.n_flops for s in stats) + 1,
                         sum([s.loads for s in stats], []))
    raise TypeError(e)


@dataclass
class NodeReport:
    name: str
    latency: int
    ii: int
    depth: int
    dsp: int
    lut: int
    parallelism: float
    trip_product: int
    flops: int


@dataclass
class DataflowReport:
    """Task-level-pipelining view of one design (``DesignReport.dataflow``).

    ``applied`` is True when the streaming schedule was adopted: the
    region's latency (``max`` over task finish times + fill/drain control
    overhead) beat the sequential sum *and* the channel storage fit the
    device.  When False the report keeps the sequential numbers and
    ``reason`` says why (ineligible graph, no latency gain, or channel
    BRAM overflow)."""
    applied: bool
    tasks: int
    sequential_latency: int
    region_latency: int
    channel_bits: float = 0.0
    channel_lut: int = 0
    # (array, producer, consumer, kind, depth) per channel
    channels: Tuple[Tuple[str, str, str, str, int], ...] = ()
    reason: str = ""
    # Steady-state initiation interval of the *region* under a stream of
    # invocations: drain of invocation k overlaps fill of k+1.  Channels
    # with storage (fifo/pipo) double-buffer across invocations, so every
    # task re-starts as soon as its own previous run finished (bounded by
    # the slowest task); a ``seq`` edge has no channel storage — the
    # consumer's read of invocation k must finish before the producer may
    # overwrite for k+1, serializing that producer/consumer pair.  Always
    # <= region_latency (the single-shot number includes the one-time
    # fill/drain the steady state amortizes).  0 = not computed.
    ii_region: int = 0

    @property
    def overlap(self) -> int:
        """Cycles saved by task overlap (0 when not applied)."""
        return (self.sequential_latency - self.region_latency
                if self.applied else 0)


@dataclass
class DesignReport:
    latency: int
    nodes: Dict[str, NodeReport]
    dsp: int
    lut: int
    ff: int
    bram_bits: float
    feasible: bool
    dataflow: Optional[DataflowReport] = None
    # Per-run telemetry snapshot attached by ``dse.auto_dse`` (analysis
    # evals, cost-model counters, wave/pool deltas — see
    # ``telemetry.metrics``).  Observational only: excluded from equality
    # so every bit-identity invariant (serial vs pooled, cached vs
    # uncached, traced vs untraced) compares reports unchanged, and not
    # serialized into the design database.
    telemetry: Optional[Dict] = field(default=None, compare=False,
                                      repr=False)

    @property
    def parallelism(self) -> float:
        # paper: product of tile sizes / achieved II, per critical node
        if not self.nodes:
            return 1.0
        return max(n.parallelism for n in self.nodes.values())

    # -- resource totals (the Pareto archive's objective axes) ----------------
    @property
    def bram18(self) -> int:
        """BRAM usage in BRAM18 tiles (the paper's device counts them)."""
        return int(math.ceil(self.bram_bits / 18_000.0))

    @property
    def resource_vector(self) -> Tuple[int, int]:
        """(DSP, BRAM18) — the resource axes the design frontier trades
        against latency in ``search.ParetoArchive``."""
        return (self.dsp, self.bram18)

    def resource_totals(self) -> Dict[str, float]:
        """All device-resource totals by name (the per-strategy columns of
        ``bench_dse_speed`` snapshot these per best design)."""
        return {"dsp": self.dsp, "lut": self.lut, "ff": self.ff,
                "bram_bits": self.bram_bits, "bram18": self.bram18}

    @property
    def ii_region(self) -> int:
        """Per-invocation steady-state initiation interval: cycles between
        successive invocation starts when the design serves a stream.  With
        an applied dataflow region, invocation k+1's fill overlaps k's
        drain (``DataflowReport.ii_region``); a sequential design admits no
        cross-invocation overlap, so its II is the single-shot latency."""
        if self.dataflow is not None and self.dataflow.applied \
                and self.dataflow.ii_region > 0:
            return self.dataflow.ii_region
        return self.latency


@dataclass
class CostStats:
    """Evaluation counters (cache-hit bookkeeping for benchmarks/tests).

    ``node_evals`` counts per-node report computations (including cheap
    re-aggregations where only a shared array's partitions changed);
    ``full_node_evals`` counts the expensive ones — recurrence-II polyhedral
    analyses actually computed rather than served from cache, plus
    unpipelined (fully sequential) node computations, which have no cached
    decomposition.  In the uncached engine every node computation is full.
    ``analytic_node_evals`` counts recurrence IIs derived by the closed
    form instead: the dependence vectors and trip counts feeding the II
    arithmetic were *transferred* through the candidate's change of basis
    (zero polyhedral work), so these are integer arithmetic, not analyses.
    """
    node_evals: int = 0          # per-node report computations
    node_cache_hits: int = 0
    full_node_evals: int = 0     # fresh recurrence analyses + sequential nodes
    design_evals: int = 0        # design_report calls
    design_cache_hits: int = 0   # ... served entirely from cache
    analytic_node_evals: int = 0  # closed-form (transfer-fed) recurrence IIs
    # bound-and-confirm rung evaluation (POM_BOUND_PRUNE): candidates whose
    # full design report was actually computed vs candidates whose latency
    # lower bound proved they could not win the rung.  With pruning off,
    # confirmed_evals counts every applied candidate and pruned stays 0.
    confirmed_evals: int = 0
    pruned_candidates: int = 0

    def as_dict(self) -> Dict[str, int]:
        """JSON-ready counter dict (the telemetry/metrics schema)."""
        return {"node_evals": self.node_evals,
                "node_cache_hits": self.node_cache_hits,
                "full_node_evals": self.full_node_evals,
                "design_evals": self.design_evals,
                "design_cache_hits": self.design_cache_hits,
                "analytic_node_evals": self.analytic_node_evals,
                "confirmed_evals": self.confirmed_evals,
                "pruned_candidates": self.pruned_candidates}

    def delta(self, since: "CostStats") -> Dict[str, int]:
        """Counter movement since a snapshot (``copy.copy(stats)``)."""
        now, then = self.as_dict(), since.as_dict()
        return {k: now[k] - then[k] for k in now}


# name-canonical (schedule, pipeline pos, unrolls, body latency) -> II;
# shared across models: two structurally identical candidate schedules have
# the same recurrence II regardless of which statement/layer produced them
_REC_II_CACHE: Dict[Tuple, int] = {}
# keys of _REC_II_CACHE entries produced by the closed-form (analytic)
# path; the parallel replay-merge needs the origin to adjust the right
# counter when a worker's entry collides with an earlier candidate's
_REC_II_XFER: set = set()


class HlsModel:
    """Latency + resource estimator over the scheduled Function.

    ``cache=False`` forces the pre-incremental behavior (every report fully
    recomputed); the default follows ``repro_torch.core.caching.ENABLED``.
    Reports returned from the cache are shared instances — treat them as
    read-only.
    """

    def __init__(self, resources: Dict = XC7Z020, cache: Optional[bool] = None,
                 dataflow: Optional[bool] = None):
        self.resources = dict(resources)
        self._cache_flag = cache
        self._dataflow_flag = dataflow
        self._node_cache: Dict[Tuple, NodeReport] = {}
        self._design_cache: Dict[Tuple, DesignReport] = {}
        self._expr_cache: Dict[int, ExprStats] = {}   # uid -> body stats
        # derived-structure memos (pure functions of schedule state the
        # rung-evaluation hot path re-derives per candidate otherwise):
        # group uids -> {array name: Placeholder} (which arrays a group
        # touches never changes — only their partition dicts do)
        self._arrays_cache: Dict[Tuple, Dict[str, Placeholder]] = {}
        # (uid, subst sig) -> ((array name, used-dims frozenset), ...) per
        # access ref — the memory-port II inputs that survive unrolling
        self._refdims_cache: Dict[Tuple, Tuple] = {}
        # (uid, domain key, subst sig) -> name-canonical II-key prefix
        self._reckey_cache: Dict[Tuple, Tuple] = {}
        self.stats = CostStats()

    def _caching(self) -> bool:
        return caching.ENABLED if self._cache_flag is None else self._cache_flag

    def _dataflow_on(self, fn: Function) -> bool:
        """Effective dataflow toggle for this design: per-function override
        first (the stage-2 search decision / DSL toggle), then the model's
        constructor flag, then the ``POM_DATAFLOW`` environment default."""
        if fn.dataflow is not None:
            return bool(fn.dataflow)
        if self._dataflow_flag is not None:
            return bool(self._dataflow_flag)
        from .graph_ir import dataflow_default
        return dataflow_default()

    def _group_arrays(self, stmts: Sequence[Statement]) -> Dict[str, Placeholder]:
        """{array name: Placeholder} touched by ``stmts``.  Which arrays a
        statement reads/writes is structural (schedules only reshape the
        index functions), so the map is memoized per uid tuple; the live
        partition dicts are read off the shared Placeholder objects."""
        key = tuple(s.uid for s in stmts)
        hit = self._arrays_cache.get(key)
        if hit is not None:
            return hit
        arrays: Dict[str, Placeholder] = {}
        for s in stmts:
            arr, _ = s.store_access()
            arrays.setdefault(arr.name, _find_ph([s], arr.name) or arr)
            for a, _ in s.load_accesses():
                arrays.setdefault(a.name, _find_ph([s], a.name) or a)
        if self._caching():
            self._arrays_cache[key] = arrays
        return arrays

    def _partition_sig(self, stmts: Sequence[Statement]) -> Tuple:
        """Signature of the partition state of every array the statements
        touch (the only placeholder state the cost model reads)."""
        return tuple(sorted((n, ph.part_sig())
                            for n, ph in self._group_arrays(stmts).items()))

    # -- per statement ---------------------------------------------------------
    def node_report(self, stmt: Statement, group: Sequence[Statement] = (),
                    _sigs: Optional[Dict[int, Tuple]] = None) -> NodeReport:
        group = list(group) or [stmt]
        if not self._caching():
            self.stats.node_evals += 1
            return self._node_report_compute(stmt, group)
        # ``stmt`` is always a member of ``group``, so the group signature
        # tuple already pins its schedule; ``_sigs`` (design_report's key,
        # threaded down) spares rebuilding signatures per node
        if _sigs is not None:
            gsigs = tuple(_sigs[s.uid] for s in group)
        else:
            gsigs = tuple(s.schedule_signature() for s in group)
        key = (stmt.uid, gsigs, self._partition_sig(group))
        hit = self._node_cache.get(key)
        if hit is not None:
            self.stats.node_cache_hits += 1
            return hit
        self.stats.node_evals += 1
        r = self._node_report_compute(stmt, group)
        self._node_cache[key] = r
        return r

    def _expr_stats(self, stmt: Statement) -> ExprStats:
        """expr_stats of the (immutable) body, cached per statement."""
        if not self._caching():
            return expr_stats(stmt.body)
        st = self._expr_cache.get(stmt.uid)
        if st is None:
            st = expr_stats(stmt.body)
            self._expr_cache[stmt.uid] = st
        return st

    def _node_report_compute(self, stmt: Statement,
                             group: Sequence[Statement]) -> NodeReport:
        st = self._expr_stats(stmt)
        trips = stmt.trip_counts()
        dims = stmt.dims
        n = len(dims)
        unrolls = {d: f for d, f in stmt.unrolls.items() if f > 1}
        unroll_prod = 1
        for f in unrolls.values():
            unroll_prod *= f

        pipe = stmt.pipeline_at
        if pipe is not None and pipe in dims:
            p = dims.index(pipe)
        else:
            p = None

        iter_latency = st.latency + STORE_LATENCY

        if p is None:
            # fully sequential: every iteration costs its critical path
            self.stats.full_node_evals += 1
            seq_trip = 1
            for d in dims:
                t = trips.get(d, 1)
                seq_trip *= t
            lat = seq_trip * (iter_latency + LOOP_OVERHEAD)
            dsp = st.dsp
            lut = st.lut + 300
            return NodeReport(stmt.name, lat, iter_latency + LOOP_OVERHEAD,
                              iter_latency, dsp, lut, 1.0, seq_trip, st.n_flops * seq_trip)

        # pipelined band: loops at depth >= p; unrolled dims replicate HW
        band = dims[p:]
        outer = dims[:p]
        outer_trip = 1
        for d in outer:
            outer_trip *= trips.get(d, 1)
        band_seq_trip = 1          # initiations per band execution
        for d in band:
            t = trips.get(d, 1)
            if d in unrolls:
                t = math.ceil(t / unrolls[d])
            band_seq_trip *= t

        ii = self._achieved_ii(stmt, group, p, unrolls, st)
        depth = iter_latency
        lat = outer_trip * (depth + ii * max(band_seq_trip - 1, 0)) + LOOP_OVERHEAD * outer_trip
        dsp = st.dsp * unroll_prod
        lut = st.lut * unroll_prod + 500
        total_trip = outer_trip * band_seq_trip * unroll_prod
        tile_prod = unroll_prod
        return NodeReport(stmt.name, lat, ii, depth, dsp, lut,
                          tile_prod / ii, total_trip, st.n_flops * total_trip)

    # -- II ---------------------------------------------------------------------
    def _achieved_ii(self, stmt: Statement, group: Sequence[Statement], p: int,
                     unrolls: Dict[str, int], st: ExprStats) -> int:
        ii_rec = self._recurrence_ii(stmt, p, unrolls, st)
        ii_mem = self._memory_ii(stmt, group)
        return max(ii_rec, ii_mem)

    def _rec_ii_key(self, stmt: Statement, p: int, unrolls: Dict[str, int],
                    st: ExprStats) -> Tuple:
        """Name-canonical key of the recurrence-II memo (shared by the
        lookup path and the closed-form rung sweep's cache priming).

        The canonical prefix (domain + composed accesses through one
        ``NameCanon``) depends only on (domain, substitution) — not on the
        unroll/pipeline state a rung's candidates vary — so it is memoized
        per schedule basis and only the cheap suffix is rebuilt per call."""
        pre_key = (stmt.uid, stmt.domain.key(), stmt.subst_signature())
        pre = self._reckey_cache.get(pre_key)
        if pre is None:
            from .affine import NameCanon
            c = NameCanon()
            w_arr, w_idx = stmt.store_access()
            pre = (c.set_key(stmt.domain),
                   tuple(c.expr(e) for e in w_idx),
                   tuple((arr.name == w_arr.name,
                          tuple(c.expr(e) for e in idx))
                         for arr, idx in stmt.load_accesses()))
            if self._caching():
                self._reckey_cache[pre_key] = pre
        return pre + (p, tuple(unrolls.get(d, 1) for d in stmt.dims),
                      stmt.pipeline_ii, st.latency)

    def prime_recurrence_ii(self, stmt: Statement, sweep: Optional["ClosedFormII"],
                            factors: Tuple[int, ...]) -> None:
        """Seed the canonical II memo for a just-applied ladder candidate
        from the rung's closed form: ``sweep.ii(factors)`` is the same
        transfer-fed integer arithmetic ``_recurrence_ii`` would run, so
        the later lookup during ``design_report`` is a dictionary hit.
        A no-op when the sweep (or this candidate's transfer) is
        unavailable — the lookup then derives the II as before."""
        if sweep is None or not self._caching() or not caching.analytic_on():
            return
        pipe = stmt.pipeline_at
        if pipe is None or pipe not in stmt.dims:
            return
        p = stmt.dims.index(pipe)
        unrolls = {d: f for d, f in stmt.unrolls.items() if f > 1}
        key = self._rec_ii_key(stmt, p, unrolls, self._expr_stats(stmt))
        if key in _REC_II_CACHE:
            return
        ii = sweep.ii(tuple(factors))
        if ii is None:
            return
        self.stats.analytic_node_evals += 1
        if len(_REC_II_CACHE) >= 100_000:
            _REC_II_CACHE.clear()
            _REC_II_XFER.clear()
        _REC_II_CACHE[key] = ii
        _REC_II_XFER.add(key)

    def _recurrence_ii(self, stmt: Statement, p: int,
                       unrolls: Dict[str, int], st: ExprStats) -> int:
        """Recurrence-constrained II — the polyhedral half of the II model.

        Memoized under a name-canonical key (domain + composed accesses +
        pipeline position + per-dim unroll factors + body latency): this is
        the *full* cost evaluation of a node; everything else in
        ``node_report`` is cheap arithmetic.  ``stats.full_node_evals``
        counts the misses."""
        if self._caching():
            key = self._rec_ii_key(stmt, p, unrolls, st)
            hit = _REC_II_CACHE.get(key)
            if hit is not None:
                return hit
            # materialize the II's inputs first: when both the dependence
            # list and the loop bounds of this schedule state were served
            # by the transfer algebra, the computation below is the
            # closed form — pure integer arithmetic, zero polyhedral calls
            from . import caching
            from .transforms import self_dependences
            self_dependences(stmt)
            stmt.dim_bounds()
            analytic = (caching.analytic_on()
                        and stmt.xfer_sig() in stmt._xfer_keys["selfdep"]
                        and stmt.domain.key() in stmt._xfer_keys["trip"])
            if analytic:
                self.stats.analytic_node_evals += 1
            else:
                self.stats.full_node_evals += 1
            ii = self._recurrence_ii_compute(stmt, p, unrolls, st)
            if len(_REC_II_CACHE) >= 100_000:
                _REC_II_CACHE.clear()
                _REC_II_XFER.clear()
            _REC_II_CACHE[key] = ii
            if analytic:
                _REC_II_XFER.add(key)
            return ii
        self.stats.full_node_evals += 1
        return self._recurrence_ii_compute(stmt, p, unrolls, st)

    def _recurrence_ii_compute(self, stmt: Statement, p: int,
                               unrolls: Dict[str, int], st: ExprStats) -> int:
        # recurrence II from loop-carried dependences inside the band, per
        # dependence *level* (a polyhedron carries at several levels).
        # For a self-accumulation (store also loaded at the same address) the
        # recurrence circuit is just the adder: other operands pipeline in.
        from .transforms import self_dependences
        link = _link_latency(stmt, st)
        return recurrence_ii_arith(
            stmt.dims, p, stmt.trip_counts(), unrolls,
            [dep.levels for dep in self_dependences(stmt)],
            link, stmt.pipeline_ii)

    def closed_form_ii(self, stmt: Statement) -> Optional["ClosedFormII"]:
        """Per-rung closed-form ``ii(unroll_vector)`` (paper §V algebra +
        §VI-B ladder): the base schedule's dependence vectors, loop bounds,
        and chain latency are fixed across a rung, so every candidate's
        recurrence II follows by pushing them through the candidate's
        change of basis — pure integer arithmetic, zero polyhedral calls.
        Returns None when the base dependences resist exact transfer (the
        per-candidate path then derives IIs by FM as before)."""
        from .transforms import self_dependences
        deps = self_dependences(stmt)
        if any(d.exists and d.classes is None for d in deps):
            return None
        bounds = stmt.dim_bounds()
        if any(d not in bounds for d in stmt.dims):
            return None
        st = self._expr_stats(stmt)
        return ClosedFormII(list(stmt.dims), dict(bounds), list(deps),
                            _link_latency(stmt, st),
                            st.latency + STORE_LATENCY)

    def latency_lower_bound(self, sweep: Optional["ClosedFormII"],
                            factors: Tuple[int, ...]) -> Optional[int]:
        """Admissible latency lower bound for one rung candidate.

        ``node_report``'s pipelined-node latency is
        ``outer_trip * (depth + ii * max(band_seq_trip - 1, 0))
        + LOOP_OVERHEAD * outer_trip`` — monotone in ``ii`` at fixed trip
        counts.  ``depth`` and the trip products are exact functions of the
        candidate's split shape (``sweep.shape``), and the achieved II is
        ``max(recurrence II, memory-port II, ...) >= sweep.ii(factors)``,
        so substituting the closed-form recurrence II never over-estimates:
        bound <= true node latency for every candidate.  Returns ``None``
        (no bound — always confirm) when the rung has no sweep or this
        candidate's transfer/shape is unavailable."""
        if sweep is None:
            return None
        key = tuple(factors)
        ii = sweep.ii(key)
        if ii is None:
            return None
        shape = sweep.shape(key)
        if shape is None:
            return None
        outer_trip, band_seq_trip = shape
        return (outer_trip * (sweep.depth + ii * max(band_seq_trip - 1, 0))
                + LOOP_OVERHEAD * outer_trip)

    def _ref_dims(self, s: Statement) -> Tuple:
        """Per access ref of ``s``: (array name, frozenset of loop dims its
        composed index reads).  A pure function of the substitution basis —
        unroll candidates never touch it — memoized so the memory-port II
        of a rung's candidates is dict arithmetic over these sets."""
        key = (s.uid, s.subst_signature())
        hit = self._refdims_cache.get(key)
        if hit is not None:
            return hit
        refs = []
        for ld in [s.store] + loads_of(s.body):
            used = set()
            for e in ld.idx:
                used |= set(s.subst_lin(e).vars())
            refs.append((ld.array.name, frozenset(used)))
        out = tuple(refs)
        if self._caching():
            self._refdims_cache[key] = out
        return out

    def _memory_ii(self, stmt: Statement, group: Sequence[Statement]) -> int:
        # memory-port II (dual-port BRAM banks per partitioned array),
        # shared across fused statements in the same pipelined body.
        # A ref only multiplies by the unroll factors of dims that appear in
        # its index (replicas hitting the same address broadcast).
        # Pure dict arithmetic over memoized ref dim-sets — recomputed
        # on every (cheap) node re-aggregation when partitions change.
        ii_mem = 1
        arrays: Dict[str, int] = {}
        for s in group:
            unrolls = s.unrolls
            for name, used in self._ref_dims(s):
                distinct = 1
                for d, f in unrolls.items():
                    if d in used:
                        distinct *= max(f, 1)
                arrays[name] = arrays.get(name, 0) + distinct
        for name, accesses in arrays.items():
            ph = _find_ph(group, name)
            banks = 1
            if ph is not None:
                for (f, _kind) in ph.partitions.values():
                    banks *= f
            ii_mem = max(ii_mem, math.ceil(accesses / (2 * banks)))
        return ii_mem

    # -- whole design -------------------------------------------------------------
    def design_report(self, fn: Function) -> DesignReport:
        self.stats.design_evals += 1
        use_cache = self._caching()
        df = self._dataflow_on(fn)
        key = None
        sig_of = None
        if use_cache:
            sig_of = {s.uid: s.schedule_signature() for s in fn.statements}
            key = (tuple(sig_of.values()),
                   tuple(sorted((ph.name, ph.part_sig())
                                for ph in fn.placeholders.values())),
                   df)
            hit = self._design_cache.get(key)
            if hit is not None:
                self.stats.design_cache_hits += 1
                return hit
        rep = self._design_report_compute(fn, df, sig_of)
        if use_cache:
            self._design_cache[key] = rep
        return rep

    def _design_report_compute(self, fn: Function, df: bool = False,
                               sig_of: Optional[Dict[int, Tuple]] = None
                               ) -> DesignReport:
        groups = _fusion_groups(fn)
        nodes: Dict[str, NodeReport] = {}
        dsp = lut = 0
        for grp in groups:
            for s in grp:
                r = self.node_report(s, grp, _sigs=sig_of)
                nodes[s.name] = r
                dsp += r.dsp
                lut += r.lut
        # BRAM: large arrays stream from DDR; the on-chip cost is the
        # *banking* from array partitioning (>=1 BRAM18 per bank) plus
        # whole small arrays that fit on-chip.  Banking also costs LUT muxes.
        bram = 0.0
        for ph in fn.placeholders.values():
            banks = 1
            for (f, _kind) in ph.partitions.values():
                banks *= f
            bits = _arr_bits(ph)
            if bits <= 36_000:           # small arrays live on-chip whole
                bram += max(bits, banks * 18_000)
            else:
                bram += banks * 18_000
            lut += (banks - 1) * LUT_PER_BANK
        # fused statements overlap in time: latency of a group = max member
        total = 0
        for grp in groups:
            total += max(nodes[s.name].latency for s in grp)
        ff = lut  # rough FF ~ LUT on these designs

        def feasible_at(l, b, f_):
            return (dsp <= self.resources["dsp"] and l <= self.resources["lut"]
                    and b <= self.resources["bram_bits"]
                    and f_ <= self.resources["ff"])

        dataflow = None
        if df and len(groups) > 1:
            dataflow = self._dataflow_schedule(fn, groups, nodes, total)
            if dataflow.applied:
                lut_df = lut + dataflow.channel_lut
                bram_df = bram + dataflow.channel_bits
                if feasible_at(lut_df, bram_df, lut_df) or not feasible_at(lut, bram, ff):
                    total = dataflow.region_latency
                    lut, bram, ff = lut_df, bram_df, lut_df
                else:
                    dataflow = DataflowReport(
                        False, dataflow.tasks, dataflow.sequential_latency,
                        dataflow.region_latency,
                        reason="channel storage exceeds device BRAM",
                        ii_region=dataflow.ii_region)
        feasible = feasible_at(lut, bram, ff)
        return DesignReport(total, nodes, dsp, lut, ff, bram, feasible,
                            dataflow)

    def _dataflow_schedule(self, fn: Function, groups, nodes,
                           sequential: int) -> DataflowReport:
        """Streaming schedule of the task graph: per-task start times via
        longest-path relaxation over the classified channels, region
        latency = max task finish + fork/join overhead.

        Each task's finish time obeys two lower bounds per in-edge
        (``graph_ir`` channel kinds), relaxed in task order over the DAG:

        * **fill-path** — a consumer cannot finish before its first input
          arrives plus its own full latency: ``fillpath(c) >= fillpath(p)
          + fill(p→c)``, where the edge fill is ``depth x II_p`` for a
          ``fifo``, the producer's first ``fill_chunks`` chunk times for a
          ``pipo``, and the producer's whole latency for a ``seq`` edge;
        * **drain** — a consumer cannot finish before the producer's last
          chunk plus the consumer's trailing window: ``finish(c) >=
          finish(p) + tail``, with ``tail`` the consumer-paced mirror of
          the fill (its whole latency on a ``seq`` edge).

        ``finish(t) = max(fillpath(t) + lat(t), max over edges)``; region
        latency = max finish + fork/join overhead.  A fully sequential
        chain collapses to exactly the sequential sum, and the schedule is
        only *applied* when it strictly beats that sum — the model never
        reports dataflow making a design slower."""
        from .graph_ir import (CHANNEL_LUT, DATAFLOW_OVERHEAD,
                               analyze_task_graph)
        info = analyze_task_graph(fn)
        n = len(info.tasks)
        if not info.eligible:
            return DataflowReport(False, n, sequential, sequential,
                                  reason=info.reason)
        lat = [max(nodes[s.name].latency for s in grp) for grp in info.tasks]
        # the relaxation below is a pure function of the task latencies, the
        # producer/consumer IIs, and the (memoized) channel structure — memo
        # it on the TaskGraphInfo object itself, so its lifetime can never
        # outlive the graph analysis it belongs to
        memo = None
        if self._caching():
            mkey = (tuple(lat),
                    tuple((nodes[ch.producer].ii, nodes[ch.consumer].ii)
                          for ch in info.channels),
                    sequential)
            memo = getattr(info, "_sched_memo", None)
            if memo is None:
                memo = {}
                info._sched_memo = memo
            hit = memo.get(mkey)
            if hit is not None:
                return hit
        fillpath = [0] * n
        finish = [0] * n
        by_dst: Dict[int, List] = {}
        for ch in info.channels:      # src_task < dst_task always
            by_dst.setdefault(ch.dst_task, []).append(ch)
        for t in range(n):
            drain = 0
            for ch in by_dst.get(t, ()):
                p_lat, c_lat = lat[ch.src_task], lat[ch.dst_task]
                if ch.kind == "fifo":
                    fill = ch.depth * nodes[ch.producer].ii
                    tail = ch.depth * nodes[ch.consumer].ii
                elif ch.kind == "pipo":
                    frac = ch.fill_chunks / max(ch.chunks, 1)
                    fill = int(math.ceil(p_lat * frac))
                    tail = int(math.ceil(c_lat * frac))
                else:                 # seq: full producer drain
                    fill, tail = p_lat, c_lat
                fillpath[t] = max(fillpath[t], fillpath[ch.src_task] + fill)
                drain = max(drain, finish[ch.src_task] + tail)
            finish[t] = max(fillpath[t] + lat[t], drain)
        region = max(finish) + DATAFLOW_OVERHEAD
        # steady-state II under a stream of invocations: fifo/pipo channel
        # storage double-buffers across invocations, so each task re-starts
        # at its own pace (bounded by the slowest task); a seq edge has no
        # storage — its consumer must drain invocation k before the
        # producer overwrites for k+1, serializing that pair.  Provably
        # <= region (see the relaxation: finish[dst] >= finish[src] +
        # tail >= lat[src] + lat[dst] on every seq edge).
        ii = max(lat) if lat else 0
        for ch in info.channels:
            if ch.kind == "seq":
                ii = max(ii, lat[ch.src_task] + lat[ch.dst_task])
        channels = tuple((ch.array, ch.producer, ch.consumer, ch.kind,
                          ch.depth) for ch in info.channels)
        if region >= sequential:
            rep = DataflowReport(False, n, sequential, region,
                                 channels=channels,
                                 reason="no latency gain over sequential",
                                 ii_region=ii)
        else:
            bits = sum(ch.bits for ch in info.channels)
            chan_lut = CHANNEL_LUT * len(info.channels)
            rep = DataflowReport(True, n, sequential, region, bits, chan_lut,
                                 channels, ii_region=ii)
        if memo is not None:
            if len(memo) >= 4096:
                memo.clear()
            memo[mkey] = rep
        return rep


# --------------------------------------------------------------------------
# closed-form recurrence-II (analytic dependence transfer, PR 4)
# --------------------------------------------------------------------------
def _link_latency(stmt: Statement, st: ExprStats) -> int:
    """Latency of the recurrence circuit: for a self-accumulation (store
    also loaded at the same address) just the adder; else the full body."""
    w_arr, w_idx = stmt.store_access()
    is_accum = any(
        arr.name == w_arr.name and all(
            (a - b).key() == ((), 0) for a, b in zip(idx, w_idx))
        for arr, idx in stmt.load_accesses())
    return OP_LATENCY["+"] if is_accum else st.latency + STORE_LATENCY


def recurrence_ii_arith(dims: Sequence[str], p: int, trips: Dict[str, int],
                        unrolls: Dict[str, int],
                        levels_list: Sequence[Dict[int, Tuple]],
                        link: int, base_ii: int) -> int:
    """The recurrence-II integer arithmetic, shared by the FM path and the
    closed-form sweep: distance in initiation slots per dependence level,
    chained-replica accounting for unrolled dims, max over all levels."""
    band = dims[p:]
    ii_rec = base_ii
    for levels in levels_list:
        for lvl, dvec in levels.items():
            if lvl - 1 < p:
                continue  # carried by an outer sequential loop
            # distance in *initiation slots* between dependent iterations
            flat = 0
            mult = 1
            chained = 1   # sequentially chained replicas in one slot
            for k in range(len(band) - 1, -1, -1):
                d = band[k]
                dist = dvec[p + k]
                t = trips.get(d, 1)
                if d in unrolls:
                    # unrolled iterations share one slot; nonzero distance
                    # along an unrolled dim chains replicas combinationally
                    if dist is None:
                        dist = 1
                    if dist != 0:
                        chained *= max(unrolls[d] // max(abs(dist), 1), 1)
                    dist = dist // unrolls[d]
                    t = math.ceil(t / unrolls[d])
                if dist is None:
                    dist = 1
                flat += dist * mult
                mult *= t
            chain = link * chained
            if flat <= 0:
                if chained > 1:
                    # intra-slot chained replicas: the next slot's chain
                    # cannot start until this one drains
                    ii_rec = max(ii_rec, chain)
                continue
            ii_rec = max(ii_rec, math.ceil(chain / flat))
    return ii_rec


def _ii_threads() -> int:
    """``POM_II_THREADS``: thread count for sharding a rung's closed-form
    II sweep (:meth:`ClosedFormII.prefetch`).  The sweep is pure integer
    arithmetic on immutable facts — no pickling, no fork — so sharding it
    across threads is safe by construction; on GIL-serialized builds the
    speedup is modest, which is why the default is 1 (compute on demand,
    single thread)."""
    try:
        return max(1, int(os.environ.get("POM_II_THREADS", "1") or 1))
    except ValueError:
        return 1


_II_MISS = object()


@dataclass
class ClosedFormII:
    """Closed-form ``ii(unroll_vector)`` for one ladder rung.

    Precomputed once per rung from the bottleneck node's base schedule;
    ``ii(factors)`` replays ``search.apply_parallel``'s basis change
    (split the innermost ``len(factors)`` dims, move the intra-tile dims
    innermost, unroll them, pipeline just above) on the *facts* instead of
    the statement: dependence classes and loop bounds are pushed through
    the split/permute algebra and fed to the same II arithmetic the cost
    model runs.  Returns None for candidates the ladder would reject
    (factor exceeds a trip count) and falls back to None when a class
    resists exact transfer.

    ``ii`` is memoized per rung (``_memo``); ``prefetch`` fills the memo
    for a whole candidate set at once, sharded across ``POM_II_THREADS``
    threads when that is > 1.  ``_compute_ii`` touches only the frozen
    rung facts and thread-local state (``DependenceInfo.transform`` is
    pure), so concurrent computes are data-race-free; the memo itself is
    only written from the calling thread.
    """
    dims: List[str]
    bounds: Dict[str, Tuple[int, int]]
    deps: List
    link: int
    depth: int = 0               # pipeline depth (iter latency) of the body
    _memo: Dict[Tuple[int, ...], Optional[int]] = field(
        default_factory=dict, repr=False, compare=False)
    _shape_memo: Dict[Tuple[int, ...], Optional[Tuple[int, int]]] = field(
        default_factory=dict, repr=False, compare=False)

    def ii(self, factors: Tuple[int, ...]) -> Optional[int]:
        key = tuple(factors)
        hit = self._memo.get(key, _II_MISS)
        if hit is not _II_MISS:
            return hit
        val = self._compute_ii(key)
        self._memo[key] = val
        return val

    def shape(self, factors: Tuple[int, ...]
              ) -> Optional[Tuple[int, int]]:
        """(outer_trip, band_seq_trip) of the candidate's pipelined node —
        the exact trip products ``_node_report_compute`` aggregates, derived
        by replaying the candidate's splits on the rung-base loop bounds
        (no dependence transfer involved).  ``None`` for candidates the
        ladder would reject; memoized per rung like ``ii``."""
        key = tuple(factors)
        hit = self._shape_memo.get(key, _II_MISS)
        if hit is not _II_MISS:
            return hit
        val = self._compute_shape(key)
        self._shape_memo[key] = val
        return val

    def _compute_shape(self, factors: Tuple[int, ...]
                       ) -> Optional[Tuple[int, int]]:
        from .ir import _apply_trip_op
        dims = list(self.dims)
        k = len(factors)
        if k > len(dims):
            return None
        trips0 = {d: up - lo + 1 for d, (lo, up) in self.bounds.items()}
        targets = dims[-k:]
        for d, f in zip(targets, factors):
            if f > trips0.get(d, 1):
                return None
        bounds = dict(self.bounds)
        new_inner: List[str] = []
        for d, f in zip(targets, factors):
            if f <= 1:
                continue
            d0, d1 = d + "_o", d + "_u"
            pos = dims.index(d)
            bounds = _apply_trip_op(bounds, ("split", d, f, d0, d1))
            dims[pos:pos + 1] = [d0, d1]
            new_inner.append(d1)
        outer = [x for x in dims if x not in new_inner]
        if not outer:
            return None
        trips = {d: max(0, up - lo + 1) for d, (lo, up) in bounds.items()}
        # the pipeline sits at outer[-1]: the band is [outer[-1]] + the
        # unrolled intra-tile dims, whose unroll factor equals their trip
        # (each contributes ceil(t/f) == 1 initiation)
        outer_trip = 1
        for d in outer[:-1]:
            outer_trip *= trips.get(d, 1)
        return outer_trip, trips.get(outer[-1], 1)

    def prefetch(self, factor_lists, threads: Optional[int] = None) -> None:
        """Fill the memo for ``factor_lists`` (a rung's candidate set).

        With ``threads`` (default ``POM_II_THREADS``) > 1 and at least
        two uncomputed vectors, the computes run on a thread pool —
        values and every counter are identical either way (the sweep
        charges nothing; ``prime_recurrence_ii`` does the accounting when
        a candidate consumes a value).  With one thread this is a no-op:
        values are computed on demand by ``ii``, preserving the serial
        engine's work order exactly."""
        n = _ii_threads() if threads is None else max(1, int(threads))
        todo = [f for f in dict.fromkeys(tuple(f) for f in factor_lists)
                if f not in self._memo]
        if n <= 1 or len(todo) < 2:
            return
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(n, len(todo))) as ex:
            vals = list(ex.map(self._compute_ii, todo))
        for f, v in zip(todo, vals):
            self._memo[f] = v

    def _compute_ii(self, factors: Tuple[int, ...]) -> Optional[int]:
        from .affine import BasisMap
        from .ir import _apply_trip_op
        dims = list(self.dims)
        k = len(factors)
        if k > len(dims):
            return None
        trips0 = {d: up - lo + 1 for d, (lo, up) in self.bounds.items()}
        targets = dims[-k:]
        for d, f in zip(targets, factors):
            if f > trips0.get(d, 1):
                return None
        steps: List[Tuple] = []
        bounds = dict(self.bounds)
        new_inner: List[str] = []
        unrolls: Dict[str, int] = {}
        for d, f in zip(targets, factors):
            if f <= 1:
                continue
            d0, d1 = d + "_o", d + "_u"
            pos = dims.index(d)
            steps.append(("split", pos, f))
            bounds = _apply_trip_op(bounds, ("split", d, f, d0, d1))
            dims[pos:pos + 1] = [d0, d1]
            new_inner.append(d1)
            unrolls[d1] = f              # == the intra dim's trip count
        order = [x for x in dims if x not in new_inner] + new_inner
        if order != dims:
            steps.append(("permute", tuple(dims.index(x) for x in order)))
            dims = order
        outer = [x for x in dims if x not in new_inner]
        if not outer:
            return None
        p = len(outer) - 1
        basis = BasisMap(len(self.dims), steps)
        levels_list = []
        for dep in self.deps:
            if not dep.exists:
                continue
            info = dep.transform(basis)
            if info is None:
                return None
            levels_list.append(info.levels)
        trips = {d: max(0, up - lo + 1) for d, (lo, up) in bounds.items()}
        # base II is 1, not the rung-base statement's pipeline_ii:
        # apply_parallel unconditionally resets every candidate to
        # pipeline_ii=1 when it pipelines above the unrolled band
        return recurrence_ii_arith(dims, p, trips, unrolls, levels_list,
                                   self.link, 1)


def _arr_bits(ph: Placeholder) -> float:
    n = 1
    for s in ph.shape:
        n *= s
    return n * ph.dtype.bits


def _find_ph(group: Sequence[Statement], name: str) -> Optional[Placeholder]:
    for s in group:
        if s.function is not None and name in s.function.placeholders:
            return s.function.placeholders[name]
    return None


def _fusion_groups(fn: Function) -> List[List[Statement]]:
    # one definition of record: the streaming task graph and the cost
    # aggregation must index the exact same grouping, or the dataflow
    # schedule would mis-attribute task latencies
    from .graph_ir import fusion_tasks
    return fusion_tasks(fn)


# --------------------------------------------------------------------------
# NVIDIA H100 SXM roofline (per card)
# --------------------------------------------------------------------------
# NVIDIA's data-sheet numbers for the H100 SXM at its 700 W limit: 989e12
# dense bf16 tensor-core FLOP/s, 495e12 dense TF32, 67e12 f32 FLOP/s outside
# the tensor cores, 80 GB of HBM3 at 3.35e12 B/s, 232,448 B of shared memory a
# block can use, 132 SMs.  A card set below 700 W runs slower than these
# peaks.
@dataclass(frozen=True)
class HopperSpec:
    peak_flops_bf16: float = 989e12    # dense tensor cores, bf16/fp16
    peak_flops_tf32: float = 495e12    # dense tensor cores, TF32
    peak_flops_f32: float = 67e12      # CUDA cores, no tensor cores
    hbm_bw: float = 3.35e12            # bytes/s
    hbm_bytes: int = 80 * 10 ** 9      # device memory
    smem_bytes: int = 232_448          # dynamic shared memory a block can use
    num_sms: int = 132


H100 = HopperSpec()


@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float

    @property
    def dominant(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s)


class HopperModel:
    """Roofline estimates for kernels on one H100."""

    def __init__(self, spec: HopperSpec = H100):
        self.spec = spec

    def kernel_terms(self, flops: float, hbm_bytes: float,
                     tensor_cores: bool = True) -> RooflineTerms:
        peak = self.spec.peak_flops_bf16 if tensor_cores else self.spec.peak_flops_f32
        return RooflineTerms(flops / peak, hbm_bytes / self.spec.hbm_bw)
