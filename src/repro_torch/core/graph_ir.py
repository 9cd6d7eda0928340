"""Graph IR — the top layer of POM's three-level IR (paper §V, Fig. 7).

A dataflow graph of compute ops built from the DSL: nodes are ``compute``
statements, edges are producer→consumer relations through the arrays they
store/load.  Optimizations that the paper performs "at a suitable
abstraction level" on this layer:

  * **dead-op elimination** — ops whose results can never reach a live
    output are dropped before any polyhedral work is spent on them;
  * **op fusion** — producer/consumer pairs whose dependences permit it are
    annotated with an ``after`` fusion spec (checked by
    ``transforms.fuse_legal``), so the polyhedral layer builds one shared
    loop nest;
  * **common-subexpression sharing** — structurally identical ops (equal
    modulo iterator/array renaming, detected with ``affine.NameCanon``)
    are grouped into sharing classes that feed the name-canonical memo
    tables of the incremental engine: one polyhedral analysis per class,
    cache hits for every other member.

The layer below is the polyhedral IR (``ir.Function`` + ``transforms``);
``GraphIR.to_function()`` lowers into it.  ``pipeline.PassManager`` wires
the layers together and verifies each boundary.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .ir import (BinOp, Call, Const, Expr, Function, IterVal, Load, Statement,
                 walk_expr)
from . import caching


class GraphError(Exception):
    """Raised when a GraphIR is malformed (caught by the graph verifier)."""


@dataclass
class GraphOp:
    """One compute op: a statement plus its dataflow context."""
    stmt: Statement
    reads: Tuple[str, ...]            # array names loaded
    writes: str                       # array name stored
    producers: List[int] = field(default_factory=list)   # uids of upstream ops
    consumers: List[int] = field(default_factory=list)   # uids of downstream ops

    @property
    def uid(self) -> int:
        return self.stmt.uid

    @property
    def name(self) -> str:
        return self.stmt.name


class GraphIR:
    """Dataflow graph over a function's computes.

    ``outputs`` is the set of array names that are externally observable;
    by default every written array is an output (conservative — nothing is
    dead).  Narrow it (``outputs={"C"}``) to let dead-op elimination drop
    producers of purely internal temporaries.
    """

    def __init__(self, name: str, ops: List[GraphOp], outputs: Set[str],
                 source: Optional[Function] = None):
        self.name = name
        self.ops = ops
        self.outputs = set(outputs)
        self.source = source
        self.cse_classes: Dict[Tuple, List[str]] = {}
        # fusion specs created by graph passes: (consumer, producer, level);
        # the poly verifier dependence-checks exactly these
        self.fused: List[Tuple[str, str, int]] = []
        self._dirty = False          # True once an op was dropped/rewired

    # -- construction -----------------------------------------------------------
    @classmethod
    def from_function(cls, fn: Function, outputs: Optional[Sequence[str]] = None) -> "GraphIR":
        ops: List[GraphOp] = []
        last_writer: Dict[str, List[GraphOp]] = {}
        for s in fn.statements:
            w_arr, _ = s.store_access()
            reads = tuple(arr.name for arr, _ in s.load_accesses())
            op = GraphOp(s, reads, w_arr.name)
            for rd in reads:
                for producer in last_writer.get(rd, []):
                    if producer.uid != op.uid and op.uid not in producer.consumers:
                        producer.consumers.append(op.uid)
                        op.producers.append(producer.uid)
            last_writer.setdefault(w_arr.name, []).append(op)
            ops.append(op)
        outs = set(outputs) if outputs is not None else {op.writes for op in ops}
        return cls(fn.name, ops, outs, source=fn)

    # -- introspection ----------------------------------------------------------
    def op(self, name: str) -> GraphOp:
        for o in self.ops:
            if o.name == name:
                return o
        raise KeyError(name)

    def by_uid(self) -> Dict[int, GraphOp]:
        return {o.uid: o for o in self.ops}

    def edges(self) -> List[Tuple[str, str, str]]:
        """(producer op, consumer op, array) triples."""
        by = self.by_uid()
        out = []
        for o in self.ops:
            for c in o.consumers:
                if c in by:
                    out.append((o.name, by[c].name, o.writes))
        return out

    def describe(self) -> str:
        lines = [f"graph {self.name} (outputs: {sorted(self.outputs)})"]
        by = self.by_uid()
        for o in self.ops:
            dst = [by[c].name for c in o.consumers if c in by]
            after = ""
            if o.stmt.after_spec is not None:
                after = f"  after={o.stmt.after_spec[0].name}@{o.stmt.after_spec[1]}"
            lines.append(f"  {o.name}: [{', '.join(o.reads)}] -> {o.writes}"
                         f"  dims={o.stmt.dims}{after}"
                         + (f"  -> {dst}" if dst else ""))
        for key, members in self.cse_classes.items():
            if len(members) > 1:
                lines.append(f"  cse-class {members}")
        return "\n".join(lines)

    # -- well-formedness --------------------------------------------------------
    def verify(self) -> None:
        """Domain/substitution well-formedness of every op + edge sanity.

        Raises ``GraphError`` on the first violation.  This is the
        graph-stage verifier of the pass pipeline.
        """
        uids = {o.uid for o in self.ops}
        written = {o.writes for o in self.ops}
        for name in sorted(self.outputs):
            if name not in written:
                raise GraphError(
                    f"output {name!r} is not written by any op "
                    f"(written arrays: {sorted(written)}) — a typo here "
                    f"would silently dead-code-eliminate the program")
        for o in self.ops:
            s = o.stmt
            dims = s.dims
            if len(set(dims)) != len(dims):
                raise GraphError(f"{s.name}: duplicate loop dims {dims}")
            if set(s.iter_subst) != set(s.original_iters):
                raise GraphError(
                    f"{s.name}: iter_subst keys {sorted(s.iter_subst)} != "
                    f"original iterators {sorted(s.original_iters)}")
            legal_names = set(dims) | set(s.domain.params)
            for k, e in s.iter_subst.items():
                stray = set(e.vars()) - legal_names
                if stray:
                    raise GraphError(
                        f"{s.name}: substitution for {k} references "
                        f"non-dims {sorted(stray)}")
            orig_names = set(s.original_iters) | set(s.domain.params)
            refs = [s.store] + [ld for ld in walk_expr(s.body)
                                if isinstance(ld, Load)]
            for ld in refs:
                for e in ld.idx:
                    stray = set(e.vars()) - orig_names
                    if stray:
                        raise GraphError(
                            f"{s.name}: access {ld.array.name} indexes with "
                            f"unknown iterators {sorted(stray)}")
            for i, d in enumerate(dims):
                los, ups = s.domain.bounds_of(d, dims[i + 1:])
                if not los or not ups:
                    raise GraphError(f"{s.name}: loop {d} is unbounded "
                                     f"({'no lower' if not los else 'no upper'} bound)")
            for uid in o.producers + o.consumers:
                if uid not in uids:
                    raise GraphError(f"{o.name}: dangling edge to dropped op "
                                     f"uid={uid}")
            if s.after_spec is not None and s.after_spec[0].uid not in uids:
                raise GraphError(f"{s.name}: `after` target "
                                 f"{s.after_spec[0].name} is not in the graph")

    # -- lowering ---------------------------------------------------------------
    def to_function(self, rebuild: Optional[bool] = None) -> Function:
        """Lower to the polyhedral IR (an ``ir.Function``).

        When no graph pass changed the op set, the original function is
        returned unchanged (the statements are shared objects, so fusion
        annotations made at graph level are already visible).  After a
        destructive pass (or with ``rebuild=True``) a fresh Function is
        assembled from the surviving ops in graph order.
        """
        if rebuild is None:
            rebuild = self._dirty
        if not rebuild and self.source is not None:
            return self.source
        fn = Function(self.name)
        for o in self.ops:
            fn.add(o.stmt)
        return fn


# --------------------------------------------------------------------------
# graph-level passes
# --------------------------------------------------------------------------
def eliminate_dead_ops(g: GraphIR) -> List[str]:
    """Drop ops that cannot reach any output array (paper: graph-level DCE).

    An op is live iff it writes an output array, some live op reads the
    array it writes, or a live op's ``after`` spec anchors to it (fusion
    specs are program semantics, so their targets are kept — removing one
    would have to mutate statements shared with the source function).
    Returns the names of removed ops.
    """
    live: Set[int] = set()
    by = g.by_uid()

    def mark(uid: int, work: List[int]) -> None:
        if uid not in live and uid in by:
            live.add(uid)
            work.append(uid)

    work: List[int] = []
    for o in g.ops:
        if o.writes in g.outputs:
            mark(o.uid, work)
    while work:
        o = by[work.pop()]
        for p in o.producers:
            mark(p, work)
        if o.stmt.after_spec is not None:
            mark(o.stmt.after_spec[0].uid, work)
    removed = [o.name for o in g.ops if o.uid not in live]
    if not removed:
        return []
    dead = {o.uid for o in g.ops if o.uid not in live}
    g.ops = [o for o in g.ops if o.uid in live]
    for o in g.ops:
        o.producers = [u for u in o.producers if u not in dead]
        o.consumers = [u for u in o.consumers if u not in dead]
    g._dirty = True
    return removed


def fuse_ops(g: GraphIR) -> List[str]:
    """Fuse adjacent producer→consumer ops whose dependences permit it.

    For each consecutive op pair (p, c) where c reads what p writes, both
    have the same loop depth and equal trip counts, and c carries no fusion
    spec yet, annotate ``c.after(p, deepest-legal-level)``.  Legality is
    the conservative cross-statement check ``transforms.fuse_legal`` —
    every dependence must stay non-negative on the shared loops.  Returns
    action strings for the log.
    """
    from . import transforms as T
    actions: List[str] = []
    for p, c in zip(g.ops, g.ops[1:]):
        if c.stmt.after_spec is not None:
            continue
        if c.uid not in p.consumers:
            continue
        sp, sc = p.stmt, c.stmt
        if len(sp.dims) != len(sc.dims):
            continue
        tp, tc = sp.trip_counts(), sc.trip_counts()
        if list(tp.values()) != list(tc.values()):
            continue
        for levels in range(len(sp.dims), 0, -1):
            if T.fuse_legal(sc, sp, levels):
                T.set_after(sc, sp, levels - 1)
                g.fused.append((sc.name, sp.name, levels - 1))
                actions.append(f"fuse {sc.name} after {sp.name} "
                               f"at level {levels - 1}")
                break
    return actions


def _body_key(e: Expr, canon) -> Tuple:
    """Structural key of a compute body under name canonicalization."""
    if isinstance(e, Const):
        return ("c", e.value)
    if isinstance(e, IterVal):
        return ("it", canon.expr(e.expr))
    if isinstance(e, Load):
        return ("ld", canon.id("@" + e.array.name),
                tuple(canon.expr(i) for i in e.idx))
    if isinstance(e, BinOp):
        return ("b", e.op, _body_key(e.lhs, canon), _body_key(e.rhs, canon))
    if isinstance(e, Call):
        return ("f", e.fn, tuple(_body_key(a, canon) for a in e.args))
    raise TypeError(e)


def op_structural_key(stmt: Statement) -> Tuple:
    """Name-canonical signature of an op: domain + substitution + accesses +
    body structure.  Two ops with equal keys are the same computation modulo
    iterator/array renaming, so every positional polyhedral query (trip
    counts, dependence distances, legality, recurrence II) has the same
    answer for both."""
    from .affine import NameCanon
    c = NameCanon()
    dkey = c.set_key(stmt.domain)
    subst = tuple(c.expr(stmt.iter_subst[k]) for k in stmt.original_iters)
    store = (c.id("@" + stmt.store.array.name),
             tuple(c.expr(e) for e in stmt.store.idx))
    return (dkey, subst, store, _body_key(stmt.body, c))


# --------------------------------------------------------------------------
# streaming task graph (task-level pipelining / HLS dataflow)
# --------------------------------------------------------------------------
# A *task* is one fusion group (one top-level loop nest after `after`
# grouping); a producer→consumer edge between tasks is realized by a
# *channel* whose kind is decided by a streaming-legality analysis over the
# composed access functions:
#
#   * ``fifo``  — the consumer reads the producer's array in exactly the
#     monotone affine order the producer writes it: both accesses are the
#     identity over their (current) loop dims, positional loop bounds agree,
#     each element is written once (no write→write self-dependence, i.e. no
#     reduction dim outside the store footprint), and the task is the
#     array's only consumer.  Channel = a small ``hls::stream`` FIFO.
#   * ``pipo``  — both sides walk the array in the same *major-block* order:
#     some index position p is driven by each task's outermost loop dim
#     (unit coefficient), so array slices along dim p are finalized and
#     consumed in the same strictly increasing order, and the consumer may
#     start once the producer has finished the first ``fill_chunks``
#     chunks.  Channel = a ping-pong buffer of ``fill_chunks + 1`` chunks.
#     Constant offsets (stencil rows) only widen the fill window.
#   * ``seq``   — no streaming order exists (e.g. the consumer's leading
#     read dim is an inner loop): the consumer waits for the producer to
#     finish.  No on-chip channel storage; the edge only orders the tasks.
#
# Loop bounds come from ``Statement.dim_bounds`` — the fact the analytic
# transfer layer (PR 4) pushes through every recorded basis step — so
# re-classifying a channel after a DSE transform costs dictionary lookups,
# not Fourier–Motzkin projections.

FIFO_DEPTH = 4                 # element slots per FIFO channel
CHANNEL_LUT = 60               # handshake/control LUTs per channel
DATAFLOW_OVERHEAD = 8          # region fork/join control cycles


def dataflow_default() -> bool:
    """Ambient dataflow toggle: ``POM_DATAFLOW=0`` disables task-level
    pipelining everywhere (bit-identical to the pre-dataflow engine)."""
    return os.environ.get("POM_DATAFLOW", "1") != "0"


def dataflow_effective(fn: Function) -> bool:
    """Per-function dataflow setting: an explicit ``fn.dataflow`` (DSL
    toggle / ``compile(dataflow=...)`` / the stage-2 search decision) wins
    over the ``POM_DATAFLOW`` environment default."""
    flag = getattr(fn, "dataflow", None)
    return dataflow_default() if flag is None else bool(flag)


@dataclass(frozen=True)
class ChannelSpec:
    """One producer→consumer array edge between two tasks."""
    array: str
    producer: str              # writer statement name
    consumer: str              # reader statement name
    src_task: int
    dst_task: int
    kind: str                  # "fifo" | "pipo" | "seq"
    depth: int                 # fifo: element slots; pipo: chunk buffers
    chunks: int                # pipo: producer outer-dim chunk count
    fill_chunks: int           # pipo: chunks produced before consumer starts
    bits: float                # on-chip channel storage (0 for seq)


@dataclass
class TaskGraphInfo:
    """The streaming task graph of one function (``analyze_task_graph``)."""
    tasks: List[List[Statement]]
    channels: List[ChannelSpec]
    eligible: bool
    reason: str = ""

    def describe(self) -> str:
        """Readable dump (the ``POM_DUMP_IR=taskgraph`` format)."""
        head = (f"taskgraph ({len(self.tasks)} task"
                f"{'s' if len(self.tasks) != 1 else ''}, "
                + ("dataflow-eligible" if self.eligible
                   else f"not eligible: {self.reason}") + ")")
        lines = [head]
        for t, grp in enumerate(self.tasks):
            for s in grp:
                arr, _ = s.store_access()
                reads = sorted({a.name for a, _ in s.load_accesses()})
                lines.append(f"  task {t}: {s.name}  "
                             f"[{', '.join(reads)}] -> {arr.name}")
        for ch in self.channels:
            extra = ""
            if ch.kind == "pipo":
                extra = f" chunks={ch.chunks} fill={ch.fill_chunks}"
            lines.append(
                f"  channel {ch.array}: {ch.producer} -> {ch.consumer}  "
                f"kind={ch.kind} depth={ch.depth}{extra} "
                f"bits={int(ch.bits)}")
        return "\n".join(lines)


# Fusion grouping depends only on registration order and the `after`
# placements — both untouched by the loop transforms DSE sweeps — so one
# derivation serves every candidate design of a run.  Cleared by
# ``caching.clear_all``.
_FUSION_CACHE: Dict[Tuple, List[List[Statement]]] = {}


def fusion_tasks(fn: Function) -> List[List[Statement]]:
    """Statements grouped into tasks = fusion groups in program order (the
    same grouping the AST builder opens one top-level nest per)."""
    from . import caching
    key = None
    if caching.ENABLED:
        key = tuple((s.uid,
                     None if s.after_spec is None
                     else (s.after_spec[0].uid, s.after_spec[1]))
                    for s in fn.statements)
        hit = _FUSION_CACHE.get(key)
        if hit is not None:
            return hit
    from .astbuild import _program_order, _share_with_prev
    order = _program_order(fn)
    share = _share_with_prev(order)
    tasks: List[List[Statement]] = []
    for s, sh in zip(order, share):
        if sh > 0 and tasks:
            tasks[-1].append(s)
        else:
            tasks.append([s])
    if key is not None:
        if len(_FUSION_CACHE) >= 1024:
            _FUSION_CACHE.clear()
        _FUSION_CACHE[key] = tasks
    return tasks


def _perm_access(stmt: Statement, idx: Sequence) -> Optional[Tuple]:
    """Positional shape of a permutation access: per index position, the
    (loop depth of the driving dim, constant offset), or None when some
    position is not a distinct single dim with unit coefficient.  Such an
    access touches each element exactly once per sweep, in an order fully
    determined by the positional tuple — two statements with equal tuples
    (and equal positional loop bounds) write/read the array in the *same*
    element order, which is the FIFO condition."""
    if len(idx) != len(stmt.dims):
        return None
    pos = {d: i for i, d in enumerate(stmt.dims)}
    out = []
    seen = set()
    for e in idx:
        key = e.key()
        if len(key[0]) != 1:
            return None
        (var, coeff), = key[0]
        if coeff != 1 or var not in pos or var in seen:
            return None
        seen.add(var)
        out.append((pos[var], key[1]))
    return tuple(out)


def _chunk_stride(stmt: Statement, idx: Sequence, p: int,
                  writer: bool) -> Optional[Tuple[int, int, int]]:
    """Major-block decomposition of index position ``p``: returns
    ``(a, lo, hi)`` when ``idx[p] = a*outer + r`` with ``outer`` the
    statement's outermost loop dim (coefficient ``a > 0``) and the
    residual ``r`` (inner dims + constant) confined to ``[lo, hi]`` — so
    the window of array slices touched along dim ``p`` advances
    monotonically, ``a`` slices per outer-loop iteration.  For a *writer*
    the residual must fit inside one stride (``hi - lo <= a - 1``):
    blocks may not overlap, or a block would be revisited after the next
    one started.  A reader's window may span several blocks (a stencil
    halo) — that only widens the fill lag.  Survives DSE splits
    (``idx = f*i_o + i_u``, ``i_u in [0, f)``): the residual bounds come
    from ``Statement.dim_bounds``, the fact the PR-4 transfer algebra
    pushes through every recorded basis step.  None when the access is
    not block-monotone in ``p``."""
    if p >= len(idx) or not stmt.dims:
        return None
    e = idx[p]
    outer = stmt.dims[0]
    a = e.coeffs.get(outer, 0)
    if a <= 0:
        return None
    bounds = stmt.dim_bounds()
    lo = hi = e.const
    for v, c in e.coeffs.items():
        if v == outer or c == 0:
            continue
        b = bounds.get(v)
        if b is None:
            return None
        lo += min(c * b[0], c * b[1])
        hi += max(c * b[0], c * b[1])
    if writer and hi - lo > a - 1:
        return None
    return (a, lo, hi)


def _elem_bits(fn: Function, array: str) -> float:
    ph = fn.placeholders.get(array)
    return float(ph.dtype.bits) if ph is not None else 32.0


def _array_bits(fn: Function, array: str) -> float:
    ph = fn.placeholders.get(array)
    if ph is None:
        return 0.0
    n = 1
    for s in ph.shape:
        n *= s
    return float(n * ph.dtype.bits)


# Per-edge classification memo: an edge's kind/depth/bits depend only on
# the writer's and readers' (uid, domain, composed accesses) plus the
# array name and fan-out flag — uid pins the owning function, and the
# placeholder facts read (dtype bits, shape) are immutable.  A candidate
# design changes one statement's basis; every channel not touching it
# re-classifies from here.  Cleared by ``caching.clear_all``.
_EDGE_CACHE: Dict[Tuple, Tuple[str, int, int, int, float]] = {}


def _classify_edge(fn: Function, writer: Statement, readers: List[Statement],
                   array: str, multi_consumer: bool) -> Tuple[str, int, int, int, float]:
    if not caching.ENABLED:
        return _classify_edge_compute(fn, writer, readers, array,
                                      multi_consumer)
    key = (writer.uid, writer.domain.key(), writer.subst_signature(),
           tuple((r.uid, r.domain.key(), r.subst_signature())
                 for r in readers),
           array, multi_consumer)
    hit = _EDGE_CACHE.get(key)
    if hit is not None:
        return hit
    out = _classify_edge_compute(fn, writer, readers, array, multi_consumer)
    if len(_EDGE_CACHE) >= 8192:
        _EDGE_CACHE.clear()
    _EDGE_CACHE[key] = out
    return out


def _classify_edge_compute(fn: Function, writer: Statement,
                           readers: List[Statement], array: str,
                           multi_consumer: bool) -> Tuple[str, int, int, int, float]:
    """(kind, depth, chunks, fill_chunks, bits) of one producer→consumer
    array edge, weakest kind over all reader access functions."""
    w_arr, w_idx = writer.store_access()
    # ---- FIFO: exact in-order elementwise hand-off --------------------------
    if not multi_consumer and len(readers) == 1:
        r = readers[0]
        r_accs = [idx for a, idx in r.load_accesses() if a.name == array]
        distinct = {tuple(e.key() for e in idx) for idx in r_accs}
        # a permutation store covers every loop dim injectively, so each
        # element is written exactly once (no write→write self-dependence)
        w_perm = _perm_access(writer, w_idx)
        r_perm = _perm_access(r, r_accs[0]) if len(distinct) == 1 else None
        if w_perm is not None and w_perm == r_perm:
            wb, rb = writer.dim_bounds(), r.dim_bounds()
            w_bounds = [wb.get(d) for d in writer.dims]
            r_bounds = [rb.get(d) for d in r.dims]
            if (None not in w_bounds and w_bounds == r_bounds):
                bits = FIFO_DEPTH * _elem_bits(fn, array)
                return ("fifo", FIFO_DEPTH, 0, 0, bits)
    # ---- PIPO: major-block monotone on both sides at some index position ----
    wb = writer.dim_bounds().get(writer.dims[0]) if writer.dims else None
    for p in range(len(w_idx)):
        w = _chunk_stride(writer, w_idx, p, writer=True)
        if w is None or wb is None:
            continue
        stride, _w_lo, w_hi = w
        chunks = max(1, wb[1] - wb[0] + 1)
        max_lag = 0
        ok = True
        for r in readers:
            for arr, idx in r.load_accesses():
                if arr.name != array:
                    continue
                rc = _chunk_stride(r, idx, p, writer=False)
                if rc is None:
                    ok = False
                    break
                # producer chunks the consumer's window runs ahead of the
                # writer's block (stencil halo): widens the fill window
                lag = -(-max(0, rc[2] - w_hi) // stride)    # ceil division
                max_lag = max(max_lag, lag)
            if not ok:
                break
        if ok:
            fill = 1 + max_lag
            depth = fill + 1
            # one chunk = the block one producer outer-iteration finalizes
            bits = depth * _array_bits(fn, array) / chunks
            return ("pipo", depth, chunks, fill, bits)
    # ---- fallback: pure ordering edge ---------------------------------------
    return ("seq", 0, 0, 0, 0.0)


# Task-graph memo: the graph reads program order (``after_spec``), the
# composed access functions (``iter_subst``) and the loop bounds
# (``domain``) — never unroll factors, pipeline markers, or array
# partitions, which are exactly what stage-2 DSE candidates mutate.  One
# derivation therefore serves every candidate of a rung (and, absent
# fusion changes, the whole search).  Keyed per statement on the state
# that matters; uids are globally unique, so distinct functions never
# collide.  Cleared by ``caching.clear_all``.
_TASKGRAPH_CACHE: Dict[Tuple, "TaskGraphInfo"] = {}


def _taskgraph_key(fn: Function) -> Tuple:
    return tuple(
        (s.uid, s.domain.key(), s.subst_signature(),
         None if s.after_spec is None
         else (s.after_spec[0].uid, s.after_spec[1]))
        for s in fn.statements)


def analyze_task_graph(fn: Function) -> TaskGraphInfo:
    """Build the streaming task graph of ``fn``: fusion groups as tasks,
    classified channels on every cross-task producer→consumer array.

    A function is dataflow-*eligible* when tasks form a single-writer
    forward DAG: every array is written by at most one task, and no task
    reads an array a *later* task writes (such an anti-dependence would
    race under concurrent task start — HLS rejects the region, and so do
    we).  Ineligible functions keep the sequential schedule; the info
    still carries the tasks and the reason for the dump.

    Memoized on the schedule state the graph actually reads (see
    ``_TASKGRAPH_CACHE``): DSE re-queries this for every candidate design,
    and the answer only changes when fusion or the loop basis changes."""
    if not caching.ENABLED:
        return _analyze_task_graph_compute(fn)
    key = _taskgraph_key(fn)
    hit = _TASKGRAPH_CACHE.get(key)
    if hit is not None:
        return hit
    info = _analyze_task_graph_compute(fn)
    if len(_TASKGRAPH_CACHE) >= 2048:
        _TASKGRAPH_CACHE.clear()
    _TASKGRAPH_CACHE[key] = info
    return info


# Structure-only skeleton memo: fusion groups, the single-writer map and
# the per-(array, task) reader lists depend on program order and on which
# arrays each statement touches — both fixed per uid, untouched by every
# loop transform DSE applies.  One derivation serves every candidate
# design of a run; only the per-edge classification (which reads the loop
# basis) re-runs, and that hits ``_EDGE_CACHE`` for every edge whose two
# endpoints kept their schedules.  Cleared by ``caching.clear_all``.
_SKELETON_CACHE: Dict[Tuple, tuple] = {}


def _taskgraph_skeleton(fn: Function) -> tuple:
    if not caching.ENABLED:
        return _taskgraph_skeleton_compute(fn)
    key = tuple((s.uid,
                 None if s.after_spec is None
                 else (s.after_spec[0].uid, s.after_spec[1]))
                for s in fn.statements)
    hit = _SKELETON_CACHE.get(key)
    if hit is not None:
        return hit
    skel = _taskgraph_skeleton_compute(fn)
    if len(_SKELETON_CACHE) >= 1024:
        _SKELETON_CACHE.clear()
    _SKELETON_CACHE[key] = skel
    return skel


def _taskgraph_skeleton_compute(fn: Function) -> tuple:
    """(tasks, edges, fail_reason): ``edges`` is the classified-channel
    worklist ``(array, writer, readers, writer_task, reader_task, multi)``
    in deterministic order; ``fail_reason`` is the eligibility failure or
    None."""
    tasks = fusion_tasks(fn)
    if len(tasks) < 2:
        return (tasks, (), "single task")
    writer_of: Dict[str, int] = {}
    writer_stmt: Dict[str, Statement] = {}
    for t, grp in enumerate(tasks):
        for s in grp:
            arr, _ = s.store_access()
            prev = writer_of.get(arr.name)
            if prev is not None and prev != t:
                return (tasks, (),
                        f"array {arr.name} written by tasks {prev} and {t}")
            writer_of[arr.name] = t
            writer_stmt[arr.name] = s
    readers_of: Dict[Tuple[str, int], List[Statement]] = {}
    consumer_tasks: Dict[str, Set[int]] = {}
    for t, grp in enumerate(tasks):
        for s in grp:
            for a, _ in s.load_accesses():
                w = writer_of.get(a.name)
                if w is None or w == t:
                    continue
                if w > t:
                    return (tasks, (),
                            f"task {t} reads {a.name} before task {w} writes it")
                lst = readers_of.setdefault((a.name, t), [])
                if s not in lst:
                    lst.append(s)
                consumer_tasks.setdefault(a.name, set()).add(t)
    edges = tuple(
        (array, writer_stmt[array], tuple(readers), writer_of[array], t,
         len(consumer_tasks[array]) > 1)
        for (array, t), readers in sorted(
            readers_of.items(), key=lambda kv: (kv[0][1], kv[0][0])))
    return (tasks, edges, None)


def _analyze_task_graph_compute(fn: Function) -> TaskGraphInfo:
    tasks, edges, reason = _taskgraph_skeleton(fn)
    if reason is not None:
        return TaskGraphInfo(tasks, [], False, reason)
    channels: List[ChannelSpec] = []
    for array, w, readers, tw, t, multi in edges:
        kind, depth, chunks, fill, bits = _classify_edge(
            fn, w, readers, array, multi)
        channels.append(ChannelSpec(
            array, w.name, readers[0].name, tw, t,
            kind, depth, chunks, fill, bits))
    return TaskGraphInfo(tasks, channels, True)


def share_structural_memos(g: GraphIR, warm: Sequence[str] = ()) -> Dict[Tuple, List[str]]:
    """Common-subexpression sharing: group structurally identical ops.

    Populates ``g.cse_classes`` (key → member op names).  With ``warm``
    analyses named (subset of {"trip", "selfdep"}) and caching enabled, the
    class representative's analyses are computed eagerly so that every
    other member hits the name-canonical memo tables from the incremental
    engine (PR 1) instead of re-deriving them.  Warming is restricted to
    analyses the downstream stages are guaranteed to run anyway, so total
    evaluation counts are unchanged — only *when* the one real computation
    happens moves.
    """
    classes: Dict[Tuple, List[GraphOp]] = {}
    for o in g.ops:
        classes.setdefault(op_structural_key(o.stmt), []).append(o)
    g.cse_classes = {k: [o.name for o in ops] for k, ops in classes.items()}
    if warm:
        if caching.ENABLED:
            from .transforms import self_dependences
            for ops in classes.values():
                rep = ops[0].stmt
                if "trip" in warm:
                    rep.trip_counts()
                if "selfdep" in warm:
                    self_dependences(rep)
    return g.cse_classes


# --------------------------------------------------------------------------
# scan-over-layers: repeated isomorphic task blocks
# --------------------------------------------------------------------------
# Deep models repeat the same layer body N times with different weights
# (conv→relu chains, transformer blocks).  Unrolling N structurally equal
# blocks makes the traced program N× bigger for zero information; the
# Pallas serving path instead compiles ONE block body and ``lax.scan``s it
# over the per-block arrays (the haliax `Stacked` idiom).  Detection runs
# here, at the Graph IR level, over the fusion task list: a *chain* is a
# maximal run of >=2 consecutive task blocks (``period`` tasks each) whose
# per-task ``op_structural_key`` + array shape/dtype signatures are equal,
# whose roles derive cleanly:
#
#   * **carry** — a template read whose block-*b* array is block-*b-1*'s
#     write (the activation chain); at most one, same shape both ends;
#   * **stacked reads** — reads bound to a different external array per
#     block (the weights), never written inside the chain;
#   * **writes** — per-block destination arrays, globally distinct;
#   * **invariant reads** — the same external array in every block.
#
# Anything else (a non-carry cross-block read, aliased writes, a name
# mapping that isn't 1:1) disqualifies the run — correctness beats
# coverage, the unrolled schedule is always available.


def scan_default() -> bool:
    """Ambient scan-over-layers toggle: ``POM_PALLAS_SCAN=0`` keeps every
    repeated block unrolled (bit-identical schedules, N× the trace)."""
    return os.environ.get("POM_PALLAS_SCAN", "1") != "0"


@dataclass(frozen=True)
class ScanChainInfo:
    """One detected run of isomorphic task blocks (see module comment)."""
    start: int                 # first task index of the first block
    period: int                # tasks per block
    n: int                     # number of blocks (>= 2)
    carry_in: Optional[str]    # template (block-0) read name of the carry
    carry_out: Optional[str]   # template write name feeding the next block
    reads: Tuple[Tuple[str, Tuple[str, ...]], ...]   # tmpl name -> per-block
    writes: Tuple[Tuple[str, Tuple[str, ...]], ...]  # tmpl name -> per-block


def _task_block_key(task: List[Statement]) -> Tuple:
    """Structural key of one task for block-isomorphism: op structure plus
    the array shapes/dtypes it touches (``op_structural_key`` canonicalizes
    names away, so shape agreement must be checked separately)."""
    parts = []
    for s in task:
        arr, _ = s.store_access()
        loads = tuple((a.shape, a.dtype.name) for a, _ in s.load_accesses())
        parts.append((op_structural_key(s), arr.shape, arr.dtype.name, loads))
    return tuple(parts)


def _derive_scan_roles(tasks: List[List[Statement]], start: int, p: int,
                       n: int) -> Optional[ScanChainInfo]:
    blocks = [[s for t in tasks[start + b * p: start + (b + 1) * p]
               for s in t] for b in range(n)]

    def sig(blk):
        reads, writes, shapes = [], [], {}
        for s in blk:
            arr, _ = s.store_access()
            writes.append(arr.name)
            shapes[arr.name] = arr.shape
            row = []
            for a, _ in s.load_accesses():
                row.append(a.name)
                shapes[a.name] = a.shape
            reads.append(tuple(row))
        return reads, writes, shapes

    t_reads, t_writes, t_shapes = sig(blocks[0])
    # per-block template-name -> block-name maps (must be functions)
    maps: List[Dict[str, str]] = []
    for blk in blocks:
        r, w, _ = sig(blk)
        m: Dict[str, str] = {}
        for pairs in ([list(zip(t_writes, w))]
                      + [list(zip(tr, br)) for tr, br in zip(t_reads, r)]):
            for tn, bn in pairs:
                if m.setdefault(tn, bn) != bn:
                    return None
        maps.append(m)

    tw_set = set(t_writes)
    all_writes = {m[w] for m in maps for w in tw_set}
    if len(all_writes) != n * len(tw_set):
        return None                       # aliased writes across blocks
    writes = tuple((w, tuple(m[w] for m in maps)) for w in sorted(tw_set))

    carry_in = carry_out = None
    reads = []
    read_names = sorted({tn for row in t_reads for tn in row} - tw_set)
    for rn in read_names:
        per = [m[rn] for m in maps]
        if all(x == per[0] for x in per):
            if per[0] in all_writes:
                return None               # fixed-name read of a block output
            continue                      # invariant (stays in bufs)
        carry_w = next(
            (w for w in tw_set
             if all(maps[b][rn] == maps[b - 1][w] for b in range(1, n))),
            None)
        if carry_w is not None:
            if carry_in is not None:
                return None               # multiple carries unsupported
            if t_shapes.get(rn) != t_shapes.get(carry_w):
                return None
            carry_in, carry_out = rn, carry_w
            continue
        if any(x in all_writes for x in per):
            return None                   # non-carry cross-block dependence
        reads.append((rn, tuple(per)))
    return ScanChainInfo(start, p, n, carry_in, carry_out,
                         tuple(reads), writes)


def detect_scan_chains(fn: Function) -> List[ScanChainInfo]:
    """Find non-overlapping scan chains over the fusion task list, smallest
    period first (a conv→relu pair matches at period 2 before any larger
    super-period could claim it)."""
    tasks = fusion_tasks(fn)
    keys = [_task_block_key(t) for t in tasks]
    m = len(tasks)
    chains: List[ScanChainInfo] = []
    used: set = set()
    for p in range(1, m // 2 + 1):
        i = 0
        while i + 2 * p <= m:
            if any((i + k) in used for k in range(p)):
                i += 1
                continue
            bk = tuple(keys[i:i + p])
            n = 1
            while (i + (n + 1) * p <= m
                   and tuple(keys[i + n * p: i + (n + 1) * p]) == bk
                   and not any((i + n * p + k) in used for k in range(p))):
                n += 1
            if n >= 2:
                info = _derive_scan_roles(tasks, i, p, n)
                if info is not None:
                    chains.append(info)
                    used.update(range(i, i + n * p))
                    i += n * p
                    continue
            i += 1
    chains.sort(key=lambda c: c.start)
    return chains
