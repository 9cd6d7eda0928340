"""Pass pipeline: the spine connecting POM's three IR levels (paper §V).

The whole flow is expressed as named passes over a ``PipelineContext``::

    dsl  →  GraphIR  →  [graph passes]  →  polyhedral IR
         →  [transforms / DSE schedule application]  →  annotated loop IR
         →  backend (HLS C / numpy oracle / CUDA)

Each stage boundary has a verifier:

  * **graph**  — domain/substitution well-formedness, edge sanity
    (``GraphIR.verify``);
  * **poly**   — dependence preservation: every statement's current
    schedule must execute all dependences source-before-sink
    (``transforms._legal``), and every ``after`` fusion spec must satisfy
    the cross-statement check (``transforms.fuse_legal``);
  * **loops**  — bound sanity: every loop has lower and upper bounds,
    constant bounds yield non-negative trips, bound expressions only
    reference enclosing loop variables, and every statement appears
    exactly once with a fully-mapped ``dim_map``.

Verifiers run under ``caching.counting_paused()`` so they never perturb
the incremental engine's evaluation counters (the DSE benchmarks are
count-based).

Debugging (the paper's "streamlined debugging" claim): set
``POM_DUMP_IR=graph|poly|loops|taskgraph|backend|all`` to dump the IR after every
pass that produces that stage.

``compile(fn, target=...)`` is the single entry point; the three backends
are lowering passes behind it, and ``dse.auto_dse`` runs its two search
stages as passes of the same pipeline.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import telemetry
from .errors import warn_structured
from .ir import Function
from .graph_ir import (GraphError, GraphIR, eliminate_dead_ops, fuse_ops,
                       share_structural_memos)


class VerifyError(Exception):
    """A per-stage verifier rejected the IR."""


@dataclass
class PipelineContext:
    """Mutable state threaded through the passes of one compilation."""
    fn: Function
    target: Optional[str] = None
    graph: Optional[GraphIR] = None
    ast: Any = None                        # loop_ir.ProgramAST
    artifact: Any = None                   # backend output
    options: Dict[str, Any] = field(default_factory=dict)
    records: Dict[str, Any] = field(default_factory=dict)


class Pass:
    """A named pipeline step.  ``stage`` labels which IR level it belongs
    to; ``dumps`` names the stage artifact it (re)produces, used by the
    ``POM_DUMP_IR`` hook."""
    name: str = "?"
    stage: str = "?"
    dumps: Optional[str] = None

    def run(self, ctx: PipelineContext) -> None:
        raise NotImplementedError


def _count_ast(node) -> int:
    """Loop-IR node count (per-pass span IR-size argument)."""
    n = 1
    for c in getattr(node, "body", ()) or ():
        n += _count_ast(c)
    return n


def _ir_sizes(ctx: PipelineContext) -> Dict[str, int]:
    """Sizes of whatever IR levels exist right now — attached to each
    pipeline-pass span so a trace shows the program growing/shrinking
    through DCE, fusion, and lowering."""
    sizes = {"statements": len(ctx.fn.statements)}
    if ctx.graph is not None:
        sizes["graph_ops"] = len(ctx.graph.ops)
    if ctx.ast is not None:
        sizes["ast_nodes"] = _count_ast(ctx.ast)
    return sizes


# the stage artifacts POM_DUMP_IR knows how to print (+ "all")
KNOWN_DUMP_STAGES: Tuple[str, ...] = ("graph", "poly", "loops", "taskgraph",
                                      "backend", "all")


class PassManager:
    """Runs passes in order; honors ``POM_DUMP_IR``.

    ``dump`` overrides the env toggle; pass ``"all"`` to dump every stage.
    An unknown stage name warns (``pipeline.unknown_dump_stage``) instead
    of silently dumping nothing.  With a trace session active, every pass
    runs under a ``pass.<name>`` span carrying the post-pass IR sizes.
    """

    def __init__(self, passes: Sequence[Pass], dump: Optional[str] = None):
        self.passes: List[Pass] = list(passes)
        self.dump = dump if dump is not None else os.environ.get("POM_DUMP_IR")
        if self.dump and self.dump not in KNOWN_DUMP_STAGES:
            warn_structured("pipeline", "unknown_dump_stage",
                            stage=self.dump,
                            known="|".join(KNOWN_DUMP_STAGES))

    def run(self, ctx: PipelineContext) -> PipelineContext:
        ctx.options.setdefault("_dump", self.dump)
        for p in self.passes:
            if telemetry.on():
                with telemetry.span(f"pass.{p.name}", _cat="pipeline",
                                    stage=p.stage) as sp:
                    p.run(ctx)
                    sp.add(**_ir_sizes(ctx))
            else:
                p.run(ctx)
            if p.dumps and self.dump and self.dump in (p.dumps, "all"):
                self._dump(p, ctx)
        return ctx

    def _dump(self, p: Pass, ctx: PipelineContext, out=None) -> None:
        out = out or sys.stderr
        print(f"// POM_DUMP_IR [{p.dumps}] after pass '{p.name}'", file=out)
        if p.dumps == "graph" and ctx.graph is not None:
            print(ctx.graph.describe(), file=out)
        elif p.dumps == "taskgraph" and ctx.records.get("taskgraph") is not None:
            print(ctx.records["taskgraph"].describe(), file=out)
        elif p.dumps == "poly":
            print(ctx.fn.describe(), file=out)
        elif p.dumps == "loops" and ctx.ast is not None:
            from . import loop_ir
            print(loop_ir.describe(ctx.ast), file=out)
        elif p.dumps == "backend":
            a = ctx.artifact
            print(a if isinstance(a, str) else repr(a), file=out)
        print(file=out)


# --------------------------------------------------------------------------
# graph stage
# --------------------------------------------------------------------------
class BuildGraph(Pass):
    name, stage, dumps = "build-graph", "graph", "graph"

    def __init__(self, outputs: Optional[Sequence[str]] = None):
        self.outputs = outputs

    def run(self, ctx: PipelineContext) -> None:
        ctx.graph = GraphIR.from_function(ctx.fn, outputs=self.outputs)


class VerifyGraph(Pass):
    name, stage = "verify-graph", "graph"

    def run(self, ctx: PipelineContext) -> None:
        from . import caching
        with caching.counting_paused():
            try:
                ctx.graph.verify()
            except GraphError as e:
                raise VerifyError(f"graph verifier: {e}") from e


class GraphDCE(Pass):
    name, stage, dumps = "graph-dce", "graph", "graph"

    def run(self, ctx: PipelineContext) -> None:
        ctx.records["dce"] = eliminate_dead_ops(ctx.graph)


class GraphFuse(Pass):
    name, stage, dumps = "graph-fuse", "graph", "graph"

    def run(self, ctx: PipelineContext) -> None:
        ctx.records["fuse"] = fuse_ops(ctx.graph)


class GraphCSE(Pass):
    """CSE sharing classes.  Default warming covers only trip counts —
    the one analysis every downstream stage (AST build, cost models)
    queries; ``auto_dse`` passes ``warm=()`` to keep the count-based
    benchmarks provably untouched, and DSE pipelines may opt into
    ``"selfdep"`` where dependence analysis is guaranteed to run."""
    name, stage, dumps = "graph-cse", "graph", "graph"

    def __init__(self, warm: Sequence[str] = ("trip",)):
        self.warm = tuple(warm)

    def run(self, ctx: PipelineContext) -> None:
        classes = share_structural_memos(ctx.graph, warm=self.warm)
        ctx.records["cse"] = {
            "classes": len(classes),
            "shared_ops": sum(len(m) - 1 for m in classes.values()),
        }


GRAPH_PASSES: Dict[str, Callable[[], Pass]] = {
    "dce": GraphDCE, "fuse": GraphFuse, "cse": GraphCSE,
}


# --------------------------------------------------------------------------
# polyhedral stage
# --------------------------------------------------------------------------
class LowerToPoly(Pass):
    name, stage, dumps = "lower-to-poly", "poly", "poly"

    def run(self, ctx: PipelineContext) -> None:
        ctx.fn = ctx.graph.to_function()


def verify_polyhedral(fn: Function,
                      fused: Sequence[Tuple[str, str, int]] = ()) -> None:
    """Poly-stage verifier: dependence preservation + domain boundedness.

    Per-statement: every loop keeps lower and upper bounds and the current
    schedule executes every self-dependence source-before-sink
    (``transforms._legal``).  Every ``after`` spec is structurally sane
    (target present, level within both nests).  ``fused`` names the
    fusion specs *created by passes* — (consumer, producer, level)
    triples from stage 1 or the graph fusion pass — which additionally
    must satisfy the cross-statement dependence check: user-authored
    ``after`` specs in the DSL define program semantics (e.g. a stencil's
    time-loop alternation) and are deliberately not re-derived.

    Raises ``VerifyError``.  Counter-neutral (``counting_paused``)."""
    from . import caching
    from . import transforms as T
    with caching.counting_paused():
        in_fn = {id(s) for s in fn.statements}
        for s in fn.statements:
            for i, d in enumerate(s.dims):
                los, ups = s.domain.bounds_of(d, s.dims[i + 1:])
                if not los or not ups:
                    raise VerifyError(
                        f"poly verifier: {s.name}: loop {d} lost its "
                        f"{'lower' if not los else 'upper'} bound")
            if not T._legal(s):
                raise VerifyError(
                    f"poly verifier: schedule of {s.name} reverses a "
                    f"dependence (current order {s.dims})")
        for s in fn.statements:
            if s.after_spec is None:
                continue
            target, level = s.after_spec
            if id(target) not in in_fn:
                raise VerifyError(
                    f"poly verifier: {s.name} is `after` {target.name}, "
                    f"which is not in the function")
            if not (0 <= level < min(len(s.dims), len(target.dims))):
                raise VerifyError(
                    f"poly verifier: {s.name} fused at level {level} but "
                    f"dims are {s.dims} / {target.dims}")
        for consumer, producer, level in fused:
            try:
                sc, sp = fn.stmt(consumer), fn.stmt(producer)
            except KeyError:
                continue             # dropped or renamed since fusion
            if sc.after_spec is None or sc.after_spec[0] is not sp:
                continue             # spec was since removed (distribution)
            if not T.fuse_legal(sc, sp, level + 1):
                raise VerifyError(
                    f"poly verifier: fusing {consumer} after {producer} at "
                    f"level {level} violates a cross-statement dependence")


class VerifyPoly(Pass):
    name, stage = "verify-poly", "poly"

    def run(self, ctx: PipelineContext) -> None:
        fused: List[Tuple[str, str, int]] = []
        if ctx.graph is not None:
            fused += ctx.graph.fused
        log = ctx.records.get("stage1")
        if log is not None:
            fused += log.fused
        verify_polyhedral(ctx.fn, fused=fused)


class Stage1DSE(Pass):
    """Dependence-aware code transformation (paper §VI-A) as a pass."""
    name, stage, dumps = "dse-stage1", "poly", "poly"

    def run(self, ctx: PipelineContext) -> None:
        from .dse import stage1
        ctx.records["stage1"] = stage1(ctx.fn)


class Stage2DSE(Pass):
    """Bottleneck-oriented optimization (paper §VI-B) as a pass.

    The candidate ladder evaluates designs through ``options["model"]``
    (an ``HlsModel``) — the pipeline owns the evaluator, the search never
    reaches into backend internals.

    The searcher itself is pluggable (``search.py``): ``strategy`` — a
    registered name (``"greedy"``, ``"beam[:k]"``, ``"parallel[:n]"``) or a
    ``search.SearchStrategy`` instance — picks it, falling back to
    ``ctx.options["strategy"]``, then the ``POM_DSE_STRATEGY`` environment
    variable, then greedy.  The subclasses below register the alternative
    strategies as their own named passes (``STAGE2_PASSES``)."""
    name, stage, dumps = "dse-stage2", "poly", "poly"

    def __init__(self, strategy=None):
        self.strategy = strategy

    def run(self, ctx: PipelineContext) -> None:
        from .cost_model import HlsModel
        from .search import ParetoArchive, resolve_strategy, run_stage2
        model = ctx.options.get("model") or HlsModel()
        ctx.options["model"] = model
        archive = ctx.options.get("archive")
        dump_pareto = os.environ.get("POM_DUMP_PARETO")
        if archive is True or (archive is None and dump_pareto):
            archive = ctx.options["archive"] = ParetoArchive()
        strategy = resolve_strategy(
            self.strategy if self.strategy is not None
            else ctx.options.get("strategy"),
            beam_width=ctx.options.get("beam_width"),
            workers=ctx.options.get("workers"))
        actions: List[str] = []
        report = run_stage2(ctx.fn, model,
                            ctx.options.get("max_parallel", 256), actions,
                            strategy=strategy, archive=archive)
        ctx.records["stage2"] = {"report": report, "actions": actions,
                                 "strategy": strategy.describe(),
                                 "strategy_obj": strategy,
                                 "archive": archive}
        if dump_pareto and archive is not None:
            archive.dump(dump_pareto)


class Stage2BeamDSE(Stage2DSE):
    """Stage 2 with anchored beam search (``search.BeamSearch``)."""
    name = "dse-stage2-beam"

    def __init__(self, width: int = 2):
        super().__init__(f"beam:{width}")


class Stage2ParallelDSE(Stage2DSE):
    """Stage 2 with worker-pool candidate evaluation
    (``search.ParallelSearch``)."""
    name = "dse-stage2-parallel"

    def __init__(self, workers: Optional[int] = None):
        super().__init__(f"parallel:{workers}" if workers else "parallel")


# alternative stage-2 searchers, registered as pipeline passes; the key is
# the strategy name accepted by ``stage2_pass`` / ``POM_DSE_STRATEGY``
STAGE2_PASSES: Dict[str, Callable[..., Stage2DSE]] = {
    "greedy": Stage2DSE, "beam": Stage2BeamDSE, "parallel": Stage2ParallelDSE,
}


def stage2_pass(spec: Optional[str] = None) -> Stage2DSE:
    """Build the stage-2 pass for a strategy spec (``"beam:4"`` etc.).

    ``search.resolve_strategy`` is the single parser/validator of record:
    it raises immediately — naming the original spec — on unknown names
    or stray parameters (e.g. ``"greedy:2"``), instead of failing later
    at pipeline run time."""
    if spec is None:
        return Stage2DSE()
    if not isinstance(spec, str):
        return Stage2DSE(spec)          # a SearchStrategy instance/class
    from .search import resolve_strategy
    resolve_strategy(spec)              # validate eagerly, best error here
    name, _, arg = spec.partition(":")
    cls = STAGE2_PASSES[name]
    if cls is Stage2DSE:
        return Stage2DSE(spec)
    if arg and not arg.lstrip("-").isdigit():
        # rich parameterization ("beam:scalar", "beam:8:parallel", ...):
        # the named subclasses only spell the single-int shorthand, so
        # carry the validated spec through the generic pass
        return Stage2DSE(spec)
    return cls(int(arg)) if arg else cls()


# --------------------------------------------------------------------------
# loop stage
# --------------------------------------------------------------------------
class BuildTaskGraph(Pass):
    """Streaming task-graph analysis (``graph_ir.analyze_task_graph``).

    Runs only when dataflow is effective for the function (or the
    ``taskgraph`` dump was requested), so a ``POM_DATAFLOW=0`` pipeline
    issues zero extra analysis queries.  The info lands in
    ``ctx.records["taskgraph"]`` and feeds the ``POM_DUMP_IR=taskgraph``
    dump; the loop-IR build re-derives its own region (the analysis is
    memoized at the access/bound layer, so this costs dictionary hits)."""
    name, stage, dumps = "task-graph", "loops", "taskgraph"

    def run(self, ctx: PipelineContext) -> None:
        from .graph_ir import analyze_task_graph, dataflow_effective
        want_dump = ctx.options.get("_dump") in ("taskgraph", "all")
        if dataflow_effective(ctx.fn) or want_dump:
            ctx.records["taskgraph"] = analyze_task_graph(ctx.fn)


class BuildLoopIR(Pass):
    name, stage, dumps = "build-loop-ir", "loops", "loops"

    def run(self, ctx: PipelineContext) -> None:
        from .astbuild import build_ast
        ctx.ast = build_ast(ctx.fn)


def verify_loop_ir(fn: Function, ast) -> None:
    """Loop-stage verifier: bound sanity + statement coverage.  Dataflow
    regions/tasks are transparent containers: their bodies are verified in
    place, and a region's channels must name arrays of the function."""
    from .loop_ir import (DataflowRegion, ForNode, IfNode, ProgramAST,
                          ScanRegion, StmtNode, TaskNode)
    params = set()
    for s in fn.statements:
        params |= set(s.domain.params)
    seen: Dict[int, int] = {}

    def rec(node, scope: frozenset):
        if isinstance(node, ProgramAST):
            for c in node.body:
                rec(c, scope)
        elif isinstance(node, (DataflowRegion, TaskNode)):
            if isinstance(node, DataflowRegion):
                for ch in node.channels:
                    if ch.array not in fn.placeholders:
                        raise VerifyError(
                            f"loop verifier: dataflow channel names unknown "
                            f"array {ch.array!r}")
            for c in node.body:
                rec(c, scope)
        elif isinstance(node, ScanRegion):
            if node.n < 2 or len(node.body) != node.n * node.template_len:
                raise VerifyError(
                    f"loop verifier: scan region claims {node.n} blocks x "
                    f"{node.template_len} nodes but holds {len(node.body)}")
            for tn, per in list(node.reads.items()) + list(node.writes.items()):
                for a in (tn,) + tuple(per):
                    if a not in fn.placeholders:
                        raise VerifyError(
                            f"loop verifier: scan region names unknown "
                            f"array {a!r}")
                if len(per) != node.n:
                    raise VerifyError(
                        f"loop verifier: scan region binds {tn!r} to "
                        f"{len(per)} arrays for {node.n} blocks")
            for c in node.body:
                rec(c, scope)
        elif isinstance(node, ForNode):
            if node.var in scope:
                raise VerifyError(
                    f"loop verifier: loop var {node.var} shadows an "
                    f"enclosing loop")
            for lb in (node.lo, node.hi):
                if not lb.bounds:
                    raise VerifyError(
                        f"loop verifier: loop {node.var} has an empty "
                        f"{'lower' if lb.is_lower else 'upper'} bound")
                for b in lb.bounds:
                    stray = set(b.expr.vars()) - scope - params
                    if stray:
                        raise VerifyError(
                            f"loop verifier: bound of {node.var} references "
                            f"{sorted(stray)} outside enclosing loops")
                    if b.div < 1:
                        raise VerifyError(
                            f"loop verifier: loop {node.var} bound divisor "
                            f"{b.div} < 1")
            if node.lo.is_constant() and node.hi.is_constant():
                if node.hi.const_value() - node.lo.const_value() + 1 < 0:
                    raise VerifyError(
                        f"loop verifier: loop {node.var} has negative trip "
                        f"([{node.lo.const_value()}, {node.hi.const_value()}])")
            for c in node.body:
                rec(c, scope | {node.var})
        elif isinstance(node, IfNode):
            for cond in node.conds:
                stray = set(cond.expr.vars()) - scope - params
                if stray:
                    raise VerifyError(
                        f"loop verifier: guard references {sorted(stray)} "
                        f"outside enclosing loops")
            for c in node.body:
                rec(c, scope)
        elif isinstance(node, StmtNode):
            s = node.stmt
            seen[s.uid] = seen.get(s.uid, 0) + 1
            if set(node.dim_map) != set(s.dims):
                raise VerifyError(
                    f"loop verifier: {s.name} dim_map covers "
                    f"{sorted(node.dim_map)} but dims are {s.dims}")
            stray = set(node.dim_map.values()) - scope
            if stray:
                raise VerifyError(
                    f"loop verifier: {s.name} maps dims to loop vars "
                    f"{sorted(stray)} that are not in scope")
        else:
            raise VerifyError(f"loop verifier: unknown node {node!r}")

    rec(ast, frozenset())
    for s in fn.statements:
        if seen.get(s.uid, 0) != 1:
            raise VerifyError(
                f"loop verifier: statement {s.name} appears "
                f"{seen.get(s.uid, 0)} times in the loop IR (expected 1)")


class VerifyLoopIR(Pass):
    name, stage = "verify-loop-ir", "loops"

    def run(self, ctx: PipelineContext) -> None:
        from . import caching
        with caching.counting_paused():
            verify_loop_ir(ctx.fn, ctx.ast)


# --------------------------------------------------------------------------
# backend stage (lowering passes)
# --------------------------------------------------------------------------
class EmitHLS(Pass):
    name, stage, dumps = "emit-hls", "backend", "backend"

    def __init__(self, **kw):
        self.kw = kw

    def run(self, ctx: PipelineContext) -> None:
        from .backend_hls import emit_hls
        ctx.artifact = emit_hls(ctx.fn, ctx.ast, **self.kw)


class CompileJAX(Pass):
    name, stage, dumps = "compile-jax", "backend", "backend"

    def __init__(self, **kw):
        self.kw = kw

    def run(self, ctx: PipelineContext) -> None:
        from .backend_jax import compile_jax
        ctx.artifact = compile_jax(ctx.fn, ctx.ast, **self.kw)


class LowerCUDA(Pass):
    """Build the CUDA program: contraction nests on the kernel, every other
    statement on the whole-program step's own executor, on one device."""
    name, stage, dumps = "lower-cuda", "backend", "backend"

    def __init__(self, device=None, fallback: bool = True):
        self.device = device
        self.fallback = fallback

    def run(self, ctx: PipelineContext) -> None:
        ctx.artifact = lower_function_cuda(
            ctx.fn, ctx.ast, device=self.device, fallback=self.fallback)


def lower_function_cuda(fn: Function, ast=None, device=None,
                        fallback: bool = True):
    """Program-level CUDA artifact: a ``backend_cuda.CudaProgram``.

    Calling the artifact, ``.jitted()`` and ``.batched(B)`` run the whole
    loop AST — including ``ScanRegion`` scan-over-layers — as one eager
    step on ``device``: the nests the contraction matcher accepts on the
    kernel, every other statement on the step's own executor.  With
    ``fallback=False`` a program whose statements do not all reach the
    kernel (``mode != "cuda"``) raises ``CudaLowerError``.  ``device``
    defaults to ``cuda``; on a ``cuda`` device the CUDA probe must pass
    first (``CudaLowerError`` otherwise)."""
    from .. import resolve_device
    from .backend_cuda import CudaLowerError, CudaProgram
    from .astbuild import build_ast
    if ast is None:
        ast = build_ast(fn)
    prog = CudaProgram(fn, ast, resolve_device(device))
    if not fallback and prog.mode != "cuda":
        raise CudaLowerError(
            f"{fn.name}: not every statement reaches the contraction kernel "
            "and fallback is disabled")
    return prog


def backend_pass(target: str, **kw) -> Pass:
    if target in ("hls", "fpga"):
        return EmitHLS(**kw)
    if target == "jax":
        return CompileJAX(**kw)
    if target == "cuda":
        return LowerCUDA(**kw)
    if target == "pallas":
        raise ValueError("target 'pallas' is the JAX package's TPU backend; "
                         "this package's kernel backend is target 'cuda'")
    raise ValueError(f"unknown target {target!r} "
                     f"(expected 'hls', 'jax', or 'cuda')")


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------
DEFAULT_GRAPH_PASSES: Tuple[str, ...] = ("cse",)


def compile(fn, target: str = "hls",
            graph_passes: Sequence[str] = DEFAULT_GRAPH_PASSES,
            outputs: Optional[Sequence[str]] = None,
            dse: bool = False, max_parallel: int = 256,
            model=None, dump: Optional[str] = None,
            strategy=None, archive=None,
            dataflow: Optional[bool] = None,
            trace_path: Optional[str] = None, **backend_kw):
    """Compile a POM function through the full three-level pipeline.

    ``fn`` is an ``ir.Function`` or a DSL ``PomFunction``.  ``target``
    picks the lowering pass: ``"hls"`` returns synthesizable C,
    ``"jax"`` an executable oracle ``run(arrays) -> dict``, ``"cuda"``
    a ``CudaProgram`` (contraction kernels plus the step's own executor)
    on ``device`` (``cuda`` unless the caller passes ``device="cpu"``).  ``graph_passes`` names
    graph-level optimizations to run (``"cse"``, ``"dce"``, ``"fuse"``);
    the default is the always-safe memo-sharing pass.  When ``outputs``
    narrows the externally observable arrays, dead-op elimination is
    prepended automatically (that is what ``outputs`` is for).
    ``dse=True`` runs the two-stage DSE between the poly verifiers first;
    ``strategy`` picks the stage-2 searcher (see ``STAGE2_PASSES``) and
    ``archive`` takes a caller-owned ``search.ParetoArchive`` instance
    that collects every evaluated design (``compile`` returns only the
    backend artifact, so pass an instance you keep a reference to — or
    set ``POM_DUMP_PARETO`` to dump the frontier; ``archive=True`` is
    only useful through ``auto_dse``, which returns the archive).
    ``dataflow`` sets the function's task-level-pipelining toggle
    (True/False override the ``POM_DATAFLOW`` environment default; None
    keeps the function's current setting) — with it on, an eligible
    multi-task function is emitted as a dataflow region (HLS) or an
    annotation-only region (oracle/CUDA — numerics unchanged).
    ``trace_path`` (or ``POM_TRACE``) opens a telemetry trace session for
    this compile and exports it on return — Chrome trace-event JSON to a
    path, or a compact tree summary to stdout for ``"-"``.  Backend
    keyword arguments (``top_name``, ``device``, …) pass through.
    """
    real_fn = fn if isinstance(fn, Function) else fn.fn
    if dataflow is not None:
        real_fn.dataflow = bool(dataflow)
    effective = list(graph_passes)
    if outputs is not None and "dce" not in effective:
        effective.insert(0, "dce")
    passes: List[Pass] = [BuildGraph(outputs), VerifyGraph()]
    for name in effective:
        passes.append(GRAPH_PASSES[name]())
    passes += [LowerToPoly(), VerifyPoly()]
    if dse:
        passes += [Stage1DSE(), VerifyPoly(), stage2_pass(strategy),
                   VerifyPoly()]
    if target in ("hls", "fpga") and outputs is not None:
        backend_kw.setdefault("outputs", outputs)
    passes += [BuildTaskGraph(), BuildLoopIR(), VerifyLoopIR(),
               backend_pass(target, **backend_kw)]
    ctx = PipelineContext(fn=real_fn, target=target,
                          options={"max_parallel": max_parallel, "model": model,
                                   "archive": archive})
    with telemetry.maybe_trace(trace_path):
        with telemetry.span("compile", _cat="pipeline",
                            fn=real_fn.name, target=target):
            PassManager(passes, dump=dump).run(ctx)
    return ctx.artifact


# --------------------------------------------------------------------------
# resilient compile service (crash-safe design database + serve entry point)
# --------------------------------------------------------------------------
@dataclass
class ServiceResult:
    """One served compile: the DSE outcome plus where it came from."""
    key: str                          # content address in the design db
    report: Any                      # cost_model.DesignReport
    actions: List[str]                # stage-2 action log
    tile_sizes: Dict[str, List[int]]  # per statement: unroll factor per dim
    strategy: str
    from_db: bool                     # True: served in O(lookup), no DSE run
    seconds: float


class CompileService:
    """Serve ``auto_dse`` results out of a crash-safe design database.

    A request is addressed by ``designdb.function_key`` — the
    name-canonical structure of the program plus the design-relevant
    options — so any process that compiled the same program before
    (under the same db path) serves the finished design in O(lookup):
    no graph build, no polyhedral analysis, no search.  A miss runs the
    full DSE and persists the outcome atomically; a corrupted entry is
    quarantined by the db layer and simply recomputed here.

    The ``parallel`` strategy is keyed as ``greedy``: the supervised
    pool is bit-identical to the serial ladder by invariant (asserted in
    ``tests/test_search.py``), so worker counts must not split the
    address space.  The db stores the *outcome* (report, action log,
    tile sizes) — backend artifacts are still emitted by ``compile``;
    what the service removes is the search, which is where the time is.

    Observability: every request runs under a ``service.request`` span
    and feeds live hit/miss latency histograms (p50/p99 via
    :meth:`metrics`).  ``trace_path`` opens a telemetry session for the
    service's lifetime and re-exports the (cumulative) trace after every
    request, so the file on disk is always a valid Chrome trace even if
    the process dies mid-session.
    """

    def __init__(self, db=None, path: Optional[str] = None,
                 trace_path: Optional[str] = None, **dse_defaults):
        from . import designdb
        self.db = db if db is not None else designdb.open_db(path)
        self.defaults = dse_defaults
        self.trace_path = trace_path
        if trace_path and telemetry.session() is None:
            telemetry.start_trace(trace_path)
        # live request-latency distributions, split by outcome (the db-hit
        # path is O(lookup); mixing it with misses would make p50 useless)
        self._latency = {"hit": telemetry.Histogram(),
                         "miss": telemetry.Histogram()}
        # served CUDA executors, keyed by (design key, batch size, device):
        # the db removes the search, this removes the re-lower + re-trace
        self._programs: Dict[Tuple[str, Optional[int], str], Any] = {}

    # -- request normalization ----------------------------------------------
    def _normalize(self, kw: Dict[str, Any]) -> Tuple[Dict, Dict]:
        """Split a request into ``auto_dse`` kwargs and the option dict
        that participates in the content address (everything that changes
        the produced design; nothing that only changes how fast it is
        produced)."""
        from .cost_model import XC7Z020
        from .search import resolve_strategy
        merged = dict(self.defaults)
        merged.update(kw)
        strat = resolve_strategy(merged.get("strategy"),
                                 beam_width=merged.get("beam_width"),
                                 workers=merged.get("workers"))
        desc = strat.describe()
        if desc.split(":")[0] == "parallel":
            desc = "greedy"
        elif "parallel" in desc.split(":"):
            # a pooled beam ("beam:8:parallel") produces bit-identical
            # designs to the serial beam — the pool changes wall-clock
            # only, so it must not change the content address
            desc = ":".join(t for t in desc.split(":") if t != "parallel")
        resources = merged.get("resources", XC7Z020)
        opts = {"strategy": desc,
                "max_parallel": merged.get("max_parallel", 256),
                "resources": tuple(sorted(resources.items())),
                "dataflow": merged.get("dataflow"),
                "graph_passes": tuple(merged.get("graph_passes", ())),
                "outputs": (tuple(merged["outputs"])
                            if merged.get("outputs") else None)}
        return merged, opts

    # -- serving -------------------------------------------------------------
    def compile_one(self, f, **kw) -> ServiceResult:
        """Serve one function: db hit → the stored outcome (the input
        function is left unscheduled); miss → full ``auto_dse`` + store."""
        with telemetry.span("service.request", _cat="service") as sp:
            res = self._compile_one(f, **kw)
            sp.add(key=res.key[:12], from_db=res.from_db,
                   strategy=res.strategy, seconds=res.seconds)
        kind = "hit" if res.from_db else "miss"
        self._latency[kind].observe(res.seconds)
        telemetry.REGISTRY.histogram(f"service.{kind}_seconds") \
            .observe(res.seconds)
        telemetry.REGISTRY.counter(f"service.requests_{kind}").inc()
        if self.trace_path:
            telemetry.export_trace()
        return res

    def _compile_one(self, f, **kw) -> ServiceResult:
        import time
        from . import designdb
        from .ir import Function
        fn = f if isinstance(f, Function) else f.fn
        merged, opts = self._normalize(kw)
        key = designdb.function_key(fn, opts)
        t0 = time.perf_counter()
        payload = self.db.get(key)
        if payload is not None:
            return ServiceResult(
                key, designdb.report_from_json(payload["report"]),
                list(payload["actions"]),
                {k: list(v) for k, v in payload["tile_sizes"].items()},
                payload["strategy"], True, time.perf_counter() - t0)
        from .dse import auto_dse
        res = auto_dse(fn, **{k: v for k, v in merged.items()
                              if k in ("target", "max_parallel", "resources",
                                       "model", "strategy", "beam_width",
                                       "workers", "archive", "graph_passes",
                                       "outputs", "dataflow")})
        payload = {"report": designdb.report_to_json(res.report),
                   "actions": list(res.actions),
                   "tile_sizes": {k: list(v)
                                  for k, v in res.tile_sizes.items()},
                   "strategy": res.strategy,
                   "dse_seconds": res.dse_seconds}
        self.db.put(key, payload)
        if res.archive is not None:
            self.db.store_archive(key, res.archive)
        return ServiceResult(key, res.report, list(res.actions),
                             {k: list(v) for k, v in res.tile_sizes.items()},
                             res.strategy, False, time.perf_counter() - t0)

    def compile_many(self, fns: Sequence, **kw) -> List[ServiceResult]:
        """Serve a batch of functions through the db (replay traffic)."""
        return [self.compile_one(f, **kw) for f in fns]

    def cuda_runner(self, f, batch_size: Optional[int] = None, device=None,
                    **kw):
        """Serve an *executable*: the DSE outcome via :meth:`compile_one`
        (db hit → O(lookup)), then the function lowered to the CUDA
        serving path — ``batch_size=None`` returns the whole-program
        single-invocation executor, an int the ``batched(B)`` one.
        Executors are cached per (design key, batch size, device), so
        repeat traffic for the same program re-uses the lowered program.

        The ``parallel`` and ``beam:k:parallel`` strategies fork worker
        processes, which must never touch CUDA: run such a DSE before the
        process's first CUDA call, or use a serial strategy."""
        from .. import resolve_device
        dev = resolve_device(device)
        res = self.compile_one(f, **kw)
        ck = (res.key, batch_size, str(dev))
        runner = self._programs.get(ck)
        if runner is None:
            from .ir import Function
            fn = f if isinstance(f, Function) else f.fn
            program = compile(fn, target="cuda", device=dev,
                              dataflow=kw.get("dataflow"),
                              outputs=kw.get("outputs"))
            runner = (program.jitted() if batch_size is None
                      else program.batched(batch_size))
            self._programs[ck] = runner
        return runner

    @property
    def stats(self):
        """The underlying db's hit/miss/write/quarantine counters."""
        return self.db.stats

    def metrics(self) -> Dict[str, Any]:
        """Live service metrics: db counters plus per-request latency
        distributions (count/sum/min/max/p50/p99, split hit vs miss) —
        maintained on every request, snapshot-cheap."""
        s = self.db.stats
        return {"db": {"hits": s.hits, "misses": s.misses,
                       "writes": s.writes, "quarantined": s.quarantined},
                "requests": {kind: h.to_json()
                             for kind, h in self._latency.items()}}


def serve(db=None, path: Optional[str] = None,
          trace_path: Optional[str] = None, **dse_defaults
          ) -> CompileService:
    """Open the compile service: ``pom.serve()`` (the ROADMAP's
    many-users entry point).  ``path`` (or ``POM_DESIGN_DB``) selects the
    persistent database; with neither set the service is a per-process
    memo — same API, no disk.  ``trace_path`` traces the whole service
    session (re-exported after every request)."""
    return CompileService(db=db, path=path, trace_path=trace_path,
                          **dse_defaults)


def compile_many(fns: Sequence, service: Optional[CompileService] = None,
                 **kw) -> List[ServiceResult]:
    """One-shot batch compile through a (new or given) service."""
    svc = service if service is not None else serve()
    return svc.compile_many(fns, **kw)
