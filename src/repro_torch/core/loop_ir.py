"""Annotated loop IR -- the repo's analogue of 'MLIR affine dialect with HLS
attributes' (paper SS V-C).

Explicit loop trees with symbolic affine bounds (max/min of floor/ceil
divisions, exactly isl-ast style) and HLS pragma attributes attached to
``ForNode``s.  Built by ``astbuild.build_ast`` and consumed by the HLS-C,
JAX and Pallas backends plus the cost models.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .affine import Bound, Constraint, LinExpr, ceil_div, floor_div
from .ir import Statement


@dataclass
class LoopBound:
    """max_i(ceildiv(e_i, d_i)) for lowers / min_i(floordiv(e_i, d_i)) for uppers."""
    bounds: List[Bound]
    is_lower: bool

    def eval(self, env: Dict[str, int]) -> int:
        vals = []
        for b in self.bounds:
            v = b.expr.eval(env)
            vals.append(ceil_div(v, b.div) if self.is_lower else floor_div(v, b.div))
        return max(vals) if self.is_lower else min(vals)

    def is_constant(self) -> bool:
        return all(b.expr.is_const() for b in self.bounds)

    def const_value(self) -> int:
        return self.eval({})


@dataclass
class Node:
    pass


@dataclass
class ForNode(Node):
    var: str
    lo: LoopBound
    hi: LoopBound                      # inclusive upper bound
    body: List[Node] = field(default_factory=list)
    pipeline_ii: Optional[int] = None  # pragma HLS pipeline II=<n>
    unroll: Optional[int] = None       # pragma HLS unroll factor=<n>
    trip: Optional[int] = None         # constant trip count if known

    def trip_count(self) -> Optional[int]:
        if self.trip is not None:
            return self.trip
        if self.lo.is_constant() and self.hi.is_constant():
            return max(0, self.hi.const_value() - self.lo.const_value() + 1)
        return None


@dataclass
class IfNode(Node):
    conds: List[Constraint]
    body: List[Node] = field(default_factory=list)


@dataclass
class StmtNode(Node):
    stmt: Statement
    # statement current-dim name -> loop variable name in the AST
    dim_map: Dict[str, str] = field(default_factory=dict)

    def cur_env(self, env: Dict[str, int]) -> Dict[str, int]:
        return {d: env[lv] for d, lv in self.dim_map.items()}


@dataclass
class Channel:
    """One inter-task array channel of a dataflow region.

    ``kind`` is decided by the streaming-legality analysis
    (``graph_ir.analyze_task_graph``): ``fifo`` = in-order elementwise
    stream (``depth`` element slots), ``pipo`` = ping-pong chunk buffer
    (``depth`` chunks of the array's outer-dim blocks), ``seq`` = no
    streaming order exists — the edge only sequences the two tasks and
    declares no on-chip storage.
    """
    array: str
    producer: str              # writer statement name
    consumer: str              # reader statement name
    kind: str                  # "fifo" | "pipo" | "seq"
    depth: int
    chunks: int = 0            # pipo: producer outer-dim chunk count
    bits: float = 0.0          # on-chip channel storage


@dataclass
class TaskNode(Node):
    """One dataflow task: a full top-level loop nest (fusion group)."""
    name: str
    body: List[Node] = field(default_factory=list)


@dataclass
class DataflowRegion(Node):
    """A ``#pragma HLS dataflow`` region: tasks run as concurrent
    processes connected by ``channels``.  Semantically the region is an
    annotation — executing the tasks in order (what the JAX/Pallas
    backends do) is always a correct schedule of it."""
    body: List[Node] = field(default_factory=list)   # TaskNodes
    channels: List[Channel] = field(default_factory=list)


@dataclass
class ScanRegion(Node):
    """``n`` consecutive isomorphic task blocks (same ``op_structural_key``
    chain, e.g. repeated conv→relu layers).  ``body`` keeps ALL unrolled
    nodes — the first ``template_len`` form the template block — so every
    backend that ignores the annotation (HLS-C, JAX oracle, sequential
    Pallas) stays exactly correct by just executing ``body`` in order.
    The traced Pallas serving path compiles the template once and
    ``lax.scan``s it over the stacked per-block arrays:

      * ``carry_in``/``carry_out`` — the inter-block activation chain
        (block *i* reads what block *i-1* wrote);
      * ``reads``  — template read name -> per-block source array names
        (stacked into scan ``xs``: the per-layer weights);
      * ``writes`` — template write name -> per-block dest array names
        (scan ``ys``, scattered back after the scan).
    """
    body: List[Node] = field(default_factory=list)
    n: int = 0
    template_len: int = 0
    carry_in: Optional[str] = None
    carry_out: Optional[str] = None
    reads: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    writes: Dict[str, Tuple[str, ...]] = field(default_factory=dict)


@dataclass
class ProgramAST(Node):
    body: List[Node] = field(default_factory=list)


def walk(node: Node):
    yield node
    body = getattr(node, "body", None)
    if body:
        for ch in body:
            yield from walk(ch)


def describe(node: Node, indent: int = 0) -> str:
    """Readable dump of a loop tree (the ``POM_DUMP_IR=loops`` format)."""
    pad = "  " * indent
    if isinstance(node, ProgramAST):
        return "\n".join(describe(c, indent) for c in node.body)
    if isinstance(node, ForNode):
        attrs = []
        if node.pipeline_ii is not None:
            attrs.append(f"pipeline II={node.pipeline_ii}")
        if node.unroll is not None:
            attrs.append(f"unroll {node.unroll}")
        if node.trip is not None:
            attrs.append(f"trip {node.trip}")
        head = (f"{pad}for {node.var} in [{_b(node.lo)}, {_b(node.hi)}]"
                + (f"  # {', '.join(attrs)}" if attrs else ""))
        return "\n".join([head] + [describe(c, indent + 1) for c in node.body])
    if isinstance(node, IfNode):
        conds = " and ".join(map(repr, node.conds))
        return "\n".join([f"{pad}if {conds}:"]
                         + [describe(c, indent + 1) for c in node.body])
    if isinstance(node, StmtNode):
        dm = ", ".join(f"{k}->{v}" for k, v in node.dim_map.items())
        return f"{pad}{node.stmt.name}({dm})"
    if isinstance(node, DataflowRegion):
        lines = [f"{pad}dataflow region ({len(node.body)} tasks):"]
        for ch in node.channels:
            extra = f" chunks={ch.chunks}" if ch.kind == "pipo" else ""
            lines.append(f"{pad}  channel {ch.array}: {ch.producer} -> "
                         f"{ch.consumer}  kind={ch.kind} depth={ch.depth}"
                         f"{extra}")
        lines += [describe(c, indent + 1) for c in node.body]
        return "\n".join(lines)
    if isinstance(node, TaskNode):
        return "\n".join([f"{pad}task {node.name}:"]
                         + [describe(c, indent + 1) for c in node.body])
    if isinstance(node, ScanRegion):
        carry = (f" carry {node.carry_in}->{node.carry_out}"
                 if node.carry_in else "")
        lines = [f"{pad}scan region ({node.n} blocks x "
                 f"{node.template_len} nodes{carry}):"]
        lines += [describe(c, indent + 1)
                  for c in node.body[:node.template_len]]
        if node.n > 1:
            lines.append(f"{pad}  ... x{node.n}")
        return "\n".join(lines)
    raise TypeError(node)


def _b(lb: LoopBound) -> str:
    op = "max" if lb.is_lower else "min"
    if len(lb.bounds) == 1:
        return repr(lb.bounds[0])
    return f"{op}({', '.join(map(repr, lb.bounds))})"


def for_nodes(ast: Node) -> List[ForNode]:
    return [n for n in walk(ast) if isinstance(n, ForNode)]


def stmt_nodes(ast: Node) -> List[StmtNode]:
    return [n for n in walk(ast) if isinstance(n, StmtNode)]
