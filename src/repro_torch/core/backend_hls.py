"""HLS C backend: annotated loop IR -> synthesizable HLS C with pragmas.

The faithful output artifact of the paper (SS V-C: 'the optimized and
annotated affine dialect is translated into synthesizable HLS code').
Array-partition pragmas come from placeholder annotations; pipeline/unroll
pragmas from ForNode attributes.

Task-level pipelining: when the loop IR carries a ``DataflowRegion`` (see
``astbuild.build_ast`` / ``graph_ir.analyze_task_graph``), the function
body is emitted as a ``#pragma HLS dataflow`` region.  Channel arrays that
are not externally observable (``outputs``) become function-local buffers,
annotated ``#pragma HLS stream type=fifo depth=N`` when the streaming
analysis proved the consumer reads in write order, and ``type=pipo`` for
ping-pong chunk buffers; non-streamable hand-offs are left as plain
buffers (a sequential edge inside the region).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from . import telemetry
from .affine import Bound, LinExpr
from .ir import (BinOp, Call, Const, Expr, Function, IterVal, Load,
                 Placeholder, loads_of)
from .loop_ir import (Channel, DataflowRegion, ForNode, IfNode, LoopBound,
                      Node, ProgramAST, ScanRegion, StmtNode, TaskNode)


def _c_lin(e: LinExpr) -> str:
    parts = []
    for k in sorted(e.coeffs):
        v = e.coeffs[k]
        if v == 1:
            parts.append(k)
        elif v == -1:
            parts.append(f"-{k}")
        else:
            parts.append(f"{v}*{k}")
    if e.const or not parts:
        parts.append(str(e.const))
    s = " + ".join(parts).replace("+ -", "- ")
    return s


def _c_bound(lb: LoopBound) -> str:
    terms = []
    for b in lb.bounds:
        if b.div == 1:
            terms.append(_c_lin(b.expr))
        elif lb.is_lower:
            # ceil division for non-negative divisor
            terms.append(f"(({_c_lin(b.expr)}) + {b.div - 1}) / {b.div}")
        else:
            terms.append(f"({_c_lin(b.expr)}) / {b.div}")
    if len(terms) == 1:
        return terms[0]
    fn = "MAX" if lb.is_lower else "MIN"
    out = terms[0]
    for t in terms[1:]:
        out = f"{fn}({out}, {t})"
    return out


def _float_suffix(fn: Function) -> str:
    """``f`` when every float placeholder is single-precision: bare float
    literals are C doubles, which silently force double-precision operator
    cores in a pure fp32 design."""
    for ph in fn.placeholders.values():
        if ph.dtype.is_float and ph.dtype.name == "p_float64":
            return ""
    return "f"


def _c_expr(e: Expr, subst, fsuf: str = "") -> str:
    if isinstance(e, Const):
        v = e.value
        if float(v).is_integer():
            return str(int(v))
        return f"{v!r}{fsuf}"
    if isinstance(e, IterVal):
        return f"({_c_lin(subst(e.expr))})"
    if isinstance(e, Load):
        idx = "".join(f"[{_c_lin(subst(ix))}]" for ix in e.idx)
        return f"{e.array.name}{idx}"
    if isinstance(e, BinOp):
        return f"({_c_expr(e.lhs, subst, fsuf)} {e.op} {_c_expr(e.rhs, subst, fsuf)})"
    if isinstance(e, Call):
        args = ", ".join(_c_expr(a, subst, fsuf) for a in e.args)
        fn = {"max": "fmax", "min": "fmin", "abs": "fabs"}.get(e.fn, e.fn)
        return f"{fn}({args})"
    raise TypeError(e)


def _find_region(ast: ProgramAST) -> Optional[DataflowRegion]:
    for n in ast.body:
        if isinstance(n, DataflowRegion):
            return n
    return None


def emit_hls(fn: Function, ast: ProgramAST, top_name: Optional[str] = None,
             outputs: Optional[Sequence[str]] = None) -> str:
    """Emit synthesizable HLS C for ``fn``'s loop IR.

    ``outputs`` names the externally observable arrays; inter-task channel
    arrays outside it become function-local stream/PIPO buffers.  Without
    it every array stays a top-level argument (conservative)."""
    with telemetry.span("backend.lower", _cat="backend", backend="hls",
                        fn=fn.name) as sp:
        text = _emit_hls_impl(fn, ast, top_name, outputs)
        sp.add(chars=len(text))
    return text


def _emit_hls_impl(fn: Function, ast: ProgramAST,
                   top_name: Optional[str] = None,
                   outputs: Optional[Sequence[str]] = None) -> str:
    top = top_name or fn.name
    region = _find_region(ast)
    fsuf = _float_suffix(fn)
    internal: Set[str] = set()
    if region is not None and outputs is not None:
        outs = set(outputs)
        # an accumulator channel (its writer reads its own partial sums)
        # relies on the caller zero-filling the buffer per invocation —
        # localizing it as a `static` array would carry partial sums
        # across calls, so only pure write-once producers are localized
        accumulated = {ld.array.name
                       for s in fn.statements
                       for ld in loads_of(s.body)
                       if ld.array.name == s.store.array.name}
        internal = {ch.array for ch in region.channels
                    if ch.array not in outs and ch.array not in accumulated}
    lines: List[str] = []
    args = []
    for ph in fn.placeholders.values():
        if ph.name in internal:
            continue
        dims = "".join(f"[{d}]" for d in ph.shape)
        args.append(f"{ph.dtype.c_name} {ph.name}{dims}")
    lines.append("#include <math.h>")
    if region is not None and any(ch.kind == "fifo" for ch in region.channels):
        lines.append("#include <hls_stream.h>")
    lines.append("#define MAX(a,b) ((a)>(b)?(a):(b))")
    lines.append("#define MIN(a,b) ((a)<(b)?(a):(b))")
    lines.append("")
    lines.append(f"void {top}({', '.join(args)}) {{")
    for name in sorted(internal):
        ph = fn.placeholders[name]
        dims = "".join(f"[{d}]" for d in ph.shape)
        lines.append(f"  static {ph.dtype.c_name} {name}{dims};")
    for ph in fn.placeholders.values():
        for dim, (factor, kind) in sorted(ph.partitions.items()):
            lines.append(f"#pragma HLS array_partition variable={ph.name} "
                         f"{kind} factor={factor} dim={dim + 1}")

    def emit_channels(chs: List[Channel], ind: int):
        pad = "  " * ind
        for ch in chs:
            if ch.kind == "seq":
                lines.append(f"{pad}// channel {ch.array}: {ch.producer} -> "
                             f"{ch.consumer} (sequential hand-off, not "
                             f"streamable)")
            elif ch.array in internal:
                lines.append(f"{pad}#pragma HLS stream variable={ch.array} "
                             f"type={ch.kind} depth={ch.depth}")
            else:
                # stream pragmas only apply to local arrays; an external
                # (interface) channel keeps its default hand-off
                lines.append(f"{pad}// channel {ch.array}: {ch.producer} -> "
                             f"{ch.consumer} kind={ch.kind} "
                             f"depth={ch.depth} (external array: "
                             f"stream pragma elided)")

    def emit(n: Node, ind: int):
        pad = "  " * ind
        if isinstance(n, ProgramAST):
            for c in n.body:
                emit(c, ind)
        elif isinstance(n, DataflowRegion):
            lines.append(f"{pad}#pragma HLS dataflow")
            emit_channels(n.channels, ind)
            for c in n.body:
                emit(c, ind)
        elif isinstance(n, TaskNode):
            lines.append(f"{pad}// dataflow task: {n.name}")
            for c in n.body:
                emit(c, ind)
        elif isinstance(n, ScanRegion):
            carry = (f", carry {n.carry_in} -> {n.carry_out}"
                     if n.carry_in else "")
            lines.append(f"{pad}// scan region: {n.n} isomorphic blocks x "
                         f"{n.template_len} nests{carry} (compiled once + "
                         f"scanned on the Pallas serving path)")
            for c in n.body:
                emit(c, ind)
        elif isinstance(n, ForNode):
            lo, hi = _c_bound(n.lo), _c_bound(n.hi)
            lines.append(f"{pad}for (int {n.var} = {lo}; {n.var} <= {hi}; ++{n.var}) {{")
            if n.pipeline_ii is not None:
                lines.append(f"{pad}#pragma HLS pipeline II={n.pipeline_ii}")
            if n.unroll is not None:
                lines.append(f"{pad}#pragma HLS unroll factor={n.unroll}")
            for c in n.body:
                emit(c, ind + 1)
            lines.append(f"{pad}}}")
        elif isinstance(n, IfNode):
            conds = " && ".join(
                f"({_c_lin(c.expr)} {'==' if c.is_eq else '>='} 0)" for c in n.conds)
            lines.append(f"{pad}if ({conds}) {{")
            for c in n.body:
                emit(c, ind + 1)
            lines.append(f"{pad}}}")
        elif isinstance(n, StmtNode):
            s = n.stmt

            def subst(e: LinExpr) -> LinExpr:
                # original iters -> current dims -> loop vars
                cur = s.subst_lin(e)
                return cur.rename(n.dim_map)

            arr, _ = s.store_access()
            idx = "".join(f"[{_c_lin(subst(ix))}]" for ix in s.store.idx)
            lines.append(f"{pad}{arr.name}{idx} = {_c_expr(s.body, subst, fsuf)};"
                         f"  // {s.name}")
        else:
            raise TypeError(n)

    emit(ast, 1)
    lines.append("}")
    return "\n".join(lines) + "\n"
