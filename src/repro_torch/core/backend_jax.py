"""Executable backend: interpret the annotated loop IR over numpy arrays.

This is the *oracle* backend -- it executes exactly the statement-instance
order the AST encodes, so tests can assert that transformed schedules compute
the same result as the untransformed program.  (Small problem sizes; the
performance path is the Pallas backend + hand kernels.)
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np

from . import telemetry
from .ir import BinOp, Call, Const, Expr, Function, IterVal, Load, Statement
from .loop_ir import (DataflowRegion, ForNode, IfNode, Node, ProgramAST,
                      ScanRegion, StmtNode, TaskNode)

_CALLS = {
    "exp": math.exp, "sqrt": math.sqrt, "abs": abs,
    "max": max, "min": min,
    "relu": lambda x: max(x, 0.0),
    "tanh": math.tanh,
}


def compile_jax(fn: Function, ast: ProgramAST) -> Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]:
    """Return f(arrays: dict name->ndarray) -> dict of updated arrays."""

    def run(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        bufs = {k: np.array(v, copy=True) for k, v in arrays.items()}
        for ph in fn.placeholders.values():
            if ph.name not in bufs:
                bufs[ph.name] = np.zeros(ph.shape, dtype=np.float64)
        env: Dict[str, int] = {}

        def eval_expr(e: Expr, cur: Dict[str, int]) -> float:
            if isinstance(e, Const):
                return e.value
            if isinstance(e, IterVal):
                return float(e.expr.eval(cur))
            if isinstance(e, Load):
                idx = tuple(ix.eval(cur) for ix in e.idx)
                return float(bufs[e.array.name][idx])
            if isinstance(e, BinOp):
                a = eval_expr(e.lhs, cur)
                b = eval_expr(e.rhs, cur)
                if e.op == "+":
                    return a + b
                if e.op == "-":
                    return a - b
                if e.op == "*":
                    return a * b
                if e.op == "/":
                    return a / b
                raise ValueError(e.op)
            if isinstance(e, Call):
                args = [eval_expr(a, cur) for a in e.args]
                return _CALLS[e.fn](*args)
            raise TypeError(e)

        def exec_stmt(sn: StmtNode):
            s = sn.stmt
            cur = {d: env[lv] for d, lv in sn.dim_map.items()}
            # compose: body/store are over original iterators -> substitute
            orig = {k: e.eval(cur) for k, e in s.iter_subst.items()}
            # accesses written over original iters; evaluate directly in orig
            val = eval_expr(s.body, orig)
            arr, _ = s.store_access()
            idx = tuple(ix.eval(orig) for ix in s.store.idx)
            bufs[arr.name][idx] = val

        def exec_node(n: Node):
            if isinstance(n, (ProgramAST, DataflowRegion, TaskNode,
                              ScanRegion)):
                # dataflow and scan regions are annotation-only: running
                # their bodies in program order is a correct schedule (a
                # scan region keeps all unrolled blocks in ``body``)
                for c in n.body:
                    exec_node(c)
            elif isinstance(n, ForNode):
                lo = n.lo.eval(env)
                hi = n.hi.eval(env)
                for v in range(lo, hi + 1):
                    env[n.var] = v
                    for c in n.body:
                        exec_node(c)
                env.pop(n.var, None)
            elif isinstance(n, IfNode):
                if all(c.holds(env) for c in n.conds):
                    for ch in n.body:
                        exec_node(ch)
            elif isinstance(n, StmtNode):
                exec_stmt(n)
            else:
                raise TypeError(n)

        # ``span`` consults the live tracer at call time, so a runner that
        # outlives the trace session simply records nothing
        with telemetry.span("backend.execute", _cat="backend",
                            backend="jax", fn=fn.name):
            exec_node(ast)
        return bufs

    return run
