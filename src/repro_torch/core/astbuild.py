"""Polyhedral AST build (paper SS V-B 'Construction of the polyhedral IR',
step 3: union map -> ast_build -> for/if/block/user nodes).

Statements are grouped by their ``after`` fusion spec; each group shares
loops up to the declared level.  Loop bounds per level are derived from each
statement's (possibly non-rectangular) domain with Fourier-Motzkin
projection; shared loops take the union (min/max) of member bounds, and
statements whose own bounds are strictly tighter are guarded with IfNodes --
the same strategy isl's ast_build uses.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .affine import Bound, Constraint, LinExpr, ge, le
from .ir import Function, Statement
from .loop_ir import (Channel, DataflowRegion, ForNode, IfNode, LoopBound,
                      Node, ProgramAST, StmtNode, TaskNode)


def _program_order(fn: Function) -> List[Statement]:
    """Registration order, but `after` targets pull their statement adjacent.

    A placed statement's `after` children form a consecutive run right
    behind it; a new child is inserted at the end of that run.  The order
    is kept as a linked list with a per-target insertion-point memo, so
    placement is O(1) amortized instead of the old ``order.index`` +
    ``list.insert`` pair (quadratic on wide functions).
    """
    nxt: Dict[int, Optional[Statement]] = {}
    placed: set = set()
    first: List[Optional[Statement]] = [None]
    last: List[Optional[Statement]] = [None]
    # target uid -> node after which its next `after` child is inserted
    # (the end of the target's consecutive child run); dropped whenever an
    # insertion for a different target lands inside that run.
    ins: Dict[int, Statement] = {}

    def run_end(target: Statement) -> Statement:
        p = ins.get(target.uid)
        if p is not None:
            return p
        p = target
        while True:
            q = nxt[p.uid]
            if q is None or q.after_spec is None or q.after_spec[0] is not target:
                return p
            p = q

    def place(s: Statement) -> None:
        if s.uid in placed:
            return
        placed.add(s.uid)
        if s.after_spec is None:
            if last[0] is None:
                first[0] = s
            else:
                nxt[last[0].uid] = s
            nxt[s.uid] = None
            last[0] = s
            return
        target = s.after_spec[0]
        place(target)
        p = run_end(target)
        q = nxt[p.uid]
        nxt[s.uid] = q
        nxt[p.uid] = s
        ins[target.uid] = s
        if q is None:
            last[0] = s
        elif q.after_spec is not None and q.after_spec[0] is not target:
            # s broke the consecutive child run of q's target at p
            ins.pop(q.after_spec[0].uid, None)

    for s in fn.statements:
        place(s)
    order: List[Statement] = []
    node = first[0]
    while node is not None:
        order.append(node)
        node = nxt[node.uid]
    return order


def _share_with_prev(order: List[Statement]) -> List[int]:
    """#loops statement i shares with statement i-1 (0 for i=0)."""
    share = [0] * len(order)
    for i in range(1, len(order)):
        s = order[i]
        if s.after_spec is not None:
            target, lvl = s.after_spec
            # shared levels apply if the target is anywhere earlier in the
            # current run; we conservatively require adjacency in order.
            if target is order[i - 1] or _in_same_run(order, i, target, share):
                share[i] = lvl + 1
    return share


def _in_same_run(order, i, target, share) -> bool:
    j = i - 1
    while j >= 0:
        if order[j] is target:
            return True
        if share[j] == 0:
            return False
        j -= 1
    return False


def build_ast(fn: Function, dataflow: Optional[bool] = None,
              scan: Optional[bool] = None) -> ProgramAST:
    """Build the annotated loop IR of ``fn``.

    With dataflow enabled (``dataflow=True``, or None + an effective
    per-function/environment toggle — see ``graph_ir.dataflow_effective``)
    and the function forming an eligible streaming task graph of >= 2
    tasks, the top-level loop nests are wrapped into ``TaskNode``s inside
    a ``DataflowRegion`` carrying the classified channels.  The region is
    annotation-only: its task bodies are exactly the nodes a sequential
    build produces, in the same order.

    With scan enabled (``scan=True``, or None + ``POM_PALLAS_SCAN`` unset
    or truthy) runs of isomorphic task blocks detected by
    ``graph_ir.detect_scan_chains`` are wrapped into ``ScanRegion`` nodes
    — also annotation-only: every unrolled node is kept inside the region
    in program order, so backends that ignore the annotation execute the
    exact sequential schedule.
    """
    order = _program_order(fn)
    share = _share_with_prev(order)
    used_names: set = set()
    body = _build_level(order, share, 0, {}, [], used_names)
    from .graph_ir import dataflow_effective, scan_default
    effective = dataflow_effective(fn) if dataflow is None else dataflow
    scan_on = scan_default() if scan is None else scan
    region = _dataflow_region(fn, body) if effective else None
    if region is not None:
        if scan_on:
            region.body = _wrap_scan(fn, region.body)
        body = [region]
    elif scan_on:
        body = _wrap_scan(fn, body)
    return ProgramAST(body)


def _wrap_scan(fn: Function, nodes: List[Node]) -> List[Node]:
    """Replace each detected chain's node span with a ``ScanRegion``.

    ``nodes`` must be 1:1 with the fusion task list (one top-level nest or
    ``TaskNode`` per task) — when grouping diverged, the AST is returned
    unchanged rather than guessed at.
    """
    from .graph_ir import detect_scan_chains, fusion_tasks
    from .loop_ir import ScanRegion
    chains = detect_scan_chains(fn)
    if not chains or len(nodes) != len(fusion_tasks(fn)):
        return nodes
    out = list(nodes)
    for c in sorted(chains, key=lambda ch: ch.start, reverse=True):
        span = c.n * c.period
        out[c.start:c.start + span] = [ScanRegion(
            out[c.start:c.start + span], c.n, c.period,
            c.carry_in, c.carry_out,
            dict(c.reads), {k: v for k, v in c.writes})]
    return out


def _dataflow_region(fn: Function, body: List[Node]) -> Optional[DataflowRegion]:
    """Wrap the top-level nodes into a DataflowRegion when the function's
    task graph is streaming-eligible; None keeps the sequential AST."""
    from .graph_ir import analyze_task_graph
    info = analyze_task_graph(fn)
    if not info.eligible or len(info.tasks) < 2:
        return None
    if len(body) != len(info.tasks):       # grouping mismatch: stay flat
        return None
    tasks = [TaskNode(grp[0].name, [node])
             for grp, node in zip(info.tasks, body)]
    channels = [Channel(ch.array, ch.producer, ch.consumer, ch.kind,
                        ch.depth, ch.chunks, ch.bits)
                for ch in info.channels]
    return DataflowRegion(tasks, channels)


def _build_level(stmts: List[Statement], share: List[int], depth: int,
                 dim_maps: Dict[int, Dict[str, str]], outer_vars: List[str],
                 used_names: set) -> List[Node]:
    """Build nodes for ``stmts`` whose loops [0..depth-1] are already open."""
    nodes: List[Node] = []
    i = 0
    while i < len(stmts):
        j = i + 1
        while j < len(stmts) and share[j] > depth:
            j += 1
        group = stmts[i:j]
        gshare = list(share[i:j])
        gshare[0] = 0
        if len(group) == 1 and len(group[0].dims) <= depth:
            nodes.append(_make_stmt_node(group[0], dim_maps.get(group[0].uid, {}),
                                         outer_vars))
        else:
            assert all(len(s.dims) > depth for s in group), \
                f"statement exhausted its loops but shares depth {depth}"
            nodes.append(_make_loop(group, gshare, depth, dim_maps, outer_vars,
                                    used_names))
        i = j
    return nodes


def _make_loop(group: List[Statement], share: List[int], depth: int,
               dim_maps: Dict[int, Dict[str, str]], outer_vars: List[str],
               used_names: set) -> ForNode:
    # loop variable name: first statement's dim at this depth (unique-ified)
    base = group[0].dims[depth]
    lv = base
    k = 0
    while lv in used_names:
        k += 1
        lv = f"{base}_{k}"
    used_names.add(lv)

    lowers: List[Bound] = []
    uppers: List[Bound] = []
    tight: Dict[int, Tuple[List[Bound], List[Bound]]] = {}
    pipeline_ii: Optional[int] = None
    unroll: Optional[int] = None
    trips = set()
    for s in group:
        d = s.dims[depth]
        dm = dict(dim_maps.get(s.uid, {}))
        dm[d] = lv
        dim_maps[s.uid] = dm
        inner = s.dims[depth + 1:]
        los, ups = s.domain.bounds_of(d, inner)
        # rename bound expressions into loop-var space
        ren = {sd: lvn for sd, lvn in dm.items()}
        los = [Bound(b.expr.rename(ren), b.div) for b in los]
        ups = [Bound(b.expr.rename(ren), b.div) for b in ups]
        tight[s.uid] = (los, ups)
        lowers.extend(los)
        uppers.extend(ups)
        if s.pipeline_at == d:
            pipeline_ii = s.pipeline_ii if pipeline_ii is None else min(pipeline_ii, s.pipeline_ii)
        if d in s.unrolls:
            unroll = max(unroll or 0, s.unrolls[d])
        tc = s.trip_counts().get(d)
        if tc is not None:
            trips.add(tc)

    if len(group) == 1:
        lo_bounds, hi_bounds = tight[group[0].uid]
    else:
        # union bounds: keep only bounds shared by all members (sound outer
        # bound: min of lowers / max of uppers == drop non-common bounds and
        # guard members individually).
        lo_bounds = _common(
            [tight[s.uid][0] for s in group]) or _widest(tight, group, True)
        hi_bounds = _common(
            [tight[s.uid][1] for s in group]) or _widest(tight, group, False)

    node = ForNode(lv, LoopBound(lo_bounds, True), LoopBound(hi_bounds, False),
                   [], pipeline_ii, unroll,
                   trips.pop() if len(trips) == 1 and len(group) >= 1 else None)

    body = _build_level(group, share, depth + 1, dim_maps, outer_vars + [lv],
                        used_names)
    # guard members whose own bounds were dropped from the union
    guarded: List[Node] = []
    for child in body:
        stmts_in = _stmts_under(child)
        guards: List[Constraint] = []
        for s in stmts_in:
            slo, sup = tight[s.uid]
            for b in slo:
                if not _bound_in(b, lo_bounds):
                    # lv >= ceil(e/div)  ->  div*lv - e >= 0
                    guards.append(ge(LinExpr.var(node.var) * b.div, b.expr))
            for b in sup:
                if not _bound_in(b, hi_bounds):
                    guards.append(le(LinExpr.var(node.var) * b.div, b.expr))
        if guards:
            guarded.append(IfNode(_dedup(guards), [child]))
        else:
            guarded.append(child)
    node.body = guarded
    return node


def _common(bound_lists: List[List[Bound]]) -> List[Bound]:
    if not bound_lists:
        return []
    keys = set((b.expr.key(), b.div) for b in bound_lists[0])
    for bl in bound_lists[1:]:
        keys &= set((b.expr.key(), b.div) for b in bl)
    return [b for b in bound_lists[0] if (b.expr.key(), b.div) in keys]


def _widest(tight, group, is_lower) -> List[Bound]:
    # fallback: constant envelope if all bounds constant, else first stmt's
    consts = []
    for s in group:
        bs = tight[s.uid][0 if is_lower else 1]
        vals = [b for b in bs if b.expr.is_const()]
        if not vals:
            return tight[group[0].uid][0 if is_lower else 1]
        from .affine import ceil_div, floor_div
        v = [ceil_div(b.expr.const, b.div) if is_lower else floor_div(b.expr.const, b.div)
             for b in vals]
        consts.append(max(v) if is_lower else min(v))
    env = min(consts) if is_lower else max(consts)
    return [Bound(LinExpr.cst(env), 1)]


def _bound_in(b: Bound, bounds: List[Bound]) -> bool:
    return any(b.expr == o.expr and b.div == o.div for o in bounds)


def _dedup(guards: List[Constraint]) -> List[Constraint]:
    out, seen = [], set()
    for g in guards:
        k = (g.expr.key(), g.is_eq)
        if k not in seen:
            seen.add(k)
            out.append(g)
    return out


def _stmts_under(node: Node) -> List[Statement]:
    from .loop_ir import walk
    return [n.stmt for n in walk(node) if isinstance(n, StmtNode)]


def _make_stmt_node(s: Statement, dim_map: Dict[str, str],
                    outer_vars: List[str]) -> StmtNode:
    return StmtNode(s, dict(dim_map))
