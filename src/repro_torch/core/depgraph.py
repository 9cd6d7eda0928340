"""Dependence-graph IR (paper SS V-A, Fig. 8).

Coarse-grained: nodes = computes (loop nests), edges = producer->consumer
relations extracted from load/store sets; DFS collects all data paths for
the DSE engine.

Fine-grained: per node, distance/direction vectors of loop-carried
dependences (write->read, read->write, write->write on the same array),
computed exactly on the dependence polyhedron; reduction dimensions are
detected from the store access pattern (Fig. 8(3)).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .affine import DependenceInfo, dependence_vector
from .ir import Function, Statement
from .transforms import self_dependences


@dataclass
class NodeInfo:
    stmt: Statement
    deps: List[DependenceInfo] = field(default_factory=list)
    reduction_dims: List[str] = field(default_factory=list)

    def loop_carried(self) -> List[DependenceInfo]:
        return [d for d in self.deps if d.loop_carried_level is not None]

    def carried_at_innermost(self) -> List[DependenceInfo]:
        n = len(self.stmt.dims)
        return [d for d in self.loop_carried() if n in d.levels]

    def tight(self, threshold: int = 1) -> List[DependenceInfo]:
        """Tight loop-carried dependences: carried at the *innermost* level
        with small distance (paper SS II-D / SS VI-A).  Uses per-level
        dependence components: Seidel carries at t AND i AND j."""
        out = []
        n = len(self.stmt.dims)
        for d in self.loop_carried():
            dist_at = d.levels.get(n)
            if dist_at is not None:
                dist = dist_at[n - 1]
                if dist is None or dist <= threshold:
                    out.append(d)
        return out


@dataclass
class DepGraph:
    fn: Function
    nodes: Dict[int, NodeInfo] = field(default_factory=dict)
    # coarse edges: (src uid, dst uid, array name)
    edges: List[Tuple[int, int, str]] = field(default_factory=list)
    # memoized maximal paths: the coarse topology depends only on which
    # arrays each statement reads/writes, which no schedule transform ever
    # changes — so the DFS result is computed at most once per graph
    _paths_cache: Optional[List[List[int]]] = field(default=None, repr=False)

    def node(self, s: Statement) -> NodeInfo:
        return self.nodes[s.uid]

    def successors(self, uid: int) -> List[int]:
        return [d for (s, d, _) in self.edges if s == uid]

    def paths(self) -> List[List[int]]:
        """All maximal data paths via DFS (paper Fig. 8(1) step 4)."""
        from . import caching
        if caching.ENABLED and self._paths_cache is not None:
            return self._paths_cache
        indeg = {u: 0 for u in self.nodes}
        for (_, d, _) in self.edges:
            indeg[d] = indeg.get(d, 0) + 1
        roots = [u for u, c in indeg.items() if c == 0] or list(self.nodes)
        out: List[List[int]] = []

        def dfs(u: int, path: List[int], seen: Set[int]):
            succ = [v for v in self.successors(u) if v not in seen]
            if not succ:
                out.append(list(path))
                return
            for v in succ:
                path.append(v)
                seen.add(v)
                dfs(v, path, seen)
                seen.discard(v)
                path.pop()

        for r in roots:
            dfs(r, [r], {r})
        self._paths_cache = out
        return out


def build_depgraph(fn: Function) -> DepGraph:
    g = DepGraph(fn)
    # coarse-grained: store -> later loads of the same array (Fig. 8(1))
    writes: Dict[str, List[Statement]] = {}
    for s in fn.statements:
        arr, _ = s.store_access()
        # reads from earlier writers
        for ld, _ in s.load_accesses():
            for w in writes.get(ld.name, []):
                if (w.uid, s.uid, ld.name) not in g.edges and w.uid != s.uid:
                    g.edges.append((w.uid, s.uid, ld.name))
        writes.setdefault(arr.name, []).append(s)
    # fine-grained per node (Fig. 8(3))
    for s in fn.statements:
        info = NodeInfo(s, self_dependences(s), s.reduction_dims())
        g.nodes[s.uid] = info
    return g


def cross_dependence(src: Statement, dst: Statement,
                     shared_levels: Optional[int] = None) -> List[DependenceInfo]:
    """Dependences between two statements (for fusion legality / `after`)."""
    out = []
    w_s, wi_s = src.store_access()
    w_d, wi_d = dst.store_access()
    for arr, idx in dst.load_accesses():
        if arr.name == w_s.name:
            info = dependence_vector(src.domain, list(wi_s), dst.domain, list(idx),
                                     shared_levels=shared_levels)
            if info.exists:
                out.append(info)
    if w_s.name == w_d.name:
        info = dependence_vector(src.domain, list(wi_s), dst.domain, list(wi_d),
                                 shared_levels=shared_levels)
        if info.exists:
            out.append(info)
    for arr, idx in src.load_accesses():
        if arr.name == w_d.name:
            info = dependence_vector(src.domain, list(idx), dst.domain, list(wi_d),
                                     shared_levels=shared_levels)
            if info.exists:
                out.append(info)
    return out
