"""The program's own spans in a profile: busy device time by phase of the
train step and by layer, and idle time by span.

``repro_torch.core.telemetry.span`` opens a ``record_function`` range while
``torch.profiler`` records, so the program's ``repro.*`` spans sit in the
profiler's trace beside the device work they launched.  ``attribute`` puts
each kernel down to them from the profiler's raw events
(``prof.profiler.kineto_results.events()``):

* a kernel belongs to the innermost host range that launched it, on
  whatever thread (the profiler links each kernel to the innermost op open
  at its launch);
* its phase is the ``repro.train.*`` range that holds the launch in time;
* a ``repro.block`` inside the backward is the remat's recompute;
* a kernel of the backward belongs to the span of the forward op its
  autograd node differentiates: the node carries that op's sequence number
  and thread (a ``CopySlices`` node the number after its op's own).

No kernel is matched by name.  ``summary`` gives the numbers a reader of a
traced window would report.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from perfbench.lib.trace import STEP, WINDOW, _host_at, _union

PROGRAM = "repro."                          # the program's span names
PHASE = "repro.train."                      # + forward, backward, optimizer
BLOCK = "repro.block"
LAYERS = {"attention": "repro.attention", "moe_dispatch": "repro.moe.dispatch",
          "moe_experts": "repro.moe.experts", "moe_combine": "repro.moe.combine",
          "loss": "repro.loss"}
BACKWARD_FUNCTION = 1                       # the profiler's RecordScope of an autograd node
NO_HOST_OP = "(no host op)"                 # lib.trace._host_at's name where none is open


@dataclass(frozen=True)
class Kernel:
    """One kernel, put down to the program's spans: its interval (ns,
    clipped to the window), its name, the phase of the step that launched
    it (None outside the phases), its part (the phase, or ``recompute``),
    and its innermost span."""
    start: int
    end: int
    name: str
    phase: Optional[str]
    part: Optional[str]
    span: Optional[str]


@dataclass
class ProgramSpans:
    """What the program's spans say of a profile.  ``busy_s`` holds busy
    device seconds (the union of the kernels' intervals) by group:
    ``phase:<forward|backward|optimizer>``, ``phase:recompute`` (the part of
    the backward in re-run blocks), ``step`` (every kernel launched in a
    phase), and ``span:<name>`` by the kernel's innermost span (a backward
    kernel's that of the forward op it differentiates; one in no narrower
    span is the phase's own, e.g. ``span:repro.train.backward``).
    ``idle_s``: the device's idle seconds by the innermost program span open
    where no aten op is.  ``nodes`` counts the autograd nodes run,
    ``nodes_attributed`` those put down to a span."""
    names: Set[str]
    busy_s: Dict[str, float]
    idle_s: Dict[str, float]
    nodes: int
    nodes_attributed: int


def attribute(raw, on_cpu: bool = False) -> Tuple[Set[str], List[Kernel], int, int, list]:
    """(the program spans recorded, the kernels, the autograd nodes run,
    those put down to a span, the host ops as (start, end, name) sorted by
    start) from the profiler's raw events; the module docstring says how.
    A run on the CPU (``on_cpu``) launches no kernel: each outermost aten op
    stands for one there.  Raises where a run on the card recorded no
    device activity, rather than read host time as the device's."""
    from torch.autograd import DeviceType

    ops, launched = [], []                  # host ops; (start, end, name, launching op's id)
    w0 = w1 = None
    for k in raw:
        if getattr(k, "is_hidden_event", lambda: False)():     # as the profiler's own events
            continue
        if k.device_type() == DeviceType.CPU:
            if k.linked_correlation_id() == 0:          # an op or range, not a runtime call
                ops.append(k)
                if k.name() == WINDOW:
                    w0, w1 = k.start_ns(), k.end_ns()
        elif not k.is_user_annotation():
            launched.append((k.start_ns(), k.end_ns(), k.name(), k.linked_correlation_id()))
    names = {k.name() for k in ops if k.name().startswith(PROGRAM)}
    by_id = {k.correlation_id(): i for i, k in enumerate(ops)}
    name = [k.name() for k in ops]
    start = [k.start_ns() for k in ops]
    end = [k.end_ns() for k in ops]
    thread = [k.start_thread_id() for k in ops]
    seq = [k.sequence_nr() for k in ops]
    fwd = [k.fwd_thread_id() for k in ops]
    # each op's parent: the innermost op of its thread that encloses it
    parent: List[Optional[int]] = [None] * len(ops)
    stacks: Dict[int, List[int]] = {}
    for i in sorted(range(len(ops)), key=lambda i: (start[i], -end[i])):
        st = stacks.setdefault(thread[i], [])
        while st and end[st[-1]] <= start[i]:
            st.pop()
        if st:
            parent[i] = st[-1]
        st.append(i)
    if not launched and not on_cpu:
        raise RuntimeError("the profile holds no device activity; a run on the CPU "
                           "asks for its aten ops to stand for kernels with on_cpu")
    if on_cpu:
        aten = [n.startswith("aten::") for n in name]
        launched = [(start[i], end[i], name[i], ops[i].correlation_id()) for i in range(len(ops))
                    if aten[i] and (parent[i] is None or not aten[parent[i]])]
    node = [seq[i] >= 0 and fwd[i] > 0 for i in range(len(ops))]     # an autograd node's range
    forward_op: Dict[Tuple[int, int], int] = {}         # (seq, thread) -> its latest forward op
    for i in sorted(range(len(ops)), key=lambda i: start[i]):
        if seq[i] >= 0 and not node[i]:
            forward_op[(seq[i], thread[i])] = i
    numbers: Dict[int, List[int]] = {}                  # thread -> its forward ops' numbers
    for n, t in sorted(forward_op):
        numbers.setdefault(t, []).append(n)

    def differentiated(i: int) -> Optional[int]:
        """The forward op that node i differentiates: the latest with the
        node's number on the node's forward thread, or with the number
        below it (an in-place op on a view takes the number after its own
        node's for the ``CopySlices`` around it)."""
        ns = numbers.get(fwd[i], [])
        j = bisect.bisect_right(ns, seq[i]) - 1
        return forward_op[(ns[j], fwd[i])] if j >= 0 else None

    def owner(i: Optional[int]) -> Tuple[Optional[int], bool]:
        """(the innermost program span over op i, whether found through a
        node); the span None where there is none."""
        while i is not None:
            if name[i].startswith(PROGRAM):
                return i, False
            if node[i]:
                return owner(differentiated(i))[0], True
            i = parent[i]
        return None, False

    def in_block(i: Optional[int]) -> bool:
        while i is not None and not node[i]:
            if name[i] == BLOCK:
                return True
            i = parent[i]
        return False

    phases = sorted((start[i], end[i], name[i][len(PHASE):]) for i in range(len(ops))
                    if name[i].startswith(PHASE))
    phase_starts = [p[0] for p in phases]

    def place(i: int) -> Tuple[Optional[str], Optional[str], Optional[str]]:
        j = bisect.bisect_right(phase_starts, start[i]) - 1
        phase = phases[j][2] if j >= 0 and phases[j][1] >= start[i] else None
        span, via_node = owner(i)
        part = "recompute" if phase == "backward" and span is not None and not via_node \
            and in_block(span) else phase
        span_name = name[span] if span is not None else None
        if phase and (span_name is None or span_name.startswith(PHASE)):
            span_name = PHASE + phase           # in the phase, in no narrower span
        return phase, part, span_name

    kernels: List[Kernel] = []
    memo: Dict[int, Tuple[Optional[str], Optional[str], Optional[str]]] = {}
    for s0, s1, kname, link in launched:
        if w0 is not None:
            s0, s1 = max(s0, w0), min(s1, w1)
            if s1 <= s0:
                continue
        i = by_id.get(link)
        if i is None:
            kernels.append(Kernel(s0, s1, kname, None, None, None))
            continue
        if i not in memo:
            memo[i] = place(i)
        kernels.append(Kernel(s0, s1, kname, *memo[i]))
    nodes = [i for i in range(len(ops)) if ops[i].scope() == BACKWARD_FUNCTION]
    attributed = sum(1 for i in nodes if seq[i] >= 0 and owner(differentiated(i))[0] is not None)
    hosts = sorted((start[i], end[i], name[i]) for i in range(len(ops))
                   if name[i] not in (WINDOW, STEP))
    return names, kernels, len(nodes), attributed, hosts


def program_spans(raw, on_cpu: bool = False) -> Optional[ProgramSpans]:
    """The busy and idle device seconds of ``attribute``'s kernels by group
    (see ``ProgramSpans``); None where the profile recorded no program
    span (a program without them)."""
    names, kernels, nodes, attributed, hosts = attribute(raw, on_cpu)
    if not names:
        return None
    groups: Dict[str, List[Tuple[int, int]]] = {}
    for k in kernels:
        if k.phase is None:
            continue
        keys = ("step", f"phase:{k.phase}", f"span:{k.span}")
        if k.part == "recompute":
            keys += ("phase:recompute",)
        for g in keys:
            groups.setdefault(g, []).append((k.start, k.end))
    busy = {g: 1e-9 * sum(e - s for s, e in _union(iv)) for g, iv in groups.items()}
    idle = idle_by_span(_union([(k.start, k.end) for k in kernels]), hosts)
    return ProgramSpans(names=names, busy_s=busy, idle_s=idle, nodes=nodes,
                        nodes_attributed=attributed)


def idle_by_span(busy: List[Tuple[int, int]], hosts: list) -> Dict[str, float]:
    """Idle seconds between the device's merged ``busy`` intervals (ns),
    each gap named by the innermost host op open at its start, or, where
    that is no aten op, by the innermost program span open there."""
    starts = [h[0] for h in hosts]
    prog = [h for h in hosts if h[2].startswith(PROGRAM)]
    prog_starts = [h[0] for h in prog]
    idle: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        key = _host_at(hosts, starts, e0)
        if not key.startswith("aten::"):
            span = _host_at(prog, prog_starts, e0)
            key = key if span == NO_HOST_OP else span
        idle[key] = idle.get(key, 0.0) + 1e-9 * (s1 - e0)
    return idle


def busy_ms(p: ProgramSpans, steps: int, group: str, span: str) -> float:
    """Busy device ms a step of one group of ``p.busy_s``; raises where the
    profile recorded program spans but not ``span``, which the group needs
    (a renamed or lost span)."""
    if span not in p.names:
        raise KeyError(f"the profile holds no program span {span!r}; it has {sorted(p.names)}")
    return 1e3 * p.busy_s.get(group, 0.0) / steps


def summary(p: ProgramSpans, steps: int, counters: Dict[str, int]) -> Dict[str, float]:
    """The per-layer numbers of a traced window of ``steps`` train steps:
    ``step_phase_ms.<phase>`` (busy ms a step of each phase, and of the
    recompute), ``layer_ms.<layer>`` (the layer's forward, recompute and
    attributed backward), ``span_coverage`` (the share of the steps' busy
    time the layers and the optimizer own, %) and, from the program's
    counters counted in the window, ``expert_rows_filled`` (%)."""
    out = {}
    for phase in ("forward", "backward", "recompute", "optimizer"):
        span = BLOCK if phase == "recompute" else PHASE + phase
        out[f"step_phase_ms.{phase}"] = busy_ms(p, steps, f"phase:{phase}", span)
    for layer, span in LAYERS.items():
        out[f"layer_ms.{layer}"] = busy_ms(p, steps, f"span:{span}", span)
    owned = sum(out[f"layer_ms.{layer}"] for layer in LAYERS) + \
        busy_ms(p, steps, f"span:{PHASE}optimizer", PHASE + "optimizer")
    out["span_coverage"] = 100.0 * owned / busy_ms(p, steps, "step", PHASE + "forward")
    if counters.get("moe.rows_computed"):
        out["expert_rows_filled"] = 100.0 * counters.get("moe.rows_filled", 0) / \
            counters["moe.rows_computed"]
    return out
