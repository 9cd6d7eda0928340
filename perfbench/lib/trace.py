"""The traced window: ``torch.profiler`` over a few steps, reduced to the
numbers the per-layer readers take.

The benchmark opens every span itself: ``perfbench.window`` around the
window, ``perfbench.step`` around each call into the program, and, for a
reader that declares a ``KernelSpan``, ``perfbench.<counts>`` around each
call of one function of the program (the attribute is wrapped for the
traced window only, and each call's operations and bytes are counted from
its arguments by ``perfbench/counts/<counts>.py``).  A span's device time
is the device side of its range in the trace (the profiler lays each host
range over the device from the first to the last work launched inside it),
so no kernel is matched by name.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "perfbench.window"
STEP = "perfbench.step"
NAME_CHARS = 120


@dataclass(frozen=True)
class KernelSpan:
    """One function of the program, ``module.attr``, timed through a span of
    its own; ``counts`` names ``perfbench/counts/<counts>.py``."""
    module: str
    attr: str
    counts: str

    @property
    def span(self) -> str:
        return f"perfbench.{self.counts}"


@dataclass
class Trace:
    """What a traced window leaves: the wall and busy seconds, the device
    activity, each span's device seconds and the counted calls."""
    window_s: float
    busy_s: float
    steps: int
    launches: int
    span_device_s: Dict[str, float]
    calls: Dict[str, List[Tuple[float, float, float]]]      # span -> (flops, bytes, peak)
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    info: dict = field(default_factory=dict)                # the window's model FLOPs


@contextlib.contextmanager
def kernel_spans(spans: List[KernelSpan], calls: Dict[str, list]):
    """Wraps each span's function for the block: a ``record_function`` named
    ``span.span`` around the call, and the call's counts appended to
    ``calls[span.span]``.  A function the program no longer has is left
    out (its reader then finds nothing)."""
    undo = []
    try:
        for ks in spans:
            try:
                mod = importlib.import_module(ks.module)
                fn = getattr(mod, ks.attr)
            except (ImportError, AttributeError):
                continue
            count = importlib.import_module(f"perfbench.counts.{ks.counts}").count
            sink = calls.setdefault(ks.span, [])

            def wrapped(*args, __fn=fn, __count=count, __sink=sink, __name=ks.span, **kwargs):
                __sink.append(__count(*args, **kwargs))
                with torch.profiler.record_function(__name):
                    return __fn(*args, **kwargs)
            functools.update_wrapper(wrapped, fn)
            setattr(mod, ks.attr, wrapped)
            undo.append((mod, ks.attr, fn))
        yield
    finally:
        for mod, attr, fn in reversed(undo):
            setattr(mod, attr, fn)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _host_at(cpu: List[Tuple[float, float, str]], starts: List[float], t: float) -> str:
    """The innermost host op running at time t (the latest-starting one that
    still encloses t)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 4000), -1):
        s, e, name = cpu[j]
        if e >= t:
            return name
    return "(no host op)"


def run_traced(fn: Callable[[], int], spans: List[KernelSpan]) -> Trace:
    """Runs ``fn`` (which returns the steps it ran, each inside a
    ``perfbench.step`` span, and synchronizes the device at its end) under
    the profiler, and reduces the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls: Dict[str, list] = {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with kernel_spans(spans, calls), profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            steps = fn()
            window_s = time.perf_counter() - t0
    events = prof.events()
    cpu, dev_events = [], []
    w0 = w1 = None
    for e in events:
        r = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev_events.append((r.start, r.end, e.name))
            continue
        if e.name == WINDOW:
            w0, w1 = r.start, r.end
        cpu.append((r.start, r.end, e.name))
    # a range opened on the host shows on the device too, as the span of the
    # work launched inside it: that is a span's device time, and no kernel
    ranges = {c[2] for c in cpu}
    span_s: Dict[str, float] = {}
    dev = []
    for s, e, n in dev_events:
        if n in ranges:
            if n.startswith("perfbench."):
                span_s[n] = span_s.get(n, 0.0) + 1e-6 * (e - s)
        else:
            dev.append((s, e, n))
    if w0 is not None:
        dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    merged = _union([(s, e) for s, e, _ in dev])
    busy_s = 1e-6 * sum(e - s for s, e in merged)
    by_name: Dict[str, float] = {}
    for s, e, n in dev:
        key = n[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + 1e-6 * (e - s)
    cpu = sorted(c for c in cpu if c[2] not in (WINDOW, STEP))
    starts = [c[0] for c in cpu]
    gaps: Dict[str, float] = {}
    edges = ([(w0, w0)] if w0 is not None else []) + merged + \
        ([(w1, w1)] if w1 is not None else [])
    for (_, e0), (s1, _) in zip(edges, edges[1:]):
        if s1 > e0:
            key = _host_at(cpu, starts, e0)[:NAME_CHARS]
            gaps[key] = gaps.get(key, 0.0) + 1e-6 * (s1 - e0)
    return Trace(window_s=window_s, busy_s=busy_s, steps=steps, launches=len(dev),
                 span_device_s=span_s, calls=calls,
                 device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
                 idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:10])


def roofline(trace: Trace, ks: KernelSpan) -> Optional[float]:
    """The span's share of its roofline, in %: the least time the card could
    take for the counted calls (each call the larger of its operations over
    the peak and its bytes over the bandwidth) over the span's device time.
    None where the window made no such call or the trace saw no kernel."""
    from perfbench.lib import peaks
    calls = trace.calls.get(ks.span) or []
    t = trace.span_device_s.get(ks.span, 0.0)
    if not calls or t <= 0:
        return None
    bound = sum(max(f / peak, b / peaks.BYTES_PER_S) for f, b, peak in calls)
    return 100.0 * bound / t
