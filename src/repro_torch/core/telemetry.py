"""Unified telemetry: structured span tracing + the metrics registry.

POM's pitch is that multi-level IR makes optimization *debuggable*; this
module is where the engine explains itself.  Two pieces, the first
with no dependency beyond torch's profiler flag:

**Span tracing** — ``telemetry.span("stage2.rung", statement="s", P=4)``
is a context manager that records one timed event; ``telemetry.event``
records an instant.  The pipeline (per-pass spans with IR sizes), the
stage-2 search (rung/wave/candidate spans with eval-count deltas), the
warm-worker pool (dispatch/retry/kill/degrade lifecycle, per-worker
lanes), the design database, the backends, and ``CompileService``
requests are all instrumented through this one API; every
``errors.warn_structured`` call and ``faultinject`` firing lands in the
same timeline it perturbs.

Traces export as **Chrome trace-event JSON** (viewable in Perfetto or
``chrome://tracing``): ``POM_TRACE=<path>.json`` — or ``trace_path=`` on
``compile`` / ``auto_dse`` / ``serve`` — writes the file;
``POM_TRACE=-`` prints a compact span-tree summary to stdout instead.
Worker processes appear as separate tracks: workers are forked, so
``time.perf_counter`` (CLOCK_MONOTONIC on Linux, system-wide) gives both
sides one clock base, and each worker's events ride back to the parent
on the existing candidate-result replies — no re-alignment needed.

**Strictly pay-for-use**: with tracing off, ``span()`` returns one
shared no-op object (no allocation, no timestamp read) and ``event()``
is a single ``is None`` check.  Tracing records *observations only* —
it never issues analysis queries — so every bit-identity invariant
(serial vs pooled, cached vs uncached, eval-counter parity) holds with
tracing on or off; ``tests/test_perf_smoke.py`` pins the counter
parity.

**The profiler as a second sink** — while a ``torch.profiler`` session
records, ``span(name)`` also opens a ``torch.profiler.record_function``
range of that name, so the program's spans land in the profiler's own
trace on its clock, beside the device work they launched; ``on()`` is
true while either sink records.  The LM stack's train path names its
spans ``repro.*`` (``repro.train.forward``, ``repro.block``,
``repro.moe.dispatch``, ...; ``docs/architecture.md`` lists them).  With
neither sink on, ``span()`` is still the shared no-op.

**Metrics registry** — named counters / gauges / histograms unifying
what used to be ad-hoc dicts: ``cost_model.CostStats``, the beam's
``wave_stats``, ``designdb.DbStats``, warm-pool health, and
``CompileService`` request latencies (p50/p99).  ``pom.metrics()``
snapshots everything as one JSON-ready dict; ``DesignReport.telemetry``
carries the per-run slice, which is what ``bench_dse_speed`` records
per strategy.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

__all__ = [
    "span", "event", "on", "session", "warning", "metrics", "dump_stream",
    "start_trace", "stop_trace", "maybe_trace", "export_trace",
    "buffer_mark", "buffer_delta", "absorb",
    "counter", "gauge", "histogram", "REGISTRY", "Registry",
]


def _now_us() -> float:
    # CLOCK_MONOTONIC is system-wide on Linux: forked worker processes
    # share the parent's clock base, so worker events land on the same
    # timeline without per-process offset correction.
    return time.perf_counter() * 1e6


# --------------------------------------------------------------------------
# spans
# --------------------------------------------------------------------------
class _NullSpan:
    """The shared disabled-path span: falsy, allocation-free, inert."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def add(self, **args) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records a Chrome 'X' (complete) event on exit.

    ``add(**args)`` attaches arguments discovered mid-span (eval-count
    deltas, accept/reject outcomes) — the recorded event carries them."""
    __slots__ = ("tracer", "name", "cat", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = _now_us()
        return self

    def __exit__(self, *exc):
        self.tracer._record(self.name, self.cat, self.t0,
                            _now_us() - self.t0, self.args)
        return False

    def __bool__(self):
        return True

    def add(self, **args) -> "_Span":
        self.args.update(args)
        return self


class _ProfiledSpan:
    """A span while a ``torch.profiler`` session records: a
    ``record_function`` range of the span's name in the profiler's trace,
    around the POM trace's own span where a session of that is active too."""
    __slots__ = ("rf", "inner")

    def __init__(self, name: str, inner: Optional[_Span]):
        self.rf = _profiler.record_function(name)
        self.inner = inner

    def __enter__(self):
        self.rf.__enter__()
        if self.inner is not None:
            self.inner.__enter__()
        return self

    def __exit__(self, *exc):
        if self.inner is not None:
            self.inner.__exit__(*exc)
        self.rf.__exit__(*exc)
        return False

    def __bool__(self):
        return True

    def add(self, **args) -> "_ProfiledSpan":
        if self.inner is not None:
            self.inner.add(**args)
        return self


class Tracer:
    """Event buffer + export for one trace session (usually the process;
    forked workers inherit it and ship their buffer deltas back)."""

    def __init__(self, dest: str):
        self.dest = dest
        self.events: List[dict] = []
        self.t_start = _now_us()

    # -- recording -----------------------------------------------------------
    def _record(self, name: str, cat: str, ts: float, dur: float,
                args: Dict[str, Any]) -> None:
        self.events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": ts, "dur": dur,
            "pid": os.getpid(), "tid": threading.get_ident() & 0xFFFF,
            "args": args,
        })

    def instant(self, name: str, cat: str, args: Dict[str, Any]) -> None:
        self.events.append({
            "name": name, "cat": cat, "ph": "i", "s": "p",
            "ts": _now_us(),
            "pid": os.getpid(), "tid": threading.get_ident() & 0xFFFF,
            "args": args,
        })

    # -- export --------------------------------------------------------------
    def _lane_metadata(self) -> List[dict]:
        """Perfetto track names: the parent process is 'pom', every other
        pid (a forked warm worker) gets its own 'worker <pid>' lane."""
        me = os.getpid()
        out = []
        for pid in sorted({e["pid"] for e in self.events}):
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0, "args": {"name": "pom" if pid == me
                                           else f"pom worker {pid}"}})
        return out

    def to_chrome(self) -> Dict[str, Any]:
        """The Chrome trace-event envelope (Perfetto-loadable)."""
        return {"traceEvents": self._lane_metadata() + list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {"tool": "pom-telemetry"}}

    def export(self, dest: Optional[str] = None) -> None:
        """Write the trace: a path gets Chrome JSON; ``-`` gets the
        compact span-tree summary on stdout (``dump_stream``)."""
        dest = dest or self.dest
        if dest == "-":
            dump_stream(self.summary(), "-")
        else:
            dump_stream(json.dumps(self.to_chrome()), dest)

    # -- compact tree summary (POM_TRACE=-) ----------------------------------
    def summary(self) -> str:
        """Span tree per process lane: nesting reconstructed from
        timestamp containment, durations in ms, instants as leaf dots."""
        me = os.getpid()
        lines = [f"# POM trace: {len(self.events)} events"]
        by_pid: Dict[int, List[dict]] = {}
        for e in self.events:
            by_pid.setdefault(e["pid"], []).append(e)
        for pid in sorted(by_pid, key=lambda p: (p != me, p)):
            lines.append(f"[{'pom' if pid == me else f'worker {pid}'}]")
            evs = sorted(by_pid[pid], key=lambda e: (e["ts"],
                                                     -e.get("dur", 0.0)))
            stack: List[dict] = []
            for e in evs:
                while stack and (e["ts"] >= stack[-1]["ts"]
                                 + stack[-1].get("dur", 0.0)):
                    stack.pop()
                pad = "  " * (len(stack) + 1)
                if e["ph"] == "i":
                    lines.append(f"{pad}· {e['name']}")
                else:
                    lines.append(f"{pad}{e['name']}"
                                 f"  {e.get('dur', 0.0) / 1e3:.3f} ms")
                    stack.append(e)
        return "\n".join(lines)


_TRACER: Optional[Tracer] = None


def on() -> bool:
    """Is a sink recording (a trace session, or a ``torch.profiler``
    session)?  The disabled-path guard for callers that would otherwise pay
    to *assemble* span arguments or count."""
    return _TRACER is not None or _profiler._is_profiler_enabled


def session() -> Optional["Tracer"]:
    """The active trace session, or None (a profiler alone is no session)."""
    return _TRACER


def span(name: str, _cat: str = "pom", **args):
    """Open a span (context manager).  Disabled path: returns the shared
    no-op span — callers may unconditionally ``with telemetry.span(...)``.
    While a profiler records, the span is a ``record_function`` range too."""
    t = _TRACER
    if _profiler._is_profiler_enabled:
        return _ProfiledSpan(name, None if t is None else _Span(t, name, _cat, args))
    if t is None:
        return _NULL_SPAN
    return _Span(t, name, _cat, args)


def event(name: str, _cat: str = "pom", **args) -> None:
    """Record an instant event (a point on the timeline)."""
    t = _TRACER
    if t is not None:
        t.instant(name, _cat, args)


def warning(component: str, event_name: str, message: str,
            fields: Dict[str, Any]) -> None:
    """The telemetry half of ``errors.warn_structured`` — every recovered
    fault becomes a timeline instant in the trace it perturbs, and a
    named counter either way."""
    REGISTRY.counter(f"warnings.{component}").inc()
    t = _TRACER
    if t is not None:
        t.instant(f"warn:{component}.{event_name}", "warning",
                  dict(fields, message=message))


# --------------------------------------------------------------------------
# trace session lifecycle
# --------------------------------------------------------------------------
def start_trace(dest: str) -> Tracer:
    """Begin a trace session writing to ``dest`` (a path, or ``-`` for
    the stdout tree summary).  One session per process; starting while
    one is active is an error (use :func:`maybe_trace` to join)."""
    global _TRACER
    if _TRACER is not None:
        raise RuntimeError("a trace session is already active")
    _TRACER = Tracer(dest)
    return _TRACER


def stop_trace(export: bool = True) -> Optional[Tracer]:
    """End the session; exports to its destination by default."""
    global _TRACER
    t = _TRACER
    _TRACER = None
    if t is not None and export:
        t.export()
    return t


def export_trace(dest: Optional[str] = None) -> bool:
    """Write the active session's buffer now (cumulative, idempotent) —
    the compile service calls this after every request so the trace file
    on disk is always valid, even mid-session."""
    t = _TRACER
    if t is None:
        return False
    t.export(dest)
    return True


class _MaybeTrace:
    """Context manager: start a trace session if one was requested
    (``trace_path`` argument or ``POM_TRACE``) and none is active; join
    (and leave alone) an already-active session otherwise."""

    def __init__(self, trace_path: Optional[str] = None):
        self.trace_path = trace_path
        self.owned: Optional[Tracer] = None

    def __enter__(self):
        dest = self.trace_path or os.environ.get("POM_TRACE")
        if dest and _TRACER is None:
            self.owned = start_trace(dest)
        return self

    def __exit__(self, *exc):
        if self.owned is not None and _TRACER is self.owned:
            stop_trace()
        return False


def maybe_trace(trace_path: Optional[str] = None) -> _MaybeTrace:
    return _MaybeTrace(trace_path)


# --------------------------------------------------------------------------
# worker-side buffer shipping (the pool's replay-merge delta for traces)
# --------------------------------------------------------------------------
def buffer_mark() -> int:
    """Current buffer length — the worker snapshots this before evaluating
    a candidate and ships everything after it."""
    t = _TRACER
    return len(t.events) if t is not None else 0


def buffer_delta(mark: int) -> Optional[List[dict]]:
    """Events recorded since ``mark`` (None when tracing is off)."""
    t = _TRACER
    if t is None:
        return None
    return t.events[mark:]


def absorb(events: Optional[List[dict]]) -> None:
    """Fold a worker's shipped events into the parent's buffer.  Events
    carry their recording pid, so worker lanes separate at export; the
    shared CLOCK_MONOTONIC base keeps them clock-aligned."""
    t = _TRACER
    if t is not None and events:
        t.events.extend(events)


# --------------------------------------------------------------------------
# stdout/stderr/file dump helper (POM_TRACE=- and POM_DUMP_PARETO=-)
# --------------------------------------------------------------------------
def dump_stream(text: str, dest: str = "-") -> None:
    """Write a dump to stdout (``-``), stderr (``stderr``), or a file —
    with an explicit flush on the stream paths so dumps interleave
    correctly with pytest capture and surrounding service logs."""
    if dest in ("-", "stdout", ""):
        sys.stdout.write(text + "\n")
        sys.stdout.flush()
    elif dest == "stderr":
        sys.stderr.write(text + "\n")
        sys.stderr.flush()
    else:
        with open(dest, "w") as fh:
            fh.write(text + "\n")


# --------------------------------------------------------------------------
# metrics registry
# --------------------------------------------------------------------------
class Counter:
    """A count.  ``inc`` takes an int, or a 0-d device tensor that is summed
    on the device and read, by one wait for the device, when ``value`` is
    next read."""
    __slots__ = ("_n", "pending")

    def __init__(self):
        self._n = 0
        self.pending = None

    def inc(self, n=1) -> None:
        if isinstance(n, torch.Tensor):
            n = n.detach()
            self.pending = n if self.pending is None else self.pending + n
        else:
            self._n += n

    @property
    def value(self) -> int:
        if self.pending is not None:
            self._n += int(self.pending.item())
            self.pending = None
        return self._n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Streaming histogram: exact count/sum/min/max, quantiles over a
    bounded sample window (plenty for request-latency p50/p99)."""
    __slots__ = ("count", "total", "vmin", "vmax", "samples")
    MAX_SAMPLES = 4096

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.samples: List[float] = []

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if len(self.samples) >= self.MAX_SAMPLES:
            # keep the window bounded; halving preserves the distribution
            # shape well enough for p50/p99 on long-running services
            self.samples = self.samples[::2]
        self.samples.append(v)

    def quantile(self, q: float) -> Optional[float]:
        if not self.samples:
            return None
        xs = sorted(self.samples)
        i = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
        return xs[i]

    def to_json(self) -> Dict[str, Any]:
        return {"count": self.count,
                "sum": self.total,
                "min": None if self.count == 0 else self.vmin,
                "max": None if self.count == 0 else self.vmax,
                "p50": self.quantile(0.50),
                "p99": self.quantile(0.99)}


class Registry:
    """Named counters/gauges/histograms with one JSON-ready snapshot —
    the shared schema ``bench_*`` and CI consume instead of ad-hoc dicts."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram()
        return h

    def counter_values(self, prefix: str = "") -> Dict[str, int]:
        return {n: c.value for n, c in self._counters.items()
                if n.startswith(prefix)}

    def snapshot(self) -> Dict[str, Any]:
        return {
            "counters": {n: c.value
                         for n, c in sorted(self._counters.items())},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.to_json()
                           for n, h in sorted(self._histograms.items())},
        }

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._histograms.clear()


REGISTRY = Registry()
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram


def merge_counters(values: Dict[str, int], prefix: str = "") -> None:
    """Fold a component's ad-hoc counter dict (``wave_stats``, db stats)
    into the registry under ``prefix`` — the unification shim."""
    for name, v in values.items():
        REGISTRY.counter(prefix + name).inc(int(v))


def metrics() -> Dict[str, Any]:
    """One JSON-ready snapshot of everything the engine counts: the
    registry (search/pool/db/service/warning metrics) plus the
    polyhedral-layer evaluation counters (``caching.COUNTS``) and their
    derived headline ``analysis_evals``."""
    from . import caching
    snap = REGISTRY.snapshot()
    snap["caching"] = dict(caching.COUNTS)
    snap["tracing"] = {"active": on()}
    return snap
