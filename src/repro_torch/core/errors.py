"""POM's user-facing error and warning taxonomy.

The engine distinguishes three failure surfaces:

* :class:`PomUserError` — the *user's program* is wrong (an undeclared
  iterator, a rank-mismatched array access).  Raised at the DSL boundary
  with the statement/array named, never as a bare ``KeyError`` from deep
  inside ``graph_ir``.
* :class:`PomInternalError` — an invariant of the engine itself broke.
* :class:`PomWarning` — a structured, one-line, machine-parseable warning
  for *recovered* conditions: a Mosaic lowering that fell back to
  interpret mode, a worker pool that degraded to the serial evaluator, a
  quarantined design-database entry.  Emitted via :func:`warn_structured`
  so every recovery path in the resilience layer logs the same
  ``[pom:component] event key=value ...`` shape.
"""
from __future__ import annotations

import time
import warnings


class PomError(Exception):
    """Base of every POM-raised error."""


class PomUserError(PomError):
    """The user's DSL program is malformed (named statement/array/rank)."""


class PomInternalError(PomError):
    """An engine invariant was violated (please report)."""


class PomWarning(UserWarning):
    """A recovered fault: the engine degraded or fell back, but the result
    is still correct (and bit-identical where the docs promise it)."""


def format_structured(component: str, event: str, **fields) -> str:
    """One-line ``[pom:component] event key=value ...`` message."""
    parts = [f"[pom:{component}] {event}"]
    for k in sorted(fields):
        parts.append(f"{k}={fields[k]}")
    return " ".join(parts)


def warn_structured(component: str, event: str, **fields) -> str:
    """Emit a :class:`PomWarning` with the structured one-line format;
    returns the message (callers may also log it).

    The single emission path for recovered faults: the warning carries a
    monotonic ``ts=`` field (seconds, comparable across one process and
    its forked workers), and the same component/event/fields land in the
    telemetry layer — a named counter always, plus a timeline instant
    when a trace session is active — so injected failures are visible in
    the very trace they perturb."""
    msg = f"{format_structured(component, event, **fields)}" \
          f" ts={time.monotonic():.6f}"
    from . import telemetry
    telemetry.warning(component, event, msg, fields)
    warnings.warn(msg, PomWarning, stacklevel=2)
    return msg
