"""Deterministic fault injection for the resilience layer.

Every recovery path in the resilient compile service — worker
supervision in ``search.PoolEvaluator``, checksum/quarantine handling in
``designdb.DesignDB``, the kernel-launch error path of ``backend_cuda`` —
is exercised through *named injection sites* rather than trusted:

=================  ==========================================  ==============
site               where it fires                              kinds
=================  ==========================================  ==============
``worker.dispatch``  parent-side, per candidate dispatched to  ``crash`` (worker
                     a pool worker; the kind rides in the       SIGKILLs itself),
                     task payload and the *worker* executes it  ``hang``, ``pickle``
                                                                (malformed reply)
``designdb.read``    before a db entry is read                 ``truncate``,
                                                                ``bitflip``,
                                                                ``error``
``designdb.write``   after a db entry is atomically written    ``truncate``,
                     (simulates a torn write by a crashed       ``bitflip``
                     writer, detected on the next read)
``backend.lower``    inside a ``backend_cuda`` statement        ``error`` (raises
                     runner, before the kernel launch           ``CudaLowerError``)
=================  ==========================================  ==============

Faults are configured either programmatically (:func:`install` /
:func:`injected`) or through ``POM_FAULT=<site>:<kind>[:p]`` (comma-
separated for several).  ``p`` is a fire probability drawn from a
*seeded* ``random.Random`` stream, so a given spec fires on exactly the
same dispatch sequence every run — tests and the crash-rate benchmark
are deterministic.  ``max_fires`` bounds how often a spec fires (the
usual test shape: fire exactly once, then verify the recovered result is
bit-identical to the fault-free run).

All sites are no-ops (one dict lookup + one env check) when nothing is
installed, which is what keeps the production path inert.
"""
from __future__ import annotations

import os
import random
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

SITES = ("worker.dispatch", "designdb.read", "designdb.write",
         "backend.lower")
KINDS = ("crash", "hang", "pickle", "truncate", "bitflip", "error")


@dataclass
class FaultSpec:
    """One installed fault: where, what, how often."""
    site: str
    kind: str
    p: float = 1.0
    max_fires: Optional[int] = None
    seed: int = 0
    fires: int = 0
    checks: int = 0
    _rng: random.Random = field(default=None, repr=False)

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(known: {', '.join(SITES)})")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(known: {', '.join(KINDS)})")
        self._rng = random.Random(self.seed)

    def roll(self) -> bool:
        """Deterministically decide whether this check fires the fault."""
        self.checks += 1
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        # always advance the stream so the fire pattern depends only on
        # the check sequence number, not on p-threshold short-circuits
        draw = self._rng.random()
        if self.p < 1.0 and draw >= self.p:
            return False
        self.fires += 1
        return True


_SPECS: List[FaultSpec] = []
# env parse cache: raw POM_FAULT string -> parsed specs (re-parsed whenever
# the raw string changes, so tests may simply monkeypatch the env var)
_ENV_RAW: Optional[str] = None
_ENV_SPECS: List[FaultSpec] = []


def parse_spec(text: str) -> FaultSpec:
    """Parse one ``<site>:<kind>[:p]`` spec string."""
    parts = text.strip().split(":")
    if len(parts) < 2:
        raise ValueError(f"bad POM_FAULT spec {text!r} "
                         f"(want <site>:<kind>[:p])")
    site, kind = parts[0], parts[1]
    p = float(parts[2]) if len(parts) > 2 and parts[2] else 1.0
    return FaultSpec(site=site, kind=kind, p=p)


def _env_specs() -> List[FaultSpec]:
    global _ENV_RAW, _ENV_SPECS
    raw = os.environ.get("POM_FAULT")
    if raw != _ENV_RAW:
        _ENV_RAW = raw
        _ENV_SPECS = ([parse_spec(t) for t in raw.split(",") if t.strip()]
                      if raw else [])
    return _ENV_SPECS


def install(site: str, kind: str, p: float = 1.0,
            max_fires: Optional[int] = None, seed: int = 0) -> FaultSpec:
    """Programmatically install a fault; returns the live spec (its
    ``fires`` counter is how tests assert the recovery path actually
    ran)."""
    spec = FaultSpec(site=site, kind=kind, p=p, max_fires=max_fires,
                     seed=seed)
    _SPECS.append(spec)
    return spec


def clear() -> None:
    """Remove every programmatically installed fault (env specs are
    controlled by the POM_FAULT variable itself)."""
    _SPECS.clear()


def active() -> bool:
    return bool(_SPECS) or bool(_env_specs())


def fires(site: str) -> Optional[str]:
    """Consult every installed spec for ``site``; returns the kind of the
    first spec that fires, or None.  The fast path (nothing installed) is
    one list check and one env-string compare."""
    if not _SPECS and _ENV_RAW is None and "POM_FAULT" not in os.environ:
        return None
    for spec in list(_SPECS) + _env_specs():
        if spec.site == site and spec.roll():
            from . import telemetry
            telemetry.REGISTRY.counter(f"fault.fired.{site}").inc()
            telemetry.event("fault.fired", _cat="fault", site=site,
                            kind=spec.kind, fires=spec.fires, p=spec.p)
            return spec.kind
    return None


def fired(site: str) -> int:
    """Total fires recorded at ``site`` across all installed specs."""
    return sum(s.fires for s in list(_SPECS) + _env_specs()
               if s.site == site)


@contextmanager
def injected(site: str, kind: str, p: float = 1.0,
             max_fires: Optional[int] = None, seed: int = 0):
    """Scoped :func:`install` — yields the spec, uninstalls on exit."""
    spec = install(site, kind, p=p, max_fires=max_fires, seed=seed)
    try:
        yield spec
    finally:
        if spec in _SPECS:
            _SPECS.remove(spec)


def corrupt_file(path: str, kind: str) -> None:
    """Apply an on-disk corruption (the db fault kinds) to ``path``.

    ``truncate`` keeps only the first half of the file (a torn write);
    ``bitflip`` flips one bit in the middle byte (silent media/transfer
    corruption).  Both must be caught by the design database's checksum
    or JSON validation — never surfaced to the caller as a crash."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return
    if not data:
        return
    if kind == "truncate":
        data = data[: len(data) // 2]
    elif kind == "bitflip":
        mid = len(data) // 2
        data = data[:mid] + bytes([data[mid] ^ 0x20]) + data[mid + 1:]
    else:
        return
    with open(path, "wb") as fh:
        fh.write(data)
