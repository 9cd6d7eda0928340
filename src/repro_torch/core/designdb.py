"""Crash-safe persistent design database (the resilient compile service).

An on-disk, content-addressed store of finished DSE results, keyed by a
*name-canonical* structural signature of the input program
(:func:`function_key`, built on ``graph_ir.op_structural_key`` — never on
process-local ``Statement.uid``s), so two processes compiling the same
program — even with renamed iterators/arrays — address the same entry.

Layout under the db root (``POM_DESIGN_DB`` or an explicit path)::

    designs/<k0k1>/<key>.json     one finished design per entry
    archives/<key>.json           persisted Pareto frontiers
    quarantine/<name>.<n>.json    corrupted/mismatched entries, kept for
                                  post-mortem, never re-read

Every entry is an envelope ``{"version", "key", "checksum", "payload"}``
where ``checksum`` is the SHA-256 of the canonical (sorted-keys) JSON of
the payload.  Every write is **atomic** — tempfile + ``os.replace``, the
same idiom as ``distributed.ft.Heartbeat.beat`` — so a reader never
observes a half-written entry from a live writer; a *torn* write from a
crashed writer (or any other corruption) is caught on read by the JSON
parse, the version gate, or the checksum, and the entry is then
**quarantined** and recomputed: never a crash, never a silently wrong
design.  Verified entries are additionally held in an in-process hot
cache, so repeated hits are dictionary lookups.

Fault-injection sites (``core.faultinject``): ``designdb.read`` corrupts
the entry just before it is read; ``designdb.write`` corrupts it just
after the atomic write (simulating the torn-write crash window).
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from . import faultinject, telemetry
from .cost_model import DataflowReport, DesignReport, NodeReport
from .errors import warn_structured

DB_VERSION = 1


# --------------------------------------------------------------------------
# atomic writes (the Heartbeat.beat idiom, generalized)
# --------------------------------------------------------------------------
def atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` atomically: readers see the old content
    or the new content, never a torn mix.  The tempfile lives in the
    destination directory so ``os.replace`` stays a same-filesystem
    rename."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj: Any, indent: Optional[int] = 2) -> None:
    """JSON-dump ``obj`` to ``path`` atomically (tempfile + ``os.replace``)."""
    atomic_write_text(path, json.dumps(obj, indent=indent) + "\n")


def _sha256(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def _canonical_json(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


# --------------------------------------------------------------------------
# content addressing
# --------------------------------------------------------------------------
def function_key(fn, options: Optional[Dict[str, Any]] = None) -> str:
    """Content address of a (function, DSE options) pair.

    Built from each statement's name-canonical structural key
    (``graph_ir.op_structural_key``: domain + substitution + accesses +
    body, invariant under iterator/array renaming) plus the pieces that
    key does not cover but that change the produced design: array
    shapes/dtypes in access order, any pre-set schedule state (unrolls /
    pipeline position, expressed positionally, not by dim name), fusion
    specs (by statement index), the function's dataflow pin, and the
    search options.  Deliberately **not** included: ``Statement.uid`` or
    ``schedule_signature()`` (both process-local), statement/array
    *names* (canonicalized away), and worker counts (the parallel
    evaluator is bit-identical to greedy by invariant)."""
    from .graph_ir import op_structural_key
    from .ir import loads_of
    by_id = {id(s): i for i, s in enumerate(fn.statements)}
    stmts = []
    for s in fn.statements:
        arrays = [s.store.array] + [ld.array for ld in loads_of(s.body)]
        shapes = tuple((tuple(a.shape), a.dtype.name) for a in arrays)
        pos = {d: i for i, d in enumerate(s.dims)}
        sched = (tuple(sorted((pos[d], f) for d, f in s.unrolls.items()
                              if d in pos)),
                 pos.get(s.pipeline_at, -1), s.pipeline_ii)
        after = (None if s.after_spec is None
                 else (by_id.get(id(s.after_spec[0]), -1), s.after_spec[1]))
        stmts.append((op_structural_key(s), shapes, sched, after))
    opts = tuple(sorted((k, repr(v)) for k, v in (options or {}).items()
                        if v is not None))
    body = ("pom-design-v1", getattr(fn, "dataflow", None),
            tuple(stmts), opts)
    return _sha256(repr(body))


# --------------------------------------------------------------------------
# DesignReport (de)serialization
# --------------------------------------------------------------------------
def report_to_json(rep: DesignReport) -> Dict[str, Any]:
    d: Dict[str, Any] = {
        "latency": rep.latency,
        "dsp": rep.dsp, "lut": rep.lut, "ff": rep.ff,
        "bram_bits": rep.bram_bits, "feasible": rep.feasible,
        "nodes": {
            name: {"name": n.name, "latency": n.latency, "ii": n.ii,
                   "depth": n.depth, "dsp": n.dsp, "lut": n.lut,
                   "parallelism": n.parallelism,
                   "trip_product": n.trip_product, "flops": n.flops}
            for name, n in rep.nodes.items()},
    }
    if rep.dataflow is not None:
        f = rep.dataflow
        d["dataflow"] = {
            "applied": f.applied, "tasks": f.tasks,
            "sequential_latency": f.sequential_latency,
            "region_latency": f.region_latency,
            "channel_bits": f.channel_bits, "channel_lut": f.channel_lut,
            "channels": [list(c) for c in f.channels], "reason": f.reason,
            "ii_region": f.ii_region}
    return d


def report_from_json(d: Dict[str, Any]) -> DesignReport:
    nodes = {name: NodeReport(**nd) for name, nd in d["nodes"].items()}
    dataflow = None
    if d.get("dataflow") is not None:
        f = dict(d["dataflow"])
        f["channels"] = tuple(tuple(c) for c in f.get("channels", ()))
        dataflow = DataflowReport(**f)
    return DesignReport(latency=d["latency"], nodes=nodes, dsp=d["dsp"],
                        lut=d["lut"], ff=d["ff"],
                        bram_bits=d["bram_bits"], feasible=d["feasible"],
                        dataflow=dataflow)


# --------------------------------------------------------------------------
# the database
# --------------------------------------------------------------------------
@dataclass
class DbStats:
    hits: int = 0            # entries served (hot cache or verified disk)
    misses: int = 0
    writes: int = 0
    quarantined: int = 0     # corrupted/version-mismatched entries moved


@dataclass
class DesignDB:
    """Content-addressed store of finished designs + Pareto archives.

    ``path=None`` keeps a purely in-process store (the hot cache only) —
    the compile service works identically, just without persistence.
    Instances are cheap; every read validates (version + checksum) before
    trusting disk, so any number of concurrent writers is safe: writes
    are atomic whole-entry replaces of content-addressed (hence
    value-identical) payloads."""
    path: Optional[str] = None
    stats: DbStats = field(default_factory=DbStats)
    _hot: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    _quarantine_n: int = 0

    def __post_init__(self):
        if self.path:
            for sub in ("designs", "archives", "quarantine"):
                os.makedirs(os.path.join(self.path, sub), exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _entry_path(self, key: str) -> str:
        d = os.path.join(self.path, "designs", key[:2])
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, key + ".json")

    def _archive_path(self, key: str) -> str:
        return os.path.join(self.path, "archives", key + ".json")

    # -- envelope ------------------------------------------------------------
    @staticmethod
    def _envelope(key: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        return {"version": DB_VERSION, "key": key,
                "checksum": _sha256(_canonical_json(payload)),
                "payload": payload}

    def _validate(self, key: str, env: Any) -> Dict[str, Any]:
        """Return the verified payload or raise ValueError naming why."""
        if not isinstance(env, dict):
            raise ValueError("entry is not an object")
        if env.get("version") != DB_VERSION:
            raise ValueError(f"version {env.get('version')!r} != {DB_VERSION}")
        if env.get("key") != key:
            raise ValueError("entry key mismatch")
        payload = env.get("payload")
        if not isinstance(payload, dict):
            raise ValueError("missing payload")
        if env.get("checksum") != _sha256(_canonical_json(payload)):
            raise ValueError("checksum mismatch")
        return payload

    def _quarantine(self, path: str, reason: str) -> None:
        """Move a bad entry aside (never deleted, never re-read) and warn.
        The move itself is atomic; a lost race with another process's
        quarantine of the same entry is fine (the entry is gone either
        way)."""
        self.stats.quarantined += 1
        self._quarantine_n += 1
        telemetry.REGISTRY.counter("designdb.quarantines").inc()
        dest = os.path.join(
            self.path, "quarantine",
            f"{os.path.basename(path)}.{os.getpid()}.{self._quarantine_n}")
        try:
            os.replace(path, dest)
        except OSError:
            dest = "<unlinked>"
        warn_structured("designdb", "entry_quarantined",
                        entry=os.path.basename(path), reason=reason,
                        moved_to=os.path.relpath(dest, self.path)
                        if dest != "<unlinked>" else dest)

    # -- designs -------------------------------------------------------------
    def get(self, key: str) -> Optional[Dict[str, Any]]:
        """Verified payload for ``key``, or None (miss / quarantined)."""
        with telemetry.span("designdb.get", _cat="designdb",
                            key=key[:12]) as sp:
            out, outcome = self._get(key)
            sp.add(outcome=outcome)
        telemetry.REGISTRY.counter(f"designdb.{outcome}").inc()
        return out

    def _get(self, key: str):
        hit = self._hot.get(key)
        if hit is not None:
            self.stats.hits += 1
            return hit, "hit_hot"
        if not self.path:
            self.stats.misses += 1
            return None, "miss"
        path = self._entry_path(key)
        if not os.path.exists(path):
            self.stats.misses += 1
            return None, "miss"
        kind = faultinject.fires("designdb.read")
        if kind in ("truncate", "bitflip"):
            faultinject.corrupt_file(path, kind)
        try:
            if kind == "error":
                raise OSError("injected transient read error")
            with open(path) as fh:
                env = json.load(fh)
            payload = self._validate(key, env)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            self._quarantine(path, f"{type(e).__name__}: {e}")
            self.stats.misses += 1
            return None, "quarantined"
        self._hot[key] = payload
        self.stats.hits += 1
        return payload, "hit_disk"

    def put(self, key: str, payload: Dict[str, Any]) -> None:
        """Store a payload under ``key`` — atomic, checksummed."""
        self._hot[key] = payload
        self.stats.writes += 1
        telemetry.REGISTRY.counter("designdb.writes").inc()
        if not self.path:
            return
        with telemetry.span("designdb.put", _cat="designdb", key=key[:12]):
            path = self._entry_path(key)
            atomic_write_json(path, self._envelope(key, payload))
        kind = faultinject.fires("designdb.write")
        if kind in ("truncate", "bitflip"):
            # simulate the crash window of a non-atomic writer: the entry
            # is torn on disk and must be caught by the next read
            faultinject.corrupt_file(path, kind)

    def __contains__(self, key: str) -> bool:
        if key in self._hot:
            return True
        return bool(self.path) and os.path.exists(self._entry_path(key))

    def forget(self, key: str) -> None:
        """Drop the hot-cache copy (the next ``get`` re-verifies disk)."""
        self._hot.pop(key, None)

    # -- archives ------------------------------------------------------------
    def store_archive(self, key: str, archive) -> None:
        """Persist a ``search.ParetoArchive`` frontier for ``key``.

        What is persisted is the *frontier* (objective points +
        evaluated/infeasible counts), not the dedup state: design
        signatures contain process-local uids by construction and must
        never cross a process boundary."""
        if not self.path:
            self._hot["archive:" + key] = archive.to_json()
            return
        payload = archive.to_json()
        atomic_write_json(self._archive_path(key),
                          self._envelope(key, payload))

    def load_archive(self, key: str) -> Optional[Dict[str, Any]]:
        """Verified frontier payload (``ParetoArchive.to_json`` shape) or
        None; corrupted archives are quarantined like design entries."""
        hot = self._hot.get("archive:" + key)
        if hot is not None:
            return hot
        if not self.path:
            return None
        path = self._archive_path(key)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as fh:
                env = json.load(fh)
            return self._validate(key, env)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            self._quarantine(path, f"{type(e).__name__}: {e}")
            return None


def open_db(path: Optional[str] = None) -> DesignDB:
    """Open the design database at ``path`` (default: ``POM_DESIGN_DB``;
    unset → an in-process, non-persistent store)."""
    if path is None:
        path = os.environ.get("POM_DESIGN_DB") or None
    return DesignDB(path)
