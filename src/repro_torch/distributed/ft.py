"""Fault tolerance: heartbeats, straggler detection, elastic remesh planning.

A copy of ``repro.distributed.ft`` (pure Python; the port imports nothing
of the reference).

Coordination is filesystem-based (works on any shared FS / GCS-fuse mount at
multi-host scale; local dir here).  Each worker writes a heartbeat with its
step and timestamp; the monitor classifies workers as healthy / straggler /
dead, and ``plan_remesh`` picks the largest usable mesh from the healthy
count so training restarts elastically from the last checkpoint.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


class Heartbeat:
    def __init__(self, workdir: str, host_id: int):
        self.dir = os.path.join(workdir, "hb")
        os.makedirs(self.dir, exist_ok=True)
        self.host_id = host_id
        self.path = os.path.join(self.dir, f"host_{host_id}.json")

    def beat(self, step: int, now: Optional[float] = None):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"host": self.host_id, "step": step,
                       "time": now if now is not None else time.time()}, f)
        os.replace(tmp, self.path)


@dataclass
class WorkerStatus:
    host: int
    step: int
    age_s: float
    state: str  # 'healthy' | 'straggler' | 'dead'


def check_workers(workdir: str, *, dead_after_s: float = 60.0,
                  straggle_steps: int = 3,
                  now: Optional[float] = None) -> List[WorkerStatus]:
    """Classify every worker from its heartbeat file.

    A worker is a *straggler* when it lags the median step by
    ``straggle_steps`` or its heartbeat is older than half the dead
    threshold; *dead* beyond ``dead_after_s``.
    """
    hb_dir = os.path.join(workdir, "hb")
    if not os.path.isdir(hb_dir):
        return []
    now = now if now is not None else time.time()
    entries = []
    for fn in sorted(os.listdir(hb_dir)):
        if not fn.endswith(".json"):
            continue
        try:
            with open(os.path.join(hb_dir, fn)) as f:
                entries.append(json.load(f))
        except (json.JSONDecodeError, OSError):
            continue
    if not entries:
        return []
    steps = sorted(e["step"] for e in entries)
    median = steps[len(steps) // 2]
    out = []
    for e in entries:
        age = now - e["time"]
        if age > dead_after_s:
            state = "dead"
        elif age > dead_after_s / 2 or e["step"] < median - straggle_steps:
            state = "straggler"
        else:
            state = "healthy"
        out.append(WorkerStatus(e["host"], e["step"], age, state))
    return out


def plan_remesh(n_healthy_hosts: int, chips_per_host: int = 4,
                model_parallel: int = 16) -> Optional[Tuple[int, ...]]:
    """Pick the largest (data, model) mesh that fits the healthy chips.

    Elastic policy: keep ``model_parallel`` fixed (resharding TP state is
    expensive); shrink/grow the data axis to the largest power of two that
    the healthy chip count supports.
    """
    chips = n_healthy_hosts * chips_per_host
    if chips < model_parallel:
        return None
    data = 1
    while data * 2 * model_parallel <= chips:
        data *= 2
    return (data, model_parallel)
