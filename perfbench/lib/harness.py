"""One run of one cell: look its pieces up, build the program's config, run
the traffic kind's module, read the metrics, judge the readings, and make
the result line.

The pieces are found by their names (``lib/manifest.py``).  The
configuration's ``reference`` (its ``family`` where it names none) picks
both the plain reference, ``ctx.family``, and the model-FLOP count,
``ctx.count`` (None where nothing counts that reference: the kinds then
leave ``trace.info["flops"]`` None, and the ``mfu`` metrics read nothing).
The program's config takes the file's fields as they stand, a cut
(``reduced``) included.

``run_cell`` never looks for a card itself: ``run.py`` does that before it
calls it, and the CPU tests call it with ``device="cpu"`` on small cells.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import torch

from perfbench.lib import check
from perfbench.lib.manifest import ROOT, Manifest, reference_name
from perfbench.lib.trace import KernelSpan


def program_config(config: dict):
    """The program's ``ModelConfig`` from a configuration file: every field
    the file names, and the program's default for any other."""
    from repro_torch.configs.base import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in config.items() if k in names})


def context(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            root: Path = ROOT, t0: Optional[float] = None) -> SimpleNamespace:
    man = Manifest(root)
    cell = man.cell(workload)
    config = man.config(cell["config"])
    traffic = man.traffic(cell["traffic"])
    readers = {m["name"]: man.reader(m["name"]) for m in man.metrics("per_layer", workload)}
    spans = [r.SPAN for r in readers.values() if isinstance(getattr(r, "SPAN", None), KernelSpan)]
    ref = reference_name(config)
    return SimpleNamespace(
        manifest=man, cell=cell, config=config, traffic=traffic, mcfg=program_config(config),
        family=man.reference(ref), count=man.model_count(ref), kind=man.kind(traffic["kind"]),
        limits=man.limits(workload), readers=readers, spans=spans, seed=int(seed),
        seconds=float(seconds), trace=bool(trace), device=torch.device(device),
        t0=time.perf_counter() if t0 is None else t0)


def log(ctx, what: str) -> None:
    """A phase's end on standard error, seconds since the process started."""
    print(f"perfbench: {time.perf_counter() - ctx.t0:8.2f} s  {what}", file=sys.stderr, flush=True)


def device_info(ctx, peak: int) -> dict:
    if ctx.device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": int(ctx.cell["chips"]), "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path = ROOT, t0: Optional[float] = None) -> dict:
    ctx = context(workload, seed, seconds, trace, device, root, t0)
    out = ctx.kind.run(ctx)
    metrics = {}
    if not ctx.trace:
        for m in ctx.manifest.metrics("end_to_end", workload):
            if m["name"] not in out["e2e"]:
                raise RuntimeError(f"the {ctx.traffic['kind']} kind gives no {m['name']}")
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    else:
        tr = out["trace"]
        for m in ctx.manifest.metrics("per_layer", workload):
            value = ctx.readers[m["name"]].read(m["name"], tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    ok, checks = check.judge(out["readings"], ctx.limits["limits"])
    result = {"correct": bool(ok and out["failed"] == 0), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device_info(ctx, out["memory_peak_bytes"])}
    if ctx.trace:
        tr = out["trace"]
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": [[n, s] for n, s in tr.device_ops],
                               "idle_gaps": [[n, s] for n, s in tr.idle_gaps]}
    result["checks"] = checks
    return result
