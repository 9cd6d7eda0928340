#!/usr/bin/env python3
"""A train cell's step time by the program's own spans and counters.

    python3 perfbench/spans.py --workload granite.train_4k --seed 7

On the card, at the cell's own size: the cell's program (``kinds/train.py``
``Program``: its model, seeded weights, AdamW state and feed) runs its
checked steps to warm up, then the traffic's ``trace_steps`` steps under
``torch.profiler`` as a traced run of the cell does, while the program's
``repro.*`` spans and ``moe.*`` counters record
(``repro_torch.core.telemetry``).  Prints one JSON line: the card, the
window's wall and busy seconds, ``lib/program.summary``
(``step_phase_ms``, ``layer_ms``, ``span_coverage``,
``expert_rows_filled``), busy ms a step by part and span, the top device
ops of each, idle ms by program span, and the autograd nodes put down to a
span.  The tests call ``traced`` on small cells on the CPU.

A stand-in, to be deleted once the cell's traced run (``lib/trace.py``)
hands its profile to ``lib/program.program_spans``: until then the
benchmark reads none of the program's spans.
"""
from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def traced(ctx) -> dict:
    """Runs the cell's program as the module docstring says and returns the
    line's numbers."""
    import torch
    from perfbench.kinds.train import Program
    from perfbench.lib import program as P
    from perfbench.lib import trace as T
    from repro_torch.core.telemetry import REGISTRY

    steps = ctx.traffic["trace_steps"]
    on_cpu = ctx.device.type == "cpu"
    prog = Program(ctx)
    prog.start(ctx.seed)
    prog.checked_steps()
    sync = (lambda: None) if on_cpu else torch.cuda.synchronize
    sync()
    before = REGISTRY.counter_values("moe.")
    acts = [torch.profiler.ProfilerActivity.CPU] + \
        ([] if on_cpu else [torch.profiler.ProfilerActivity.CUDA])
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(T.WINDOW):
            t0 = time.perf_counter()
            for _ in range(steps):
                with torch.profiler.record_function(T.STEP):
                    prog.step()
            sync()
            window_s = time.perf_counter() - t0
    counters = {c: v - before.get(c, 0) for c, v in REGISTRY.counter_values("moe.").items()}
    prog.free()
    raw = prof.profiler.kineto_results.events()
    p = P.program_spans(raw, on_cpu)
    if p is None:
        raise SystemExit("spans: the program recorded no span")
    _, kernels, _, _, _ = P.attribute(raw, on_cpu)
    by_part, by_op = defaultdict(float), defaultdict(float)
    for k in kernels:
        ms = 1e-6 * (k.end - k.start) / steps
        by_part[f"{k.part} {k.span}"] += ms
        by_op[f"{k.span} {k.part} {k.name[:T.NAME_CHARS]}"] += ms
    busy = 1e-9 * sum(e - s for s, e in T._union([(k.start, k.end) for k in kernels]))
    return {"workload": ctx.cell["name"], "seed": ctx.seed, "steps": steps,
            "window_s": window_s, "busy_s": busy, "counters": counters,
            "summary": P.summary(p, steps, counters),
            "ms_by_part_span": dict(sorted(by_part.items(), key=lambda kv: -kv[1])),
            "top_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:60],
            "idle_ms": {n: 1e3 * s for n, s in sorted(p.idle_s.items(), key=lambda kv: -kv[1])},
            "nodes": p.nodes, "nodes_attributed": p.nodes_attributed}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("spans: no CUDA device", file=sys.stderr)
        return 2
    from perfbench.lib.harness import context
    ctx = context(args.workload, args.seed, 0, True, "cuda", ROOT, T0)
    if ctx.traffic["kind"] != "train":
        raise ValueError(f"spans reads train cells, not the {ctx.traffic['kind']} kind")
    out = traced(ctx)
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
