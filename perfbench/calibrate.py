#!/usr/bin/env python3
"""Readings that set a cell's limits (``perfbench/limits/<cell>.json``).

    python3 perfbench/calibrate.py --workload zamba2.train_4k \\
        --seeds 11,12,13 --control-seeds 21,22,23

On the card, at the cell's own size, in one process (the set-up is paid
once).  For each of ``--seeds`` the program's checked work, as a run of
the cell does it (train: the checked steps; prefill: the requests a run's
check samples from a window of ``--requests``), against the plain
reference: the lower readings.  For each of ``--control-seeds`` the
control, the reference in float8 in the program's place, and the faults a
cell of its kind can have, planted in the reference in the program's
place (train: half of each batch left out, the mean taken over the rest;
prefill: every token the program chose replaced by the next id).  A
state left unchanged reads 1 by the change's measure and needs no run.
One JSON line a reading.  ``--device cpu`` runs a small cell of a root
given by ``--root`` (the tests do).
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def train(ctx, seeds, control_seeds, emit) -> None:
    from perfbench.kinds import train as D
    from perfbench.lib.check import counted_leaves, leaf_gaps, train_readings

    def worst(got, ref):
        leaves = counted_leaves(ref["grad"])
        return {k: sorted(leaf_gaps(got[k], ref[k], leaves).items(), key=lambda kv: -kv[1])[:3]
                for k in ("grad", "change")}
    prog = D.Program(ctx)
    for s in seeds:
        prog.start(s)
        got = prog.checked_steps()
        prog.opt = prog.feed = None
        ref = D.reference(ctx, s)
        emit("program", s, train_readings(got, ref), loss=got["loss"], ref_loss=ref["loss"],
             worst=worst(got, ref))
    prog.free()
    half = ctx.traffic["batch"] // 2
    for s in control_seeds:
        ref = D.reference(ctx, s)
        ctl = D.reference(ctx, s, lower=True)
        emit("control", s, train_readings(ctl, ref), loss=ctl["loss"], ref_loss=ref["loss"],
             worst=worst(ctl, ref))
        emit("half_batch", s, train_readings(D.reference(ctx, s, rows=half), ref))


def prefill(ctx, seeds, control_seeds, requests, emit) -> None:
    from perfbench.kinds import prefill as D
    vocab = ctx.config["vocab_size"]
    prog = D.Program(ctx)
    picks = {}
    for s in seeds + control_seeds:
        sched = D.lengths(ctx.traffic, s, requests)
        picks[s] = [(i, sched[i]) for i in D.sample(s, sched, ctx.traffic["checked_requests"])]
    chosen = {}
    for s in seeds:
        prog.start(s)
        chosen[s] = [prog.request(D.prompt(s, i, n, vocab, ctx.device))[1] for i, n in picks[s]]
    prog.free()
    for s in seeds:
        p = D.reference_params(ctx, s)
        gaps = [D.reference_gap(ctx, p, D.prompt(s, i, n, vocab, ctx.device), tok)
                for (i, n), tok in zip(picks[s], chosen[s])]
        emit("program", s, {"logit_gap": max(gaps)}, requests=picks[s], gaps=gaps)
        if s == seeds[0]:
            shifted = [D.reference_gap(ctx, p, D.prompt(s, i, n, vocab, ctx.device),
                                       (tok + 1) % vocab) for (i, n), tok in zip(picks[s], chosen[s])]
            emit("token_altered", s, {"logit_gap": max(shifted)})
        del p
    for s in control_seeds:
        p = D.reference_params(ctx, s)
        gaps = [D.reference_gap(ctx, p, D.prompt(s, i, n, vocab, ctx.device), None, lower=True)
                for i, n in picks[s]]
        emit("control", s, {"logit_gap": max(gaps)}, requests=picks[s], gaps=gaps)
        del p


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--requests", type=int, default=240,
                    help="prefill: the window's requests the check samples from")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from perfbench.lib.harness import context
    ctx = context(args.workload, 0, 0, False, args.device, Path(args.root), T0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]

    def emit(who, seed, readings, **more):
        print(json.dumps({"workload": args.workload, "who": who, "seed": seed,
                          "readings": readings, **more,
                          "t": round(time.perf_counter() - T0, 1)}), flush=True)

    kind = ctx.traffic["kind"]
    if kind == "train":
        train(ctx, seeds, control, emit)
    elif kind == "prefill":
        prefill(ctx, seeds, control, args.requests, emit)
    else:
        raise ValueError(f"no calibration for the {kind} kind")
    return 0


if __name__ == "__main__":
    sys.exit(main())
