"""The sLSTM recurrence on one GPU: its kernels against the plain loop, and
xlstm_1_3b's train step and forward, wall and busy.

    python3 tools/slstm_bench.py [--src PATH] [--kernels] [--model] [--reps N]

``--kernels`` (the kernels of ``--src``) builds ``csrc/slstm.cu``, prints
ptxas's registers and spills for each of its kernels (and fails on a
spill), runs ``chip_smoke``'s check of them against the plain versions
(``slstm_vs_plain``: the forward bit-equal, the backward within
``SLSTM_BWD_RTOL``, at this checkout's ``SLSTM_SHAPES``) and its timed rows
(``slstm_rows``: each call against its bound and the plain loop), then
each kernel's share of a call (``torch.profiler``).  ``--model`` times
xlstm_1_3b at full width and depth (bf16, seeded random weights): the train step (8 x 256 of
``SyntheticLM``, remat "full", through ``make_train_step``) and the forward
(2 x 512), each as ``chip_smoke.busy_share`` measures it: the median wall
of ``--reps`` unprofiled runs after a warm-up, then the device busy time of
one profiled run, and prints them as one JSON line.  ``--src`` is the
``src`` directory of the checkout to measure (default this checkout's), so
that two checkouts compare in one call: run them in turns (older, newer,
newer, older), one process each.  Prints the card's name and power limit
first.

Imports nothing of JAX.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def kernels() -> None:
    from chip_smoke import ptxas_entries, slstm_rows, slstm_vs_plain
    from repro_torch.kernels import _build
    _build.build(["slstm"])
    entries = ptxas_entries(_build.log_path("slstm").read_text(), "slstm_")
    for name, (regs, spill) in entries.items():
        print(f"ptxas {name}: {regs} registers, {spill} bytes spilled")
    spills = [name for name, (_, spill) in entries.items() if spill]
    if not entries or spills:
        raise SystemExit(f"slstm_bench: no kernel entry found, or spills in {spills}")
    g = torch.Generator(device="cuda").manual_seed(11)
    fwd_err, bwd_err = slstm_vs_plain(g)
    rows = slstm_rows(g, {"slstm": fwd_err, "slstm_bwd": bwd_err},
                      {"slstm": 0, "slstm_bwd": 0})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"passes_us": passes()}))


def passes(reps: int = 20) -> dict:
    """Device time of each kernel of a call (``torch.profiler``, the mean of
    ``reps`` calls, L2 flushed before each): the forward at xlstm's 2 x 512
    and 8 x 256, the backward at 8 x 256, in us."""
    import re
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import SLEEP_CYCLES, SLSTM_SHAPES, slstm_inputs
    from repro_torch.kernels import slstm as slstm_mod
    g = torch.Generator(device="cuda").manual_seed(12)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {}
    for label, direction in (("forward", "fwd"), ("train", "fwd"), ("train", "bwd")):
        b, s, h, hd = SLSTM_SHAPES[label]
        z, i, f, o = slstm_inputs(g, b, s, h, hd)
        dy = torch.randn(b, s, h, hd, generator=g, device="cuda")
        c, n = slstm_mod._forward(z, i, f, o, save=True)[1]
        call = ((lambda: slstm_mod._forward(z, i, f, o, save=False)) if direction == "fwd"
                else (lambda: slstm_mod.scan_backward(z, i, f, o, dy, c, n)))
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                torch.cuda._sleep(SLEEP_CYCLES)
                call()
            torch.cuda.synchronize()
        us = {}
        for e in prof.events():
            m = re.search(r"slstm_\w+?_kernel", e.name)
            if m:
                us[m.group(0)] = us.get(m.group(0), 0.0) + e.time_range.elapsed_us() / reps
        key = f"{direction} B{b} S{s} H{h} hd{hd}"
        out[key] = us
        print(f"slstm passes, {key}: " + ", ".join(f"{k} {v:.2f} us" for k, v in us.items()))
    return out


def model(reps: int) -> dict:
    """xlstm_1_3b's train step and forward at full size: wall (median of
    ``reps``) and busy ms."""
    from chip_smoke import TRAIN_B, TRAIN_LR, TRAIN_S, busy_share
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticLM, make_device_batch
    from repro_torch.distributed.step import make_train_step
    from repro_torch.launch import train as train_mod
    from repro_torch.models import forward, init_params
    from repro_torch.optim import adamw_init
    cfg = get_config("xlstm_1_3b")
    m = init_params(cfg, seed=0, device="cuda")
    out = {}
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 512)))
    tokens = tokens.cuda()
    out["forward"] = busy_share(lambda: forward(m, tokens=tokens), 1, "xlstm_1_3b forward 2 x 512",
                                ("ssm_scan_", "slstm_"), reps=reps)
    ds = SyntheticLM(cfg, ShapeConfig("train", TRAIN_S, TRAIN_B, "train"), seed=0)
    step_fn = make_train_step(cfg, m, peak_lr=TRAIN_LR, warmup=train_mod.WARMUP, total_steps=16)
    holder = {"opt": adamw_init(dict(m.named_parameters()), cfg.optim_state_dtype,
                                cfg.optim_second_dtype), "i": 0}

    def step():
        holder["opt"], _ = step_fn(holder["opt"], make_device_batch(ds.batch_at(holder["i"]),
                                                                    "cuda"))
        holder["i"] += 1
    out["train"] = busy_share(step, 1, "xlstm_1_3b train step 8 x 256", ("ssm_scan_", "slstm_"),
                              reps=reps)
    for v in out.values():
        v.pop("top", None)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src directory to measure")
    ap.add_argument("--kernels", action="store_true", help="check and time the kernels")
    ap.add_argument("--model", action="store_true", help="time xlstm's train step and forward")
    ap.add_argument("--reps", type=int, default=3, help="unprofiled runs a wall median takes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("slstm_bench: needs a CUDA device")
    src = Path(args.src).resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import repro_torch
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"measuring {Path(repro_torch.__file__).parent}")
    if args.kernels:
        kernels()
    if args.model:
        print(json.dumps({"src": str(src), **model(args.reps)}))


if __name__ == "__main__":
    main()
