"""Loss curves of smollm_360m's training loop on the card, at several peak
learning rates, on the kernels and on their plain versions.

    python3 tools/train_probe.py [--steps 30] [--lrs 3e-3,1e-3,3e-4]
                                 [--plain 3e-3] [--out curves.json]

Each run is ``repro_torch.launch.train.train`` at full width (batch 8 x 256
of ``SyntheticLM``, seeded weights, warmup 20 steps, no checkpoints but the
final one, in a temporary directory this script deletes).  ``--plain``
names the rates also run inside ``ops.plain_versions()``, so the kernels'
curve can be held against the plain one.  Prints, per run, the mean loss of
the first and the last 5 steps and every step's loss, with the card's name
and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lrs", default="3e-3,1e-3,3e-4")
    ap.add_argument("--plain", default="3e-3", help="rates also run on the plain versions")
    ap.add_argument("--out", default=None, help="write the curves here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_probe: needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    cfg = get_config("smollm_360m")
    runs = [(f"kernels {lr}", float(lr), False) for lr in args.lrs.split(",") if lr]
    runs += [(f"plain {lr}", float(lr), True) for lr in args.plain.split(",") if lr]
    out = {}
    for label, lr, plain in runs:
        root = tempfile.mkdtemp(prefix="train_probe_")
        try:
            with ops.plain_versions() if plain else contextlib.nullcontext():
                res = train_mod.train(cfg, steps=args.steps, lr=lr, workdir=root,
                                      ckpt_every=args.steps + 1, log_every=args.steps + 1,
                                      keep=1, log=lambda s: None)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        first, last = sum(res.losses[:5]) / 5, sum(res.losses[-5:]) / 5
        out[label] = {"losses": res.losses, "grad_norms": res.grad_norms,
                      "first5": first, "last5": last, "wall_s": res.wall_s}
        print(f"{label}: mean loss of the first 5 steps {first:.4f}, of the last 5 {last:.4f} "
              f"({'falls' if last < first else 'rises'}); {res.wall_s:.1f} s", flush=True)
        print("  " + " ".join(f"{x:.4f}" for x in res.losses), flush=True)
        del res
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
