#!/usr/bin/env python3
"""Runs one cell of the benchmark of the PyTorch and CUDA port.

    python3 perfbench/run.py --workload zamba2.train_4k --seed 7 --seconds 30 --trace 0

From the root of a checkout, on a machine with the cards the cell asks
for.  Prints the checks (each number compared, beside its limit) as the
last lines of standard error and one JSON line, the result, as the last
line of standard output.  Exits non-zero and prints no result where there
is no card (or fewer than the cell asks for), where the program is missing,
and where JAX or the JAX package is loaded in this process once the window
has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".perfbench_cache"

# the program's build and kernel caches live in the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
# keep libraries from loading JAX or Flax by themselves
os.environ.update(USE_FLAX="0", USE_JAX="0", USE_TF="0")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def fail(msg: str, code: int = 2) -> int:
    print(f"perfbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is False); the benchmark "
                    "measures the card only and does not run on the CPU")
    from perfbench.lib.manifest import Manifest
    try:
        cell = Manifest(ROOT).cell(args.workload)
    except (OSError, KeyError) as e:
        return fail(f"cannot find the cell: {e}")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{args.workload} needs {cell['chips']} cards, this machine has "
                    f"{torch.cuda.device_count()}")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        return fail(f"the program (src/repro_torch) cannot be imported: {e}")
    from perfbench.lib.guard import forbidden_modules
    from perfbench.lib.harness import run_cell
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      ROOT, T0)
    bad = forbidden_modules()
    if bad:
        return fail(f"loaded in this process after the window: {', '.join(bad)}", 3)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
