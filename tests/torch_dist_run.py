"""Launching ``tests/torch_dist_checks.py`` under torchrun, for the port's
distribution tests: gloo processes on a free localhost port, a time limit
on every run."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def torchrun(args, nproc: int = 4, module: bool = False):
    """Runs ``args`` under torchrun with ``nproc`` gloo processes on a free
    port; returns the completed process."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
           "--master-addr", "localhost", "--master-port", str(free_port())]
    cmd += (["-m"] if module else []) + list(args)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT,
                          env=env)


def run_checks(checks: str, args: dict) -> dict:
    """``tests/torch_dist_checks.py`` in 4 processes: {check: its report}."""
    r = torchrun([str(ROOT / "tests" / "torch_dist_checks.py"), checks, json.dumps(args)])
    assert r.returncode == 0, f"{checks} failed:\n{r.stdout[-4000:]}\n{r.stderr[-6000:]}"
    out = {}
    for line in r.stdout.splitlines():
        if line.startswith("{"):
            out.update(json.loads(line))
    for check in checks.split(","):
        assert f"OK {check}" in r.stdout, r.stdout
    return out
