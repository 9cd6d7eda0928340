"""``launch/train.py`` for the moe, hybrid and ssm families, end to end on
the CPU: a run, a resume from its checkpoint and a straight run of the same
steps, each a subprocess of the reduced config.

These three tests make nine subprocess runs (up to 300 s each), so they
live in a file of their own: ``pytest-xdist --dist loadfile`` then gives
them a worker of their own instead of queueing them behind the families'
JAX comparisons in ``tests/test_torch_train_families.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.checkpoint import latest_step

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["granite_moe_1b", "zamba2_1_2b", "xlstm_1_3b"]


def _train_cli(arch, workdir, steps):
    """``python -m repro_torch.launch.train --device cpu --reduced --arch
    arch`` in a subprocess with one CPU thread (the multithreaded CPU
    kernels differ from run to run in the last bit of f32 sums)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--reduced",
         "--arch", arch, "--steps", str(steps), "--batch", "2", "--seq", "32",
         "--log-every", "1", "--ckpt-every", "2", "--workdir", str(workdir)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    losses = {int(ln.split()[1]): ln.split()[3] for ln in out.stdout.splitlines()
              if ln.startswith("step ")}
    return out.stdout, losses


@pytest.mark.parametrize("arch", ARCHS)
def test_family_train_cli_resumes_bit_for_bit(arch, tmp_path):
    """``launch/train.py --reduced --arch`` trains the family: 3 steps
    (checkpoints at 2 and 3), then a resume to 4 in the same work dir, print
    the losses of 4 steps straight (all finite)."""
    out3, first = _train_cli(arch, tmp_path / "a", 3)
    out4, second = _train_cli(arch, tmp_path / "a", 4)
    _, straight = _train_cli(arch, tmp_path / "b", 4)
    assert "fresh start" in out3 and "resumed from step 3" in out4
    assert sorted(first) == [0, 1, 2] and sorted(second) == [3]
    assert {**first, **second} == straight
    assert all(np.isfinite(float(v)) for v in straight.values())
    assert latest_step(str(tmp_path / "a" / "ckpt")) == 4
