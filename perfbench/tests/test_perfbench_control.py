"""The control of the comparison, at a size a test run holds: the plain
reference in float8 in the program's place has to read worse than the
program on a number the cell compares, on the small bfloat16 cells, as it
does on the card at the cells' own sizes (``perfbench/calibrate.py``,
PERF.md's limits)."""
from __future__ import annotations

import io
import json
from contextlib import redirect_stdout

import pytest

from perfbench import calibrate
from perfbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench16"), dtype="bfloat16",
                          param_dtype="bfloat16")


def readings(root, cell, seeds, control, requests=None):
    buf = io.StringIO()
    args = ["--workload", cell, "--seeds", seeds, "--control-seeds", control,
            "--device", "cpu", "--root", str(root)]
    if requests:
        args += ["--requests", str(requests)]
    with redirect_stdout(buf):
        assert calibrate.main(args) == 0
    out = {}
    for line in buf.getvalue().splitlines():
        row = json.loads(line)
        out.setdefault(row["who"], []).append(row["readings"])
    return out


@pytest.mark.parametrize("cell,key", [("tiny_moe.train", "grad_gap"),
                                      ("tiny_hybrid.prefill", "logit_gap")])
def test_control_reads_worse_than_the_program(root, cell, key):
    r = readings(root, cell, "101,102", "103,104", requests=8 if "prefill" in cell else None)
    worst_program = max(x[key] for x in r["program"])
    assert min(x[key] for x in r["control"]) > worst_program
    faults = r.get("half_batch", []) + r.get("token_altered", [])
    assert faults and min(x[key] for x in faults) > worst_program
