"""The harness on the CPU, on small cells made from temporary files: a
cell, a configuration (with its own reference and model count, and cut in
depth), a traffic mix and a per-layer metric are added as new files and
manifest entries alone; sound runs come out correct, and runs with the
timed path broken underneath come out not correct."""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from perfbench.lib import peaks
from perfbench.lib.harness import context, run_cell
from perfbench.lib.manifest import PKG, ROOT
from perfbench.metrics import mfu
from perfbench.tests import tiny

SEED = 2**31 + 977


def _tree_hash():
    h = hashlib.sha256()
    for p in sorted([ROOT / "BENCHMARK.json", *PKG.rglob("*.json"), *PKG.rglob("*.py")]):
        if "__pycache__" not in p.parts:
            h.update(p.as_posix().encode() + p.read_bytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    before = _tree_hash()
    r = tiny.make_root(tmp_path_factory.mktemp("bench"))
    yield r
    assert _tree_hash() == before, "a file of the repository was edited"


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_sound_runs_are_correct(root, cell):
    r = run_cell(cell, SEED, 0.2, False, "cpu", root)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    want = {"setup_s"} | ({"prefill_tokens_per_s", "prefill_ms_p95"} if "prefill" in cell
                          else {"train_tokens_per_s"})
    assert set(r["metrics"]) == want
    assert list(r)[-1] == "checks"


def test_traced_run_reads_the_new_metric(root):
    r = run_cell("tiny_hybrid.train", SEED, 0.2, True, "cpu", root)
    assert r["correct"]
    assert set(r["metrics"]) == {"mfu.train", "steps_traced"}     # nothing on the card to read
    assert r["metrics"]["steps_traced"]["value"] == 2.0
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_a_configuration_names_its_reference_and_count(root):
    """tiny_cut names ``tiny_ref``: its reference and its model count exist
    only under the temporary root, and the traced run's ``mfu.train`` is
    that count's."""
    ctx = context("tiny_cut.train", SEED, 0.2, True, "cpu", root)
    for mod in (ctx.family, ctx.count):
        assert Path(mod.__file__).resolve().is_relative_to(root.resolve()), mod.__file__
    assert ctx.mcfg.num_layers == 2
    ctx.family.CALLS.clear()
    r = run_cell("tiny_cut.train", SEED, 0.2, True, "cpu", root)
    assert r["correct"], r["checks"]
    assert ctx.family.CALLS == [(2, 16)] * 3            # the three checked steps' batches
    steps = 2 * ctx.count.train_step(ctx.config, 2, 16)
    assert r["metrics"]["mfu.train"]["value"] == pytest.approx(
        100.0 * steps / (r["device"]["window_s"] * peaks.MODEL_PEAK), rel=1e-12)
    family = context("tiny_hybrid.train", SEED, 0.2, True, "cpu", root)
    assert family.count.__name__ == "perfbench.counts.model"      # the family's, as before


def test_a_configuration_without_a_count_runs_traced(root):
    ctx = context("tiny_uncounted.train", SEED, 0.2, True, "cpu", root)
    assert ctx.count is None
    r = run_cell("tiny_uncounted.train", SEED, 0.2, True, "cpu", root)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"steps_traced"}
    assert mfu.read("mfu.train", SimpleNamespace(info={"flops": None}, window_s=1.0)) is None


def _unchanged_state(monkeypatch):
    import repro_torch.distributed.step as step

    def update(grads, state, params, **kw):
        return params, state, {"grad_norm": torch.zeros(())}
    monkeypatch.setattr(step, "adamw_update", update)


def _half_batch(monkeypatch):
    import repro_torch.distributed.step as step
    loss_fn = step.loss_fn

    def half(model, batch):
        rows = next(iter(batch.values())).shape[0] // 2
        return loss_fn(model, {k: v[:rows] for k, v in batch.items()})
    monkeypatch.setattr(step, "loss_fn", half)


def _token_altered(monkeypatch):
    import repro_torch.models.model as model
    forward = model.forward

    def altered(*args, **kwargs):
        logits, aux = forward(*args, **kwargs)
        return torch.roll(logits, 1, dims=-1), aux
    monkeypatch.setattr(model, "forward", altered)


@pytest.mark.parametrize("cell,fault", [
    ("tiny_hybrid.train", _unchanged_state), ("tiny_moe.train", _unchanged_state),
    ("tiny_hybrid.train", _half_batch), ("tiny_moe.train", _half_batch),
    ("tiny_hybrid.prefill", _token_altered)], ids=lambda v: getattr(v, "__name__", v))
def test_broken_timed_path_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = run_cell(cell, SEED, 0.2, False, "cpu", root)
    assert not r["correct"], r["checks"]


def test_no_card_no_result(tmp_path):
    """On a host without a card the command fails and prints no result; it
    never falls back to the CPU."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:         # a directory holding only BENCHMARK.json and perfbench/
            subprocess.run(["cp", "-r", str(ROOT / "BENCHMARK.json"), str(PKG), str(tmp_path)],
                           check=True)
        p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "granite.train_4k",
                            "--seed", "5", "--seconds", "1"], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout.strip() == "", p.stdout
        assert "no CUDA device" in p.stderr
