"""The reduction of the program's own spans (``lib/program.py``), the tool
that prints it (``perfbench/spans.py``) and the reader of the program's
counters (``metrics/expert_rows_filled.py``) on the CPU, on the small moe
cell (remat "full", capacity 1.25): every kernel of a step falls in a phase
and a span, the phases add up to the step, each layer has its forward,
recompute and backward, a reading raises where the program recorded spans
but not the one it needs, and a profile without device activity is read as
one only where the run asks for it."""
from __future__ import annotations

import json

import pytest
import torch

from perfbench import spans
from perfbench.lib import program as P
from perfbench.lib import trace as T
from perfbench.lib.harness import context, program_config, run_cell
from perfbench.lib.manifest import Manifest
from perfbench.tests import tiny

SEED = 2**31 + 1913


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench_program"))


@pytest.fixture(scope="module")
def profiled(root):
    """The raw events of a profile of two train steps of the small moe
    cell's program."""
    from repro_torch.distributed.step import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw_init
    cfg = program_config(Manifest(root).config("tiny_moe"))
    model = Model(cfg, "cpu").reset_parameters(torch.Generator().manual_seed(3))
    step = make_train_step(cfg, model)
    opt = adamw_init(dict(model.named_parameters()))
    ids = torch.randint(0, cfg.vocab_size, (2, 17), generator=torch.Generator().manual_seed(4))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(T.WINDOW):
            for _ in range(2):
                with torch.profiler.record_function(T.STEP):
                    opt, _ = step(opt, {"tokens": ids[:, :-1], "labels": ids[:, 1:]})
    return prof.profiler.kineto_results.events()


def test_every_kernel_of_a_step_falls_in_a_span(profiled):
    names, kernels, nodes, attributed, _ = P.attribute(profiled, on_cpu=True)
    assert {"repro.train.forward", "repro.train.backward", "repro.train.optimizer",
            "repro.block"} | set(P.LAYERS.values()) == names
    stepped = [k for k in kernels if k.phase is not None]
    assert stepped and all(k.span is not None and k.span.startswith(P.PROGRAM)
                           for k in stepped)
    parts = {(k.part, k.span) for k in stepped}
    for span in P.LAYERS.values():
        assert ("forward", span) in parts and ("backward", span) in parts, span
    for span in ("repro.attention", "repro.moe.dispatch", "repro.moe.experts"):
        assert ("recompute", span) in parts, span
    assert 0 < attributed < nodes                    # AccumulateGrad has no forward op


def test_phases_add_up_to_the_step(profiled):
    p = P.program_spans(profiled, on_cpu=True)
    phases = sum(p.busy_s[f"phase:{x}"] for x in ("forward", "backward", "optimizer"))
    assert phases == pytest.approx(p.busy_s["step"], rel=1e-9)
    assert 0 < p.busy_s["phase:recompute"] < p.busy_s["phase:backward"]
    spans_ = sum(v for g, v in p.busy_s.items() if g.startswith("span:"))
    assert spans_ == pytest.approx(p.busy_s["step"], rel=1e-9)
    _, kernels, _, _, _ = P.attribute(profiled, on_cpu=True)     # idle: the gaps between busy intervals
    merged = T._union([(k.start, k.end) for k in kernels])
    gaps = 1e-9 * (merged[-1][1] - merged[0][0] - sum(e - s for s, e in merged))
    assert sum(p.idle_s.values()) == pytest.approx(gaps, rel=1e-9)


def test_idle_is_named_by_the_program_span_where_no_aten_op_is_open():
    hosts = [(0, 100, "repro.train.backward"), (10, 20, "aten::mm"),
             (30, 60, "repro.moe.dispatch"), (40, 45, "cudaLaunchKernel"),
             (70, 80, "autograd::engine::evaluate_function: MmBackward0")]
    busy = [(0, 15), (18, 41), (50, 55), (75, 77), (120, 131), (140, 150)]
    assert P.idle_by_span(busy, hosts) == pytest.approx(
        {"aten::mm": 3e-9,                     # an aten op open: named by it
         "repro.moe.dispatch": 9e-9 + 20e-9,   # a launch or the span alone open: the span
         "repro.train.backward": 43e-9,        # the engine between nodes: the phase
         "(no host op)": 9e-9})


def test_no_program_span_no_reading():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert P.program_spans(prof.profiler.kineto_results.events(), on_cpu=True) is None


def test_no_device_activity_is_no_reading_unless_asked(profiled):
    with pytest.raises(RuntimeError, match="no device activity"):
        P.attribute(profiled)
    with pytest.raises(RuntimeError, match="no device activity"):
        P.program_spans(profiled)


def test_a_reading_raises_where_its_span_is_missing(profiled):
    p = P.program_spans(profiled, on_cpu=True)
    assert P.summary(p, 2, {})["span_coverage"] > 0
    p.names.discard("repro.moe.combine")
    with pytest.raises(KeyError, match="repro.moe.combine"):
        P.summary(p, 2, {})


def test_spans_tool_reads_the_small_moe_cell(root):
    out = spans.traced(context("tiny_moe.train", SEED, 0, True, "cpu", root))
    json.dumps(out)
    got = out["summary"]
    assert all(got[f"step_phase_ms.{p}"] > 0 for p in ("forward", "backward", "optimizer"))
    assert 0 < got["step_phase_ms.recompute"] < got["step_phase_ms.backward"]
    assert all(got[f"layer_ms.{layer}"] > 0 for layer in P.LAYERS)
    assert 0 < got["span_coverage"] <= 100
    assert 0 < got["expert_rows_filled"] < 100              # capacity 1.25 drops pairs
    cfg = program_config(Manifest(root).config("tiny_moe"))
    assert out["counters"]["moe.rows_computed"] % (2 * cfg.num_layers) == 0
    assert 0 < out["nodes_attributed"] < out["nodes"]


def _count_moe_alone():
    """The registry's ``moe.*`` counters taken out for the test's run (the
    process may have counted before), and a function that puts them back."""
    from repro_torch.core.telemetry import REGISTRY
    saved = {n: REGISTRY._counters.pop(n) for n in list(REGISTRY._counters) if n.startswith("moe.")}

    def restore():
        for n in [n for n in REGISTRY._counters if n.startswith("moe.")]:
            del REGISTRY._counters[n]
        REGISTRY._counters.update(saved)
    return restore


def test_traced_run_reads_the_rows_filled(root):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"] if m["name"] == "expert_rows_filled.train")
    entry["workloads"] = entry["workloads"] + ["tiny_moe.train"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    from perfbench.metrics import expert_rows_filled
    from repro_torch.core.telemetry import REGISTRY
    restore = _count_moe_alone()
    try:
        assert expert_rows_filled.read("expert_rows_filled.train", None) is None
        r = run_cell("tiny_moe.train", SEED, 0.2, False, "cpu", root)      # untraced: no count
        assert REGISTRY.counter_values("moe.") == {} and "expert_rows_filled.train" \
            not in r["metrics"]
        r = run_cell("tiny_moe.train", SEED, 0.2, True, "cpu", root)
        counts = REGISTRY.counter_values("moe.")
    finally:
        restore()
    assert r["correct"]
    cfg = program_config(Manifest(root).config("tiny_moe"))
    steps = json.loads((root / "perfbench/traffic/train_tiny.json").read_text())["trace_steps"]
    assert counts["moe.rows_computed"] % (steps * cfg.num_layers) == 0
    got = r["metrics"]["expert_rows_filled.train"]
    assert got["unit"] == "%"
    assert got["value"] == pytest.approx(100 * counts["moe.rows_filled"] /
                                         counts["moe.rows_computed"])
    assert 0 < got["value"] < 100                             # capacity 1.25 drops pairs
