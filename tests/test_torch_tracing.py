"""The train path's spans and counters (``repro_torch.core.telemetry``) on
the CPU: a small moe model under remat "full", traced by ``torch.profiler``.

The spans are ``record_function`` ranges while the profiler records and the
shared no-op otherwise; they change no number of the step.  Each autograd
node of the backward carries the sequence number and thread of the forward
op it differentiates, so it is put down to the innermost ``repro.*`` span
around that op; the remat's re-run opens its ``repro.block`` again inside
the backward.  The MoE's counters count the rows its grouped matmuls run
and those that hold a kept (token, choice) pair, once per layer and step.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, reduced
from repro_torch.core import telemetry
from repro_torch.distributed.step import make_train_step
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import Model
from repro_torch.optim import adamw_init

SPANS = {"repro.train.forward", "repro.train.backward", "repro.train.optimizer",
         "repro.block", "repro.attention", "repro.moe.dispatch", "repro.moe.experts",
         "repro.moe.combine", "repro.loss"}
LAYERS, STEPS, BATCH, SEQ = 2, 2, 2, 16
BACKWARD_FUNCTION = 1           # the profiler's RecordScope of an autograd node


def _cfg(capacity_factor=1.25):
    return dataclasses.replace(reduced(get_config("granite_moe_1b")), num_layers=LAYERS,
                               d_model=64, d_ff=64, vocab_size=256, head_dim=16,
                               remat="full", capacity_factor=capacity_factor)


def _train(cfg, traced: bool, steps: int = STEPS):
    """(losses, parameters after ``steps``, the profile or None)."""
    torch.manual_seed(0)
    model = Model(cfg, "cpu").reset_parameters(torch.Generator().manual_seed(1))
    step = make_train_step(cfg, model, peak_lr=1e-2, warmup=1)
    opt = adamw_init(dict(model.named_parameters()))
    g = torch.Generator().manual_seed(2)
    batches = [torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), generator=g)
               for _ in range(steps)]
    losses, prof = [], None

    def run():
        nonlocal opt
        for ids in batches:
            opt, metrics = step(opt, {"tokens": ids[:, :-1], "labels": ids[:, 1:]})
            losses.append(metrics["loss"])
    if traced:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
    else:
        run()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return losses, params, prof


@pytest.fixture(scope="module")
def traced():
    return _train(_cfg(), traced=True)


def _innermost_span(e):
    while e is not None:
        if e.name.startswith("repro."):
            return e.name
        e = e.cpu_parent
    return None


def test_every_span_is_recorded(traced):
    events = traced[2].events()
    names = {e.name for e in events if e.name.startswith("repro.")}
    assert names == SPANS
    count = {n: sum(e.name == n for e in events) for n in SPANS}
    assert count["repro.train.forward"] == count["repro.train.optimizer"] == STEPS
    assert count["repro.attention"] == count["repro.moe.dispatch"] == 2 * LAYERS * STEPS
    assert count["repro.loss"] == 2 * STEPS         # the unembedding, and the loss itself


def test_recompute_blocks_lie_inside_the_backward(traced):
    events = traced[2].events()
    backward = [e.time_range for e in events if e.name == "repro.train.backward"]
    blocks = [e for e in events if e.name == "repro.block"]
    inside = [b for b in blocks
              if any(r.start <= b.time_range.start and b.time_range.end <= r.end
                     for r in backward)]
    assert len(blocks) == 2 * LAYERS * STEPS and len(inside) == LAYERS * STEPS
    for b in inside:                    # the re-run's layers nest in it again
        assert {c.name for c in b.cpu_children} >= {"repro.attention", "repro.moe.dispatch",
                                                     "repro.moe.experts", "repro.moe.combine"}


def test_every_backward_node_is_put_down_to_a_span(traced):
    """A node with a sequence number finds its forward op (on the node's
    forward thread, the latest with its number, or with the number below
    it: an in-place op on a view takes the number after its own node's for
    the ``CopySlices`` around it) inside a span; only nodes without a
    number (``AccumulateGrad``) are left unattributed."""
    events = traced[2].events()
    forward = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.sequence_nr >= 0 and e.scope != BACKWARD_FUNCTION and not e.fwd_thread:
            forward[(e.sequence_nr, e.thread)] = e
    nodes = [e for e in events if e.scope == BACKWARD_FUNCTION]
    attributed, unattributed = [], []
    for n in nodes:
        below = [s for s, t in forward if t == n.fwd_thread and 0 <= s <= n.sequence_nr]
        op = forward[(max(below), n.fwd_thread)] if below else None
        span = _innermost_span(op) if op is not None else None
        (attributed if span else unattributed).append((n.name, span))
    assert len(attributed) + len(unattributed) == len(nodes) > 0
    assert {name for name, _ in unattributed} == {"torch::autograd::AccumulateGrad"}
    spans = {span for _, span in attributed}
    assert {"repro.attention", "repro.moe.dispatch", "repro.moe.experts",
            "repro.moe.combine", "repro.loss"} <= spans
    experts = {name for name, span in attributed if span == "repro.moe.experts"}
    assert "GroupedMatmulBackward" in experts
    copies = {span for name, span in attributed if name == "torch::autograd::CopySlices"}
    assert copies == {"repro.loss"}     # the unembedding's fill of the padded columns


def test_spans_are_no_ops_without_a_sink(monkeypatch):
    monkeypatch.delenv("POM_TRACE", raising=False)
    assert telemetry.session() is None and not telemetry.on()
    assert telemetry.span("repro.block") is telemetry._NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert telemetry.on()
        sp = telemetry.span("repro.block")
        assert sp is not telemetry._NULL_SPAN and sp
    assert telemetry.span("repro.block") is telemetry._NULL_SPAN


def test_tracing_changes_no_number(traced):
    losses, params, _ = _train(_cfg(), traced=False)
    for a, b in zip(losses, traced[0]):
        assert torch.equal(a, b)
    for n, p in params.items():
        assert torch.equal(p, traced[1][n]), n


def _routes(monkeypatch):
    """Records every ``route`` call's expert ids (forward runs and re-runs)."""
    seen = []
    route = moe_mod.route

    def recording(p, xf, cfg):
        out = route(p, xf, cfg)
        seen.append(out[2].clone())
        return out
    monkeypatch.setattr(moe_mod, "route", recording)
    return seen


@pytest.mark.parametrize("capacity_factor", [0.5, 2.0], ids=["dropping", "dropless"])
def test_counters_match_the_routes(monkeypatch, capacity_factor):
    cfg = _cfg(capacity_factor)
    seen = _routes(monkeypatch)
    before = telemetry.REGISTRY.counter_values("moe.")
    _train(cfg, traced=False)
    assert telemetry.REGISTRY.counter_values("moe.") == before      # no sink, no count
    seen.clear()
    _train(cfg, traced=True)
    after = telemetry.REGISTRY.counter_values("moe.")
    counted = {n: v - before.get(n, 0) for n, v in after.items()}
    tokens, e, k = BATCH * SEQ, cfg.num_experts, cfg.experts_per_token
    cap = moe_mod.capacity(tokens, cfg)
    assert len(seen) == 2 * LAYERS * STEPS          # each layer's forward and re-run
    forward_runs = [ids for s in range(STEPS) for ids in seen[2 * LAYERS * s:][:LAYERS]]
    filled = sum(int(torch.clamp(torch.bincount(ids.reshape(-1), minlength=e), max=cap).sum())
                 for ids in forward_runs)
    assert counted["moe.rows_computed"] == STEPS * LAYERS * e * cap
    assert counted["moe.rows_filled"] == filled
    if capacity_factor >= e / k:
        assert cap >= tokens and filled == STEPS * LAYERS * tokens * k
    else:
        assert filled < STEPS * LAYERS * tokens * k


def test_counter_takes_device_sums():
    reg = telemetry.Registry()
    c = reg.counter("moe.rows_filled")
    c.inc(3)
    c.inc(torch.tensor(4))
    c.inc(torch.tensor(5))
    assert c.pending is not None
    assert reg.counter_values("moe.") == {"moe.rows_filled": 12} and c.pending is None
    c.inc(torch.tensor(1))
    assert c.value == 13 and reg.snapshot()["counters"] == {"moe.rows_filled": 13}
