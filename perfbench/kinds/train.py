"""The ``train`` traffic kind: the program's one-card train step
(``repro_torch.distributed.step.make_train_step``) dispatched back to back.

Set-up builds the step with its model and AdamW state, loads the seeded
weights, and runs the first ``checked_steps`` steps through the same call
and feed as the window: they warm every shape up and are the steps the
reference follows.  The window then runs steps until ``--seconds`` have
passed on the host clock, synchronizes, and reports every token of every
step over the window's wall time.  With ``--trace 1`` the window is
``trace_steps`` steps under the profiler instead.

The feed: token ids uniform over the vocabulary, a fresh (batch, seq + 1)
draw a step from a generator on the device seeded with ``--seed``; tokens
are its first ``seq`` columns and labels the next-token shift.
"""
from __future__ import annotations

import contextlib
import gc
import inspect
import math
import time
from typing import Dict, List

import torch

from perfbench.lib import trace as T
from perfbench.lib.harness import log
from perfbench.lib import weights
from perfbench.reference import common as C

DATA_STREAM = 0xDA7A


class Feed:
    def __init__(self, seed: int, batch: int, seq: int, vocab: int, device, rows=None):
        self.g = weights.generator(seed, DATA_STREAM, device)
        self.shape, self.vocab, self.device, self.rows = (batch, seq + 1), vocab, device, rows

    def next(self) -> Dict[str, torch.Tensor]:
        ids = torch.randint(0, self.vocab, self.shape, generator=self.g, device=self.device)
        if self.rows is not None:
            ids = ids[:self.rows]
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def cosine_lr(step: int, tr: dict) -> float:
    """The trainer's schedule: linear warmup to ``peak_lr``, then a cosine
    to a tenth of it at ``total_steps``; ``step`` the updates made so far."""
    peak, warm, total = tr["peak_lr"], tr["warmup"], tr["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * t)))


def _norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack([tensors[n].float().norm() for n in names]).mul(scale).cpu().tolist()
    return dict(zip(names, vals))


def _check_optimizer(tr: dict) -> None:
    """The traffic states AdamW's settings; the program's step takes its
    optimizer's defaults, which have to be those."""
    from repro_torch.optim import adamw_update
    sig = inspect.signature(adamw_update).parameters
    for key, want in tr["adamw"].items():
        have = sig[key].default
        if have != want:
            raise RuntimeError(f"the program's AdamW {key} is {have}, the traffic states {want}")


class Program:
    """The step, its model and optimizer state, and the feed: one object
    from set-up through the window."""

    def __init__(self, ctx):
        from repro_torch.distributed.step import make_train_step
        from repro_torch.models.model import Model
        from repro_torch.optim import adamw_init
        tr = ctx.traffic
        _check_optimizer(tr)
        self.ctx = ctx
        self.model = Model(ctx.mcfg, ctx.device)
        self.specs = ctx.family.param_specs(ctx.config)
        self.step_fn = make_train_step(ctx.mcfg, self.model, peak_lr=tr["peak_lr"],
                                       warmup=tr["warmup"], total_steps=tr["total_steps"])
        self.params = dict(self.model.named_parameters())
        self.opt_init = lambda: adamw_init(self.params, ctx.mcfg.optim_state_dtype,
                                           ctx.mcfg.optim_second_dtype)

    def start(self, seed: int) -> None:
        ctx = self.ctx
        weights.load_into(self.model, self.specs, ctx.config, seed)
        self.opt = self.opt_init()
        self.feed = Feed(seed, ctx.traffic["batch"], ctx.traffic["seq"],
                         ctx.config["vocab_size"], ctx.device)

    def step(self):
        self.opt, metrics = self.step_fn(self.opt, self.feed.next())
        return metrics["loss"]

    def checked_steps(self) -> dict:
        """Runs the checked steps; the readings the reference is held to."""
        tr = self.ctx.traffic
        start = {n: p.detach().to("cpu", copy=True) for n, p in self.params.items()}
        losses, grad = [], None
        for i in range(tr["checked_steps"]):
            losses.append(self.step())
            if i == 0:      # AdamW's first moment after one step is (1 - b1) g
                grad = _norms({n: self.opt.m[n] for n in self.params},
                              1.0 / (1.0 - tr["adamw"]["b1"]))
        change = {}
        for n, p in self.params.items():
            change[n] = (p.detach().float() - start[n].to(p.device).float()).norm()
        change = dict(zip(change, torch.stack(list(change.values())).cpu().tolist()))
        return {"loss": [float(x) for x in losses], "grad": grad, "change": change}

    def free(self) -> None:
        for name in ("opt", "feed", "step_fn", "params", "model"):
            self.__dict__.pop(name, None)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def reference(ctx, seed: int, lower: bool = False, rows=None) -> dict:
    """The plain reference's checked steps on the same weights and batches:
    float32 (``lower``: float8 projections, the control), the parameters
    stored in their configured dtype after each update; ``rows`` keeps
    only the first rows of each batch (a fault)."""
    cfg, tr = ctx.config, ctx.traffic
    specs = ctx.family.param_specs(cfg)
    dtypes = {n: weights.DTYPES[d] for n, _, d in specs}
    p = weights.reference_params(specs, cfg, seed, ctx.device, requires_grad=True)
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    a = tr["adamw"]
    feed = Feed(seed, tr["batch"], tr["seq"], cfg["vocab_size"], ctx.device, rows=rows)
    losses, grad = [], None
    numerics = C.lower_precision if lower else contextlib.nullcontext
    for i in range(tr["checked_steps"]):
        batch = feed.next()
        with numerics():
            x, aux = ctx.family.hidden(p, batch["tokens"], cfg)
            loss = C.next_token_loss(p, x, batch["labels"], cfg)
            (loss + 0.01 * aux).backward()
        del x, aux
        with torch.no_grad():
            for t in p.values():
                if t.grad is None:
                    t.grad = torch.zeros_like(t)
            gn = torch.sqrt(sum(torch.sum(t.grad * t.grad) for t in p.values()))
            scale = torch.clamp(a["max_grad_norm"] / torch.clamp(gn, min=1e-12), max=1.0)
            for t in p.values():
                t.grad.mul_(scale)
            if i == 0:
                grad = _norms({n: t.grad for n, t in p.items()})
            lr, k = cosine_lr(i, tr), i + 1
            for n, t in p.items():
                g = t.grad
                m[n].mul_(a["b1"]).add_((1 - a["b1"]) * g)
                v[n].mul_(a["b2"]).add_((1 - a["b2"]) * g * g)
                mh = m[n] / (1 - a["b1"] ** k)
                vh = v[n] / (1 - a["b2"] ** k)
                delta = mh / (torch.sqrt(vh) + a["eps"]) + a["weight_decay"] * t
                t.copy_((t - lr * delta).to(dtypes[n]).float())
                t.grad = None
        losses.append(float(loss.detach()))
    with torch.no_grad():
        change = {n: (p[n] - t0.float()).norm() for n, t0 in weights.draw(specs, cfg, seed,
                                                                           ctx.device)}
        change = dict(zip(change, torch.stack(list(change.values())).cpu().tolist()))
    del p, m, v
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"loss": losses, "grad": grad, "change": change}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(ctx) -> dict:
    tr = ctx.traffic
    prog = Program(ctx)
    log(ctx, "model built")
    prog.start(ctx.seed)
    log(ctx, "weights loaded")
    checked = prog.checked_steps()
    _sync(ctx.device)
    log(ctx, "checked steps run")
    setup_s = time.perf_counter() - ctx.t0
    tokens = tr["batch"] * tr["seq"]
    out = {"e2e": {"setup_s": setup_s}, "trace": None}
    if not ctx.trace:
        losses: List[torch.Tensor] = []
        _sync(ctx.device)
        t0 = time.perf_counter()
        while True:
            losses.append(prog.step())
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        _sync(ctx.device)
        window = time.perf_counter() - t0
        out["e2e"]["train_tokens_per_s"] = len(losses) * tokens / window
        out["attempted"] = len(losses)
        out["failed"] = int((~torch.isfinite(torch.stack(losses))).sum())
    else:
        n = tr["trace_steps"]

        def window() -> int:
            for _ in range(n):
                with torch.profiler.record_function(T.STEP):
                    prog.step()
            _sync(ctx.device)
            return n
        trace = T.run_traced(window, ctx.spans)
        trace.info = {"flops": n * ctx.count.train_step(ctx.config, tr["batch"], tr["seq"])
                      if ctx.count else None}
        out.update(trace=trace, attempted=n, failed=0)
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if torch.cuda.is_available() \
        else 0
    prog.free()
    del prog
    log(ctx, "window closed")
    out["program"] = checked
    out["reference"] = reference(ctx, ctx.seed)
    log(ctx, "reference run")
    from perfbench.lib.check import train_readings
    out["readings"] = train_readings(checked, out["reference"])
    return out
