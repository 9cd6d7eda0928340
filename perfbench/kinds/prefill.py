"""The ``prefill`` traffic kind: a closed loop of one client
sending one prompt at a time through the program's batched prefill
(``repro_torch.models.model.forward`` under ``torch.no_grad()``, the
one-card path of ``make_prefill_step``), and taking the greedy token at
every position of the logits it returns.

Prompt lengths come in cycles: each cycle holds every length of the
traffic's ``cycle`` as often as it says, shuffled by ``--seed``.  Request
i's token ids are uniform over the vocabulary, drawn from a generator
seeded with the seed and i, so any request can be drawn again.  Set-up
warms every length of the cycle up once.  A request is timed from its
dispatch to its logits being ready on the card; the window ends with the
first cycle that completes after ``--seconds``, so that every window
holds whole cycles, the same lengths whatever the seed.  With ``--trace 1`` the
window is ``trace_requests`` requests under the profiler instead.

The check: the longest request of the window and ``checked_requests - 1``
others drawn by the seed, each run again through the plain reference; the
reading is the widest gap by which the reference's logit of a token the
program chose lies below the reference's best at that position.
"""
from __future__ import annotations

import gc
import random
import statistics
import time
from typing import List

import torch

from perfbench.lib import trace as T
from perfbench.lib.harness import log
from perfbench.lib import weights
from perfbench.reference import common as C

PROMPT_STREAM = 0x9000_0000
WARM_STREAM = 0x7000_0000


def lengths(tr: dict, seed: int, n: int) -> List[int]:
    """The first n prompt lengths of the seed's schedule."""
    cycle = [length for length, times in tr["cycle"] for _ in range(times)]
    out: List[int] = []
    k = 0
    while len(out) < n:
        c = list(cycle)
        random.Random(seed * 1_000_003 + k).shuffle(c)
        out += c
        k += 1
    return out[:n]


def prompt(seed: int, i: int, length: int, vocab: int, device, stream: int = PROMPT_STREAM):
    g = weights.generator(seed, stream + i, device)
    return torch.randint(0, vocab, (1, length), generator=g, device=device)


class Program:
    def __init__(self, ctx):
        from repro_torch.models.model import Model
        self.ctx = ctx
        self.model = Model(ctx.mcfg, ctx.device)
        self.specs = ctx.family.param_specs(ctx.config)

    def start(self, seed: int) -> None:
        weights.load_into(self.model, self.specs, self.ctx.config, seed)

    @torch.no_grad()
    def request(self, tokens: torch.Tensor):
        """(the event marking the logits ready, the greedy tokens (S,))."""
        from repro_torch.models.model import forward
        logits, _ = forward(self.model, tokens=tokens)
        ready = torch.cuda.Event() if torch.cuda.is_available() else None
        if ready is not None:
            ready.record()
        return ready, logits[0].argmax(dim=-1)

    def free(self) -> None:
        self.__dict__.pop("model", None)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@torch.no_grad()
def reference_params(ctx, seed: int):
    return weights.reference_params(ctx.family.param_specs(ctx.config), ctx.config, seed,
                                    ctx.device)


@torch.no_grad()
def reference_gap(ctx, p, tokens: torch.Tensor, chosen, lower: bool = False,
                  rows: int = 2048) -> float:
    """The widest gap by which the reference's logit of a chosen token lies
    below its best, over every position of ``tokens`` (1, S).  ``p``: the
    reference's weights; ``lower``: the float8 control chooses the tokens
    (``chosen`` is not read)."""
    x, _ = ctx.family.hidden(p, tokens, ctx.config)
    x = x[0]
    if lower:
        with C.lower_precision():
            xl, _ = ctx.family.hidden(p, tokens, ctx.config)
        xl = xl[0]
    gap = 0.0
    for r0 in range(0, x.shape[0], rows):
        lg = C.logits(p, x[r0:r0 + rows], ctx.config)
        pick = (C.logits(p, xl[r0:r0 + rows], ctx.config).argmax(-1) if lower
                else chosen[r0:r0 + rows].long())
        if (pick >= lg.shape[-1]).any():
            return float("inf")
        g = lg.max(dim=-1).values - lg.gather(-1, pick[:, None])[:, 0]
        gap = max(gap, float(g.max()))
    return gap


def sample(seed: int, lens: List[int], k: int) -> List[int]:
    """The longest request of the window (the first of that length) and k - 1
    others drawn by the seed."""
    longest = lens.index(max(lens))
    rest = [i for i in range(len(lens)) if i != longest]
    return [longest] + random.Random(seed ^ 0x5A5A).sample(rest, min(k - 1, len(rest)))


def run(ctx) -> dict:
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    vocab = cfg["vocab_size"]
    prog = Program(ctx)
    prog.start(ctx.seed)
    log(ctx, "weights loaded")
    warm = sorted({length for length, _ in tr["cycle"]})
    for j, length in enumerate(warm):
        prog.request(prompt(ctx.seed, j, length, vocab, dev, WARM_STREAM))
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    log(ctx, "every length warmed up")
    out = {"e2e": {"setup_s": setup_s}, "trace": None}
    # enough of the schedule for any window: fifty requests a second at most
    sched = lengths(tr, ctx.seed, int(ctx.seconds * 50) + 64)
    chosen, lats = [], []

    def serve(i: int):
        tokens = prompt(ctx.seed, i, sched[i], vocab, dev)
        t0 = time.perf_counter()
        ready, tok = prog.request(tokens)
        if ready is not None:
            ready.synchronize()
        lats.append(time.perf_counter() - t0)
        chosen.append(tok)

    if not ctx.trace:
        per_cycle = sum(times for _, times in tr["cycle"])
        _sync(dev)
        t0 = time.perf_counter()
        i = 0
        while True:
            serve(i)
            i += 1
            if (time.perf_counter() - t0 >= ctx.seconds and i % per_cycle == 0) \
                    or i == len(sched):
                break
        _sync(dev)
        window = time.perf_counter() - t0
        n = i
        by_len = {}
        for length, lat in zip(sched, lats):
            by_len.setdefault(length, []).append(lat)
        log(ctx, "median ms by length: " + ", ".join(
            f"{length} x{len(v)} {1e3 * statistics.median(v):.2f}" for length, v in sorted(by_len.items())))
        out["e2e"]["prefill_tokens_per_s"] = sum(sched[:n]) / window
        out["e2e"]["prefill_ms_p95"] = 1e3 * statistics.quantiles(lats, n=20)[18] \
            if n >= 2 else 1e3 * lats[0]
    else:
        n = tr["trace_requests"]

        def window() -> int:
            for i in range(n):
                with torch.profiler.record_function(T.STEP):
                    serve(i)
            _sync(dev)
            return n
        trace = T.run_traced(window, ctx.spans)
        trace.info = {"flops": sum(ctx.count.prefill(cfg, 1, s) for s in sched[:n])
                      if ctx.count else None}
        out["trace"] = trace
    out.update(attempted=n, failed=0)
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if torch.cuda.is_available() \
        else 0
    prog.free()
    del prog
    log(ctx, "window closed")
    picked = sample(ctx.seed, sched[:n], tr["checked_requests"])
    p = reference_params(ctx, ctx.seed)
    gap = 0.0
    for i in picked:
        tokens = prompt(ctx.seed, i, sched[i], vocab, dev)
        gap = max(gap, reference_gap(ctx, p, tokens, chosen[i]))
    del p
    log(ctx, "reference run")
    out["readings"] = {"logit_gap": gap}
    out["checked"] = {"requests": [[i, sched[i]] for i in picked]}
    return out
