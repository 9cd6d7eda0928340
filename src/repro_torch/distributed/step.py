"""The train step of the port (``repro.distributed.step.make_train_step``
on one card, without shardings).

loss -> backward -> global-norm clip -> AdamW with the cosine learning rate;
every metric a 0-d device tensor, so a step never waits for the device.  On
the card attention's forward and backward run on the flash kernels
(``kernels.ops.attention`` under autograd).  The families whose card path
reaches a kernel without a backward yet cannot train.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, loss_fn
from repro_torch.optim import AdamWState, adamw_update, cosine_schedule

# family -> the kernel of its path that has no backward yet
NO_BACKWARD = {"moe": "grouped_matmul", "hybrid": "ssm_scan", "ssm": "ssm_scan"}

Metrics = Dict[str, torch.Tensor]


def make_train_step(cfg: ModelConfig, model: Model, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000
                    ) -> Callable[[AdamWState, Dict[str, torch.Tensor]], Tuple[AdamWState, Metrics]]:
    """``step(opt, batch) -> (opt, metrics)``: one optimiser step of
    ``model`` (its parameters updated in place, made trainable here) on
    ``batch``; metrics ``loss``, ``aux``, ``ppl_log``, ``grad_norm``, ``lr``.

    Raises ``NotImplementedError`` for a family whose path has a kernel
    without a backward (ROADMAP Queue 1 item 8, next slice), on any device."""
    if cfg.family in NO_BACKWARD:
        raise NotImplementedError(
            f"training the {cfg.family} family needs a backward of the "
            f"{NO_BACKWARD[cfg.family]} kernel, which is not ported yet "
            "(ROADMAP Queue 1 item 8: the moe, hybrid and ssm families)")
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def step(opt: AdamWState, batch: Dict[str, torch.Tensor]) -> Tuple[AdamWState, Metrics]:
        total, metrics = loss_fn(model, batch)
        total.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        lr = cosine_schedule(opt.step, peak_lr=peak_lr, warmup=warmup, total=total_steps)
        _, opt, om = adamw_update(grads, opt, params, lr=lr)
        for p in params.values():
            p.grad = None
        metrics = dict(metrics)
        metrics.update(om)
        metrics["lr"] = lr
        return opt, metrics

    return step
