"""The train step of the port (``repro.distributed.step.make_train_step``
on one card, without shardings).

loss -> backward -> global-norm clip -> AdamW with the cosine learning rate;
every metric a 0-d device tensor, so a step never waits for the device.  On
the card every family's gradient runs on the port's kernels (``kernels.ops``
under autograd), each block recomputed in the backward under remat "full":

* dense: attention's forward and backward on the flash kernels
  (``FlashAttention``);
* moe (granite_moe_1b): the flash kernels, and the experts' grouped
  matmuls forward and backward (dX and dW) on ``csrc/grouped_matmul.cu``
  (``GroupedMatmul``);
* hybrid (zamba2_1_2b): the Mamba2 scan forward and backward on
  ``csrc/ssm_scan.cu`` and the decay-gradient kernel ``csrc/ssm_scan_bwd.cu``
  (``SsmScan``), and the shared attention block's flash kernels;
* ssm (xlstm_1_3b): both mLSTM scans (y and the normaliser) on the same
  scan kernels; the sLSTM is plain PyTorch, as the reference's ``lax.scan``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, loss_fn
from repro_torch.optim import AdamWState, adamw_update, cosine_schedule

Metrics = Dict[str, torch.Tensor]


def make_train_step(cfg: ModelConfig, model: Model, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000
                    ) -> Callable[[AdamWState, Dict[str, torch.Tensor]], Tuple[AdamWState, Metrics]]:
    """``step(opt, batch) -> (opt, metrics)``: one optimiser step of
    ``model`` (its parameters updated in place, made trainable here) on
    ``batch``; metrics ``loss``, ``aux``, ``ppl_log``, ``grad_norm``, ``lr``.
    Every family trains; the module docstring lists the kernels each one's
    gradient runs on."""
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
