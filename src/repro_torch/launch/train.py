"""Training entry point of the port: data -> train steps -> checkpoints -> heartbeats.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced --steps 4
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.train --device cpu --reduced --mesh 2x2 --steps 4

The port of ``repro.launch.train``: deterministic resume from the latest
checkpoint, async checkpointing every ``--ckpt-every`` steps and a blocking
one at the end, heartbeats and straggler checks, ``result.json``.  Runs on
``cuda`` unless ``--device cpu`` is given, at the model's full width unless
``--reduced`` is given (the reference's ``--reduced`` is on by default,
ROADMAP Queue 3 item 1).  Weights are random (seed 0) and data is
``SyntheticLM``.  ``--mesh 1x1`` (the default) trains in one process with
the one-card step; ``--mesh DxM`` runs under torchrun with D x M processes
(NCCL on ``cuda``, gloo on ``cpu``), each holding its shards of the
reference's specs (``ParallelConfig()``: FSDP and ZeRO-1 over ``data``,
tensor parallelism over ``model``).  The checkpoint holds whole arrays, so
a run resumes on any mesh (elastic: save at 2x2, resume at 4x1).

A checkpoint is labelled with the number of steps it holds, and a resumed
run starts at that step, so resuming repeats no batch (the reference labels
its periodic checkpoints one short, ROADMAP Queue 3 item 10).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import (ARCH_IDS, ModelConfig, ParallelConfig, ShapeConfig,
                                      get_config, reduced)
from repro_torch.data import SyntheticLM, make_device_batch
from repro_torch.distributed.ft import Heartbeat, check_workers
from repro_torch.distributed.sharding import MeshContext
from repro_torch.distributed.step import init_opt_state, make_train_step, place_params
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import init_params
from repro_torch.models.model import Model
from repro_torch.optim import AdamWState, adamw_init

WARMUP = 20        # the reference's warmup steps


@dataclass
class TrainResult:
    start: int                           # the step the run began at (> 0: resumed)
    steps: int                           # the step it ended at
    losses: List[float] = field(default_factory=list)   # one a step run, from ``start``
    grad_norms: List[float] = field(default_factory=list)
    wall_s: float = 0.0                  # the loop's time, saves included
    model: Optional[Model] = None
    opt: Optional[AdamWState] = None
    shardings: Optional[dict] = None     # sharded: the state's (``train_state``'s tree)

    @property
    def final_loss(self) -> Optional[float]:
        return self.losses[-1] if self.losses else None


def train_state(model: Model, opt: AdamWState) -> dict:
    """What a checkpoint holds: the parameters and the AdamW state."""
    return {"params": dict(model.named_parameters()), "opt": opt}


@torch.no_grad()
def load_train_state(model: Model, state: dict) -> AdamWState:
    """Copies restored parameters into ``model``; returns the restored AdamW
    state."""
    params = dict(model.named_parameters())
    for name, t in state["params"].items():
        params[name].copy_(t)
    return state["opt"]


def train(cfg: ModelConfig, *, steps: int, batch: int = 8, seq: int = 256, lr: float = 3e-3,
          workdir: str, ckpt_every: int = 50, log_every: int = 10, host_id: int = 0,
          device="cuda", keep: int = 3, stop_after: Optional[int] = None,
          log: Callable[[str], None] = print, mesh=None) -> TrainResult:
    """The training loop.  Resumes from the latest checkpoint under
    ``workdir/ckpt``; checkpoints after every ``ckpt_every``-th step (labelled
    with the steps done) and, blocking, at ``steps``.  ``stop_after`` ends the
    loop once that many steps are done and checkpointed, as a crash there
    would (no final save, no result.json).  ``mesh`` (a ``DeviceMesh`` or
    ``MeshContext``): every rank calls this, trains its shards and logs
    nothing but rank 0 (``device`` is then the mesh's)."""
    mc = mesh if mesh is None or isinstance(mesh, MeshContext) else MeshContext(mesh)
    rank = mc.index(mc.axis_names) if mc is not None else 0
    if rank:
        log = _quiet
    device = mc.device if mc is not None else resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    mgr = CheckpointManager(os.path.join(workdir, "ckpt"), keep=keep)
    hb = Heartbeat(workdir, host_id + rank)
    ds = SyntheticLM(cfg, ShapeConfig("train", seq, batch, "train"), seed=0)
    model = init_params(cfg, seed=0, device=device)
    if mc is None:
        one_card = make_train_step(cfg, model, peak_lr=lr, warmup=WARMUP, total_steps=steps)
        opt = adamw_init(dict(model.named_parameters()), cfg.optim_state_dtype,
                         cfg.optim_second_dtype)
        place, state_sh = device, None

        def step_fn(model, opt, b):
            return (model,) + one_card(opt, b)
    else:
        step_fn, (param_sh, opt_sh, place) = make_train_step(
            cfg, ParallelConfig(), mc, peak_lr=lr, warmup=WARMUP, total_steps=steps)
        place_params(model, param_sh)
        opt = init_opt_state(model, opt_sh, cfg)
        state_sh = {"params": param_sh, "opt": opt_sh}

    start = 0
    try:
        state, start = mgr.restore(train_state(model, opt), shardings=state_sh)
        opt = load_train_state(model, state)
        log(f"resumed from step {start}" + (f" (mesh {_mesh_str(mc)})" if mc else ""))
    except FileNotFoundError:
        log("fresh start")

    losses, gnorms = [], []
    t0 = time.time()
    for step in range(start, steps):
        model, opt, metrics = step_fn(model, opt, make_device_batch(ds.batch_at(step), place))
        losses.append(metrics["loss"])
        gnorms.append(metrics["grad_norm"])
        if step % log_every == 0 or step == steps - 1:
            log(f"step {step:5d}  loss {float(metrics['loss']):.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  "
                f"lr {float(metrics['lr']):.2e}  {time.time() - t0:.1f}s")
            hb.beat(step)
            stragglers = [w for w in check_workers(workdir) if w.state != "healthy"]
            if stragglers:
                log(f"  [ft] degraded workers: {[(w.host, w.state) for w in stragglers]}")
        done = step + 1
        if done % ckpt_every == 0 and done < steps:
            mgr.save(train_state(model, opt), done, shardings=state_sh)
        if stop_after is not None and done >= stop_after:
            mgr.wait()
            return TrainResult(start, done, _floats(losses), _floats(gnorms),
                               time.time() - t0, model, opt, state_sh)
    if start < steps:
        mgr.save(train_state(model, opt), steps, block=True, shardings=state_sh)
    res = TrainResult(start, steps, _floats(losses), _floats(gnorms), time.time() - t0,
                      model, opt, state_sh)
    log(f"done: {steps} steps, final loss "
        + ("n/a (no step run)" if res.final_loss is None else f"{res.final_loss:.4f}"))
    if not rank:
        with open(os.path.join(workdir, "result.json"), "w") as f:
            json.dump({"final_loss": res.final_loss, "steps": steps}, f)
    return res


def _quiet(msg: str) -> None:
    """The log of every rank but 0."""


def _mesh_str(mc: MeshContext) -> str:
    return "x".join(str(n) for n in mc.shape.values())


def _floats(ts: List[torch.Tensor]) -> List[float]:
    """0-d tensors to floats with one transfer (one wait for the device)."""
    return torch.stack(ts).cpu().tolist() if ts else []


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL; other than 1x1 under torchrun with DATA*MODEL processes")
    ap.add_argument("--reduced", action="store_true", help="train the reduced config")
    ap.add_argument("--full-size", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> TrainResult:
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, remat="none" if args.reduced else cfg.remat)
    d, m = (int(x) for x in args.mesh.split("x"))
    mesh = None if (d, m) == (1, 1) else make_mesh((d, m), ("data", "model"), args.device)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                 workdir=args.workdir, ckpt_every=args.ckpt_every, log_every=args.log_every,
                 host_id=args.host_id, device=args.device, mesh=mesh)


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
