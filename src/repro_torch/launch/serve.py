"""Serving entry point of the port: batched prefill + greedy decode with a KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \\
      --batch 8 --prompt-len 64 --gen 64
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.serve --device cpu --reduced --mesh 2x2

Every family serves (dense, audio, vlm, moe, hybrid, ssm).  Runs on
``cuda`` unless ``--device cpu`` is given, at the model's full width unless
``--reduced`` is given; a configuration whose weights alone exceed the
card's memory (qwen2_72b, llama4_maverick_400b on one H100) is refused
before anything is allocated.  Weights and prompts are random, seeded.
``--mesh DxM`` other than 1x1 runs under torchrun with D x M processes and
decodes through ``distributed.step.make_decode_step``: each rank serves its
batch shard with its shards of the weights and the cache, and gathers the
vocab-sharded logits over ``model`` to pick the next token.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ARCH_IDS, ParallelConfig, get_config, reduced
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import MeshContext
from repro_torch.distributed.step import init_sharded_cache, make_decode_step, place_params
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import decode_step, init_cache, init_params
from repro_torch.models.model import Model


@dataclass
class ServeResult:
    tokens: torch.Tensor                 # (B, gen) generated token ids
    prefill_s: float
    decode_s: float
    logits: Optional[torch.Tensor] = None  # (B, prompt + gen - 1, Vpad) if kept

    def tokens_per_s(self, batch: int, prompt_len: int, gen: int):
        return (batch * prompt_len / max(self.prefill_s, 1e-9),
                batch * (gen - 1) / max(self.decode_s, 1e-9))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def serve(model: Model, prompts: torch.Tensor, gen: int, *,
          keep_logits: bool = False, mesh=None) -> ServeResult:
    """Teacher-forced prefill of ``prompts`` (B, P) through ``decode_step``,
    then ``gen`` greedy tokens, as the JAX package's ``serve.py`` does.

    ``keep_logits`` keeps every step's logits (prefill and generation) for
    comparison.  ``mesh`` (a ``DeviceMesh`` or ``MeshContext``): the step of
    ``make_decode_step`` on this rank's shards (``model``, whole, is cut to
    them in place); the result holds this rank's batch rows."""
    if gen < 1:
        raise ValueError("gen must be at least 1")
    b, pl = prompts.shape
    if mesh is None:
        device = model.device
        cache = init_cache(model.cfg, b, pl + gen, device=device)

        def decode(tok, pos):
            return decode_step(model, cache, tok, pos)[0]
    else:
        mc = mesh if isinstance(mesh, MeshContext) else MeshContext(mesh)
        device = mc.device
        serve_step, (param_sh, cache_sh, tok_sh) = make_decode_step(
            model.cfg, ParallelConfig(), mc, b, pl + gen)
        place_params(model, param_sh)
        cache = init_sharded_cache(model.cfg, b, pl + gen, cache_sh)
        prompts = tok_sh.local_slice(prompts)
        b = prompts.shape[0]

        def decode(tok, pos):
            logits = serve_step(model, cache, tok, pos)[0]
            return C.all_gather(logits, 1, mc.group("model")) if "model" in mc.shape else logits
    prompts = prompts.to(device)
    kept = []

    def step(tok, t):
        logits = decode(tok, torch.full((b,), t, dtype=torch.long, device=device))
        if keep_logits:
            kept.append(logits)
        return logits

    _sync(device)
    t0 = time.perf_counter()
    for t in range(pl):
        logits = step(prompts[:, t], t)
    tok = torch.argmax(logits, dim=-1)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for t in range(pl, pl + gen - 1):
        tok = torch.argmax(step(tok, t), dim=-1)
        out.append(tok)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return ServeResult(torch.stack(out, dim=1), prefill_s, decode_s,
                       torch.stack(kept, dim=1) if keep_logits else None)


def check_fits(cfg, device: torch.device) -> None:
    """Raises ``ValueError`` when the weights alone exceed the card's memory
    (also on a mesh: each rank makes the weights whole before it cuts them)."""
    if device.type != "cuda":
        return
    need = cfg.param_count() * torch.empty((), dtype=getattr(torch, cfg.param_dtype)).element_size()
    have = torch.cuda.get_device_properties(device).total_memory
    if need > have:
        raise ValueError(f"{cfg.name}: {need / 2**30:.1f} GiB of weights do not fit the "
                         f"{have / 2**30:.1f} GiB of {torch.cuda.get_device_name(device)}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--reduced", action="store_true", help="serve the reduced config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL; other than 1x1 under torchrun with DATA*MODEL processes")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced(get_config(args.arch)) if args.reduced else get_config(args.arch)
    b, pl, g = args.batch, args.prompt_len, args.gen
    d, m = (int(x) for x in args.mesh.split("x"))
    mesh = None if (d, m) == (1, 1) else make_mesh((d, m), ("data", "model"), device)
    check_fits(cfg, device)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, pl)))
    model = init_params(cfg, seed=0, device=device)
    res = serve(model, prompts, g, mesh=mesh)
    if mesh is not None and torch.distributed.get_rank():
        return res
    pre_tps, dec_tps = res.tokens_per_s(b, pl, g)
    gen = res.tokens.cpu().numpy()
    print(f"arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
          f"device={device} batch={b} prompt={pl} gen={g} mesh={args.mesh}")
    print(f"prefill: {res.prefill_s:.3f}s ({pre_tps:.0f} tok/s)")
    print(f"decode:  {res.decode_s:.3f}s ({dec_tps:.0f} tok/s)")
    print("sample generations (token ids):")
    for i in range(min(b, 2)):
        print(f"  [{i}]", gen[i, :16].tolist())
    return res


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
