"""Decode attention at smollm_360m's serve shapes, and the device time of
smollm_360m's decode step at full width, on one GPU.

    python3 tools/decode_bench.py [--src PATH]

``--src`` is the ``src`` directory of the checkout to measure (default this
checkout's), so that two checkouts compare in one call: run them in turns
(older, newer, newer, older).  Times ``ops.decode_attention`` (B 8, Hq 15,
Hkv 5, D 64, bf16) at S 128 with every row full (the serve's last step), at
S 1024 with ragged lengths and at S 8192 full, beside SDPA and the bytes
bound (``chip_smoke.time_ms``: CUDA events, L2 flushed).  Then profiles
eight decode steps of smollm_360m (batch 8, a 128-position cache, steps at
positions 64-71 after 64 unprofiled ones) and prints the step's wall time,
its device busy time and the decode kernel's part of it
(``chip_smoke.busy_share``).  Prints the card's name and power limit first.

Imports nothing of JAX.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src directory to measure")
    src = Path(ap.parse_args().src).resolve()
    if not torch.cuda.is_available():
        raise SystemExit("decode_bench: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import torch.nn.functional as F

    from chip_smoke import bound, busy_share, time_ms
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import decode_step, init_cache, init_params
    import repro_torch
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"measuring {Path(repro_torch.__file__).parent}")
    g = torch.Generator(device="cuda").manual_seed(2)
    b, hq, hkv, d, dt = 8, 15, 5, 64, torch.bfloat16
    for s, ragged in ((128, False), (1024, True), (8192, False)):
        q = torch.randn(b, hq, d, generator=g, device="cuda").to(dt)
        k = torch.randn(b, hkv, s, d, generator=g, device="cuda").to(dt)
        v = torch.randn(b, hkv, s, d, generator=g, device="cuda").to(dt)
        length = (torch.randint(1, s + 1, (b,), generator=g, device="cuda", dtype=torch.int32)
                  if ragged else torch.full((b,), s, dtype=torch.int32, device="cuda"))
        mask = (torch.arange(s, device="cuda")[None, :] < length[:, None])[:, None, None, :]
        n_valid = int(length.sum())
        bms, by = bound(2 * n_valid * hkv * d * 2 + 2 * b * hq * d * 2 + 4 * b,
                        4.0 * n_valid * hq * d, dt)
        err = (ops.decode_attention(q, k, v, length=length).float()
               - ref.decode_attention(q, k, v, length=length).float()).abs().max().item()
        ms = time_ms(lambda: ops.decode_attention(q, k, v, length=length))
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], k, v,
                                                              attn_mask=mask, enable_gqa=True))
        print(f"decode_attention B{b} S{s} {'ragged' if ragged else 'full'}: {ms:.4f} ms "
              f"({bms / ms:.3f} of the bound), sdpa {sdpa:.4f} ms, bound {bms:.5f} ms ({by}), "
              f"max abs err vs plain {err:.3g}")
        del q, k, v, mask
    cfg = get_config("smollm_360m")
    model = init_params(cfg, seed=0, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (b, 72)))
    tokens = tokens.cuda()
    cache = init_cache(cfg, b, 128, device="cuda")

    def step(t: int) -> None:
        decode_step(model, cache, tokens[:, t], torch.full((b,), t, dtype=torch.long,
                                                           device="cuda"))
    for t in range(64):
        step(t)
    torch.cuda.synchronize()
    busy_share(lambda: [step(t) for t in range(64, 72)], 8,
               "smollm_360m decode step (batch 8, positions 64-71 of a 128 cache)",
               "decode_kernel")


if __name__ == "__main__":
    main()
