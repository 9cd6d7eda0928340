"""Flash attention on one GPU: the forward at smollm_360m's forward and
training shapes, and, where the checkout has them, the forward with its lse
and the backward.

    python3 tools/flash_bench.py [--src PATH]

``--src`` is the ``src`` directory of the checkout to measure (default this
checkout's), so that two checkouts compare in one call: run them in turns
(older, newer, newer, older).  Times ``ops.attention`` (bf16, D 64, causal)
with ``chip_smoke.time_ms`` (CUDA events, L2 flushed, 100 calls) at
smollm_360m's forward (B 4 x S 512, Hq 15, Hkv 5) and at the training
shapes (B 8 x S 256) of smollm_360m (15 / 5), granite_moe_1b (16 / 8) and
zamba2_1_2b (32 / 32); then ``flash_attention(..., return_lse=True)`` and
``flash_attention_backward`` (on its route and on the CUDA cores) if the
checkout defines them, and at the training shapes the backward's time by
kernel (``torch.profiler``) and SDPA's backward alone on the same inputs.
Prints the card's name and power limit first.

Imports nothing of JAX.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src directory to measure")
    src = Path(ap.parse_args().src).resolve()
    if not torch.cuda.is_available():
        raise SystemExit("flash_bench: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    from chip_smoke import time_ms
    from repro_torch.kernels import flash_attention as fm
    from repro_torch.kernels import ops
    import repro_torch
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"measuring {Path(repro_torch.__file__).parent}")
    g = torch.Generator(device="cuda").manual_seed(2)
    d, dt = 64, torch.bfloat16
    for b, s, hq, hkv in ((4, 512, 15, 5), (8, 256, 15, 5), (8, 256, 16, 8), (8, 256, 32, 32)):
        q = torch.randn(b, hq, s, d, generator=g, device="cuda").to(dt)
        k = torch.randn(b, hkv, s, d, generator=g, device="cuda").to(dt)
        v = torch.randn(b, hkv, s, d, generator=g, device="cuda").to(dt)
        fwd_ms = time_ms(lambda: ops.attention(q, k, v))
        line = f"B {b} S {s} Hq {hq} Hkv {hkv}: forward {fwd_ms:.5f} ms"
        if hasattr(fm, "flash_attention_backward"):
            do = torch.randn(b, hq, s, d, generator=g, device="cuda").to(dt)
            o, lse = fm.flash_attention(q, k, v, return_lse=True)
            lse_ms = time_ms(lambda: fm.flash_attention(q, k, v, return_lse=True))
            bwd_ms = time_ms(lambda: fm.flash_attention_backward(q, k, v, o, lse, do))
            line += f", with lse {lse_ms:.5f} ms, backward {bwd_ms:.5f} ms"
            if hasattr(fm, "launches_bwd_tc"):
                cc_ms = time_ms(lambda: fm.flash_attention_backward(q, k, v, o, lse, do,
                                                                    route="cuda_cores"))
                line += f" (CUDA-core route {cc_ms:.5f} ms)"
            if s == 256:
                from scan_bench import by_kernel
                line += (" [by kernel: " + by_kernel(
                    lambda: fm.flash_attention_backward(q, k, v, o, lse, do)) + "]")
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                out = torch.nn.functional.scaled_dot_product_attention(
                    *leaves, is_causal=True, enable_gqa=True)
                sdpa_ms = time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
                line += f", SDPA backward alone {sdpa_ms:.5f} ms"
        print(line, flush=True)


if __name__ == "__main__":
    main()
