"""Flash attention on one GPU: the forward at smollm_360m's forward and
training shapes, and, where the checkout has them, the forward with its lse
and the backward.

    python3 tools/flash_bench.py [--src PATH]

``--src`` is the ``src`` directory of the checkout to measure (default this
checkout's), so that two checkouts compare in one call: run them in turns
(older, newer, newer, older).  Times ``ops.attention`` (bf16, Hq 15, Hkv 5,
D 64, causal; B 4 x S 512 and B 8 x S 256) with ``chip_smoke.time_ms``
(CUDA events, L2 flushed, 100 calls); then ``flash_attention(...,
return_lse=True)`` and ``flash_attention_backward`` (on its route and on the
CUDA cores) at both shapes if the checkout defines them.  Prints the card's
name and power limit first.

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
    hq, hkv, d, dt = 15, 5, 64, torch.bfloat16
    for b, s in ((4, 512), (8, 256)):
        q = torch.randn(b, hq, s, d, generator=g, device="cuda").to(dt)
        k = torch.randn(b, hkv, s, d, generator=g, device="cuda").to(dt)
        v = torch.randn(b, hkv, s, d, generator=g, device="cuda").to(dt)
        line = f"B {b} S {s}: forward {time_ms(lambda: ops.attention(q, k, v)):.5f} ms"
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
        print(line, flush=True)


if __name__ == "__main__":
    main()
