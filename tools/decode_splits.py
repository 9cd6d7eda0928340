"""Decode attention at every split count, and the f32 matmul's routes, on one GPU.

    python3 tools/decode_splits.py

Times ``decode_attention`` forced to 1-8 splits (CUDA events, L2 flushed:
``chip_smoke.time_ms``) at the decode shapes of smollm_360m (Hq 15 / Hkv
5), granite_moe_1b (16 / 8) and zamba2_1_2b (32 / 32), batch 8, D 64, bf16,
every row full, at S 64, 128, 1024 and 8192, beside the schedule's choice,
SDPA and the bytes bound; the clusters of each size the card holds at once
(3 heads a CTA); then the f32 matmul at 4096^3 on the ring, on the
CUDA-core tile (128, 128, 16) and as ``torch.matmul``.  This is the
measurement behind ``autotune.pom_decode_schedule``.

Imports nothing of JAX.  Exits non-zero without a card.
"""
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("decode_splits: needs a CUDA device")
    from chip_smoke import bound, time_ms
    from repro_torch.kernels import autotune
    from repro_torch.kernels import decode_attention as dm
    from repro_torch.kernels import matmul_pom as mm
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    for (b, hq, hkv, d) in ((8, 15, 5, 64), (8, 16, 8, 64), (8, 32, 32, 64)):
        for s in (64, 128, 1024, 8192):
            q = torch.randn(b, hq, d, generator=g, device="cuda").to(dt)
            k = torch.randn(b, hkv, s, d, generator=g, device="cuda").to(dt)
            v = torch.randn(b, hkv, s, d, generator=g, device="cuda").to(dt)
            length = torch.full((b,), s, dtype=torch.int32, device="cuda")
            mask = (torch.arange(s, device="cuda")[None, :] < length[:, None])[:, None, None, :]
            byts = 2 * b * s * hkv * d * 2 + 2 * b * hq * d * 2
            bms, _ = bound(byts, 4.0 * b * s * hq * d, dt)
            sch = autotune.pom_decode_schedule(b * hkv, s, hq // hkv, d, 2)
            t = {n: time_ms(lambda n=n: dm.decode_attention(q, k, v, length=length, splits=n),
                            iters=50) for n in range(1, 9)}
            sd = time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], k, v,
                                                                attn_mask=mask, enable_gqa=True),
                         iters=50)
            print(f"B{b} Hq{hq} Hkv{hkv} S{s}: sched {sch.splits}; "
                  + " ".join(f"{n}:{x:.4f}" for n, x in t.items())
                  + f" sdpa {sd:.4f} bound {bms:.5f}", flush=True)
    print("clusters", {n: dm.max_active_clusters(64, 3, n, dt) for n in range(1, 9)})
    n = 4096
    x = torch.randn(n, n, generator=g, device="cuda")
    y = torch.randn(n, n, generator=g, device="cuda")
    print("ring", time_ms(lambda: mm.matmul(x, y, route="ring"), iters=20, warmup=2),
          "old", time_ms(lambda: mm.matmul(x, y, bm=128, bn=128, bk=16), iters=20, warmup=2),
          "torch", time_ms(lambda: torch.matmul(x, y), iters=20, warmup=2),
          "ring", time_ms(lambda: mm.matmul(x, y, route="ring"), iters=20, warmup=2))


if __name__ == "__main__":
    main()
