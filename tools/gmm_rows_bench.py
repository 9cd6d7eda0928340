"""The grouped matmul's forward at granite_moe_1b's training shape, dense
and with row counts, on one GPU.

    python3 tools/gmm_rows_bench.py [--src PATH]

At 8 x 4,096 tokens with dropless routing (E 32 experts, top 8, cap 32,768
slots an expert) the MoE layer runs three forward grouped matmuls: (E, cap,
1024) @ (E, 1024, 512) for wi and wg, and (E, cap, 512) @ (E, 512, 1024)
for wo, each at the tile ``ops`` picks.  The row counts are filled as the
cell's routing fills them: 262,144 (token, choice) pairs over the 32
experts, drawn uniformly from a fixed seed (~8,192 an expert).  For each
product it prints the dense call's time (no counts, on an x whose rows past
the counts are zero) and, where the grouped matmul takes row counts, the
time of the call with them (on an x that holds NaN past the counts), both
by CUDA events with the L2 flushed (``chip_smoke.time_ms``), the live
tiles' share, and whether the two outputs are bit-equal (it exits non-zero
where they are not).  ``--src`` is the ``src`` directory of the checkout to
measure (default this one's), so that two checkouts are timed in one call.

Imports nothing of JAX.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import inspect
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
E, CAP, K = 32, 32768, 8
# the products of one MoE layer's forward, (d, f) of x (E, cap, d) @ w (E, d, f)
PRODUCTS = (("wi, wg", 1024, 512), ("wo", 512, 1024))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src directory to measure")
    src = Path(ap.parse_args().src).resolve()
    if not torch.cuda.is_available():
        raise SystemExit("gmm_rows_bench: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    from chip_smoke import time_ms
    from repro_torch.kernels import autotune
    from repro_torch.kernels import grouped_matmul as gmm
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), f"src {src}")
    takes_rows = "rows" in inspect.signature(gmm.grouped_matmul).parameters
    g = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, E, (CAP * K,), generator=g, device="cuda")
    rows = torch.bincount(ids, minlength=E).clamp_(max=CAP).int()
    live = torch.arange(CAP, device="cuda")[None, :, None] < rows[:, None, None]
    print(f"rows: min {int(rows.min())}, max {int(rows.max())}, mean {rows.float().mean():.1f} "
          f"of cap {CAP}")
    for name, d, f in PRODUCTS:
        x = torch.randn(E, CAP, d, generator=g, device="cuda").bfloat16()
        w = (torch.randn(E, d, f, generator=g, device="cuda") * d ** -0.5).bfloat16()
        xz = torch.where(live, x, torch.zeros((), dtype=x.dtype, device="cuda"))
        del x
        tile = gmm.pom_tile(xz, w)
        dense = time_ms(lambda: gmm.grouped_matmul(xz, w, **tile), iters=20, warmup=3)
        line = f"grouped_matmul {name} E{E} cap{CAP} d{d} f{f} bf16 {tile}: dense {dense:.4f} ms"
        if takes_rows:
            xn = torch.where(live, xz, torch.full((), float("nan"), dtype=xz.dtype,
                                                  device="cuda"))
            same = torch.equal(gmm.grouped_matmul(xn, w, rows, **tile),
                               gmm.grouped_matmul(xz, w, **tile))
            counted = time_ms(lambda: gmm.grouped_matmul(xn, w, rows, **tile), iters=20,
                              warmup=3)
            bm, bn = tile["tile"][:2] if "tile" in tile else (tile["bm"], autotune.GMM_BN)
            run = int(((rows + bm - 1) // bm).sum()) / (E * -(-CAP // bm))
            line += (f", with rows {counted:.4f} ms ({counted / dense:.3f} of dense), live m "
                     f"tiles {100 * run:.2f}% of {E * -(-CAP // bm)} (x {-(-f // bn)} n tiles), "
                     f"bit-equal {same}")
            if not same:
                print(line)
                raise SystemExit("gmm_rows_bench: the call with row counts differs from the "
                                 "dense call on zeroed rows")
            del xn
        print(line, flush=True)
        del xz, w


if __name__ == "__main__":
    main()
