"""The selective scan and the Jacobi-2D stencil on one GPU, and the scan's
share of zamba2_1_2b's and xlstm_1_3b's forwards.

    python3 tools/scan_bench.py [--src PATH] [--no-forward] [--tiles] [--backward]

``--src`` is the ``src`` directory of the checkout to measure (default this
checkout's), so that two checkouts compare in one call: run them in turns
(older, newer, newer, older).  Times ``ops.ssm_scan`` at ``chip_smoke``'s
zamba2, xlstm and mLSTM-normaliser shapes two ways: as ``chip_smoke.time_ms``
does (the 50 MB L2 flushed and a 2 ms device sleep before each call, CUDA
events around each call) and back to back (one pair of events around 20
calls, no flush, no sleep).  Times ``ops.jacobi2d`` at 1024^2 and 4096^2
x 10 sweeps (f32) the first way.  Then, unless ``--no-forward``, profiles a
forward of zamba2_1_2b (2 x 1024) and of xlstm_1_3b (2 x 512) at full width
and depth (bf16, seeded random weights) and prints each one's wall time,
device busy time and the scan kernels' part of it (``chip_smoke.busy_share``,
names holding ``ssm_scan``).  ``--tiles`` (this checkout's kernels only)
first times every (chunk, P tile) the scan is compiled for at the three
shapes and every (sweeps a launch, tile) of the stencil at the two grids,
beside each schedule's pick: the evidence for ``autotune``'s choices.
``--backward`` (this checkout's kernels only) times the backward passes at
the training shapes by kernel instead: the scan's ``scan_backward`` at
``chip_smoke``'s SCAN_BWD_SHAPES (zamba2, xlstm, the normaliser) and the
grouped matmul's at granite's (E 32, cap 640, d 1024, f 512, bf16), each
with its plain PyTorch copies, casts and flips beside the kernels.
Prints the card's name and power limit first.

Imports nothing of JAX.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def back_to_back_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``iters`` calls of ``fn`` enqueued back to back."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def by_kernel(fn, calls: int = 10) -> str:
    """Device time a call of each kernel ``fn`` launches (``torch.profiler``,
    ``calls`` calls back to back)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            found = re.search(r"(\w+_kernel)\b", e.name)
            name = found.group(1) if found else e.name[:40]
            ms[name] = ms.get(name, 0.0) + 1e-3 * e.time_range.elapsed_us() / calls
    return ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(ms.items(), key=lambda kv: -kv[1]))


def tiles(g) -> None:
    """Every compiled scan and stencil tile at the shapes the paths use."""
    from chip_smoke import SCAN_SHAPES, _scan_inputs, time_ms
    from repro_torch.kernels import autotune
    from repro_torch.kernels import ssm_scan as scan_mod
    from repro_torch.kernels import stencil as st_mod
    for label in ("zamba2", "xlstm", "normaliser"):
        b, s, h, p, n, dt, bc = SCAN_SHAPES[label]
        x, a, bm, cm = _scan_inputs(g, b, s, h, p, n, dt, bc)
        sc = autotune.pom_scan_schedule(s, p, n, x.element_size(), b * h,
                                        bc_groups=b * scan_mod.bc_groups(bm, cm))
        times = {(c, t): time_ms(lambda: scan_mod.ssm_scan(x, a, bm, cm, chunk=c, p_tile=t),
                                 iters=10, warmup=2)
                 for c, t in autotune.SCAN_TILES}
        print(f"ssm_scan {label} (schedule: chunk {sc.chunk}, P tile {sc.p_tile}): "
              + ", ".join(f"{c}/{t} {ms:.4f}" for (c, t), ms in sorted(times.items())) + " ms")
        del x, a, bm, cm
    for n in (1024, 4096):
        x = torch.randn(n, n, generator=g, device="cuda")
        sc = autotune.pom_jacobi_schedule(n, n, 10, 4)
        out = []
        for t in (1, 2, 3, 4, 5, 6, 8, 10):
            for tile in ((autotune.JACOBI_TILE,) if t == 1 else autotune.JACOBI_TILES):
                ms = time_ms(lambda: st_mod.jacobi2d(x, 10, sweeps=t, tile=tile), iters=10,
                             warmup=2)
                out.append(f"{t}/{tile[0]}x{tile[1]} {ms:.4f}")
        print(f"jacobi2d {n}^2 x 10 (schedule: {sc.sweeps} a launch, tile {sc.tile}): "
              + ", ".join(out) + " ms")
        del x


def backward(g) -> None:
    """The backward passes at the training shapes, by kernel."""
    from chip_smoke import SCAN_BWD_SHAPES, _randn, _scan_bwd_inputs, time_ms
    from repro_torch.kernels import grouped_matmul as gmm_mod
    from repro_torch.kernels import ssm_scan as scan_mod
    for label in ("zamba2", "xlstm", "normaliser"):
        b, s, h, p, n, dt, bc, tail = SCAN_BWD_SHAPES[label]
        x, a, bm, cm, dy, _ = _scan_bwd_inputs(g, b, s, h, p, n, dt, bc, tail)
        needs = (p > 1, True, True, True)          # the normaliser's x = 1 needs no dx

        def run():
            scan_mod.scan_backward(scan_mod._bwd_scan, x, a, bm, cm, dy, needs=needs)
        print(f"scan_backward {label} B{b} S{s} H{h} P{p} N{n} {str(dt)[6:]}: "
              f"{time_ms(run, iters=20):.4f} ms; by kernel: {by_kernel(run)}")
        del x, a, bm, cm, dy
    e, cap, d, f = 32, 640, 1024, 512
    x = _randn(g, e, cap, d, dtype=torch.bfloat16)
    w = (torch.randn(e, d, f, generator=g, device="cuda") * d ** -0.5).bfloat16()
    dy = _randn(g, e, cap, f, dtype=torch.bfloat16)

    def run():
        gmm_mod.grouped_matmul_backward(x, w, dy)
    print(f"grouped_matmul_backward E{e} cap{cap} d{d} f{f} bf16: {time_ms(run, iters=20):.4f} "
          f"ms; by kernel: {by_kernel(run)}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src directory to measure")
    ap.add_argument("--no-forward", action="store_true", help="skip the model forwards")
    ap.add_argument("--tiles", action="store_true", help="time every compiled tile first")
    ap.add_argument("--backward", action="store_true",
                    help="time the scan's and the grouped matmul's backward by kernel instead")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    if not torch.cuda.is_available():
        raise SystemExit("scan_bench: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    from chip_smoke import SCAN_SHAPES, _scan_inputs, busy_share, time_ms
    import repro_torch
    from repro_torch.kernels import ops, ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"measuring {Path(repro_torch.__file__).parent}")
    g = torch.Generator(device="cuda").manual_seed(7)
    if args.backward:
        backward(g)
        return
    if args.tiles:
        tiles(g)
    for label in ("zamba2", "xlstm", "normaliser"):
        b, s, h, p, n, dt, bc = SCAN_SHAPES[label]
        x, a, bm, cm = _scan_inputs(g, b, s, h, p, n, dt, bc)
        y, hl = ops.ssm_scan(x, a, bm, cm)
        want_y, want_h = ref.ssm_scan(x, a, bm, cm)
        ey = (y.float() - want_y.float()).abs().max().item() / want_y.float().abs().max().item()
        eh = (hl - want_h).abs().max().item() / want_h.abs().max().item()
        flushed = time_ms(lambda: ops.ssm_scan(x, a, bm, cm), iters=20)
        b2b = back_to_back_ms(lambda: ops.ssm_scan(x, a, bm, cm))
        print(f"ssm_scan {label} B{b} S{s} H{h} P{p} N{n} {str(dt)[6:]}: flushed + sleep "
              f"{flushed:.4f} ms, back to back {b2b:.4f} ms; max err / max |value|: y {ey:.3g}, "
              f"h {eh:.3g}; by kernel: {by_kernel(lambda: ops.ssm_scan(x, a, bm, cm))}")
        del x, a, bm, cm, y, hl, want_y, want_h
    for n in (1024, 4096):
        x = torch.randn(n, n, generator=g, device="cuda")
        err = (ops.jacobi2d(x, 10) - ref.jacobi2d(x, 10)).abs().max().item()
        ms = time_ms(lambda: ops.jacobi2d(x, 10), iters=20)
        print(f"jacobi2d {n}^2 f32 x 10 sweeps: {ms:.4f} ms; max abs err {err:.3g}")
        del x
    if args.no_forward:
        return
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    for arch, (b, s) in (("zamba2_1_2b", (2, 1024)), ("xlstm_1_3b", (2, 512))):
        cfg = get_config(arch)
        model = init_params(cfg, seed=0, device="cuda")
        tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s)))
        tokens = tokens.cuda()
        forward(model, tokens=tokens)
        torch.cuda.synchronize()
        busy_share(lambda: forward(model, tokens=tokens), 1, f"{arch} forward {b} x {s}",
                   "ssm_scan")
        del model, tokens
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
