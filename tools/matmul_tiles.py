"""Every tile compiled into ``csrc/matmul_pom.cu`` and ``csrc/grouped_matmul.cu``,
and the stencil sweep, on one GPU.

    python3 tools/matmul_tiles.py

Builds the ``matmul_pom``, ``grouped_matmul`` and ``stencil`` kernels, prints
ptxas's registers, stack frame and spills for each compiled kernel (from the
``.log`` beside the library) and the number of wgmma (HGMMA) and TMA-load
(UTMALDG) instructions in the SASS of the two matmul libraries: non-zero
counts show that the tensor-core route was compiled.  Then, for the matmul,
every tile of ``autotune.MATMUL_TC_TILES`` (tensor cores, where
``matmul_route`` takes the shape), of ``autotune.MATMUL_TILES`` and the four
larger CUDA-core tiles the source also compiles (they spill registers; the
wrapper refuses them, so they are launched here through the C entry point):
its max abs error against the plain version and its time at 4096^3 (bf16 and
f32), at smollm_360m's FFN up-projection (2048 x 960 x 2560, bf16) and at a
ragged 1000 x 520 x 3000 (bf16), beside ``torch.matmul`` and the tile the
schedule picks.  For the grouped matmul, every tile of
``autotune.GMM_TC_TILES`` and every CUDA-core height of ``autotune.GMM_BM``
at granite_moe_1b's decode (cap 8) and forward (cap 640) shapes, beside
``torch.bmm``, the plain version and the schedule's pick.  Then one stencil
sweep at 1024^2 and 4096^2 (f32) and 1024^2 bf16.  This is the measurement
behind the tile sets and the schedules' choices.

Imports nothing of JAX.  Exits non-zero without a card.
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SPILLING_TILES = ((128, 128, 32), (128, 256, 16), (128, 256, 32), (256, 128, 16))
SHAPES = [(4096, 4096, 4096, torch.bfloat16), (4096, 4096, 4096, torch.float32),
          (2048, 960, 2560, torch.bfloat16), (1000, 520, 3000, torch.bfloat16)]
# granite_moe_1b's grouped matmuls (E, cap, d, f): decode (wi/wg, wo) and forward
GMM_SHAPES = [(32, 8, 1024, 512), (32, 8, 512, 1024), (32, 640, 1024, 512)]


def ptxas_summary(name: str) -> None:
    """One line per compiled kernel: its (demangled) name, registers, spills."""
    from repro_torch.kernels import _build
    log = _build.log_path(name).read_text()
    entries = re.findall(r"Compiling entry function '(\w+)'", log)
    demangled = subprocess.run(["c++filt"], input="\n".join(entries), capture_output=True,
                               text=True).stdout.splitlines() if entries else []
    names = dict(zip(entries, demangled or entries))
    cur = None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", ln)
        if m and m.group(1) in names:
            cur = names[m.group(1)]
        elif cur and ("spill" in ln or "Used" in ln):
            print(f"  {cur[:90]}: {ln.strip()}")


def launch(x: torch.Tensor, y: torch.Tensor, tile: tuple) -> torch.Tensor:
    """x @ y through ``csrc/matmul_pom.cu``'s C entry point at ``tile``."""
    from repro_torch.kernels import matmul_pom as mm
    out = torch.empty(x.shape[0], y.shape[1], dtype=x.dtype, device=x.device)
    rc = mm._kernel()(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.shape[0], y.shape[1],
                      x.shape[1], *tile, mm._DTYPES[x.dtype],
                      torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"matmul tile {tile}: CUDA error {rc}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("matmul_tiles: needs a CUDA device")
    from chip_smoke import bound, time_ms
    from repro_torch.kernels import _build, autotune, ref
    from repro_torch.kernels import stencil as st
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import matmul_pom as mm
    _build.build(["matmul_pom", "grouped_matmul", "stencil"])
    for name in ("matmul_pom", "grouped_matmul", "stencil"):
        print(f"ptxas {name}:")
        ptxas_summary(name)
    for name in ("matmul_pom", "grouped_matmul"):
        print(f"sass {name}: {_build.sass_counts(name)}")
    g = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n, dt in SHAPES:
        x = torch.randn(m, k, generator=g, device="cuda").to(dt)
        y = torch.randn(k, n, generator=g, device="cuda").to(dt)
        want = ref.matmul(x, y).float()
        scale = want.abs().max().item()
        s = autotune.pom_matmul_schedule(m, n, k, x.element_size())
        bms, by = bound((m * k + k * n + m * n) * x.element_size(), 2.0 * m * n * k, dt)
        lib = time_ms(lambda: torch.matmul(x, y), iters=20)
        print(f"matmul {m}x{k}x{n} {str(dt)[6:]}: bound {bms:.4f} ms ({by}), torch.matmul "
              f"{lib:.4f} ms, schedule picks {(s.bm, s.bn, s.bk)} ({s.route})")
        tc = s.route == autotune.TENSOR_CORES
        for tile in (autotune.MATMUL_TC_TILES if tc else ()) + autotune.MATMUL_TILES \
                + SPILLING_TILES:
            if tile in autotune.MATMUL_TC_TILES:
                run = (lambda t: lambda: mm.matmul(x, y, bm=t[0], bn=t[1], bk=t[2]))(tile)
            else:
                run = (lambda t: lambda: launch(x, y, t))(tile)
            got = run()
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            ms = time_ms(run, iters=10, warmup=2)
            print(f"  tile {tile}: {ms:.4f} ms ({2.0 * m * n * k / ms / 1e9:.1f} TFLOP/s), "
                  f"max abs err {err:.3g} ({err / scale:.2e} of scale)")
        del x, y, want, got
    for e, cap, d, f in GMM_SHAPES:
        x = torch.randn(e, cap, d, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(e, d, f, generator=g, device="cuda") * d ** -0.5).to(torch.bfloat16)
        want = ref.grouped_matmul(x, w).float()
        scale = want.abs().max().item()
        s = autotune.pom_gmm_schedule(e, cap, d, f, 2)
        bms, by = bound((e * cap * d + e * d * f + e * cap * f) * 2, 2.0 * e * cap * d * f,
                        torch.bfloat16)
        lib = time_ms(lambda: torch.bmm(x, w))
        plain = time_ms(lambda: ref.grouped_matmul(x, w), iters=20)
        print(f"grouped_matmul E{e} cap{cap} d{d} f{f} bf16: bound {bms:.5f} ms ({by}), "
              f"torch.bmm {lib:.4f} ms, plain {plain:.4f} ms, schedule picks "
              f"{(s.bm, s.bn, s.bk)} ({s.route})")
        runs = [(f"tile {t}", (lambda t: lambda: gmm.grouped_matmul(x, w, tile=t))(t))
                for t in autotune.GMM_TC_TILES]
        runs += [(f"CUDA-core bm {b}", (lambda b: lambda: gmm.grouped_matmul(x, w, bm=b))(b))
                 for b in autotune.GMM_BM]
        for label, run in runs:
            got = run()
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            ms = time_ms(run, iters=20, warmup=3)
            print(f"  {label}: {ms:.4f} ms, max abs err {err:.3g} ({err / scale:.2e} of scale)")
        del x, w, want, got
    for m, dt in ((1024, torch.float32), (4096, torch.float32), (1024, torch.bfloat16)):
        a = torch.randn(m, m, generator=g, device="cuda").to(dt)
        err = (st.jacobi2d(a, 10).float() - ref.jacobi2d(a, 10).float()).abs().max().item()
        bms, by = bound(2 * m * m * a.element_size(), 5.0 * m * m, torch.float32)
        one = time_ms(lambda: st.jacobi2d(a, 1))
        ten = time_ms(lambda: st.jacobi2d(a, 10), iters=20)
        plain = time_ms(lambda: ref.jacobi2d(a, 1), iters=20)
        print(f"jacobi2d {m}^2 {str(dt)[6:]}: sweep {one:.4f} ms, 10 sweeps {ten:.4f} ms, "
              f"plain sweep {plain:.4f} ms, bound {bms:.5f} ms ({by}); 10 sweeps vs plain "
              f"max abs err {err:.3g}")


if __name__ == "__main__":
    main()
