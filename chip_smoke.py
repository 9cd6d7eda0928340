"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in the order they run (any failure raises and exits non-zero
without the final ok line):
  1. device  -- a CUDA device must be present; prints nvidia-smi's name and
                power limit;
  2. build   -- builds every CUDA kernel of the paths from
                ``src/repro_torch/csrc`` (one nvcc per source, all ten in
                parallel) and prints ptxas's summary; counts the wgmma
                (HGMMA) and TMA-load (UTMALDG) instructions in the SASS of
                matmul_pom, grouped_matmul and flash_attention and fails if
                either is 0; counts the tensor-core (HMMA) instructions of
                the ssm_scan library and fails if there are none; prints the
                registers and spills of the f32 ring
                (``strided_gemm_kernel``) in both libraries that include it,
                of the decode kernels, of the four scan kernels, of the
                two stencil kernels, of the flash backward's kernels and of
                the scan's decay-gradient kernels, and fails if a scan,
                stencil, flash-backward or decay-gradient kernel spills;
  3. kernels -- each LM kernel against its plain PyTorch version on the card:
                decode attention at smollm's decode shape (S 128, 1024 and
                8192), granite's and zamba2's (S 1024), group 8 and ragged
                ones, with rows at length 0 (must be 0), every split count
                1-8 forced on three shapes, and a second run that must give
                the same bits; flash attention at smollm's shapes and ragged ones
                (in bf16 on every tensor-core tile too: a ragged Sq,
                Sq < Skv, Sq > Skv with rows that see no key, group 4 and
                1, non-causal, D 128, and D 32 on the CUDA cores), the
                flash backward at the training step's shape in bf16 and
                f32, with rows that see no key and ragged (a second call
                bit-equal),
                grouped_matmul at granite_moe_1b's decode (cap 8) and forward
                (cap 640) shapes and a ragged one, bf16 and f32, through both
                schedules and every tensor-core tile, ssm_scan at
                zamba2's and xlstm's shapes, P = 1 and a ragged S (y and h),
                through both schedules, with the route of each call; the
                grouped matmul's backward (dX, dW) at granite's training
                shapes (cap 640, on the tensor cores) and a ragged f32 one,
                a second call bit-equal; the scan's backward (dx, da, db,
                dc) at zamba2's, xlstm's and the normaliser's training
                shapes and a ragged one with a non-zero dh_final, and the
                decay-gradient kernel alone;
  4. contraction vs plain -- the contraction kernel against its plain
                version in f32 and bf16 on the compile path's schedules
                (tiled gemm at n 256 and at the path's n 4096, unscheduled
                gemm, tiled matvec, conv nests, batched gemm), and the probe
                kernel against x + 1;
  5. serve   -- smollm_360m at full width (32 layers, d_model 960), bf16,
                seeded random weights, batch 8, prompt 64, gen 64, through
                ``repro_torch.launch.serve.serve``; the decode kernel must run
                32 times per decode step; logits are held against the same
                tokens teacher-forced through the plain attention;
  6. forward -- a 512-token prompt (batch 4) through ``forward`` (the flash
                kernel, all 32 launches on the tensor-core route), held
                against teacher-forced decode logits;
  6b. train -- smollm_360m at full width and depth (bf16 parameters, f32
                moments, remat "full"), batch 8 x 256 of ``SyntheticLM``:
                one step's loss and every gradient with the kernels against
                the same step on the plain versions on the card (relative
                norm of each gradient's difference within TRAIN_GRAD_RTOL),
                with exact counts (64 flash forwards, all on the tensor
                cores with lse, and 32 flash backwards a step, all on the
                tensor cores; no other kernel); the main path, 30 steps of ``launch/train.py``'s
                loop with a checkpoint at step 10, whose loss must fall; a
                run stopped after that checkpoint and resumed in the same
                process, bit-equal to the straight run (losses, parameters,
                moments); step wall time, device busy time and share,
                tokens/s, peak memory and the top device kernels;
  6c. train families -- granite_moe_1b, zamba2_1_2b and xlstm_1_3b,
                batch 8 x 256, remat "full" (``train_family_phase``): one
                step's loss and gradients at full width and depth against
                the plain versions on the card (granite in bf16 with the
                kernel run's expert choices replayed, recompute included,
                which must choose the forward's experts; zamba2 and xlstm on
                an f32 copy), within TRAIN_GRAD_RTOL and TRAIN_LOSS_RTOL, with
                exact counts a step (the forward kernels twice, the flash
                backward once an attention layer, dX and dW a grouped
                matmul, three scans a scan's backward, two for the
                normaliser, one decay-gradient launch a scan; in bf16 every
                flash and grouped-matmul launch on the tensor cores); the
                main path, ``launch/train.py``'s loop at full width with
                the depth cut (granite 4 layers, zamba2 6, xlstm 8), 16
                steps with a checkpoint at 8, whose loss must fall, and a
                resume bit-equal to the straight run; step wall time,
                tokens/s, device busy time and share, peak memory and top
                kernels at full width and depth;
  7. families -- granite_moe_1b, zamba2_1_2b and xlstm_1_3b at full width
                and depth (bf16, seeded random weights), one at a time.  The
                main path: a serve (batch 8; prompt 32 and gen 32, xlstm 16
                and 16) and a forward (4 x 512; zamba2 2 x 1024, xlstm
                2 x 512); every kernel must run exactly as often as the
                family's layers say (grouped_matmul 72 times a granite decode
                step and forward, every one on the tensor-core route, as
                are granite's 24 and zamba2's 6 flash launches a forward;
                ssm_scan 38 times a zamba2 forward and 96 an xlstm one).
                Then the checks, each against the same
                tokens through the plain versions on the card
                (``ops.plain_versions()``): granite in bf16 with the kernel
                run's expert choices replayed (``moe_routes``); zamba2 and
                xlstm on an f32 copy of the weights (serve, forward, and
                teacher-forced decode of 2 x 170 tokens against the
                forward), the bf16 forward's difference printed
                (``family_phase`` says why); tokens/s, peak memory and device busy share per
                family;
  8. probe   -- the compile path's once-per-process CUDA probe
                (``cuda_supported()``, first called here) must pass after
                exactly one launch;
  9. compile path at size -- gemm, 2mm and 3mm at n = 4096 (f32), tiled
                32 x 32 x 32 with the DSL's tile/split/unroll primitives,
                through ``compile(fn, target="cuda")``: calling the program
                and ``jitted()`` each launch the contraction kernel once per
                statement, every launch on its strided (shared-memory ring)
                kernel, and agree with ``torch.matmul`` compositions;
 10. workloads -- the thirteen serving workloads (``serving_cases(False)``)
                through ``jitted()`` and ``batched(8)`` on the card against
                the numpy oracle and eight sequential calls (times after a
                warm-up, the median of five), and through
                ``CompileService.cuda_runner`` (greedy DSE, serial);
 11. workloads at default size -- the same thirteen programs at the
                builders' default sizes (``default_cases()``: n 4096, the
                stencils' 100 or 10 steps) through ``jitted()``, against the
                same computations written directly in PyTorch on the card;
 12. kernel library -- ``ops.matmul`` at 4096^3, smollm's FFN up-projection
                (2048 x 960 x 2560) and a ragged 1000 x 520 x 3000, each in
                bf16 and f32, 1000 x 520 x 3001 in f32, and once with
                ``schedule="naive"``; ``ops.jacobi2d`` at 1024^2 and 4096^2
                x 10 steps (f32), 1024^2 x 10 in bf16 and a ragged
                1000 x 777 x 3; exactly one launch a matmul (the four bf16
                ones on the tensor cores, the three f32 ones whose K and N
                are multiples of 4 on the ring, N = 3001 on the CUDA-core
                tiles) and ceil(steps / T) a stencil call (T the sweeps a
                launch of ``autotune.pom_jacobi_schedule``), the multi-sweep
                results bit for bit against ``steps`` single-sweep launches;
                each result against its plain
                version, every tensor-core tile against it at the bf16
                shapes, each ring result bit for bit against the CUDA-core
                tile (128, 128, 16) and the contraction's strided kernel on
                the same inputs, and ``ops.jacobi2d(A, 10)`` against the
                compile path's jacobi2d program at 1024^2; then the
                library's ops on a misaligned bf16 operand (CUDA cores) and
                a transposed one (copied to contiguous), each against its
                plain version;
 13. numbers -- per-kernel times with CUDA events (L2 flushed before every
                launch), each kernel's bound, the plain version's time and a
                PyTorch yardstick on the same inputs (SDPA, ``torch.addmm``,
                ``torch.add``, ``torch.bmm``, ``torch.matmul``; none for the
                scan and the stencil; the port never calls them), the
                scan's bound at the TF32 tensor-core rate its kernels use
                (the f32 rate's beside it), the scan at the mLSTM
                normaliser's shape, the stencil's row its 10-sweep call
                against the bound of one pass (one sweep beside it), with the
                card's clocks, temperature and power draw sampled before and
                after each group; the matmul, grouped-matmul and flash rows
                name their route and tile, read from the launch counts of
                the timed calls (flash's CUDA-core route, the contraction's
                table kernel and the f32 matmul's CUDA-core tile timed
                beside them on the same inputs); decode at S 128 (the row),
                1024 ragged and 8192, each split count 1-8 timed at S 128
                and 8192, and the clusters the card holds at once; the
                flash forward with lse beside it, and the flash backward at
                the training shape against its bound, its CUDA-core route,
                its plain version and SDPA's forward plus backward (its
                backward alone beside it); the grouped matmul's backward at
                granite's training shape (its transposed copies' time and
                two ``torch.bmm`` beside it), the scan's backward at
                zamba2's (xlstm's and the normaliser's beside it) and the
                decay-gradient kernel.  One ``{"kernels": [...]}`` JSON line.
Every launch count is set to 0 just before each path run (the smollm serve,
the smollm forward, the smollm training loop, each family's training loop,
serve and forward, the compile path as phases 8-11, the kernel library) and
read just after; the counts in the kernels line are their sums, and every
one of the eight kernels and the four backward passes (``BACKWARD``) must
have run.
The last line is ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

SERVE_B, SERVE_PROMPT, SERVE_GEN = 8, 64, 64
FWD_B, FWD_S = 4, 512
# training (launch/train.py's defaults): batch 8 x 256 tokens of SyntheticLM,
# 30 steps with a checkpoint at step 10
TRAIN_B, TRAIN_S = 8, 256
TRAIN_STEPS, TRAIN_CKPT = 30, 10
# peak learning rate: at train.py's default 3e-3 (warmup 20 steps) the loss
# of 30 steps rises once the rate passes ~2.5e-3, on the kernels and on the
# plain versions alike; at 1e-3 it falls (PERF.md, tools/train_probe.py)
TRAIN_LR = 1e-3
# One training step's gradients with the kernels against the same step on
# the plain versions on the card, as the relative norm of each parameter's
# gradient difference, ||g_kernel - g_plain|| / ||g_plain||: the tensor-core
# forward rounds P to bf16 before P V, and both paths round bf16
# activations and gradients (2^-8 relative) at different places, which 32
# layers carry into every gradient (the logit checks' 5% bound).  A wrong
# mask, head or scale moves a gradient by O(1) of its norm.  The losses,
# means over 2048 tokens, within 1% (a few bf16 ulps) of each other.
TRAIN_GRAD_RTOL = 0.05
TRAIN_LOSS_RTOL = 1e-2
# the flash backward alone against its plain version, relative to the
# largest |value| (the forward's form): f32 sums in another order; bf16
# outputs rounded once
FLASH_BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Logit tolerances, as a fraction of the largest |logit| of the reference:
# bf16 keeps 8 significant bits (2^-8 relative per rounding).  Kernel and
# plain version sum in different orders and round their bf16 outputs
# independently, and forward and decode round bf16 activations at different
# places (different matmul shapes); a one-ulp difference in one of 32
# layers carries through the residual stream of the rest.  Bugs (a wrong
# mask, head or position) move logits by O(1) of that scale.
LOGITS_RTOL_OF_SCALE = 0.05
SLEEP_CYCLES = 4_000_000    # ~2 ms at the H100's ~1.98 GHz boost clock
POM_N, POM_T = 4096, 32     # benchmarks/workloads.py's default size; tile 32
# f32 contraction vs a torch.matmul composition, relative to the largest
# |value|: both sum 4096 f32 products per output (in different orders), and
# 3mm feeds one product into the next.
POM_RTOL = 1e-4
# granite_moe_1b's grouped matmuls (E 32; wi/wg d 1024 -> f 512, wo 512 ->
# 1024) at decode (batch 8: cap 8) and forward (4 x 512 tokens: cap 640),
# and a ragged shape no tile divides
GMM_SHAPES = [(32, 8, 1024, 512), (32, 8, 512, 1024), (32, 640, 1024, 512),
              (32, 320, 500, 1000)]
# (B, S, H, P, N, x dtype, B/C broadcast over heads)
SCAN_SHAPES = {"zamba2": (2, 1024, 32, 128, 64, torch.bfloat16, True),
               "xlstm": (2, 512, 4, 512, 512, torch.bfloat16, False),
               "normaliser": (2, 512, 4, 1, 512, torch.float32, False),
               "ragged": (2, 200, 4, 64, 64, torch.float32, False)}
# the backward passes against their plain versions, relative to the largest
# |value| of each plain gradient: the grouped matmul's as its forward (bf16
# outputs round once, f32 sums of cap or f products in another order); the
# scan's db, dc and da from split-TF32 products within a few f32 ulps (da
# through a sum over S of differences that nearly cancel), its dx in x's
# dtype (a bf16 dx rounds once)
GMM_BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SCAN_BWD_RTOL = 2e-3
# the scan's gradient at the training shapes (batch 8 x 256; B, S, H, P, N,
# x dtype, B/C broadcast over heads, dh_final): zamba2's, xlstm's, the mLSTM
# normaliser's (P 1: its role-swapped scans have N 1), and a ragged one with
# a non-zero dh_final
SCAN_BWD_SHAPES = {"zamba2": (8, 256, 32, 128, 64, torch.bfloat16, True, False),
                   "xlstm": (8, 256, 4, 512, 512, torch.bfloat16, False, False),
                   "normaliser": (8, 256, 4, 1, 512, torch.float32, False, False),
                   "ragged": (2, 200, 4, 48, 40, torch.float32, False, True)}
# training the three families (batch 8 x 256 of SyntheticLM, remat "full"):
# one step's gradients at full width and depth against the plain versions
# (granite in bf16 with the kernel run's expert choices replayed, zamba2 and
# xlstm on an f32 copy, as family_phase holds their logits), the loop and its
# resume at full width with the depth cut (a checkpoint of the full models is
# 12-18 GB): granite 4 layers, zamba2 6 (its shared-attention site), xlstm 8
# (its sLSTM); FAMILY_STEPS steps with a checkpoint at FAMILY_CKPT
FAMILY_TRAIN = {"granite_moe_1b": dict(check_dtype="bfloat16", loop_layers=4),
                "zamba2_1_2b": dict(check_dtype="float32", loop_layers=6),
                "xlstm_1_3b": dict(check_dtype="float32", loop_layers=8)}
FAMILY_STEPS, FAMILY_CKPT = 16, 8
# the three families, at full width and depth: serve (batch, prompt, gen),
# forward (batch, seq), for hybrid and ssm the teacher-forced decode held
# against the forward on the same tokens (batch, seq; 170 = 5 x 32 + 10
# crosses the scan's chunk boundaries and leaves a ragged tail), and the
# precision the logit checks run in (family_phase says why)
FAMILIES = {"granite_moe_1b": dict(serve=(8, 32, 32), forward=(4, 512), consistency=None,
                                   check_dtype="bfloat16"),
            "zamba2_1_2b": dict(serve=(8, 32, 32), forward=(2, 1024), consistency=(2, 170),
                                check_dtype="float32"),
            "xlstm_1_3b": dict(serve=(8, 16, 16), forward=(2, 512), consistency=(2, 170),
                               check_dtype="float32")}
KERNEL_MODULES = ("decode_attention", "flash_attention", "contraction", "probe",
                  "grouped_matmul", "ssm_scan", "matmul_pom", "stencil")
# the kernels with a tensor-core and a CUDA-core route: their wrappers count
# the tensor-core launches (launches_tc) beside all of them (launches); the
# matmul's f32 ring counts its own (launches_ring)
ROUTED = ("grouped_matmul", "matmul_pom", "flash_attention")
# the kernel library's matmul (M, K, N, dtype): the JAX autotune test's and
# bench_kernels.py's 4096^3 in bf16 and f32, smollm_360m's FFN up-projection
# at the forward (4 x 512 tokens, d_model 960 -> d_ff 2560) and a ragged one
# in bf16 (the tensor cores) and f32 (the ring; N = 3001 the CUDA-core tiles)
MATMUL_SHAPES = [(4096, 4096, 4096, torch.bfloat16), (4096, 4096, 4096, torch.float32),
                 (FWD_B * FWD_S, 960, 2560, torch.bfloat16), (1000, 520, 3000, torch.bfloat16),
                 (FWD_B * FWD_S, 960, 2560, torch.float32), (1000, 520, 3000, torch.float32),
                 (1000, 520, 3001, torch.float32)]
# the Jacobi-2D stencil (M, N, steps, dtype): the paper's Table VII size
# (benchmarks/workloads.py, bench_stencils.py: 1024^2, 10 steps), 4096^2, the
# same in bf16 and a ragged grid
JACOBI_SHAPES = [(1024, 1024, 10, torch.float32), (4096, 4096, 10, torch.float32),
                 (1024, 1024, 10, torch.bfloat16), (1000, 777, 3, torch.float32)]
# matmul against its plain version, relative to the largest |value|: f32
# sums of K products in another order; bf16 outputs round the f32 sum once
# each (the JAX kernel tests' bf16 tolerance)
MATMUL_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
JACOBI_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def _kernel_modules() -> dict:
    import importlib
    return {n: importlib.import_module(f"repro_torch.kernels.{n}") for n in KERNEL_MODULES}


def zero_counts() -> None:
    """Sets every kernel wrapper's launch counts to 0 (per route too, and
    the backward passes')."""
    for n, m in _kernel_modules().items():
        m.launches = 0
        if n in ROUTED:
            m.launches_tc = 0
        if n == "matmul_pom":
            m.launches_ring = 0
        if n == "contraction":
            m.launches_strided = 0
        if n in ("flash_attention", "grouped_matmul"):
            m.launches_bwd = m.launches_bwd_tc = 0
        if n == "ssm_scan":
            m.launches_bwd = m.launches_da = 0


# the backward passes' counts: name in the counts -> (module, counter)
BACKWARD = {"flash_attention_bwd": ("flash_attention", "launches_bwd"),
            "grouped_matmul_bwd": ("grouped_matmul", "launches_bwd"),
            "ssm_scan_bwd": ("ssm_scan", "launches_bwd"),
            "ssm_scan_da": ("ssm_scan", "launches_da")}


def read_counts() -> dict:
    """kernel -> launches since the counts were last set to 0 (the backward
    passes under the names of ``BACKWARD``: the flash backward, the grouped
    matmul's dX and dW, the scan kernels' runs inside the scan's backward,
    and the decay-gradient kernel)."""
    mods = _kernel_modules()
    return {**{n: m.launches for n, m in mods.items()},
            **{k: getattr(mods[mod], attr) for k, (mod, attr) in BACKWARD.items()}}


def read_routes() -> dict:
    """name -> {route: launches} of the ROUTED kernels (the matmul's ring
    apart from its CUDA-core tiles)."""
    out = {}
    for n, m in _kernel_modules().items():
        if n in ROUTED:
            ring = getattr(m, "launches_ring", 0)
            out[n] = {"tensor_cores": m.launches_tc,
                      "cuda_cores": m.launches - m.launches_tc - ring}
            if n == "matmul_pom":
                out[n]["ring"] = ring
    return out


def check_routes(label: str, name: str, tensor_cores: int, cuda_cores: int = 0,
                 ring: int = 0) -> None:
    """``name`` ran exactly so often on each route since the counts were
    last set to 0."""
    got = read_routes()[name]
    want = {"tensor_cores": tensor_cores, "cuda_cores": cuda_cores}
    if name == "matmul_pom":
        want["ring"] = ring
    print(f"{label}: {name} routes {got}")
    if got != want:
        fail(f"{label}: {name} took routes {got}, expected {want}")


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------
def device_phase() -> str:
    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


# --------------------------------------------------------------------------
# 2. build
# --------------------------------------------------------------------------
def build_phase() -> None:
    phase("build")
    from repro_torch.kernels import _build
    reused = sorted(n for n in _build.KERNELS if _build.lib_path(n).exists())
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"built {sorted(set(paths) - set(reused))} and reused {reused} "
          f"in {time.perf_counter() - t0:.1f}s")
    for name in sorted(paths):
        log = _build.log_path(name).read_text()
        regs = [ln.split("Used", 1)[1].strip() for ln in log.splitlines() if "Used" in ln]
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill")]
        serial = [ln.strip() for ln in log.splitlines() if "wgmma" in ln and "serializ" in ln]
        print(f"ptxas {name}: {len(regs)} kernels; "
              f"registers {sorted(set(int(r.split()[0]) for r in regs))}; "
              f"spilling entries {len(spills)}" + (f" e.g. {spills[0]}" if spills else "")
              + (f"; wgmma serialized in {len(serial)}: {serial[0]}" if serial else ""))
    for name in ROUTED:
        counts = _build.sass_counts(name)
        print(f"sass {name}: {counts}")
        if not all(counts.values()):
            fail(f"{name}: the tensor-core route compiled without wgmma or TMA: {counts}")
    counts = _build.sass_counts("ssm_scan", ("HMMA",))
    print(f"sass ssm_scan: {counts}")
    if not counts["HMMA"]:
        fail(f"ssm_scan: compiled without tensor-core (mma.sync) instructions: {counts}")
    # the f32 ring in both libraries that include it, and the decode kernels
    ring = "strided_gemm_kernel"
    for lib, entry in (("contraction", ring), ("matmul_pom", ring),
                       ("decode_attention", "decode_kernel"), ("ssm_scan", "ssm_scan_"),
                       ("stencil", "jacobi"), ("flash_attention_bwd", "flash_bwd_"),
                       ("ssm_scan_bwd", "ssm_scan_da")):
        found = ptxas_entries(_build.log_path(lib).read_text(), entry)
        if not found:
            fail(f"{lib}: ptxas compiled no {entry}")
        regs = sorted({r for r, _ in found.values()})
        spills = {n: sp for n, (_, sp) in found.items() if sp}
        print(f"ptxas {lib} {entry}: {len(found)} kernels, registers {regs}, spill bytes "
              + (", ".join(f"{n}: {sp}" for n, sp in spills.items()) if spills else "none"))
        if len(found) <= 2:
            for n, (r, sp) in found.items():
                print(f"  {n}: {r} registers, {sp} bytes spilled")
        if spills and lib in ("ssm_scan", "stencil", "flash_attention_bwd", "ssm_scan_bwd"):
            fail(f"{lib}: kernels spill registers: {spills}")


def ptxas_entries(log: str, entry: str) -> dict:
    """mangled kernel name -> (registers, spill store + load bytes) of the
    kernels of an nvcc ``-Xptxas -v`` log whose name holds ``entry``."""
    import re
    out, name, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None and entry in name:
            out[name] = (int(m.group(1)), spill)
    return out


# --------------------------------------------------------------------------
# 3. kernels vs plain versions
# --------------------------------------------------------------------------
def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-4


def _randn(g, *shape, dtype):
    return torch.randn(*shape, generator=g, device="cuda").to(dtype)


def kernel_phase() -> dict:
    phase("kernels vs plain")
    from repro_torch.kernels import ops, ref
    errs = {"decode_attention": 0.0, "flash_attention": 0.0}
    g = torch.Generator(device="cuda").manual_seed(0)

    # (B, Hq, Hkv, S, D, dtype, ragged length, a row at length 0, every
    # split count 1-8): full-width smollm, granite and zamba2 shapes first
    from repro_torch.kernels import autotune
    from repro_torch.kernels import decode_attention as decode_mod
    bf16 = torch.bfloat16
    decode_cases = [(8, 15, 5, 1024, 64, bf16, True, False, False),
                    (SERVE_B, 15, 5, SERVE_PROMPT + SERVE_GEN, 64, bf16, True, False, True),
                    (8, 15, 5, 8192, 64, bf16, False, False, False),   # smollm, S 8192 full
                    (8, 16, 8, 1024, 64, bf16, True, True, False),     # granite_moe_1b
                    (8, 32, 32, 1024, 64, bf16, True, True, False),    # zamba2_1_2b
                    (2, 16, 2, 1000, 64, bf16, True, True, True),      # group 8
                    (2, 4, 4, 200, 64, torch.float32, True, False, False),   # group 1, ragged S
                    (2, 8, 2, 77, 32, torch.float32, True, True, True),      # group 4
                    (3, 4, 1, 300, 128, torch.float32, True, False, False)]
    for b, hq, hkv, s, d, dt, ragged, zero, forced in decode_cases:
        q = _randn(g, b, hq, d, dtype=dt)
        k, v = _randn(g, b, hkv, s, d, dtype=dt), _randn(g, b, hkv, s, d, dtype=dt)
        length = torch.full((b,), s, dtype=torch.int32, device="cuda")
        if ragged:
            length = torch.randint(1, s + 1, (b,), generator=g, device="cuda",
                                   dtype=torch.int32)
        if zero:
            length[0] = 0
        want = ref.decode_attention(q, k, v, length=length)
        sch = autotune.pom_decode_schedule(b * hkv, s, hq // hkv, d, q.element_size())
        runs = [(f"{sc} (splits {sch.splits if sc == 'pom' else 1})", lambda sc=sc:
                 ops.decode_attention(q, k, v, length=length, schedule=sc))
                for sc in ("pom", "naive")]
        if forced:
            runs += [(f"splits {n}", lambda n=n: decode_mod.decode_attention(
                q, k, v, length=length, splits=n)) for n in range(1, 9)]
        for how, run in runs:
            got = run()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            print(f"decode B{b} Hq{hq} Hkv{hkv} S{s} D{d} {str(dt)[6:]} "
                  f"{'ragged' if ragged else 'full'}{' +zero row' if zero else ''} {how}: "
                  f"max abs err {err:.3g}")
            if not err <= _tol(dt):
                fail(f"decode_attention disagrees with its plain version: {err}")
            if zero and not bool((got[0] == 0).all()):
                fail("decode_attention: a row at length 0 is not 0")
            errs["decode_attention"] = max(errs["decode_attention"], err)
            # the split merge runs in a fixed order: a second run, same bits
            if how.startswith("pom") and not torch.equal(run(), got):
                fail(f"decode_attention {how}: a second run on the same inputs gave other bits")

    # (B, Hq, Hkv, Sq, Skv, D, causal, dtype); bf16 at D 64 and 128 takes the
    # tensor cores (its tile is run directly too), D 32 and f32 the CUDA cores
    flash_cases = [(FWD_B, 15, 5, FWD_S, FWD_S, 64, True, bf16),       # smollm_360m's forward
                   (2, 32, 32, 1024, 1024, 64, True, bf16),         # zamba2_1_2b's forward
                   (4, 16, 8, 512, 512, 64, True, bf16),            # granite_moe_1b's forward
                   (2, 4, 4, 130, 130, 64, True, bf16),             # ragged Sq
                   (1, 4, 1, 64, 200, 64, True, bf16),              # Sq < Skv suffix
                   (1, 4, 2, 200, 64, 64, True, bf16),              # Sq > Skv: rows see no key
                   (2, 8, 2, 130, 130, 64, True, bf16),             # group 4
                   (1, 4, 4, 96, 96, 64, True, bf16),               # group 1
                   (2, 4, 4, 100, 100, 64, False, bf16),            # non-causal
                   (2, 8, 2, 300, 300, 128, True, bf16),            # D 128
                   (2, 4, 4, 130, 130, 32, True, bf16),             # D 32: CUDA cores
                   (2, 4, 4, 100, 100, 64, False, torch.float32),   # non-causal, ragged
                   (1, 4, 1, 64, 200, 64, True, torch.float32),     # Sq < Skv suffix
                   (2, 8, 2, 130, 130, 32, True, torch.float32),    # group 4, ragged
                   (1, 4, 4, 96, 96, 128, True, torch.float32)]     # group 1
    from repro_torch.kernels import flash_attention as flash_mod
    for b, hq, hkv, sq, skv, d, causal, dt in flash_cases:
        q = _randn(g, b, hq, sq, d, dtype=dt)
        k, v = _randn(g, b, hkv, skv, d, dtype=dt), _randn(g, b, hkv, skv, d, dtype=dt)
        want = ref.attention(q, k, v, causal=causal)
        route = autotune.attention_route(sq, skv, d, q.element_size())
        runs = [(sch, lambda sch=sch: ops.attention(q, k, v, causal=causal, schedule=sch))
                for sch in ("pom", "naive")]
        if route == autotune.TENSOR_CORES:
            runs += [(f"tile {t}", lambda t=t: flash_mod.flash_attention(
                q, k, v, causal=causal, bq=t[0], bkv=t[1])) for t in autotune.FLASH_TC_TILES]
        for how, run in runs:
            ntc = flash_mod.launches_tc
            got = run()
            torch.cuda.synchronize()
            took_tc = flash_mod.launches_tc - ntc
            err = (got.float() - want.float()).abs().max().item()
            print(f"flash B{b} Hq{hq} Hkv{hkv} Sq{sq} Skv{skv} D{d} causal={causal} "
                  f"{str(dt)[6:]} {route} {how}: max abs err {err:.3g}")
            if took_tc != (route == autotune.TENSOR_CORES):
                fail(f"flash_attention took the wrong route: {took_tc} tensor-core launches "
                     f"for route {route}")
            if not err <= _tol(dt):
                fail(f"flash_attention disagrees with its plain version: {err}")
            if causal and sq > skv and not bool((got[:, :, :sq - skv] == 0).all()):
                fail("flash_attention: a query row that sees no key is not 0")
            errs["flash_attention"] = max(errs["flash_attention"], err)
    errs["flash_attention_bwd"] = flash_bwd_vs_plain(g)
    errs["grouped_matmul"] = gmm_vs_plain(g)
    errs["grouped_matmul_bwd"] = gmm_bwd_vs_plain(g)
    errs["ssm_scan"] = scan_vs_plain(g)
    errs["ssm_scan_bwd"], errs["ssm_scan_da"] = scan_bwd_vs_plain(g)
    return errs


def flash_bwd_vs_plain(g) -> float:
    """The flash backward against ``ref.attention_backward`` on the same q,
    k, v, o, lse and dO: at the training step's shape in bf16 and f32, and
    Sq > Skv (rows that see no key get dq 0) and group 4 ragged; a second
    call gives the same bits; bf16 at D 64 on both routes (tensor and CUDA
    cores).  Each held to FLASH_BWD_RTOL of its largest |value|; returns the
    largest absolute error."""
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels import flash_attention as flash_mod
    worst_abs = 0.0
    for b, hq, hkv, sq, skv, d, causal, dt in [
            (TRAIN_B, 15, 5, TRAIN_S, TRAIN_S, 64, True, torch.bfloat16),
            (TRAIN_B, 15, 5, TRAIN_S, TRAIN_S, 64, True, torch.float32),
            (1, 4, 2, 200, 64, 64, True, torch.bfloat16),
            (2, 8, 2, 130, 130, 64, True, torch.float32)]:
        q, do = _randn(g, b, hq, sq, d, dtype=dt), _randn(g, b, hq, sq, d, dtype=dt)
        k, v = _randn(g, b, hkv, skv, d, dtype=dt), _randn(g, b, hkv, skv, d, dtype=dt)
        o, lse = flash_mod.flash_attention(q, k, v, causal=causal, return_lse=True)
        want = ref.attention_backward(q, k, v, o, lse, do, causal=causal)
        best = autotune.attention_route(sq, skv, d, q.element_size())
        for route in sorted({best, autotune.CUDA_CORES}):
            ntc = flash_mod.launches_bwd_tc
            got = flash_mod.flash_attention_backward(q, k, v, o, lse, do, causal=causal,
                                                     route=route)
            again = flash_mod.flash_attention_backward(q, k, v, o, lse, do, causal=causal,
                                                       route=route)
            torch.cuda.synchronize()
            if (flash_mod.launches_bwd_tc - ntc) != 2 * (route == autotune.TENSOR_CORES):
                fail(f"flash_attention_backward did not take the route {route}")
            err = [(a.float() - w.float()).abs().max().item() for a, w in zip(got, want)]
            rel = max(e / w.float().abs().max().item() for e, w in zip(err, want))
            print(f"flash backward B{b} Hq{hq} Hkv{hkv} Sq{sq} Skv{skv} D{d} {str(dt)[6:]} "
                  f"{route}: max abs err {max(err):.3g}, {rel:.3g} of the largest value "
                  f"(tolerance {FLASH_BWD_RTOL[dt]})")
            if not rel <= FLASH_BWD_RTOL[dt]:
                fail(f"flash_attention_backward disagrees with its plain version: {rel}")
            if any(not torch.equal(a, x) for a, x in zip(got, again)):
                fail("flash_attention_backward: a second call gave other bits")
            if sq > skv and not bool((got[0][:, :, :sq - skv] == 0).all()):
                fail("flash_attention_backward: a query row that sees no key has dq != 0")
            worst_abs = max(worst_abs, max(err))
    return worst_abs


def _rel_tol(dtype, f32: float) -> float:
    """Tolerance relative to the largest |value| of the plain result: bf16
    outputs may round one ulp (2^-8) apart; f32 sums differ in order."""
    return 1e-2 if dtype == torch.bfloat16 else f32


def gmm_vs_plain(g) -> float:
    """grouped_matmul against ref.grouped_matmul: granite_moe_1b's decode
    (cap 8) and forward (cap 640) shapes and a ragged one (cap 320, f 1000,
    d 500: no multiple of any tile, and d no multiple of 8, so bf16 takes the
    CUDA cores), bf16 and f32, both schedules, and every tensor-core tile
    where the route is the tensor cores."""
    from repro_torch.kernels import autotune, ops, ref
    from repro_torch.kernels import grouped_matmul as gmm_mod
    worst = 0.0
    for e, cap, d, f in GMM_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            x = _randn(g, e, cap, d, dtype=dt)
            w = (torch.randn(e, d, f, generator=g, device="cuda") * d ** -0.5).to(dt)
            want = ref.grouped_matmul(x, w).float()
            scale = want.abs().max().item()
            route = autotune.gmm_route(e, cap, d, f, x.element_size())
            runs = [(sch, lambda sch=sch: ops.grouped_matmul(x, w, schedule=sch))
                    for sch in ("pom", "naive")]
            if route == autotune.TENSOR_CORES:
                runs += [(f"tile {t}", lambda t=t: gmm_mod.grouped_matmul(x, w, tile=t))
                         for t in autotune.GMM_TC_TILES]
            for how, run in runs:
                got = run()
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                tol = _rel_tol(dt, 1e-4) * scale
                print(f"grouped_matmul E{e} cap{cap} d{d} f{f} {str(dt)[6:]} {route} {how}: "
                      f"max abs err {err:.3g} (tolerance {tol:.3g})")
                if not err <= tol:
                    fail(f"grouped_matmul disagrees with its plain version: {err}")
                worst = max(worst, err)
            del x, w, want
    return worst


def _scan_inputs(g, b, s, h, p, n, dt, broadcast):
    """Inputs in the models' ranges: a in (0.5, 1), b and c ~ N(0, 1/N); a
    broadcast B/C group is a stride-0 view over the heads (zamba2)."""
    x = _randn(g, b, s, h, p, dtype=dt)
    a = torch.rand(b, s, h, generator=g, device="cuda") * 0.5 + 0.5
    hb = 1 if broadcast else h
    bm = torch.randn(b, s, hb, n, generator=g, device="cuda") * n ** -0.5
    cm = torch.randn(b, s, hb, n, generator=g, device="cuda") * n ** -0.5
    if broadcast:
        bm, cm = bm.expand(b, s, h, n), cm.expand(b, s, h, n)
    return x, a, bm, cm


def scan_vs_plain(g) -> float:
    """ssm_scan against ref.ssm_scan (y and the final h): zamba2's shape
    (broadcast B/C), xlstm's, the mLSTM normaliser's P = 1 and a ragged
    S = 200, both schedules, each call's route (x's dtype names it) printed."""
    from repro_torch.kernels import autotune, ops, ref
    worst = 0.0
    for label, (b, s, h, p, n, dt, bc) in SCAN_SHAPES.items():
        x, a, bm, cm = _scan_inputs(g, b, s, h, p, n, dt, bc)
        want_y, want_h = ref.ssm_scan(x, a, bm, cm)
        route = autotune.SCAN_ROUTES[x.element_size()]
        for schedule in ("pom", "naive"):
            y, hl = ops.ssm_scan(x, a, bm, cm, schedule=schedule)
            torch.cuda.synchronize()
            ey = (y.float() - want_y.float()).abs().max().item()
            eh = (hl - want_h).abs().max().item()
            ty = _rel_tol(dt, 1e-3) * want_y.float().abs().max().item()
            th = 1e-3 * want_h.abs().max().item()
            print(f"ssm_scan {label} B{b} S{s} H{h} P{p} N{n} {str(dt)[6:]} {schedule} "
                  f"({route}): max abs err y {ey:.3g} (tolerance {ty:.3g}), h {eh:.3g} "
                  f"(tolerance {th:.3g})")
            if not (ey <= ty and eh <= th):
                fail(f"ssm_scan {label} disagrees with its plain version: {ey}, {eh}")
            worst = max(worst, ey)
        del x, a, bm, cm, want_y, want_h
    return worst


def gmm_bwd_vs_plain(g) -> float:
    """grouped_matmul_backward (dX and dW) against its plain version at
    granite_moe_1b's training shapes (8 x 256 tokens: cap 640; wi/wg and
    wo) in bf16, every launch on the tensor cores, and a ragged one in f32
    (the CUDA cores); a second call gives the same bits."""
    from repro_torch.kernels import grouped_matmul as gmm_mod
    from repro_torch.kernels import ref
    worst = 0.0
    for e, cap, d, f, dt in ((32, 640, 1024, 512, torch.bfloat16),
                             (32, 640, 512, 1024, torch.bfloat16),
                             (4, 130, 100, 70, torch.float32)):
        x = _randn(g, e, cap, d, dtype=dt)
        w = (torch.randn(e, d, f, generator=g, device="cuda") * d ** -0.5).to(dt)
        dy = _randn(g, e, cap, f, dtype=dt)
        want = ref.grouped_matmul_backward(x, w, dy)
        n0, ntc = gmm_mod.launches_bwd, gmm_mod.launches_bwd_tc
        got = gmm_mod.grouped_matmul_backward(x, w, dy)
        again = gmm_mod.grouped_matmul_backward(x, w, dy)
        torch.cuda.synchronize()
        tc = gmm_mod.launches_bwd_tc - ntc
        if gmm_mod.launches_bwd - n0 != 4 or tc != (4 if dt == torch.bfloat16 else 0):
            fail(f"grouped_matmul_backward E{e} cap{cap} d{d} f{f}: "
                 f"{gmm_mod.launches_bwd - n0} launches, {tc} on the tensor cores")
        for name, gr, wt, ag in zip(("dx", "dw"), got, want, again):
            err = (gr.float() - wt.float()).abs().max().item()
            tol = GMM_BWD_RTOL[dt] * wt.float().abs().max().item()
            print(f"grouped_matmul_backward {name} E{e} cap{cap} d{d} f{f} {str(dt)[6:]}: "
                  f"max abs err {err:.3g} (tolerance {tol:.3g})")
            if not err <= tol:
                fail(f"grouped_matmul_backward {name} disagrees with its plain version: {err}")
            if not torch.equal(gr, ag):
                fail(f"grouped_matmul_backward {name}: a second call gave other bits")
            worst = max(worst, err)
        del x, w, dy, want, got, again
    return worst


def _scan_bwd_inputs(g, b, s, h, p, n, dt, broadcast, tail):
    x, a, bm, cm = _scan_inputs(g, b, s, h, p, n, dt, broadcast)
    dy = _randn(g, b, s, h, p, dtype=dt)
    dh = torch.randn(b, h, n, p, generator=g, device="cuda") if tail else None
    return x, a, bm, cm, dy, dh


def scan_bwd_vs_plain(g) -> tuple:
    """The scan's backward on the kernels (``ssm_scan.scan_backward``: three
    runs of the scan kernels, two for x = 1's normaliser in the models but
    three here, and the decay-gradient kernel) against the sequential
    ``ref.ssm_scan_backward`` at SCAN_BWD_SHAPES, and the decay-gradient
    kernel alone against ``ref.ssm_scan_da`` on the same dc and db.
    Returns the worst max abs errors (backward, decay gradient)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as scan_mod
    worst = worst_da = 0.0
    for label, (b, s, h, p, n, dt, bc, tail) in SCAN_BWD_SHAPES.items():
        x, a, bm, cm, dy, dh = _scan_bwd_inputs(g, b, s, h, p, n, dt, bc, tail)
        want = ref.ssm_scan_backward(x, a, bm, cm, dy, dh)
        n0 = (scan_mod.launches_bwd, scan_mod.launches_da)
        got = scan_mod.scan_backward(scan_mod._bwd_scan, x, a, bm, cm, dy, dh)
        torch.cuda.synchronize()
        if (scan_mod.launches_bwd - n0[0], scan_mod.launches_da - n0[1]) != (3 + tail, 1):
            fail(f"scan backward {label}: {scan_mod.launches_bwd - n0[0]} scans and "
                 f"{scan_mod.launches_da - n0[1]} decay-gradient launches")
        for name, gr, wt in zip(("dx", "da", "db", "dc"), got, want):
            err = (gr.float() - wt.float()).abs().max().item()
            rel = _rel_tol(dt, SCAN_BWD_RTOL) if name == "dx" else SCAN_BWD_RTOL
            tol = rel * wt.float().abs().max().item()
            print(f"scan backward {label} B{b} S{s} H{h} P{p} N{n} {str(dt)[6:]}"
                  f"{' dh_final' if tail else ''} {name}: max abs err {err:.3g} "
                  f"(tolerance {tol:.3g})")
            if not (bool(torch.isfinite(gr).all()) and err <= tol):
                fail(f"scan backward {label} {name} disagrees with its plain version: {err}")
            worst = max(worst, err)
        # the decay-gradient kernel alone, on the plain dc and db
        _, _, db, dc = want
        bias = None if dh is None else torch.randn(b, h, generator=g, device="cuda")
        da = scan_mod.ssm_scan_da(cm, dc, bm, db, a, bias)
        da_want = ref.ssm_scan_da(cm, dc, bm, db, a, bias)
        torch.cuda.synchronize()
        err = (da - da_want).abs().max().item()
        tol = 1e-4 * da_want.abs().max().item()
        print(f"ssm_scan_da {label}: max abs err {err:.3g} (tolerance {tol:.3g})")
        if not err <= tol:
            fail(f"ssm_scan_da {label} disagrees with its plain version: {err}")
        worst_da = max(worst_da, err)
        del x, a, bm, cm, dy, dh, want, got
    return worst, worst_da


# --------------------------------------------------------------------------
# 5. serve at full width
# --------------------------------------------------------------------------
def serve_phase(model) -> dict:
    phase("serve smollm_360m full width")
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import decode_step, init_cache
    cfg = model.cfg
    b, p, gen = SERVE_B, SERVE_PROMPT, SERVE_GEN
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (b, p)))
    serve(model, prompts[:, :4], 4)            # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    res = serve(model, prompts, gen, keep_logits=True)
    launches = read_counts()
    steps = p + gen - 1
    print(f"launches in the serve run: {launches} ({steps} decode steps)")
    if launches["decode_attention"] != cfg.num_layers * steps:
        fail(f"decode_attention ran {launches['decode_attention']} times, "
             f"expected {cfg.num_layers} x {steps}")
    peak = torch.cuda.max_memory_allocated()
    pre_tps, dec_tps = res.tokens_per_s(b, p, gen)
    toks = res.tokens
    if toks.shape != (b, gen) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"served tokens malformed: {tuple(toks.shape)}")
    if not bool(torch.isfinite(res.logits[..., :cfg.vocab_size]).all()):
        fail("served logits are not finite")

    # the same tokens, teacher-forced, with the plain attention on the card
    forced = torch.cat([prompts.cuda(), toks[:, :-1]], dim=1)
    with ops.plain_versions():
        plain = teacher_forced(model, forced, p + gen)
    v = cfg.vocab_size
    err = (res.logits[..., :v] - plain[..., :v]).abs().max().item()
    scale = plain[..., :v].abs().max().item()
    agree = (plain[:, p - 1:].argmax(-1) == toks).float().mean().item()
    tol = LOGITS_RTOL_OF_SCALE * scale
    print(f"serve logits vs plain-attention teacher forcing: max abs err {err:.4g} "
          f"(logit scale {scale:.3g}, tolerance {tol:.3g}); "
          f"greedy agreement {agree:.4f}")
    if not err <= tol:
        fail(f"served logits disagree with the plain path: {err}")
    n = 8

    def eight_steps():
        c = init_cache(cfg, b, n, device="cuda")
        for t in range(n):
            decode_step(model, c, forced[:, t],
                        torch.full((b,), t, dtype=torch.long, device="cuda"))
    busy = {f"step_{k}": v for k, v in
            busy_share(eight_steps, n, "decode step", "decode_kernel").items()}
    out = {"batch": b, "prompt": p, "gen": gen, "prefill_s": res.prefill_s,
           "decode_s": res.decode_s, "prefill_tok_s": pre_tps, "decode_tok_s": dec_tps,
           "decode_ms_per_step": 1e3 * res.decode_s / (gen - 1),
           "peak_mem_bytes": peak, "logits_max_abs_err": err, "greedy_agreement": agree,
           **busy}
    print(f"serve: prefill {pre_tps:.1f} tok/s, decode {dec_tps:.1f} tok/s "
          f"({out['decode_ms_per_step']:.2f} ms/step), peak memory {peak / 2**30:.3f} GiB")
    return {"serve": out, "launches": launches}


def busy_share(fn, per: int, label: str, kernels) -> dict:
    """Wall time of ``fn`` (unprofiled) and the card's busy time over the
    same work (``torch.profiler``), both divided by ``per`` units: how far
    the host holds the card back, and the device time of each of the port's
    ``kernels`` (names matched as substrings; one name or a tuple).  Returns
    {} when the profiler records no device activity."""
    kernels = (kernels,) if isinstance(kernels, str) else tuple(kernels)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        fn()
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = 1e3 * (time.perf_counter() - t0) / per
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print(f"{label} device busy time: not measured (the profiler saw no kernels)")
        return {}
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + 1e-3 * e.time_range.elapsed_us() / per
    busy_ms = sum(by_name.values())
    kernel_ms = {k: sum(ms for name, ms in by_name.items() if k in name) for k in kernels}
    print(f"{label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(share {busy_ms / wall_ms:.3f}), {len(events) / per:.0f} kernels; the port's "
          + ", ".join(f"{k} {ms:.4f} ms" for k, ms in kernel_ms.items()))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {ms:.4f} ms  {name[:100]}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms, "kernels": len(events) / per,
            **{f"{k}_ms": ms for k, ms in kernel_ms.items()},
            "top": [[name[:100], ms] for name, ms in top]}


# --------------------------------------------------------------------------
# 6. forward at full width
# --------------------------------------------------------------------------
def forward_phase(model) -> dict:
    phase("forward smollm_360m full width")
    from repro_torch.models import forward
    cfg = model.cfg
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (FWD_B, FWD_S))).cuda()
    forward(model, tokens=tokens[:, :8])       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    t0 = time.perf_counter()
    logits, _ = forward(model, tokens=tokens)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"launches in the forward run: {launches}")
    if launches["flash_attention"] != cfg.num_layers:
        fail(f"flash_attention ran {launches['flash_attention']} times, "
             f"expected {cfg.num_layers}")
    check_routes("smollm_360m forward", "flash_attention", cfg.num_layers)
    v = cfg.vocab_size
    if logits.shape != (FWD_B, FWD_S, cfg.padded_vocab_size) \
            or not bool(torch.isfinite(logits[..., :v]).all()):
        fail("forward logits malformed or not finite")

    dec = teacher_forced(model, tokens)[..., :v]
    err = (dec - logits[..., :v]).abs().max().item()
    tol = LOGITS_RTOL_OF_SCALE * dec.abs().max().item()
    agree = (dec.argmax(-1) == logits[..., :v].argmax(-1)).float().mean().item()
    print(f"forward vs teacher-forced decode over {FWD_S} positions: max abs err {err:.4g} "
          f"(tolerance {tol:.3g}); argmax agreement {agree:.4f}")
    if not err <= tol:
        fail(f"forward disagrees with decode: {err}")
    busy = busy_share(lambda: forward(model, tokens=tokens), 1, "forward", "flash_kernel")
    out = {"batch": FWD_B, "seq": FWD_S, "forward_s": fwd_s, **busy,
           "prefill_tok_s": FWD_B * FWD_S / fwd_s, "peak_mem_bytes": peak,
           "logits_max_abs_err_vs_decode": err, "argmax_agreement": agree}
    print(f"forward: {fwd_s * 1e3:.2f} ms for {FWD_B}x{FWD_S} tokens "
          f"({out['prefill_tok_s']:.0f} tok/s), peak memory {peak / 2**30:.3f} GiB")
    return {"forward": out, "launches": launches}



# --------------------------------------------------------------------------
# 6b. training smollm_360m at full width
# --------------------------------------------------------------------------
def _grads(model, batch) -> tuple:
    """One step's loss and every parameter's gradient (cloned; 0 for a
    parameter the loss does not reach, as in ``make_train_step``: xlstm's
    sLSTM weights of a block without an sLSTM), without the optimiser."""
    from repro_torch.models import loss_fn
    model.zero_grad(set_to_none=True)
    total, _ = loss_fn(model, batch)
    total.backward()
    grads = {n: p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return total.detach(), grads


def check_bwd_tc(label: str, n: int) -> None:
    """The flash backward ran ``n`` times since the counts were last set to
    0, every time on the tensor cores."""
    from repro_torch.kernels import flash_attention as flash_mod
    got = (flash_mod.launches_bwd, flash_mod.launches_bwd_tc)
    print(f"{label}: flash backward {got[0]} calls, {got[1]} on the tensor cores")
    if got != (n, n):
        fail(f"{label}: flash backward calls (all, tensor cores) {got}, expected ({n}, {n})")


def train_phase() -> dict:
    """smollm_360m at full width and depth (bf16 parameters, f32 moments,
    ``remat="full"``), batch 8 x 256 from ``SyntheticLM``.

    (1) one step's loss and gradients with the kernels against the same step
    on the plain versions on the card, with exact launch counts: 64 forward
    flash launches a step (each layer again under remat), all on the tensor
    cores with lse, and 32 backward ones; no other kernel.  (2) The main
    path: 30 steps of ``launch/train.py``'s loop at peak learning rate
    TRAIN_LR with a checkpoint at step 10 (counts set to 0 just before it,
    read just after); the loss falls.
    (3) A second run stopped after its step-10 checkpoint and resumed from
    it in the same process gives the same losses, parameters and moments,
    bit for bit.  (4) Step wall time, device busy time and share, tokens/s,
    peak memory and the top device kernels."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticLM, make_device_batch
    from repro_torch.distributed.step import make_train_step
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.models import init_params
    cfg = get_config("smollm_360m")
    phase("train smollm_360m full width")
    if cfg.remat != "full":
        fail(f"smollm_360m's remat is {cfg.remat!r}, the phase expects 'full'")
    fwd_per_step, bwd_per_step = 2 * cfg.num_layers, cfg.num_layers
    want = {"flash_attention": fwd_per_step, "flash_attention_bwd": bwd_per_step}
    ds = SyntheticLM(cfg, ShapeConfig("train", TRAIN_S, TRAIN_B, "train"), seed=0)
    batch = make_device_batch(ds.batch_at(0), "cuda")
    out = {"batch": TRAIN_B, "seq": TRAIN_S, "steps": TRAIN_STEPS}

    # (1) kernels against plain versions on one step
    model = init_params(cfg, seed=0, device="cuda").requires_grad_(True)
    _grads(model, batch)                        # warm-up: builds, cuBLAS handles
    torch.cuda.synchronize()
    zero_counts()
    loss_k, g_k = _grads(model, batch)
    torch.cuda.synchronize()
    got = read_counts()
    print(f"launches in one training step: {got}")
    check_counts("train step", got, want)
    check_routes("train step", "flash_attention", fwd_per_step)
    check_bwd_tc("train step", bwd_per_step)
    with ops.plain_versions():
        loss_p, g_p = _grads(model, batch)
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    rel = {n: ((g_k[n].float() - g_p[n].float()).norm()
               / g_p[n].float().norm().clamp_min(1e-30)).item() for n in g_p}
    worst = max(rel, key=rel.get)
    print(f"train step, kernels vs plain versions: loss {loss_k.item():.6f} vs "
          f"{loss_p.item():.6f} (rel {loss_rel:.3g}, tolerance {TRAIN_LOSS_RTOL}); gradient "
          f"difference, relative norm: largest {rel[worst]:.4g} ({worst}), median "
          f"{sorted(rel.values())[len(rel) // 2]:.4g} (tolerance {TRAIN_GRAD_RTOL})")
    if not all(torch.isfinite(g.float()).all() for g in g_k.values()):
        fail("train step: a gradient is not finite")
    if not loss_rel <= TRAIN_LOSS_RTOL:
        fail(f"train step: the loss with the kernels is {loss_rel} off the plain one")
    if not rel[worst] <= TRAIN_GRAD_RTOL:
        fail(f"train step: {worst}'s gradient is {rel[worst]} off the plain one")
    out["vs_plain"] = {"loss_rel_err": loss_rel, "grad_rel_norm_max": rel[worst],
                       "grad_rel_norm_max_param": worst,
                       "grad_rel_norm_median": sorted(rel.values())[len(rel) // 2]}
    del model, g_k, g_p

    # (2) the main path: launch/train.py's loop, 30 steps, checkpoint at 10
    root = tempfile.mkdtemp(prefix="repro_torch_train_")
    kw = dict(steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S, lr=TRAIN_LR,
              ckpt_every=TRAIN_CKPT, log_every=TRAIN_CKPT, device="cuda", keep=1)
    try:
        zero_counts()
        straight = train_mod.train(cfg, workdir=os.path.join(root, "a"), **kw)
        got = read_counts()
        print(f"launches in the {TRAIN_STEPS}-step run: {got}")
        check_counts("train loop", got, {k: n * TRAIN_STEPS for k, n in want.items()})
        check_routes("train loop", "flash_attention", fwd_per_step * TRAIN_STEPS)
        check_bwd_tc("train loop", bwd_per_step * TRAIN_STEPS)
        launches = got
        losses = straight.losses
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        print(f"train loop: {straight.wall_s:.2f} s with checkpoints; loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, mean of the first 5 steps {first:.4f}, of the last 5 "
              f"{last:.4f}")
        if not all(np.isfinite(losses)) or not last < first:
            fail(f"train loop: the loss did not fall ({first} -> {last})")
        out.update(losses=losses, loop_wall_s=straight.wall_s)

        # (3) stop after the step-10 checkpoint, resume in this process
        cut = train_mod.train(cfg, workdir=os.path.join(root, "b"), stop_after=TRAIN_CKPT, **kw)
        del cut
        resumed = train_mod.train(cfg, workdir=os.path.join(root, "b"), **kw)
        if resumed.start != TRAIN_CKPT:
            fail(f"the resumed run began at step {resumed.start}, not {TRAIN_CKPT}")
        diff = max(abs(a - b) for a, b in zip(resumed.losses, losses[TRAIN_CKPT:]))
        same_state = all(torch.equal(p, q) for p, q in zip(straight.model.parameters(),
                                                            resumed.model.parameters()))
        same_state &= all(torch.equal(straight.opt.m[n], resumed.opt.m[n])
                          and torch.equal(straight.opt.v[n], resumed.opt.v[n])
                          for n in straight.opt.m)
        print(f"resumed from step {TRAIN_CKPT}: losses of steps {TRAIN_CKPT}-{TRAIN_STEPS - 1} "
              f"{'bit-equal to' if diff == 0 else f'{diff:.3g} off'} the straight run's; "
              f"final parameters and moments {'bit-equal' if same_state else 'differ'}")
        if diff != 0 or not same_state:
            fail("the resumed run differs from the straight run")
        out["resume"] = {"from_step": TRAIN_CKPT, "loss_max_abs_diff": diff,
                         "state_bit_equal": same_state}
        del resumed

        # (4) numbers: steps on, from the straight run's state, no checkpoints
        model, opt = straight.model, straight.opt
        step_fn = make_train_step(cfg, model, peak_lr=TRAIN_LR, warmup=train_mod.WARMUP,
                                  total_steps=TRAIN_STEPS)
        holder = {"opt": opt}

        def steps(n):
            for i in range(n):
                holder["opt"], _ = step_fn(holder["opt"], make_device_batch(
                    ds.batch_at(TRAIN_STEPS + i), "cuda"))
        steps(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        steps(5)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / 5
        peak = torch.cuda.max_memory_allocated()
        busy = busy_share(lambda: steps(2), 2, "train step", ("flash_kernel_tc",
                                                               "flash_bwd_"))
        out.update(step_ms=step_ms, tokens_per_s=TRAIN_B * TRAIN_S / (step_ms / 1e3),
                   peak_mem_bytes=peak, busy=busy)
        print(f"train step: {step_ms:.2f} ms wall ({out['tokens_per_s']:.0f} tokens/s), "
              f"peak memory {peak / 2**30:.3f} GiB")
        del straight, model, opt, holder, step_fn
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"train": out, "launches": launches}


# --------------------------------------------------------------------------
# 6c. training the moe, hybrid and ssm families
# --------------------------------------------------------------------------
def expected_train_launches(cfg) -> dict:
    """Launches of one training step (remat "full": every block's forward
    runs twice), derived from the config as ``expected_launches``: the
    forward kernels, the flash backward once an attention layer, dX and dW a
    grouped matmul, three scans a Mamba2 or mLSTM scan's backward (dx, db,
    dc) and two the normaliser's (x = 1 asks for no dx), and one
    decay-gradient launch a scan."""
    fwd, _ = expected_launches(cfg)
    runs = 2 if cfg.remat == "full" else 1
    want = {k: runs * n for k, n in fwd.items() if n}
    attn, gmm, scan = fwd["flash_attention"], fwd["grouped_matmul"], fwd["ssm_scan"]
    if attn:
        want["flash_attention_bwd"] = attn
    if gmm:
        want["grouped_matmul_bwd"] = 2 * gmm
    if scan:
        want["ssm_scan_bwd"] = 3 * cfg.num_layers + (2 * cfg.num_layers
                                                     if cfg.family == "ssm" else 0)
        want["ssm_scan_da"] = scan
    return want


def check_train_routes(label: str, want: dict, bf16: bool) -> None:
    """In bf16 every flash launch, forward and backward, and every grouped
    matmul, forward, dX and dW, took the tensor cores; in f32 the CUDA
    cores.  Prints the grouped matmul backward's tensor-core share."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import grouped_matmul as gmm_mod
    for name, mod in (("flash_attention", flash_mod), ("grouped_matmul", gmm_mod)):
        n, nb = want.get(name, 0), want.get(f"{name}_bwd", 0)
        if not n:
            continue
        check_routes(label, name, n if bf16 else 0, 0 if bf16 else n)
        got = (mod.launches_bwd, mod.launches_bwd_tc)
        print(f"{label}: {name} backward {got[0]} launches, {got[1]} on the tensor cores"
              + (f" (share {got[1] / got[0]:.3f})" if got[0] else ""))
        if got != (nb, nb if bf16 else 0):
            fail(f"{label}: {name} backward launches (all, tensor cores) {got}, expected "
                 f"({nb}, {nb if bf16 else 0})")


def train_family_phase(arch: str) -> dict:
    """One model of the moe, hybrid or ssm family, batch 8 x 256 of
    ``SyntheticLM``, remat "full".

    (1) One step's loss and gradients at full width and depth with the
    kernels against the same step on the plain versions on the card, with
    exact counts (``expected_train_launches``): granite in bf16 with the
    kernel run's expert choices replayed (the log covers the recompute's
    routing calls too, in reverse layer order, and the kernel run's
    recompute must choose its own forward's experts), zamba2 and xlstm on an
    f32 copy of the weights (chaotic in bf16: ``family_phase``).  (2) The
    main path: ``launch/train.py``'s loop in bf16 at full width, depth cut
    (FAMILY_TRAIN), FAMILY_STEPS steps at TRAIN_LR with a checkpoint at
    FAMILY_CKPT (counts set to 0 just before it, read just after); the loss
    falls.  (3) A run stopped after that checkpoint and resumed is bit-equal
    to the straight one.  (4) At full width and depth in bf16: step wall
    time, tokens/s, device busy time and share, peak memory, top kernels."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticLM, make_device_batch
    from repro_torch.distributed.step import make_train_step
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.models import Model, init_params
    from repro_torch.optim import adamw_init
    spec = FAMILY_TRAIN[arch]
    cfg = get_config(arch)
    phase(f"train {arch} full width")
    if cfg.remat != "full":
        fail(f"{arch}'s remat is {cfg.remat!r}, the phase expects 'full'")
    moe = cfg.family == "moe"
    bf16 = spec["check_dtype"] == "bfloat16"
    ds = SyntheticLM(cfg, ShapeConfig("train", TRAIN_S, TRAIN_B, "train"), seed=0)
    batch = make_device_batch(ds.batch_at(0), "cuda")
    want = expected_train_launches(cfg)
    out = {"batch": TRAIN_B, "seq": TRAIN_S, "check_dtype": spec["check_dtype"]}
    model = init_params(cfg, seed=0, device="cuda")

    # (1) one step against the plain versions
    check_model = model
    if not bf16:
        cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
        check_model = Model(cfg32, "cuda")
        check_model.load_state_dict({k: t.float() for k, t in model.state_dict().items()})
    check_model.requires_grad_(True)
    routes, stats = [], {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zero_counts()
    with moe_routes(routes, False, stats) if moe else contextlib.nullcontext():
        loss_k, g_k = _grads(check_model, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    got = read_counts()
    print(f"launches in one training step ({spec['check_dtype']}, {step_s:.2f} s): {got}")
    check_counts(f"{arch} train step", got, want)
    check_train_routes(f"{arch} train step", want, bf16)
    if moe:                                    # forward calls, then the recompute's
        layers = len(routes) // 2
        if len(routes) != 2 * cfg.num_layers // cfg.moe_every:
            fail(f"{arch}: {len(routes)} routing calls in a step, expected "
                 f"{2 * cfg.num_layers // cfg.moe_every}")
        flips = sum(int((routes[i] != routes[2 * layers - 1 - i]).any(dim=-1).sum())
                    for i in range(layers))
        print(f"{arch} train step: the recompute chose other experts than the forward in "
              f"{flips} of {layers * routes[0].shape[0]} (token, layer) slots")
        if flips:
            fail(f"{arch}: the recompute's routing differs from the forward's")
        out["recompute_route_flips"] = flips
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with ops.plain_versions(), (moe_routes(routes, True, stats) if moe
                                else contextlib.nullcontext()):
        loss_p, g_p = _grads(check_model, batch)
        plain_peak = torch.cuda.max_memory_allocated()
    plain_s = time.perf_counter() - t0
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    rel = {n: ((g_k[n].float() - g_p[n].float()).norm()
               / g_p[n].float().norm().clamp_min(1e-30)).item() for n in g_p}
    worst = max(rel, key=rel.get)
    median = sorted(rel.values())[len(rel) // 2]
    print(f"{arch} train step ({spec['check_dtype']}), kernels vs plain versions: loss "
          f"{loss_k.item():.6f} vs {loss_p.item():.6f} (rel {loss_rel:.3g}, tolerance "
          f"{TRAIN_LOSS_RTOL}); gradient difference, relative norm: largest {rel[worst]:.4g} "
          f"({worst}), median {median:.4g} (tolerance {TRAIN_GRAD_RTOL}); the plain step "
          f"{plain_s:.1f} s, peak memory {plain_peak / 2**30:.2f} GiB")
    if not all(torch.isfinite(gr.float()).all() for gr in g_k.values()):
        fail(f"{arch} train step: a gradient is not finite")
    if not loss_rel <= TRAIN_LOSS_RTOL:
        fail(f"{arch} train step: the loss with the kernels is {loss_rel} off the plain one")
    if not rel[worst] <= TRAIN_GRAD_RTOL:
        fail(f"{arch} train step: {worst}'s gradient is {rel[worst]} off the plain one")
    out["vs_plain"] = {"loss_rel_err": loss_rel, "grad_rel_norm_max": rel[worst],
                       "grad_rel_norm_max_param": worst, "grad_rel_norm_median": median,
                       "plain_peak_mem_bytes": plain_peak, "kernel_step_s": step_s,
                       "plain_step_s": plain_s}
    if moe:
        out["vs_plain"]["routing"] = route_report(f"{arch} train step, plain run", stats)
    del check_model, g_k, g_p, routes
    torch.cuda.empty_cache()

    # (2) the main path: launch/train.py's loop at full width, depth cut
    cut = dataclasses.replace(cfg, num_layers=spec["loop_layers"])
    per_step = expected_train_launches(cut)
    root = tempfile.mkdtemp(prefix="repro_torch_train_")
    kw = dict(steps=FAMILY_STEPS, batch=TRAIN_B, seq=TRAIN_S, lr=TRAIN_LR,
              ckpt_every=FAMILY_CKPT, log_every=FAMILY_CKPT, device="cuda", keep=1)
    try:
        zero_counts()
        straight = train_mod.train(cut, workdir=os.path.join(root, "a"), **kw)
        got = read_counts()
        print(f"launches in the {FAMILY_STEPS}-step run ({cut.num_layers} layers): {got}")
        check_counts(f"{arch} train loop", got, {k: n * FAMILY_STEPS for k, n in per_step.items()})
        check_train_routes(f"{arch} train loop",
                           {k: n * FAMILY_STEPS for k, n in per_step.items()}, True)
        launches = got
        losses = straight.losses
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        print(f"{arch} train loop ({cut.num_layers} layers): {straight.wall_s:.2f} s with "
              f"checkpoints; loss {losses[0]:.4f} -> {losses[-1]:.4f}, mean of the first 5 "
              f"steps {first:.4f}, of the last 5 {last:.4f}")
        if not all(np.isfinite(losses)) or not last < first:
            fail(f"{arch} train loop: the loss did not fall ({first} -> {last})")
        out.update(loop_layers=cut.num_layers, loop_steps=FAMILY_STEPS, losses=losses,
                   loop_wall_s=straight.wall_s)
        # (3) stop after the checkpoint, resume in this process
        t0 = time.perf_counter()
        train_mod.train(cut, workdir=os.path.join(root, "b"), stop_after=FAMILY_CKPT, **kw)
        resumed = train_mod.train(cut, workdir=os.path.join(root, "b"), **kw)
        out["resume_s"] = time.perf_counter() - t0
        if resumed.start != FAMILY_CKPT:
            fail(f"{arch}: the resumed run began at step {resumed.start}, not {FAMILY_CKPT}")
        diff = max(abs(a - b) for a, b in zip(resumed.losses, losses[FAMILY_CKPT:]))
        same = all(torch.equal(p, q) for p, q in zip(straight.model.parameters(),
                                                      resumed.model.parameters()))
        same &= all(torch.equal(straight.opt.m[n], resumed.opt.m[n])
                    and torch.equal(straight.opt.v[n], resumed.opt.v[n]) for n in straight.opt.m)
        print(f"{arch} resumed from step {FAMILY_CKPT}: losses "
              f"{'bit-equal to' if diff == 0 else f'{diff:.3g} off'} the straight run's; final "
              f"parameters and moments {'bit-equal' if same else 'differ'} (the cut run and "
              f"the resumed one {out['resume_s']:.1f} s)")
        if diff != 0 or not same:
            fail(f"{arch}: the resumed run differs from the straight run")
        out["resume"] = {"from_step": FAMILY_CKPT, "loss_max_abs_diff": diff,
                         "state_bit_equal": same}
        del straight, resumed
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # (4) numbers at full width and depth, bf16
    step_fn = make_train_step(cfg, model, peak_lr=TRAIN_LR, warmup=train_mod.WARMUP,
                              total_steps=FAMILY_STEPS)
    holder = {"opt": adamw_init(dict(model.named_parameters()), cfg.optim_state_dtype,
                                cfg.optim_second_dtype)}

    def steps(n):
        for i in range(n):
            holder["opt"], _ = step_fn(holder["opt"], make_device_batch(ds.batch_at(i), "cuda"))
    torch.cuda.reset_peak_memory_stats()
    kernels = {"moe": ("gemm_kernel", "flash_kernel_tc", "flash_bwd_"),
               "hybrid": ("ssm_scan_", "ssm_scan_da", "flash_kernel_tc", "flash_bwd_"),
               "ssm": ("ssm_scan_", "ssm_scan_da")}[cfg.family]
    busy = busy_share(lambda: steps(1), 1, f"{arch} train step", kernels)
    peak = torch.cuda.max_memory_allocated()
    step_ms = busy.get("wall_ms", float("nan"))
    out.update(step_ms=step_ms, tokens_per_s=TRAIN_B * TRAIN_S / (step_ms / 1e3),
               peak_mem_bytes=peak, busy=busy)
    print(f"{arch} train step: {step_ms:.2f} ms wall ({out['tokens_per_s']:.0f} tokens/s), "
          f"peak memory {peak / 2**30:.3f} GiB")
    del model, step_fn, holder
    torch.cuda.empty_cache()
    return {"train": out, "launches": launches}


# --------------------------------------------------------------------------
# 7. the moe, hybrid and ssm families at full width
# --------------------------------------------------------------------------
def expected_launches(cfg) -> tuple:
    """Launches of the LM kernels in one forward and in one decode step."""
    attn = {"moe": cfg.num_layers, "hybrid": cfg.num_layers // max(cfg.attn_every, 1),
            "ssm": 0}[cfg.family]
    gmm = 3 * (cfg.num_layers // cfg.moe_every) if cfg.family == "moe" else 0
    scan = {"hybrid": cfg.num_layers, "ssm": 2 * cfg.num_layers}.get(cfg.family, 0)
    return ({"flash_attention": attn, "grouped_matmul": gmm, "ssm_scan": scan},
            {"decode_attention": attn, "grouped_matmul": gmm})


def check_counts(label: str, got: dict, want: dict) -> None:
    """Every kernel ran exactly as often as ``want`` says (absent: never)."""
    for name, n in got.items():
        if n != want.get(name, 0):
            fail(f"{label}: {name} ran {n} times, expected {want.get(name, 0)}")


def logits_info(label: str, got: torch.Tensor, want: torch.Tensor, v: int) -> dict:
    """Max abs error over the real vocabulary, the largest |logit| of
    ``want`` and the argmax agreement, printed."""
    got, want = got[..., :v].float(), want[..., :v].float()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"{label}: max abs err {err:.4g} (logit scale {scale:.3g}, "
          f"{err / scale:.4f} of it); argmax agreement {agree:.4f}")
    return {"max_abs_err": err, "logit_scale": scale, "argmax_agreement": agree}


def logits_check(label: str, got: torch.Tensor, want: torch.Tensor, v: int) -> dict:
    """``logits_info``, failing unless every logit is finite and the max abs
    error is within LOGITS_RTOL_OF_SCALE of the largest |logit| of ``want``."""
    if not bool(torch.isfinite(got[..., :v]).all()):
        fail(f"{label}: logits are not finite")
    info = logits_info(label, got, want, v)
    tol = LOGITS_RTOL_OF_SCALE * info["logit_scale"]
    print(f"  tolerance {tol:.3g}")
    if not info["max_abs_err"] <= tol:
        fail(f"{label}: logits disagree: {info['max_abs_err']} > {tol}")
    return info


def route_report(label: str, stats: dict) -> dict:
    """The replayed run's own routing against the recorded one."""
    rep = {"slots": stats.get("slots", 0), "flips": stats.get("flips", 0),
           "max_margin": stats.get("max_margin", 0.0)}
    print(f"{label}: the plain run's own top k differs from the kernel run's in "
          f"{rep['flips']} of {rep['slots']} (token, layer) slots; largest probability "
          f"margin of a differing slot {rep['max_margin']:.3g}")
    return rep


def _add(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


@contextlib.contextmanager
def moe_routes(log: list, replay: bool, stats: dict):
    """Records every MoE layer's expert choices, in call order, into ``log``;
    or (``replay``) routes each layer's tokens to the recorded experts, with
    gate values from this run's own router probabilities, and counts in
    ``stats`` the (token, layer) slots whose own top k differs from the
    recorded one, with the largest probability margin of such a slot.

    Why: with seeded random weights granite's router is near-uniform (the
    8th and 9th largest of 32 probabilities are often closer than bf16's
    resolution of the activations), so one-ulp differences upstream flip
    expert choices, and each flip moves a token's logits by several percent
    of their scale: two plain versions that differ only in f32 vs f64 sums
    in the grouped matmul disagree by more than the logit tolerance
    (measured in PERF.md).  Replaying the kernel run's choices into the
    plain run holds every kernel, and the dispatch and combine around it,
    to the plain versions on the same discrete routing; the routing itself
    (plain PyTorch in both runs) is held to the JAX package's by the CPU
    tests."""
    from repro_torch.models import moe as MOE
    orig = MOE.route
    calls = iter(list(log))

    def patched(p, xf, cfg):
        probs, vals, ids = orig(p, xf, cfg)
        if not replay:
            log.append(ids)
            return probs, vals, ids
        want = next(calls)
        differ = (ids.sort(dim=-1).values != want.sort(dim=-1).values).any(dim=-1)
        stats["slots"] = stats.get("slots", 0) + differ.numel()
        stats["flips"] = stats.get("flips", 0) + int(differ.sum())
        if bool(differ.any()):
            margin = probs.gather(1, ids).amin(-1) - probs.gather(1, want).amin(-1)
            stats["max_margin"] = max(stats.get("max_margin", 0.0),
                                      margin[differ].max().item())
        vals = probs.gather(1, want)
        if cfg.experts_per_token > 1:
            vals = vals / vals.sum(dim=-1, keepdim=True)
        return probs, vals, want

    MOE.route = patched
    try:
        yield
    finally:
        MOE.route = orig


def teacher_forced(model, tokens: torch.Tensor, max_seq: int = 0) -> torch.Tensor:
    """Logits (B, S, Vpad) of ``tokens`` (B, S) fed one step at a time
    through ``decode_step`` from an empty cache of ``max_seq`` (default S)."""
    from repro_torch.models import decode_step, init_cache
    b, s = tokens.shape
    cache = init_cache(model.cfg, b, max_seq or s, device="cuda")
    return torch.stack([decode_step(model, cache, tokens[:, t],
                                    torch.full((b,), t, dtype=torch.long, device="cuda"))[0]
                        for t in range(s)], dim=1)


def hold(label: str, run, v: int, moe: bool, check: bool = True) -> dict:
    """``run()`` -> (logits, aux) once through the kernels and once through
    the plain versions (for the moe family with the kernel run's expert
    choices replayed); the logits held to LOGITS_RTOL_OF_SCALE when
    ``check``, else only reported."""
    from repro_torch.kernels import ops
    routes, stats = [], {}
    with moe_routes(routes, False, stats) if moe else contextlib.nullcontext():
        got, aux = run()
    with ops.plain_versions(), (moe_routes(routes, True, stats) if moe
                                else contextlib.nullcontext()):
        want, want_aux = run()
    label += " (kernel run's expert choices replayed)" if moe else ""
    info = (logits_check if check else logits_info)(label, got, want, v)
    if moe:
        info["routing"] = route_report(label, stats)
    if aux is not None:
        info["aux"], info["plain_aux"] = aux.item(), want_aux.item()
        print(f"{label}: aux loss {aux.item():.6g}, plain {want_aux.item():.6g}")
        if check and not abs(aux.item() - want_aux.item()) <= \
                LOGITS_RTOL_OF_SCALE * abs(want_aux.item()):
            fail(f"{label}: aux loss {aux.item()} disagrees with the plain {want_aux.item()}")
    return info


def family_phase(arch: str) -> dict:
    """One model of the moe, hybrid or ssm family at full width and depth:
    the main path (a serve and a forward in bf16, seeded random weights,
    every count set to 0 just before each and read just after), then the
    checks.  granite_moe_1b is held in bf16 against the plain versions with
    the kernel run's expert choices replayed (``moe_routes``).  zamba2 and
    xlstm are held in f32, on an f32 copy of the same weights, at the same
    shapes (serve, forward, and teacher-forced decode against the forward):
    with random weights both are chaotic (a small move of one embedding row
    moves the f32 logits by a large part of their scale), so two bf16
    computations that round at different places decorrelate: the bf16
    forward's difference is printed, not checked (PERF.md has the
    measurements, on the H100)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model, decode_step, forward, init_cache, init_params
    spec = FAMILIES[arch]
    cfg = get_config(arch)
    phase(f"{arch} full width")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model {cfg.name} ({cfg.family}): {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"params {n_params}, {cfg.param_dtype}; init {time.perf_counter() - t0:.1f}s")
    fwd_per, dec_per = expected_launches(cfg)
    # granite's grouped matmuls all take the tensor-core route (checked below);
    # the scan's four kernels (C B^T, chunk states, pass, readout) share the prefix
    # "ssm_scan_"; the decode step's profile also reads the decode attention
    # kernel
    kernel = "gemm_kernel" if cfg.family == "moe" else "ssm_scan_"
    decode_kernels = (kernel, "decode_kernel") if dec_per.get("decode_attention") else kernel
    moe = cfg.family == "moe"
    v = cfg.vocab_size
    launches = {}
    out = {"params": n_params}

    # main path 1: serve (teacher-forced prefill + greedy decode)
    b, p, gen = spec["serve"]
    steps = p + gen - 1
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, v, (b, p)))
    serve(model, prompts[:, :4], 4)            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res = serve(model, prompts, gen, keep_logits=True)
    got = read_counts()
    _add(launches, got)
    print(f"launches in the serve run: {got} ({steps} decode steps)")
    check_counts(f"{arch} serve", got, {k: n * steps for k, n in dec_per.items()})
    if moe:
        check_routes(f"{arch} serve", "grouped_matmul", got["grouped_matmul"])
    serve_peak = torch.cuda.max_memory_allocated()
    toks = res.tokens
    if toks.shape != (b, gen) or not bool(((toks >= 0) & (toks < v)).all()):
        fail(f"{arch}: served tokens malformed: {tuple(toks.shape)}")
    if not bool(torch.isfinite(res.logits[..., :v]).all()):
        fail(f"{arch}: served logits are not finite")
    pre_tps, dec_tps = res.tokens_per_s(b, p, gen)
    out["serve"] = {"batch": b, "prompt": p, "gen": gen, "prefill_tok_s": pre_tps,
                    "decode_tok_s": dec_tps, "decode_ms_per_step": 1e3 * res.decode_s / (gen - 1),
                    "peak_mem_bytes": serve_peak}
    print(f"{arch} serve: prefill {pre_tps:.1f} tok/s, decode {dec_tps:.1f} tok/s "
          f"({out['serve']['decode_ms_per_step']:.2f} ms/step), peak memory "
          f"{serve_peak / 2**30:.3f} GiB")
    forced = torch.cat([prompts.cuda(), toks[:, :-1]], dim=1)
    served_logits = res.logits
    del res

    # main path 2: forward (prefill)
    fb, fs = spec["forward"]
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, v, (fb, fs))).cuda()
    forward(model, tokens=tokens[:, :64])      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    logits, _ = forward(model, tokens=tokens)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    got = read_counts()
    _add(launches, got)
    fwd_peak = torch.cuda.max_memory_allocated()
    print(f"launches in the forward run: {got}")
    check_counts(f"{arch} forward", got, fwd_per)
    if moe:
        check_routes(f"{arch} forward", "grouped_matmul", got["grouped_matmul"])
    check_routes(f"{arch} forward", "flash_attention", got["flash_attention"])
    if logits.shape != (fb, fs, cfg.padded_vocab_size) \
            or not bool(torch.isfinite(logits[..., :v]).all()):
        fail(f"{arch}: forward logits malformed or not finite")
    out["forward"] = {"batch": fb, "seq": fs, "forward_s": fwd_s, "prefill_tok_s": fb * fs / fwd_s,
                      "peak_mem_bytes": fwd_peak}
    print(f"{arch} forward: {fwd_s * 1e3:.2f} ms for {fb}x{fs} tokens "
          f"({fb * fs / fwd_s:.0f} tok/s), peak memory {fwd_peak / 2**30:.3f} GiB")

    # the kernel path repeats bit for bit (no atomics on it)
    again = teacher_forced(model, forced, p + gen)
    out["serve"]["rerun_max_abs_err"] = (again - served_logits).abs().max().item()
    fwd_again, _ = forward(model, tokens=tokens)
    out["forward"]["rerun_max_abs_err"] = (fwd_again - logits).abs().max().item()
    print(f"{arch} the kernels again on the same tokens: serve max abs err "
          f"{out['serve']['rerun_max_abs_err']:.4g}, forward "
          f"{out['forward']['rerun_max_abs_err']:.4g}")
    del fwd_again, served_logits, logits

    def serve_run(m):
        return lambda: (teacher_forced(m, forced, p + gen), None)

    def forward_run(m, t):
        return lambda: forward(m, tokens=t)

    bf16 = spec["check_dtype"] == "bfloat16"
    if bf16:
        out["serve"]["bf16_vs_plain"] = hold(
            f"{arch} serve logits (bf16) vs plain teacher forcing", serve_run(model), v, moe)
    out["forward"]["bf16_vs_plain"] = hold(
        f"{arch} forward {fb}x{fs} (bf16) vs plain forward", forward_run(model, tokens), v,
        moe, check=bf16)
    if moe:
        from repro_torch.kernels import ops
        with ops.plain_versions():
            free = teacher_forced(model, forced, p + gen)
        out["serve"]["unreplayed"] = logits_info(
            f"{arch} serve logits vs plain teacher forcing, routing free (not checked)",
            again, free, v)
        del free
    del again
    if not bf16:                               # the checks, in f32
        cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
        m32 = Model(cfg32, "cuda")
        m32.load_state_dict({k: t.float() for k, t in model.state_dict().items()})
        out["serve"]["f32_vs_plain"] = hold(
            f"{arch} serve logits (f32 copy) vs plain teacher forcing", serve_run(m32), v,
            moe)
        out["forward"]["f32_vs_plain"] = hold(
            f"{arch} forward {fb}x{fs} (f32 copy) vs plain forward",
            forward_run(m32, tokens), v, moe)
        cb, cs = spec["consistency"]           # teacher-forced decode == forward
        ctoks = tokens[:cb, :cs].contiguous()
        full, _ = forward(m32, tokens=ctoks)
        out["decode_vs_forward_f32"] = logits_check(
            f"{arch} teacher-forced decode vs forward over {cb}x{cs} (f32 copy)",
            teacher_forced(m32, ctoks), full, v)
        del m32, full

    n = 8

    def eight_steps():
        c = init_cache(cfg, b, n, device="cuda")
        for t in range(n):
            decode_step(model, c, forced[:, t], torch.full((b,), t, dtype=torch.long,
                                                          device="cuda"))
    out["decode_busy"] = busy_share(eight_steps, n, f"{arch} decode step", decode_kernels)
    out["forward_busy"] = busy_share(lambda: forward(model, tokens=tokens), 1,
                                     f"{arch} forward", kernel)
    del model, tokens, forced
    torch.cuda.empty_cache()
    return {"summary": out, "launches": launches}

# --------------------------------------------------------------------------
# 8. the compile path's probe
# --------------------------------------------------------------------------
def probe_phase() -> None:
    phase("probe")
    from repro_torch.core.backend_cuda import cuda_supported
    from repro_torch.kernels import probe as pmod
    n0 = pmod.launches
    ok = cuda_supported()
    print(f"cuda_supported() = {ok}; probe launches {pmod.launches - n0}")
    if ok is not True or pmod.launches - n0 != 1:
        fail("the CUDA probe did not pass with exactly one launch")


# --------------------------------------------------------------------------
# 4. contraction kernel vs plain version (and the probe kernel vs x + 1)
# --------------------------------------------------------------------------
def sched_contraction(handle, t: int) -> None:
    """The schedule of tests/test_backend_pallas.py for a 3-dim contraction
    statement (i, j, k): tile (i, j) by t, split k by t, the intra-tile
    loops innermost and fully unrolled, the k tile loop pipelined."""
    i, j, k = handle.stmt.dims
    handle.tile(i, j, t, t, i + "_o", j + "_o", i + "_i", j + "_i")
    handle.split(k, t, k + "_o", k + "_i")
    handle.stmt.domain = handle.stmt.domain.permute(
        [i + "_o", j + "_o", k + "_o", i + "_i", j + "_i", k + "_i"])
    for d in (i + "_i", j + "_i", k + "_i"):
        handle.unroll(d, t)
    handle.pipeline(k + "_o", 1)


def _tiled(build, t: int):
    """A workload with every statement scheduled by ``sched_contraction``."""
    from repro_torch.core.dsl import ComputeHandle
    f = build()
    for s in f.fn.statements:
        sched_contraction(ComputeHandle(s), t)
    return f


def _matvec(n: int, t: int):
    from repro_torch.core import dsl as pom
    with pom.function("mv") as f:
        i, j = pom.var("i", 0, n), pom.var("j", 0, n)
        A = pom.placeholder("A", (n, n))
        p = pom.placeholder("p", (n,))
        q = pom.placeholder("q", (n,))
        s = pom.compute("s", [i, j], q(i) + A(i, j) * p(j), q(i))
    s.tile("i", "j", t, t, "i0", "j0", "i1", "j1")
    s.unroll("i1", t)
    s.unroll("j1", t)
    s.pipeline("j0", 1)
    return f


def contraction_phase() -> tuple:
    """Max abs errors of the contraction (f32) and probe kernels against
    their plain versions."""
    phase("contraction vs plain")
    from repro_torch import workloads as W
    from repro_torch.core.backend_cuda import lower_stmt_cuda
    from repro_torch.kernels import contraction as cmod
    from repro_torch.kernels import ref
    cases = [("gemm n256 t32", lambda: _tiled(lambda: W.gemm(256), 32), 1),
             ("gemm n256 unscheduled", lambda: W.gemm(256), 1),
             ("matvec n1024 t32", lambda: _matvec(1024, 32), 1),
             ("conv (8,4,6,6)", lambda: W.conv_nest("conv", 8, 4, 6, 6), 1),
             ("conv (64,16,30,30)", lambda: W.conv_nest("conv", 64, 16, 30, 30), 1),
             ("gemm n128 t32 batch 8", lambda: _tiled(lambda: W.gemm(128), 32), 8),
             (f"gemm n{POM_N} t{POM_T}", lambda: _tiled(lambda: W.gemm(POM_N), POM_T), 1)]
    g = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    for label, build, b in cases:
        d = lower_stmt_cuda(build().fn.statements[0], device="cuda").desc
        view = cmod.gemm_view(d)
        label += (" (generic kernel)" if view is None else " (table kernel)"
                  if cmod.gemm_strides(d, view) is None else " (strided kernel in f32)")
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(b * d.x_numel, generator=g, device="cuda").to(dt)
            y = torch.randn(b * d.y_numel, generator=g, device="cuda").to(dt)
            o = torch.randn(b * d.o_numel, generator=g, device="cuda").to(dt)
            got = cmod.contraction(d, x, y, o)
            torch.cuda.synchronize()
            want = ref.contraction(d, x, y, o)
            err = (got.float() - want.float()).abs().max().item()
            # f32: the kernel's k-order sum vs einsum's (cuBLAS on the card)
            # order; bf16: both round the f32 sum once, so at most an ulp
            # (2^-8 relative) apart
            tol = (1e-2 if dt == torch.bfloat16 else 1e-5) * want.float().abs().max().item()
            print(f"contraction {label} {str(dt)[6:]}: max abs err {err:.3g} "
                  f"(tolerance {tol:.3g})")
            if not err <= tol:
                fail(f"contraction {label} disagrees with its plain version: {err}")
            if dt == torch.float32:
                worst = max(worst, err)
        del x, y, o, got, want
    from repro_torch.kernels import probe as pmod
    x8 = torch.arange(8, dtype=torch.float32, device="cuda")
    perr = (pmod.probe(x8) - ref.probe(x8)).abs().max().item()
    print(f"probe vs x + 1: max abs err {perr}")
    if perr != 0:
        fail(f"the probe kernel disagrees with x + 1: {perr}")
    return worst, perr


# --------------------------------------------------------------------------
# 9. the POM compile path at size: gemm, 2mm, 3mm at n = 4096
# --------------------------------------------------------------------------
def _matmul_reference(name: str, a: dict) -> dict:
    """The same programs as torch.matmul compositions (a check, not the port)."""
    mm = torch.matmul
    if name == "gemm":
        return {"C": a["C"] + mm(a["A"], a["B"])}
    if name == "2mm":
        tmp = a["tmp"] + mm(a["A"], a["B"])
        return {"tmp": tmp, "D": a["D"] + mm(tmp, a["C"])}
    e = a["E"] + mm(a["A"], a["B"])
    f = a["F"] + mm(a["C"], a["D"])
    return {"E": e, "F": f, "G": a["G"] + mm(e, f)}


def compile_path_phase() -> dict:
    phase(f"POM compile path at size (n {POM_N}, f32, tile {POM_T})")
    from repro_torch import workloads as W
    from repro_torch.core.pipeline import compile as pom_compile
    from repro_torch.kernels import contraction as cmod
    builders = {"gemm": W.gemm, "2mm": W.mm2, "3mm": W.mm3}
    g = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for name, build in builders.items():
        t0 = time.perf_counter()
        f = _tiled(lambda: build(POM_N), POM_T)
        prog = pom_compile(f.fn, target="cuda")
        lower_s = time.perf_counter() - t0
        if prog.mode != "cuda" or prog.device.type != "cuda":
            fail(f"{name}: compiled in mode {prog.mode} on {prog.device}, expected cuda")
        arrs = {ph: torch.randn(p.shape, generator=g, device="cuda")
                for ph, p in f.fn.placeholders.items()}
        want = _matmul_reference(name, arrs)
        scale = {k: v.abs().max().item() for k, v in want.items()}
        n_stmt = len(f.fn.statements)
        flops = 2.0 * n_stmt * POM_N ** 3
        t0 = time.perf_counter()
        traced = prog.traceable()
        trace_s = time.perf_counter() - t0
        if not traced:
            fail(f"{name}: the whole-program step fell back")
        res = {"statements": n_stmt, "lower_s": lower_s, "trace_s": trace_s}
        for label, run in (("call", prog), ("jitted", prog.jitted())):
            run(arrs)                            # warm-up
            torch.cuda.synchronize()
            n0, s0 = cmod.launches, cmod.launches_strided
            t0 = time.perf_counter()
            got = run(arrs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = cmod.launches - n0
            if cmod.launches_strided - s0 != n_stmt:
                fail(f"{name} {label}: {cmod.launches_strided - s0} of {n_stmt} statements "
                     "took the strided contraction kernel")
            err = max((got[k] - want[k]).abs().max().item() / scale[k] for k in want)
            print(f"{name} {label}: {launches} contraction launches, wall "
                  f"{wall * 1e3:.2f} ms, {flops / wall / 1e9:.1f} GFLOP/s, "
                  f"max rel err vs torch.matmul {err:.3g} (tolerance {POM_RTOL})")
            if launches != n_stmt:
                fail(f"{name} {label}: {launches} launches for {n_stmt} statements")
            if not err <= POM_RTOL:
                fail(f"{name} {label} disagrees with torch.matmul: {err}")
            res[label] = {"wall_ms": wall * 1e3, "gflop_s": flops / wall / 1e9,
                          "max_rel_err": err, "launches": launches}
        print(f"{name}: lowering {lower_s * 1e3:.1f} ms, step dry run (meta) "
              f"{trace_s * 1e3:.1f} ms")
        out[name] = res
        del arrs, want, got
    return out


# --------------------------------------------------------------------------
# 10. the thirteen serving workloads on the card
# --------------------------------------------------------------------------
def _workload_inputs(fn, b=None, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    written = {s.store.array.name for s in fn.statements}
    lead = () if b is None else (b,)
    return {p.name: rng.standard_normal(lead + tuple(p.shape)).astype(np.float32)
            for p in fn.placeholders.values() if p.name not in written}


def _close(got: torch.Tensor, want, label: str) -> float:
    w = torch.as_tensor(np.asarray(want, dtype=np.float64))
    gt = got.detach().double().cpu()
    err = (gt - w).abs().max().item() if w.numel() else 0.0
    if not torch.allclose(gt, w, rtol=1e-4, atol=1e-4):
        fail(f"{label}: max abs err {err} beyond rtol/atol 1e-4")
    return err


def wall_ms(fn, reps: int = 5) -> float:
    """Median host wall time of ``fn`` (synchronized) after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[reps // 2]


def workloads_phase() -> dict:
    phase("workloads (13, serving_cases(False)) on the card")
    from repro_torch import workloads as W
    from repro_torch.core import serve
    from repro_torch.core.astbuild import build_ast
    from repro_torch.core.backend_jax import compile_jax
    from repro_torch.core.pipeline import compile as pom_compile
    B = 8
    out = {}
    for name, build in W.serving_cases(False):
        f = build()
        outs = sorted({s.store.array.name for s in f.fn.statements})
        prog = pom_compile(f.fn, target="cuda")
        if not prog.traceable():
            fail(f"{name}: the whole-program step cannot run this program")
        lanes = [_workload_inputs(f.fn, seed=s) for s in range(B)]
        batched = {k: np.stack([ln[k] for ln in lanes]) for k in lanes[0]}
        oracle = compile_jax(f.fn, build_ast(f.fn))
        got = prog.jitted()(dict(lanes[0]))
        want = oracle({k: v.astype(np.float64) for k, v in lanes[0].items()})
        err = max(_close(got[k], want[k], f"{name} jitted:{k}") for k in outs)
        bo = prog.batched(B)(batched)
        seq = [prog.jitted()(dict(ln)) for ln in lanes]
        for i, ln in enumerate(lanes):
            for k in outs:
                if bo[k].device.type != "cuda":
                    fail(f"{name}: batched output {k} on {bo[k].device}")
                _close(bo[k][i], seq[i][k].cpu().numpy(), f"{name} batched lane {i}:{k}")
        lane_err = max(_close(bo[k][B - 1], w, f"{name} batched vs oracle:{k}")
                       for k, w in oracle({k: v.astype(np.float64)
                                           for k, v in lanes[B - 1].items()}).items()
                       if k in outs)
        run = prog.jitted()
        jit_ms = wall_ms(lambda: run(dict(lanes[0])))
        bat_ms = wall_ms(lambda: prog.batched(B)(batched))
        seq_ms = wall_ms(lambda: [run(dict(ln)) for ln in lanes])
        print(f"{name}: mode {prog.mode}; jitted {jit_ms:.2f} ms (max abs err vs "
              f"oracle {err:.3g}); batched({B}) {bat_ms:.2f} ms vs {B} sequential "
              f"{seq_ms:.2f} ms (lane err vs oracle {lane_err:.3g})")
        out[name] = {"mode": prog.mode, "jitted_ms": jit_ms, "batched_ms": bat_ms,
                     "sequential_ms": seq_ms, "max_abs_err": max(err, lane_err)}

    # the compile service: greedy (serial) DSE, then the served executor
    svc = serve()
    for name in ("gemm", "2mm", "bicg", "conv"):
        build = dict(W.serving_cases(False))[name]
        run = svc.cuda_runner(build(), batch_size=B, strategy="greedy")
        again = svc.cuda_runner(build(), batch_size=B, strategy="greedy")
        if again is not run:
            fail(f"{name}: the service did not reuse its executor")
        f = build()
        outs = sorted({s.store.array.name for s in f.fn.statements})
        batched = _workload_inputs(f.fn, b=B, seed=9)
        got = run(batched)
        want = pom_compile(f.fn, target="cuda").batched(B)(batched)
        err = max(_close(got[k], want[k].cpu().numpy(), f"{name} cuda_runner:{k}")
                  for k in outs)
        print(f"{name}: CompileService.cuda_runner (greedy DSE, mode "
              f"{run.program.mode}) vs unscheduled batched({B}): max abs err {err:.3g}")
    return out


# --------------------------------------------------------------------------
# 11. the thirteen workloads at their default sizes
# --------------------------------------------------------------------------
def _seidel(a: torch.Tensor, steps: int) -> torch.Tensor:
    """Gauss-Seidel in place, one anti-diagonal at a time: the points of a
    diagonal read only the diagonals before (new values) and after (old)."""
    a = a.clone()
    n = a.shape[0]
    for _ in range(steps):
        for d in range(2, 2 * n - 3):
            i = torch.arange(max(1, d - n + 2), min(n - 2, d - 1) + 1, device=a.device)
            j = d - i
            a[i, j] = 0.2 * (a[i - 1, j] + a[i, j - 1] + a[i, j] + a[i, j + 1] + a[i + 1, j])
    return a


def workload_reference(name: str, a: dict, steps: int = 0) -> dict:
    """The workloads of ``repro_torch.workloads`` written directly in
    PyTorch (a check, not the port): every array of ``a`` is an input
    (``steps`` the stencils' time steps), and the result holds the arrays
    the program writes."""
    import torch.nn.functional as F
    mm = torch.matmul
    a = {k: v.clone() for k, v in a.items()}
    if name in ("gemm", "2mm", "3mm"):
        return _matmul_reference(name, a)
    if name == "bicg":
        return {"q": a["q"] + mm(a["A"], a["p"]), "s": a["s"] + mm(a["r"], a["A"])}
    if name == "gesummv":
        tmp = a["tmp"] + mm(a["A"], a["x"])
        y = a["y"] + mm(a["B"], a["x"])
        return {"tmp": tmp, "y": 1.5 * tmp + 1.2 * y}
    if name in ("jacobi1d", "heat1d", "jacobi2d"):
        A, B = a["A"], a["B"]
        for _ in range(steps):
            if name == "jacobi1d":
                B[1:-1] = 0.33333 * (A[:-2] + A[1:-1] + A[2:])
            elif name == "heat1d":
                B[1:-1] = 0.125 * (A[2:] - 2.0 * A[1:-1] + A[:-2]) + A[1:-1]
            else:
                B[1:-1, 1:-1] = 0.2 * (A[1:-1, 1:-1] + A[1:-1, :-2] + A[1:-1, 2:]
                                       + A[2:, 1:-1] + A[:-2, 1:-1])
            A[(slice(1, -1),) * A.dim()] = B[(slice(1, -1),) * A.dim()]
        return {"A": A, "B": B}
    if name == "seidel":
        return {"A": _seidel(a["A"], steps)}
    if name == "gaussian":
        img, out = a["img"], a["out"]
        w = torch.tensor([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]], device=img.device)
        out[1:-1, 1:-1] = 0.0625 * F.conv2d(img[None, None], w[None, None])[0, 0]
        return {"out": out}
    if name == "blur":
        img, bx, out = a["img"], a["bx"], a["out"]
        bx[:, 1:-1] = 0.33333 * (img[:, :-2] + img[:, 1:-1] + img[:, 2:])
        out[1:-1, 1:-1] = 0.33333 * (bx[:-2, 1:-1] + bx[1:-1, 1:-1] + bx[2:, 1:-1])
        return {"bx": bx, "out": out}
    if name == "edge_detect":
        img, sm, out = a["img"], a["sm"], a["out"]
        sm[1:-1, 1:-1] = 0.111 * F.conv2d(img[None, None],
                                          torch.ones(1, 1, 3, 3, device=img.device))[0, 0]
        gy = sm[3:-1, 2:-2] - sm[1:-3, 2:-2]
        gx = sm[2:-2, 3:-1] - sm[2:-2, 1:-3]
        out[2:-2, 2:-2] = gy * gy + gx * gx
        return {"sm": sm, "out": out}
    if name == "conv":
        return {"conv_out": a["conv_out"] + F.conv2d(a["conv_in"][None], a["conv_w"])[0]}
    raise ValueError(name)


def default_size_phase() -> dict:
    phase("workloads (13, default_cases()) at their default sizes on the card")
    from repro_torch import workloads as W
    from repro_torch.core.pipeline import compile as pom_compile
    g = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for name, build in W.default_cases():
        f = build()
        t0 = time.perf_counter()
        prog = pom_compile(f.fn, target="cuda")
        traced = prog.traceable()
        lower_ms = 1e3 * (time.perf_counter() - t0)
        if not traced:
            fail(f"{name}: the whole-program step cannot run this program")
        arrs = {k: torch.randn(p.shape, generator=g, device="cuda")
                for k, p in f.fn.placeholders.items()}
        steps = {"jacobi1d": 100, "heat1d": 100, "jacobi2d": 10, "seidel": 10}.get(name, 0)
        want = workload_reference(name, arrs, steps)
        run = prog.jitted()
        ms = wall_ms(lambda: run(arrs), reps=3)
        got = run(arrs)
        err = max((got[k] - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                  for k, w in want.items())
        print(f"{name} {[tuple(p.shape) for p in f.fn.placeholders.values()][0]}: "
              f"mode {prog.mode}, compile + dry run {lower_ms:.1f} ms, jitted {ms:.2f} ms, "
              f"max rel err vs PyTorch {err:.3g} (tolerance {POM_RTOL})")
        if not err <= POM_RTOL:
            fail(f"{name} at default size disagrees with PyTorch: {err}")
        out[name] = {"mode": prog.mode, "compile_ms": lower_ms, "jitted_ms": ms,
                     "max_rel_err": err}
        del arrs, want, got
    return out


# --------------------------------------------------------------------------
# 12. the kernel library: ops.matmul and ops.jacobi2d
# --------------------------------------------------------------------------
def library_phase() -> dict:
    """The main path: ``ops.matmul`` at MATMUL_SHAPES (and once with
    ``schedule="naive"``) and ``ops.jacobi2d`` at JACOBI_SHAPES, every count
    set to 0 just before and read just after (one launch a matmul, the
    stencil schedule's ceil(steps / T) a stencil call, no other kernel).
    Then each result against its plain version on the same inputs, each
    stencil result bit for bit against ``steps`` single-sweep launches, and
    ``ops.jacobi2d(A, 10)`` against the compile path's
    jacobi2d program at 1024^2 (whose s2 copies the interior back each step,
    so both compute the same sweeps)."""
    phase("kernel library: ops.matmul and ops.jacobi2d")
    from repro_torch import workloads as W
    from repro_torch.core.pipeline import compile as pom_compile
    from repro_torch.kernels import autotune, ops, ref
    from repro_torch.kernels import matmul_pom as mm_mod
    from repro_torch.kernels import stencil as st_mod
    g = torch.Generator(device="cuda").manual_seed(8)
    mm_in = [(_randn(g, m, k, dtype=dt), _randn(g, k, n, dtype=dt), "pom")
             for m, k, n, dt in MATMUL_SHAPES]
    mm_in.append((mm_in[-1][0], mm_in[-1][1], "naive"))
    jac_in = [(_randn(g, m, n, dtype=dt), steps) for m, n, steps, dt in JACOBI_SHAPES]
    pom_a = torch.randn(1024, 1024, generator=g, device="cuda")
    pom_b = torch.randn(1024, 1024, generator=g, device="cuda")
    torch.cuda.synchronize()

    zero_counts()
    t0 = time.perf_counter()
    mm_out = [ops.matmul(x, y, schedule=sch) for x, y, sch in mm_in]
    jac_out = [ops.jacobi2d(x, steps) for x, steps in jac_in]
    cross = ops.jacobi2d(pom_a, 10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    print(f"launches in the kernel-library run ({wall * 1e3:.1f} ms): {launches}")
    jac_sched = [autotune.pom_jacobi_schedule(*x.shape, steps, x.element_size())
                 for x, steps in jac_in + [(pom_a, 10)]]
    check_counts("kernel library", launches,
                 {"matmul_pom": len(mm_in), "stencil": sum(sc.launches for sc in jac_sched)})
    routes = [autotune.matmul_route(x.shape[0], y.shape[1], x.shape[1], x.element_size())
              for x, y, _ in mm_in]
    check_routes("kernel library", "matmul_pom", routes.count(autotune.TENSOR_CORES),
                 routes.count(autotune.CUDA_CORES), routes.count(autotune.RING))

    errs = {"matmul_pom": 0.0, "stencil": 0.0}
    for (x, y, sch), got, route in zip(mm_in, mm_out, routes):
        (m, k), n = x.shape, y.shape[1]
        tc = route == autotune.TENSOR_CORES
        s = autotune.pom_matmul_schedule(m, n, k, x.element_size())
        naive = {autotune.TENSOR_CORES: autotune.MATMUL_TC_NAIVE,
                 autotune.RING: autotune.MATMUL_RING_TILE}.get(route, autotune.MATMUL_NAIVE)
        tile = (s.bm, s.bn, s.bk) if sch == "pom" else naive
        want = ref.matmul(x, y).float()
        tol = MATMUL_RTOL[x.dtype] * want.abs().max().item()
        # the main path's result, then every tensor-core tile on the same inputs
        runs = [(f"{sch} tile {tile}", got)]
        if tc and sch == "pom":
            runs += [(f"tile {t}", mm_mod.matmul(x, y, bm=t[0], bn=t[1], bk=t[2]))
                     for t in autotune.MATMUL_TC_TILES]
        for how, out in runs:
            torch.cuda.synchronize()
            err = (out.float() - want).abs().max().item()
            print(f"matmul {m}x{k}x{n} {str(x.dtype)[6:]} {route} {how}: max abs err "
                  f"{err:.3g} (tolerance {tol:.3g})")
            if out.shape != (m, n) or out.dtype != x.dtype or not err <= tol:
                fail(f"matmul {m}x{k}x{n} disagrees with its plain version: {err}")
            errs["matmul_pom"] = max(errs["matmul_pom"], err)
        if route == autotune.RING:
            same_bits(f"matmul {m}x{k}x{n} f32", got, x, y)
        del runs
    for (x, steps), got, sc in zip(jac_in, jac_out, jac_sched):
        want = ref.jacobi2d(x, steps)
        err = (got.float() - want.float()).abs().max().item()
        tol = JACOBI_ATOL[x.dtype]
        single = st_mod.jacobi2d(x, steps, sweeps=1)
        same = torch.equal(got, single)
        print(f"jacobi2d {tuple(x.shape)} x {steps} steps {str(x.dtype)[6:]} ({sc.launches} "
              f"launches of up to {sc.sweeps} sweeps, tile {sc.tile}): max abs err {err:.3g} "
              f"(tolerance {tol:.3g}); bit-equal to {steps} single sweeps: {same}")
        if got.shape != x.shape or got.dtype != x.dtype or not err <= tol:
            fail(f"jacobi2d {tuple(x.shape)} disagrees with its plain version: {err}")
        if not same:
            fail(f"jacobi2d {tuple(x.shape)}: {sc.sweeps} sweeps a launch differ from single "
                 "sweeps")
        errs["stencil"] = max(errs["stencil"], err)
    del mm_in, mm_out, jac_in, jac_out

    prog = pom_compile(W.jacobi2d(1024, 10).fn, target="cuda")
    want = prog.jitted()({"A": pom_a.clone(), "B": pom_b.clone()})["A"]
    err = (cross - want).abs().max().item()
    print(f"ops.jacobi2d(A, 10) vs the compile path's jacobi2d(1024, 10) (mode "
          f"{prog.mode}): max abs err {err:.3g} (tolerance {JACOBI_ATOL[torch.float32]})")
    if not err <= JACOBI_ATOL[torch.float32]:
        fail(f"ops.jacobi2d disagrees with the compile path: {err}")
    errs["misaligned_or_transposed"] = odd_operands(g)
    return {"errs": errs, "launches": launches, "wall_ms": wall * 1e3,
            "vs_compile_path_max_abs_err": err}


def same_bits(label: str, ring: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> None:
    """The ring's f32 product ``ring`` of x @ y has the bits of the CUDA-core
    tile (128, 128, 16) and of the contraction's strided kernel (which adds
    it to zeros) on the same inputs: each sums every output in k order in
    one f32 FMA chain from 0."""
    from repro_torch.kernels import contraction as cmod
    from repro_torch.kernels import matmul_pom as mm_mod
    from repro_torch.kernels.contraction import ContractionDesc
    (m, k), n = x.shape, y.shape[1]
    old = mm_mod.matmul(x, y, bm=128, bn=128, bk=16)
    d = ContractionDesc((m, n), (k, 0), (0, 1), (n, 1), (k,), (1,), (n,), 0, 0, 0, m * k, k * n,
                        m * n)
    s0 = cmod.launches_strided
    con = cmod.contraction(d, x.reshape(-1), y.reshape(-1), torch.zeros(m * n, device="cuda"))
    torch.cuda.synchronize()
    if cmod.launches_strided != s0 + 1:
        fail(f"{label}: the contraction did not take its strided kernel")
    eq_old, eq_con = torch.equal(ring, old), torch.equal(ring, con.view(m, n))
    print(f"{label} ring: bit-equal to the CUDA-core tile (128, 128, 16) {eq_old}, to the "
          f"contraction's strided kernel {eq_con}")
    if not (eq_old and eq_con):
        fail(f"{label}: the ring's bits differ from the CUDA-core tile or the contraction")


def _misaligned(g, *shape):
    """A contiguous bf16 tensor of ``shape`` 8 bytes off a 16-byte boundary."""
    n = 1
    for s in shape:
        n *= s
    out = torch.randn(n + 4, generator=g, device="cuda").bfloat16()[4:].view(*shape)
    if out.data_ptr() % 16 != 8:
        fail("could not make a misaligned operand")
    return out


def odd_operands(g) -> float:
    """ops.matmul, ops.grouped_matmul and ops.jacobi2d on a misaligned bf16
    operand (the route must be the CUDA cores: TMA cannot describe it) and
    on a transposed one (copied to contiguous), each against its plain
    version; the largest error relative to the plain result's largest
    |value|."""
    from repro_torch.kernels import grouped_matmul as gmm_mod
    from repro_torch.kernels import matmul_pom as mm_mod
    from repro_torch.kernels import ops, ref
    xt = _randn(g, 1024, 512, dtype=torch.bfloat16)
    w = _randn(g, 8, 512, 256, dtype=torch.bfloat16)
    cases = [("matmul misaligned", mm_mod, 0, lambda: (_misaligned(g, 512, 512),
                                                       _misaligned(g, 512, 256)),
              ops.matmul, ref.matmul),
             ("matmul x.t()", mm_mod, 1, lambda: (xt.t(), xt), ops.matmul, ref.matmul),
             ("grouped_matmul misaligned", gmm_mod, 0, lambda: (_misaligned(g, 8, 64, 512),
                                                                _misaligned(g, 8, 512, 256)),
              ops.grouped_matmul, ref.grouped_matmul),
             ("grouped_matmul w.transpose(1, 2)", gmm_mod, 1, lambda: (w.transpose(1, 2), w),
              ops.grouped_matmul, ref.grouped_matmul),
             ("jacobi2d misaligned", None, None, lambda: (_misaligned(g, 1000, 512), 3),
              ops.jacobi2d, ref.jacobi2d),
             ("jacobi2d x.t()", None, None, lambda: (_randn(g, 512, 1000,
                                                            dtype=torch.float32).t(), 3),
              ops.jacobi2d, ref.jacobi2d)]
    worst = 0.0
    for label, mod, tc, make, op, plain in cases:
        args = make()
        ntc = mod.launches_tc if mod else 0
        got = op(*args)
        torch.cuda.synchronize()
        want = plain(*args).float()
        err = (got.float() - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
        route = "" if mod is None else (" tensor cores" if mod.launches_tc - ntc else
                                        " cuda cores")
        print(f"{label} {tuple(args[0].shape)}{route}: max rel err vs plain {err:.3g}")
        if mod is not None and mod.launches_tc - ntc != tc:
            fail(f"{label}: took the{route} route")
        if got.shape != want.shape or not err <= (2e-2 if got.dtype == torch.bfloat16
                                                  else 1e-5):
            fail(f"{label} disagrees with its plain version: {err}")
        worst = max(worst, err)
    return worst


# --------------------------------------------------------------------------
# 13. numbers
# --------------------------------------------------------------------------
def clocks(label: str) -> None:
    """The card's SM clock (and its maximum), temperature and power draw."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                          "temperature.gpu,power.draw", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"clocks {label}: {smi}")
def time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device time of ``fn`` with the 50 MB L2 flushed before each call.

    A 2 ms device-side sleep precedes each timed call, so the host has
    enqueued the whole call before the start event fires: the events then
    time the card's work, not the host's launch overhead."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def timed_route(mod, fn, **kw) -> tuple:
    """(``time_ms(fn)``, the route every launch of ``mod``'s kernel took in
    that run), read from the wrapper's counts."""
    from repro_torch.kernels import autotune
    n0, ntc, nr = mod.launches, mod.launches_tc, getattr(mod, "launches_ring", 0)
    ms = time_ms(fn, **kw)
    n, tc, ring = mod.launches - n0, mod.launches_tc - ntc, getattr(mod, "launches_ring", 0) - nr
    if n == 0 or tc not in (0, n) or ring not in (0, n):
        fail(f"{mod.__name__}: of {n} timed launches {tc} on the tensor cores, {ring} on the "
             "ring")
    return ms, (autotune.TENSOR_CORES if tc else autotune.RING if ring else autotune.CUDA_CORES)


def bound(byts: float, flops: float, dtype, tf32: bool = False) -> tuple:
    """The least time the card could take: bytes at the HBM rate or
    operations at the peak rate for ``dtype`` (H100 SXM data sheet; with
    ``tf32`` the TF32 tensor-core rate, the units the scan's products use)."""
    from repro_torch.core.cost_model import H100
    peak = (H100.peak_flops_tf32 if tf32 else
            H100.peak_flops_bf16 if dtype == torch.bfloat16 else H100.peak_flops_f32)
    t_bytes = byts / H100.hbm_bw
    t_ops = flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def numbers_phase(errs: dict, launches: dict) -> list:
    phase("numbers")
    clocks("before")
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(2)
    dt = torch.bfloat16
    rows = []

    # decode at the serve's last step (cache S = prompt + gen, every row
    # full: the row), at S 1024 with ragged lengths and at S 8192 full; each
    # split count 1-8 timed beside the schedule's at S 128 and 8192
    from repro_torch.kernels import autotune
    from repro_torch.kernels import decode_attention as decode_mod
    b, hq, hkv, d = SERVE_B, 15, 5, 64
    dec = {}
    for s, tag in ((SERVE_PROMPT + SERVE_GEN, "main"), (1024, "S1024-ragged"),
                   (8192, "S8192")):
        q = _randn(g, b, hq, d, dtype=dt)
        k, v = _randn(g, b, hkv, s, d, dtype=dt), _randn(g, b, hkv, s, d, dtype=dt)
        if tag == "S1024-ragged":
            length = torch.randint(1, s + 1, (b,), generator=g, device="cuda",
                                   dtype=torch.int32)
        else:
            length = torch.full((b,), s, dtype=torch.int32, device="cuda")
        mask = (torch.arange(s, device="cuda")[None, :] < length[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        n_valid = int(length.sum())
        byts = 2 * n_valid * hkv * d * 2 + 2 * b * hq * d * 2 + 4 * b
        flops = 4.0 * n_valid * hq * d
        bms, by = bound(byts, flops, dt)
        sch = autotune.pom_decode_schedule(b * hkv, s, hq // hkv, d, 2)
        ms = time_ms(lambda: ops.decode_attention(q, k, v, length=length))
        plain_ms = time_ms(lambda: ref.decode_attention(q, k, v, length=length), iters=20)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                                                enable_gqa=True))
        print(f"decode_attention {tag} B{b} S{s} (splits {sch.splits}): {ms:.4f} ms "
              f"({bms / ms:.3f} of the bound), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
              f"bound {bms:.5f} ms ({by})")
        dec[tag] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                    "library_ms": lib_ms, "splits": sch.splits,
                    "shape": f"B {b}, Hq {hq}, Hkv {hkv}, S {s}, D {d}, bf16"}
        if tag != "S1024-ragged":
            forced = {n: time_ms(lambda n=n: decode_mod.decode_attention(
                q, k, v, length=length, splits=n), iters=50) for n in range(1, 9)}
            dec[tag]["splits_ms"] = forced
            print(f"decode_attention {tag} by splits: "
                  + ", ".join(f"{n}: {t:.4f} ms" for n, t in forced.items()))
        del q, k, v, mask, q4
    clusters = {n: decode_mod.max_active_clusters(d, hq // hkv, n, dt) for n in range(1, 9)}
    print(f"decode_attention (bf16, D {d}, 3 heads a CTA): clusters the card holds at once, "
          "by splits: " + ", ".join(f"{n}: {c}" for n, c in clusters.items()))
    rows.append({"name": "decode_attention", "route": "cuda",
                 "source": "src/repro_torch/csrc/decode_attention.cu",
                 "replaces": "src/repro/kernels/decode_attention.py:24",
                 "launches": launches["decode_attention"],
                 "max_abs_err": errs["decode_attention"], **dec["main"],
                 "library": "scaled_dot_product_attention",
                 "at_S1024_ragged": dec["S1024-ragged"], "at_S8192": dec["S8192"],
                 "max_active_clusters": clusters})

    # flash at the forward's shape
    b, s = FWD_B, FWD_S
    q = _randn(g, b, hq, s, d, dtype=dt)
    k, v = _randn(g, b, hkv, s, d, dtype=dt), _randn(g, b, hkv, s, d, dtype=dt)
    byts = (2 * b * hq * s * d + 2 * b * hkv * s * d) * 2
    flops = 4.0 * d * b * hq * (s * (s + 1) // 2)
    bms, by = bound(byts, flops, dt)
    from repro_torch.kernels import flash_attention as flash_mod
    sch = autotune.pom_attention_schedule(s, s, d, 2, True)
    ms, route = timed_route(flash_mod, lambda: ops.attention(q, k, v, causal=True))
    if route != sch.route:
        fail(f"flash_attention: ops.attention took the {route} route, its schedule "
             f"{sch.route}")
    cc_ms = time_ms(lambda: flash_mod.flash_attention(q, k, v, bq=64, bkv=64), iters=20)
    lse_ms = time_ms(lambda: flash_mod.flash_attention(q, k, v, bq=sch.bq, bkv=sch.bkv,
                                                       return_lse=True))
    plain_ms = time_ms(lambda: ref.attention(q, k, v, causal=True), iters=20)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                            enable_gqa=True))
    print(f"flash_attention B{b} S{s} ({route}, tile {(sch.bq, sch.bkv)}): {ms:.4f} ms, "
          f"with lse {lse_ms:.4f} ms, CUDA-core route (64, 64) {cc_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bms:.5f} ms ({by})")
    rows.append({"name": "flash_attention", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:27",
                 "launches": launches["flash_attention"],
                 "max_abs_err": errs["flash_attention"], "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
                 "library": "scaled_dot_product_attention", "kernel_route": route,
                 "tile": [sch.bq, sch.bkv], "cuda_core_route_ms": cc_ms,
                 "with_lse_ms": lse_ms})
    rows.append(flash_bwd_row(g, errs, launches))
    clocks("after")
    return rows


def flash_bwd_row(g, errs: dict, launches: dict) -> dict:
    """The flash backward at the training step's shape (B 8, Hq 15, Hkv 5,
    S 256, D 64, bf16, causal): its time, its plain version's, the bound of
    its work (q, k, v, o, dO and lse read once, dq, dk, dv written once; the
    five causal products of the backward, 2.5x the forward's operations, at
    the bf16 tensor-core rate), and SDPA's forward plus backward (its
    backward alone beside it) on the same inputs."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ref
    dt = torch.bfloat16
    b, hq, hkv, s, d = TRAIN_B, 15, 5, TRAIN_S, 64
    q, do = _randn(g, b, hq, s, d, dtype=dt), _randn(g, b, hq, s, d, dtype=dt)
    k, v = _randn(g, b, hkv, s, d, dtype=dt), _randn(g, b, hkv, s, d, dtype=dt)
    o, lse = flash_mod.flash_attention(q, k, v, return_lse=True)
    byts = (4 * b * hq * s * d + 4 * b * hkv * s * d) * 2 + 4 * b * hq * s
    flops = 2.5 * 4.0 * d * b * hq * (s * (s + 1) // 2)
    bms, by = bound(byts, flops, dt)
    ntc = flash_mod.launches_bwd_tc
    ms = time_ms(lambda: flash_mod.flash_attention_backward(q, k, v, o, lse, do))
    if flash_mod.launches_bwd_tc == ntc:
        fail("flash_attention_backward: the timed calls did not take the tensor cores")
    cc_ms = time_ms(lambda: flash_mod.flash_attention_backward(q, k, v, o, lse, do,
                                                               route="cuda_cores"), iters=20)
    plain_ms = time_ms(lambda: ref.attention_backward(q, k, v, o, lse, do), iters=20)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
        torch.autograd.grad(out, leaves, do)
    lib_ms = time_ms(sdpa_fwd_bwd)
    out = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
    print(f"flash_attention_bwd B{b} S{s} (tensor cores): {ms:.4f} ms, CUDA-core route "
          f"{cc_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa forward + backward {lib_ms:.4f} ms "
          f"(backward alone {lib_bwd_ms:.4f} ms), bound {bms:.5f} ms ({by})")
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "none: no TPU counterpart (the reference differentiates XLA "
                        "attention; src/repro/configs/base.py:54 use_pallas False)",
            "launches": launches["flash_attention_bwd"],
            "max_abs_err": errs["flash_attention_bwd"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "library": "scaled_dot_product_attention forward + backward",
            "library_backward_only_ms": lib_bwd_ms, "kernel_route": "tensor_cores",
            "cuda_core_route_ms": cc_ms,
            "shape": f"B {b}, Hq {hq}, Hkv {hkv}, S {s}, D {d}, bf16, causal"}


def compile_numbers_phase(errs: dict, launches: dict) -> list:
    phase("numbers: compile path kernels")
    clocks("before")
    from repro_torch import workloads as W
    from repro_torch.core.backend_cuda import lower_stmt_cuda
    from repro_torch.kernels import contraction as cmod
    from repro_torch.kernels import probe as pmod
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(5)
    rows = []

    def gemm_desc(n):
        return lower_stmt_cuda(_tiled(lambda: W.gemm(n), POM_T).fn.statements[0],
                               device="cuda").desc

    def operands(d):
        return [torch.randn(k, generator=g, device="cuda")
                for k in (d.x_numel, d.y_numel, d.o_numel)]

    n = POM_N
    d = gemm_desc(n)
    x, y, o = operands(d)
    byts = 4 * (d.x_numel + d.y_numel + 2 * d.o_numel)   # X, Y, D read once; D written
    bms, by = bound(byts, d.flops(), torch.float32)
    n0, s0 = cmod.launches, cmod.launches_strided
    ms = time_ms(lambda: cmod.contraction(d, x, y, o), iters=20, warmup=2)
    if cmod.launches_strided - s0 != cmod.launches - n0:
        fail(f"gemm n{n}: {cmod.launches_strided - s0} of {cmod.launches - n0} timed "
             "launches took the strided kernel")
    strides = cmod.gemm_strides
    cmod.gemm_strides = lambda desc, view: None     # the same inputs on the table kernel
    try:
        table_ms = time_ms(lambda: cmod.contraction(d, x, y, o), iters=20, warmup=2)
    finally:
        cmod.gemm_strides = strides
    lib_ms = time_ms(lambda: torch.addmm(o.view(n, n), x.view(n, n), y.view(n, n)), iters=20)
    plain_ms = time_ms(lambda: ref.contraction(d, x, y, o), iters=20, warmup=2)
    print(f"contraction gemm n{n} t{POM_T} f32 (strided kernel): {ms:.3f} ms "
          f"({d.flops() / ms / 1e6:.1f} GFLOP/s), table kernel {table_ms:.3f} ms, "
          f"plain {plain_ms:.4f} ms, "
          f"torch.addmm {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    rows.append({"name": "contraction", "route": "cuda",
                 "source": "src/repro_torch/csrc/contraction.cu",
                 "replaces": "src/repro/core/backend_pallas.py:286",
                 "launches": launches["contraction"], "max_abs_err": errs["contraction"],
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                 "library_ms": lib_ms, "library": "torch.addmm",
                 "shape": f"gemm n{n} tile {POM_T} f32", "kernel_path": "strided",
                 "table_kernel_ms": table_ms})
    del x, y, o

    x8 = torch.arange(8, dtype=torch.float32, device="cuda")
    bms, by = bound(2 * 8 * 4, 8, torch.float32)
    ms = time_ms(lambda: pmod.probe(x8))
    plain_ms = time_ms(lambda: ref.probe(x8))
    lib_ms = time_ms(lambda: torch.add(x8, 1.0))
    print(f"probe: {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.add {lib_ms:.4f} ms, "
          f"bound {bms:.2e} ms ({by})")
    rows.append({"name": "probe", "route": "cuda", "source": "src/repro_torch/csrc/probe.cu",
                 "replaces": "src/repro/core/backend_pallas.py:150",
                 "launches": launches["probe"], "max_abs_err": errs["probe"], "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                 "library_ms": lib_ms})
    clocks("after")
    return rows


def lm_numbers_phase(errs: dict, launches: dict) -> list:
    """grouped_matmul at granite_moe_1b's decode shape (the row; its forward
    shape beside it) and ssm_scan at zamba2's shape (the row; xlstm's and the
    mLSTM normaliser's beside it), the scan with its bound at the TF32
    tensor-core rate its kernels use (the row's) and at the f32 rate, and
    its route (x's dtype names it)."""
    phase("numbers: MoE and SSM kernels")
    clocks("before")
    from repro_torch.kernels import autotune, ops, ref
    from repro_torch.kernels import grouped_matmul as gmm_mod
    from repro_torch.kernels import ssm_scan as scan_mod
    g = torch.Generator(device="cuda").manual_seed(7)
    dt = torch.bfloat16
    gmm = {}
    for e, cap, d, f in (GMM_SHAPES[0], GMM_SHAPES[2]):
        x = _randn(g, e, cap, d, dtype=dt)
        w = (torch.randn(e, d, f, generator=g, device="cuda") * d ** -0.5).to(dt)
        s = autotune.pom_gmm_schedule(e, cap, d, f, x.element_size())
        tile = (s.bm, s.bn, s.bk)
        bms, by = bound((e * cap * d + e * d * f + e * cap * f) * 2, 2.0 * e * cap * d * f, dt)
        ms, route = timed_route(gmm_mod, lambda: ops.grouped_matmul(x, w))
        plain_ms = time_ms(lambda: ref.grouped_matmul(x, w), iters=20)
        lib_ms = time_ms(lambda: torch.bmm(x, w))
        print(f"grouped_matmul E{e} cap{cap} d{d} f{f} bf16 ({route}, tile {tile}): "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm {lib_ms:.4f} ms, bound "
              f"{bms:.5f} ms ({by})")
        gmm[cap] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                    "library_ms": lib_ms, "shape": f"E {e}, cap {cap}, d {d}, f {f}, bf16",
                    "kernel_route": route, "tile": list(tile)}
        del x, w
    rows = [{"name": "grouped_matmul", "route": "cuda",
             "source": "src/repro_torch/csrc/grouped_matmul.cu",
             "replaces": "src/repro/kernels/grouped_matmul.py:18",
             "launches": launches["grouped_matmul"], "max_abs_err": errs["grouped_matmul"],
             **gmm[8], "library": "torch.bmm", "at_forward_shape": gmm[640]}]
    scan = {}
    for label in ("zamba2", "xlstm", "normaliser"):
        b, s, h, p, n, sdt, bc = SCAN_SHAPES[label]
        x, a, bm, cm = _scan_inputs(g, b, s, h, p, n, sdt, bc)
        hb = 1 if bc else h
        # each input read once (a broadcast B/C group once), y and h written
        byts = 2 * b * s * h * p * x.element_size() + 4 * b * s * h + 8 * b * s * hb * n \
            + 4 * b * h * n * p
        flops = 4.0 * b * s * h * n * p
        # the bound at the TF32 tensor-core rate, the units the products run
        # on; the f32 CUDA-core rate's beside it
        bms, by = bound(byts, flops, torch.float32, tf32=True)
        f32_ms, f32_by = bound(byts, flops, torch.float32)
        sc = autotune.pom_scan_schedule(s, p, n, x.element_size(), b * h,
                                        bc_groups=b * scan_mod.bc_groups(bm, cm))
        route = autotune.SCAN_ROUTES[x.element_size()]
        ms = time_ms(lambda: ops.ssm_scan(x, a, bm, cm), iters=20)
        plain_ms = time_ms(lambda: ref.ssm_scan(x, a, bm, cm), iters=3, warmup=1)
        print(f"ssm_scan {label} B{b} S{s} H{h} P{p} N{n} ({route}, chunk {sc.chunk}, P tile "
              f"{sc.p_tile}): {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bms:.5f} ms ({by}, "
              f"TF32 rate), {f32_ms:.5f} ms ({f32_by}, f32 rate)")
        scan[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                       "bound_f32_ms": f32_ms, "bound_f32_by": f32_by, "kernel_route": route,
                       "chunk": sc.chunk, "p_tile": sc.p_tile,
                       "shape": f"B {b}, S {s}, H {h}, P {p}, N {n}, x {str(sdt)[6:]}"}
        del x, a, bm, cm
    rows.append({"name": "ssm_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssm_scan.cu",
                 "replaces": "src/repro/kernels/ssm_scan.py:28",
                 "launches": launches["ssm_scan"], "max_abs_err": errs["ssm_scan"],
                 **scan["zamba2"], "library_ms": None,
                 "library": "none: no single PyTorch call computes the scan",
                 "at_xlstm_shape": scan["xlstm"], "at_normaliser_shape": scan["normaliser"]})
    rows += backward_rows(g, errs, launches)
    clocks("after")
    return rows


NO_TPU = ("none: no TPU counterpart (the reference differentiates its pure-jnp ops with "
          "XLA; src/repro/configs/base.py:54 use_pallas False)")


def backward_rows(g, errs: dict, launches: dict) -> list:
    """The backward passes at the training shapes (batch 8 x 256): the
    grouped matmul's dX and dW at granite's wi/wg shape (E 32, cap 640, d
    1024, f 512, bf16), with the two transposed copies' time beside it and
    two ``torch.bmm`` as its library call; the scan's backward at zamba2's
    shape (xlstm's and the normaliser's beside it) and the decay-gradient
    kernel at zamba2's shape, neither with a library call.  Bounds: each
    input read once and each output written once; the grouped matmul's two
    products at the bf16 tensor-core rate, the scan's three scans' products
    at the TF32 rate (as the forward row), the decay gradient's dots at the
    f32 rate."""
    from repro_torch.kernels import grouped_matmul as gmm_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as scan_mod
    rows = []
    dt = torch.bfloat16
    e, cap, d, f = 32, 640, 1024, 512
    x = _randn(g, e, cap, d, dtype=dt)
    w = (torch.randn(e, d, f, generator=g, device="cuda") * d ** -0.5).to(dt)
    dy = _randn(g, e, cap, f, dtype=dt)
    byts = (2 * e * cap * d + 2 * e * d * f + e * cap * f) * 2
    bms, by = bound(byts, 2 * 2.0 * e * cap * d * f, dt)
    n0, ntc = gmm_mod.launches_bwd, gmm_mod.launches_bwd_tc
    ms = time_ms(lambda: gmm_mod.grouped_matmul_backward(x, w, dy), iters=50)
    n, tc = gmm_mod.launches_bwd - n0, gmm_mod.launches_bwd_tc - ntc
    copies_ms = time_ms(lambda: (w.transpose(1, 2).contiguous(), x.transpose(1, 2).contiguous()),
                        iters=50)
    plain_ms = time_ms(lambda: ref.grouped_matmul_backward(x, w, dy), iters=20)
    lib_ms = time_ms(lambda: (torch.bmm(dy, w.transpose(1, 2)), torch.bmm(x.transpose(1, 2), dy)))
    print(f"grouped_matmul_bwd E{e} cap{cap} d{d} f{f} bf16 ({tc} of {n} timed launches on the "
          f"tensor cores): {ms:.4f} ms (the transposed copies alone {copies_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, two torch.bmm {lib_ms:.4f} ms, bound {bms:.5f} ms ({by})")
    rows.append({"name": "grouped_matmul_bwd", "route": "cuda",
                 "source": "src/repro_torch/csrc/grouped_matmul.cu", "replaces": NO_TPU,
                 "launches": launches["grouped_matmul_bwd"],
                 "max_abs_err": errs["grouped_matmul_bwd"], "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
                 "library": "two torch.bmm (dY W^T, X^T dY)", "transposed_copies_ms": copies_ms,
                 "tensor_core_share": tc / n, "shape": f"E {e}, cap {cap}, d {d}, f {f}, bf16"})
    del x, w, dy
    scan = {}
    for label in ("zamba2", "xlstm", "normaliser"):
        b, s, h, p, n, sdt, bc, tail = SCAN_BWD_SHAPES[label]
        x, a, bm, cm, dy, _ = _scan_bwd_inputs(g, b, s, h, p, n, sdt, bc, tail)
        hb = 1 if bc else h
        # x, a, b, c, dy read once (a broadcast group once); dx (x's dtype), da,
        # db and dc (f32, per head) written once; three scans' products
        byts = (2 * b * s * h * p * x.element_size() + 8 * b * s * h + 8 * b * s * hb * n
                + 8 * b * s * h * n)
        bms, by = bound(byts, 3 * 4.0 * b * s * h * n * p, torch.float32, tf32=True)
        needs = (p > 1, True, True, True)          # the normaliser's x = 1 needs no dx
        ms = time_ms(lambda: scan_mod.scan_backward(scan_mod._bwd_scan, x, a, bm, cm, dy,
                                                    needs=needs), iters=20)
        plain_ms = time_ms(lambda: ref.ssm_scan_backward(x, a, bm, cm, dy), iters=3, warmup=1)
        print(f"ssm_scan_bwd {label} B{b} S{s} H{h} P{p} N{n} {str(sdt)[6:]}: {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bms:.5f} ms ({by}, TF32 rate)")
        scan[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                       "shape": f"B {b}, S {s}, H {h}, P {p}, N {n}, x {str(sdt)[6:]}"}
        if label == "zamba2":
            _, _, db, dc = ref.ssm_scan_backward(x, a, bm, cm, dy)
            byts = 4 * (2 * b * s * hb * n + 2 * b * s * h * n + 2 * b * s * h)
            da_bms, da_by = bound(byts, 4.0 * b * s * h * n, torch.float32)
            da_ms = time_ms(lambda: scan_mod.ssm_scan_da(cm, dc, bm, db, a))
            da_plain = time_ms(lambda: ref.ssm_scan_da(cm, dc, bm, db, a), iters=20)
            print(f"ssm_scan_da {label} B{b} S{s} H{h} N{n}: {da_ms:.4f} ms, plain "
                  f"{da_plain:.4f} ms, bound {da_bms:.5f} ms ({da_by})")
            rows.append({"name": "ssm_scan_da", "route": "cuda",
                         "source": "src/repro_torch/csrc/ssm_scan_bwd.cu", "replaces": NO_TPU,
                         "launches": launches["ssm_scan_da"], "max_abs_err": errs["ssm_scan_da"],
                         "ms": da_ms, "plain_ms": da_plain, "bound_ms": da_bms,
                         "bound_by": da_by, "library_ms": None,
                         "library": "none: no single PyTorch call computes it",
                         "shape": f"B {b}, S {s}, H {h}, N {n}, b and c broadcast"})
            del db, dc
        del x, a, bm, cm, dy
    rows.insert(1, {"name": "ssm_scan_bwd", "route": "cuda",
                    "source": "src/repro_torch/csrc/ssm_scan.cu + src/repro_torch/csrc/"
                              "ssm_scan_bwd.cu (kernels/ssm_scan.py scan_backward)",
                    "replaces": NO_TPU, "launches": launches["ssm_scan_bwd"],
                    "max_abs_err": errs["ssm_scan_bwd"], **scan["zamba2"], "library_ms": None,
                    "library": "none: no single PyTorch call computes the scan",
                    "at_xlstm_shape": scan["xlstm"], "at_normaliser_shape": scan["normaliser"]})
    return rows


def library_numbers_phase(errs: dict, launches: dict) -> list:
    """matmul_pom at 4096^3 bf16 (the row; f32 beside it) and the library
    phase's stencil call, 10 sweeps at 1024^2 f32 (the row; 4096^2 beside
    it), each against the bound of one pass over the grid, with one sweep
    on the single-sweep kernel and the same 10 sweeps as 10 single-sweep
    launches beside it."""
    phase("numbers: kernel library")
    clocks("before")
    from repro_torch.kernels import autotune, ops, ref
    from repro_torch.kernels import matmul_pom as mm_mod
    from repro_torch.kernels import stencil as st_mod
    g = torch.Generator(device="cuda").manual_seed(9)
    mm = {}
    for dt in (torch.bfloat16, torch.float32):
        n = 4096
        x, y = _randn(g, n, n, dtype=dt), _randn(g, n, n, dtype=dt)
        s = autotune.pom_matmul_schedule(n, n, n, x.element_size())
        bms, by = bound(3 * n * n * x.element_size(), 2.0 * n ** 3, dt)
        ms, route = timed_route(mm_mod, lambda: ops.matmul(x, y), iters=20, warmup=2)
        if route != s.route:
            fail(f"matmul_pom {n}^3 {str(dt)[6:]}: ops.matmul took the {route} route, its "
                 f"schedule {s.route}")
        plain_ms = time_ms(lambda: ref.matmul(x, y), iters=20, warmup=2)
        lib_ms = time_ms(lambda: torch.matmul(x, y), iters=20, warmup=2)
        print(f"matmul_pom {n}^3 {str(dt)[6:]} ({route}, tile {(s.bm, s.bn, s.bk)}): "
              f"{ms:.4f} ms ({2.0 * n ** 3 / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
              f"torch.matmul {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        mm[dt] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                  "library_ms": lib_ms, "shape": f"{n}^3 {str(dt)[6:]}",
                  "kernel_route": route, "tile": [s.bm, s.bn, s.bk]}
        if route == autotune.RING:     # the CUDA-core tile it replaced, same inputs
            old_ms = time_ms(lambda: mm_mod.matmul(x, y, bm=128, bn=128, bk=16), iters=20,
                             warmup=2)
            mm[dt]["cuda_core_tile_ms"] = old_ms
            print(f"matmul_pom {n}^3 f32 on the CUDA-core tile (128, 128, 16): {old_ms:.4f} ms")
        del x, y
    rows = [{"name": "matmul_pom", "route": "cuda",
             "source": "src/repro_torch/csrc/matmul_pom.cu",
             "replaces": "src/repro/kernels/matmul_pom.py:26",
             "launches": launches["matmul_pom"], "max_abs_err": errs["matmul_pom"],
             **mm[torch.bfloat16], "library": "torch.matmul",
             "at_f32": mm[torch.float32]}]
    sweep = {}
    for n in (1024, 4096):
        a = torch.randn(n, n, generator=g, device="cuda")
        # one read and one write of the grid; the 10 sweeps' operations
        bms, by = bound(2 * n * n * 4, 10 * 5.0 * (n - 2) ** 2, torch.float32)
        one_bms, one_by = bound(2 * n * n * 4, 5.0 * (n - 2) ** 2, torch.float32)
        sc = autotune.pom_jacobi_schedule(n, n, 10, 4)
        n0 = st_mod.launches
        ops.jacobi2d(a, 10)
        per_call = st_mod.launches - n0
        ms = time_ms(lambda: ops.jacobi2d(a, 10), iters=20)
        plain_ms = time_ms(lambda: ref.jacobi2d(a, 10), iters=5)
        one_ms = time_ms(lambda: ops.jacobi2d(a, 1))
        one_plain_ms = time_ms(lambda: ref.jacobi2d(a, 1), iters=20)
        single_ms = time_ms(lambda: st_mod.jacobi2d(a, 10, sweeps=1), iters=20)
        print(f"stencil {n}^2 f32 x 10 sweeps (one call: {per_call} launches of up to "
              f"{sc.sweeps} sweeps, tile {sc.tile}): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound of one pass {bms:.5f} ms ({by}); as 10 single sweeps {single_ms:.4f} ms; "
              f"one sweep {one_ms:.4f} ms, plain {one_plain_ms:.4f} ms, bound {one_bms:.5f} ms "
              f"({one_by})")
        if per_call != sc.launches:
            fail(f"stencil {n}^2 x 10: {per_call} launches a call, the schedule {sc.launches}")
        sweep[n] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                    "launches_a_call": sc.launches, "sweeps_a_launch": sc.sweeps,
                    "tile": list(sc.tile), "ten_single_sweeps_ms": single_ms,
                    "one_sweep_ms": one_ms, "one_sweep_plain_ms": one_plain_ms,
                    "one_sweep_bound_ms": one_bms, "one_sweep_bound_by": one_by,
                    "shape": f"{n}^2 f32, 10 sweeps"}
        del a
    rows.append({"name": "stencil", "route": "cuda", "source": "src/repro_torch/csrc/stencil.cu",
                 "replaces": "src/repro/kernels/stencil.py:19",
                 "launches": launches["stencil"], "max_abs_err": errs["stencil"],
                 **sweep[1024], "library_ms": None,
                 "library": "none: no single PyTorch call computes a sweep with its "
                            "pass-through boundary",
                 "at_4096": sweep[4096]})
    clocks("after")
    return rows


def main() -> None:
    card = device_phase()
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails where the repo is absent)
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    build_phase()
    errs = kernel_phase()
    errs["contraction"], errs["probe"] = contraction_phase()
    launches: dict = {}                    # summed over every path run below
    cfg = get_config("smollm_360m")
    model = init_params(cfg, seed=0, device="cuda")
    print(f"model {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, params "
          f"{sum(p.numel() for p in model.parameters())}, {cfg.param_dtype}")
    served = serve_phase(model)
    fwd = forward_phase(model)
    _add(launches, served["launches"])
    _add(launches, fwd["launches"])
    del model
    torch.cuda.empty_cache()
    # slice 9: training (its loop's counts set to 0 just before it)
    trained = train_phase()
    _add(launches, trained["launches"])
    # slice 10: training the moe, hybrid and ssm families (each loop's counts
    # set to 0 just before it)
    trained_families = {}
    for arch in FAMILY_TRAIN:
        res = train_family_phase(arch)
        trained_families[arch] = res["train"]
        _add(launches, res["launches"])
    # slice 3: each family's serve and forward count their own launches
    families = {}
    for arch in FAMILIES:
        res = family_phase(arch)
        families[arch] = res["summary"]
        _add(launches, res["launches"])
    # the compile path (slice 2): every count set to 0 just before it, read
    # just after; its probe runs here for the first time in the process
    zero_counts()
    probe_phase()
    pom = compile_path_phase()
    wl = workloads_phase()
    wl_default = default_size_phase()
    compile_counts = read_counts()
    print(f"launches on the compile path: {compile_counts}")
    check_counts("compile path", {k: n for k, n in compile_counts.items()
                                  if k not in ("contraction", "probe")}, {})
    _add(launches, compile_counts)
    # slice 4: the kernel library (its counts set to 0 just before it)
    library = library_phase()
    errs.update(library["errs"])
    _add(launches, library["launches"])
    print(f"launches on all paths: {launches}")
    for name in (*KERNEL_MODULES, *BACKWARD):
        if launches.get(name, 0) == 0:
            fail(f"{name} was never launched on the main path")
    rows = (numbers_phase(errs, launches) + compile_numbers_phase(errs, launches)
            + lm_numbers_phase(errs, launches) + library_numbers_phase(errs, launches))
    print(json.dumps({"serve": served["serve"], "forward": fwd["forward"],
                      "train": trained["train"], "train_families": trained_families,
                      "families": families, "compile_path": pom, "workloads": wl,
                      "workloads_default_size": wl_default,
                      "kernel_library": {k: library[k] for k in
                                         ("wall_ms", "vs_compile_path_max_abs_err")},
                      "card": card}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
