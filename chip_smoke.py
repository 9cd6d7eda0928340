"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero without the final ok line):
  1. device  -- a CUDA device must be present; prints nvidia-smi's name and
                power limit;
  2. build   -- builds every CUDA kernel of the path from ``src/repro_torch/csrc``
                (one nvcc per source, in parallel) and prints ptxas's summary;
  3. kernels -- each kernel against its plain PyTorch version on the card;
  4. serve   -- smollm_360m at full width (32 layers, d_model 960), bf16,
                seeded random weights, batch 8, prompt 64, gen 64, through
                ``repro_torch.launch.serve.serve``; the decode kernel must run
                32 times per decode step; logits are held against the same
                tokens teacher-forced through the plain attention;
  5. forward -- a 512-token prompt (batch 4) through ``forward`` (the flash
                kernel), held against teacher-forced decode logits;
  6. contraction vs plain -- the contraction kernel against its plain
                version in f32 and bf16 on the compile path's schedules
                (tiled gemm at n 256 and at the path's n 4096, unscheduled
                gemm, tiled matvec, conv nests, batched gemm), and the probe
                kernel against x + 1;
  7. probe   -- the compile path's once-per-process CUDA probe
                (``cuda_supported()``, first called here) must pass after
                exactly one launch;
  8. compile path at size -- gemm, 2mm and 3mm at n = 4096 (f32), tiled
                32 x 32 x 32 with the DSL's tile/split/unroll primitives,
                through ``compile(fn, target="cuda")``: calling the program
                and ``jitted()`` each launch the contraction kernel once per
                statement and agree with ``torch.matmul`` compositions;
  9. workloads -- the thirteen serving workloads (``serving_cases(False)``)
                through ``jitted()`` and ``batched(8)`` on the card against
                the numpy oracle and eight sequential calls (times after a
                warm-up, the median of five), and through
                ``CompileService.cuda_runner`` (greedy DSE, serial);
 10. workloads at default size -- the same thirteen programs at the
                builders' default sizes (``default_cases()``: n 4096, the
                stencils' 100 or 10 steps) through ``jitted()``, against the
                same computations written directly in PyTorch on the card;
 11. numbers -- per-kernel times with CUDA events (L2 flushed before every
                launch), each kernel's bound, the plain version's time and a
                PyTorch yardstick on the same inputs (SDPA, ``torch.addmm``,
                ``torch.add``; the port never calls them), tokens/s, GFLOP/s,
                peak memory.  One ``{"kernels": [...]}`` JSON line.
Phases 7-10 are the compile path: every launch count is set to 0 just
before phase 7 and read just after phase 10.
The last line is ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

SERVE_B, SERVE_PROMPT, SERVE_GEN = 8, 64, 64
FWD_B, FWD_S = 4, 512
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


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


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
        print(f"ptxas {name}: {len(regs)} kernels; "
              f"registers {sorted(set(int(r.split()[0]) for r in regs))}; "
              f"spilling entries {len(spills)}" + (f" e.g. {spills[0]}" if spills else ""))


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

    # (B, Hq, Hkv, S, D, dtype): full-width smollm shapes first
    decode_cases = [(8, 15, 5, 1024, 64, torch.bfloat16),
                    (SERVE_B, 15, 5, SERVE_PROMPT + SERVE_GEN, 64, torch.bfloat16),
                    (2, 4, 4, 200, 64, torch.float32),      # group 1, ragged S
                    (2, 8, 2, 77, 32, torch.float32),       # group 4
                    (3, 4, 1, 300, 128, torch.float32)]
    for b, hq, hkv, s, d, dt in decode_cases:
        q = _randn(g, b, hq, d, dtype=dt)
        k, v = _randn(g, b, hkv, s, d, dtype=dt), _randn(g, b, hkv, s, d, dtype=dt)
        length = torch.randint(1, s + 1, (b,), generator=g, device="cuda", dtype=torch.int32)
        want = ref.decode_attention(q, k, v, length=length)
        for schedule in ("pom", "naive"):
            got = ops.decode_attention(q, k, v, length=length, schedule=schedule)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            print(f"decode B{b} Hq{hq} Hkv{hkv} S{s} D{d} {str(dt)[6:]} {schedule}: "
                  f"max abs err {err:.3g}")
            if not err <= _tol(dt):
                fail(f"decode_attention disagrees with its plain version: {err}")
            errs["decode_attention"] = max(errs["decode_attention"], err)

    # (B, Hq, Hkv, Sq, Skv, D, causal, dtype)
    flash_cases = [(FWD_B, 15, 5, FWD_S, FWD_S, 64, True, torch.bfloat16),
                   (2, 4, 4, 100, 100, 64, False, torch.float32),   # non-causal, ragged
                   (1, 4, 1, 64, 200, 64, True, torch.float32),     # Sq < Skv suffix
                   (2, 8, 2, 130, 130, 32, True, torch.float32),    # group 4, ragged
                   (1, 4, 4, 96, 96, 128, True, torch.float32)]     # group 1
    for b, hq, hkv, sq, skv, d, causal, dt in flash_cases:
        q = _randn(g, b, hq, sq, d, dtype=dt)
        k, v = _randn(g, b, hkv, skv, d, dtype=dt), _randn(g, b, hkv, skv, d, dtype=dt)
        want = ref.attention(q, k, v, causal=causal)
        for schedule in ("pom", "naive"):
            got = ops.attention(q, k, v, causal=causal, schedule=schedule)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            print(f"flash B{b} Hq{hq} Hkv{hkv} Sq{sq} Skv{skv} D{d} causal={causal} "
                  f"{str(dt)[6:]} {schedule}: max abs err {err:.3g}")
            if not err <= _tol(dt):
                fail(f"flash_attention disagrees with its plain version: {err}")
            errs["flash_attention"] = max(errs["flash_attention"], err)
    return errs


# --------------------------------------------------------------------------
# 4. serve at full width
# --------------------------------------------------------------------------
def serve_phase(model) -> dict:
    phase("serve smollm_360m full width")
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import serve
    from repro_torch.models import decode_step, init_cache
    cfg = model.cfg
    b, p, gen = SERVE_B, SERVE_PROMPT, SERVE_GEN
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (b, p)))
    serve(model, prompts[:, :4], 4)            # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    dmod.launches = fmod.launches = 0
    res = serve(model, prompts, gen, keep_logits=True)
    launches = {"decode_attention": dmod.launches, "flash_attention": fmod.launches}
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
    cache = init_cache(cfg, b, p + gen, device="cuda")
    plain = []
    for t in range(steps):
        lg, cache = decode_step(model, cache, forced[:, t],
                                torch.full((b,), t, dtype=torch.long, device="cuda"),
                                ref.decode_attention)
        plain.append(lg)
    plain = torch.stack(plain, dim=1)
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


def busy_share(fn, per: int, label: str, kernel: str) -> dict:
    """Wall time of ``fn`` (unprofiled) and the card's busy time over the
    same work (``torch.profiler``), both divided by ``per`` units: how far
    the host holds the card back, and the device time of the port's
    ``kernel``.  Returns {} when the profiler records no device activity."""
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
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"{label} device busy time: not measured (the profiler saw no kernels)")
        return {}
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + 1e-3 * e.time_range.elapsed_us() / per
    busy_ms = sum(by_name.values())
    kernel_ms = sum(ms for name, ms in by_name.items() if kernel in name)
    print(f"{label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(share {busy_ms / wall_ms:.3f}), {len(kernels) / per:.0f} kernels; "
          f"the port's {kernel} {kernel_ms:.4f} ms")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {ms:.4f} ms  {name[:100]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms, "kernels": len(kernels) / per,
            f"{kernel}_ms": kernel_ms}


# --------------------------------------------------------------------------
# 5. forward at full width
# --------------------------------------------------------------------------
def forward_phase(model) -> dict:
    phase("forward smollm_360m full width")
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.models import decode_step, forward, init_cache
    cfg = model.cfg
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (FWD_B, FWD_S))).cuda()
    forward(model, tokens=tokens[:, :8])       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    dmod.launches = fmod.launches = 0
    t0 = time.perf_counter()
    logits, _ = forward(model, tokens=tokens)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    launches = {"decode_attention": dmod.launches, "flash_attention": fmod.launches}
    peak = torch.cuda.max_memory_allocated()
    print(f"launches in the forward run: {launches}")
    if launches["flash_attention"] != cfg.num_layers:
        fail(f"flash_attention ran {launches['flash_attention']} times, "
             f"expected {cfg.num_layers}")
    v = cfg.vocab_size
    if logits.shape != (FWD_B, FWD_S, cfg.padded_vocab_size) \
            or not bool(torch.isfinite(logits[..., :v]).all()):
        fail("forward logits malformed or not finite")

    cache = init_cache(cfg, FWD_B, FWD_S, device="cuda")
    dec = []
    for t in range(FWD_S):
        lg, cache = decode_step(model, cache, tokens[:, t],
                                torch.full((FWD_B,), t, dtype=torch.long, device="cuda"))
        dec.append(lg[:, :v])
    dec = torch.stack(dec, dim=1)
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
# 7. the compile path's probe
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
# 6. contraction kernel vs plain version (and the probe kernel vs x + 1)
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
        label += " (tiled kernel)" if cmod.gemm_view(d) else " (generic kernel)"
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
# 8. the POM compile path at size: gemm, 2mm, 3mm at n = 4096
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
            n0 = cmod.launches
            t0 = time.perf_counter()
            got = run(arrs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = cmod.launches - n0
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
# 9. the thirteen serving workloads on the card
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
# 10. the thirteen workloads at their default sizes
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
# 11. numbers
# --------------------------------------------------------------------------
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


def bound(byts: float, flops: float, dtype) -> tuple:
    """The least time the card could take: bytes at the HBM rate or
    operations at the peak rate for ``dtype`` (H100 SXM data sheet)."""
    from repro_torch.core.cost_model import H100
    peak = H100.peak_flops_bf16 if dtype == torch.bfloat16 else H100.peak_flops_f32
    t_bytes = byts / H100.hbm_bw
    t_ops = flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def numbers_phase(errs: dict, launches: dict) -> list:
    phase("numbers")
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(2)
    dt = torch.bfloat16
    rows = []

    # decode at the serve's last step: cache S = prompt + gen, every row full
    b, hq, hkv, d = SERVE_B, 15, 5, 64
    for s, tag in ((SERVE_PROMPT + SERVE_GEN, "main"), (1024, "S1024-ragged")):
        q = _randn(g, b, hq, d, dtype=dt)
        k, v = _randn(g, b, hkv, s, d, dtype=dt), _randn(g, b, hkv, s, d, dtype=dt)
        if tag == "main":
            length = torch.full((b,), s, dtype=torch.int32, device="cuda")
        else:
            length = torch.randint(1, s + 1, (b,), generator=g, device="cuda",
                                   dtype=torch.int32)
        mask = (torch.arange(s, device="cuda")[None, :] < length[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        n_valid = int(length.sum())
        byts = 2 * n_valid * hkv * d * 2 + 2 * b * hq * d * 2 + 4 * b
        flops = 4.0 * n_valid * hq * d
        bms, by = bound(byts, flops, dt)
        ms = time_ms(lambda: ops.decode_attention(q, k, v, length=length))
        plain_ms = time_ms(lambda: ref.decode_attention(q, k, v, length=length))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                                                enable_gqa=True))
        print(f"decode_attention {tag} B{b} S{s}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {bms:.5f} ms ({by})")
        if tag == "main":
            rows.append({"name": "decode_attention", "route": "cuda",
                         "source": "src/repro_torch/csrc/decode_attention.cu",
                         "replaces": "src/repro/kernels/decode_attention.py:24",
                         "launches": launches["decode_attention"],
                         "max_abs_err": errs["decode_attention"], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                         "library_ms": lib_ms})

    # flash at the forward's shape
    b, s = FWD_B, FWD_S
    q = _randn(g, b, hq, s, d, dtype=dt)
    k, v = _randn(g, b, hkv, s, d, dtype=dt), _randn(g, b, hkv, s, d, dtype=dt)
    byts = (2 * b * hq * s * d + 2 * b * hkv * s * d) * 2
    flops = 4.0 * d * b * hq * (s * (s + 1) // 2)
    bms, by = bound(byts, flops, dt)
    ms = time_ms(lambda: ops.attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: ref.attention(q, k, v, causal=True), iters=20)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                            enable_gqa=True))
    print(f"flash_attention B{b} S{s}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {lib_ms:.4f} ms, bound {bms:.5f} ms ({by})")
    rows.append({"name": "flash_attention", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:27",
                 "launches": launches["flash_attention"],
                 "max_abs_err": errs["flash_attention"], "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bms, "bound_by": by, "library_ms": lib_ms})
    return rows


def compile_numbers_phase(errs: dict, launches: dict) -> list:
    phase("numbers: compile path kernels")
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
    ms = time_ms(lambda: cmod.contraction(d, x, y, o), iters=20, warmup=2)
    lib_ms = time_ms(lambda: torch.addmm(o.view(n, n), x.view(n, n), y.view(n, n)), iters=20)
    plain_ms = time_ms(lambda: ref.contraction(d, x, y, o), iters=20, warmup=2)
    print(f"contraction gemm n{n} t{POM_T} f32: {ms:.3f} ms "
          f"({d.flops() / ms / 1e6:.1f} GFLOP/s), plain {plain_ms:.4f} ms, "
          f"torch.addmm {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    rows.append({"name": "contraction", "route": "cuda",
                 "source": "src/repro_torch/csrc/contraction.cu",
                 "replaces": "src/repro/core/backend_pallas.py:286",
                 "launches": launches["contraction"], "max_abs_err": errs["contraction"],
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                 "library_ms": lib_ms, "shape": f"gemm n{n} tile {POM_T} f32"})
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
    return rows


def main() -> None:
    card = device_phase()
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails where the repo is absent)
    from repro_torch.configs import get_config
    from repro_torch.kernels import contraction as cmod
    from repro_torch.kernels import probe as pmod
    from repro_torch.models import init_params

    build_phase()
    errs = kernel_phase()
    errs["contraction"], errs["probe"] = contraction_phase()
    cfg = get_config("smollm_360m")
    model = init_params(cfg, seed=0, device="cuda")
    print(f"model {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, params "
          f"{sum(p.numel() for p in model.parameters())}, {cfg.param_dtype}")
    served = serve_phase(model)
    fwd = forward_phase(model)
    del model
    torch.cuda.empty_cache()
    # the compile path (slice 2): its counts set to 0 just before it, read
    # just after; its probe runs here for the first time in the process
    cmod.launches = pmod.launches = 0
    probe_phase()
    pom = compile_path_phase()
    wl = workloads_phase()
    wl_default = default_size_phase()
    launches = {"decode_attention": served["launches"]["decode_attention"],
                "flash_attention": fwd["launches"]["flash_attention"],
                "contraction": cmod.launches, "probe": pmod.launches}
    print(f"launches on the compile path: contraction {cmod.launches}, probe {pmod.launches}")
    for name, n in launches.items():
        if n == 0:
            fail(f"{name} was never launched on the main path")
    rows = numbers_phase(errs, launches) + compile_numbers_phase(errs, launches)
    print(json.dumps({"serve": served["serve"], "forward": fwd["forward"],
                      "compile_path": pom, "workloads": wl,
                      "workloads_default_size": wl_default, "card": card}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
