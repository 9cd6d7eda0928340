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
  6. numbers -- per-kernel times with CUDA events (L2 flushed before every
                launch), each kernel's bound, the plain version's and
                ``scaled_dot_product_attention``'s time on the same inputs
                (a yardstick only: the port never calls it), tokens/s, peak
                memory.  One ``{"kernels": [...]}`` JSON line.
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
# 6. numbers
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


def main() -> None:
    card = device_phase()
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails where the repo is absent)
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    build_phase()
    errs = kernel_phase()
    cfg = get_config("smollm_360m")
    model = init_params(cfg, seed=0, device="cuda")
    print(f"model {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, params "
          f"{sum(p.numel() for p in model.parameters())}, {cfg.param_dtype}")
    served = serve_phase(model)
    fwd = forward_phase(model)
    launches = {"decode_attention": served["launches"]["decode_attention"],
                "flash_attention": fwd["launches"]["flash_attention"]}
    for name, n in launches.items():
        if n == 0:
            fail(f"{name} was never launched on the main path")
    rows = numbers_phase(errs, launches)
    print(json.dumps({"serve": served["serve"], "forward": fwd["forward"], "card": card}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
