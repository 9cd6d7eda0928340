"""How sensitive the full-width models' logits are to rounding, on one GPU.

    python3 tools/logit_sensitivity.py [arch ...]    # default: the three below

Measures why two correct computations of the same seeded random-weight model
disagree, which is what decides how ``chip_smoke.py`` holds each family to
its plain versions:

* granite_moe_1b (bf16): the router's margin between the k-th and (k+1)-th
  expert probability; serve logits (batch 8, 63 teacher-forced steps) and a
  4 x 512 forward, kernels vs plain, and two plain versions that differ only
  in the grouped matmul's sums (f32 vs f64), with the (token, layer) slots
  whose expert choice differs and the largest error where none differs;
* zamba2_1_2b, xlstm_1_3b: the bf16 plain forward against the plain forward
  of an f32 copy of the same weights; the f32 plain logits after moving one
  embedding row by 1e-3 of its largest entry; and, for zamba2, where along
  the depth a bf16 decode step through the kernels parts from the plain one.

Imports nothing of JAX.  Exits non-zero without a card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def err(a: torch.Tensor, b: torch.Tensor, v: int) -> tuple:
    """(max abs error over the real vocabulary, as a share of b's scale)."""
    e = (a[..., :v].float() - b[..., :v].float()).abs().max().item()
    return e, e / b[..., :v].abs().max().item()


def moe_case(arch: str) -> None:
    from chip_smoke import teacher_forced
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import forward, init_params
    from repro_torch.models import moe as MOE
    cfg = get_config(arch)
    model = init_params(cfg, seed=0, device="cuda")
    v, k = cfg.vocab_size, cfg.experts_per_token
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, v, (8, 63))).cuda()
    log = []
    route = MOE.route

    def recording(p, xf, c):
        probs, vals, ids = route(p, xf, c)
        top = torch.sort(probs, dim=-1, descending=True).values
        log.append((ids.sort(dim=-1).values, top[:, k - 1] - top[:, k]))
        return probs, vals, ids

    @contextlib.contextmanager
    def f64_gmm():
        plain = ref.grouped_matmul
        # the MoE's x is zero past the row counts, so the dense product is the masked one
        ref.grouped_matmul = lambda x, w, rows=None: torch.einsum(
            "ecd,edf->ecf", x.double(), w.double()).to(x.dtype)
        try:
            with ops.plain_versions():
                yield
        finally:
            ref.grouped_matmul = plain

    MOE.route = recording
    runs = {}
    for name, ctx in (("kernels", contextlib.nullcontext), ("plain", ops.plain_versions),
                      ("plain, f64 sums", f64_gmm)):
        log.clear()
        with ctx():
            logits = teacher_forced(model, tokens)
        ids = torch.stack([i for i, _ in log]).reshape(63, cfg.num_layers, 8, k)
        gaps = torch.stack([g for _, g in log])
        runs[name] = (logits, ids, gaps)
    gaps = runs["kernels"][2]
    print(f"{arch}: k-th vs (k+1)-th router probability, median gap "
          f"{gaps.median().item():.4g}, share under 1e-3 {(gaps < 1e-3).float().mean().item():.4f}")
    for a, b in (("kernels", "plain"), ("plain, f64 sums", "plain")):
        (la, ia, _), (lb, ib, _) = runs[a], runs[b]
        flips = (ia != ib).any(-1)                       # (step, layer, row)
        clean = ~flips.any(1).transpose(0, 1)            # (row, step): no layer differs
        e, share = err(la, lb, v)
        per_step = (la - lb)[..., :v].abs().amax(-1)          # (row, step)
        e_clean = per_step[clean].max().item() if bool(clean.any()) else 0.0
        print(f"{arch} serve 8 x 63, {a} vs {b}: max abs err {e:.4g} ({share:.4f} of scale); "
              f"{int(flips.sum())} of {flips.numel()} (token, layer) choices differ; "
              f"largest error where none differs {e_clean:.4g}")
    fwd = torch.from_numpy(np.random.default_rng(1).integers(0, v, (4, 512))).cuda()
    outs = {}
    for name, ctx in (("kernels", contextlib.nullcontext), ("plain", ops.plain_versions),
                      ("plain, f64 sums", f64_gmm)):
        with ctx():
            outs[name] = forward(model, tokens=fwd)[0]
    MOE.route = route
    for a in ("kernels", "plain, f64 sums"):
        e, share = err(outs[a], outs["plain"], v)
        print(f"{arch} forward 4 x 512, {a} vs plain: max abs err {e:.4g} ({share:.4f} of scale)")


def recurrent_case(arch: str) -> None:
    from chip_smoke import teacher_forced
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model, forward, init_params
    from repro_torch.models import model as MD
    cfg = get_config(arch)
    v = cfg.vocab_size
    m16 = init_params(cfg, seed=0, device="cuda")
    m32 = Model(dataclasses.replace(cfg, dtype="float32", param_dtype="float32"), "cuda")
    m32.load_state_dict({n: t.float() for n, t in m16.state_dict().items()})
    s = 1024 if cfg.family == "hybrid" else 512
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, v, (2, s))).cuda()
    with ops.plain_versions():
        p16 = forward(m16, tokens=tokens)[0]
        p32 = forward(m32, tokens=tokens)[0]
        e, share = err(p16, p32, v)
        print(f"{arch} forward 2 x {s}, plain bf16 vs plain f32 copy: max abs err {e:.4g} "
              f"({share:.4f} of scale)")
        del p16
        emb = m32.embed.tok.data
        row = int(tokens[0, 0])
        keep = emb[row].clone()
        emb[row] += 1e-3 * emb[row].abs().max()
        moved = forward(m32, tokens=tokens[:, :64])[0]
        emb[row] = keep
        e, share = err(moved, p32[:, :64], v)
        print(f"{arch} f32 plain forward 2 x 64, token {row}'s embedding row moved by 1e-3 of "
              f"its largest entry: max abs err {e:.4g} ({share:.4f} of scale)")
    if cfg.family != "hybrid":
        return
    seen = []
    rmsnorm = MD.L.rmsnorm

    def recording(p, x, eps=1e-5):
        seen.append(x.float().clone())
        return rmsnorm(p, x, eps)

    steps = torch.from_numpy(np.random.default_rng(0).integers(0, v, (8, 21))).cuda()
    trace = {}
    for name, ctx in (("kernels", contextlib.nullcontext), ("plain", ops.plain_versions)):
        with ctx():
            seen.clear()
            MD.L.rmsnorm = recording
            try:
                teacher_forced(m16, steps)
            finally:
                MD.L.rmsnorm = rmsnorm
        trace[name] = seen[-(len(seen) // 21):]     # the norm inputs of the last step
    diffs = [(a - b).abs().max().item() for a, b in zip(trace["kernels"], trace["plain"])]
    first = next((i for i, d in enumerate(diffs) if d > 0), None)
    print(f"{arch} bf16 decode step 21, kernels vs plain, max |difference| of the residual "
          f"stream at each of the {len(diffs)} norm inputs (block order): first nonzero at "
          f"{first}; " + ", ".join(f"{d:.3g}" for d in diffs[::4]) + f"; last {diffs[-1]:.3g}")


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("logit_sensitivity: needs an NVIDIA GPU")
    from repro_torch.configs import get_config
    for arch in argv or ["granite_moe_1b", "zamba2_1_2b", "xlstm_1_3b"]:
        (moe_case if get_config(arch).family == "moe" else recurrent_case)(arch)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
