"""Multi-pod dry run of the port: one (arch x shape x mesh) cell on ``meta``
tensors, as rank 0 of a fake process group (the counterpart of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm_360m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch zamba2_1_2b --shape long_500k \\
        [--multi-pod | --mesh 1x1] [--variant dots] [--out PATH]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jobs 4] [--force]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch ... --shape ... --recost

For a cell this:
  1. sets up a fake process group (``torch.testing._internal.distributed.
     fake_pg``) of 256 ranks, this process rank 0, and a ``DeviceMesh`` of
     16x16 (``data``, ``model``) over it (512 ranks, 2x16x16 with ``pod``,
     under ``--multi-pod``; ``--mesh`` another shape, e.g. ``1x1``): every
     collective returns at once and moves nothing;
  2. builds the sharded step of ``distributed/step.py`` (``make_train_step``,
     ``make_prefill_step`` or ``make_decode_step``, the last with
     ``long_context`` for ``long_500k``) and rank 0's shards of its inputs
     on ``meta``: parameters, moments, ``input_specs``' batch, the decode
     cache;
  3. runs the step once, counting the FLOPs of PyTorch's own operators
     (``FlopCounterMode``), the kernels' FLOPs and bytes (each kernel
     wrapper's shape-only branch, ``kernels/meta.py``), the collectives'
     calls and bytes by kind (``collectives.count_collectives``: what rank
     0 would hand over) and the peak memory the step holds
     (``MemTracker``);
  4. prints the report as JSON (and writes it to ``--out``).

``--variant`` applies one of ``VARIANTS``: config overrides, and rule
overrides that go into the mesh context (``sp``: ``{"seq": ("model",)}``,
Megatron's sequence parallelism on the residual stream, as the reference
runs it under ``use_mesh(mesh, rules=...)``); the report records the rules.
An override of a field the port has no use for (``chunk2k``'s
``attn_chunk``, ``NO_EFFECT``) is taken out and recorded under
``no_effect`` with its reason, so that variant's cell is its base's.

Where the reference lowers and compiles with XLA, the port runs the step's
Python on ``meta`` tensors: ``lower_s`` is the seconds to build and run
it, and there is no ``compile_s``.  ``memory.argument_size_in_bytes`` is
the sum of the rank's argument shards from their local shapes, as XLA's
``argument_size_in_bytes`` counts them; ``temp_size_in_bytes`` is
``MemTracker``'s peak over the step less the arguments (what the step
allocates on top of them, the saved activations and the gradients
included).  ``fits`` holds ``bytes_per_device`` against the card's memory:
``torch.cuda.get_device_properties(0).total_memory`` where a card is
present, else the 80 GB of an H100 80GB HBM3.  ``cost.flops`` is
``FlopCounterMode``'s count plus the kernels' own (their roofline bound's
operations); ``cost.kernel_bytes`` the kernels' bytes (PyTorch's own
operators' bytes are not counted).  ``corrected`` is the reference's
extrapolation from depth P and 2P (``_extrapolate_costs``) over
``num_layers``: the port's eager step counts every layer, so it checks the
whole step's count rather than correcting it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                           "dryrun_torch")
H100_MEMORY = 80e9              # bytes: an H100 80GB HBM3, where no card is present

# named (config overrides, sharding-rule overrides), the reference's nine;
# every one runs (attn_chunk has no effect: NO_EFFECT)
VARIANTS: Dict[str, Tuple[Dict, Dict]] = {
    "base": ({}, {}),
    # Megatron-style sequence parallelism on the residual stream
    "sp": ({}, {"seq": ("model",)}),
    # bf16 unembed matmul (f32 accumulate): halves logits bytes
    "bf16logits": ({"logits_dtype": "bfloat16"}, {}),
    # remat only dot outputs instead of full blocks: fewer recompute flops
    "dots": ({"remat": "dots"}, {}),
    # no remat at all (memory-for-flops trade)
    "noremat": ({"remat": "none"}, {}),
    "sp+bf16logits": ({"logits_dtype": "bfloat16"}, {"seq": ("model",)}),
    "sp+bf16logits+dots": ({"logits_dtype": "bfloat16", "remat": "dots"},
                           {"seq": ("model",)}),
    # larger attention chunks (fewer scan steps, bigger score blocks)
    "chunk2k": ({"attn_chunk": 2048}, {}),
    "bf16logits+chunk2k": ({"logits_dtype": "bfloat16", "attn_chunk": 2048}, {}),
}


# config fields of the reference that the port's steps have no use for: a
# variant's override of one is taken out and recorded in the report
NO_EFFECT = {"attn_chunk": "the reference's attn_chunk sets only the query block of its XLA "
                           "attention (repro/models/layers.py chunked_attention, used where "
                           "use_pallas is False); the port's attention is the flash kernel on "
                           "every path (its plain version on the CPU), which tiles the "
                           "sequence itself, so configs/base.py has no such field"}


def _variant(variant: str) -> Tuple[Dict, Dict, Dict]:
    """The variant's (config overrides, sharding-rule overrides, the
    overrides taken out as having no effect in the port: ``NO_EFFECT``)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: {list(VARIANTS)}")
    cfg_over, rules_over = VARIANTS[variant]
    dropped = {k: v for k, v in cfg_over.items() if k in NO_EFFECT}
    cfg_over = {k: v for k, v in cfg_over.items() if k not in NO_EFFECT}
    return cfg_over, rules_over, dropped


def structural_period(cfg) -> int:
    if cfg.family == "moe":
        return cfg.moe_every
    if cfg.family == "hybrid":
        return cfg.attn_every or 1
    if cfg.family == "ssm":
        return cfg.slstm_every or 1
    return 1


def production_mesh(multi_pod: bool) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    return ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))


def parse_mesh(text: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """"DxM" -> (data, model); "PxDxM" -> (pod, data, model)."""
    shape = tuple(int(n) for n in text.split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(shape))
    if axes is None:
        raise ValueError(f"--mesh {text!r}: give DxM or PxDxM")
    return shape, axes


def fake_mesh(shape, axes, rules: Optional[Dict] = None):
    """A ``MeshContext`` with the sharding-rule overrides ``rules`` over a
    ``DeviceMesh`` of ``shape`` on a fake process group of prod(shape)
    ranks, this process rank 0 (set up on first use)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.distributed.sharding import MeshContext
    n = math.prod(shape)
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    elif dist.get_world_size() != n:
        raise RuntimeError(f"the fake process group has {dist.get_world_size()} ranks, mesh "
                           f"{shape} needs {n}")
    return MeshContext(init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes)),
                       rules)


def build(cfg, shape, mc, long_ctx: bool):
    """(run, arguments): ``run()`` calls the cell's sharded step once on
    rank 0's ``meta`` shards; ``arguments`` {name: tensor tree} of those
    shards."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.distributed import step as S
    from repro_torch.distributed.partition import tree_map
    from repro_torch.models.model import Model, init_cache
    pcfg = ParallelConfig()
    meta = torch.device("meta")
    specs = S.input_specs(cfg, shape)
    if shape.kind == "train":
        step, (param_sh, opt_sh, batch_sh) = S.make_train_step(cfg, pcfg, mc)
        model = S.place_params(Model(cfg, device=meta), param_sh)
        opt = S.init_opt_state(model, opt_sh, cfg)
        batch = {k: batch_sh[k].local_slice(v) for k, v in specs.items()}
        args = {"params": dict(model.named_parameters()), "opt": {"m": opt.m, "v": opt.v,
                                                                   "step": opt.step},
                "batch": batch}
        return (lambda: step(model, opt, batch)), args
    if shape.kind == "prefill":
        prefill, (param_sh, batch_sh) = S.make_prefill_step(cfg, pcfg, mc)
        model = S.place_params(Model(cfg, device=meta), param_sh)
        batch = {k: batch_sh[k].local_slice(v) for k, v in specs.items()}
        args = {"params": dict(model.named_parameters()), "batch": batch}
        return (lambda: prefill(model, batch)), args
    b = shape.global_batch
    serve, (param_sh, cache_sh, tok_sh) = S.make_decode_step(cfg, pcfg, mc, b, shape.seq_len,
                                                             long_context=long_ctx)
    model = S.place_params(Model(cfg, device=meta), param_sh)
    cache = tree_map(lambda t, sh: torch.empty(sh.local_shape(t.shape), dtype=t.dtype,
                                               device=meta),
                     init_cache(cfg, b, shape.seq_len, device=meta), cache_sh)
    token, pos = (tok_sh.local_slice(specs[k]) for k in ("token", "pos"))
    args = {"params": dict(model.named_parameters()), "cache": cache, "token": token,
            "pos": pos}
    return (lambda: serve(model, cache, token, pos)), args


def measure(cfg, shape, mc, long_ctx: bool, memory: bool = False) -> Dict:
    """The cell's step run once on ``meta``: its FLOPs (PyTorch's operators
    and the kernels'), the kernels' bytes by kernel, the collectives by
    kind, the argument bytes and, with ``memory``, ``MemTracker``'s peak."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed.collectives import count_collectives
    from repro_torch.distributed.partition import tree_leaves
    from repro_torch.kernels import meta as kernel_meta
    run, args = build(cfg, shape, mc, long_ctx)
    kernel_meta.reset()
    leaves = tree_leaves(args)
    out = {"argument_bytes": sum(t.numel() * t.element_size() for t in leaves)}
    mt = None
    if memory:
        from torch.distributed._tools.mem_tracker import MemTracker
        mt = MemTracker()
        mt.track_external(*leaves)
    with count_collectives() as coll, FlopCounterMode(display=False) as fc, \
            mt or contextlib.nullcontext():
        run()
    if mt is not None:
        out["peak_bytes"] = int(mt.get_tracker_snapshot("peak")[torch.device("meta")]["Total"])
    k = kernel_meta.totals()
    out.update(counted_flops=float(fc.get_total_flops()), kernel_flops=k["flops"],
               kernel_bytes=k["bytes"],
               kernels={n: {"calls": c[0], "flops": c[1], "bytes": c[2]}
                        for n, c in kernel_meta.counts.items()},
               collectives={kind: {"calls": c[0], "bytes": c[1]} for kind, c in coll.items()})
    out["flops"] = out["counted_flops"] + out["kernel_flops"]
    return out


def extrapolate_costs(cfg, shape, mc, long_ctx: bool) -> Dict:
    """The reference's ``_extrapolate_costs``: the step at depth P and 2P
    (P the structural period), extrapolated linearly over ``num_layers``."""
    period = structural_period(cfg)
    vals = {m: measure(dataclasses.replace(cfg, num_layers=period * m), shape, mc, long_ctx)
            for m in (1, 2)}
    n_periods = cfg.num_layers / period
    out = {}
    for key in ("flops", "kernel_bytes"):
        per = vals[2][key] - vals[1][key]
        out[key] = max(vals[1][key] + per * (n_periods - 1), vals[1][key])
    coll = {}
    for op in set(vals[1]["collectives"]) | set(vals[2]["collectives"]):
        c1, c2 = (vals[m]["collectives"].get(op, {"calls": 0, "bytes": 0}) for m in (1, 2))
        coll[op] = {k: max(c1[k] + (c2[k] - c1[k]) * (n_periods - 1), 0.0)
                    for k in ("calls", "bytes")}
    out["collectives"] = coll
    out["period"] = period
    out["note"] = ("depth P and 2P extrapolated linearly over num_layers; exact where the "
                   "depth is a multiple of P")
    return out


def device_memory() -> Tuple[float, str]:
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory), \
            torch.cuda.get_device_name(0)
    return H100_MEMORY, "NVIDIA H100 80GB HBM3 (no card present: its 80 GB)"


def run_cell(arch: str, shape_name, multi_pod: bool = False, skip_compile: bool = False,
             variant: str = "base", mesh: Optional[str] = None, cfg=None) -> Dict:
    """One cell's report.  ``shape_name`` a name of ``SHAPES`` or a
    ``ShapeConfig``; ``cfg`` replaces ``get_config(arch)`` (a reduced
    config, as the tests run); ``mesh`` ("DxM", "PxDxM") replaces the
    production mesh."""
    from repro_torch.configs.base import SHAPES, get_config
    t0 = time.time()
    cfg = cfg or get_config(arch)
    cfg_over, rules, dropped = _variant(variant)
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mesh_shape, axes = parse_mesh(mesh) if mesh else production_mesh(multi_pod)
    chips = math.prod(mesh_shape)
    report: Dict = {"arch": arch, "shape": shape.name,
                    "mesh": "x".join(map(str, mesh_shape)), "variant": variant,
                    "rules": {k: list(v) for k, v in rules.items()},
                    "chips": chips, "kind": shape.kind, "params": cfg.param_count(),
                    "active_params": cfg.active_param_count()}
    if dropped:
        report["no_effect"] = dropped
        report["no_effect_reason"] = {k: NO_EFFECT[k] for k in dropped}
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        report["status"] = "skipped"
        report["reason"] = ("pure full-attention arch: 500k decode is quadratic-KV; skipped "
                            "per assignment (DESIGN.md SS5)")
        return report
    long_ctx = shape.name == "long_500k"
    mc = fake_mesh(mesh_shape, axes, rules)
    if skip_compile:
        build(cfg, shape, mc, long_ctx)
        report["lower_s"] = round(time.time() - t0, 1)
        report["status"] = "lowered"
        return report
    m = measure(cfg, shape, mc, long_ctx, memory=True)
    report["lower_s"] = round(time.time() - t0, 1)
    temp = max(m["peak_bytes"] - m["argument_bytes"], 0)
    report["memory"] = {"argument_size_in_bytes": m["argument_bytes"],
                        "temp_size_in_bytes": temp}
    report["bytes_per_device"] = m["argument_bytes"] + temp
    limit, card = device_memory()
    report["device_memory"] = {"bytes": limit, "card": card}
    report["fits"] = bool(report["bytes_per_device"] <= limit)
    report["cost"] = {k: m[k] for k in ("flops", "counted_flops", "kernel_flops",
                                        "kernel_bytes", "kernels")}
    report["collectives"] = m["collectives"]
    report["corrected"] = extrapolate_costs(cfg, shape, mc, long_ctx)
    # analytic model FLOPs (global): 6 N_active a token for training
    # (forward and backward), 2 N_active a token otherwise
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mf = (6.0 if shape.kind == "train" else 2.0) * cfg.active_param_count() * tokens
    report["model_flops_global"] = mf
    report["model_flops_per_device"] = mf / chips
    report["status"] = "ok"
    report["total_s"] = round(time.time() - t0, 1)
    return report


def recost_cell(arch: str, shape_name: str, multi_pod: bool, path: str,
                mesh: Optional[str] = None) -> Dict:
    """Refresh only the ``corrected`` extrapolation of a cell's report."""
    from repro_torch.configs.base import SHAPES, get_config
    with open(path) as f:
        report = json.load(f)
    if report.get("status") != "ok":
        return report
    cfg = get_config(arch)
    cfg_over, rules, _ = _variant(report.get("variant", "base"))
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    mesh_shape, axes = parse_mesh(mesh) if mesh else production_mesh(multi_pod)
    report["corrected"] = extrapolate_costs(cfg, SHAPES[shape_name],
                                            fake_mesh(mesh_shape, axes, rules),
                                            shape_name == "long_500k")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    return report


def cell_path(arch: str, shape: str, multi_pod: bool) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    return os.path.join(RESULTS_DIR, f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}.json")


def orchestrate(jobs: int, archs: List[str], shapes: List[str], meshes: List[bool],
                force: bool = False) -> int:
    """Every cell in its own subprocess (a process holds one fake process
    group), ``jobs`` at a time; returns the number that failed."""
    todo = [(a, s, mp, cell_path(a, s, mp)) for a in archs for s in shapes for mp in meshes]
    todo = [t for t in todo if force or not os.path.exists(t[3])]
    print(f"dry-run: {len(todo)} cells to run, {jobs} parallel jobs")
    procs: List[Tuple[subprocess.Popen, Tuple]] = []
    failed = 0
    queue = list(todo)
    while queue or procs:
        while queue and len(procs) < jobs:
            a, s, mp, p = item = queue.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", s,
                   "--out", p] + (["--multi-pod"] if mp else [])
            procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT), item))
        for pr, item in list(procs):
            if pr.poll() is None:
                continue
            procs.remove((pr, item))
            out = pr.stdout.read().decode(errors="replace")
            a, s, mp, _ = item
            tag = f"{a} x {s} x {'pod2' if mp else 'pod1'}"
            if pr.returncode != 0:
                failed += 1
                print(f"[FAIL] {tag}\n{out[-2000:]}")
            else:
                print(f"[ok]   {tag}")
        time.sleep(1.0)
    return failed


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", help="a mesh other than the production one: DxM or PxDxM")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--skip-compile", action="store_true",
                    help="build the step and its arguments, do not run it")
    ap.add_argument("--recost", action="store_true",
                    help="refresh only the cost extrapolation of an existing cell report")
    ap.add_argument("--variant", default="base", help=f"perf variant: {list(VARIANTS)}")
    args = ap.parse_args(argv)

    if args.all:
        from repro_torch.configs.base import ARCH_IDS, SHAPES
        sys.exit(1 if orchestrate(args.jobs, ARCH_IDS, list(SHAPES), [False, True],
                                  args.force) else 0)
    if args.recost:
        path = args.out or cell_path(args.arch, args.shape, args.multi_pod)
        report = recost_cell(args.arch, args.shape, args.multi_pod, path, args.mesh)
        print(json.dumps(report.get("corrected", {}), indent=2))
        sys.exit(0)
    report = run_cell(args.arch, args.shape, args.multi_pod, args.skip_compile,
                      variant=args.variant, mesh=args.mesh)
    out = json.dumps(report, indent=2)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
    if report.get("status") not in ("ok", "skipped", "lowered"):
        sys.exit(1)


if __name__ == "__main__":
    main()
