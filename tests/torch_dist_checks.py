"""Checks of the port's distribution, each run on every rank of a gloo group.

    python -m torch.distributed.run --nproc-per-node 4 --master-port PORT \\
        tests/torch_dist_checks.py CHECK JSON_ARGS

Each check raises on a failure (torchrun then exits non-zero) and rank 0
prints ``OK CHECK`` and one JSON line of what it measured.  The port's
tests launch them (``tests/test_torch_distributed*.py``); the JAX package
is not imported here: weights come in as an ``.npz`` of the JAX tree.
"""
import json
import os
import sys
import warnings

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
torch.set_num_threads(1)
if len(sys.argv) > 2 and json.loads(sys.argv[2]).get("f64"):
    # every f32 of the port in float64 (dtype arguments and .float() casts),
    # set before the port is imported: tells a formula apart from rounding
    torch.float32 = torch.float64
    torch.Tensor.float = torch.Tensor.double

from repro_torch.checkpoint import restore_pytree, save_pytree  # noqa: E402
from repro_torch.configs import ParallelConfig, get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import SyntheticLM, make_device_batch  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed import step as step_mod  # noqa: E402
from repro_torch.distributed.sharding import MeshContext, NamedSharding, use_mesh  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import decode_step, forward, init_cache, init_params, loss_fn  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

LOSS_RTOL = 1e-6           # the sharded loss against the one-process loss
GRAD_RTOL = 1e-5           # each gradient, as a relative norm of the difference
LOGITS_RTOL = 1e-5         # prefill and decode logits, of their largest |value|
# one sharded AdamW step's update against the one-process step's, as a
# relative norm: the first step moves each entry by about lr * g / |g|, so an
# entry whose gradient is near 0 swings with its last bits (a wrong slice or
# a lost reduction is O(1) off)
UPDATE_RTOL = 1e-2


def mesh(shape, axes, rules=None) -> MeshContext:
    """A ``MeshContext`` over a gloo mesh; ``rules`` overrides the sharding
    rules (``{"seq": ["model"]}``: sequence parallelism)."""
    return MeshContext(make_mesh(shape, axes, device="cpu"), rules)


def rank() -> int:
    return dist.get_rank()


def logits_err(got: torch.Tensor, want: torch.Tensor, scale: float) -> float:
    """Largest difference over ``scale`` (the whole logits' largest |value|)
    of the real vocab columns: the pads (-1e30) must agree exactly."""
    pad = want <= -1e29
    if not torch.equal(pad, got <= -1e29):
        return float("inf")
    return (got.masked_fill(pad, 0.0) - want.masked_fill(pad, 0.0)).abs().max().item() / scale


def real_scale(logits: torch.Tensor) -> float:
    return logits.masked_fill(logits <= -1e29, 0.0).abs().max().item()


def rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    d = (got.double() - want.double()).norm().item()
    n = want.double().norm().item()
    return d / n if n else d


def tree_from_npz(path: str) -> dict:
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = data[key]
    return tree


# --------------------------------------------------------------------------
# a family's sharded steps against the one-process step
# --------------------------------------------------------------------------
def _grads(model, batch):
    total, metrics = loss_fn(model, batch)
    total.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return metrics["loss"].item(), grads


def _drops(cfg, tree, batch) -> int:
    """Token slots the one-process forward drops over capacity, all layers."""
    seen = []
    orig = moe_mod.route

    def record(p, xf, c):
        out = orig(p, xf, c)
        seen.append(out[2])
        return out
    moe_mod.route = record
    try:
        with torch.no_grad():
            forward(from_jax_params(tree, cfg, device="cpu"), tokens=batch["tokens"])
    finally:
        moe_mod.route = orig
    cap = moe_mod.capacity(seen[0].shape[0], cfg)
    return sum(int((torch.bincount(ids.reshape(-1), minlength=cfg.num_experts) - cap)
                   .clamp(min=0).sum()) for ids in seen)


def check_family(args):
    cfg = reduced(get_config(args["arch"]), **args.get("overrides", {}))
    tree = tree_from_npz(args["weights"])
    b, s = args["batch"], args["seq"]
    batch_np = SyntheticLM(cfg, ShapeConfig("t", s, b, "train"), seed=1).batch_at(0)
    batch = make_device_batch(batch_np, "cpu")
    report = {"arch": cfg.name}
    if cfg.family == "moe":
        report["dropped"] = _drops(cfg, tree, batch)
        if args.get("drops") and not report["dropped"]:
            raise AssertionError("the capacity dropped no token")
    ref = from_jax_params(tree, cfg, device="cpu").requires_grad_(True)
    ref_loss, ref_grads = _grads(ref, batch)
    with torch.no_grad():
        ref_logits, _ = forward(ref, tokens=batch["tokens"])
    # the one-process step and its decode
    kw = dict(peak_lr=1e-2, warmup=0, total_steps=10)
    one = from_jax_params(tree, cfg, device="cpu")
    before = {n: p.detach().clone() for n, p in one.named_parameters()}
    step_mod.make_train_step(cfg, one, **kw)(
        adamw_init(dict(one.named_parameters()), cfg.optim_state_dtype,
                   cfg.optim_second_dtype), batch)
    after = {n: p.detach() for n, p in one.named_parameters()}
    max_seq = 6
    cache = init_cache(cfg, b, max_seq, device="cpu")
    dec = []
    for t in range(max_seq):
        dec.append(decode_step(ref, cache, batch["tokens"][:, t],
                               torch.full((b,), t, dtype=torch.long))[0].clone())

    for case in args["cases"]:
        shape, axes = tuple(case["mesh"]), tuple(case["axes"])
        pcfg = ParallelConfig(**case.get("pcfg", {}))
        mc = mesh(shape, axes, case.get("rules"))
        step, (param_sh, opt_sh, batch_sh) = step_mod.make_train_step(cfg, pcfg, mc, **kw)
        model = step_mod.place_params(from_jax_params(tree, cfg, device="cpu"), param_sh)
        local = make_device_batch(batch_np, batch_sh)
        model.requires_grad_(True)
        with use_mesh(mc):
            total, metrics = loss_fn(model, local)
            total.backward()
        grads, _ = step_mod.sync_grads(model, param_sh, opt_sh, mc)
        model.zero_grad(set_to_none=True)
        loss_err = abs(metrics["loss"].item() - ref_loss) / abs(ref_loss)
        grad_err = {n: rel_norm(g, opt_sh.m[n].local_slice(ref_grads[n])) for n, g in grads.items()}
        worst = max(grad_err, key=grad_err.get)
        if not loss_err <= LOSS_RTOL:
            raise AssertionError(f"{case}: loss {metrics['loss'].item()} vs {ref_loss}")
        if not grad_err[worst] <= args.get("grad_rtol", GRAD_RTOL):
            raise AssertionError(f"{case}: {worst}'s gradient {grad_err[worst]} off")
        # one whole sharded step: the update against the one-process step's
        model, opt, met = step(model, step_mod.init_opt_state(model, opt_sh, cfg), local)
        upd = {n: rel_norm(p.detach() - param_sh[n].local_slice(before[n]),
                           param_sh[n].local_slice(after[n] - before[n]))
               for n, p in model.named_parameters()}
        # prefill and decode through their builders
        prefill, (psh, _) = step_mod.make_prefill_step(cfg, pcfg, mc)
        model = step_mod.place_params(from_jax_params(tree, cfg, device="cpu"), psh)
        logits = prefill(model, make_device_batch(batch_np, batch_sh))
        want = mc.sharding(("batch", "seq", "vocab")).local_slice(ref_logits)
        prefill_err = logits_err(logits, want, real_scale(ref_logits))
        serve, (dsh, cache_sh, tok_sh) = step_mod.make_decode_step(cfg, pcfg, mc, b, max_seq)
        model = step_mod.place_params(from_jax_params(tree, cfg, device="cpu"), dsh)
        cache = step_mod.init_sharded_cache(cfg, b, max_seq, cache_sh)
        toks = tok_sh.local_slice(batch["tokens"])
        decode_err = 0.0
        for t in range(max_seq):
            got = serve(model, cache, toks[:, t], torch.full((toks.shape[0],), t,
                                                              dtype=torch.long))[0]
            want = mc.sharding(("batch", "vocab")).local_slice(dec[t])
            decode_err = max(decode_err, logits_err(got, want, real_scale(dec[t])))
        if not max(prefill_err, decode_err) <= LOGITS_RTOL:
            raise AssertionError(f"{case}: prefill {prefill_err}, decode {decode_err}")
        if not max(upd.values()) <= UPDATE_RTOL:
            raise AssertionError(f"{case}: the update of {max(upd, key=upd.get)} is off")
        key = "x".join(map(str, shape)) + "|" + json.dumps(case.get("pcfg", {}))
        report[key + ("|sp" if mc.sp else "")] = {
            "loss_rel_err": loss_err, "grad_rel_norm_max": grad_err[worst], "worst": worst,
            "update_rel_norm_max": max(upd.values()), "update_worst": max(upd, key=upd.get),
            "prefill_err": prefill_err, "decode_err": decode_err}
    return report


# --------------------------------------------------------------------------
# the loss falls at 2x2
# --------------------------------------------------------------------------
def check_learns(args):
    """The reference's ``check_train_step_sharded`` (dist_checks.py:24-55)
    on the port: 40 sharded steps at 2x2, the loss falls by more than 0.3."""
    cfg = reduced(get_config("smollm_360m"), d_model=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
    mc = mesh((2, 2), ("data", "model"))
    step, (param_sh, opt_sh, batch_sh) = step_mod.make_train_step(
        cfg, ParallelConfig(), mc, peak_lr=1e-2, warmup=5)
    model = step_mod.place_params(init_params(cfg, seed=0, device="cpu"), param_sh)
    opt = step_mod.init_opt_state(model, opt_sh, cfg)
    ds = SyntheticLM(cfg, ShapeConfig("t", 32, 8, "train"), seed=1)
    losses = []
    for i in range(40):
        model, opt, metrics = step(model, opt, make_device_batch(ds.batch_at(i), batch_sh))
        losses.append(metrics["loss"].item())
    if not (np.isfinite(losses).all() and min(losses[-5:]) < losses[0] - 0.3):
        raise AssertionError(f"no learning: {losses}")
    return {"first": losses[0], "min_last5": min(losses[-5:])}


def check_cli_resume(args):
    """``launch/train.py``'s ``main`` at ``--mesh 2x2`` for 4 steps, then at
    ``--mesh 4x1`` from its checkpoint: the restored state, gathered whole,
    is bit for bit the saved one."""
    from repro_torch.launch import train as train_mod
    base = ["--device", "cpu", "--reduced", "--steps", "4", "--workdir", args["workdir"],
            "--log-every", "2"]
    first = train_mod.main(base + ["--mesh", "2x2"])
    saved = _whole_state(first)
    again = train_mod.main(base + ["--mesh", "4x1"])
    if again.start != 4:
        raise AssertionError(f"the 4x1 run began at step {again.start}")
    restored = _whole_state(again)
    same = all(torch.equal(saved[k], restored[k]) for k in saved)
    if not same or saved.keys() != restored.keys():
        raise AssertionError("the state restored at 4x1 differs from the one saved at 2x2")
    return {"losses_2x2": first.losses, "leaves": len(saved)}


def _whole_state(res) -> dict:
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.launch.train import train_state
    flat = _flatten(train_state(res.model, res.opt))
    sh = _flatten(res.shardings)
    return {k: C.gather_whole(v.detach(), sh[k]) for k, v in flat.items()}


# --------------------------------------------------------------------------
# collectives, compression, GPipe, elastic restore
# --------------------------------------------------------------------------
def check_conjugate(args):
    """Megatron's pair at model 4: a replicated scale before f and one after
    g get the one-process gradients; the all-reduce that differentiates to
    a second all-reduce (``torch.distributed.nn.functional.all_reduce``)
    multiplies the first by the model size."""
    import torch.distributed.nn.functional as dnn
    mc = mesh((1, 4), ("data", "model"))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 8, generator=g)
    w1, w2 = torch.randn(8, 16, generator=g), torch.randn(16, 8, generator=g)
    s0, s1 = torch.randn(8, generator=g), torch.randn(8, generator=g)

    def run(tp, reduce):
        leaves = [t.clone().requires_grad_(True) for t in (x, s0, s1)]
        xl, a, c = leaves
        r = mc.index("model") if tp is not None else 0
        n = 4 if tp is not None else 1
        w1l = w1[:, r * 16 // n:(r + 1) * 16 // n].clone().requires_grad_(True)
        w2l = w2[r * 16 // n:(r + 1) * 16 // n].clone().requires_grad_(True)
        h = torch.relu(C.copy_to_model(xl * a, tp) @ w1l)
        y = reduce(h @ w2l) * c
        (y ** 2).sum().backward()
        return [t.grad for t in leaves], w1l.grad, w2l.grad

    with use_mesh(mc):
        tp = C.tp()                      # local: no parameter constrains it
        got, gw1, gw2 = run(tp, lambda t: C.reduce_from_model(t, tp))
        with warnings.catch_warnings():            # deprecated in newer PyTorch
            warnings.simplefilter("ignore", FutureWarning)
            bad, _, _ = run(tp, lambda t: dnn.all_reduce(t, group=mc.group("model")))
    want, ww1, ww2 = run(None, lambda t: t)
    r = mc.index("model")
    errs = [rel_norm(a, b) for a, b in zip(got, want)]
    errs += [rel_norm(gw1, ww1[:, r * 4:(r + 1) * 4]), rel_norm(gw2, ww2[r * 4:(r + 1) * 4])]
    if max(errs) > 1e-6:
        raise AssertionError(f"f/g gradients off: {errs}")
    scale = (bad[1].norm() / want[1].norm()).item()
    if abs(scale - 4.0) > 1e-4:
        raise AssertionError(f"the all-reduce-backward pair scaled s0's gradient by {scale}")
    return {"grad_rel_errs": errs, "all_reduce_backward_scale": scale}


def check_compression(args):
    """int8 + EF compressed sum over 4 ranks ~ the exact sum (the
    reference's ``check_compressed_psum``)."""
    from repro_torch.distributed.compression import compressed_psum
    make_mesh((4,), ("data",), device="cpu")
    xs = [torch.from_numpy(np.random.default_rng(r).normal(size=(64, 33)).astype(np.float32))
          for r in range(4)]
    got, resid = compressed_psum(xs[rank()], torch.zeros(64, 33), group=None)
    want = sum(xs)
    err = ((got - want).abs().max() / want.abs().max()).item()
    every = [torch.empty_like(got) for _ in range(4)]
    dist.all_gather(every, got)
    if not err < 0.05:
        raise AssertionError(f"compressed allreduce error {err}")
    if not all(torch.equal(every[0], e) for e in every):
        raise AssertionError("the ranks summed differently")
    if not resid.abs().max().item() > 0.0:
        raise AssertionError("the residual is zero")
    return {"rel_err": err, "residual_max": resid.abs().max().item()}


def check_gpipe(args):
    """GPipe over 4 stages == the sequential stack (``check_pp_gpipe``)."""
    from repro_torch.distributed.pp import gpipe_forward
    mc = mesh((4, 1), ("stage", "data"))
    nlayer, d = 8, 16
    rng = np.random.default_rng(2)
    ws = torch.from_numpy((rng.normal(size=(nlayer, d, d)) / np.sqrt(d)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(8, 4, d)).astype(np.float32))   # (mb, b, d)

    def layer(w, h):
        return torch.tanh(h @ w)

    want = x
    for i in range(nlayer):
        want = layer(ws[i], want)
    got = gpipe_forward(layer, ws, x, mc, stage_axis="stage", n_microbatches=8)
    err = (got - want).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"gpipe off by {err}")
    return {"max_abs_err": err}


def check_serve(args):
    """``launch/serve.py``'s ``serve`` at 2x2 (``make_decode_step``: each
    rank its batch rows, the logits gathered over ``model``) against one
    process: the same greedy tokens and logits within 1e-5."""
    from repro_torch.launch.serve import serve
    mc = mesh((2, 2), ("data", "model"))
    out = {}
    for arch in ("smollm_360m", "granite_moe_1b"):
        cfg = reduced(get_config(arch))
        prompts = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 8)))
        want = serve(init_params(cfg, seed=0, device="cpu"), prompts, 8, keep_logits=True)
        got = serve(init_params(cfg, seed=0, device="cpu"), prompts, 8, keep_logits=True,
                    mesh=mc)
        rows = slice(mc.index("data") * 2, mc.index("data") * 2 + 2)
        err = logits_err(got.logits, want.logits[rows], real_scale(want.logits))
        if not torch.equal(got.tokens, want.tokens[rows]) or not err <= LOGITS_RTOL:
            raise AssertionError(f"{arch}: serve at 2x2 differs ({err})")
        out[arch] = err
    return out


def check_elastic(args):
    """A state saved at 2x2 restores bit for bit at 4x1 and 1x4: the
    reference's ``check_elastic_reshard`` tree, and a reduced model's
    parameters and moments after one sharded step."""
    cfg = reduced(get_config("granite_moe_1b"))
    directory = args["dir"]
    mc = mesh((2, 2), ("data", "model"))
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.ones(8)}
    sh = {"w": NamedSharding(mc, ("data", "model")), "b": NamedSharding(mc, ("model",))}
    step, (param_sh, opt_sh, batch_sh) = step_mod.make_train_step(
        cfg, ParallelConfig(), mc, peak_lr=1e-2, warmup=0)
    model = step_mod.place_params(init_params(cfg, seed=0, device="cpu"), param_sh)
    ds = SyntheticLM(cfg, ShapeConfig("t", 16, 4, "train"), seed=0)
    model, opt, _ = step(model, step_mod.init_opt_state(model, opt_sh, cfg),
                         make_device_batch(ds.batch_at(0), batch_sh))
    state = {"params": dict(model.named_parameters()), "opt": opt}
    state_sh = {"params": param_sh, "opt": opt_sh}
    placed = {k: sh[k].local_slice(v).clone() for k, v in tree.items()}
    save_pytree(placed, os.path.join(directory, "tree"), 7, shardings=sh)
    save_pytree(state, os.path.join(directory, "state"), 1, shardings=state_sh)
    from repro_torch.checkpoint.manager import _flatten
    flat, fsh = _flatten(state), _flatten(state_sh)
    whole = {k: C.gather_whole(v.detach(), fsh[k]) for k, v in flat.items()}
    dist.barrier()
    out = {}
    for shape in ((4, 1), (1, 4)):
        mc2 = mesh(shape, ("data", "model"))
        sh2 = {"w": NamedSharding(mc2, ("data", "model")), "b": NamedSharding(mc2, ("data",))}
        got, stepno = restore_pytree(placed, os.path.join(directory, "tree"), shardings=sh2)
        if stepno != 7 or not torch.equal(got["w"], sh2["w"].local_slice(tree["w"])) \
                or not torch.equal(got["b"], sh2["b"].local_slice(tree["b"])):
            raise AssertionError(f"the tree restored at {shape} differs")
        _, (p2, o2, _) = step_mod.make_train_step(cfg, ParallelConfig(), mc2)
        tpl = step_mod.place_params(init_params(cfg, seed=1, device="cpu"), p2)
        sh_b = {"params": p2, "opt": o2}
        got, _ = restore_pytree({"params": dict(tpl.named_parameters()),
                                 "opt": step_mod.init_opt_state(tpl, o2, cfg)},
                                os.path.join(directory, "state"), shardings=sh_b)
        flat, fsh = _flatten(got), _flatten(sh_b)
        again = {k: C.gather_whole(v, fsh[k]) for k, v in flat.items()}
        if again.keys() != whole.keys() or not all(torch.equal(whole[k], again[k])
                                                   for k in whole):
            raise AssertionError(f"the train state restored at {shape} differs")
        out["x".join(map(str, shape))] = len(again)
    return out


# --------------------------------------------------------------------------
# slice 14: the SP merge, the long-context decode, collectives for the dry run
# --------------------------------------------------------------------------
def check_sp_decode(args):
    """``collectives.decode_attention_sp`` with the cache's S split over the
    4 ranks, on the reference check's inputs (``args["sp_shape"]`` b, hq,
    hkv, s, d, from ``np.random.default_rng(1)``), at each of
    ``args["sp_lengths"]`` (null: every position): every rank's merged
    output, the same on every rank, reported for the test to hold against
    JAX's whole-cache ``ref.decode_attention``."""
    make_mesh((4,), ("model",), device="cpu")
    b, hq, hkv, s, d = args["sp_shape"]
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(b, hq, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, hkv, s, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, hkv, s, d)).astype(np.float32))
    part = s // dist.get_world_size()
    mine = slice(rank() * part, (rank() + 1) * part)
    out = {}
    for lengths in args["sp_lengths"]:
        length = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
        got = C.decode_attention_sp(q, k[:, :, mine].contiguous(), v[:, :, mine].contiguous(),
                                    length, None)
        every = [torch.empty_like(got) for _ in range(4)]
        dist.all_gather(every, got)
        if not all(torch.equal(every[0], e) for e in every) or not torch.isfinite(got).all():
            raise AssertionError(f"lengths {lengths}: the ranks merged differently")
        out[json.dumps(lengths)] = got.tolist()
    return out


def _random_cache(cfg, batch: int, max_seq: int, seed: int) -> dict:
    """A whole decode cache filled with seeded random values (numpy)."""
    from repro_torch.distributed.partition import tree_map
    rng = np.random.default_rng(seed)
    return tree_map(lambda t: torch.from_numpy(rng.normal(size=tuple(t.shape)).astype(
        np.float32)).to(t.dtype), init_cache(cfg, batch, max_seq, device="cpu"))


def check_long_decode(args):
    """``make_decode_step(..., long_context=True)`` at 2x2 with a batch of
    1 (replicated over ``data``) for reduced zamba2 and xlstm: 4 steps at
    the last positions of a cache of 2048 filled with seeded random
    values, each rank on its shards, against one process's ``decode_step``
    on the whole cache.  Reports each model's largest logit difference over
    the largest logit; raises above 1e-5 (the tests hold it closer)."""
    from repro_torch.distributed.partition import tree_map
    mc = mesh((2, 2), ("data", "model"))
    max_seq = 2048
    out = {}
    for arch in ("zamba2_1_2b", "xlstm_1_3b"):
        cfg = reduced(get_config(arch))
        whole = _random_cache(cfg, 1, max_seq, 3)
        serve, (psh, cache_sh, tok_sh) = step_mod.make_decode_step(
            cfg, ParallelConfig(), mc, 1, max_seq, long_context=True)
        if tok_sh.spec != (None,):
            raise AssertionError(f"a batch of 1 is not replicated: {tok_sh.spec}")
        local = tree_map(lambda t, sh: sh.local_slice(t).clone(), whole, cache_sh)
        one = init_params(cfg, seed=0, device="cpu")
        model = step_mod.place_params(init_params(cfg, seed=0, device="cpu"), psh)
        toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (4,))
        err = 0.0
        for i, t in enumerate(range(max_seq - 4, max_seq)):
            tok = torch.tensor([toks[i]], dtype=torch.int32)
            pos = torch.tensor([t], dtype=torch.int32)
            want = decode_step(one, whole, tok, pos)[0]
            got = serve(model, local, tok, pos)[0]
            wl = logical_slice(mc, want)
            err = max(err, logits_err(got, wl, real_scale(want)))
        if not err <= 1e-5:
            raise AssertionError(f"{arch}: the long-context decode at 2x2 is off by {err}")
        out[arch] = err
    return out


def logical_slice(mc, logits):
    """This rank's shard of whole (B, Vpad) logits, as the decode step's
    ``("batch", "vocab")`` output is laid out (a batch the batch shards do
    not divide replicated)."""
    from repro_torch.distributed.partition import logical_to_sharding
    return logical_to_sharding(("batch", "vocab"), mc, tuple(logits.shape)).local_slice(logits)


def check_collectives(args):
    """The collectives rank 0 issues, by kind (calls, bytes), in one
    sharded train step and prefill of ``args["dryrun_train"]`` (batch, seq)
    and one decode step at ``args["dryrun_decode"]`` (batch, max_seq) of
    each reduced family at 2x2, under the base rules and (under ``"sp"``)
    the sp rules: what the dry run of the same cells must count."""
    out = {}
    for arch in ("smollm_360m", "granite_moe_1b", "zamba2_1_2b", "xlstm_1_3b"):
        out[arch] = _collectives(arch, mesh((2, 2), ("data", "model")), args)
        out[arch]["sp"] = _collectives(arch, mesh((2, 2), ("data", "model"),
                                                  {"seq": ["model"]}), args)
    return out


def _collectives(arch, mc, args):
    """``check_collectives``' counts of one family over ``mc``."""
    cfg = reduced(get_config(arch))
    b, s = args["dryrun_train"]
    batch_np = SyntheticLM(cfg, ShapeConfig("t", s, b, "train"), seed=1).batch_at(0)
    step, (psh, osh, bsh) = step_mod.make_train_step(cfg, ParallelConfig(), mc)
    model = step_mod.place_params(init_params(cfg, seed=0, device="cpu"), psh)
    opt = step_mod.init_opt_state(model, osh, cfg)
    with C.count_collectives() as train:
        step(model, opt, make_device_batch(batch_np, bsh))
    prefill, (psh, bsh) = step_mod.make_prefill_step(cfg, ParallelConfig(), mc)
    model = step_mod.place_params(init_params(cfg, seed=0, device="cpu"), psh)
    with C.count_collectives() as pre:
        prefill(model, make_device_batch(batch_np, bsh))
    b, max_seq = args["dryrun_decode"]
    serve, (psh, cache_sh, tok_sh) = step_mod.make_decode_step(cfg, ParallelConfig(), mc,
                                                               b, max_seq)
    model = step_mod.place_params(init_params(cfg, seed=0, device="cpu"), psh)
    cache = step_mod.init_sharded_cache(cfg, b, max_seq, cache_sh)
    tok = tok_sh.local_slice(torch.zeros(b, dtype=torch.int32))
    with C.count_collectives() as dec:
        serve(model, cache, tok, tok)
    return {"train": train, "prefill": pre, "decode": dec}


def main():
    """CHECKS: names joined by commas, run in order in one process group."""
    checks, args = sys.argv[1], json.loads(sys.argv[2]) if len(sys.argv) > 2 else {}
    for check in checks.split(","):
        out = globals()[f"check_{check}"](args)
        if rank() == 0:
            print(f"OK {check}")
            print(json.dumps({check: out}), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
