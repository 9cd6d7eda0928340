"""The port's training path against the JAX package's, on the CPU.

Reduced smollm_360m in f32 (4 layers, d_model 128, 4 query and 2 kv heads)
on the same weights (``from_jax_params``) and the same batches
(``SyntheticLM``, pure numpy in both).  JAX trains on its pure-jnp path, as
the reference does; the port's attention runs ``FlashAttention`` with its
plain versions (``ref.attention_lse``, ``ref.attention_backward``).
Tolerances: 1e-5 relative for losses and the schedule (f32 sums in another
order), 1e-4 of each gradient's largest value (f32 sums over the batch and
the sequence in another order; JAX's chunked attention against the port's
explicit formula).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import ParallelConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.data import SyntheticLM as JSyntheticLM
from repro.kernels import ref as jref
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine_schedule
from repro_torch.checkpoint import CheckpointManager, latest_step, restore_pytree, save_pytree
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticLM, make_device_batch
from repro_torch.distributed import step as step_mod
from repro_torch.distributed.ft import Heartbeat, check_workers, plan_remesh
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as train_mod
from repro_torch.models import forward, loss_fn
from repro_torch.models.convert import from_jax_params
from repro_torch.models.model import num_blocks
from repro_torch.optim import AdamWState, adamw_init, adamw_update, cosine_schedule

ROOT = Path(__file__).resolve().parent.parent
GRAD_REL = 1e-4
LOSS_RTOL = 1e-5


def _jax_cfg(**overrides):
    return jreduced(jget_config("smollm_360m"), num_kv_heads=2, **overrides)


def _port_cfg(**overrides):
    return reduced(get_config("smollm_360m"), num_kv_heads=2, **overrides)


def _model(jparams, cfg):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")


def _port_names(tree, cfg) -> dict:
    """The JAX tree's leaves under the port's parameter names (the stacked
    ``blocks`` leaves split along their leading axis)."""
    out = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = np.asarray(v)
    walk(tree, "")
    flat = {}
    for name, a in out.items():
        if name.startswith("blocks."):
            for i in range(num_blocks(cfg)):
                flat[f"blocks.{i}.{name[len('blocks.'):]}"] = a[i]
        else:
            flat[name] = a
    return flat


def _close_of_max(got, want, rel, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (name, err, np.abs(want).max())


@pytest.fixture(scope="module")
def setup():
    """(JAX cfg, JAX params, port cfg, a numpy batch of 2 x 64)."""
    jcfg, tcfg = _jax_cfg(), _port_cfg()
    jparams = jinit_params(jax.random.key(3), jcfg)
    batch = JSyntheticLM(jcfg, JShapeConfig("t", 64, 2, "train"), seed=5).batch_at(7)
    return jcfg, jparams, tcfg, batch


# --------------------------------------------------------------------------
# schedule, AdamW, data
# --------------------------------------------------------------------------
@pytest.mark.parametrize("warmup,total", [(20, 200), (0, 10), (5, 5), (100, 30)])
def test_cosine_schedule_matches_jax(warmup, total):
    for step in range(0, total + 10):
        want = float(jcosine_schedule(step, peak_lr=3e-3, warmup=warmup, total=total))
        got = cosine_schedule(step, peak_lr=3e-3, warmup=warmup, total=total)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL, atol=1e-12)
    t = cosine_schedule(torch.tensor(3, dtype=torch.int32), peak_lr=1.0, warmup=warmup,
                        total=total)
    np.testing.assert_allclose(float(t), float(jcosine_schedule(3, peak_lr=1.0, warmup=warmup,
                                                                total=total)), rtol=LOSS_RTOL)


def _random_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": ((7, 5), "float32"), "b": ((16,), "bfloat16"), "c": ((3, 4, 2), "bfloat16"),
              "d": ((9,), "float32")}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, (s, _) in shapes.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32) for n, (s, _) in shapes.items()}
             for _ in range(3)]
    return shapes, params, grads


def _as(a, dtype, lib):
    if lib == "jax":
        return jnp.asarray(a, getattr(jnp, dtype))
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clipping", "no-clipping"])
def test_adamw_update_matches_jax(max_norm):
    """Three steps on a tree of bf16 and f32 parameters with a bf16 first
    moment: parameters, both moments, the step and the grad norm agree
    within one bf16 ulp (2^-8 relative) or f32 1e-5."""
    shapes, params, grads = _random_tree(0)
    jp = {n: _as(params[n], dt, "jax") for n, (_, dt) in shapes.items()}
    tp = {n: _as(params[n], dt, "torch") for n, (_, dt) in shapes.items()}
    jst = jadamw_init(jp, "bfloat16")
    tst = adamw_init(tp, "bfloat16")
    assert all(m.dtype == torch.bfloat16 for m in tst.m.values())
    assert all(v.dtype == torch.float32 for v in tst.v.values())
    for i, g in enumerate(grads):
        jg = {n: _as(g[n], dt, "jax") for n, (_, dt) in shapes.items()}
        tg = {n: _as(g[n], dt, "torch") for n, (_, dt) in shapes.items()}
        lr = 1e-2 * (i + 1)
        jp, jst, jm = jadamw_update(jg, jst, jp, lr=lr, max_grad_norm=max_norm)
        tp, tst, tm = adamw_update(tg, tst, tp, lr=torch.tensor(lr), max_grad_norm=max_norm)
        assert int(tst.step) == int(jst.step) == i + 1
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=LOSS_RTOL)
        for n, (_, dt) in shapes.items():
            rt = 2 ** -8 if dt == "bfloat16" else 1e-5
            for got, want in ((tp[n], jp[n]), (tst.m[n], jst.m[n]), (tst.v[n], jst.v[n])):
                assert str(got.dtype).endswith(str(want.dtype))
                np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                           rtol=rt, atol=1e-7)
    if max_norm < 1:          # the grad norm was above the bound: clipping was active
        assert float(tm["grad_norm"]) > max_norm


@pytest.mark.parametrize("arch", ["smollm_360m", "musicgen_large"])
def test_synthetic_lm_batches_are_bit_equal(arch):
    """Pure numpy in both packages: the same batches bit for bit (tokens, or
    embeddings for a frontend config), and ``make_device_batch`` keeps them."""
    jcfg, tcfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    shape = (64, 3)
    jds = JSyntheticLM(jcfg, JShapeConfig("t", *shape, "train"), seed=2)
    tds = SyntheticLM(tcfg, ShapeConfig("t", *shape, "train"), seed=2)
    for step in (0, 1, 17):
        want, got = jds.batch_at(step), tds.batch_at(step)
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        dev = make_device_batch(got, "cpu")
        for k in want:
            assert np.array_equal(dev[k].numpy(), want[k]), k
    it = tds.iter_from(5)
    assert all(np.array_equal(next(it)["labels"], tds.batch_at(5 + i)["labels"])
               for i in range(3))


# --------------------------------------------------------------------------
# loss and gradients
# --------------------------------------------------------------------------
def _port_loss_and_grads(model, batch):
    model.requires_grad_(True)
    total, metrics = loss_fn(model, make_device_batch(batch, "cpu"))
    total.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return total, metrics, grads


def test_loss_and_gradients_match_jax(setup):
    """``loss_fn`` and every parameter's gradient against
    ``jax.value_and_grad(repro.models.loss_fn)``; the tied embedding collects
    gradient from the lookup and the unembedding; the padded vocabulary
    rows get none."""
    jcfg, jparams, tcfg, batch = setup
    (jtotal, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    model = _model(jparams, tcfg)
    total, metrics, grads = _port_loss_and_grads(model, batch)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=LOSS_RTOL)
    for k in ("loss", "aux", "ppl_log"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=LOSS_RTOL,
                                   atol=1e-12)
        assert metrics[k].dim() == 0 and not metrics[k].requires_grad
    want = _port_names(jgrads, tcfg)
    assert sorted(want) == sorted(grads)
    for n, g in grads.items():
        _close_of_max(g.numpy(), want[n], GRAD_REL, n)
    tok = grads["embed.tok"]
    assert tcfg.tie_embeddings and float(tok[tcfg.vocab_size:].abs().max()) == 0.0
    unseen = np.setdiff1d(np.arange(tcfg.vocab_size), batch["tokens"])
    assert float(tok[unseen].abs().max()) > 0        # from the unembedding alone


def test_loss_mask_and_aux_follow_the_reference(setup):
    """A mask that drops positions, as the reference weighs it."""
    jcfg, jparams, tcfg, batch = setup
    mask = (np.arange(batch["labels"].size).reshape(batch["labels"].shape) % 3 != 0)
    mb = dict(batch, mask=mask.astype(np.float32))
    jtotal, _ = jloss_fn(jparams, jcfg, {k: jnp.asarray(v) for k, v in mb.items()})
    with torch.no_grad():
        total, _ = loss_fn(_model(jparams, tcfg), make_device_batch(mb, "cpu"))
    np.testing.assert_allclose(float(total), float(jtotal), rtol=LOSS_RTOL)


def test_remat_full_is_bit_equal_to_none(setup):
    """``remat="full"`` (recompute each block in the backward) gives the same
    loss and gradients, bit for bit, as ``"none"`` on the CPU; "dots"
    raises."""
    jcfg, jparams, tcfg, batch = setup
    runs = {}
    for remat in ("none", "full"):
        model = _model(jparams, dataclasses.replace(tcfg, remat=remat))
        runs[remat] = _port_loss_and_grads(model, batch)
    assert torch.equal(runs["none"][0], runs["full"][0])
    for n, g in runs["none"][2].items():
        assert torch.equal(g, runs["full"][2][n]), n
    model = _model(jparams, dataclasses.replace(tcfg, remat="dots"))
    with pytest.raises(NotImplementedError, match="dots"):
        loss_fn(model, make_device_batch(batch, "cpu"))


def test_grad_mode_attention_runs_the_function_without_launches(setup):
    """Under autograd the model's attention goes through ``FlashAttention``
    (on the CPU its plain versions, so no launch is counted), and the
    forward's logits equal those of a no-grad forward bit for bit."""
    jcfg, jparams, tcfg, batch = setup
    model = _model(jparams, tcfg).requires_grad_(True)
    tokens = torch.from_numpy(batch["tokens"])
    n = (flash_mod.launches, flash_mod.launches_bwd)
    logits, _ = forward(model, tokens=tokens)
    assert logits.requires_grad
    logits.sum().backward()
    with torch.no_grad():
        plain, _ = forward(model, tokens=tokens)
    assert torch.equal(logits.detach(), plain)
    assert (flash_mod.launches, flash_mod.launches_bwd) == n


# --------------------------------------------------------------------------
# one whole train step
# --------------------------------------------------------------------------
def test_train_step_matches_jax(setup):
    """One ``make_train_step`` step against the reference's on mesh 1x1 (as
    ``tests/test_system.py`` builds it): loss, grad norm and lr agree, and
    so do the new parameters.  AdamW's first step moves a parameter by
    lr (g / (|g| + eps) + wd p): where |g| is at least 1e-3 of its tensor's
    largest (or exactly 0, as for the padded vocabulary rows), the quotient is
    sure and the two agree within 1e-4 of the largest parameter; where g is
    smaller the quotient is ill-conditioned (f32 sums
    in another order move it anywhere in [-1, 1]), so there they agree within
    its range, 2 lr."""
    from repro.distributed import step as jstep_mod
    from repro.distributed.sharding import current, use_mesh
    from repro.launch.mesh import make_mesh
    jcfg, jparams, tcfg, batch = setup
    grads = _port_loss_and_grads(_model(jparams, tcfg), batch)[2]
    model = _model(jparams, tcfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    mesh = make_mesh((1, 1), ("data", "model"))
    with use_mesh(mesh):
        jitted, _ = jstep_mod.make_train_step(jcfg, ParallelConfig(), current(), peak_lr=1e-3,
                                              warmup=0, total_steps=10)
        jp = jax.tree_util.tree_map(jnp.array, jparams)
        jp, jopt, jm = jitted(jp, jadamw_init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
        jnew = _port_names(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    step = step_mod.make_train_step(tcfg, model, peak_lr=1e-3, warmup=0, total_steps=10)
    opt = adamw_init(dict(model.named_parameters()))
    opt, tm = step(opt, make_device_batch(batch, "cpu"))
    assert int(opt.step) == int(jopt.step) == 1
    for k in ("loss", "grad_norm", "lr"):
        assert tm[k].dim() == 0
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=GRAD_REL)
    for n, p in model.named_parameters():
        assert p.grad is None
        assert not torch.equal(p.detach(), before[n]), n
        g = grads[n].abs()
        sure = ((g >= 1e-3 * g.max()) | (g == 0)).numpy()   # 0: the padded vocab rows
        assert sure.mean() > 0.95, n             # the check covers the bulk
        diff = np.abs(p.detach().numpy() - jnew[n])
        assert diff[sure].max() <= GRAD_REL * np.abs(jnew[n]).max(), n
        assert diff.max() <= 2 * 1e-3 + 1e-6, n


# --------------------------------------------------------------------------
# the attention backward formula
# --------------------------------------------------------------------------
# (B, Hq, Hkv, Sq, Skv, D, causal)
BWD_CASES = [(2, 4, 2, 16, 16, 32, True),     # GQA, causal
             (1, 8, 2, 12, 20, 32, True),     # Sq < Skv: aligned suffixes
             (2, 4, 1, 10, 14, 64, False),    # non-causal, group 4
             (1, 4, 4, 9, 9, 64, True)]       # group 1, D 64


def _bwd_inputs(case, seed):
    b, hq, hkv, sq, skv, d, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d), (b, hq, sq, d))]


@pytest.mark.parametrize("case", BWD_CASES)
def test_attention_backward_matches_autograd_and_jax(case):
    """``ref.attention_backward`` (the backward kernel's formula) against
    autograd through ``ref.attention`` and against ``jax.grad`` of
    ``repro.kernels.ref.attention``, on the same numpy inputs."""
    causal = case[-1]
    q, k, v, do = _bwd_inputs(case, seed=case[3])
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = tref.attention_lse(tq, tk, tv, causal=causal)
    assert torch.equal(o, tref.attention(tq, tk, tv, causal=causal))
    got = tref.attention_backward(tq, tk, tv, o, lse, tdo, causal=causal)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    tref.attention(*leaves, causal=causal).backward(tdo)
    want = jax.grad(lambda a, b_, c: jnp.sum(jref.attention(a, b_, c, causal=causal) * do),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, leaf, w, name in zip(got, leaves, want, "qkv"):
        _close_of_max(g.numpy(), leaf.grad.numpy(), GRAD_REL, name)
        _close_of_max(g.numpy(), np.asarray(w), GRAD_REL, name)
    # lse: log of the softmax's denominator
    s = np.einsum("bhqd,bhkd->bhqk", q, np.repeat(k, q.shape[1] // k.shape[1], axis=1))
    s = s / np.sqrt(q.shape[-1])
    if causal:
        sq, skv = q.shape[2], k.shape[2]
        s = np.where(np.arange(skv)[None] <= np.arange(sq)[:, None] + skv - sq, s, -np.inf)
    np.testing.assert_allclose(lse.numpy(), np.log(np.exp(s).sum(-1)), rtol=1e-5, atol=1e-5)


def test_attention_backward_row_without_keys_is_zero():
    """Sq > Skv, causal: the first Sq - Skv query rows see no key, their lse
    is -inf and their gradient 0 (no NaN), as autograd through the plain
    attention (which returns 0 there) gives; the rest still match autograd."""
    case = (1, 4, 2, 12, 5, 32, True)
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(case, seed=1))
    o, lse = tref.attention_lse(q, k, v, causal=True)
    assert torch.isinf(lse[:, :, :7]).all() and torch.isfinite(lse[:, :, 7:]).all()
    got = tref.attention_backward(q, k, v, o, lse, do, causal=True)
    assert all(torch.isfinite(g).all() for g in got)
    assert torch.all(got[0][:, :, :7] == 0)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tref.attention(*leaves, causal=True).backward(do)
    for g, leaf in zip(got, leaves):
        _close_of_max(g.numpy(), leaf.grad.numpy(), GRAD_REL)


def test_flash_function_on_the_cpu_uses_the_plain_backward():
    """``FlashAttention.apply`` and ``ops.attention`` under autograd on CPU
    tensors: the plain versions' gradients, bit for bit, and no launch."""
    case = (2, 4, 2, 16, 16, 32, True)
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(case, seed=2))
    o, lse = tref.attention_lse(q, k, v)
    want = tref.attention_backward(q, k, v, o, lse, do)
    n = (flash_mod.launches, flash_mod.launches_bwd)
    for run in (lambda *t: flash_mod.FlashAttention.apply(*t, True, None, None, None),
                lambda *t: ops.attention(*t, causal=True)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        run(*leaves).backward(do)
        for g, leaf in zip(want, leaves):
            assert torch.equal(g, leaf.grad)
    assert (flash_mod.launches, flash_mod.launches_bwd) == n
    with ops.plain_versions():            # differentiable through ref.attention
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ops.attention(*leaves).backward(do)
    for g, leaf in zip(want, leaves):
        _close_of_max(g.numpy(), leaf.grad.numpy(), GRAD_REL)


# --------------------------------------------------------------------------
# checkpoint, fault tolerance
# --------------------------------------------------------------------------
def _ckpt_tree():
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(5, 3, generator=g).bfloat16(), "b": torch.randn(4, generator=g)}
    opt = AdamWState(torch.tensor(7, dtype=torch.int32),
                     {n: torch.randn(p.shape, generator=g).bfloat16() for n, p in params.items()},
                     {n: torch.randn(p.shape, generator=g) for n, p in params.items()})
    return {"params": params, "opt": opt}


def _assert_tree_equal(got, want):
    assert isinstance(got["opt"], AdamWState)
    for a, b in ((got["params"], want["params"]), (got["opt"].m, want["opt"].m),
                 (got["opt"].v, want["opt"].v)):
        for n in b:
            assert a[n].dtype == b[n].dtype and torch.equal(a[n], b[n]), n
    assert torch.equal(got["opt"].step, want["opt"].step)


def test_checkpoint_round_trip_keeps_bf16(tmp_path):
    tree = _ckpt_tree()
    save_pytree(tree, str(tmp_path), step=3)
    assert latest_step(str(tmp_path)) == 3
    meta = json.loads((tmp_path / "step_3" / "meta.json").read_text())
    assert meta["dtypes"]["params/w"] == "bfloat16" and meta["dtypes"]["opt/step"] == "int32"
    got, step = restore_pytree(tree, str(tmp_path))
    assert step == 3
    _assert_tree_equal(got, tree)
    with np.load(tmp_path / "step_3" / "arrays.npz") as data:
        assert data["params/w"].dtype == np.uint16          # bf16 bits


def test_checkpoint_detects_corruption(tmp_path):
    tree = _ckpt_tree()
    save_pytree(tree, str(tmp_path), step=1)
    path = tmp_path / "step_1" / "arrays.npz"
    data = path.read_bytes()
    path.write_bytes(data[:-4] + b"dead")
    with pytest.raises(IOError, match="digest"):
        restore_pytree(tree, str(tmp_path))
    with pytest.raises(FileNotFoundError):
        restore_pytree(tree, str(tmp_path / "none"))


def test_checkpoint_manager_keeps_n_and_snapshots_at_save(tmp_path):
    """Async saves keep the newest ``keep``; what is written is the tree as
    it was when ``save`` returned, whatever happens to it afterwards."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _ckpt_tree()
    saved = {n: t.clone() for n, t in tree["params"].items()}
    mgr.save(tree, 1)
    for t in tree["params"].values():          # an optimiser step right after save
        t.add_(1.0)
    mgr.save(tree, 2)
    mgr.wait()
    got, step = mgr.restore(tree, step=1)
    assert step == 1
    for n, t in got["params"].items():
        assert torch.equal(t, saved[n]), n
    got, step = mgr.restore(tree)
    assert step == 2
    _assert_tree_equal(got, tree)
    mgr.save(tree, 3)
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_2", "step_3"]
    assert latest_step(str(tmp_path)) == 3


def test_heartbeat_straggler_detection(tmp_path):
    t0 = 1000.0
    for host in range(4):
        Heartbeat(str(tmp_path), host).beat(step=10, now=t0)
    Heartbeat(str(tmp_path), 3).beat(step=5, now=t0 - 40)
    statuses = {w.host: w.state for w in check_workers(str(tmp_path), dead_after_s=60, now=t0)}
    assert statuses[0] == "healthy" and statuses[3] == "straggler"
    statuses = {w.host: w.state for w in check_workers(str(tmp_path), dead_after_s=60,
                                                        now=t0 + 30)}
    assert statuses[3] == "dead" and statuses[0] == "healthy"
    assert check_workers(str(tmp_path / "none")) == []
    assert plan_remesh(64, 4, 16) == (16, 16)
    assert plan_remesh(60, 4, 16) == (8, 16)
    assert plan_remesh(3, 4, 16) is None


# --------------------------------------------------------------------------
# the entry point
# --------------------------------------------------------------------------
def _train_cli(workdir, steps):
    """``python -m repro_torch.launch.train --device cpu --reduced`` in a
    subprocess with one CPU thread (PyTorch's multithreaded CPU kernels
    differ from run to run in the last bit of f32 sums)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--reduced",
         "--steps", str(steps), "--batch", "2", "--seq", "32", "--log-every", "1",
         "--workdir", str(workdir)], capture_output=True, text=True, timeout=300, env=env,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr
    losses = {int(ln.split()[1]): ln.split()[3] for ln in out.stdout.splitlines()
              if ln.startswith("step ")}
    return out.stdout, losses


def test_train_cli_resume_equals_a_straight_run(tmp_path):
    """4 steps, then a resume to 6 in the same work dir, print the same
    losses as 6 steps straight; the checkpoints and result.json are where
    the reference puts them."""
    out4, first = _train_cli(tmp_path / "a", 4)
    out6, second = _train_cli(tmp_path / "a", 6)
    _, straight = _train_cli(tmp_path / "b", 6)
    assert "fresh start" in out4 and "resumed from step 4" in out6
    assert sorted(first) == [0, 1, 2, 3] and sorted(second) == [4, 5]
    assert {**first, **second} == straight
    assert latest_step(str(tmp_path / "a" / "ckpt")) == 6
    result = json.loads((tmp_path / "a" / "result.json").read_text())
    assert result["steps"] == 6 and f"{result['final_loss']:.4f}" == straight[5]
    assert (tmp_path / "a" / "hb" / "host_0.json").exists()


def test_train_loop_resumes_bit_for_bit(tmp_path):
    """The loop itself: a run stopped after its step-3 checkpoint and
    resumed ends with the same losses, parameters and moments, bit for bit,
    as a straight run (one CPU thread, as above)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = _port_cfg()
        kw = dict(steps=5, batch=2, seq=32, ckpt_every=3, device="cpu", log=lambda s: None)
        straight = train_mod.train(cfg, workdir=str(tmp_path / "a"), **kw)
        cut = train_mod.train(cfg, workdir=str(tmp_path / "b"), stop_after=3, **kw)
        assert cut.steps == 3 and latest_step(str(tmp_path / "b" / "ckpt")) == 3
        assert not (tmp_path / "b" / "result.json").exists()
        resumed = train_mod.train(cfg, workdir=str(tmp_path / "b"), **kw)
    finally:
        torch.set_num_threads(threads)
    assert resumed.start == 3
    assert cut.losses + resumed.losses == straight.losses
    for (n, p), q in zip(straight.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), n
    for n in straight.opt.m:
        assert torch.equal(straight.opt.m[n], resumed.opt.m[n])
        assert torch.equal(straight.opt.v[n], resumed.opt.v[n])


def test_train_main_defaults_and_refusals():
    args = train_mod.build_parser().parse_args([])
    assert (args.device, args.reduced, args.arch, args.batch, args.seq) == \
        ("cuda", False, "smollm_360m", 8, 256)
    with pytest.raises(NotImplementedError, match="1x1"):
        train_mod.main(["--device", "cpu", "--reduced", "--mesh", "2x1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_mod.main(["--reduced", "--steps", "1"])
