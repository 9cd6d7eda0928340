"""Training of the moe, hybrid and ssm families: the port against the JAX package, on the CPU.

The gradients of the two kernels these families reach, the grouped matmul
(granite_moe_1b) and the selective scan (zamba2_1_2b, xlstm_1_3b), and the
families' whole train steps, on the same numpy inputs and weights
(``from_jax_params``).  The reference trains on its pure-jnp path
(``use_pallas=False``) and lets ``jax.grad`` differentiate it; the port's
``GroupedMatmul`` and ``SsmScan`` take their plain versions on CPU tensors
(``ref.grouped_matmul_backward``, ``ref.ssm_scan_backward``), and
``ref.ssm_scan_backward_chunked`` (the plain mirror of the decomposition the
card runs: reverse chunk states, a reverse pass over the chunks, dX, dB and
dC per chunk, and the decay gradient from the per-step dots) is held here at
the kernels' chunk lengths, 64 and 128.

Tolerances: 1e-5 relative for losses, 1e-4 of each gradient's largest value
(f32 sums in another order: the chunked scan against the sequential one,
the scan's reverse recursion against XLA's); a bf16 output one bf16 ulp
(2^-8) of its largest value.  Reduced zamba2's gradients are held to 1e-2
of their largest value (``GRAD_TOL``): with these weights the model is
ill-conditioned in f32 on its own, so the two frameworks' roundings, a few
f32 ulps apart, move its gradients by up to 2.9e-3 (embed.tok).  Measured:
a relative change of 1e-7 (about one ulp) of every weight moves the JAX
package's own logits by 3.9e-5 and its gradients by 5.6e-4 of their largest
values (xlstm's logits by 8.5e-6), and the port's logits sit 1.7e-4 from
JAX's in the forward already (granite 9.2e-7, xlstm 3.1e-6).  A wrong
gradient formula moves a gradient by O(1) of its size.
"""
import dataclasses

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
from repro_torch.configs import get_config, reduced
from repro_torch.data import make_device_batch
from repro_torch.distributed import step as step_mod
from repro_torch.kernels import grouped_matmul as gmm_mod
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssm_scan as scan_mod
from repro_torch.models import loss_fn
from repro_torch.models.convert import from_jax_params
from repro_torch.models.model import num_blocks
from repro_torch.optim import adamw_init

GRAD_REL = 1e-4
LOSS_RTOL = 1e-5
BF16_REL = 2 ** -8
ARCHS = ["granite_moe_1b", "zamba2_1_2b", "xlstm_1_3b"]
# each family's gradients against JAX's, relative to their largest value (the
# module docstring says why zamba2's is wider)
GRAD_TOL = {"granite_moe_1b": GRAD_REL, "zamba2_1_2b": 1e-2, "xlstm_1_3b": GRAD_REL}


def _close_of_max(got, want, rel, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (name, err, np.abs(want).max())


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# --------------------------------------------------------------------------
# the grouped matmul's gradient
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,cap,d,f", [(3, 8, 16, 24), (2, 40, 32, 8)],
                         ids=["cap8", "cap40"])
def test_grouped_matmul_gradient_matches_autograd_and_jax(e, cap, d, f, dtype):
    """``GroupedMatmul`` (through ``ops.grouped_matmul`` under autograd) and
    ``ref.grouped_matmul_backward`` against autograd of ``ref.grouped_matmul``
    and ``jax.grad`` of the JAX package's, at decode's cap 8 and a cap that
    is no multiple of 128 (which the Pallas kernel refuses); no launch is
    counted on the CPU.  dy is rounded to the dtype first, as both
    frameworks' casts round the cotangent of a bf16 output."""
    rng = np.random.default_rng(cap + d)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((e, cap, d)).astype(np.float32)).to(dt)
    w = torch.from_numpy((rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)).to(dt)
    dy = torch.from_numpy(rng.standard_normal((e, cap, f)).astype(np.float32)).to(dt)
    jdt = getattr(jnp, dtype)
    want = jax.grad(lambda a, b: jnp.sum(jref.grouped_matmul(a, b).astype(jnp.float32)
                                         * jnp.asarray(_np(dy))), argnums=(0, 1))(
        jnp.asarray(_np(x)).astype(jdt), jnp.asarray(_np(w)).astype(jdt))
    leaves = [t.clone().requires_grad_(True) for t in (x, w)]
    tref.grouped_matmul(*leaves).backward(dy)
    auto = [t.grad for t in leaves]
    plain = tref.grouped_matmul_backward(x, w, dy)
    n0 = (gmm_mod.launches, gmm_mod.launches_bwd)
    leaves = [t.clone().requires_grad_(True) for t in (x, w)]
    out = ops.grouped_matmul(*leaves)
    torch.testing.assert_close(out, tref.grouped_matmul(x, w), rtol=0, atol=0)
    out.backward(dy)
    assert (gmm_mod.launches, gmm_mod.launches_bwd) == n0
    rel = BF16_REL if dtype == "bfloat16" else GRAD_REL
    for g, a, jw, leaf, name in zip(plain, auto, want, leaves, ("x", "w")):
        assert g.dtype == dt and leaf.grad.dtype == dt
        assert torch.equal(leaf.grad, g), name
        _close_of_max(_np(g), _np(a), rel, name)
        _close_of_max(_np(g), np.asarray(jw, np.float32), rel, name)


@pytest.mark.parametrize("capacity_factor", [1.25, 4.0], ids=["dropping", "dropless"])
def test_moe_apply_with_row_counts_is_bit_equal_to_dense(monkeypatch, capacity_factor):
    """``moe_apply`` passes each expert's filled rows to its three grouped
    matmuls; its output, aux loss and every gradient are the bits it gives
    when the grouped matmuls compute every row (the empty rows were zeros
    before and are zeros now), with experts at capacity and below it
    (1.25) and dropless (4.0)."""
    from repro_torch.models import moe as moe_mod
    cfg = dataclasses.replace(reduced(get_config("granite_moe_1b")), d_model=64, d_ff=32,
                              capacity_factor=capacity_factor)
    p = moe_mod.MoE(cfg, "cpu")
    p.reset_parameters(torch.Generator().manual_seed(5))
    params = [t.requires_grad_(True) for t in p.parameters()]
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 24, cfg.d_model, generator=g)
    # a direction every token shares crowds two experts past capacity at 1.25
    x = (x + torch.randn(cfg.d_model, generator=g)).requires_grad_(True)
    dy = torch.randn(2, 24, cfg.d_model, generator=g)
    seen = []
    dense = ops.grouped_matmul

    def run():
        out, aux = moe_mod.moe_apply(p, x, cfg)
        return [out, aux, *torch.autograd.grad((out * dy).sum() + aux, [x, *params])]

    def recording(a, b, rows=None, **kw):
        seen.append(rows)
        return dense(a, b, rows, **kw)

    def without_rows(a, b, rows=None, **kw):
        return dense(a, b, **kw)
    monkeypatch.setattr(ops, "grouped_matmul", recording)
    with_rows = run()
    monkeypatch.setattr(ops, "grouped_matmul", without_rows)
    without = run()
    cap = moe_mod.capacity(2 * 24, cfg)
    assert len(seen) == 3 and all(r is seen[0] for r in seen)
    assert seen[0].dtype == torch.int32 and int(seen[0].min()) < cap      # rows skipped
    if capacity_factor == 1.25:
        assert int(seen[0].max()) == cap                                  # experts at capacity
    else:
        assert int(seen[0].sum()) == 2 * 24 * cfg.experts_per_token       # every pair kept
    for a, b in zip(with_rows, without):
        assert torch.equal(a, b)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 4.0])
def test_moe_row_counts_follow_the_routes(monkeypatch, capacity_factor):
    """The row counts ``moe_apply`` gives its grouped matmuls are each
    expert's kept pairs, min(count, cap), from the route's expert ids, at
    capacities that drop most pairs, some, and none."""
    from repro_torch.models import moe as moe_mod
    cfg = dataclasses.replace(reduced(get_config("granite_moe_1b")), d_model=64, d_ff=32,
                              capacity_factor=capacity_factor)
    p = moe_mod.MoE(cfg, "cpu")
    p.reset_parameters(torch.Generator().manual_seed(7))
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(8))
    ids, seen = [], []
    route, dense = moe_mod.route, ops.grouped_matmul

    def routing(*a):
        out = route(*a)
        ids.append(out[2])
        return out

    def recording(a, b, rows=None, **kw):
        seen.append(rows)
        return dense(a, b, rows, **kw)
    monkeypatch.setattr(moe_mod, "route", routing)
    monkeypatch.setattr(ops, "grouped_matmul", recording)
    moe_mod.moe_apply(p, x, cfg)
    cap = moe_mod.capacity(2 * 40, cfg)
    want = torch.bincount(ids[0].reshape(-1), minlength=cfg.num_experts).clamp(max=cap)
    assert len(ids) == 1 and len(seen) == 3
    for rows in seen:
        assert rows.dtype == torch.int32 and torch.equal(rows.long(), want)


def test_grouped_matmul_backward_skips_what_is_not_asked():
    x, w, dy = torch.randn(2, 8, 4), torch.randn(2, 4, 6), torch.randn(2, 8, 6)
    dx, dw = gmm_mod.grouped_matmul_backward(x, w, dy, needs=(False, True))
    assert dx is None and torch.equal(dw, tref.grouped_matmul_backward(x, w, dy)[1])
    leaf = w.clone().requires_grad_(True)
    ops.grouped_matmul(x, leaf).backward(dy)           # x needs no gradient
    assert torch.equal(leaf.grad, dw)


# --------------------------------------------------------------------------
# the scan's gradient
# --------------------------------------------------------------------------
# (B, S, H, P, N, x dtype, b/c broadcast over the heads, a's special values,
# dh_final): small widths; no S is a multiple of the kernels' chunks (64,
# 128): 70 and 130 leave a tail at both, 200 and 300 cross chunk
# boundaries at both; P 1 is the mLSTM normaliser's
SCAN_CASES = {
    "f32": (2, 70, 3, 8, 4, "float32", False, False, False),
    "bf16-x": (2, 70, 3, 8, 4, "bfloat16", False, False, False),
    "broadcast-bc": (2, 70, 3, 8, 4, "float32", True, False, False),
    "P1": (2, 70, 3, 1, 16, "float32", False, False, False),
    "S200": (1, 200, 2, 8, 8, "float32", False, False, False),
    "a-0-1e-30-1": (2, 70, 3, 8, 4, "float32", False, True, False),
    "dh-final": (2, 70, 3, 8, 4, "float32", False, False, True),
    "broadcast-bc-dh-final": (2, 200, 3, 8, 4, "float32", True, False, True),
    "S130": (1, 130, 2, 8, 8, "float32", False, False, False),
    "S300-bf16-x-broadcast-bc-dh-final": (1, 300, 2, 16, 8, "bfloat16", True, False, True),
}
SCAN_CHUNKS = (64, 128)


def _scan_case(case, seed):
    b, s, h, p, n, dtype, bc, special, tail = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = rng.uniform(0.5, 1.0, (b, s, h)).astype(np.float32)
    if special:                       # steps where the state is cut, nearly cut, kept
        a[:, 5], a[:, 33, 0], a[:, 34], a[:, 60] = 0.0, 1e-30, 1.0, 0.0
    hb = 1 if bc else h
    bm = (rng.standard_normal((b, s, hb, n)) * n ** -0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, hb, n)) * n ** -0.5).astype(np.float32)
    if bc:
        bm, cm = np.broadcast_to(bm, (b, s, h, n)), np.broadcast_to(cm, (b, s, h, n))
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dh = rng.standard_normal((b, h, n, p)).astype(np.float32) if tail else None
    dt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(dt)
    x, dy = _np(tx), _np(torch.from_numpy(dy).to(dt))    # what both frameworks see
    tb, tc = (torch.from_numpy(np.array(m[:, :, :hb])) for m in (bm, cm))
    if bc:
        tb, tc = tb.expand(b, s, h, n), tc.expand(b, s, h, n)
    targs = (tx, torch.from_numpy(a), tb, tc)
    return (x, a, np.ascontiguousarray(bm), np.ascontiguousarray(cm), dy, dh), targs, dt


@pytest.mark.parametrize("label", list(SCAN_CASES))
def test_scan_backward_matches_autograd_and_jax(label):
    """``ref.ssm_scan_backward_chunked`` at each of SCAN_CHUNKS (the plain
    mirror of the kernels' decomposition) and ``ref.ssm_scan_backward`` (the
    sequential reverse recursion) against ``jax.grad`` of
    ``repro.kernels.ref.ssm_scan`` and autograd of the port's
    ``ref.ssm_scan``, for L = <dy, y> + <dh_final, h_final>.  A broadcast b
    or c gets its per-head gradient (``expand`` sums it).  Where a < 1e-20
    (the forward kernel's floor: there y does not depend on a) the chunked
    da is 0 and the reference's sum(lambda_t h_{t-1}) is not; both agree
    there in a * da, which is what reaches a parameter through a = exp(..)
    or a sigmoid (zamba2, xlstm), and everywhere else in da itself.  The
    chunked gradients are held against the sequential ones too."""
    case = SCAN_CASES[label]
    (x, a, bm, cm, dy, dh), targs, dt = _scan_case(case, seed=len(label))
    bsz, s, h, p, n = case[:5]

    def jloss(x_, a_, b_, c_):
        y, hl = jref.ssm_scan(x_, a_, b_, c_)
        out = jnp.sum(y.astype(jnp.float32) * dy)
        return out + (jnp.sum(hl * dh) if dh is not None else 0.0)
    jdt = getattr(jnp, case[5])
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(jnp.asarray(x).astype(jdt), jnp.asarray(a),
                                                  jnp.asarray(bm), jnp.asarray(cm))
    want = [np.asarray(w, np.float32) for w in want]
    tdy = torch.from_numpy(dy).to(dt)
    tdh = torch.from_numpy(dh) if dh is not None else None
    leaves = [t.clone().requires_grad_(True) for t in targs]
    y, hl = tref.ssm_scan(*leaves)
    ((y.float() * tdy.float()).sum() + ((hl * tdh).sum() if dh is not None else 0)).backward()
    auto = [_np(t.grad) for t in leaves]
    seq = [_np(g) for g in tref.ssm_scan_backward(*targs, tdy, tdh)]
    cut = a < tref.A_FLOOR
    for i, name in enumerate("xabc"):
        rel = BF16_REL if (name == "x" and dt == torch.bfloat16) else GRAD_REL
        w = want[i]
        if name in "bc" and case[6]:       # JAX's leaf is the broadcast array itself
            w = np.broadcast_to(w, (bsz, s, h, n))
        _close_of_max(seq[i], auto[i], rel, f"sequential vs autograd {name}")
        _close_of_max(seq[i], w, rel, f"sequential vs jax {name}")
    for chunk in SCAN_CHUNKS:
        comp = tref.ssm_scan_backward_chunked(*targs, tdy, tdh, chunk=chunk)
        assert comp[0].dtype == dt and all(g.dtype == torch.float32 for g in comp[1:])
        comp = [_np(g) for g in comp]
        for i, name in enumerate("xabc"):
            rel = BF16_REL if (name == "x" and dt == torch.bfloat16) else GRAD_REL
            w, sq = want[i], seq[i]
            if name in "bc" and case[6]:
                w = np.broadcast_to(w, (bsz, s, h, n))
            what = f"chunked ({chunk})"
            if name == "a" and cut.any():
                assert np.all(comp[i][cut] == 0) and np.all(np.isfinite(comp[i]))
                _close_of_max(comp[i] * a, w * a, rel, f"{what} vs jax a * da")
                _close_of_max(comp[i] * a, sq * a, rel, f"{what} vs sequential a * da")
                _close_of_max(np.where(cut, 0, comp[i]), np.where(cut, 0, w), rel,
                              f"{what} vs jax da where a >= 1e-20")
            else:
                _close_of_max(comp[i], w, rel, f"{what} vs jax {name}")
                _close_of_max(comp[i], sq, rel, f"{what} vs sequential {name}")


def test_scan_function_takes_only_the_asked_gradients(monkeypatch):
    """``ops.ssm_scan`` under autograd goes through ``SsmScan`` with no
    launch on the CPU; its gradients equal ``ref.ssm_scan_backward``'s bit
    for bit; the mLSTM normaliser's x = 1 needs no gradient and gets none,
    and the plain mirror of the kernels' backward,
    ``ref.ssm_scan_backward_chunked``, computes no dx when not asked (its da
    does not need one)."""
    (_, _, _, _, dy, _), (x, a, bm, cm), _ = _scan_case(SCAN_CASES["P1"], seed=3)
    tdy = torch.from_numpy(dy)
    n0 = (scan_mod.launches, scan_mod.launches_bwd, scan_mod.launches_da)
    leaves = [t.clone().requires_grad_(True) for t in (a, bm, cm)]
    y, _ = ops.ssm_scan(x, *leaves)
    y.backward(tdy)
    assert (scan_mod.launches, scan_mod.launches_bwd, scan_mod.launches_da) == n0
    _, da, db, dc = tref.ssm_scan_backward(x, a, bm, cm, tdy)
    for leaf, want in zip(leaves, (da, db, dc)):
        assert torch.equal(leaf.grad, want)
    calls = []

    def counting_dx(*args):
        calls.append(args[0].shape)
        return chunk_dx(*args)
    chunk_dx = tref._scan_chunk_dx
    monkeypatch.setattr(tref, "_scan_chunk_dx", counting_dx)
    chunk = scan_mod.pom_tile(x, bm, cm)["chunk"]
    got = tref.ssm_scan_backward_chunked(x, a, bm, cm, tdy, chunk=chunk,
                                         needs=(False, True, True, True))
    assert got[0] is None and len(calls) == 0          # da, db and dc; no dx
    _close_of_max(_np(got[1]), _np(da), GRAD_REL)
    got = tref.ssm_scan_backward_chunked(x, a, bm, cm, tdy, chunk=chunk,
                                         needs=(True, False, False, False))
    assert got[1:] == (None, None, None) and len(calls) == 1
    _close_of_max(_np(got[0]), _np(tref.ssm_scan_backward(x, a, bm, cm, tdy)[0]), GRAD_REL)


def test_scan_da_plain_is_the_reverse_sum():
    """``ref.ssm_scan_da`` by its definition, with a bias and the floor, on
    random inputs, and the sum kernel's wrapper ``ssm_scan.da_sum`` (on the
    CPU its plain version) on the same dots and bias cut into parts."""
    rng = np.random.default_rng(0)
    c, dc, b, db = (torch.from_numpy(rng.standard_normal((2, 9, 3, 5)).astype(np.float32))
                    for _ in range(4))
    a = torch.from_numpy(rng.uniform(0.1, 1, (2, 9, 3)).astype(np.float32))
    a[0, 4, 1] = 1e-25
    bias = torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32))
    got = tref.ssm_scan_da(c, dc, b, db, a, bias).numpy()
    g = (c.double() * dc.double()).sum(-1) - (b.double() * db.double()).sum(-1)
    want = np.zeros((2, 9, 3))
    for t in range(9):
        want[:, t] = (g[:, t:].sum(1) + bias.double()).numpy() / a[:, t].double().numpy()
    want[0, 4, 1] = 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the dots in two parts a step (N 2 + 3), the bias in three parts
    parts = [(c[..., i:j].double() * dc[..., i:j].double()).sum(-1)
             - (b[..., i:j].double() * db[..., i:j].double()).sum(-1) for i, j in ((0, 2), (2, 5))]
    gp = torch.stack(parts, -1).transpose(1, 2).float().contiguous()      # (B, H, S, 2)
    bp = torch.stack([bias * 0.25, bias * 0.5, bias * 0.25], -1)           # (B, H, 3)
    gsum = gp.double().sum(-1).transpose(1, 2).numpy()                     # (B, S, H)
    want = np.zeros((2, 9, 3))
    for t in range(9):
        want[:, t] = (gsum[:, t:].sum(1) + bp.double().sum(-1).numpy()) / a[:, t].double().numpy()
    want[0, 4, 1] = 0.0
    np.testing.assert_allclose(scan_mod.da_sum(gp, a, bp).numpy(), want, rtol=1e-6)


# --------------------------------------------------------------------------
# the families' loss, gradients and train step
# --------------------------------------------------------------------------
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
    for name, arr in out.items():
        if name.startswith("blocks."):
            for i in range(num_blocks(cfg)):
                flat[f"blocks.{i}.{name[len('blocks.'):]}"] = arr[i]
        else:
            flat[name] = arr
    return flat


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """(JAX config, JAX params, port config, a numpy batch of 2 x 64) of a
    reduced ``arch`` in f32 (4 layers, d_model 128; granite 4 experts top-2,
    zamba2 a shared-attention site every 2 blocks, xlstm an sLSTM every 2)."""
    arch = request.param
    jcfg, tcfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jparams = jinit_params(jax.random.key(11), jcfg)
    batch = JSyntheticLM(jcfg, JShapeConfig("t", 64, 2, "train"), seed=5).batch_at(7)
    return jcfg, jparams, tcfg, batch


def _model(jparams, cfg):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")


def _port_loss_and_grads(model, batch):
    model.requires_grad_(True)
    total, metrics = loss_fn(model, make_device_batch(batch, "cpu"))
    total.backward()
    # a parameter the loss does not reach (an sLSTM of a block without one)
    # has no gradient: JAX's is 0
    grads = {n: p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return total, metrics, grads


def test_family_loss_and_gradients_match_jax(family):
    """``loss_fn`` (with granite's 0.01 x aux) and every parameter's gradient
    against ``jax.value_and_grad(repro.models.loss_fn)``; no kernel launch
    on the CPU."""
    jcfg, jparams, tcfg, batch = family
    (jtotal, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    counts = (gmm_mod.launches, gmm_mod.launches_bwd, scan_mod.launches,
              scan_mod.launches_bwd, scan_mod.launches_da)
    total, metrics, grads = _port_loss_and_grads(_model(jparams, tcfg), batch)
    assert counts == (gmm_mod.launches, gmm_mod.launches_bwd, scan_mod.launches,
                      scan_mod.launches_bwd, scan_mod.launches_da)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=LOSS_RTOL)
    for k in ("loss", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=LOSS_RTOL,
                                   atol=1e-12)
    assert (float(metrics["aux"]) > 0) == (tcfg.family == "moe")
    want = _port_names(jgrads, tcfg)
    assert sorted(want) == sorted(grads)
    for n, g in grads.items():
        assert torch.isfinite(g).all(), n
        _close_of_max(g.numpy(), want[n], GRAD_TOL[tcfg.name], n)


def test_family_train_step_matches_jax(family):
    """One ``make_train_step`` step against the reference's jitted step on
    mesh 1x1: loss, grad norm and lr agree, and so do the new parameters
    where the first AdamW step's quotient g / |g| is well conditioned (the
    bound of ``test_torch_train.test_train_step_matches_jax``: where |g| is
    at least 10 x the family's gradient tolerance of its tensor's largest,
    or exactly 0)."""
    from repro.distributed import step as jstep_mod
    from repro.distributed.sharding import current, use_mesh
    from repro.launch.mesh import make_mesh
    jcfg, jparams, tcfg, batch = family
    grads = _port_loss_and_grads(_model(jparams, tcfg), batch)[2]
    model = _model(jparams, tcfg)
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
    tol = GRAD_TOL[tcfg.name]
    for k in ("loss", "aux", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=GRAD_REL, atol=1e-12)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=tol)
    for n, p in model.named_parameters():
        assert p.grad is None
        g = grads[n].abs()
        sure = ((g >= 10 * tol * g.max()) | (g == 0)).numpy()
        diff = np.abs(p.detach().numpy() - jnew[n])
        assert diff[sure].max() <= GRAD_REL * np.abs(jnew[n]).max(), n
        assert diff.max() <= 2 * 1e-3 + 1e-6, n


def test_family_remat_full_is_bit_equal_to_none(family):
    """Each block recomputed in the backward (``remat="full"``: the moe
    super-block with its routing, the hybrid block with its shared-attention
    site, the xLSTM block with its sLSTM) gives the loss and gradients of
    ``"none"``, bit for bit, on the CPU."""
    _, jparams, tcfg, batch = family
    runs = {}
    for remat in ("none", "full"):
        runs[remat] = _port_loss_and_grads(
            _model(jparams, dataclasses.replace(tcfg, remat=remat)), batch)
    assert torch.equal(runs["none"][0], runs["full"][0])
    for n, g in runs["none"][2].items():
        assert torch.equal(g, runs["full"][2][n]), n
