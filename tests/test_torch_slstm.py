"""The sLSTM recurrence of the port (``kernels/slstm.py``, ``csrc/slstm.cu``)
against the JAX package, on the CPU.

The reference runs the recurrence as a ``jax.lax.scan`` inside
``repro.models.xlstm.slstm_apply`` (``src/repro/models/xlstm.py:132-146``);
``_jax_slstm`` below is that scan with the same step, and
``test_slstm_apply_matches_jax`` holds the port's whole sLSTM block against
the reference's own ``slstm_apply``.  On CPU tensors the port's wrappers take
their plain versions: ``ref.slstm_scan`` (the loop the model ran before the
kernel) and ``ref.slstm_scan_backward`` (the reverse recursion the backward
kernel mirrors), so these tests hold what the card's kernels are held to.

Inputs are made with numpy from a seed, as a pass makes them: z = tanh and
the gates sigmoids of N(0, 1) pre-activations.  In ``below`` the input gate
is scaled by 0.1 and the forget gate by 0.5, so that n stays below 1 (the
clamp max(n, 1) is 1 throughout); in the others n starts below 1 and
crosses it, so both sides of the clamp are hit.

Tolerances: y within 1e-6 of its largest |value| (the same f32 operations;
XLA may fuse a multiply and an add), each gradient within 1e-5 of its
largest |value| (f32 sums over the hd lanes and over S in another order
than XLA's transposed scan and than autograd's).  A wrong term moves a
gradient by O(1) of its size.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import meta, ops, ref
from repro_torch.kernels import slstm as slstm_mod
from repro_torch.models import xlstm as txlstm

Y_REL = 1e-6
GRAD_REL = 1e-5
# (B, S, H, hd, gates): "real" sigmoids of N(0, 1); "below" the input gate
# x 0.1 and the forget gate x 0.5, so that n < 1 at every step
CASES = {"S1": (2, 1, 3, 32, "real"),
         "ragged": (2, 37, 3, 24, "real"),
         "reduced": (2, 64, 4, 32, "real"),
         "below": (2, 50, 2, 24, "below")}


def _inputs(case, seed):
    b, s, h, hd, kind = case
    rng = np.random.default_rng(seed)
    z = np.tanh(rng.standard_normal((b, s, h, hd))).astype(np.float32)
    i, f, o = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, h)))) for _ in range(3))
    if kind == "below":
        i, f = 0.1 * i, 0.5 * f
    return z, i.astype(np.float32), f.astype(np.float32), o.astype(np.float32)


def _states(z, i, f):
    """n_t of every step (numpy, f64)."""
    n = np.zeros(i.shape[::2], np.float64)
    out = []
    for t in range(z.shape[1]):
        n = f[:, t] * n + i[:, t]
        out.append(n)
    return np.stack(out, 1)


def _jax_slstm(z, i, f, o):
    """The reference's recurrence: ``slstm_apply``'s ``lax.scan`` over
    ``step`` (``src/repro/models/xlstm.py:132-146``)."""
    def step(carry, inp):
        c, n = carry
        zt, it, ft, ot = inp
        c = ft[..., None] * c + it[..., None] * zt
        n = ft * n + it
        y = ot[..., None] * c / jnp.maximum(n[..., None], 1.0)
        return (c, n), y

    b, s, h, hd = z.shape
    c0 = jnp.zeros((b, h, hd), jnp.float32)
    n0 = jnp.zeros((b, h), jnp.float32)
    _, ys = jax.lax.scan(step, (c0, n0), tuple(jnp.moveaxis(t, 1, 0) for t in (z, i, f, o)))
    return jnp.moveaxis(ys, 0, 1)


def _close_of_max(got, want, rel, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (name, err, np.abs(want).max())


@pytest.mark.parametrize("label", list(CASES))
def test_slstm_scan_matches_lax_scan(label):
    """``ref.slstm_scan`` (and ``ops.slstm_scan``, its kernel's wrapper, on
    the CPU) against the reference's ``lax.scan``; the clamp's sides as the
    case says."""
    z, i, f, o = _inputs(CASES[label], seed=len(label))
    n = _states(z, i, f)
    if CASES[label][4] == "below":
        assert n.max() < 1
    elif CASES[label][1] > 1:
        assert n.min() < 1 <= n.max()
    want = np.asarray(_jax_slstm(*(jnp.asarray(t) for t in (z, i, f, o))))
    tz, ti, tf, to = (torch.from_numpy(t) for t in (z, i, f, o))
    got = ref.slstm_scan(tz, ti, tf, to)
    assert got.dtype == torch.float32 and got.shape == tz.shape
    _close_of_max(got.numpy(), want, Y_REL, label)
    assert torch.equal(ops.slstm_scan(tz, ti, tf, to), got)
    assert ref.slstm_scan(tz.double(), ti.double(), tf.double(), to.double()).dtype == \
        torch.float64


@pytest.mark.parametrize("label", list(CASES))
def test_slstm_backward_matches_vjp_and_autograd(label):
    """``ref.slstm_scan_backward`` against ``jax.vjp`` of the reference's
    recurrence and against autograd of the plain loop, for L = <dy, y>."""
    z, i, f, o = _inputs(CASES[label], seed=10 + len(label))
    dy = np.random.default_rng(99).standard_normal(z.shape).astype(np.float32)
    _, vjp = jax.vjp(_jax_slstm, *(jnp.asarray(t) for t in (z, i, f, o)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(dy))]
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (z, i, f, o)]
    ref.slstm_scan(*leaves).backward(torch.from_numpy(dy))
    got = ref.slstm_scan_backward(*(t.detach() for t in leaves), torch.from_numpy(dy))
    for name, g, w, leaf in zip(("dz", "di", "df", "do"), got, want, leaves):
        assert g.dtype == torch.float32 and g.shape == leaf.shape
        _close_of_max(g.numpy(), w, GRAD_REL, f"{label} {name} vs jax")
        _close_of_max(g.numpy(), leaf.grad.numpy(), GRAD_REL, f"{label} {name} vs autograd")
    got64 = ref.slstm_scan_backward(*(t.detach().double() for t in leaves),
                                    torch.from_numpy(dy).double())
    assert all(g.dtype == torch.float64 for g in got64)


PASS_REL = 1e-6     # the decomposed backward against the reverse recursion: the same
                    # f32 operations but the lane sums in the kernels' order


def _lane_sum(x):
    """Sum over the last dim (hd) in the order of ``csrc/slstm.cu``'s
    backward: the products of each warp of 32 lanes added in lane order from
    0 (the chain pass), then the warps' sums in warp order from 0 (the rows
    pass)."""
    hd = x.shape[-1]
    warps = -(-hd // 32)
    lanes = torch.nn.functional.pad(x, (0, 32 * warps - hd)).reshape(*x.shape[:-1], warps, 32)
    part = torch.zeros(lanes.shape[:-1], dtype=x.dtype)
    for j in range(32):
        part = part + lanes[..., j]
    total = torch.zeros(x.shape[:-1], dtype=x.dtype)
    for w in range(warps):
        total = total + part[..., w]
    return total


def _passes_forward(z, i, f, o):
    """The forward as the kernels split it: the carry pass (c and n a step
    at a time, nothing else in the loop), then the readout over every (t,
    lane) at once.  Returns y, c, n."""
    b, s, h, hd = z.shape
    c = torch.zeros(b, h, hd)
    n = torch.zeros(b, h)
    cs, ns = [], []
    for t in range(s):
        c = f[:, t, :, None] * c + i[:, t, :, None] * z[:, t]
        n = f[:, t] * n + i[:, t]
        cs.append(c)
        ns.append(n)
    c, n = torch.stack(cs, 1), torch.stack(ns, 1)
    return o[..., None] * c / torch.clamp(n[..., None], min=1.0), c, n


def _passes_backward(z, i, f, o, dy, c, n):
    """The backward as the kernels split it, on the forward's c and n: the
    chain pass (dC a lane in reverse t, dz, and the lane sums of dC z, dC
    c_{t-1} and dy c), the rows pass (do and dN's direct term over every
    row), the dN pass (the scalar chain in reverse t, then di and df).
    Returns dz, di, df, do."""
    m = torch.clamp(n, min=1.0)
    s = z.shape[1]
    dcs = [None] * s                                              # chain
    dc = torch.zeros_like(z[:, 0])
    for t in range(s - 1, -1, -1):
        f1 = f[:, t + 1] if t + 1 < s else torch.zeros_like(n[:, 0])
        dc = dy[:, t] * o[:, t, :, None] / m[:, t, :, None] + f1[..., None] * dc
        dcs[t] = dc
    dc = torch.stack(dcs, 1)
    c_prev = torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], 1)
    s0, s1, s2 = _lane_sum(dc * z), _lane_sum(dc * c_prev), _lane_sum(dy * c)
    do = s2 / m                                                   # rows
    direct = torch.where(n >= 1, -(o * s2) / (m * m), torch.zeros_like(n))
    dns = [None] * s                                              # dN
    dn = torch.zeros_like(n[:, 0])
    for t in range(s - 1, -1, -1):
        f1 = f[:, t + 1] if t + 1 < s else torch.zeros_like(n[:, 0])
        dn = direct[:, t] + f1 * dn
        dns[t] = dn
    dn = torch.stack(dns, 1)
    n_prev = torch.cat([torch.zeros_like(n[:, :1]), n[:, :-1]], 1)
    return i[..., None] * dc, s0 + dn, s1 + dn * n_prev, do


@pytest.mark.parametrize("label", list(CASES))
def test_slstm_pass_decomposition_matches_the_plain_versions(label):
    """The kernels' order of operations written out in plain f32 on the CPU:
    the carry pass then the readout bit-equal to ``ref.slstm_scan``; the
    backward's chain, rows and dN passes within PASS_REL of each gradient's
    largest |value| of ``ref.slstm_scan_backward`` (the lane sums in another
    order), dz bit-equal (the chain keeps the recursion's order)."""
    z, i, f, o = (torch.from_numpy(t) for t in _inputs(CASES[label], seed=20 + len(label)))
    dy = torch.from_numpy(np.random.default_rng(21).standard_normal(z.shape).astype(np.float32))
    y, c, n = _passes_forward(z, i, f, o)
    assert y.dtype == torch.float32 and torch.equal(y, ref.slstm_scan(z, i, f, o)), label
    want = ref.slstm_scan_backward(z, i, f, o, dy)
    for name, g, w in zip(("dz", "di", "df", "do"), _passes_backward(z, i, f, o, dy, c, n), want):
        assert g.dtype == torch.float32 and g.shape == w.shape, (label, name)
        _close_of_max(g.numpy(), w.numpy(), PASS_REL, f"{label} {name}")
    assert torch.equal(_passes_backward(z, i, f, o, dy, c, n)[0], want[0]), label


def test_slstm_function_takes_only_the_asked_gradients():
    """``ops.slstm_scan`` under autograd goes through ``SlstmScan`` with no
    launch on the CPU: the same y as the plain loop, and only the gradients
    asked for, each equal to ``ref.slstm_scan_backward``'s bit for bit."""
    z, i, f, o = (torch.from_numpy(t) for t in _inputs(CASES["ragged"], seed=5))
    dy = torch.from_numpy(np.random.default_rng(6).standard_normal(z.shape).astype(np.float32))
    n0 = (slstm_mod.launches, slstm_mod.launches_bwd)
    zl, ol = z.clone().requires_grad_(True), o.clone().requires_grad_(True)
    y = ops.slstm_scan(zl, i, f, ol)
    assert y.grad_fn is not None and "SlstmScan" in type(y.grad_fn).__name__
    assert torch.equal(y, ref.slstm_scan(z, i, f, o))
    y.backward(dy)
    assert (slstm_mod.launches, slstm_mod.launches_bwd) == n0
    dz, _, _, do = ref.slstm_scan_backward(z, i, f, o, dy)
    assert torch.equal(zl.grad, dz) and torch.equal(ol.grad, do)
    assert i.grad is None and f.grad is None
    with ops.plain_versions():                 # the plain loop, under autograd
        assert ops.slstm_scan(zl, i, f, ol).grad_fn is not None
        assert "SlstmScan" not in type(ops.slstm_scan(zl, i, f, ol).grad_fn).__name__


def test_slstm_meta_branch_counts_its_work():
    """On ``meta`` tensors the wrapper launches nothing and returns the
    shapes the kernels write; the forward (saving c and n under autograd) and
    the backward add their bytes and operations to ``meta.counts``."""
    b, s, h, hd = 2, 40, 3, 16
    z = torch.empty(b, s, h, hd, device="meta")
    i, f, o = (torch.empty(b, s, h, device="meta") for _ in range(3))
    n0 = (slstm_mod.launches, slstm_mod.launches_bwd)
    meta.reset()
    try:
        y = ops.slstm_scan(z, i, f, o)
        assert y.device.type == "meta" and y.shape == z.shape and y.dtype == torch.float32
        lanes, heads = b * s * h * hd, b * s * h
        assert meta.counts["slstm_scan"] == [1, 5.0 * lanes + 2.0 * heads,
                                             4 * (2 * lanes + 3 * heads)]
        before = meta.totals()
        leaves = [t.requires_grad_(True) for t in (z, i, f, o)]
        y = ops.slstm_scan(*leaves)
        y.backward(torch.empty_like(y))
        assert [t.grad.shape for t in leaves] == [z.shape, i.shape, i.shape, i.shape]
        assert all(t.grad.device.type == "meta" for t in leaves)
        assert meta.counts["slstm_scan"][0] == 2
        assert meta.counts["slstm_scan"][2] == 4 * (2 * lanes + 3 * heads) \
            + 4 * (3 * lanes + 4 * heads)                # the second call saved c and n
        assert meta.counts["slstm_scan_bwd"] == [1, 11.0 * lanes + 12.0 * heads,
                                                 4 * (4 * lanes + 7 * heads)]
        after = meta.totals()
        assert after["bytes"] > before["bytes"] and after["flops"] > before["flops"]
        assert (slstm_mod.launches, slstm_mod.launches_bwd) == n0
    finally:
        meta.reset()


def test_slstm_wrapper_raises_on_what_the_kernels_do_not_take():
    """The kernels' wrappers raise where the kernels cannot run: a tensor
    that is not on the card, a bad shape, a dtype other than float32, a
    non-contiguous last dim, a head wider than the backward's block."""
    z, i, f, o = (torch.from_numpy(t) for t in _inputs(CASES["ragged"], seed=7))
    dy = torch.zeros_like(z)
    c, n = torch.zeros_like(z), torch.zeros_like(i)
    with pytest.raises(ValueError, match="unsupported device"):
        slstm_mod.scan_backward(z, i, f, o, dy, c, n)
    with pytest.raises(ValueError, match="bad shapes"):
        slstm_mod.scan_backward(z, i[:, :-1], f, o, dy, c, n)
    with pytest.raises(ValueError, match="bad shapes"):
        slstm_mod.scan_backward(z[0], i, f, o, dy, c, n)
    with pytest.raises(TypeError, match="float32"):
        slstm_mod.scan_backward(z.double(), i, f, o, dy, c, n)
    with pytest.raises(TypeError, match="float32"):
        slstm_mod.scan_backward(z, i, f.half(), o, dy, c, n)
    with pytest.raises(ValueError, match="contiguous"):
        zt = z.transpose(1, 3).contiguous().transpose(1, 3)
        slstm_mod.scan_backward(zt, i, f, o, dy, c, n)
    wide = torch.zeros(1, 2, 1, slstm_mod.MAX_LANES + 1)
    with pytest.raises(ValueError, match="head width"):
        slstm_mod.scan_backward(wide, *(torch.zeros(1, 2, 1) for _ in range(3)), wide, wide,
                                torch.zeros(1, 2, 1))


def test_slstm_apply_matches_jax():
    """The port's sLSTM block (``models/xlstm.py`` ``slstm_apply``, through
    ``ops.slstm_scan``) against the reference's (``lax.scan``) at the reduced
    config, on the same weights and input: the output within 1e-6 of its
    largest |value|, and the gradients of <dy, out> for x, wz, wg and wo
    within 1e-5 of each one's largest |value| (``SlstmScan``'s plain
    backward against ``jax.grad``)."""
    jcfg = jreduced(jget_config("xlstm_1_3b"))
    cfg = reduced(get_config("xlstm_1_3b"))
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(3)
    w = {"wz": rng.standard_normal((d, h * hd)) * d ** -0.5,
         "wg": rng.standard_normal((d, 3 * h)) * d ** -0.5,
         "wo": rng.standard_normal((h * hd, d)) * (h * hd) ** -0.5}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((2, 64, d)).astype(np.float32)
    dy = rng.standard_normal((2, 64, d)).astype(np.float32)

    def jloss(x_, p):
        return jnp.sum(jxlstm.slstm_apply(p, x_, jcfg) * dy)
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    want_y = np.asarray(jxlstm.slstm_apply(jp, jnp.asarray(x), jcfg))
    want_gx, want_gp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jp)

    block = txlstm.SLSTM(cfg, "cpu")
    with torch.no_grad():
        for k, v in w.items():
            getattr(block, k).copy_(torch.from_numpy(v))
    block.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = txlstm.slstm_apply(block, tx, cfg)
    _close_of_max(out.detach().numpy(), want_y, Y_REL, "out")
    (out * torch.from_numpy(dy)).sum().backward()
    _close_of_max(tx.grad.numpy(), np.asarray(want_gx), GRAD_REL, "dx")
    for k in w:
        _close_of_max(getattr(block, k).grad.numpy(), np.asarray(want_gp[k]), GRAD_REL, k)
