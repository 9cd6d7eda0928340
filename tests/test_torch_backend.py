"""The port's contraction lowering (``backend_cuda``) against the JAX
package's Pallas lowering (``backend_pallas``).

On the CPU ``lower_stmt_cuda(..., device="cpu")`` runs the contraction
kernel's plain PyTorch version; the reference runs its Pallas kernel in
interpret mode on the same numpy inputs (rtol/atol 1e-4 in f32, the
reference tests' own).  The acceptance tests hold the two matchers to the
same verdict on every statement of the thirteen serving workloads, under
three schedules.  The kernel's own checks on the card are in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from benchmarks import workloads as ref_workloads
from repro.core import caching as ref_caching
from repro.core import dsl as ref_pom
from repro.core import ir as ref_ir
from repro.core.backend_pallas import PallasLowerError, lower_stmt_pallas
from repro.core.dse import auto_dse as ref_auto_dse

from repro_torch import workloads as port_workloads
from repro_torch.core import caching as port_caching
from repro_torch.core import dsl as port_pom
from repro_torch.core import faultinject
from repro_torch.core.backend_cuda import (CudaLowerError, cuda_supported,
                                           lower_stmt_cuda)
from repro_torch.core.dse import auto_dse as port_auto_dse
from repro_torch.core.ir import p_bfloat16, p_int32

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _fresh_caches():
    ref_caching.clear_all()
    port_caching.clear_all()
    yield


def _sched_gemm(pom, n=32, ti=8, tj=8, tk=8, dtype=None):
    """The reference test's tiled gemm: tile (i, j), split k, intra-tile
    loops innermost and fully unrolled."""
    kw = {} if dtype is None else {"dtype": dtype}
    with pom.function("gemm") as f:
        i, j, k = pom.var("i", 0, n), pom.var("j", 0, n), pom.var("k", 0, n)
        A = pom.placeholder("A", (n, n), **kw)
        B = pom.placeholder("B", (n, n), **kw)
        C = pom.placeholder("C", (n, n), **kw)
        s = pom.compute("s", [i, j, k], A(i, j) + B(i, k) * C(k, j), A(i, j))
    s.tile("i", "j", ti, tj, "i0", "j0", "i1", "j1")
    s.split("k", tk, "k0", "k1")
    st = s.stmt
    st.domain = st.domain.permute(["i0", "j0", "k0", "i1", "j1", "k1"])
    s.unroll("i1", ti)
    s.unroll("j1", tj)
    s.unroll("k1", tk)
    s.pipeline("k0", 1)
    return f, s


def _matvec(pom, n=64, t=16):
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
    return f, s


def _gemm_inputs(n, seed):
    rng = np.random.default_rng(seed)
    return {"A": rng.normal(size=(n, n)).astype(np.float32),
            "B": rng.normal(size=(n, n)).astype(np.float32),
            "C": rng.normal(size=(n, n)).astype(np.float32)}


# --------------------------------------------------------------------------
# the cases of tests/test_backend_pallas.py, port vs Pallas interpret
# --------------------------------------------------------------------------
def test_gemm_matches_pallas():
    n = 32
    _, rs = _sched_gemm(ref_pom, n)
    _, ps = _sched_gemm(port_pom, n)
    arrs = _gemm_inputs(n, 0)
    want = np.asarray(lower_stmt_pallas(rs.stmt, interpret=True)(dict(arrs)))
    got = lower_stmt_cuda(ps.stmt, device="cpu")(dict(arrs))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), arrs["A"] + arrs["B"] @ arrs["C"], **TOL)


@pytest.mark.parametrize("n,t", [(16, 4), (64, 16), (128, 32)])
def test_gemm_shape_sweep_matches_pallas(n, t):
    _, rs = _sched_gemm(ref_pom, n, t, t, t)
    _, ps = _sched_gemm(port_pom, n, t, t, t)
    arrs = _gemm_inputs(n, n)
    arrs["A"] = np.zeros((n, n), np.float32)
    want = np.asarray(lower_stmt_pallas(rs.stmt, interpret=True)(dict(arrs)))
    got = lower_stmt_cuda(ps.stmt, device="cpu")(dict(arrs))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_matvec_matches_pallas():
    _, rs = _matvec(ref_pom)
    _, ps = _matvec(port_pom)
    rng = np.random.default_rng(1)
    arrs = {"A": rng.normal(size=(64, 64)).astype(np.float32),
            "p": rng.normal(size=(64,)).astype(np.float32),
            "q": np.zeros(64, np.float32)}
    want = np.asarray(lower_stmt_pallas(rs.stmt, interpret=True)(dict(arrs)))
    got = lower_stmt_cuda(ps.stmt, device="cpu")(dict(arrs))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_unsupported_pattern_raises():
    def build(pom):
        n = 8
        with pom.function("st"):
            i = pom.var("i", 1, n - 1)
            A = pom.placeholder("A", (n,))
            B = pom.placeholder("B", (n,))
            return pom.compute("s", [i], A(i - 1) + A(i + 1), B(i))
    with pytest.raises(PallasLowerError):
        lower_stmt_pallas(build(ref_pom).stmt)
    with pytest.raises(CudaLowerError):
        lower_stmt_cuda(build(port_pom).stmt, device="cpu")


def test_bf16_gemm_matches_pallas():
    """bf16 arrays: both sum in f32 and round once to bf16.  Tolerance: 1% of
    the largest |output| (bf16 keeps 8 significant bits, and the two sides
    round their f32 partial sums at different points)."""
    import jax.numpy as jnp
    n, t = 32, 8
    _, rs = _sched_gemm(ref_pom, n, t, t, t, dtype=ref_ir.p_bfloat16)
    _, ps = _sched_gemm(port_pom, n, t, t, t, dtype=p_bfloat16)
    arrs = _gemm_inputs(n, 3)
    want = np.asarray(lower_stmt_pallas(rs.stmt, interpret=True)(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in arrs.items()}), np.float32)
    got = lower_stmt_cuda(ps.stmt, device="cpu")(
        {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in arrs.items()})
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=1e-2 * scale)


def test_unsupported_dtype_raises_naming_it():
    with port_pom.function("g"):
        i, k = port_pom.var("i", 0, 8), port_pom.var("k", 0, 8)
        A = port_pom.placeholder("A", (8, 8), p_int32)
        x = port_pom.placeholder("x", (8,), p_int32)
        y = port_pom.placeholder("y", (8,), p_int32)
        s = port_pom.compute("s", [i, k], y(i) + A(i, k) * x(k), y(i))
    with pytest.raises(CudaLowerError, match="p_int32"):
        lower_stmt_cuda(s.stmt, device="cpu")


def test_batched_contraction_equals_lane_loop():
    """D, X, Y with a leading batch of 3 through one runner call equal three
    unbatched calls."""
    n, b = 16, 3
    _, ps = _sched_gemm(port_pom, n, 4, 4, 4)
    run = lower_stmt_cuda(ps.stmt, device="cpu")
    lanes = [_gemm_inputs(n, s) for s in range(b)]
    batched = {k: np.stack([ln[k] for ln in lanes]) for k in lanes[0]}
    got = run(batched)
    assert tuple(got.shape) == (b, n, n)
    for i, ln in enumerate(lanes):
        assert torch.equal(got[i], run(ln))


def test_injected_fault_raises_with_cause():
    _, ps = _sched_gemm(port_pom, 16, 4, 4, 4)
    run = lower_stmt_cuda(ps.stmt, device="cpu")
    with faultinject.injected("backend.lower", "error", max_fires=1):
        with pytest.raises(CudaLowerError) as ei:
            run(_gemm_inputs(16, 0))
    assert isinstance(ei.value.__cause__, RuntimeError)
    run(_gemm_inputs(16, 0))            # the runner itself stays usable


def test_runner_does_not_modify_inputs():
    _, ps = _sched_gemm(port_pom, 16, 4, 4, 4)
    arrs = {k: torch.from_numpy(v) for k, v in _gemm_inputs(16, 0).items()}
    before = arrs["A"].clone()
    lower_stmt_cuda(ps.stmt, device="cpu")(arrs)
    assert torch.equal(arrs["A"], before)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the default is exercised on it")
    _, ps = _sched_gemm(port_pom, 16, 4, 4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lower_stmt_cuda(ps.stmt)


# --------------------------------------------------------------------------
# acceptance parity: the port rejects exactly what the reference rejects
# --------------------------------------------------------------------------
def _ref_cases():
    w = ref_workloads
    n, m = 16, 12
    return {"gemm": lambda: w.gemm(n), "bicg": lambda: w.bicg(n),
            "gesummv": lambda: w.gesummv(n), "2mm": lambda: w.mm2(n),
            "3mm": lambda: w.mm3(n), "jacobi1d": lambda: w.jacobi1d(3 * n, 4),
            "jacobi2d": lambda: w.jacobi2d(m, 3), "heat1d": lambda: w.heat1d(3 * n, 4),
            "seidel": lambda: w.seidel(m, 3), "edge_detect": lambda: w.edge_detect(m),
            "gaussian": lambda: w.gaussian(m), "blur": lambda: w.blur(m),
            "conv": lambda: w.conv_nest("conv", 8, 4, 6, 6)}


NAMES = sorted(_ref_cases())


def _tile_schedule(stmt, t=4):
    """The reference test's gemm schedule generalised: split every dim whose
    trip count t divides (t < trip), intra-tile loops innermost and fully
    unrolled."""
    from repro.core import transforms as RT
    from repro_torch.core import transforms as PT
    T = PT if type(stmt).__module__.startswith("repro_torch") else RT
    outer, inner = [], []
    for d in list(stmt.dims):
        trip = stmt.trip_counts()[d]
        if trip > t and trip % t == 0:
            T.split(stmt, d, t, f"{d}_o", f"{d}_i", check=False)
            outer.append(f"{d}_o")
            inner.append(f"{d}_i")
        else:
            outer.append(d)
    stmt.domain = stmt.domain.permute(outer + inner)
    for d in inner:
        stmt.unrolls[d] = t


def _verdicts(ref_fn, port_fn):
    out = []
    for rs, ps in zip(ref_fn.statements, port_fn.statements):
        try:
            lower_stmt_pallas(rs, interpret=True)
            r = True
        except Exception as e:       # the reference raises more than one type
            r = type(e).__name__
        try:
            lower_stmt_cuda(ps, device="cpu")
            p = True
        except CudaLowerError:
            p = "CudaLowerError"
        out.append((rs.name, r is True, p is True, r, p))
    return out


@pytest.mark.parametrize("schedule", ["unscheduled", "tiled", "greedy_dse"])
@pytest.mark.parametrize("name", NAMES)
def test_acceptance_matches_reference(name, schedule):
    rf = _ref_cases()[name]().fn
    pf = dict(port_workloads.serving_cases(True))[name]().fn
    if schedule == "tiled":
        for s in list(rf.statements) + list(pf.statements):
            _tile_schedule(s)
    elif schedule == "greedy_dse":
        ref_auto_dse(rf, strategy="greedy")
        port_auto_dse(pf, strategy="greedy")
    verdicts = _verdicts(rf, pf)
    assert verdicts, name
    for sname, ref_ok, port_ok, r, p in verdicts:
        assert ref_ok == port_ok, f"{name}/{schedule}/{sname}: reference {r}, port {p}"


def test_acceptance_covers_both_verdicts():
    """The parity population holds accepted and rejected statements."""
    seen = set()
    for name in NAMES:
        for sched in ("unscheduled", "tiled"):
            rf = _ref_cases()[name]().fn
            pf = dict(port_workloads.serving_cases(True))[name]().fn
            if sched == "tiled":
                for s in list(rf.statements) + list(pf.statements):
                    _tile_schedule(s)
            seen |= {ok for _, ok, _, _, _ in _verdicts(rf, pf)}
    assert seen == {True, False}


# --------------------------------------------------------------------------
# the probe (the card's side is in tests/test_torch_cuda.py)
# --------------------------------------------------------------------------
def test_probe_is_false_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert cuda_supported() is False


# --------------------------------------------------------------------------
# the tiled kernel's GEMM view of a descriptor (checked here in PyTorch)
# --------------------------------------------------------------------------
def _gemm_by_tables(desc, view, x, y, init):
    """What the tiled kernel computes, written with its six offset tables."""
    from repro_torch.kernels.contraction import gemm_tables
    mx, mo, ny, no, kx, ky = gemm_tables(desc, view, x.device)
    xs = x.double()[mx[:, None] + kx[None, :]]           # (M, K)
    ys = y.double()[ny[:, None] + ky[None, :]]           # (N, K)
    out = init.double().clone()
    out[mo[:, None] + no[None, :]] += xs @ ys.T
    return out


GEMM_SHAPED = [
    ("gemm_tiled", lambda: _sched_gemm(port_pom, 128, 32, 32, 32)[1].stmt, True),
    ("gemm_unscheduled", lambda: port_workloads.gemm(160).fn.statements[0], True),
    ("2mm_s2", lambda: port_workloads.mm2(128).fn.statements[1], True),
    ("conv", lambda: port_workloads.conv_nest("conv", 128, 2, 12, 12).fn.statements[0], True),
    ("matvec", lambda: _matvec(port_pom, 64, 16)[1].stmt, False),
    ("gemm_small", lambda: port_workloads.gemm(16).fn.statements[0], False),
    # GEMM-shaped, but M and N do not fill one 128 x 128 tile
    ("gemm_below_tile", lambda: port_workloads.gemm(96).fn.statements[0], False),
]


@pytest.mark.parametrize("label,build,shaped", GEMM_SHAPED)
def test_gemm_view_tables_reproduce_the_statement(label, build, shaped):
    from repro_torch.kernels.contraction import gemm_view
    from repro_torch.kernels.ref import contraction as plain
    desc = lower_stmt_cuda(build(), device="cpu").desc
    view = gemm_view(desc)
    assert (view is not None) == shaped
    if view is None:
        return
    g = torch.Generator().manual_seed(0)
    x = torch.randn(desc.x_numel, generator=g, dtype=torch.float64)
    y = torch.randn(desc.y_numel, generator=g, dtype=torch.float64)
    o = torch.randn(desc.o_numel, generator=g, dtype=torch.float64)
    torch.testing.assert_close(_gemm_by_tables(desc, view, x, y, o), plain(desc, x, y, o))


# --------------------------------------------------------------------------
# the plain contraction (strided views + einsum) against a gathered sum
# --------------------------------------------------------------------------
def _gathered(desc, x, y, init):
    """The statement by index grids: one gather per operand over every
    (output, reduction) point, the products summed over the reduction."""
    from repro_torch.kernels.ref import offset_grid
    batch = init.numel() // desc.o_numel
    o_off = offset_grid(desc.out_trips, desc.out_o, desc.o0, "cpu")
    x_off = (offset_grid(desc.out_trips, desc.out_x, desc.x0, "cpu")[:, None]
             + offset_grid(desc.red_trips, desc.red_x, 0, "cpu")[None, :])
    y_off = (offset_grid(desc.out_trips, desc.out_y, desc.y0, "cpu")[:, None]
             + offset_grid(desc.red_trips, desc.red_y, 0, "cpu")[None, :])
    xg = x.reshape(x.numel() // desc.x_numel, -1)[:, x_off]
    yg = y.reshape(y.numel() // desc.y_numel, -1)[:, y_off]
    out = init.clone().reshape(batch, -1)
    out[:, o_off] += (xg * yg).sum(-1)
    return out.reshape(init.shape)


@pytest.mark.parametrize("seed", range(6))
def test_plain_contraction_matches_gathered_sum(seed):
    """Random descriptors: negative and zero coefficients, dims neither
    operand moves with, batched and shared lanes, in f64."""
    from repro_torch.kernels.contraction import ContractionDesc
    from repro_torch.kernels.ref import contraction as plain
    rng = np.random.default_rng(seed)
    for _ in range(20):
        ot = tuple(int(v) for v in rng.integers(1, 5, rng.integers(1, 4)))
        rt = tuple(int(v) for v in rng.integers(1, 5, rng.integers(0, 3)))
        oo, st = [], 1
        for t in reversed(ot):            # an injective store, random signs
            oo.append(st * int(rng.choice([-1, 1])))
            st *= t
        oo = tuple(reversed(oo))
        cx, cy = (tuple(int(v) for v in rng.integers(-3, 4, len(ot) + len(rt)))
                  for _ in range(2))

        def placed(trips, coefs):
            lo = sum(min(0, c * (t - 1)) for t, c in zip(trips, coefs))
            hi = sum(max(0, c * (t - 1)) for t, c in zip(trips, coefs))
            pad = int(rng.integers(0, 3))
            return pad - lo, hi - lo + 1 + pad + int(rng.integers(0, 3))

        (x0, xn), (y0, yn), (o0, on) = (placed(ot + rt, cx), placed(ot + rt, cy),
                                        placed(ot, oo))
        d = ContractionDesc(ot, cx[:len(ot)], cy[:len(ot)], oo, rt, cx[len(ot):],
                            cy[len(ot):], x0, y0, o0, xn, yn, on)
        b = int(rng.choice([1, 3]))
        x = torch.randn(int(rng.choice([1, b])) * xn, dtype=torch.float64)
        y = torch.randn(int(rng.choice([1, b])) * yn, dtype=torch.float64)
        o = torch.randn(b * on, dtype=torch.float64)
        torch.testing.assert_close(plain(d, x, y, o), _gathered(d, x, y, o),
                                   msg=lambda m: f"{d}: {m}")
