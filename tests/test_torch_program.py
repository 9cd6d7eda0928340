"""The port's CUDA serving path (``CudaProgram``) against the JAX package's
Pallas serving path (``PallasProgram``).

Counterparts of ``tests/test_pallas_serving.py``: the compile artifact and
calling it, the whole-program step (``jitted()``) on all thirteen
workloads against the numpy oracle and against the reference's
``jitted()``, ``batched(B)`` against sequential calls, the wrong-batch
error, the sequential fallback of an untraceable program, the compile
service's executor cache, the DSL ``runner()`` shortcut, runner-cache keys,
and scan-over-layers.  The port runs with ``device="cpu"`` (plain PyTorch
versions of the kernels); the reference in Pallas interpret mode.
"""
import numpy as np
import pytest
import torch

from benchmarks import workloads as ref_workloads
from repro.core import caching as ref_caching
from repro.core.pipeline import compile as ref_compile

from repro_torch import workloads
from repro_torch.core import caching
from repro_torch.core import dsl as pom
from repro_torch.core.astbuild import build_ast
from repro_torch.core.backend_cuda import CudaProgram, cuda_supported
from repro_torch.core.backend_jax import compile_jax
from repro_torch.core.errors import PomWarning
from repro_torch.core.loop_ir import ScanRegion, walk
from repro_torch.core.pipeline import compile as pcompile

CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh_caches():
    caching.clear_all()
    caching.reset_counts()
    ref_caching.clear_all()
    yield


CASES = {
    "gemm": (lambda w: w.gemm(24)), "bicg": (lambda w: w.bicg(24)),
    "gesummv": (lambda w: w.gesummv(24)), "2mm": (lambda w: w.mm2(16)),
    "3mm": (lambda w: w.mm3(16)), "jacobi1d": (lambda w: w.jacobi1d(48, 4)),
    "jacobi2d": (lambda w: w.jacobi2d(10, 3)), "heat1d": (lambda w: w.heat1d(48, 4)),
    "seidel": (lambda w: w.seidel(10, 3)), "edge_detect": (lambda w: w.edge_detect(14)),
    "gaussian": (lambda w: w.gaussian(14)), "blur": (lambda w: w.blur(14)),
    "conv": (lambda w: w.conv_nest("conv", 8, 4, 6, 6)),
}


def _inputs(fn, seed=0):
    rng = np.random.default_rng(seed)
    written = {s.store.array.name for s in fn.statements}
    return {p.name: rng.standard_normal(p.shape).astype(np.float32)
            for p in fn.placeholders.values() if p.name not in written}


def _outputs(fn):
    return {s.store.array.name for s in fn.statements}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --------------------------------------------------------------------------
# probe + artifact surface
# --------------------------------------------------------------------------
def test_probe_is_stable_and_bool():
    a, b = cuda_supported(), cuda_supported()
    assert isinstance(a, bool) and a == b
    if not torch.cuda.is_available():
        assert a is False


def test_artifact_is_program_and_legacy_callable():
    f = workloads.gemm(8)
    prog = pcompile(f.fn, target="cuda", device=CPU)
    assert isinstance(prog, CudaProgram)
    assert prog.mode == "cuda" and prog.device == torch.device("cpu")
    arrs = _inputs(f.fn)
    out = prog(dict(arrs))
    ref = compile_jax(f.fn, build_ast(f.fn))(dict(arrs))
    np.testing.assert_allclose(_np(out["C"]).astype(np.float64), ref["C"],
                               rtol=1e-5, atol=1e-5)


def test_unsupported_program_is_oracle_mode():
    f = workloads.gesummv(8)
    prog = pcompile(f.fn, target="cuda", device=CPU)
    assert prog.mode == "oracle"
    arrs = _inputs(f.fn)
    out = prog(dict(arrs))
    ref = compile_jax(f.fn, build_ast(f.fn))(dict(arrs))
    assert isinstance(out["y"], torch.Tensor)
    np.testing.assert_allclose(_np(out["y"]), ref["y"], rtol=1e-5, atol=1e-5)


def test_pallas_target_names_cuda():
    with pytest.raises(ValueError, match="'cuda'"):
        pcompile(workloads.gemm(8).fn, target="pallas")


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pcompile(workloads.gemm(8).fn, target="cuda")


# --------------------------------------------------------------------------
# the whole-program step: jitted() on all 13 workloads
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_jitted_matches_oracle_and_reference(name):
    f = CASES[name](workloads)
    prog = pcompile(f.fn, target="cuda", device=CPU)
    assert prog.traceable(), f"{name}: serving path fell back"
    arrs = _inputs(f.fn)
    got = prog.jitted()(dict(arrs))
    ref = compile_jax(f.fn, build_ast(f.fn))(
        {k: np.asarray(v, dtype=np.float64) for k, v in arrs.items()})
    rf = CASES[name](ref_workloads)
    want = ref_compile(rf.fn, target="pallas", interpret=True).jitted()(dict(arrs))
    for k in _outputs(f.fn):
        assert got[k].device.type == "cpu" and got[k].dtype == torch.float32
        np.testing.assert_allclose(_np(got[k]).astype(np.float64), ref[k],
                                   rtol=1e-4, atol=1e-4, err_msg=f"{name}:{k}")
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=f"{name}:{k}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_legacy_matches_oracle(name):
    f = CASES[name](workloads)
    prog = pcompile(f.fn, target="cuda", device=CPU)
    arrs = _inputs(f.fn, seed=4)
    got = prog(dict(arrs))
    ref = compile_jax(f.fn, build_ast(f.fn))(
        {k: np.asarray(v, dtype=np.float64) for k, v in arrs.items()})
    for k in _outputs(f.fn):
        np.testing.assert_allclose(_np(got[k]).astype(np.float64), ref[k],
                                   rtol=1e-4, atol=1e-4, err_msg=f"{name}:{k}")


def test_jitted_does_not_modify_inputs():
    f = workloads.gemm(8)
    prog = pcompile(f.fn, target="cuda", device=CPU)
    arrs = {k: torch.from_numpy(v) for k, v in _inputs(f.fn).items()}
    arrs["C"] = torch.ones(8, 8)
    prog.jitted()(arrs)
    assert torch.equal(arrs["C"], torch.ones(8, 8))


# --------------------------------------------------------------------------
# batched execution
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["gemm", "2mm", "blur", "conv"])
def test_batched_equals_sequential_bitforbit(name):
    """As in the reference: every lane of ``batched(B)`` equals a sequential
    ``jitted()`` run exactly (the contraction's plain version sums each
    output's products in the same order with or without the batch)."""
    B = 3
    f = CASES[name](workloads)
    prog = pcompile(f.fn, target="cuda", device=CPU)
    singles = [_inputs(f.fn, seed=s) for s in range(B)]
    batched = {k: np.stack([s[k] for s in singles]) for k in singles[0]}
    run = prog.jitted()
    seq = [run(dict(s)) for s in singles]
    out = prog.batched(B)(batched)
    for k in _outputs(f.fn):
        got = out[k]
        assert got.shape[0] == B
        for i in range(B):
            assert torch.equal(got[i], seq[i][k]), \
                f"{name}:{k} batch lane {i} differs from sequential run"


def test_batched_matches_reference_batched():
    B = 2
    f = CASES["conv"](workloads)
    rf = CASES["conv"](ref_workloads)
    singles = [_inputs(f.fn, seed=s) for s in range(B)]
    batched = {k: np.stack([s[k] for s in singles]) for k in singles[0]}
    got = pcompile(f.fn, target="cuda", device=CPU).batched(B)(batched)
    want = ref_compile(rf.fn, target="pallas", interpret=True).batched(B)(batched)
    for k in _outputs(f.fn):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-4, atol=1e-4)


def test_batched_rejects_wrong_batch():
    f = workloads.gemm(8)
    prog = pcompile(f.fn, target="cuda", device=CPU)
    br = prog.batched(4)
    arrs = {k: np.stack([v, v]) for k, v in _inputs(f.fn).items()}
    with pytest.raises(ValueError, match="built for batch 4"):
        br(arrs)


def test_batched_infers_batch_without_inputs():
    f = workloads.gemm(8)
    prog = pcompile(f.fn, target="cuda", device=CPU)
    out = prog.batched(3)({})
    assert tuple(out["C"].shape) == (3, 8, 8)
    with pytest.raises(ValueError, match="cannot infer batch size"):
        prog.batched(None)({})


def test_untraceable_program_falls_back_sequential():
    f = workloads.gemm(8)
    prog = pcompile(f.fn, target="cuda", device=CPU)
    prog._step_ok = False          # force the fallback path
    br = prog.batched(2)
    singles = [_inputs(f.fn, seed=s) for s in range(2)]
    batched = {k: np.stack([s[k] for s in singles]) for k in singles[0]}
    out = br(batched)
    assert out["C"].device.type == "cpu"
    for i, s in enumerate(singles):
        ref = prog(dict(s))
        np.testing.assert_allclose(_np(out["C"][i]), _np(ref["C"]), rtol=1e-5, atol=1e-5)


def test_trace_failure_warns_and_falls_back(monkeypatch):
    from repro_torch.core import backend_cuda as bc
    f = workloads.gemm(8)
    prog = pcompile(f.fn, target="cuda", device=CPU)

    def broken(*a, **k):
        raise bc.TraceError("no rendition")

    monkeypatch.setattr(bc, "_build_step", broken)
    with pytest.warns(PomWarning, match="cuda_trace_fallback"):
        assert prog.traceable() is False
    assert prog.jitted() is prog


# --------------------------------------------------------------------------
# service + DSL plumbing
# --------------------------------------------------------------------------
def test_service_cuda_runner_caches_executors(tmp_path):
    svc = pom.serve(path=str(tmp_path / "db"))
    f = workloads.gemm(8)
    r1 = svc.cuda_runner(f, batch_size=2, device=CPU)
    r2 = svc.cuda_runner(workloads.gemm(8), batch_size=2, device=CPU)
    assert r1 is r2                # same design key + batch + device -> same executor
    r3 = svc.cuda_runner(workloads.gemm(8), device=CPU)
    assert r3 is not r1
    singles = [_inputs(f.fn, seed=s) for s in range(2)]
    out = r1({k: np.stack([s[k] for s in singles]) for k in singles[0]})
    for i, s in enumerate(singles):
        np.testing.assert_allclose(_np(out["C"][i]), _np(r3(dict(s))["C"]),
                                   rtol=1e-5, atol=1e-5)


def test_dsl_runner_shortcut():
    f = workloads.gemm(8)
    run = f.runner(device=CPU)
    arrs = _inputs(f.fn)
    ref = pcompile(workloads.gemm(8).fn, target="cuda", device=CPU).jitted()(dict(arrs))
    np.testing.assert_allclose(_np(run(dict(arrs))["C"]), _np(ref["C"]),
                               rtol=1e-5, atol=1e-5)


def test_runner_cache_keys_distinguish_devices():
    from repro_torch.core import backend_cuda as bc
    from repro_torch.core.ir import loads_of
    f = workloads.gemm(8)
    s = f.fn.statements[0]
    s.unrolls["j"] = 8
    bc.lower_stmt_cuda(s, device=CPU)
    sig = tuple((a.name, a.shape, a.dtype.name)
                for a in [s.store.array] + [ld.array for ld in loads_of(s.body)])
    assert (s.schedule_signature(), sig, "cpu") in bc._CUDA_RUNNER_CACHE
    assert (s.schedule_signature(), sig, "cuda") not in bc._CUDA_RUNNER_CACHE
    assert bc.lower_stmt_cuda(s, device=CPU) is bc.lower_stmt_cuda(s, device=CPU)
    caching.clear_all()
    assert not bc._CUDA_RUNNER_CACHE


# --------------------------------------------------------------------------
# scan-over-layers
# --------------------------------------------------------------------------
def _tail_fn(w=workloads, scan_tail=3, hw=8):
    return w.conv_chain(hw=hw, chans=(3, 4, 4), scan_tail=scan_tail)


def test_scan_equals_unrolled(monkeypatch):
    f = _tail_fn()
    prog = pcompile(f.fn, target="cuda", device=CPU)
    assert any(isinstance(n, ScanRegion) for n in walk(prog.ast))
    assert prog.traceable()
    arrs = _inputs(f.fn, seed=1)
    got = prog.jitted()(dict(arrs))
    monkeypatch.setenv("POM_PALLAS_SCAN", "0")
    caching.clear_all()
    prog_u = pcompile(_tail_fn().fn, target="cuda", device=CPU)
    assert not any(isinstance(n, ScanRegion) for n in walk(prog_u.ast))
    ref = prog_u.jitted()(dict(arrs))
    for k in _outputs(f.fn):
        assert torch.equal(got[k], ref[k]), f"{k}: scan-over-layers changed numerics"


def test_scan_matches_reference_scan():
    f, rf = _tail_fn(), _tail_fn(ref_workloads)
    arrs = _inputs(f.fn, seed=3)
    got = pcompile(f.fn, target="cuda", device=CPU).jitted()(dict(arrs))
    want = ref_compile(rf.fn, target="pallas", interpret=True).jitted()(dict(arrs))
    for k in _outputs(f.fn):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-4, atol=1e-4)


def test_scan_region_oracle_and_legacy_exact():
    f = _tail_fn()
    ast = build_ast(f.fn)
    arrs = {k: np.asarray(v, dtype=np.float64) for k, v in _inputs(f.fn, seed=2).items()}
    got = compile_jax(f.fn, ast)(dict(arrs))
    f2 = _tail_fn()
    ref = compile_jax(f2.fn, build_ast(f2.fn, scan=False))(dict(arrs))
    for k in _outputs(f.fn):
        assert np.array_equal(got[k], ref[k])
    prog = pcompile(_tail_fn().fn, target="cuda", device=CPU)
    legacy = prog(dict(arrs))
    for k in _outputs(f.fn):
        np.testing.assert_allclose(_np(legacy[k]).astype(np.float64), ref[k],
                                   rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the executor's own paths: the call is the step, loop distribution,
# wavefronts, no host round trip off the CPU
# --------------------------------------------------------------------------
def test_call_is_the_step_and_never_the_oracle(monkeypatch):
    from repro_torch.core import backend_jax
    f = workloads.gesummv(12)
    prog = pcompile(f.fn, target="cuda", device=CPU)

    def no_oracle(*a, **k):
        raise AssertionError("the oracle ran for a program the step expresses")

    monkeypatch.setattr(backend_jax, "compile_jax", no_oracle)
    arrs = _inputs(f.fn, seed=5)
    called, stepped = prog(dict(arrs)), prog.jitted()(dict(arrs))
    for k in _outputs(f.fn):
        assert torch.equal(called[k], stepped[k])


def test_untraceable_program_raises_off_the_cpu():
    """Off the CPU a program the step cannot express raises: nothing is
    copied to the host to run on the oracle (``meta`` stands in for a card
    here)."""
    from repro_torch.core.backend_cuda import CudaLowerError
    f = workloads.gemm(8)
    prog = CudaProgram(f.fn, build_ast(f.fn), torch.device("meta"))
    prog._step_ok = False
    with pytest.raises(CudaLowerError, match="nothing falls back"):
        prog(_inputs(f.fn))
    with pytest.raises(CudaLowerError, match="nothing falls back"):
        prog.batched(2)({k: np.stack([v, v]) for k, v in _inputs(f.fn).items()})


@pytest.mark.parametrize("name,generic", [("bicg", set()), ("gesummv", {"s3"}),
                                          ("conv", set()), ("seidel", {"s"})])
def test_mode_reports_which_statements_reach_the_kernel(name, generic):
    """bicg and gesummv fuse their two contractions into one nest; the
    statements share no array they write, so the step distributes the nest
    and each contraction reaches the kernel."""
    prog = pcompile(CASES[name](workloads).fn, target="cuda", device=CPU)
    assert prog.traceable()
    assert prog._step.generic == generic
    assert prog.mode == ("cuda" if not generic else "oracle")


def _fused_dependent(n=6):
    """Two statements fused into one nest, the second reading what the
    first writes: not distributable."""
    with pom.function("fused_dep") as f:
        i, j = pom.var("i", 1, n), pom.var("j", 0, n)
        A = pom.placeholder("A", (n, n))
        B = pom.placeholder("B", (n, n))
        s1 = pom.compute("s1", [i, j], A(i - 1, j) * 2.0, B(i, j))
        s2 = pom.compute("s2", [i, j], B(i, j) + A(i, j), A(i, j))
        s2.after(s1, 1)
    return f


def _skewed_seidel(n=7, steps=2):
    """An in-place update reading ``A[i-1][j+1]`` (new): offset (-1, +1) lies
    on the same hyperplane ``i + j``, so no wavefront over (i, j) applies;
    within one row the reads see the row before only, so each row is one
    update."""
    with pom.function("skewed") as f:
        t = pom.var("t", 0, steps)
        i, j = pom.var("i", 1, n - 1), pom.var("j", 1, n - 1)
        A = pom.placeholder("A", (n, n))
        pom.compute("s", [t, i, j], 0.5 * (A(i - 1, j + 1) + A(i, j)), A(i, j))
    return f


def _recurrence(n=6):
    """``x[0] = 0.5 * x[0] + A[i]``: every instance reads the one before."""
    with pom.function("recurrence") as f:
        i = pom.var("i", 0, n)
        A = pom.placeholder("A", (n,))
        x = pom.placeholder("x", (1,))
        pom.compute("s", [i], 0.5 * x(0) + A(i), x(0))
    return f


@pytest.mark.parametrize("build,executor", [
    (lambda: workloads.seidel(9, 2), "wavefront"),
    (lambda: workloads.bicg(9), "distributed"),
    (_skewed_seidel, "wavefront"),
    (_fused_dependent, "loops"),
    (_recurrence, "loops"),
])
def test_executor_paths_match_the_oracle(build, executor, monkeypatch):
    """Each of the step's own executors against the numpy oracle, with the
    instance-by-instance path forbidden where another one must apply."""
    from repro_torch.core import backend_cuda as bc
    f = build()
    prog = pcompile(f.fn, target="cuda", device=CPU)
    scalar_runs = []

    def scalar(*a, **k):
        if executor != "loops":
            raise AssertionError(f"{f.fn.name} ran instance by instance")
        scalar_runs.append(1)
        return exec_scalar(*a, **k)

    exec_scalar = bc._exec_stmt_scalar
    monkeypatch.setattr(bc, "_exec_stmt_scalar", scalar)
    rng = np.random.default_rng(7)
    arrs = {p.name: rng.standard_normal(p.shape).astype(np.float32)
            for p in f.fn.placeholders.values()}
    got = prog.jitted()(dict(arrs))
    want = compile_jax(f.fn, build_ast(f.fn))(
        {k: v.astype(np.float64) for k, v in arrs.items()})
    for k in _outputs(f.fn):
        np.testing.assert_allclose(_np(got[k]).astype(np.float64), want[k],
                                   rtol=1e-5, atol=1e-5, err_msg=f"{f.fn.name}:{k}")
    assert bool(scalar_runs) == (executor == "loops")


def _smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMALL_DEFAULTS = {
    "gemm": (lambda: workloads.gemm(12), 0), "bicg": (lambda: workloads.bicg(12), 0),
    "gesummv": (lambda: workloads.gesummv(12), 0), "2mm": (lambda: workloads.mm2(10), 0),
    "3mm": (lambda: workloads.mm3(10), 0), "jacobi1d": (lambda: workloads.jacobi1d(20, 5), 5),
    "jacobi2d": (lambda: workloads.jacobi2d(9, 3), 3),
    "heat1d": (lambda: workloads.heat1d(20, 5), 5), "seidel": (lambda: workloads.seidel(9, 3), 3),
    "edge_detect": (lambda: workloads.edge_detect(11), 0),
    "gaussian": (lambda: workloads.gaussian(11), 0), "blur": (lambda: workloads.blur(11), 0),
    "conv": (lambda: workloads.conv_nest("conv", 6, 3, 5, 5), 0),
}


@pytest.mark.parametrize("name", sorted(SMALL_DEFAULTS))
def test_smoke_workload_reference_matches_the_oracle(name):
    """``chip_smoke.py`` holds the workloads at their default sizes against
    PyTorch formulations of them; here those formulations meet the numpy
    oracle at small sizes, every array an input."""
    build, steps = SMALL_DEFAULTS[name]
    f = build()
    rng = np.random.default_rng(11)
    arrs = {p.name: rng.standard_normal(p.shape).astype(np.float32)
            for p in f.fn.placeholders.values()}
    got = _smoke().workload_reference(
        name, {k: torch.from_numpy(v) for k, v in arrs.items()}, steps)
    want = compile_jax(f.fn, build_ast(f.fn))(
        {k: v.astype(np.float64) for k, v in arrs.items()})
    assert set(got) == _outputs(f.fn)
    for k, v in got.items():
        np.testing.assert_allclose(_np(v).astype(np.float64), want[k],
                                   rtol=1e-5, atol=1e-5, err_msg=f"{name}:{k}")
