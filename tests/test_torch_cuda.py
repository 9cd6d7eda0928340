"""The compile path's CUDA kernels on the card (every test is ``gpu``-marked
and skips on a host without one).

The contraction kernel is held against its plain PyTorch version for the
schedules of ``tests/test_torch_backend.py`` in f32 and bf16, batched and
unbatched; the probe must pass; whole programs on ``cuda`` must agree with
the same programs on the CPU.  This file imports only the port, so it runs
on a machine without JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch import workloads
from repro_torch.core import caching
from repro_torch.core import dsl as pom
from repro_torch.core.backend_cuda import cuda_supported, lower_stmt_cuda
from repro_torch.core.pipeline import compile as pcompile
from repro_torch.kernels import contraction as cmod
from repro_torch.kernels import probe as pmod
from repro_torch.kernels import ref as tref


@pytest.fixture(autouse=True)
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    caching.clear_all()
    yield


def _sched_gemm(n, t):
    with pom.function("gemm") as f:
        i, j, k = pom.var("i", 0, n), pom.var("j", 0, n), pom.var("k", 0, n)
        A = pom.placeholder("A", (n, n))
        B = pom.placeholder("B", (n, n))
        C = pom.placeholder("C", (n, n))
        s = pom.compute("s", [i, j, k], A(i, j) + B(i, k) * C(k, j), A(i, j))
    s.tile("i", "j", t, t, "i0", "j0", "i1", "j1")
    s.split("k", t, "k0", "k1")
    s.stmt.domain = s.stmt.domain.permute(["i0", "j0", "k0", "i1", "j1", "k1"])
    for d in ("i1", "j1", "k1"):
        s.unroll(d, t)
    s.pipeline("k0", 1)
    return s.stmt


def _matvec(n, t):
    with pom.function("mv"):
        i, j = pom.var("i", 0, n), pom.var("j", 0, n)
        A = pom.placeholder("A", (n, n))
        p = pom.placeholder("p", (n,))
        q = pom.placeholder("q", (n,))
        s = pom.compute("s", [i, j], q(i) + A(i, j) * p(j), q(i))
    s.tile("i", "j", t, t, "i0", "j0", "i1", "j1")
    s.unroll("i1", t)
    s.unroll("j1", t)
    s.pipeline("j0", 1)
    return s.stmt


SCHEDULES = [
    ("gemm_tiled", lambda: _sched_gemm(256, 32)),
    ("gemm_unscheduled", lambda: workloads.gemm(160).fn.statements[0]),
    ("matvec_tiled", lambda: _matvec(256, 32)),
    ("conv", lambda: workloads.conv_nest("conv", 8, 4, 6, 6).fn.statements[0]),
    ("conv_gemm_shaped", lambda: workloads.conv_nest("conv", 128, 2, 12, 12).fn.statements[0]),
]


def _tol(dtype, scale):
    # f32: the kernel sums each output in loop order, the plain version in
    # einsum's (cuBLAS) order; bf16: both round the f32 sum once, so at most
    # an ulp apart
    return (1e-2 if dtype == torch.bfloat16 else 1e-5) * scale


@pytest.mark.gpu
def test_gpu_probe_passes():
    assert cuda_supported() is True
    x = torch.arange(8, dtype=torch.float32, device="cuda")
    n0 = pmod.launches
    out = pmod.probe(x)
    torch.cuda.synchronize()
    assert pmod.launches == n0 + 1
    assert torch.equal(out, tref.probe(x))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label,build", SCHEDULES)
def test_gpu_contraction_matches_plain(label, build, dtype):
    d = lower_stmt_cuda(build(), device="cuda").desc
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(d.x_numel, generator=g, device="cuda").to(dt)
    y = torch.randn(d.y_numel, generator=g, device="cuda").to(dt)
    o = torch.randn(d.o_numel, generator=g, device="cuda").to(dt)
    n0 = cmod.launches
    got = cmod.contraction(d, x, y, o)
    torch.cuda.synchronize()
    assert cmod.launches == n0 + 1
    want = tref.contraction(d, x, y, o)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(dt, want.float().abs().max().item()), (label, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label,build", [s for s in SCHEDULES
                                         if s[0] in ("gemm_tiled", "gemm_unscheduled",
                                                     "conv_gemm_shaped")])
def test_gpu_tiled_kernel_equals_generic_kernel(label, build, dtype, monkeypatch):
    """Both kernels sum each output's products in k order in one f32
    register, so a GEMM-shaped statement gives the same bits on either."""
    d = lower_stmt_cuda(build(), device="cuda").desc
    assert cmod.gemm_view(d) is not None
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(2)
    x, y, o = (torch.randn(k, generator=g, device="cuda").to(dt)
               for k in (d.x_numel, d.y_numel, d.o_numel))
    tiled = cmod.contraction(d, x, y, o)
    monkeypatch.setattr(cmod, "GEMM_MIN", 1 << 62)
    generic = cmod.contraction(d, x, y, o)
    torch.cuda.synchronize()
    assert torch.equal(tiled, generic), label


@pytest.mark.gpu
def test_gpu_contraction_f64_matches_plain():
    d = lower_stmt_cuda(_sched_gemm(64, 16), device="cuda").desc
    g = torch.Generator(device="cuda").manual_seed(3)
    x, y, o = (torch.randn(k, generator=g, device="cuda", dtype=torch.float64)
               for k in (d.x_numel, d.y_numel, d.o_numel))
    torch.testing.assert_close(cmod.contraction(d, x, y, o), tref.contraction(d, x, y, o))


@pytest.mark.gpu
def test_gpu_batched_contraction_matches_plain():
    d = lower_stmt_cuda(_sched_gemm(128, 32), device="cuda").desc
    g = torch.Generator(device="cuda").manual_seed(1)
    b = 4
    x = torch.randn(b * d.x_numel, generator=g, device="cuda")
    y = torch.randn(d.y_numel, generator=g, device="cuda")      # shared by every lane
    o = torch.randn(b * d.o_numel, generator=g, device="cuda")
    got = cmod.contraction(d, x, y, o)
    torch.cuda.synchronize()
    want = tref.contraction(d, x, y, o)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def _inputs(fn, seed=0):
    rng = np.random.default_rng(seed)
    written = {s.store.array.name for s in fn.statements}
    return {p.name: rng.standard_normal(p.shape).astype(np.float32)
            for p in fn.placeholders.values() if p.name not in written}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gemm", "2mm", "conv", "blur", "seidel", "bicg", "gesummv"])
def test_gpu_program_matches_cpu(name):
    build = dict(workloads.serving_cases(True))[name]
    gpu = pcompile(build().fn, target="cuda", device="cuda")
    cpu = pcompile(build().fn, target="cuda", device="cpu")
    assert gpu.mode == cpu.mode and gpu.device.type == "cuda"
    f = build()
    outs = {s.store.array.name for s in f.fn.statements}
    arrs = _inputs(f.fn)
    n0 = cmod.launches
    got = gpu.jitted()(dict(arrs))
    torch.cuda.synchronize()
    if gpu.mode == "cuda":
        assert cmod.launches > n0
    want = cpu.jitted()(dict(arrs))
    called = gpu(dict(arrs))
    B = 3
    batched = gpu.batched(B)({k: np.stack([v] * B) for k, v in arrs.items()})
    for k in outs:
        assert got[k].device.type == "cuda"
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].cpu().numpy(), w, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(called[k].cpu().numpy(), w, rtol=1e-4, atol=1e-4)
        for i in range(B):
            np.testing.assert_allclose(batched[k][i].cpu().numpy(), w, rtol=1e-4, atol=1e-4)
