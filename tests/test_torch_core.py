"""The port's copy of the POM core against the JAX package's.

``src/repro_torch/core`` holds verbatim copies of the host front end (DSL,
Graph IR, polyhedral IR and transforms, cost model, DSE, loop IR, HLS
emitter, numpy oracle).  These tests hold the copies to the reference on
the thirteen serving workloads: identical HLS C, identical greedy DSE
designs, identical oracle outputs and identical design-db keys.  One
deliberate difference is tested too: the copy's analytic dependence
transfer falls back to Fourier-Motzkin where the reference's disagrees
with it (a permute that moves a dim between a tile dim and its intra dim).
"""
import numpy as np
import pytest

from benchmarks import workloads as ref_workloads
from repro.core import caching as ref_caching
from repro.core.astbuild import build_ast as ref_build_ast
from repro.core.backend_jax import compile_jax as ref_compile_jax
from repro.core.designdb import function_key as ref_function_key
from repro.core.dse import auto_dse as ref_auto_dse
from repro.core.pipeline import compile as ref_compile

from repro_torch import workloads as port_workloads
from repro_torch.core import caching as port_caching
from repro_torch.core import transforms as port_T
from repro_torch.core.astbuild import build_ast as port_build_ast
from repro_torch.core.backend_jax import compile_jax as port_compile_jax
from repro_torch.core.designdb import function_key as port_function_key
from repro_torch.core.dse import auto_dse as port_auto_dse
from repro_torch.core.pipeline import compile as port_compile

NAMES = [name for name, _ in port_workloads.serving_cases(True)]


@pytest.fixture(autouse=True)
def _fresh_caches():
    ref_caching.clear_all()
    port_caching.clear_all()
    ref_caching.reset_counts()
    port_caching.reset_counts()
    yield


def _pair(name, small=True):
    """The same workload built in both packages."""
    ref = dict(ref_workloads_cases(small))[name]()
    port = dict(port_workloads.serving_cases(small))[name]()
    return ref, port


def ref_workloads_cases(small):
    n = 16 if small else 32
    m = 12 if small else 20
    w = ref_workloads
    return [
        ("gemm", lambda: w.gemm(n)), ("bicg", lambda: w.bicg(n)),
        ("gesummv", lambda: w.gesummv(n)), ("2mm", lambda: w.mm2(n)),
        ("3mm", lambda: w.mm3(n)), ("jacobi1d", lambda: w.jacobi1d(3 * n, 4)),
        ("jacobi2d", lambda: w.jacobi2d(m, 3)), ("heat1d", lambda: w.heat1d(3 * n, 4)),
        ("seidel", lambda: w.seidel(m, 3)), ("edge_detect", lambda: w.edge_detect(m)),
        ("gaussian", lambda: w.gaussian(m)), ("blur", lambda: w.blur(m)),
        ("conv", lambda: w.conv_nest("conv", 8, 4, 6, 6)),
    ]


def _inputs(fn, seed=0):
    rng = np.random.default_rng(seed)
    written = {s.store.array.name for s in fn.statements}
    return {p.name: rng.standard_normal(p.shape).astype(np.float64)
            for p in fn.placeholders.values() if p.name not in written}


def test_serving_cases_mirror_bench_pallas():
    from benchmarks.bench_pallas import _cases
    for small in (True, False):
        assert [n for n, _ in _cases(small)] == [n for n, _ in port_workloads.serving_cases(small)]
        for (n, mk), (_, pmk) in zip(_cases(small), port_workloads.serving_cases(small)):
            r, p = mk().fn, pmk().fn
            assert {k: v.shape for k, v in r.placeholders.items()} == \
                {k: v.shape for k, v in p.placeholders.items()}, n


@pytest.mark.parametrize("name", NAMES)
def test_hls_c_is_byte_identical(name):
    ref, port = _pair(name)
    assert port_compile(port.fn, target="hls") == ref_compile(ref.fn, target="hls")


@pytest.mark.parametrize("name", NAMES)
def test_oracle_outputs_equal(name):
    ref, port = _pair(name)
    arrs = _inputs(ref.fn)
    want = ref_compile_jax(ref.fn, ref_build_ast(ref.fn))(dict(arrs))
    got = port_compile_jax(port.fn, port_build_ast(port.fn))(dict(arrs))
    assert want.keys() == got.keys()
    for k in want:
        assert np.array_equal(want[k], got[k]), f"{name}:{k}"


@pytest.mark.parametrize("name", NAMES)
def test_function_key_equal(name):
    ref, port = _pair(name)
    opts = {"strategy": "greedy", "max_parallel": 256}
    assert port_function_key(port.fn, opts) == ref_function_key(ref.fn, opts)


def _result_tuple(res):
    rep = res.report
    nodes = tuple(sorted(
        (n.name, n.latency, n.ii, n.depth, n.dsp, n.lut, n.trip_product)
        for n in rep.nodes.values()))
    return (rep.latency, rep.dsp, rep.lut, rep.ff, rep.bram_bits,
            rep.feasible, nodes, tuple(res.actions),
            tuple(res.stage1_log.actions),
            tuple(sorted((k, tuple(v)) for k, v in res.tile_sizes.items())))


@pytest.mark.parametrize("name", ["gemm", "2mm", "bicg", "conv"])
def test_greedy_dse_chooses_the_same_design(name):
    """Same tile sizes, same report (latency, DSP, LUT, FF, BRAM bits),
    same action logs — with the copy's dependence-transfer fix in place."""
    ref, port = _pair(name)
    want = ref_auto_dse(ref.fn, strategy="greedy")
    got = port_auto_dse(port.fn, strategy="greedy")
    assert _result_tuple(got) == _result_tuple(want)


# --------------------------------------------------------------------------
# Queue 3 item 5: analytic dependence transfer vs Fourier-Motzkin
# --------------------------------------------------------------------------
def _info_tuple(d):
    return (d.exists, d.distance, d.direction, d.loop_carried_level,
            dict(d.levels))


def _apply(s, ops):
    uniq = 0
    for kind, a, b, f in ops:
        dims = s.dims
        if kind == "interchange":
            port_T.interchange(s, dims[a % len(dims)], dims[b % len(dims)], check=False)
        elif kind == "split":
            d = dims[a % len(dims)]
            uniq += 1
            port_T.split(s, d, f, f"{d}_a{uniq}", f"{d}_b{uniq}", check=False)
        else:
            i, j = dims[-2], dims[-1]
            uniq += 1
            port_T.skew(s, i, j, f % 3 + 1, f"{i}_s{uniq}", f"{j}_s{uniq}", check=False)


TRANSFER_CASES = [
    # the hypothesis example that exposed the fault in the reference
    ("gemm", [("split", 0, 0, 2), ("interchange", 1, 3, 2)]),
    ("gemm", [("split", 0, 0, 2), ("interchange", 2, 3, 2)]),
    ("gemm", [("split", 2, 0, 4), ("interchange", 0, 1, 2)]),
    ("gemm", [("split", 1, 0, 2), ("split", 0, 0, 3), ("interchange", 0, 4, 2)]),
    ("bicg", [("split", 1, 0, 2), ("interchange", 0, 2, 2)]),
    ("seidel", [("split", 1, 0, 2), ("interchange", 2, 3, 2)]),
    ("jacobi2d", [("split", 2, 0, 3), ("skew", 0, 0, 2)]),
]


@pytest.mark.parametrize("name,ops", TRANSFER_CASES)
def test_dependence_transfer_matches_fm(name, ops):
    fn = dict(port_workloads.serving_cases(False))[name]().fn
    for s in fn.statements:
        _apply(s, ops)
        got = port_T.self_dependences(s)
        fm = port_T._self_dependences_compute(s)
        assert [_info_tuple(d) for d in got] == [_info_tuple(d) for d in fm]
        assert port_T._legal(s) == port_T._legal_compute(s)


def test_transfer_fault_example_gives_fm_vectors():
    fn = port_workloads.gemm(24).fn
    s = fn.statements[0]
    _apply(s, [("split", 0, 0, 2), ("interchange", 1, 3, 2)])
    got = port_T.self_dependences(s)
    assert got and all(d.distance == (0, 1, 0, None) for d in got)
    assert all(d.direction == ("=", "<", "=", "*") for d in got)
