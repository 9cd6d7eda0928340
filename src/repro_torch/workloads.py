"""The paper's benchmark workloads, written in the port's POM DSL.

A copy of the workload builders of ``benchmarks/workloads.py`` on
``repro_torch.core`` (the port imports nothing of the JAX package), so that
``chip_smoke.py`` and the tests build the same programs in both packages.

Builders return a fresh ``PomFunction`` per call (DSE mutates schedules).
Suites:
  * Polybench (Table III): gemm, bicg, gesummv, mm2, mm3
  * Stencils (Table VII):  jacobi1d, jacobi2d, heat1d, seidel
  * Image (Table V):       edge_detect, gaussian, blur
  * DNN (Table V/Fig 13):  vgg16 / resnet18 critical conv nests
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.core import dsl as pom
from repro_torch.core.ir import Call, wrap


# ---------------------------------------------------------------------------
# Polybench
# ---------------------------------------------------------------------------
def gemm(n: int = 4096):
    with pom.function("gemm") as f:
        i, j, k = pom.var("i", 0, n), pom.var("j", 0, n), pom.var("k", 0, n)
        A = pom.placeholder("A", (n, n))
        B = pom.placeholder("B", (n, n))
        C = pom.placeholder("C", (n, n))
        pom.compute("s", [i, j, k], C(i, j) + A(i, k) * B(k, j), C(i, j))
    return f


def bicg(n: int = 4096):
    with pom.function("bicg") as f:
        i, j = pom.var("i", 0, n), pom.var("j", 0, n)
        A = pom.placeholder("A", (n, n))
        p = pom.placeholder("p", (n,))
        r = pom.placeholder("r", (n,))
        q = pom.placeholder("q", (n,))
        s_arr = pom.placeholder("s", (n,))
        sq = pom.compute("sq", [i, j], q(i) + A(i, j) * p(j), q(i))
        ss = pom.compute("ss", [i, j], s_arr(j) + r(i) * A(i, j), s_arr(j))
        ss.after(sq, 1)
    return f


def gesummv(n: int = 4096):
    with pom.function("gesummv") as f:
        i, j = pom.var("i", 0, n), pom.var("j", 0, n)
        i2 = pom.var("i2", 0, n)
        A = pom.placeholder("A", (n, n))
        B = pom.placeholder("B", (n, n))
        x = pom.placeholder("x", (n,))
        tmp = pom.placeholder("tmp", (n,))
        y = pom.placeholder("y", (n,))
        s1 = pom.compute("s1", [i, j], tmp(i) + A(i, j) * x(j), tmp(i))
        s2 = pom.compute("s2", [i, j], y(i) + B(i, j) * x(j), y(i))
        s2.after(s1, 1)
        s3 = pom.compute("s3", [i2], 1.5 * tmp(i2) + 1.2 * y(i2), y(i2))
    return f


def mm2(n: int = 4096):
    with pom.function("mm2") as f:
        i, j, k = pom.var("i", 0, n), pom.var("j", 0, n), pom.var("k", 0, n)
        i2, j2, k2 = pom.var("i2", 0, n), pom.var("j2", 0, n), pom.var("k2", 0, n)
        A = pom.placeholder("A", (n, n))
        B = pom.placeholder("B", (n, n))
        C = pom.placeholder("C", (n, n))
        tmp = pom.placeholder("tmp", (n, n))
        D = pom.placeholder("D", (n, n))
        pom.compute("s1", [i, j, k], tmp(i, j) + A(i, k) * B(k, j), tmp(i, j))
        pom.compute("s2", [i2, j2, k2], D(i2, j2) + tmp(i2, k2) * C(k2, j2),
                    D(i2, j2))
    return f


def mm3(n: int = 4096):
    with pom.function("mm3") as f:
        dims = {}
        for t in range(3):
            for d in "ijk":
                dims[f"{d}{t}"] = pom.var(f"{d}{t}", 0, n)
        A = pom.placeholder("A", (n, n))
        B = pom.placeholder("B", (n, n))
        C = pom.placeholder("C", (n, n))
        D = pom.placeholder("D", (n, n))
        E = pom.placeholder("E", (n, n))
        F = pom.placeholder("F", (n, n))
        G = pom.placeholder("G", (n, n))
        pom.compute("s1", [dims["i0"], dims["j0"], dims["k0"]],
                    E(dims["i0"], dims["j0"]) + A(dims["i0"], dims["k0"]) *
                    B(dims["k0"], dims["j0"]), E(dims["i0"], dims["j0"]))
        pom.compute("s2", [dims["i1"], dims["j1"], dims["k1"]],
                    F(dims["i1"], dims["j1"]) + C(dims["i1"], dims["k1"]) *
                    D(dims["k1"], dims["j1"]), F(dims["i1"], dims["j1"]))
        pom.compute("s3", [dims["i2"], dims["j2"], dims["k2"]],
                    G(dims["i2"], dims["j2"]) + E(dims["i2"], dims["k2"]) *
                    F(dims["k2"], dims["j2"]), G(dims["i2"], dims["j2"]))
    return f


# ---------------------------------------------------------------------------
# Stencils (Table VII)
# ---------------------------------------------------------------------------
def jacobi1d(n: int = 4096, steps: int = 100):
    with pom.function("jacobi1d") as f:
        t = pom.var("t", 0, steps)
        i = pom.var("i", 1, n - 1)
        t2 = pom.var("t2", 0, steps)
        i2 = pom.var("i2", 1, n - 1)
        A = pom.placeholder("A", (n,))
        B = pom.placeholder("B", (n,))
        s1 = pom.compute("s1", [t, i],
                         0.33333 * (A(i - 1) + A(i) + A(i + 1)), B(i))
        s2 = pom.compute("s2", [t2, i2], B(i2), A(i2))
        s2.after(s1, 0)
    return f


def heat1d(n: int = 4096, steps: int = 100):
    with pom.function("heat1d") as f:
        t = pom.var("t", 0, steps)
        i = pom.var("i", 1, n - 1)
        t2 = pom.var("t2", 0, steps)
        i2 = pom.var("i2", 1, n - 1)
        A = pom.placeholder("A", (n,))
        B = pom.placeholder("B", (n,))
        s1 = pom.compute("s1", [t, i],
                         0.125 * (A(i + 1) - 2.0 * A(i) + A(i - 1)) + A(i),
                         B(i))
        s2 = pom.compute("s2", [t2, i2], B(i2), A(i2))
        s2.after(s1, 0)
    return f


def jacobi2d(n: int = 1024, steps: int = 10):
    with pom.function("jacobi2d") as f:
        t = pom.var("t", 0, steps)
        i, j = pom.var("i", 1, n - 1), pom.var("j", 1, n - 1)
        t2 = pom.var("t2", 0, steps)
        i2, j2 = pom.var("i2", 1, n - 1), pom.var("j2", 1, n - 1)
        A = pom.placeholder("A", (n, n))
        B = pom.placeholder("B", (n, n))
        s1 = pom.compute("s1", [t, i, j],
                         0.2 * (A(i, j) + A(i, j - 1) + A(i, j + 1)
                                + A(i + 1, j) + A(i - 1, j)), B(i, j))
        s2 = pom.compute("s2", [t2, i2, j2], B(i2, j2), A(i2, j2))
        s2.after(s1, 0)
    return f


def seidel(n: int = 1024, steps: int = 10):
    with pom.function("seidel") as f:
        t = pom.var("t", 0, steps)
        i, j = pom.var("i", 1, n - 1), pom.var("j", 1, n - 1)
        A = pom.placeholder("A", (n, n))
        pom.compute("s", [t, i, j],
                    0.2 * (A(i - 1, j) + A(i, j - 1) + A(i, j)
                           + A(i, j + 1) + A(i + 1, j)), A(i, j))
    return f


# ---------------------------------------------------------------------------
# Image processing (Table V)
# ---------------------------------------------------------------------------
def gaussian(n: int = 4096):
    with pom.function("gaussian") as f:
        i, j = pom.var("i", 1, n - 1), pom.var("j", 1, n - 1)
        img = pom.placeholder("img", (n, n))
        out = pom.placeholder("out", (n, n))
        pom.compute("g", [i, j],
                    0.0625 * (img(i - 1, j - 1) + 2.0 * img(i - 1, j)
                              + img(i - 1, j + 1) + 2.0 * img(i, j - 1)
                              + 4.0 * img(i, j) + 2.0 * img(i, j + 1)
                              + img(i + 1, j - 1) + 2.0 * img(i + 1, j)
                              + img(i + 1, j + 1)), out(i, j))
    return f


def blur(n: int = 4096):
    """Halide's two-pass blur: blurx then blury."""
    with pom.function("blur") as f:
        i, j = pom.var("i", 0, n), pom.var("j", 1, n - 1)
        i2, j2 = pom.var("i2", 1, n - 1), pom.var("j2", 1, n - 1)
        img = pom.placeholder("img", (n, n))
        bx = pom.placeholder("bx", (n, n))
        out = pom.placeholder("out", (n, n))
        pom.compute("blurx", [i, j],
                    0.33333 * (img(i, j - 1) + img(i, j) + img(i, j + 1)),
                    bx(i, j))
        pom.compute("blury", [i2, j2],
                    0.33333 * (bx(i2 - 1, j2) + bx(i2, j2) + bx(i2 + 1, j2)),
                    out(i2, j2))
    return f


def edge_detect(n: int = 4096):
    """Gaussian smooth + gradient magnitude (two dependent 3x3 stages)."""
    with pom.function("edge_detect") as f:
        i, j = pom.var("i", 1, n - 1), pom.var("j", 1, n - 1)
        i2, j2 = pom.var("i2", 2, n - 2), pom.var("j2", 2, n - 2)
        img = pom.placeholder("img", (n, n))
        sm = pom.placeholder("sm", (n, n))
        out = pom.placeholder("out", (n, n))
        pom.compute("smooth", [i, j],
                    0.111 * (img(i - 1, j - 1) + img(i - 1, j) + img(i - 1, j + 1)
                             + img(i, j - 1) + img(i, j) + img(i, j + 1)
                             + img(i + 1, j - 1) + img(i + 1, j)
                             + img(i + 1, j + 1)), sm(i, j))
        pom.compute("grad", [i2, j2],
                    (sm(i2 + 1, j2) - sm(i2 - 1, j2)) *
                    (sm(i2 + 1, j2) - sm(i2 - 1, j2)) +
                    (sm(i2, j2 + 1) - sm(i2, j2 - 1)) *
                    (sm(i2, j2 + 1) - sm(i2, j2 - 1)), out(i2, j2))
    return f


# ---------------------------------------------------------------------------
# DNN critical conv nests (Table V / Fig 13)
# ---------------------------------------------------------------------------
def conv_nest(name: str, oc: int, ic: int, oh: int, ow: int, kh: int = 3,
              kw: int = 3):
    with pom.function(name) as f:
        o = pom.var("oc", 0, oc)
        y = pom.var("oh", 0, oh)
        x = pom.var("ow", 0, ow)
        c = pom.var("ic", 0, ic)
        r = pom.var("kh", 0, kh)
        s = pom.var("kw", 0, kw)
        img = pom.placeholder(f"{name}_in", (ic, oh + kh - 1, ow + kw - 1))
        w = pom.placeholder(f"{name}_w", (oc, ic, kh, kw))
        out = pom.placeholder(f"{name}_out", (oc, oh, ow))
        pom.compute("conv", [o, y, x, c, r, s],
                    out(o, y, x) + img(c, y + r, x + s) * w(o, c, r, s),
                    out(o, y, x))
    return f


def conv_chain(hw: int = 12, chans: Sequence[int] = (3, 4, 4),
               scan_tail: int = 0):
    """Multi-statement conv stack in ONE function: conv -> relu per layer,
    plus a final elementwise rescale — the task-level-pipelining flagship.

    Each layer is a "valid" 3x3 convolution (spatial extent shrinks by 2),
    so layer l+1 reads layer l's activation array directly.  The statement
    chain gives the streaming analysis one of each channel kind: conv ->
    relu and relu -> conv hand-offs are order-mismatched (sequential
    edges after stage 1's interchange), while relu -> rescale is a pure
    in-order elementwise chain (FIFO).

    ``scan_tail`` appends that many *isomorphic* 1x1-conv -> relu layers
    (channel count and spatial extent held fixed) before the rescale — the
    3x3 body shrinks spatially each layer, so its blocks can never be
    structurally equal, while the tail blocks are exactly the repeated-
    layer shape ``graph_ir.detect_scan_chains`` compiles once and
    ``lax.scan``s over stacked weights (the deep-model serving idiom).
    """
    with pom.function("conv_chain", outputs=["out"]) as f:
        img = pom.placeholder("img", (chans[0], hw, hw))
        cur, cur_hw = img, hw
        for l, (ic, oc) in enumerate(zip(chans, chans[1:])):
            oh = cur_hw - 2
            w = pom.placeholder(f"w{l}", (oc, ic, 3, 3))
            t = pom.placeholder(f"t{l}", (oc, oh, oh))
            r_arr = pom.placeholder(f"r{l}", (oc, oh, oh))
            o = pom.var(f"o{l}", 0, oc)
            y = pom.var(f"y{l}", 0, oh)
            x = pom.var(f"x{l}", 0, oh)
            c = pom.var(f"c{l}", 0, ic)
            kr = pom.var(f"kr{l}", 0, 3)
            kc = pom.var(f"kc{l}", 0, 3)
            pom.compute(f"conv{l}", [o, y, x, c, kr, kc],
                        t(o, y, x) + cur(c, y + kr, x + kc) * w(o, c, kr, kc),
                        t(o, y, x))
            # y-major loop order: the elementwise stage consumes the conv's
            # activation rows in the order the conv finalizes them, so the
            # producer→consumer edge stays block-streamable
            ro = pom.var(f"ro{l}", 0, oc)
            ry = pom.var(f"ry{l}", 0, oh)
            rx = pom.var(f"rx{l}", 0, oh)
            pom.compute(f"relu{l}", [ry, rx, ro],
                        Call("max", (wrap(t(ro, ry, rx)), wrap(0.0))),
                        r_arr(ro, ry, rx))
            cur, cur_hw = r_arr, oh
        for l in range(scan_tail):
            nc = chans[-1]
            w = pom.placeholder(f"tw{l}", (nc, nc))
            t = pom.placeholder(f"tt{l}", (nc, cur_hw, cur_hw))
            r_arr = pom.placeholder(f"tr{l}", (nc, cur_hw, cur_hw))
            o = pom.var(f"to{l}", 0, nc)
            y = pom.var(f"ty{l}", 0, cur_hw)
            x = pom.var(f"tx{l}", 0, cur_hw)
            c = pom.var(f"tc{l}", 0, nc)
            pom.compute(f"tconv{l}", [o, y, x, c],
                        t(o, y, x) + cur(c, y, x) * w(o, c),
                        t(o, y, x))
            ro = pom.var(f"tro{l}", 0, nc)
            ry = pom.var(f"try{l}", 0, cur_hw)
            rx = pom.var(f"trx{l}", 0, cur_hw)
            pom.compute(f"trelu{l}", [ry, rx, ro],
                        Call("max", (wrap(t(ro, ry, rx)), wrap(0.0))),
                        r_arr(ro, ry, rx))
            cur = r_arr
        out = pom.placeholder("out", (chans[-1], cur_hw, cur_hw))
        so = pom.var("so", 0, chans[-1])
        sy = pom.var("sy", 0, cur_hw)
        sx = pom.var("sx", 0, cur_hw)
        pom.compute("rescale", [sy, sx, so], cur(so, sy, sx) * 0.5,
                    out(so, sy, sx))
    return f


# (out_ch, in_ch, H) at input resolution 512 (the paper's prob. size),
# one entry per critical conv loop (loop depth > 4)
VGG16_CONVS: List[Tuple[int, int, int]] = (
    [(64, 3, 512), (64, 64, 512)]
    + [(128, 64, 256), (128, 128, 256)]
    + [(256, 128, 128)] + [(256, 256, 128)] * 2
    + [(512, 256, 64)] + [(512, 512, 64)] * 2
    + [(512, 512, 32)] * 3
)

RESNET18_CONVS: List[Tuple[int, int, int]] = (
    [(64, 3, 256)]
    + [(64, 64, 128)] * 4
    + [(128, 64, 64)] + [(128, 128, 64)] * 3
    + [(256, 128, 32)] + [(256, 256, 32)] * 3
    + [(512, 256, 16)] + [(512, 512, 16)] * 3
)


def conv_table(net: str) -> List[Tuple[int, int, int]]:
    """(out_ch, in_ch, H=W) per critical conv loop of ``net``."""
    return VGG16_CONVS if net == "vgg16" else RESNET18_CONVS


def dnn_layers(net: str):
    """Yield (name, conv builder) for each critical loop of the net."""
    table = conv_table(net)
    out = []
    for idx, (oc, ic, hw) in enumerate(table):
        out.append((f"{net}_conv{idx}",
                    lambda oc=oc, ic=ic, hw=hw, idx=idx:
                    conv_nest(f"{net}_conv{idx}", oc, ic, hw, hw)))
    return out


POLYBENCH: Dict[str, Callable] = {
    "gemm": gemm, "bicg": bicg, "gesummv": gesummv, "2mm": mm2, "3mm": mm3,
}
STENCILS: Dict[str, Callable] = {
    "jacobi1d": jacobi1d, "jacobi2d": jacobi2d, "heat1d": heat1d,
    "seidel": seidel,
}
IMAGE: Dict[str, Callable] = {
    "edge_detect": edge_detect, "gaussian": gaussian, "blur": blur,
}


def serving_cases(small: bool) -> List[Tuple[str, Callable]]:
    """The thirteen programs of ``benchmarks/bench_pallas.py:_cases``: every
    Polybench, stencil and image workload plus one conv nest, at sizes the
    sequential parts of the serving path keep tractable."""
    n = 16 if small else 32
    m = 12 if small else 20
    return [
        ("gemm", lambda: gemm(n)),
        ("bicg", lambda: bicg(n)),
        ("gesummv", lambda: gesummv(n)),
        ("2mm", lambda: mm2(n)),
        ("3mm", lambda: mm3(n)),
        ("jacobi1d", lambda: jacobi1d(3 * n, 4)),
        ("jacobi2d", lambda: jacobi2d(m, 3)),
        ("heat1d", lambda: heat1d(3 * n, 4)),
        ("seidel", lambda: seidel(m, 3)),
        ("edge_detect", lambda: edge_detect(m)),
        ("gaussian", lambda: gaussian(m)),
        ("blur", lambda: blur(m)),
        ("conv", lambda: conv_nest("conv", 8, 4, 6, 6)),
    ]


def default_cases() -> List[Tuple[str, Callable]]:
    """The same thirteen programs at the builders' default sizes (n 4096;
    jacobi1d/heat1d 4096 x 100 steps; jacobi2d/seidel 1024 x 10 steps), the
    conv nest at ResNet-18's (128, 128, 64) layer."""
    return [
        ("gemm", gemm), ("bicg", bicg), ("gesummv", gesummv), ("2mm", mm2),
        ("3mm", mm3), ("jacobi1d", jacobi1d), ("jacobi2d", jacobi2d),
        ("heat1d", heat1d), ("seidel", seidel), ("edge_detect", edge_detect),
        ("gaussian", gaussian), ("blur", blur),
        ("conv", lambda: conv_nest("conv", 128, 128, 64, 64)),
    ]
