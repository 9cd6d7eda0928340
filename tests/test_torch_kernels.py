"""The port's LM kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; they are
compared with the Pallas kernels in interpret mode on the same numpy inputs.
Tests marked ``gpu`` hold the CUDA kernels against the plain versions on
the card and skip on a host without one.  JAX is imported inside the tests
that use it, so the ``gpu`` tests also run where JAX is not installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.cost_model import H100
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import grouped_matmul as gmm_mod
from repro_torch.kernels import matmul_pom as matmul_mod
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssm_scan as scan_mod
from repro_torch.kernels import stencil as stencil_mod


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-4, atol=2e-4)


def _pair(a: np.ndarray, dtype: str):
    """The same numpy data as a JAX array and a torch CPU tensor of ``dtype``."""
    import jax.numpy as jnp
    tt = torch.from_numpy(a).to(getattr(torch, dtype))
    return jnp.asarray(a, getattr(jnp, dtype)), tt


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# --------------------------------------------------------------------------
# flash attention: port (CPU) vs Pallas interpret
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_flash_matches_pallas(hq, hkv, causal, dtype):
    from repro.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(hq * 10 + hkv + causal)
    b, s, d = 2, 128, 32
    q, tq = _pair(rng.normal(size=(b, hq, s, d)).astype(np.float32), dtype)
    k, tk = _pair(rng.normal(size=(b, hkv, s, d)).astype(np.float32), dtype)
    v, tv = _pair(rng.normal(size=(b, hkv, s, d)).astype(np.float32), dtype)
    want = flash_attention(q, k, v, causal=causal, bq=64, bkv=64, interpret=True)
    got = ops.attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_suffix_matches_pallas(dtype):
    """Sq < Skv: the causal mask is offset by Skv - Sq (prefill continuation)."""
    from repro.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(7)
    q, tq = _pair(rng.normal(size=(1, 4, 64, 32)).astype(np.float32), dtype)
    k, tk = _pair(rng.normal(size=(1, 2, 192, 32)).astype(np.float32), dtype)
    v, tv = _pair(rng.normal(size=(1, 2, 192, 32)).astype(np.float32), dtype)
    want = flash_attention(q, k, v, causal=True, bq=64, bkv=64, interpret=True)
    got = ops.attention(tq, tk, tv, causal=True, schedule="naive")
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_flash_row_without_keys_is_zero():
    """Sq > Skv leaves the first causal rows with no visible key: 0, not NaN."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.normal(size=(1, 2, 8, 32)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(1, 2, 4, 32)).astype(np.float32))
    out = ops.attention(q, kv, kv, causal=True)
    assert torch.all(out[:, :, :4] == 0)
    assert torch.isfinite(out).all() and torch.any(out[:, :, 4:] != 0)


# --------------------------------------------------------------------------
# decode attention: port (CPU) vs Pallas interpret
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_decode_matches_pallas(hq, hkv, dtype):
    import jax.numpy as jnp
    from repro.kernels.decode_attention import decode_attention
    rng = np.random.default_rng(hq * 3 + hkv)
    b, s, d = 3, 128, 32
    q, tq = _pair(rng.normal(size=(b, hq, d)).astype(np.float32), dtype)
    k, tk = _pair(rng.normal(size=(b, hkv, s, d)).astype(np.float32), dtype)
    v, tv = _pair(rng.normal(size=(b, hkv, s, d)).astype(np.float32), dtype)
    length = np.array([1, 77, 128], np.int32)        # ragged, never 0
    want = decode_attention(q, k, v, length=jnp.asarray(length), bkv=64, interpret=True)
    got = ops.decode_attention(tq, tk, tv, length=torch.from_numpy(length))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_decode_ragged_s200_matches_jax_ref():
    """S = 200 is no multiple of a KV block: the Pallas kernel asserts there,
    so the JAX package's pure-jnp reference is the yardstick."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    rng = np.random.default_rng(200)
    q, tq = _pair(rng.normal(size=(2, 4, 32)).astype(np.float32), "float32")
    k, tk = _pair(rng.normal(size=(2, 2, 200, 32)).astype(np.float32), "float32")
    v, tv = _pair(rng.normal(size=(2, 2, 200, 32)).astype(np.float32), "float32")
    length = np.array([13, 200], np.int32)
    want = jref.decode_attention(q, k, v, length=jnp.asarray(length))
    got = ops.decode_attention(tq, tk, tv, length=torch.from_numpy(length))
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_decode_full_cache_matches_jax_ref():
    """length=None attends to the whole cache."""
    from repro.kernels import ref as jref
    rng = np.random.default_rng(5)
    q, tq = _pair(rng.normal(size=(2, 4, 64)).astype(np.float32), "float32")
    k, tk = _pair(rng.normal(size=(2, 4, 96, 64)).astype(np.float32), "float32")
    v, tv = _pair(rng.normal(size=(2, 4, 96, 64)).astype(np.float32), "float32")
    np.testing.assert_allclose(_np(ops.decode_attention(tq, tk, tv)),
                               _np(jref.decode_attention(q, k, v)), rtol=2e-4, atol=2e-4)


def test_decode_length_zero_is_zero():
    """No valid key: the port returns 0 (JAX's ref returns NaN here)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 4, 32)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(2, 2, 16, 32)).astype(np.float32))
    out = ops.decode_attention(q, kv, kv, length=torch.tensor([0, 5], dtype=torch.int32))
    assert torch.all(out[0] == 0) and torch.isfinite(out).all()


def _split_decode(q, k, v, length, splits):
    """The split-KV kernel's algebra in plain PyTorch (f32): for each batch
    row, CTA r of ``splits`` takes [r c, min((r + 1) c, length)) of the valid
    prefix (c = ceil(length / splits)) and keeps (m, l, acc) of its slice
    (m = -inf, l = 0, acc = 0 when the slice is empty); the partials merge
    in split order, each weighted by exp(m_r - max m).  A row with no valid
    key gives 0."""
    import math
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    kr = k.float().repeat_interleave(hq // hkv, dim=1)
    vr = v.float().repeat_interleave(hq // hkv, dim=1)
    scores = torch.einsum("bhd,bhkd->bhk", q.float(), kr) / math.sqrt(d)
    out = torch.zeros(b, hq, d)
    for bi in range(b):
        n = min(max(int(length[bi]), 0), s)
        c = -(-n // splits)
        ms, ls, accs = [], [], []
        for r in range(splits):
            lo = min(r * c, n)
            hi = min(lo + c, n)
            sc = scores[bi, :, lo:hi]
            if hi > lo:
                m = sc.max(-1).values
                p = torch.exp(sc - m[:, None])
                ms.append(m)
                ls.append(p.sum(-1))
                accs.append(torch.einsum("hk,hkd->hd", p, vr[bi, :, lo:hi]))
            else:
                ms.append(torch.full((hq,), -math.inf))
                ls.append(torch.zeros(hq))
                accs.append(torch.zeros(hq, d))
        mx = torch.stack(ms).max(0).values
        a, tot = torch.zeros(hq, d), torch.zeros(hq)
        for m, l, acc in zip(ms, ls, accs):          # in split order
            w = torch.where(m == -math.inf, torch.zeros(hq), torch.exp(m - mx))
            a = a + acc * w[:, None]
            tot = tot + l * w
        out[bi] = torch.where(tot[:, None] > 0, a / tot.clamp_min(1e-30)[:, None], 0.0)
    return out.to(q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", range(1, 9))
def test_split_decode_combine_matches_pallas(splits, dtype):
    """Merging per-split (max, sum, acc) partials in split order gives the
    TPU kernel's result for every split count, with ragged lengths whose
    short rows leave splits empty (length 3 at 8 splits fills 3); at length
    0 the port's 0 (the Pallas kernel returns the mean of V there)."""
    import jax.numpy as jnp
    from repro.kernels.decode_attention import decode_attention
    rng = np.random.default_rng(100 + splits)
    b, hq, hkv, s, d = 4, 6, 2, 128, 32
    q, tq = _pair(rng.normal(size=(b, hq, d)).astype(np.float32), dtype)
    k, tk = _pair(rng.normal(size=(b, hkv, s, d)).astype(np.float32), dtype)
    v, tv = _pair(rng.normal(size=(b, hkv, s, d)).astype(np.float32), dtype)
    length = np.array([0, 3, 77, 128], np.int32)
    want = decode_attention(q, k, v, length=jnp.asarray(length), bkv=64, interpret=True)
    got = _split_decode(tq, tk, tv, torch.from_numpy(length), splits)
    assert got.dtype == tq.dtype
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got)[1:], _np(want)[1:], **tol)
    assert torch.all(got[0] == 0)


def test_cpu_path_does_not_count_launches():
    before = (decode_mod.launches, flash_mod.launches)
    q = torch.zeros(1, 2, 32)
    kv = torch.zeros(1, 2, 8, 32)
    ops.decode_attention(q, kv, kv)
    ops.attention(q[:, :, None, :], kv, kv)
    assert (decode_mod.launches, flash_mod.launches) == before


def test_bad_schedule_raises():
    q = torch.zeros(1, 2, 4, 32)
    with pytest.raises(ValueError):
        ops.attention(q, q, q, schedule="fast")
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, :, 0], q, q, schedule="fast")


# --------------------------------------------------------------------------
# grouped matmul: port (CPU) vs Pallas interpret and JAX ref
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,cap,d,f", [(4, 64, 32, 48), (8, 128, 64, 64), (32, 8, 128, 64)])
def test_grouped_matmul_matches_pallas(e, cap, d, f, dtype):
    from repro.kernels import ref as jref
    from repro.kernels.grouped_matmul import grouped_matmul
    rng = np.random.default_rng(e * cap + d)
    x, tx = _pair(rng.normal(size=(e, cap, d)).astype(np.float32), dtype)
    w, tw = _pair((rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32), dtype)
    want = grouped_matmul(x, w, bm=min(32, cap), bn=16, bk=16, interpret=True)
    got = ops.grouped_matmul(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (e, cap, f)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(jref.grouped_matmul(x, w)), **_tol(dtype))


@pytest.mark.parametrize("e,cap,d,f", [(3, 37, 100, 70), (2, 320, 128, 256)])
def test_grouped_matmul_ragged_matches_jax_ref(e, cap, d, f):
    """Capacities and widths no block divides (the port's kernel masks)."""
    from repro.kernels import ref as jref
    rng = np.random.default_rng(cap)
    x, tx = _pair(rng.normal(size=(e, cap, d)).astype(np.float32), "float32")
    w, tw = _pair(rng.normal(size=(e, d, f)).astype(np.float32), "float32")
    np.testing.assert_allclose(_np(ops.grouped_matmul(tx, tw, schedule="naive")),
                               _np(jref.grouped_matmul(x, w)), rtol=1e-4, atol=1e-4)


def test_grouped_matmul_reference_fault_at_cap_320():
    """ROADMAP Queue 3: the JAX Pallas grouped_matmul asserts cap % bm == 0
    with bm = min(128, cap), so cap 320 raises; the port's op returns the
    einsum."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    rng = np.random.default_rng(320)
    xa = rng.normal(size=(2, 320, 128)).astype(np.float32)
    wa = rng.normal(size=(2, 128, 256)).astype(np.float32)
    with pytest.raises(AssertionError):
        jops.grouped_matmul(jnp.asarray(xa), jnp.asarray(wa), impl="pallas")
    got = ops.grouped_matmul(torch.from_numpy(xa), torch.from_numpy(wa))
    np.testing.assert_allclose(got.numpy(), np.einsum("ecd,edf->ecf", xa, wa),
                               rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# ssm scan: port (CPU) vs Pallas interpret and JAX ref
# --------------------------------------------------------------------------
def _scan_np(b, s, h, p, n, seed, broadcast=False):
    rng = np.random.default_rng(seed)
    hb = 1 if broadcast else h
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    a = rng.uniform(0.5, 1.0, size=(b, s, h)).astype(np.float32)
    bm = np.broadcast_to(rng.normal(size=(b, s, hb, n)), (b, s, h, n)).astype(np.float32)
    cm = np.broadcast_to(rng.normal(size=(b, s, hb, n)), (b, s, h, n)).astype(np.float32)
    return x, a, bm, cm


def _torch_scan_args(x, a, bm, cm, broadcast):
    """torch tensors of the numpy inputs; a broadcast group stays a stride-0
    view over the heads, as in the port's Mamba2 block."""
    tb, tc = torch.from_numpy(np.ascontiguousarray(bm)), torch.from_numpy(np.ascontiguousarray(cm))
    if broadcast:
        tb = tb[:, :, :1].expand(tb.shape)
        tc = tc[:, :, :1].expand(tc.shape)
    return torch.from_numpy(x), torch.from_numpy(a), tb, tc


@pytest.mark.parametrize("s,p,n,chunk,broadcast", [(128, 16, 8, 32, False),
                                                   (256, 32, 16, 64, True),
                                                   (128, 1, 32, 64, False)])
def test_ssm_scan_matches_pallas(s, p, n, chunk, broadcast):
    """Tolerance rtol/atol 2e-3 against the chunked kernel, as
    tests/test_kernels.py uses (chunked and sequential sums differ)."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.ssm_scan import ssm_scan
    x, a, bm, cm = _scan_np(2, s, 3, p, n, s + p, broadcast)
    want_y, want_h = ssm_scan(*(jnp.asarray(v) for v in (x, a, bm, cm)), chunk=chunk,
                              interpret=True)
    y, hl = ops.ssm_scan(*_torch_scan_args(x, a, bm, cm, broadcast))
    assert y.shape == x.shape and hl.shape == (2, 3, n, p) and hl.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(hl.numpy(), np.asarray(want_h), rtol=2e-3, atol=2e-3)
    ry, rh = jref.ssm_scan(*(jnp.asarray(v) for v in (x, a, bm, cm)))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hl.numpy(), np.asarray(rh), rtol=1e-5, atol=1e-5)


def test_ssm_scan_ragged_s_and_h0_match_jax_ref():
    """S = 200 (no chunk divides it: the Pallas kernel asserts) and, in the
    plain version, a carried h0, against the JAX package's sequential
    reference."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    x, a, bm, cm = _scan_np(2, 200, 2, 16, 8, 200)
    h0 = np.random.default_rng(1).normal(size=(2, 2, 8, 16)).astype(np.float32)
    want_y, want_h = jref.ssm_scan(*(jnp.asarray(v) for v in (x, a, bm, cm)),
                                   h0=jnp.asarray(h0))
    y, hl = tref.ssm_scan(*_torch_scan_args(x, a, bm, cm, False), torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hl.numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,p,n,chunk,broadcast", [(128, 16, 8, 64, False),
                                                   (128, 8, 16, 64, True),
                                                   (128, 1, 32, 128, False)])
def test_ssm_scan_chunked_matches_jax_chunked_and_pallas(s, p, n, chunk, broadcast):
    """The port's plain chunked scan (the CUDA kernels' decomposition: chunk
    states, the pass over them, the readout) against the JAX package's
    ``ref.ssm_scan_chunked`` and the Pallas kernel in interpret mode, at S a
    multiple of the chunk (which both require); rtol/atol 2e-3, as
    test_ssm_scan_matches_pallas (sums in another order)."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.ssm_scan import ssm_scan
    x, a, bm, cm = _scan_np(2, s, 2, p, n, s + p + n, broadcast)
    jargs = [jnp.asarray(v) for v in (x, a, bm, cm)]
    y, hl = tref.ssm_scan_chunked(*_torch_scan_args(x, a, bm, cm, broadcast), chunk=chunk)
    for want_y, want_h in (jref.ssm_scan_chunked(*jargs, chunk=chunk),
                           ssm_scan(*jargs, chunk=chunk, interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(hl.numpy(), np.asarray(want_h), rtol=2e-3, atol=2e-3)


# (B, S, H, P, N, chunk, broadcast): a ragged S, the normaliser's P = 1, a
# broadcast B/C group, S shorter than a chunk, and a carried h0
@pytest.mark.parametrize("b,s,h,p,n,chunk,broadcast,with_h0", [
    (2, 200, 2, 16, 8, 64, False, False), (2, 100, 3, 1, 16, 64, False, False),
    (1, 130, 4, 8, 8, 128, True, False), (1, 7, 2, 5, 6, 64, True, False),
    (2, 90, 2, 4, 8, 64, False, True)])
def test_ssm_scan_chunked_matches_sequential(b, s, h, p, n, chunk, broadcast, with_h0):
    """The plain chunked scan against the port's and the JAX package's
    sequential references on shapes the Pallas kernel refuses (ragged S);
    rtol/atol 1e-4 of values up to ~30 (f32 sums in another order)."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    x, a, bm, cm = _scan_np(b, s, h, p, n, s + h + p, broadcast)
    targs = _torch_scan_args(x, a, bm, cm, broadcast)
    h0 = (np.random.default_rng(3).normal(size=(b, h, n, p)).astype(np.float32)
          if with_h0 else None)
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, hl = tref.ssm_scan_chunked(*targs, th0, chunk=chunk)
    want_y, want_h = tref.ssm_scan(*targs, th0)
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(hl, want_h, rtol=1e-4, atol=1e-4)
    jy, jh = jref.ssm_scan(*(jnp.asarray(v) for v in (x, a, bm, cm)),
                           h0=None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hl.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-4)


def test_ssm_scan_chunked_bf16_x_and_empty_sequence():
    x, a, bm, cm = _scan_np(1, 70, 2, 8, 4, 5)
    tx, ta, tb, tc = _torch_scan_args(x, a, bm, cm, False)
    y, hl = tref.ssm_scan_chunked(tx.bfloat16(), ta, tb, tc)
    want_y, want_h = tref.ssm_scan(tx.bfloat16(), ta, tb, tc)
    assert y.dtype == torch.bfloat16 and hl.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(hl, want_h, rtol=1e-4, atol=1e-4)
    y, hl = tref.ssm_scan_chunked(tx[:, :0], ta[:, :0], tb[:, :0], tc[:, :0])
    assert y.shape == (1, 0, 2, 8) and not hl.any()


def test_ssm_scan_bf16_returns_x_dtype():
    x, a, bm, cm = _scan_np(1, 16, 2, 8, 4, 3)
    tx, ta, tb, tc = _torch_scan_args(x, a, bm, cm, False)
    y, hl = ops.ssm_scan(tx.bfloat16(), ta, tb, tc)
    assert y.dtype == torch.bfloat16 and hl.dtype == torch.float32


def test_cpu_path_of_new_kernels_does_not_count_launches():
    before = (gmm_mod.launches, scan_mod.launches)
    ops.grouped_matmul(torch.zeros(2, 8, 4), torch.zeros(2, 4, 3))
    ops.ssm_scan(torch.zeros(1, 4, 2, 3), torch.ones(1, 4, 2), torch.zeros(1, 4, 2, 5),
                 torch.zeros(1, 4, 2, 5))
    assert (gmm_mod.launches, scan_mod.launches) == before


def test_plain_versions_route_every_op_to_ref():
    x = torch.randn(2, 8, 4)
    w = torch.randn(2, 4, 3)
    with ops.plain_versions():
        assert ops._plain
        with ops.plain_versions():
            pass
        assert ops._plain
        torch.testing.assert_close(ops.grouped_matmul(x, w), tref.grouped_matmul(x, w))
    assert not ops._plain


def test_new_ops_bad_schedule_raises():
    with pytest.raises(ValueError):
        ops.grouped_matmul(torch.zeros(1, 8, 4), torch.zeros(1, 4, 4), schedule="fast")
    with pytest.raises(ValueError):
        ops.ssm_scan(torch.zeros(1, 4, 1, 2), torch.ones(1, 4, 1), torch.zeros(1, 4, 1, 2),
                     torch.zeros(1, 4, 1, 2), schedule="fast")


# --------------------------------------------------------------------------
# matmul and the Jacobi-2D stencil: port (CPU) vs Pallas interpret and JAX ref
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (256, 128, 384), (96, 64, 80),
                                   (128, 256, 128)])
def test_matmul_matches_pallas(m, n, k, dtype):
    from repro.kernels.matmul_pom import matmul
    rng = np.random.default_rng(m + n + k)
    x, tx = _pair(rng.normal(size=(m, k)).astype(np.float32), dtype)
    y, ty = _pair(rng.normal(size=(k, n)).astype(np.float32), dtype)
    want = matmul(x, y, bm=64, bn=64, bk=64, interpret=True)
    got = ops.matmul(tx, ty)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,bm,steps", [(64, 48, 16, 1), (128, 64, 32, 3), (32, 32, 32, 2)])
def test_jacobi2d_matches_pallas(m, n, bm, steps, dtype):
    """f32 within 1e-5; bf16 within 1e-2 (both compute in f32 and round once
    a sweep, so they agree to the bit here)."""
    from repro.kernels.stencil import jacobi2d
    rng = np.random.default_rng(m)
    x, tx = _pair(rng.normal(size=(m, n)).astype(np.float32), dtype)
    want = jacobi2d(x, steps, bm=bm, interpret=True)
    got = ops.jacobi2d(tx, steps)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_jacobi2d_ragged_matches_jax_ref():
    """m = 200 is no multiple of the Pallas kernel's 128-row block: JAX's
    pure-jnp reference is the yardstick."""
    from repro.kernels import ref as jref
    x, tx = _pair(np.random.default_rng(200).normal(size=(200, 64)).astype(np.float32),
                  "float32")
    np.testing.assert_allclose(_np(ops.jacobi2d(tx, 3)), _np(jref.jacobi2d(x, 3)),
                               rtol=1e-5, atol=1e-5)


def test_jacobi2d_reference_fault_at_m_200():
    """ROADMAP Queue 3: the JAX Pallas stencil asserts m % bm == 0 with
    bm = min(128, m), so m = 200 raises; the port's op answers."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    xa = np.random.default_rng(0).normal(size=(200, 64)).astype(np.float32)
    with pytest.raises(AssertionError):
        jops.jacobi2d(jnp.asarray(xa), 1, impl="pallas")
    np.testing.assert_allclose(ops.jacobi2d(torch.from_numpy(xa), 1).numpy(),
                               np.asarray(jref.jacobi2d(jnp.asarray(xa), 1)),
                               rtol=1e-5, atol=1e-5)


def test_jacobi2d_bf16_follows_the_tpu_kernel():
    """In bf16 the port follows the Pallas kernel (f32 math, one rounding a
    sweep), not JAX's ref.jacobi2d (bf16 math), which differs by 2^-7 here."""
    from repro.kernels import ref as jref
    from repro.kernels.stencil import jacobi2d
    x, tx = _pair(np.random.default_rng(0).normal(size=(128, 64)).astype(np.float32),
                  "bfloat16")
    got = _np(ops.jacobi2d(tx, 3))
    np.testing.assert_array_equal(got, _np(jacobi2d(x, 3, interpret=True)))
    assert np.abs(got - _np(jref.jacobi2d(x, 3))).max() == 2.0 ** -7


# (M, N, steps, sweeps a launch, tile): T dividing steps and not, a tile
# larger than the grid, ragged grids, grids too thin for an interior
@pytest.mark.parametrize("m,n,steps,sweeps,tile", [
    (200, 300, 10, 5, (64, 128)), (200, 300, 10, 4, (32, 128)), (130, 260, 7, 7, (128, 128)),
    (100, 77, 7, 3, (32, 128)), (33, 65, 5, 2, (64, 128)), (2, 40, 3, 2, (32, 128)),
    (40, 1, 3, 3, (128, 128))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jacobi2d_blocked_mirror_equals_single_sweeps(m, n, steps, sweeps, tile, dtype):
    """The plain mirror of the multi-sweep kernel (a tile and a halo of T
    cells swept T times a launch, each block on its own) gives the bits of
    ``steps`` single sweeps (``ref.jacobi2d``), in f32 and in bf16 (rounded
    after every sweep)."""
    x = torch.from_numpy(np.random.default_rng(m * n + steps).normal(size=(m, n)).astype(
        np.float32)).to(getattr(torch, dtype))
    got = tref.jacobi2d_blocked(x, steps, sweeps, tile)
    assert got.dtype == x.dtype
    assert torch.equal(got, tref.jacobi2d(x, steps))


@pytest.mark.parametrize("m,n", [(1, 1), (1, 6), (2, 7), (6, 1), (5, 2), (2, 2)])
def test_jacobi2d_tiny_grid_copies(m, n):
    """Below 3 rows or columns every cell is boundary: the sweep copies."""
    x = torch.from_numpy(np.random.default_rng(m * n).normal(size=(m, n)).astype(np.float32))
    torch.testing.assert_close(ops.jacobi2d(x, 4), x, rtol=0, atol=0)


def test_jacobi2d_three_by_three_and_zero_steps():
    x = torch.arange(9, dtype=torch.float32).reshape(3, 3)
    got = ops.jacobi2d(x, 1)
    want = x.clone()
    want[1, 1] = 0.2 * (1 + 7 + 3 + 5 + 4)
    torch.testing.assert_close(got, want)
    assert ops.jacobi2d(x, 0) is x
    assert stencil_mod.jacobi2d(x, 0) is x


def test_cpu_path_of_library_kernels_does_not_count_launches():
    before = (matmul_mod.launches, stencil_mod.launches)
    ops.matmul(torch.zeros(8, 4), torch.zeros(4, 3))
    ops.matmul(torch.zeros(8, 4), torch.zeros(4, 3), schedule="naive")
    ops.jacobi2d(torch.zeros(8, 5), 3)
    assert (matmul_mod.launches, stencil_mod.launches) == before


def test_plain_versions_route_library_ops_to_ref():
    x, y = torch.randn(6, 5), torch.randn(5, 4)
    with ops.plain_versions():
        torch.testing.assert_close(ops.matmul(x, y), tref.matmul(x, y))
        torch.testing.assert_close(ops.jacobi2d(x, 2), tref.jacobi2d(x, 2))
    assert not ops._plain


def test_matmul_bad_schedule_raises():
    with pytest.raises(ValueError):
        ops.matmul(torch.zeros(4, 4), torch.zeros(4, 4), schedule="fast")


@pytest.mark.parametrize("m,n,k,xb", [(4096, 4096, 4096, 2), (4096, 4096, 4096, 4),
                                      (2048, 2560, 960, 2), (1000, 3000, 520, 2),
                                      (96, 64, 80, 4), (1, 1, 1, 4), (0, 8, 8, 2)])
def test_pom_matmul_schedule_returns_kernel_tiles(m, n, k, xb):
    """The schedule's tile is one the kernel of its route compiles, with that
    kernel's footprint (every stage of the ring on the tensor cores)."""
    s = autotune.pom_matmul_schedule(m, n, k, xb)
    assert s.route == autotune.matmul_route(m, n, k, xb)
    if s.route == autotune.TENSOR_CORES:
        assert (s.bm, s.bn, s.bk) in autotune.MATMUL_TC_TILES
        assert s.smem_bytes == autotune.tc_smem_bytes(s.bm, s.bn, s.bk) <= H100.smem_bytes
    elif s.route == autotune.RING:
        assert (s.bm, s.bn, s.bk) == autotune.MATMUL_RING_TILE
        assert s.smem_bytes == autotune.ring_smem_bytes() == 4 * 2 * 16 * 132 * 4
    else:
        assert (s.bm, s.bn, s.bk) in autotune.MATMUL_TILES
        assert s.smem_bytes == autotune.matmul_smem_bytes(s.bm, s.bn, s.bk) <= H100.smem_bytes
    assert autotune.MATMUL_NAIVE in autotune.MATMUL_TILES
    assert autotune.MATMUL_TC_NAIVE in autotune.MATMUL_TC_TILES


# --------------------------------------------------------------------------
# autotuner (POM stage-2 on the H100 model): shared memory and alignment
# --------------------------------------------------------------------------
def test_pom_matmul_schedule_smem_and_alignment():
    s = autotune.pom_matmul_schedule(4096, 4096, 4096, 2)
    assert s.smem_bytes <= H100.smem_bytes
    assert s.bm % 64 == 0 and s.bn % 64 == 0 and s.bk % 16 == 0
    assert s.bm * s.bn <= 32768


def test_pom_attention_schedule_long_context():
    """bf16 at D 128 takes a tensor-core tile; f32 (and a misaligned bf16
    operand) a CUDA-core one, each with its own kernel's footprint."""
    s = autotune.pom_attention_schedule(8192, 8192, 128, 2, True)
    assert s.route == autotune.TENSOR_CORES
    assert s.smem_bytes <= H100.smem_bytes
    assert s.smem_bytes == autotune.flash_tc_smem_bytes(s.bq, s.bkv, 128)
    assert (s.bq, s.bkv) in autotune.FLASH_TC_TILES
    for s in (autotune.pom_attention_schedule(8192, 8192, 128, 4, True),
              autotune.pom_attention_schedule(8192, 8192, 128, 2, True, aligned=False)):
        assert s.route == autotune.CUDA_CORES
        assert s.smem_bytes <= H100.smem_bytes
        assert s.smem_bytes == autotune.flash_smem_bytes(s.bq, s.bkv, 128)
        assert s.bq in autotune.FLASH_BQ and s.bkv in autotune.FLASH_BKV


@pytest.mark.parametrize("d", autotune.HEAD_DIMS)
def test_every_flash_block_size_fits(d):
    for bq in autotune.FLASH_BQ:
        for bkv in autotune.FLASH_BKV:
            assert autotune.flash_smem_bytes(bq, bkv, d) <= H100.smem_bytes


def test_decode_block_sizes_that_fit():
    """Every head_dim and every number of heads a CTA serves (1-8) fits the
    48 KB of static shared memory; a group above 8 is served in chunks of a
    divisor of it (starcoder2_7b's 9 in threes), never more than 8 a CTA."""
    for d in autotune.HEAD_DIMS:
        for heads in range(1, autotune.DECODE_MAX_HEADS + 1):
            assert autotune.decode_smem_bytes(heads, d) <= 48 * 1024
    assert autotune.decode_smem_bytes(8, 128) == 4 * (8 * 8 * 128 + 2 * 8 * 8 + 2 * 8)
    for group in range(1, 17):
        heads = autotune.decode_heads_per_cta(group)
        assert 1 <= heads <= autotune.DECODE_MAX_HEADS and group % heads == 0
        assert heads == group or group > autotune.DECODE_MAX_HEADS
    assert autotune.decode_heads_per_cta(9) == 3
    assert autotune.pom_decode_schedule(8 * 4, 4096, 9, 128, 2).heads == 3


def test_pom_decode_schedule_smollm_shape():
    """smollm_360m's decode at S 1024 (B 8, Hkv 5, group 3, D 64, bf16):
    the 40 (batch, kv head) pairs split four ways fill the 132 SMs; bytes
    bound the kernel."""
    s = autotune.pom_decode_schedule(8 * 5, 1024, 3, 64, 2)
    assert (s.splits, s.heads) == (4, 3)
    assert s.smem_bytes == autotune.decode_smem_bytes(3, 64) <= 48 * 1024
    assert s.terms.dominant == "memory"


# (B x Hkv, group, D, dtype bytes): smollm_360m's, granite_moe_1b's and
# zamba2_1_2b's decode at batch 8, group 8, starcoder2_7b's group 9 (in
# threes), f32 at D 32
DECODE_SHAPES = [(8 * 5, 3, 64, 2), (8 * 8, 2, 64, 2), (8 * 32, 1, 64, 2), (2 * 1, 8, 128, 2),
                 (8 * 4, 9, 128, 2), (3 * 2, 2, 32, 4)]


@pytest.mark.parametrize("s", [1, 7, 33, 128, 1024, 8192])
@pytest.mark.parametrize("bh,group,d,xb", DECODE_SHAPES)
def test_decode_splits_schedule(bh, group, d, xb, s):
    """1 <= splits <= 8; at full length every split of the prefix has rows
    (CTA r of n takes [r c, min((r + 1) c, S)), c = ceil(S / n)); a split
    is never shorter than one pass of the CTA's rows; and wherever a pass a
    split allows, the splits put a CTA on every one of the 132 SMs."""
    sc = autotune.pom_decode_schedule(bh, s, group, d, xb)
    assert 1 <= sc.splits <= autotune.DECODE_MAX_SPLITS
    assert sc.heads == autotune.decode_heads_per_cta(group)
    c = -(-s // sc.splits)
    assert all(r * c < s for r in range(sc.splits))
    rows = autotune.decode_rows_per_pass(d, xb, sc.heads)
    assert sc.splits == 1 or s > (sc.splits - 1) * rows
    ctas = bh * (group // sc.heads) * sc.splits
    if s >= autotune.DECODE_MAX_SPLITS * rows:
        assert ctas >= H100.num_sms or sc.splits == autotune.DECODE_MAX_SPLITS
        assert ctas < H100.num_sms + bh * (group // sc.heads) or sc.splits == 1


def test_cpu_path_takes_any_head_dim():
    """head_dim 96 has no compiled kernel; the CPU path still serves it."""
    rng = np.random.default_rng(96)
    q = torch.from_numpy(rng.normal(size=(1, 2, 8, 96)).astype(np.float32))
    out = ops.attention(q, q, q, causal=True)
    np.testing.assert_allclose(out.numpy(), tref.attention(q, q, q).numpy())
    out = ops.decode_attention(q[:, :, 0], q, q)
    assert out.shape == (1, 2, 96)


def test_pom_scan_schedule_fits():
    """Every compiled (chunk, P tile) pair fits one block, whatever N (the
    kernels stream it); the schedule's footprint is its pair's."""
    for chunk, pt in autotune.SCAN_TILES:
        assert autotune.scan_smem_bytes(chunk, pt) <= H100.smem_bytes
    assert autotune.SCAN_NAIVE in autotune.SCAN_TILES
    s = autotune.pom_scan_schedule(4096, 64, 64, 2)
    assert s.smem_bytes == autotune.scan_smem_bytes(s.chunk, s.p_tile) <= H100.smem_bytes
    assert s.state_bytes == autotune.scan_state_bytes(4096, 64, 64, 1, s.chunk)


# (S, P, N, x bytes, B * H, B/C groups): zamba2 at 2 x 1024 (one group
# broadcast over the heads), xlstm at 2 x 512, the mLSTM normaliser (P 1),
# ragged S, a ragged S at zamba2's widths, a decode-length S
@pytest.mark.parametrize("s,p,n,xb,groups,bcg", [(1024, 128, 64, 2, 64, 2),
                                                 (512, 512, 512, 2, 8, 8),
                                                 (512, 1, 512, 4, 8, 8), (200, 64, 64, 4, 8, 8),
                                                 (170, 128, 64, 2, 64, 2), (1, 16, 16, 4, 1, 1)])
def test_pom_scan_schedule_fits_model_shapes(s, p, n, xb, groups, bcg):
    sc = autotune.pom_scan_schedule(s, p, n, xb, groups, bc_groups=bcg)
    assert (sc.chunk, sc.p_tile) in autotune.SCAN_TILES
    assert sc.smem_bytes == autotune.scan_smem_bytes(sc.chunk, sc.p_tile) <= H100.smem_bytes
    assert sc.state_bytes == autotune.scan_state_bytes(s, p, n, groups, sc.chunk) \
        <= H100.hbm_bytes
    narrowest = min(t for _, t in autotune.SCAN_TILES)
    if p <= narrowest:   # a wider P tile only pads (the normaliser's P = 1)
        assert sc.p_tile == narrowest
    assert sc.terms.compute_s > 0 and sc.terms.memory_s > 0


def test_pom_scan_schedule_splits_xlstm_carry_over_p():
    """xlstm's 512 x 512 f32 state is 1 MiB a (batch, head): the readout and
    the chunk states split it over P tiles, and no footprint depends on N;
    a state whose chunk scratch exceeds the card's memory raises."""
    sc = autotune.pom_scan_schedule(512, 512, 512, 2, 8)
    assert sc.p_tile < 512 and 512 % sc.p_tile == 0
    assert sc.smem_bytes == autotune.scan_smem_bytes(sc.chunk, sc.p_tile)
    assert autotune.pom_scan_schedule(512, 64, 8192, 2, 8).smem_bytes <= H100.smem_bytes
    with pytest.raises(ValueError):
        autotune.pom_scan_schedule(1 << 20, 4096, 4096, 2, 64)


def test_scan_smem_matches_the_source_layout():
    """The footprint is the largest of the kernels' shared-memory layouts in
    csrc/ssm_scan.cu, with the bank-spreading row pitches."""
    assert autotune._pitch(32, 4) == 36 and autotune._pitch(64, 8) == 72
    assert autotune._pitch(8, 8) == 8 and autotune._pitch(128, 8) == 136
    # (chunk 128, P tile 128): the readout (2 x (2 x 128 x 36 + 32 x 136) + 256
    # floats) over the chunk-state kernel (2 x (2 x 32 x 72 + 32 x 136) + 128)
    assert autotune.scan_smem_bytes(128, 128) == 4 * (2 * (2 * 128 * 36 + 32 * 136) + 256)
    # (chunk 64, P tile 128): the readout (2 x (2 x 64 x 36 + 32 x 136) + 128 floats)
    assert autotune.scan_smem_bytes(64, 128) == 4 * (2 * (2 * 64 * 36 + 32 * 136) + 128)
    # every footprint covers the C B^T kernel (2 x 2 x 32 x 36 floats) and the
    # chunk-state kernel (2 x (2 x 32 x 72 + 32 x pitch(P tile)) + chunk floats)
    for c, t in autotune.SCAN_TILES:
        assert autotune.scan_smem_bytes(c, t) >= 4 * max(
            2 * 2 * 32 * 36, 2 * (2 * 32 * 72 + 32 * autotune._pitch(t, 8)) + c)


def _dispatched(source: str, pattern: str) -> set:
    """The integer pairs that ``pattern``'s two groups match in a ``csrc``
    source."""
    import re
    from pathlib import Path
    text = (Path(autotune.__file__).resolve().parent.parent / "csrc" / source).read_text()
    return {(int(a), int(b)) for a, b in re.findall(pattern, text)}


def test_scan_tiles_match_the_source():
    """The schedule picks only pairs that csrc/ssm_scan.cu instantiates."""
    assert _dispatched("ssm_scan.cu", r"SSM_CASE\((\d+), (\d+)\)") == set(autotune.SCAN_TILES)


def test_jacobi_tiles_match_the_source():
    """The multi-sweep tiles are the ones csrc/stencil.cu instantiates."""
    assert _dispatched("stencil.cu", r"launch_sweeps<T, (\d+), (\d+)>\(") == set(autotune.JACOBI_TILES)


# (M, N, steps, x bytes): the paper's 1024^2 x 10, 4096^2 x 10, bf16, the
# ragged 1000 x 777 x 3, a one-sweep call, grids too thin for an interior
@pytest.mark.parametrize("m,n,steps,xb", [(1024, 1024, 10, 4), (4096, 4096, 10, 4),
                                          (1024, 1024, 10, 2), (1000, 777, 3, 4),
                                          (1024, 1024, 1, 4), (2, 40, 3, 4), (40, 1, 3, 2)])
def test_pom_jacobi_schedule_fits(m, n, steps, xb):
    sc = autotune.pom_jacobi_schedule(m, n, steps, xb)
    assert sc.sweeps == min(steps, autotune.JACOBI_MAX_SWEEPS)
    assert sc.launches == -(-steps // sc.sweeps) == len(autotune.jacobi_plan(steps, sc.sweeps))
    if sc.sweeps == 1:
        assert sc.tile == autotune.JACOBI_TILE and sc.smem_bytes == 0
    else:
        assert sc.tile in autotune.JACOBI_TILES
        assert sc.smem_bytes == autotune.jacobi_smem_bytes(sc.tile, sc.sweeps) \
            <= H100.smem_bytes
        assert sc.tile[1] + 2 * sc.sweeps <= autotune.JACOBI_MAX_WIDTH


@pytest.mark.parametrize("n", [1024, 4096])
def test_pom_jacobi_schedule_sweeps_several_a_launch(n):
    """At the paper's 10 sweeps the schedule makes fewer passes over the grid
    than one launch a sweep, and at 1024^2 its grid still covers the SMs."""
    sc = autotune.pom_jacobi_schedule(n, n, 10, 4)
    assert (sc.sweeps, sc.launches) == (10, 1)
    blocks = -(-n // sc.tile[0]) * -(-n // sc.tile[1])
    assert blocks >= H100.num_sms


# (M, N, tile): the wide tile where its grid fills the SMs, else the narrow one
@pytest.mark.parametrize("m,n,tile", [(1024, 1024, (32, 128)), (4096, 4096, (64, 128)),
                                      (1000, 777, (32, 128)), (1056, 1152, (64, 128)),
                                      (1000, 1024, (32, 128))])
def test_pom_jacobi_schedule_tile_fills_the_sms(m, n, tile):
    assert autotune.pom_jacobi_schedule(m, n, 10, 4).tile == tile


def test_pom_jacobi_schedule_caps_sweeps_a_launch():
    sc = autotune.pom_jacobi_schedule(1024, 1024, 40, 4)
    assert sc.sweeps == autotune.JACOBI_MAX_SWEEPS and sc.launches == 3
    assert autotune.jacobi_plan(40, sc.sweeps) == [16, 16, 8]


def test_jacobi_plan_and_footprint():
    assert autotune.jacobi_plan(10, 4) == [4, 4, 2]
    assert autotune.jacobi_plan(10, 10) == [10]
    assert autotune.jacobi_plan(3, 1) == [1, 1, 1]
    assert autotune.jacobi_smem_bytes((64, 128), 5) == 8 * 74 * 138
    # the wide tile's halo stops fitting in one block's shared memory well
    # above the most sweeps a launch
    assert autotune.jacobi_smem_bytes((64, 128), 38) <= H100.smem_bytes
    assert autotune.jacobi_smem_bytes((64, 128), 39) > H100.smem_bytes


def test_pom_gmm_schedule_follows_cap():
    """bf16 at granite's shapes runs on the tensor cores: decode (cap 8) takes
    a 64-row tile whose width leaves E x ceil(f / bn) blocks to fill the SMs,
    the forward's cap 640 a tall one.  On the CUDA cores (f32) the height
    follows cap: 8 rows at decode, 128 at the forward."""
    dec = autotune.pom_gmm_schedule(32, 8, 1024, 512, 2)
    assert dec.route == autotune.TENSOR_CORES and dec.bm == 64
    assert 32 * -(-512 // dec.bn) >= 0.9 * H100.num_sms
    assert autotune.pom_gmm_schedule(32, 640, 1024, 512, 2).bm == 128
    assert autotune.pom_gmm_schedule(32, 8, 1024, 512, 4).bm == 8
    assert autotune.pom_gmm_schedule(32, 640, 1024, 512, 4).bm == 128
    for cap in (8, 24, 100, 320, 640, 1288):
        for xb in (2, 4):
            s = autotune.pom_gmm_schedule(32, cap, 1024, 512, xb)
            tiles = autotune.GMM_TC_TILES if xb == 2 else [
                (bm, autotune.GMM_BN, autotune.GMM_CC_BK[bm]) for bm in autotune.GMM_BM]
            assert (s.bm, s.bn, s.bk) in tiles
            assert s.terms.bound_s > 0


# (M, N, K, bytes, route): 4096^3, smollm's FFN and the ragged library shape
# in bf16 on the tensor cores; K = 70, N = 1, f32 and empty on the CUDA cores
# in bf16 on the tensor cores; f32 with K and N multiples of 4 (4096^3,
# smollm's FFN, the ragged library shape, one row) on the ring; K = 70, N = 1,
# f32 with K or N off a multiple of 4 and empty shapes on the CUDA cores
MATMUL_ROUTES = [(4096, 4096, 4096, 2, "tensor_cores"), (2048, 2560, 960, 2, "tensor_cores"),
                 (1000, 3000, 520, 2, "tensor_cores"), (1, 8, 8, 2, "tensor_cores"),
                 (130, 200, 70, 2, "cuda_cores"), (7, 300, 1, 2, "cuda_cores"),
                 (64, 1, 64, 2, "cuda_cores"), (4096, 4096, 4096, 4, "ring"),
                 (2048, 2560, 960, 4, "ring"), (1000, 3000, 520, 4, "ring"), (1, 4, 4, 4, "ring"),
                 (1000, 3001, 520, 4, "cuda_cores"), (4096, 4096, 4095, 4, "cuda_cores"),
                 (4096, 4097, 4096, 4, "cuda_cores"), (130, 200, 70, 4, "cuda_cores"),
                 (0, 8, 8, 2, "cuda_cores"), (8, 8, 0, 2, "cuda_cores"), (8, 8, 0, 4, "cuda_cores")]


@pytest.mark.parametrize("m,n,k,xb,route", MATMUL_ROUTES)
def test_matmul_route(m, n, k, xb, route):
    """The route of a shape with aligned operands; a misaligned x or y
    takes the CUDA cores (neither TMA nor the ring's 16-byte copies can
    stage it)."""
    assert autotune.matmul_route(m, n, k, xb) == route
    assert autotune.matmul_route(m, n, k, xb, aligned=False) == autotune.CUDA_CORES


# (E, cap, d, f, bytes, route): granite's decode (wi/wg, wo) and forward
# shapes and the tail shapes in bf16 on the tensor cores; d = 500, f = 70
# and f32 on the CUDA cores
GMM_ROUTES = [(32, 8, 1024, 512, 2, "tensor_cores"), (32, 8, 512, 1024, 2, "tensor_cores"),
              (32, 640, 1024, 512, 2, "tensor_cores"), (32, 640, 512, 1024, 2, "tensor_cores"),
              (3, 37, 72, 64, 2, "tensor_cores"), (1, 1000, 520, 64, 2, "tensor_cores"),
              (32, 320, 500, 1000, 2, "cuda_cores"), (4, 37, 100, 70, 2, "cuda_cores"),
              (32, 8, 1024, 512, 4, "cuda_cores"), (0, 8, 64, 64, 2, "cuda_cores")]


@pytest.mark.parametrize("e,cap,d,f,xb,route", GMM_ROUTES)
def test_gmm_route(e, cap, d, f, xb, route):
    assert autotune.gmm_route(e, cap, d, f, xb) == route


@pytest.mark.parametrize("e,cap,d,f,xb,route", GMM_ROUTES)
def test_pom_gmm_schedule_returns_tiles_of_its_route(e, cap, d, f, xb, route):
    """The grouped matmul's tile belongs to its route and fits shared memory
    with every stage of the ring."""
    s = autotune.pom_gmm_schedule(e, cap, d, f, xb)
    assert s.route == route
    if route == autotune.TENSOR_CORES:
        assert (s.bm, s.bn, s.bk) in autotune.GMM_TC_TILES
        assert s.smem_bytes == autotune.tc_smem_bytes(s.bm, s.bn, s.bk)
    else:
        assert s.bm in autotune.GMM_BM and (s.bn, s.bk) == (autotune.GMM_BN,
                                                           autotune.GMM_CC_BK[s.bm])
        assert s.smem_bytes == autotune.gmm_smem_bytes(s.bm)
    assert s.smem_bytes <= H100.smem_bytes


@pytest.mark.parametrize("bm,bn,bk", sorted(set(autotune.MATMUL_TC_TILES
                                                + autotune.GMM_TC_TILES)))
def test_every_tensor_core_tile_fits_with_all_stages(bm, bn, bk):
    """Every stage of the ring fits in a block's shared memory, each stage's
    tiles on a 1024-byte swizzle period, 3 or 4 stages, and three stages
    only where they let two blocks share an SM."""
    stages = autotune.tc_stages(bm, bn, bk)
    smem = autotune.tc_smem_bytes(bm, bn, bk)
    assert stages in (3, 4) and bk == autotune.TC_BK
    assert smem == stages * (bm + bn) * bk * 2 + 1024 + 16 * stages <= H100.smem_bytes
    assert (bm * bk * 2) % 1024 == 0 and (bk * 64 * 2) % 1024 == 0
    if stages == 3:
        assert 2 * (smem + 1024) <= autotune.SMEM_PER_SM


def _tile_instantiations(source: str) -> tuple:
    """The (bm, bn, bk) of the TILE(...) lines of ``dispatch_tc`` in a
    ``csrc`` source."""
    import re
    from pathlib import Path
    text = (Path(autotune.__file__).resolve().parent.parent / "csrc" / source).read_text()
    body = text[text.index("cudaError_t dispatch_tc("):]
    body = body[:body.index("#undef TILE")]
    return tuple(tuple(int(v) for v in t)
                 for t in re.findall(r"^\s*TILE\((\d+), (\d+), (\d+)\)", body, flags=re.M))


def test_tensor_core_tile_sets_match_the_sources():
    assert _tile_instantiations("matmul_pom.cu") == autotune.MATMUL_TC_TILES
    assert _tile_instantiations("grouped_matmul.cu") == autotune.GMM_TC_TILES
    assert autotune.GMM_TC_NAIVE in autotune.GMM_TC_TILES


def test_build_hash_follows_included_headers(tmp_path, monkeypatch):
    """An edited header a source includes gives the library a new name (so
    a stale build is never reused); an unrelated header does not."""
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("int y;\n")
    (tmp_path / "c.cuh").write_text("int z;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [h.name for h in _build.headers(tmp_path / "k.cu")] == ["a.cuh", "b.cuh"]
    before = _build.lib_path("k")
    (tmp_path / "c.cuh").write_text("int w;\n")
    assert _build.lib_path("k") == before
    (tmp_path / "b.cuh").write_text("int y2;\n")
    assert _build.lib_path("k") != before


def test_cpu_path_takes_any_tile_or_route():
    """On the CPU the wrappers return the plain version whatever the tile,
    and count nothing."""
    x, y = torch.randn(16, 8), torch.randn(8, 24)
    before = (matmul_mod.launches_tc, matmul_mod.launches_ring, gmm_mod.launches_tc)
    torch.testing.assert_close(matmul_mod.matmul(x.bfloat16(), y.bfloat16(), bm=128, bn=128,
                                                 bk=64), tref.matmul(x.bfloat16(), y.bfloat16()))
    torch.testing.assert_close(matmul_mod.matmul(x, y, route=autotune.RING), tref.matmul(x, y))
    xe, we = x[None], y[None]
    torch.testing.assert_close(gmm_mod.grouped_matmul(xe, we, tile=(64, 64, 64)),
                               tref.grouped_matmul(xe, we))
    assert (matmul_mod.launches_tc, matmul_mod.launches_ring, gmm_mod.launches_tc) == before


# --------------------------------------------------------------------------
# routes know alignment; every schedule returns a tile of its route
# --------------------------------------------------------------------------
# (Sq, Skv, D, bytes, route): smollm's forward, a ragged and a suffix shape
# and D 128 in bf16 on the tensor cores; D 32, f32 and empty on the CUDA cores
ATTENTION_ROUTES = [(512, 512, 64, 2, "tensor_cores"), (130, 130, 64, 2, "tensor_cores"),
                    (64, 200, 64, 2, "tensor_cores"), (96, 96, 128, 2, "tensor_cores"),
                    (100, 100, 32, 2, "cuda_cores"), (512, 512, 64, 4, "cuda_cores"),
                    (512, 512, 96, 2, "cuda_cores"), (0, 8, 64, 2, "cuda_cores")]


@pytest.mark.parametrize("sq,skv,d,xb,route", ATTENTION_ROUTES)
def test_attention_route(sq, skv, d, xb, route):
    assert autotune.attention_route(sq, skv, d, xb) == route
    assert autotune.attention_route(sq, skv, d, xb, True) == route


@pytest.mark.parametrize("route_fn,args", [
    (autotune.matmul_route, (4096, 4096, 4096, 2)),
    (autotune.matmul_route, (64, 64, 64, 2)),
    (autotune.gmm_route, (32, 8, 1024, 512, 2)),
    (autotune.gmm_route, (32, 640, 1024, 512, 2)),
    (autotune.attention_route, (512, 512, 64, 2)),
    (autotune.attention_route, (96, 96, 128, 2)),
])
def test_misaligned_operand_takes_the_cuda_cores(route_fn, args):
    """A bf16 shape the tensor cores take goes to the CUDA cores when an
    operand is not 16-byte aligned (TMA cannot describe it)."""
    assert route_fn(*args) == autotune.TENSOR_CORES
    assert route_fn(*args, aligned=True) == autotune.TENSOR_CORES
    assert route_fn(*args, aligned=False) == autotune.CUDA_CORES


def _route_tiles(route, tc_tiles, cc_tiles):
    return tc_tiles if route == autotune.TENSOR_CORES else cc_tiles


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("m,n,k,xb", [(4096, 4096, 4096, 2), (2048, 2560, 960, 2),
                                      (64, 64, 64, 2), (130, 200, 70, 2), (4096, 4096, 4096, 4),
                                      (2048, 2560, 960, 4), (1000, 3000, 520, 4),
                                      (1000, 3001, 520, 4), (4096, 4096, 4095, 4)])
def test_matmul_schedule_tile_belongs_to_its_route(m, n, k, xb, aligned):
    """The ring's one tile where its route runs (f32, K and N multiples of
    4, aligned); a CUDA-core tile for the f32 shapes off by one or
    misaligned."""
    s = autotune.pom_matmul_schedule(m, n, k, xb, aligned=aligned)
    assert s.route == autotune.matmul_route(m, n, k, xb, aligned)
    if s.route == autotune.RING:
        assert (s.bm, s.bn, s.bk) == autotune.MATMUL_RING_TILE
        assert xb == 4 and aligned and k % 4 == 0 and n % 4 == 0
    else:
        assert (s.bm, s.bn, s.bk) in _route_tiles(s.route, autotune.MATMUL_TC_TILES,
                                                  autotune.MATMUL_TILES)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("e,cap,d,f,xb", [(32, 8, 1024, 512, 2), (32, 640, 1024, 512, 2),
                                          (4, 37, 100, 70, 2), (32, 8, 1024, 512, 4)])
def test_gmm_schedule_tile_belongs_to_its_route(e, cap, d, f, xb, aligned):
    s = autotune.pom_gmm_schedule(e, cap, d, f, xb, aligned=aligned)
    assert s.route == autotune.gmm_route(e, cap, d, f, xb, aligned)
    cc = tuple((bm, autotune.GMM_BN, autotune.GMM_CC_BK[bm]) for bm in autotune.GMM_BM)
    assert (s.bm, s.bn, s.bk) in _route_tiles(s.route, autotune.GMM_TC_TILES, cc)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sq,skv,d,xb,causal", [(512, 512, 64, 2, True), (1024, 1024, 64, 2, True),
                                                (130, 130, 64, 2, True), (64, 200, 64, 2, True),
                                                (100, 100, 64, 2, False), (96, 96, 128, 2, True),
                                                (100, 100, 32, 2, True), (512, 512, 64, 4, True)])
def test_attention_schedule_tile_belongs_to_its_route(sq, skv, d, xb, causal, aligned):
    s = autotune.pom_attention_schedule(sq, skv, d, xb, causal, aligned=aligned)
    assert s.route == autotune.attention_route(sq, skv, d, xb, aligned)
    if s.route == autotune.TENSOR_CORES:
        assert (s.bq, s.bkv) in autotune.FLASH_TC_TILES
        assert s.smem_bytes == autotune.flash_tc_smem_bytes(s.bq, s.bkv, d)
    else:
        assert s.bq in autotune.FLASH_BQ and s.bkv in autotune.FLASH_BKV
        assert s.smem_bytes == autotune.flash_smem_bytes(s.bq, s.bkv, d)
    assert s.terms.bound_s > 0


def test_flash_tensor_core_tiles_match_the_source():
    """FLASH_TC_TILES is the (kBQ, kBKV) tile of tc::dispatch in
    csrc/flash_attention.cu, and its head dims the ones it launches."""
    import re
    from pathlib import Path
    text = (Path(autotune.__file__).resolve().parent.parent / "csrc" /
            "flash_attention.cu").read_text()
    tc = text[text.index("namespace tc {"):text.index("}  // namespace tc")]
    tile = tuple(int(re.search(rf"constexpr int {name} = (\d+);", tc).group(1))
                 for name in ("kBQ", "kBKV"))
    assert (tile,) == autotune.FLASH_TC_TILES
    body = tc[tc.index("cudaError_t dispatch(int d, int bq, int bkv"):]
    assert "if (bq != kBQ || bkv != kBKV) return cudaErrorInvalidValue;" in body
    dims = tuple(int(d) for d in re.findall(r"if \(d == (\d+)\) return launch<", body))
    assert dims == autotune.FLASH_TC_DIMS
    assert autotune.FLASH_TC_NAIVE in autotune.FLASH_TC_TILES
    assert f"kStages = {autotune.FLASH_TC_STAGES};" in text


@pytest.mark.parametrize("d", autotune.FLASH_TC_DIMS)
def test_every_flash_tensor_core_tile_fits(d):
    """Every tensor-core flash tile fits a block's shared memory at every
    head dim it takes, its tiles on the 1024-byte swizzle period; at D 64
    two blocks share an SM."""
    for bq, bkv in autotune.FLASH_TC_TILES:
        smem = autotune.flash_tc_smem_bytes(bq, bkv, d)
        assert smem <= H100.smem_bytes
        assert (bq * 128) % 1024 == 0 and (bkv * 128) % 1024 == 0
        if d == 64:
            assert 2 * (smem + 1024) <= autotune.SMEM_PER_SM


def test_flash_backward_tiles_match_the_source():
    """FLASH_BWD_TILES is ``BwdTiles`` of csrc/flash_attention_bwd.cu, its
    head dims the ones ``dispatch_d`` launches, and ``flash_bwd_smem_bytes``
    follows the source's two shared-memory layouts."""
    import re
    from pathlib import Path
    text = (Path(autotune.__file__).resolve().parent.parent / "csrc" /
            "flash_attention_bwd.cu").read_text()
    tiles = text[text.index("template <int D> struct BwdTiles {"):]
    tiles = tiles[:tiles.index("};")]

    def val(name, d):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", tiles).group(1)
        m = re.fullmatch(r"D == (\d+) \? (\d+) : (\d+)", expr)
        return int(expr) if m is None else int(m.group(2) if d == int(m.group(1)) else m.group(3))
    dims = tuple(int(d) for d in re.findall(r"case (\d+): return launch<T, ", text))
    assert dims == tuple(sorted(autotune.FLASH_BWD_TILES)) == autotune.HEAD_DIMS
    for d, ((kbq, kbkv), (qbq, qbkv)) in autotune.FLASH_BWD_TILES.items():
        assert (val("kKvBQ", d), val("kKvBKV", d), val("kQBQ", d), val("kQBKV", d)) == \
            (kbq, kbkv, qbq, qbkv)
    assert "return 2 * BKV * (D + 1) + 2 * BQ * (D + 1) + 2 * BKV * (BQ + 1) + 2 * BQ;" in text
    assert "return 2 * BQ * (D + 1) + 2 * BKV * (D + 1) + BQ * (BKV + 1) + 2 * BQ;" in text
    # the tensor-core route: 64-row tiles, pitch D + 8, four tiles and lse, Delta
    assert "constexpr int kRows = 64;" in text and "kPitch = D + 8;" in text
    assert "kSmem = 4 * kTile * 2 + 2 * kRows * 4;" in text
    assert re.findall(r"if \(d == (\d+)\)\s+return static_cast<int>\(tc::launch<", text) == \
        [str(d) for d in autotune.FLASH_TC_DIMS]


@pytest.mark.parametrize("d", autotune.HEAD_DIMS)
def test_flash_backward_tiles_fit(d):
    """Both backward blocks fit a block's shared memory; their tiles split
    over the 16 x 8 threads (rows by 16, columns by 8); at D 64, the
    training shape's, two dK/dV blocks and two dQ blocks share an SM."""
    (kbq, kbkv), (qbq, qbkv) = autotune.FLASH_BWD_TILES[d]
    dkdv, dq = autotune.flash_bwd_smem_bytes(d)
    assert max(dkdv, dq) <= H100.smem_bytes
    assert kbkv % 16 == 0 and kbq % 8 == 0 and qbq % 16 == 0 and qbkv % 8 == 0 and d % 8 == 0
    if d == 64:
        assert 2 * (dkdv + 1024) <= autotune.SMEM_PER_SM
        assert 2 * (dq + 1024) <= autotune.SMEM_PER_SM
    if d in autotune.FLASH_TC_DIMS:
        # the tensor-core blocks: at least two an SM; rows of 16-byte multiples
        assert 2 * (autotune.flash_bwd_tc_smem_bytes(d) + 1024) <= autotune.SMEM_PER_SM
        assert ((d + 8) * 2) % 16 == 0


@pytest.mark.parametrize("op", ["matmul", "grouped_matmul", "jacobi2d", "attention",
                                "decode_attention"])
def test_ops_take_transposed_and_misaligned_operands_on_the_cpu(op):
    """A transposed view and a bf16 view 8 bytes off a 16-byte boundary
    compute on the CPU and match the plain version (on the card the same
    ops copy to contiguous and route the misaligned operand to the CUDA
    cores)."""
    g = torch.Generator().manual_seed(7)
    buf = torch.randn(2 * 64 * 64 + 4, generator=g).bfloat16()
    mis = buf[4:4 + 64 * 64].view(64, 64)
    assert mis.data_ptr() % 16 == 8
    if op == "matmul":
        x = torch.randn(48, 64, generator=g)
        torch.testing.assert_close(ops.matmul(x.t(), x), tref.matmul(x.t().contiguous(), x))
        torch.testing.assert_close(ops.matmul(mis, mis), tref.matmul(mis.clone(), mis.clone()))
    elif op == "grouped_matmul":
        w = torch.randn(2, 40, 24, generator=g)
        torch.testing.assert_close(ops.grouped_matmul(w.transpose(1, 2), w),
                                   tref.grouped_matmul(w.transpose(1, 2).contiguous(), w))
        xm = mis.view(2, 32, 64)
        wm = buf[4 + 64 * 64:4 + 2 * 64 * 64].view(2, 64, 32)
        torch.testing.assert_close(ops.grouped_matmul(xm, wm),
                                   tref.grouped_matmul(xm.clone(), wm.clone()))
    elif op == "jacobi2d":
        x = torch.randn(40, 30, generator=g)
        torch.testing.assert_close(ops.jacobi2d(x.t(), 3), tref.jacobi2d(x.t().contiguous(), 3))
        torch.testing.assert_close(ops.jacobi2d(mis, 2), tref.jacobi2d(mis.clone(), 2))
    elif op == "attention":
        q = torch.randn(1, 16, 2, 64, generator=g).bfloat16().transpose(1, 2)   # (1, 2, 16, 64)
        qm = mis.view(1, 2, 32, 64)
        torch.testing.assert_close(ops.attention(q, q, q), tref.attention(*(q.contiguous(),) * 3))
        torch.testing.assert_close(ops.attention(qm, qm, qm), tref.attention(*(qm.clone(),) * 3))
    else:
        kv = torch.randn(1, 16, 2, 64, generator=g).bfloat16().transpose(1, 2)  # (1, 2, 16, 64)
        q, km = mis[:4].view(1, 4, 64), mis.view(1, 2, 32, 64)
        n = torch.tensor([9], dtype=torch.int32)
        torch.testing.assert_close(ops.decode_attention(q, kv, kv, length=n),
                                   tref.decode_attention(q.clone(), *(kv.contiguous(),) * 2,
                                                         length=n))
        torch.testing.assert_close(ops.decode_attention(q, km, km, length=n),
                                   tref.decode_attention(q.clone(), km.clone(), km.clone(),
                                                         length=n))

# --------------------------------------------------------------------------
# on the card: CUDA kernel vs its plain version
# --------------------------------------------------------------------------
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (B, Hq, Hkv, Sq, Skv, D, causal, dtype); the first row is smollm_360m's
FLASH_CASES = [
    (4, 15, 5, 512, 512, 64, True, "bfloat16"),
    (2, 4, 4, 100, 100, 32, False, "float32"),
    (1, 4, 1, 64, 200, 64, True, "float32"),
    (2, 8, 2, 130, 130, 128, True, "float32"),
    (1, 4, 4, 64, 64, 64, True, "bfloat16"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
def test_gpu_flash_matches_plain(case):
    dev = _cuda()
    b, hq, hkv, sq, skv, d, causal, dtype = case
    g = torch.Generator(device=dev).manual_seed(sq + skv)
    dt = getattr(torch, dtype)
    q = torch.randn(b, hq, sq, d, generator=g, device=dev).to(dt)
    k = torch.randn(b, hkv, skv, d, generator=g, device=dev).to(dt)
    v = torch.randn(b, hkv, skv, d, generator=g, device=dev).to(dt)
    want = tref.attention(q, k, v, causal=causal)
    for bq in autotune.FLASH_BQ:
        for bkv in autotune.FLASH_BKV:
            got = flash_mod.flash_attention(q, k, v, causal=causal, bq=bq, bkv=bkv)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


# (B, Hq, Hkv, Sq, Skv, D, causal, dtype) of the backward: smollm_360m's
# training shape in both dtypes, then ragged Sq and Skv, Sq < Skv, Sq > Skv
# (rows that see no key), groups 1, 2, 4 and 8, non-causal, D 32, 64, 128
FLASH_BWD_CASES = [
    (8, 15, 5, 256, 256, 64, True, "bfloat16"),
    (8, 15, 5, 256, 256, 64, True, "float32"),
    (2, 8, 2, 130, 130, 64, True, "bfloat16"),
    (1, 4, 1, 64, 200, 64, True, "float32"),
    (1, 4, 2, 200, 64, 64, True, "bfloat16"),
    (2, 4, 4, 100, 100, 32, False, "float32"),
    (2, 8, 8, 77, 77, 32, True, "bfloat16"),
    (2, 8, 2, 300, 300, 128, True, "bfloat16"),
    (1, 16, 2, 96, 150, 128, False, "float32"),
]


def _bwd_inputs(case, dev, seed=0):
    b, hq, hkv, sq, skv, d, causal, dtype = case
    g = torch.Generator(device=dev).manual_seed(seed + sq + skv + d)
    dt = getattr(torch, dtype)
    q = torch.randn(b, hq, sq, d, generator=g, device=dev).to(dt)
    k = torch.randn(b, hkv, skv, d, generator=g, device=dev).to(dt)
    v = torch.randn(b, hkv, skv, d, generator=g, device=dev).to(dt)
    do = torch.randn(b, hq, sq, d, generator=g, device=dev).to(dt)
    return q, k, v, do


def _close_of_max(got, want, rel):
    """|got - want| within ``rel`` of the largest |want| (the forward's
    tolerance form: 1e-4 f32, sums in another order; 2e-2 bf16, one
    rounding of the output)."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= rel * max(scale, 1e-30), (err, scale)


def _bwd_rel(dtype):
    return 2e-2 if dtype == "bfloat16" else 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_gpu_flash_backward_matches_plain(case):
    """The backward kernels against ``ref.attention_backward`` on the same
    q, k, v, o, lse and dO, on the route ``attention_route`` picks (the
    tensor cores for bf16 at D 64 and 128) and on the CUDA cores; one
    ``launches_bwd`` a call; a query row that sees no key gets dq 0; a
    second call gives the same bits (no atomics)."""
    dev = _cuda()
    _, _, _, sq, skv, d, causal, dtype = case
    q, k, v, do = _bwd_inputs(case, dev)
    o, lse = flash_mod.flash_attention(q, k, v, causal=causal, return_lse=True)
    want = tref.attention_backward(q, k, v, o, lse, do, causal=causal)
    best = autotune.attention_route(sq, skv, d, q.element_size())
    for route in sorted({best, autotune.CUDA_CORES}):
        n0, ntc = flash_mod.launches_bwd, flash_mod.launches_bwd_tc
        got = flash_mod.flash_attention_backward(q, k, v, o, lse, do, causal=causal, route=route)
        again = flash_mod.flash_attention_backward(q, k, v, o, lse, do, causal=causal,
                                                   route=route)
        torch.cuda.synchronize()
        assert flash_mod.launches_bwd == n0 + 2
        assert flash_mod.launches_bwd_tc == ntc + 2 * (route == autotune.TENSOR_CORES)
        for name, g_, w_, a_ in zip("qkv", got, want, again):
            assert g_.dtype == w_.dtype and g_.shape == w_.shape, (route, name)
            assert torch.isfinite(g_.float()).all(), (route, name)
            _close_of_max(g_, w_, _bwd_rel(dtype))
            assert torch.equal(g_, a_), (route, name)
        if causal and sq > skv:
            assert torch.all(got[0][:, :, :sq - skv] == 0), route


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES + [(1, 4, 2, 200, 64, 64, True, "bfloat16"),
                                                (1, 4, 2, 200, 64, 64, True, "float32")])
def test_gpu_flash_lse_matches_plain(case):
    """lse from both routes (every tile of each) against
    ``ref.attention_lse``: -inf exactly where a row sees no key; the output
    bit-equal with and without the lse pointer."""
    dev = _cuda()
    b, hq, hkv, sq, skv, d, causal, dtype = case
    q, k, v, _ = _bwd_inputs(case, dev, seed=1)
    _, want = tref.attention_lse(q, k, v, causal=causal)
    route = autotune.attention_route(sq, skv, d, q.element_size())
    tiles = [(bq, bkv) for bq in autotune.FLASH_BQ for bkv in autotune.FLASH_BKV
             if d in autotune.HEAD_DIMS]
    if route == autotune.TENSOR_CORES:
        tiles += list(autotune.FLASH_TC_TILES)
    for bq, bkv in tiles:
        o, lse = flash_mod.flash_attention(q, k, v, causal=causal, bq=bq, bkv=bkv,
                                           return_lse=True)
        plain_o = flash_mod.flash_attention(q, k, v, causal=causal, bq=bq, bkv=bkv)
        torch.cuda.synchronize()
        assert torch.equal(o, plain_o), (bq, bkv)
        assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
        none = torch.isinf(want)
        assert torch.equal(torch.isinf(lse), none), (bq, bkv)
        assert torch.all(lse[none] < 0)
        torch.testing.assert_close(lse[~none], want[~none], rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_attention_op_differentiates_through_the_kernels(dtype):
    """``ops.attention`` on inputs that need a gradient runs the forward
    kernel once and the backward kernel once, and its gradients match
    autograd through ``ref.attention`` (f32 arithmetic) on the card: 1e-4 of
    the largest value in f32, 2e-2 in bf16 (the gradients round to bf16)."""
    dev = _cuda()
    case = (2, 8, 2, 130, 130, 64, True, dtype)
    q, k, v, do = _bwd_inputs(case, dev, seed=2)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n0, nb0 = flash_mod.launches, flash_mod.launches_bwd
    o = ops.attention(*leaves, causal=True)
    o.backward(do)
    torch.cuda.synchronize()
    assert (flash_mod.launches - n0, flash_mod.launches_bwd - nb0) == (1, 1)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tref.attention(*plain, causal=True).backward(do)
    for t, r in zip(leaves, plain):
        _close_of_max(t.grad, r.grad, _bwd_rel(dtype))


@pytest.mark.gpu
def test_gpu_flash_gradient_by_finite_differences():
    """``FlashAttention`` in f32 against central differences of its own
    forward kernel: for L = sum(o * w) and a random direction u of q, k or
    v, (L(x + eps u) - L(x - eps u)) / (2 eps) within 1e-2 of |<grad, u>|
    (eps 1e-2: the difference's truncation error is O(eps^2), its f32
    rounding ~1e-7 |L| / eps)."""
    dev = _cuda()
    case = (1, 4, 2, 70, 90, 32, True, "float32")
    q, k, v, w = _bwd_inputs(case, dev, seed=3)
    g = torch.Generator(device=dev).manual_seed(4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (flash_mod.FlashAttention.apply(*leaves, True, None, None, None) * w).sum().backward()
    eps = 1e-2
    for i, t in enumerate((q, k, v)):
        u = torch.randn(t.shape, generator=g, device=dev)
        args = [q, k, v]

        def loss(x):
            args[i] = x
            return (flash_mod.flash_attention(*args, causal=True).double() * w).sum().item()
        fd = (loss(t + eps * u) - loss(t - eps * u)) / (2 * eps)
        an = (leaves[i].grad.double() * u).sum().item()
        assert abs(fd - an) <= 1e-2 * abs(an), (i, fd, an)


@pytest.mark.gpu
def test_gpu_flash_backward_raises_on_unsupported_input():
    dev = _cuda()
    q = torch.zeros(1, 2, 8, 64, device=dev)
    lse = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(ValueError):                # lse of the wrong shape
        flash_mod.flash_attention_backward(q, q, q, q, lse[:, :1], q)
    with pytest.raises(ValueError):                # lse not f32
        flash_mod.flash_attention_backward(q, q, q, q, lse.double(), q)
    with pytest.raises(ValueError):                # dO not contiguous
        flash_mod.flash_attention_backward(q, q, q, q, lse, q.transpose(2, 3))
    with pytest.raises(ValueError):                # o of another dtype
        flash_mod.flash_attention_backward(q, q, q, q.bfloat16(), lse, q)
    q48 = torch.zeros(1, 2, 8, 48, device=dev)     # head_dim 48 is not compiled
    with pytest.raises(ValueError):
        flash_mod.flash_attention_backward(q48, q48, q48, q48, lse, q48)
    with pytest.raises(ValueError):                # f32 has no tensor-core route
        flash_mod.flash_attention_backward(q, q, q, q, lse, q, route=autotune.TENSOR_CORES)
    qb = torch.zeros(2 * 8 * 64 + 4, device=dev, dtype=torch.bfloat16)[4:].view(1, 2, 8, 64)
    with pytest.raises(ValueError):                # 8 bytes off a 16-byte boundary
        flash_mod.flash_attention_backward(qb, qb, qb, qb, lse, qb, route=autotune.TENSOR_CORES)


# (B, Hq, Hkv, S, D, dtype): smollm_360m's, granite_moe_1b's and
# zamba2_1_2b's decode at batch 8 and S 128, 1024 and 8192, then ragged
# shapes, group 4, 8 and 9 (starcoder2_7b's, in chunks of 3 heads), D 32
# and 128, f32
DECODE_CASES = [(8, hq, hkv, s, 64, "bfloat16") for hq, hkv in ((15, 5), (16, 8), (32, 32))
                for s in (128, 1024, 8192)] + [
    (3, 4, 4, 200, 32, "float32"),
    (2, 8, 2, 77, 128, "float32"),
    (2, 4, 1, 300, 64, "float32"),
    (2, 8, 1, 1000, 64, "bfloat16"),
    (2, 36, 4, 300, 128, "bfloat16"),
    (3, 8, 8, 517, 32, "bfloat16"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODE_CASES)
def test_gpu_decode_matches_plain(case):
    """Every split count 1-8 and the schedule's, with ragged lengths (one
    row at length 0, one full), within the bf16 / f32 tolerance of the
    plain version; a second run of each gives the same bits; one launch a
    call."""
    dev = _cuda()
    b, hq, hkv, s, d, dtype = case
    g = torch.Generator(device=dev).manual_seed(s)
    dt = getattr(torch, dtype)
    q = torch.randn(b, hq, d, generator=g, device=dev).to(dt)
    k = torch.randn(b, hkv, s, d, generator=g, device=dev).to(dt)
    v = torch.randn(b, hkv, s, d, generator=g, device=dev).to(dt)
    length = torch.randint(1, s + 1, (b,), generator=g, device=dev, dtype=torch.int32)
    length[0] = 0
    length[-1] = s
    want = tref.decode_attention(q, k, v, length=length)
    for splits in [None, *range(1, autotune.DECODE_MAX_SPLITS + 1)]:
        n0 = decode_mod.launches
        got = decode_mod.decode_attention(q, k, v, length=length, splits=splits)
        again = decode_mod.decode_attention(q, k, v, length=length, splits=splits)
        torch.cuda.synchronize()
        assert decode_mod.launches == n0 + 2
        assert torch.all(got[0] == 0), splits
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
        assert torch.equal(got, again), splits


@pytest.mark.gpu
def test_gpu_wrappers_raise_on_unsupported_input():
    dev = _cuda()
    q = torch.zeros(1, 2, 48, device=dev)          # head_dim 48 is not compiled
    kv = torch.zeros(1, 2, 8, 48, device=dev)
    with pytest.raises(ValueError):
        decode_mod.decode_attention(q, kv, kv)
    q, kv = torch.zeros(1, 4, 64, device=dev), torch.zeros(1, 2, 8, 64, device=dev)
    for splits in (0, 9):
        with pytest.raises(ValueError):
            decode_mod.decode_attention(q, kv, kv, splits=splits)
    buf = torch.zeros(2 * 8 * 64 + 1, device=dev)
    with pytest.raises(ValueError):                # contiguous, 4 bytes off 16
        decode_mod.decode_attention(q, buf[1:].view(1, 2, 8, 64), kv)
    q = torch.zeros(1, 2, 8, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_mod.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 64, 8, device=dev).transpose(2, 3)
    with pytest.raises(ValueError):
        flash_mod.flash_attention(q, q, q)


# (E, cap, d, f, dtype): granite_moe_1b's decode (cap 8) and forward
# (cap 640) shapes, then ragged caps, d and f
GMM_CASES = [
    (32, 8, 1024, 512, "bfloat16"),
    (32, 8, 512, 1024, "bfloat16"),
    (32, 640, 1024, 512, "bfloat16"),
    (32, 320, 512, 1000, "float32"),
    (4, 37, 100, 70, "float32"),
    (3, 130, 64, 129, "bfloat16"),
]


def _gmm_tol(dtype, d):
    """bf16 outputs round once (2^-8 relative of values ~sqrt(d)); f32 sums
    of d products in another order than the plain einsum."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("case", GMM_CASES)
def test_gpu_grouped_matmul_matches_plain(case):
    from repro_torch.kernels import grouped_matmul as gmm_mod
    dev = _cuda()
    e, cap, d, f, dtype = case
    g = torch.Generator(device=dev).manual_seed(cap + d + f)
    dt = getattr(torch, dtype)
    x = torch.randn(e, cap, d, generator=g, device=dev).to(dt)
    w = (torch.randn(e, d, f, generator=g, device=dev) * d ** -0.5).to(dt)
    want = tref.grouped_matmul(x, w)
    for bm in autotune.GMM_BM:
        got = gmm_mod.grouped_matmul(x, w, bm=bm)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **_gmm_tol(dtype, d))


def _scan_inputs(b, s, h, p, n, dtype, dev, seed, broadcast=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=g, device=dev).to(getattr(torch, dtype))
    a = torch.rand(b, s, h, generator=g, device=dev) * 0.5 + 0.5
    hb = 1 if broadcast else h
    bm = torch.randn(b, s, hb, n, generator=g, device=dev) * n ** -0.5
    cm = torch.randn(b, s, hb, n, generator=g, device=dev) * n ** -0.5
    if broadcast:
        bm, cm = bm.expand(b, s, h, n), cm.expand(b, s, h, n)
    return x, a, bm, cm


# (B, S, H, P, N, dtype, broadcast B/C): zamba2's and xlstm's shapes (at a
# reduced S), the mLSTM normaliser's P = 1, ragged S and N, and odd P (a bf16
# x copied element by element, an f32 x and the states in 4-byte units, y
# stored one value at a time; N P odd: the pass one entry a thread)
SCAN_CASES = [
    (2, 256, 32, 128, 64, "bfloat16", True),
    (2, 128, 4, 512, 512, "bfloat16", False),
    (2, 128, 4, 1, 512, "float32", False),
    (2, 200, 4, 48, 40, "float32", False),
    (1, 7, 2, 16, 16, "float32", True),
    (1, 50, 1, 7, 15, "bfloat16", False),
    (1, 70, 3, 5, 20, "float32", False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SCAN_CASES)
def test_gpu_ssm_scan_matches_plain(case):
    from repro_torch.kernels import ssm_scan as scan_mod
    dev = _cuda()
    b, s, h, p, n, dtype, bc = case
    x, a, bm, cm = _scan_inputs(b, s, h, p, n, dtype, dev, s + p, bc)
    want_y, want_h = tref.ssm_scan(x, a, bm, cm)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-3, atol=2e-3)
    for chunk, pt in autotune.SCAN_TILES:
        n0 = scan_mod.launches
        y, hl = scan_mod.ssm_scan(x, a, bm, cm, chunk=chunk, p_tile=pt)
        torch.cuda.synchronize()
        assert scan_mod.launches == n0 + 1
        torch.testing.assert_close(y.float(), want_y.float(), **tol)
        torch.testing.assert_close(hl, want_h, rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
def test_gpu_ssm_scan_takes_strided_a():
    """a as a strided view (the mLSTM's forget gate is a slice of a gate pair)."""
    dev = _cuda()
    x, _, bm, cm = _scan_inputs(2, 100, 4, 32, 16, "float32", dev, 9)
    a = torch.rand(2, 100, 4, 2, device=dev)[..., 1]
    want_y, want_h = tref.ssm_scan(x, a, bm, cm)
    y, hl = scan_mod.ssm_scan(x, a, bm, cm, chunk=64, p_tile=8)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want_y, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(hl, want_h, rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8192, 1000])
def test_gpu_ssm_scan_streams_any_state_width(n):
    """N is streamed in tiles of 64 (no footprint depends on it): a state
    wider than one block's shared memory, and a ragged one, run."""
    dev = _cuda()
    x, a, bm, cm = _scan_inputs(1, 130, 2, 16, n, "float32", dev, n)
    want_y, want_h = tref.ssm_scan(x, a, bm, cm)
    y, hl = ops.ssm_scan(x, a, bm, cm)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want_y, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(hl, want_h, rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
def test_gpu_new_wrappers_raise_on_unsupported_input():
    dev = _cuda()
    x = torch.zeros(2, 8, 4, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        gmm_mod.grouped_matmul(x, x.new_zeros(2, 4, 4))
    with pytest.raises(ValueError):
        gmm_mod.grouped_matmul(torch.zeros(2, 8, 4, device=dev), torch.zeros(2, 5, 4, device=dev))
    with pytest.raises(ValueError):
        gmm_mod.grouped_matmul(torch.zeros(2, 8, 4, device=dev), torch.zeros(2, 4, 4, device=dev),
                               bm=16)
    x, a = torch.zeros(1, 8, 2, 4, device=dev), torch.ones(1, 8, 2, device=dev)
    bm = torch.zeros(1, 8, 2, 16, device=dev)
    with pytest.raises(TypeError):
        scan_mod.ssm_scan(x, a.double(), bm, bm)
    with pytest.raises(ValueError):
        scan_mod.ssm_scan(x, a, bm, bm, chunk=48)
    with pytest.raises(ValueError):
        scan_mod.ssm_scan(x, a, torch.zeros(1, 8, 2, 8192, device=dev),
                          torch.zeros(1, 8, 2, 8192, device=dev), chunk=64, p_tile=16)
    with pytest.raises(ValueError):
        scan_mod.ssm_scan(x, a, bm.transpose(2, 3).contiguous().transpose(2, 3), bm)


# (M, K, N, dtype): 4096^3, smollm_360m's FFN up-projection, ragged shapes,
# K = 1 and a single output
MATMUL_CASES = [
    (4096, 4096, 4096, "bfloat16"),
    (2048, 960, 2560, "bfloat16"),
    (1000, 520, 3000, "float32"),
    (130, 70, 200, "bfloat16"),
    (7, 1, 300, "float32"),
    (1, 33, 1, "float32"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", MATMUL_CASES)
def test_gpu_matmul_matches_plain(case):
    """Every compiled tile, within 1e-4 (f32) or 2e-2 (bf16: one rounding
    of the f32 sum, 2^-8 relative) of the largest |value|."""
    dev = _cuda()
    m, k, n, dtype = case
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    dt = getattr(torch, dtype)
    x = torch.randn(m, k, generator=g, device=dev).to(dt)
    y = torch.randn(k, n, generator=g, device=dev).to(dt)
    want = tref.matmul(x, y).float()
    tol = (2e-2 if dtype == "bfloat16" else 1e-4) * want.abs().max().item()
    route = autotune.matmul_route(m, n, k, x.element_size())
    tc = route == autotune.TENSOR_CORES
    runs = [(t, None) for t in (autotune.MATMUL_TC_TILES if tc else ()) + autotune.MATMUL_TILES]
    if route == autotune.RING:
        runs.append((autotune.MATMUL_RING_TILE, autotune.RING))
    for (bm, bn, bk), r in runs:
        n0, ntc, nr = matmul_mod.launches, matmul_mod.launches_tc, matmul_mod.launches_ring
        got = matmul_mod.matmul(x, y, bm=bm, bn=bn, bk=bk, route=r)
        torch.cuda.synchronize()
        assert matmul_mod.launches == n0 + 1
        assert matmul_mod.launches_tc == ntc + ((bm, bn, bk) in autotune.MATMUL_TC_TILES)
        assert matmul_mod.launches_ring == nr + (r == autotune.RING)
        assert got.dtype == dt and got.shape == (m, n)
        assert (got.float() - want).abs().max().item() <= tol, (bm, bn, bk, r)


# (M, K, N) in f32 on the ring: 4096^3, smollm_360m's FFN up-projection, the
# ragged library shape, a K tail (36 = 2 x 16 + 4) with M and N tails, one row
MATMUL_RING_CASES = [(4096, 4096, 4096), (2048, 960, 2560), (1000, 520, 3000), (130, 36, 200),
                     (1, 4, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", MATMUL_RING_CASES)
def test_gpu_matmul_ring_equals_old_tile_and_contraction(case):
    """ops.matmul takes the ring for f32 with K and N multiples of 4 (one
    launch, counted on the ring).  The ring sums each output in k order in
    one FMA chain from 0, as the CUDA-core tile (128, 128, 16) and the
    contraction's kernels do: the same bits as both (the contraction on the
    same ring where M and N are at least 128), within 1e-4 of the plain
    version."""
    from repro_torch.kernels import contraction as cmod
    from repro_torch.kernels.contraction import ContractionDesc
    dev = _cuda()
    m, k, n = case
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=dev)
    y = torch.randn(k, n, generator=g, device=dev)
    assert autotune.matmul_route(m, n, k, 4) == autotune.RING
    n0, nr = matmul_mod.launches, matmul_mod.launches_ring
    ring = ops.matmul(x, y)
    torch.cuda.synchronize()
    assert (matmul_mod.launches, matmul_mod.launches_ring) == (n0 + 1, nr + 1)
    old = matmul_mod.matmul(x, y, bm=128, bn=128, bk=16)
    torch.cuda.synchronize()
    assert (matmul_mod.launches, matmul_mod.launches_ring) == (n0 + 2, nr + 1)
    assert torch.equal(ring, old)
    d = ContractionDesc((m, n), (k, 0), (0, 1), (n, 1), (k,), (1,), (n,), 0, 0, 0, m * k, k * n,
                        m * n)
    s0 = cmod.launches_strided
    con = cmod.contraction(d, x.reshape(-1), y.reshape(-1), torch.zeros(m * n, device=dev))
    torch.cuda.synchronize()
    assert cmod.launches_strided == s0 + (min(m, n) >= 128)
    assert torch.equal(ring, con.view(m, n))
    want = tref.matmul(x, y)
    assert (ring - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.gpu
def test_gpu_f32_matmul_off_the_ring_takes_the_cuda_cores():
    """An f32 operand 4 bytes off a 16-byte boundary, N = 3001 and K = 70
    take the CUDA-core tiles through ops.matmul (within 1e-4 of the plain
    version); the ring's route refuses them, and any tile but its own."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3001)
    buf = torch.randn(512 * 512 + 1, generator=g, device=dev)
    xm = buf[1:].view(512, 512)
    assert xm.data_ptr() % 16 == 4
    cases = [(xm, torch.randn(512, 256, generator=g, device=dev)),
             (torch.randn(300, 64, generator=g, device=dev),
              torch.randn(64, 3001, generator=g, device=dev)),
             (torch.randn(200, 70, generator=g, device=dev),
              torch.randn(70, 128, generator=g, device=dev))]
    for x, y in cases:
        n0, nr = matmul_mod.launches, matmul_mod.launches_ring
        got = ops.matmul(x, y)
        torch.cuda.synchronize()
        assert (matmul_mod.launches, matmul_mod.launches_ring) == (n0 + 1, nr)
        want = tref.matmul(x.clone(), y)
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
        with pytest.raises(ValueError):
            matmul_mod.matmul(x, y, route=autotune.RING)
    x, y = torch.zeros(256, 256, device=dev), torch.zeros(256, 256, device=dev)
    with pytest.raises(ValueError):
        matmul_mod.matmul(x, y, bm=64, bn=64, bk=32, route=autotune.RING)
    with pytest.raises(ValueError):
        matmul_mod.matmul(x, y, route="wgmma")


# (M, K, N) in bf16 for the tensor-core tiles: aligned, an M tail (M 1000),
# a K tail (k 520: 8 x 64 + 8), an N tail (200), one row, and K = 8 (one
# stage, mostly TMA zeros)
MATMUL_TC_CASES = [(1024, 1024, 1024), (1000, 520, 3000), (130, 72, 200), (1, 64, 64),
                   (256, 8, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", MATMUL_TC_CASES)
def test_gpu_matmul_tensor_core_tiles_match_plain(case):
    """Every tensor-core tile within 2e-2 of the largest |value| (one bf16
    rounding of an f32 sum), through ops.matmul's route and counted there."""
    dev = _cuda()
    m, k, n = case
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=dev).bfloat16()
    y = torch.randn(k, n, generator=g, device=dev).bfloat16()
    want = tref.matmul(x, y).float()
    tol = 2e-2 * want.abs().max().item()
    assert autotune.matmul_route(m, n, k, 2) == autotune.TENSOR_CORES
    for bm, bn, bk in autotune.MATMUL_TC_TILES:
        got = matmul_mod.matmul(x, y, bm=bm, bn=bn, bk=bk)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == (m, n)
        assert (got.float() - want).abs().max().item() <= tol, (bm, bn, bk)
    for schedule in ("pom", "naive"):
        ntc = matmul_mod.launches_tc
        got = ops.matmul(x, y, schedule=schedule)
        torch.cuda.synchronize()
        assert matmul_mod.launches_tc == ntc + 1
        assert (got.float() - want).abs().max().item() <= tol


# (E, cap, d, f) in bf16 for the tensor-core tiles: granite's decode and
# forward, a cap tail (37), a d tail (72 = 64 + 8) with an f tail, E = 1
GMM_TC_CASES = [(32, 8, 1024, 512), (32, 640, 512, 1024), (3, 37, 256, 128),
                (4, 64, 72, 200), (1, 1000, 520, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GMM_TC_CASES)
def test_gpu_grouped_matmul_tensor_core_tiles_match_plain(case):
    """Every tensor-core tile within 2e-2 of the largest |value|; the
    experts stay apart at every tail (a d tail reading the next expert's
    rows would be far off); ops.grouped_matmul counts a tensor-core launch."""
    dev = _cuda()
    e, cap, d, f = case
    g = torch.Generator(device=dev).manual_seed(e + cap + d + f)
    x = torch.randn(e, cap, d, generator=g, device=dev).bfloat16()
    w = (torch.randn(e, d, f, generator=g, device=dev) * d ** -0.5).bfloat16()
    want = tref.grouped_matmul(x, w).float()
    tol = 2e-2 * want.abs().max().item()
    assert autotune.gmm_route(e, cap, d, f, 2) == autotune.TENSOR_CORES
    for tile in autotune.GMM_TC_TILES:
        got = gmm_mod.grouped_matmul(x, w, tile=tile)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == (e, cap, f)
        assert (got.float() - want).abs().max().item() <= tol, tile
    for schedule in ("pom", "naive"):
        ntc = gmm_mod.launches_tc
        got = ops.grouped_matmul(x, w, schedule=schedule)
        torch.cuda.synchronize()
        assert gmm_mod.launches_tc == ntc + 1
        assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.gpu
def test_gpu_tensor_core_route_raises_where_tma_cannot_describe():
    """A tensor-core tile on a shape or pointer the route does not take
    raises; the same shapes run on the CUDA cores through ops."""
    dev = _cuda()
    x = torch.zeros(64, 70, device=dev, dtype=torch.bfloat16)
    y = torch.zeros(70, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        matmul_mod.matmul(x, y, bm=128, bn=128, bk=64)
    n0, ntc = matmul_mod.launches, matmul_mod.launches_tc
    ops.matmul(x, y)
    assert (matmul_mod.launches, matmul_mod.launches_tc) == (n0 + 1, ntc)
    with pytest.raises(ValueError):
        matmul_mod.matmul(x.float(), y.float(), bm=128, bn=128, bk=64)
    buf = torch.zeros(64 * 64 + 4, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):          # 8-byte offset: contiguous but misaligned
        matmul_mod.matmul(buf[4:].view(64, 64), buf[4:].view(64, 64), bm=128, bn=128, bk=64)
    xe = torch.zeros(2, 8, 500, device=dev, dtype=torch.bfloat16)
    we = torch.zeros(2, 500, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        gmm_mod.grouped_matmul(xe, we, tile=(64, 64, 64))
    with pytest.raises(ValueError):
        gmm_mod.grouped_matmul(xe[:, :, :64].contiguous(), we[:, :64].contiguous(),
                               tile=(64, 64, 32))
    with pytest.raises(ValueError):
        gmm_mod.grouped_matmul(xe, we, bm=8, tile=(64, 64, 64))
    n0, ntc = gmm_mod.launches, gmm_mod.launches_tc
    ops.grouped_matmul(xe, we)
    assert (gmm_mod.launches, gmm_mod.launches_tc) == (n0 + 1, ntc)


# (M, N, steps, dtype): the paper's 1024^2, ragged, tiny grids
JACOBI_CASES = [
    (1024, 1024, 10, "float32"),
    (1000, 777, 3, "float32"),
    (200, 64, 2, "bfloat16"),
    (33, 65, 1, "float32"),
    (2, 40, 3, "float32"),
    (40, 1, 3, "bfloat16"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", JACOBI_CASES)
def test_gpu_jacobi2d_matches_plain(case):
    dev = _cuda()
    m, n, steps, dtype = case
    g = torch.Generator(device=dev).manual_seed(m + n)
    x = torch.randn(m, n, generator=g, device=dev).to(getattr(torch, dtype))
    want = tref.jacobi2d(x, steps)
    n0 = stencil_mod.launches
    got = stencil_mod.jacobi2d(x, steps)
    torch.cuda.synchronize()
    sc = autotune.pom_jacobi_schedule(m, n, steps, x.element_size())
    assert stencil_mod.launches == n0 + sc.launches
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert stencil_mod.jacobi2d(x, 0) is x


# chip_smoke's JACOBI_SHAPES: (M, N, steps, dtype)
JACOBI_SMOKE_SHAPES = [(1024, 1024, 10, "float32"), (4096, 4096, 10, "float32"),
                       (1024, 1024, 10, "bfloat16"), (1000, 777, 3, "float32")]


@pytest.mark.gpu
@pytest.mark.parametrize("case", JACOBI_SMOKE_SHAPES)
def test_gpu_jacobi2d_sweeps_equal_single_sweeps(case):
    """The multi-sweep kernel, at every T from 1 to steps and every tile, gives
    the bits of ``steps`` launches of the single-sweep kernel, in
    ceil(steps / T) launches."""
    dev = _cuda()
    m, n, steps, dtype = case
    g = torch.Generator(device=dev).manual_seed(m + steps)
    x = torch.randn(m, n, generator=g, device=dev).to(getattr(torch, dtype))
    single = stencil_mod.jacobi2d(x, steps, sweeps=1)
    for t in range(2, steps + 1):
        for tile in autotune.JACOBI_TILES:
            n0 = stencil_mod.launches
            got = stencil_mod.jacobi2d(x, steps, sweeps=t, tile=tile)
            torch.cuda.synchronize()
            assert stencil_mod.launches == n0 + -(-steps // t)
            assert torch.equal(got, single), (t, tile)


@pytest.mark.gpu
def test_gpu_library_wrappers_raise_on_unsupported_input():
    dev = _cuda()
    x = torch.zeros(8, 4, device=dev)
    with pytest.raises(TypeError):
        matmul_mod.matmul(x.half(), torch.zeros(4, 4, device=dev).half())
    with pytest.raises(TypeError):
        matmul_mod.matmul(x, torch.zeros(4, 4, device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        matmul_mod.matmul(x, torch.zeros(4, 4, device=dev).t())
    with pytest.raises(ValueError):
        matmul_mod.matmul(x, torch.zeros(4, 4))
    with pytest.raises(ValueError):
        matmul_mod.matmul(x, torch.zeros(5, 4, device=dev))
    with pytest.raises(ValueError):
        matmul_mod.matmul(x, torch.zeros(4, 4, device=dev), bm=32, bn=32, bk=32)
    with pytest.raises(ValueError):
        stencil_mod.jacobi2d(torch.zeros(2, 8, 8, device=dev))
    with pytest.raises(TypeError):
        stencil_mod.jacobi2d(x.half())
    with pytest.raises(ValueError):
        stencil_mod.jacobi2d(torch.zeros(8, 16, device=dev)[:, ::2])
    with pytest.raises(ValueError):
        stencil_mod.jacobi2d(x, -1)
    with pytest.raises(ValueError):
        stencil_mod.jacobi2d(x, 30, sweeps=30, tile=(128, 128))
    with pytest.raises(ValueError):
        stencil_mod.jacobi2d(x, 4, sweeps=2, tile=(16, 16))


# (B, Hq, Hkv, Sq, Skv, D, causal) in bf16 for the tensor-core flash route:
# smollm_360m's forward, a ragged Sq, Sq < Skv, group 4, group 1,
# non-causal, D 128, D 32 (which the route sends to the CUDA cores), and
# zamba2_1_2b's and granite_moe_1b's forwards
FLASH_TC_CASES = [
    (4, 15, 5, 512, 512, 64, True),
    (2, 4, 4, 130, 130, 64, True),
    (1, 4, 1, 64, 200, 64, True),
    (2, 8, 2, 130, 130, 64, True),
    (1, 4, 4, 96, 96, 64, True),
    (2, 4, 4, 100, 100, 64, False),
    (2, 8, 2, 300, 300, 128, True),
    (2, 4, 4, 130, 130, 32, True),
    (2, 32, 32, 1024, 1024, 64, True),
    (4, 16, 8, 512, 512, 64, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_TC_CASES)
def test_gpu_flash_tensor_core_route_matches_plain(case):
    """Every tensor-core tile against ref.attention (f32 math) within the
    bf16 tolerance, and ops.attention on the route ``attention_route``
    picks, counted in ``launches_tc``."""
    dev = _cuda()
    b, hq, hkv, sq, skv, d, causal = case
    g = torch.Generator(device=dev).manual_seed(sq + skv + d)
    q = torch.randn(b, hq, sq, d, generator=g, device=dev).bfloat16()
    k = torch.randn(b, hkv, skv, d, generator=g, device=dev).bfloat16()
    v = torch.randn(b, hkv, skv, d, generator=g, device=dev).bfloat16()
    want = tref.attention(q, k, v, causal=causal).float()
    tc = autotune.attention_route(sq, skv, d, 2) == autotune.TENSOR_CORES
    assert tc == (d != 32)
    for bq, bkv in autotune.FLASH_TC_TILES if tc else ():
        n0, ntc = flash_mod.launches, flash_mod.launches_tc
        got = flash_mod.flash_attention(q, k, v, causal=causal, bq=bq, bkv=bkv)
        torch.cuda.synchronize()
        assert (flash_mod.launches, flash_mod.launches_tc) == (n0 + 1, ntc + 1)
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        torch.testing.assert_close(got.float(), want, **_tol("bfloat16"))
    for schedule in ("pom", "naive"):
        ntc = flash_mod.launches_tc
        got = ops.attention(q, k, v, causal=causal, schedule=schedule)
        torch.cuda.synchronize()
        assert flash_mod.launches_tc == ntc + tc
        torch.testing.assert_close(got.float(), want, **_tol("bfloat16"))


@pytest.mark.gpu
def test_gpu_flash_tensor_core_row_without_keys_is_zero():
    """Causal Sq 200 > Skv 64: the first 136 query rows see no key and
    return exactly 0 on every tensor-core tile; the rest match the plain
    version."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn(1, 4, 200, 64, generator=g, device=dev).bfloat16()
    k = torch.randn(1, 2, 64, 64, generator=g, device=dev).bfloat16()
    v = torch.randn(1, 2, 64, 64, generator=g, device=dev).bfloat16()
    want = tref.attention(q, k, v, causal=True).float()
    for bq, bkv in autotune.FLASH_TC_TILES:
        got = flash_mod.flash_attention(q, k, v, causal=True, bq=bq, bkv=bkv)
        torch.cuda.synchronize()
        assert torch.all(got[:, :, :136] == 0)
        torch.testing.assert_close(got.float(), want, **_tol("bfloat16"))


@pytest.mark.gpu
def test_gpu_flash_tensor_core_tile_raises_where_tma_cannot_describe():
    """A tensor-core tile on f32, on D 32 or on a misaligned q raises; the
    same inputs run on the CUDA cores through ops."""
    dev = _cuda()
    q = torch.zeros(1, 2, 64, 64, device=dev)
    with pytest.raises(ValueError):
        flash_mod.flash_attention(q, q, q, bq=128, bkv=64)
    q32 = torch.zeros(1, 2, 64, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_mod.flash_attention(q32, q32, q32, bq=128, bkv=64)
    buf = torch.zeros(2 * 64 * 64 + 4, device=dev, dtype=torch.bfloat16)
    qm = buf[4:4 + 2 * 64 * 64].view(1, 2, 64, 64)
    with pytest.raises(ValueError):
        flash_mod.flash_attention(qm, qm, qm, bq=128, bkv=64)
    for x in (q, q32, qm):
        n0, ntc = flash_mod.launches, flash_mod.launches_tc
        ops.attention(x, x, x)
        assert (flash_mod.launches, flash_mod.launches_tc) == (n0 + 1, ntc)


def _misaligned(g, dev, *shape):
    """A bf16 tensor of ``shape``, contiguous, 8 bytes off a 16-byte boundary."""
    n = 1
    for s in shape:
        n *= s
    buf = torch.randn(n + 4, generator=g, device=dev).bfloat16()
    out = buf[4:].view(*shape)
    assert out.data_ptr() % 16 == 8
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["matmul", "grouped_matmul", "jacobi2d", "attention",
                                "decode_attention"])
def test_gpu_ops_take_misaligned_and_transposed_operands(op):
    """The library's public ops compute a misaligned bf16 operand (on the
    CUDA cores: TMA cannot describe it) and a transposed one (copied to
    contiguous) and match their plain versions on the card."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(9)
    if op == "matmul":
        mod = matmul_mod
        xm, ym = _misaligned(g, dev, 64, 64), _misaligned(g, dev, 64, 64)
        xt = torch.randn(128, 96, generator=g, device=dev).bfloat16()
        y = torch.randn(96, 64, generator=g, device=dev).bfloat16()
        runs = [(lambda: ops.matmul(xm, ym), lambda: tref.matmul(xm, ym), 0),
                (lambda: ops.matmul(xt.t(), xt), lambda: tref.matmul(xt.t(), xt), 1),
                (lambda: ops.matmul(y.t().float(), y.float()),
                 lambda: tref.matmul(y.t().float(), y.float()), 0)]
    elif op == "grouped_matmul":
        mod = gmm_mod
        xm, wm = _misaligned(g, dev, 4, 32, 64), _misaligned(g, dev, 4, 64, 64)
        w = torch.randn(4, 64, 128, generator=g, device=dev).bfloat16()
        runs = [(lambda: ops.grouped_matmul(xm, wm), lambda: tref.grouped_matmul(xm, wm), 0),
                (lambda: ops.grouped_matmul(w.transpose(1, 2), w),
                 lambda: tref.grouped_matmul(w.transpose(1, 2), w), 1)]
    elif op == "jacobi2d":
        mod = stencil_mod
        xm = _misaligned(g, dev, 100, 64)
        x = torch.randn(64, 100, generator=g, device=dev)
        runs = [(lambda: ops.jacobi2d(xm, 3), lambda: tref.jacobi2d(xm, 3), None),
                (lambda: ops.jacobi2d(x.t(), 3), lambda: tref.jacobi2d(x.t(), 3), None)]
    elif op == "attention":
        mod = flash_mod
        qm = _misaligned(g, dev, 1, 4, 96, 64)
        qt = torch.randn(1, 96, 4, 64, generator=g, device=dev).bfloat16().transpose(1, 2)
        runs = [(lambda: ops.attention(qm, qm, qm), lambda: tref.attention(qm, qm, qm), 0),
                (lambda: ops.attention(qt, qt, qt), lambda: tref.attention(qt, qt, qt), 1)]
    else:                     # copied to an aligned, contiguous tensor by ops
        mod = decode_mod
        qm, km = _misaligned(g, dev, 2, 4, 64), _misaligned(g, dev, 2, 2, 96, 64)
        kt = torch.randn(2, 96, 2, 64, generator=g, device=dev).bfloat16().transpose(1, 2)
        n = torch.tensor([50, 96], dtype=torch.int32, device=dev)
        runs = [(lambda: ops.decode_attention(qm, km, km, length=n),
                 lambda: tref.decode_attention(qm, km, km, length=n), None),
                (lambda: ops.decode_attention(qm, kt, kt, length=n),
                 lambda: tref.decode_attention(qm, kt, kt, length=n), None)]
    for run, plain, tc in runs:
        n0, ntc = mod.launches, getattr(mod, "launches_tc", 0)
        got = run()
        torch.cuda.synchronize()
        want = plain()
        assert mod.launches > n0
        if tc is not None:
            assert mod.launches_tc == ntc + tc
        scale = want.float().abs().max().item()
        rel = 2e-2 if want.dtype == torch.bfloat16 else 1e-4
        assert got.shape == want.shape and got.dtype == want.dtype
        assert (got.float() - want.float()).abs().max().item() <= rel * max(scale, 1.0)


# --------------------------------------------------------------------------
# on the card: the backward passes of the grouped matmul and the scan
# --------------------------------------------------------------------------
# (E, cap, d, f, dtype): granite_moe_1b's training shapes (8 x 256 tokens:
# cap 640; wi/wg d 1024 -> f 512, wo 512 -> 1024), then ragged ones on the
# CUDA cores (d 100: no TMA row) and in f32
GMM_BWD_CASES = [
    (32, 640, 1024, 512, "bfloat16"),
    (32, 640, 512, 1024, "bfloat16"),
    (4, 40, 100, 70, "bfloat16"),
    (3, 130, 64, 129, "float32"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GMM_BWD_CASES)
def test_gpu_grouped_matmul_backward_matches_plain(case):
    """dX and dW against ``ref.grouped_matmul_backward`` (bf16 one rounding
    of the f32 sum; f32 sums of cap or f products in another order), two
    ``launches_bwd`` a call, on the tensor cores where ``gmm_route`` takes
    both shapes (bf16, every dim a multiple of 8)."""
    dev = _cuda()
    e, cap, d, f, dtype = case
    g = torch.Generator(device=dev).manual_seed(cap + d)
    dt = getattr(torch, dtype)
    x = torch.randn(e, cap, d, generator=g, device=dev).to(dt)
    w = (torch.randn(e, d, f, generator=g, device=dev) * d ** -0.5).to(dt)
    dy = torch.randn(e, cap, f, generator=g, device=dev).to(dt)
    want = tref.grouped_matmul_backward(x, w, dy)
    n0, ntc = gmm_mod.launches_bwd, gmm_mod.launches_bwd_tc
    got = gmm_mod.grouped_matmul_backward(x, w, dy)
    torch.cuda.synchronize()
    tc = all(autotune.gmm_route(e, m, k, n, x.element_size()) == autotune.TENSOR_CORES
             for m, k, n in ((cap, f, d), (d, cap, f)))
    assert gmm_mod.launches_bwd == n0 + 2 and gmm_mod.launches_bwd_tc == ntc + 2 * tc
    for gr, wt, name in zip(got, want, ("dx", "dw")):
        assert gr.dtype == wt.dtype and gr.shape == wt.shape, name
        scale = wt.float().abs().max().item()
        rel = 1e-2 if dtype == "bfloat16" else 1e-4
        assert (gr.float() - wt.float()).abs().max().item() <= rel * scale, name


@pytest.mark.gpu
def test_gpu_grouped_matmul_function_differentiates_through_the_kernels():
    """``ops.grouped_matmul`` under autograd: one forward launch, dX and dW on
    the kernel, against autograd through the plain version."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(8, 64, 128, generator=g, device=dev).bfloat16()
    w = (torch.randn(8, 128, 64, generator=g, device=dev) * 128 ** -0.5).bfloat16()
    dy = torch.randn(8, 64, 64, generator=g, device=dev).bfloat16()
    n0 = (gmm_mod.launches, gmm_mod.launches_bwd)
    leaves = [t.clone().requires_grad_(True) for t in (x, w)]
    ops.grouped_matmul(*leaves).backward(dy)
    torch.cuda.synchronize()
    assert (gmm_mod.launches, gmm_mod.launches_bwd) == (n0[0] + 1, n0[1] + 2)
    want = tref.grouped_matmul_backward(x, w, dy)
    for leaf, wt in zip(leaves, want):
        assert (leaf.grad.float() - wt.float()).abs().max() <= 1e-2 * wt.float().abs().max()


# (B, S, H, P, N, x dtype, broadcast B/C, dh_final): zamba2's and xlstm's
# training shapes (8 x 256), the mLSTM normaliser's (P 1; its role-swapped
# scans have N 1), ragged S and widths, a non-zero dh_final
SCAN_BWD_CASES = [
    (8, 256, 32, 128, 64, "bfloat16", True, False),
    (2, 256, 4, 512, 512, "bfloat16", False, False),
    (2, 256, 4, 1, 512, "float32", False, False),
    (2, 200, 4, 48, 40, "float32", False, True),
    (1, 130, 3, 16, 8, "float32", True, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SCAN_BWD_CASES)
def test_gpu_scan_backward_matches_plain(case):
    """``scan_backward`` on the kernels (its scans counted in
    ``launches_bwd``, the decay gradient in ``launches_da``) against the
    sequential ``ref.ssm_scan_backward``: dx within 1e-2 (a bf16 x: one
    rounding) or 2e-3, db, dc and da within 2e-3 of their largest value
    (split-TF32 products, within a few f32 ulps, over S steps; da through a
    sum over S of differences that nearly cancel)."""
    dev = _cuda()
    b, s, h, p, n, dtype, bc, tail = case
    x, a, bm, cm = _scan_inputs(b, s, h, p, n, dtype, dev, s + p + n, bc)
    g = torch.Generator(device=dev).manual_seed(7)
    dy = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
    dh = torch.randn(b, h, n, p, generator=g, device=dev) if tail else None
    want = tref.ssm_scan_backward(x, a, bm, cm, dy, dh)
    n0 = (scan_mod.launches_bwd, scan_mod.launches_da)
    got = scan_mod.scan_backward(scan_mod._bwd_scan, x, a, bm, cm, dy, dh)
    torch.cuda.synchronize()
    assert (scan_mod.launches_bwd, scan_mod.launches_da) == (n0[0] + 3 + tail, n0[1] + 1)
    for gr, wt, name in zip(got, want, ("dx", "da", "db", "dc")):
        assert gr.dtype == wt.dtype and gr.shape == wt.shape, name
        assert torch.isfinite(gr).all(), name
        rel = 1e-2 if (name == "dx" and dtype == "bfloat16") else 2e-3
        scale = wt.float().abs().max().item()
        assert (gr.float() - wt.float()).abs().max().item() <= rel * scale, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_scan_function_differentiates_through_the_kernels(dtype):
    """``ops.ssm_scan`` under autograd (zamba2's broadcast b and c, as the
    model passes them): one forward call, three backward scans and one
    decay-gradient launch; the gradient of the unexpanded b and c summed
    over the heads, against autograd through the plain version."""
    dev = _cuda()
    x, a, bm, cm = _scan_inputs(2, 130, 8, 32, 16, dtype, dev, 3, True)
    base = [t[:, :, :1].contiguous() for t in (bm, cm)]
    dy = torch.randn(x.shape, device=dev).to(x.dtype)

    def run(plain):
        leaves = [t.clone().requires_grad_(True) for t in (x, a, *base)]
        xb, ab, bb, cb = leaves
        if plain:
            with ops.plain_versions():
                y, _ = ops.ssm_scan(xb, ab, bb.expand(bm.shape), cb.expand(cm.shape))
        else:
            y, _ = ops.ssm_scan(xb, ab, bb.expand(bm.shape), cb.expand(cm.shape))
        y.backward(dy)
        return [t.grad for t in leaves]
    n0 = (scan_mod.launches, scan_mod.launches_bwd, scan_mod.launches_da)
    got = run(False)
    torch.cuda.synchronize()
    assert (scan_mod.launches, scan_mod.launches_bwd, scan_mod.launches_da) == \
        (n0[0] + 1, n0[1] + 3, n0[2] + 1)
    for gr, wt in zip(got, run(True)):
        rel = 1e-2 if gr.dtype == torch.bfloat16 else 2e-3
        assert (gr.float() - wt.float()).abs().max() <= rel * wt.float().abs().max()


@pytest.mark.gpu
def test_gpu_ssm_scan_da_matches_plain():
    """The decay-gradient kernel against ``ref.ssm_scan_da``: strided and
    broadcast c and b, a bias, an a below the floor (0 there), N = 1 and
    odd N (4-byte loads)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(11)
    for bsz, s, h, n, bc in ((8, 256, 32, 64, True), (2, 256, 4, 512, False), (2, 70, 3, 1, False),
                             (1, 1000, 2, 7, False)):
        c, b = (torch.randn(bsz, s, 1 if bc else h, n, generator=g, device=dev).expand(
            bsz, s, h, n) for _ in range(2))
        dc, db = (torch.randn(bsz, s, h, n, generator=g, device=dev) for _ in range(2))
        a = torch.rand(bsz, s, h, 2, generator=g, device=dev)[..., 1] * 0.9 + 0.1
        a[0, 3] = 1e-30
        bias = torch.randn(bsz, h, generator=g, device=dev)
        for bb in (None, bias):
            want = tref.ssm_scan_da(c, dc, b, db, a, bb)
            n0 = scan_mod.launches_da
            got = scan_mod.ssm_scan_da(c, dc, b, db, a, bb)
            torch.cuda.synchronize()
            assert scan_mod.launches_da == n0 + 1
            assert torch.all(got[0, 3] == 0)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())
