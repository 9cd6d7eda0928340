"""The port's attention kernels against the JAX package's Pallas kernels.

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
from repro_torch.kernels import ref as tref


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
# autotuner (POM stage-2 on the H100 model): shared memory and alignment
# --------------------------------------------------------------------------
def test_pom_matmul_schedule_smem_and_alignment():
    s = autotune.pom_matmul_schedule(4096, 4096, 4096, 2)
    assert s.smem_bytes <= H100.smem_bytes
    assert s.bm % 64 == 0 and s.bn % 64 == 0 and s.bk % 16 == 0
    assert s.bm * s.bn <= 32768


def test_pom_attention_schedule_long_context():
    s = autotune.pom_attention_schedule(8192, 8192, 128, 2, True)
    assert s.smem_bytes <= H100.smem_bytes
    assert s.smem_bytes == autotune.flash_smem_bytes(s.bq, s.bkv, 128)
    assert s.bq in autotune.FLASH_BQ and s.bkv in autotune.FLASH_BKV


@pytest.mark.parametrize("d", autotune.HEAD_DIMS)
def test_every_flash_block_size_fits(d):
    for bq in autotune.FLASH_BQ:
        for bkv in autotune.FLASH_BKV:
            assert autotune.flash_smem_bytes(bq, bkv, d) <= H100.smem_bytes


def test_decode_block_sizes_that_fit():
    """Every head_dim has a decode tile that fits; the largest tile at
    head_dim 128 does not, and the search never picks it."""
    for d in autotune.HEAD_DIMS:
        assert autotune.decode_smem_bytes(8, d, autotune.DECODE_BKV[0]) <= H100.smem_bytes
    assert autotune.decode_smem_bytes(1, 128, 256) > H100.smem_bytes
    assert autotune.pom_decode_schedule(4096, 128, 1).bkv < 256


def test_pom_decode_schedule_smollm_shape():
    s = autotune.pom_decode_schedule(1024, 64, 3, 2)
    assert s.bkv in autotune.DECODE_BKV
    assert s.smem_bytes == autotune.decode_smem_bytes(3, 64, s.bkv) <= H100.smem_bytes
    assert s.terms.dominant == "memory"


def test_cpu_path_takes_any_head_dim():
    """head_dim 96 has no compiled kernel; the CPU path still serves it."""
    rng = np.random.default_rng(96)
    q = torch.from_numpy(rng.normal(size=(1, 2, 8, 96)).astype(np.float32))
    out = ops.attention(q, q, q, causal=True)
    np.testing.assert_allclose(out.numpy(), tref.attention(q, q, q).numpy())
    out = ops.decode_attention(q[:, :, 0], q, q)
    assert out.shape == (1, 2, 96)


def test_pom_scan_schedule_fits():
    s = autotune.pom_scan_schedule(4096, 64, 64, 2)
    assert s.smem_bytes <= H100.smem_bytes and 4096 % s.chunk == 0


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


# (B, Hq, Hkv, S, D, dtype); the first row is smollm_360m's
DECODE_CASES = [
    (8, 15, 5, 1024, 64, "bfloat16"),
    (3, 4, 4, 200, 32, "float32"),
    (2, 8, 2, 77, 128, "float32"),
    (2, 4, 1, 300, 64, "float32"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODE_CASES)
def test_gpu_decode_matches_plain(case):
    dev = _cuda()
    b, hq, hkv, s, d, dtype = case
    g = torch.Generator(device=dev).manual_seed(s)
    dt = getattr(torch, dtype)
    q = torch.randn(b, hq, d, generator=g, device=dev).to(dt)
    k = torch.randn(b, hkv, s, d, generator=g, device=dev).to(dt)
    v = torch.randn(b, hkv, s, d, generator=g, device=dev).to(dt)
    length = torch.randint(1, s + 1, (b,), generator=g, device=dev, dtype=torch.int32)
    length[0] = 0
    want = tref.decode_attention(q, k, v, length=length)
    for bkv in autotune.DECODE_BKV:
        if autotune.decode_smem_bytes(hq // hkv, d, bkv) > H100.smem_bytes:
            continue
        got = decode_mod.decode_attention(q, k, v, length=length, bkv=bkv)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.gpu
def test_gpu_wrappers_raise_on_unsupported_input():
    dev = _cuda()
    q = torch.zeros(1, 2, 48, device=dev)          # head_dim 48 is not compiled
    kv = torch.zeros(1, 2, 8, 48, device=dev)
    with pytest.raises(ValueError):
        decode_mod.decode_attention(q, kv, kv)
    q = torch.zeros(1, 2, 8, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_mod.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 64, 8, device=dev).transpose(2, 3)
    with pytest.raises(ValueError):
        flash_mod.flash_attention(q, q, q)
