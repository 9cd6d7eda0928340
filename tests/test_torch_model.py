"""The port's models (every family) against the JAX package's, on the same weights.

JAX runs on the CPU with ``use_pallas=True``, so its model goes through the
Pallas kernels in interpret mode; the port runs on the CPU, where its
wrappers take the plain PyTorch versions.  The JAX parameters are carried
across with ``from_jax_params``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro_torch.configs import all_configs, get_config, reduced
from repro_torch.models import decode_step, forward, init_cache, init_params
from repro_torch.models.convert import from_jax_params

ROOT = Path(__file__).resolve().parent.parent
F32 = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    """(JAX config, JAX params, port config, port model) of reduced smollm_360m."""
    jcfg = dataclasses.replace(jreduced(jget_config("smollm_360m"), num_kv_heads=2),
                               use_pallas=True)
    tcfg = reduced(get_config("smollm_360m"), num_kv_heads=2)
    jparams = jinit_params(jax.random.key(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, from_jax_params(tree, tcfg, device="cpu")


def test_forward_matches_jax(pair):
    jcfg, jparams, tcfg, model = pair
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 128))
    want, _ = jforward(jparams, jcfg, tokens=jnp.asarray(tokens))
    got, aux = forward(model, tokens=torch.from_numpy(tokens))
    assert got.shape == (2, 128, tcfg.padded_vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert float(got[..., tcfg.vocab_size:].max()) < -1e29
    assert float(aux) == 0.0


def test_embeds_forward_matches_jax(pair):
    """Precomputed embeddings (the audio/vlm frontend path) instead of tokens."""
    jcfg, jparams, tcfg, model = pair
    embeds = np.random.default_rng(7).normal(size=(2, 32, tcfg.d_model)).astype(np.float32)
    want, _ = jforward(jparams, jcfg, embeds=jnp.asarray(embeds))
    got, _ = forward(model, embeds=torch.from_numpy(embeds))
    assert got.shape == (2, 32, tcfg.padded_vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    with pytest.raises(ValueError, match="d_model"):
        forward(model, embeds=torch.zeros(1, 4, tcfg.d_model + 1))


def test_eight_decode_steps_match_jax(pair):
    jcfg, jparams, tcfg, model = pair
    b, max_seq = 2, 64
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (b, 8))
    jcache = jinit_cache(jcfg, b, max_seq)
    tcache = init_cache(tcfg, b, max_seq, device="cpu")
    jstep = jax.jit(lambda p, c, t, q: jdecode_step(p, jcfg, c, t, q))
    for t in range(8):
        pos = np.array([t, t], np.int32)
        jl, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t], jnp.int32), jnp.asarray(pos))
        tl, tcache = decode_step(model, tcache, torch.from_numpy(toks[:, t]),
                                 torch.from_numpy(pos).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **F32)


def test_ragged_positions_match_jax(pair):
    """Rows of one batch at different positions (ragged lengths)."""
    jcfg, jparams, tcfg, model = pair
    b, max_seq = 3, 64
    rng = np.random.default_rng(2)
    jcache = jinit_cache(jcfg, b, max_seq)
    tcache = init_cache(tcfg, b, max_seq, device="cpu")
    jstep = jax.jit(lambda p, c, t, q: jdecode_step(p, jcfg, c, t, q))
    start = np.array([0, 5, 17], np.int32)
    for t in range(4):
        tok = rng.integers(0, tcfg.vocab_size, (b,))
        pos = start + t
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok, jnp.int32), jnp.asarray(pos))
        tl, tcache = decode_step(model, tcache, torch.from_numpy(tok),
                                 torch.from_numpy(pos).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)


def test_prefill_decode_consistency(pair):
    """Teacher-forced decode logits equal the full forward at each position."""
    _, _, tcfg, model = pair
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, tcfg.vocab_size, (1, 8)))
    full, _ = forward(model, tokens=tokens)
    cache = init_cache(tcfg, 1, 16, device="cpu")
    for t in range(8):
        logits, cache = decode_step(model, cache, tokens[:, t], torch.tensor([t]))
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), **F32)


@pytest.mark.parametrize("arch", ["starcoder2_7b", "codeqwen1_5_7b"])
def test_gelu_and_bias_variants_match_jax(arch):
    """Non-gated GeLU MLP (starcoder2) and QKV bias (codeqwen) against JAX."""
    jcfg = jreduced(jget_config(arch), num_layers=2)
    tcfg = reduced(get_config(arch), num_layers=2)
    jparams = jinit_params(jax.random.key(4), jcfg)
    if tcfg.qkv_bias:          # JAX inits biases to 0; make them count
        rng = np.random.default_rng(4)
        for name in ("bq", "bk", "bv"):
            leaf = jparams["blocks"]["attn"][name]
            jparams["blocks"]["attn"][name] = jnp.asarray(
                rng.normal(size=leaf.shape) * 0.1, leaf.dtype)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    tokens = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 16))
    want, _ = jforward(jparams, jcfg, tokens=jnp.asarray(tokens))
    got, _ = forward(model, tokens=torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_bf16_weights_carry_across():
    jcfg = jreduced(jget_config("smollm_360m"), num_layers=1, param_dtype="bfloat16",
                    dtype="bfloat16")
    tcfg = reduced(get_config("smollm_360m"), num_layers=1, param_dtype="bfloat16",
                   dtype="bfloat16")
    jparams = jinit_params(jax.random.key(6), jcfg)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    assert model.embed.tok.dtype == torch.bfloat16
    np.testing.assert_array_equal(model.blocks[0].attn.wq.float().numpy(),
                                  np.asarray(jparams["blocks"]["attn"]["wq"][0], np.float32))


def test_converter_rejects_mismatched_tree(pair):
    jcfg, jparams, tcfg, _ = pair
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    with pytest.raises(ValueError):
        from_jax_params(tree, dataclasses.replace(tcfg, num_layers=2), device="cpu")
    del tree["final_norm"]
    with pytest.raises(KeyError):
        from_jax_params(tree, tcfg, device="cpu")


def test_configs_match_jax():
    ported = all_configs()
    for name, tcfg in ported.items():
        jcfg = jget_config(name)
        for f in dataclasses.fields(tcfg):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), (name, f.name)
        assert tcfg.padded_vocab_size == jcfg.padded_vocab_size
    assert len(ported) == 10


@pytest.mark.parametrize("arch", ["starcoder2_7b", "codeqwen1_5_7b", "smollm_360m",
                                  "qwen2_72b", "musicgen_large", "zamba2_1_2b",
                                  "llama4_maverick_400b", "granite_moe_1b", "xlstm_1_3b",
                                  "phi3_vision_4_2b"])
def test_param_count_matches_jax(arch):
    assert get_config(arch).param_count() == jget_config(arch).param_count()


def test_seeded_init_is_deterministic_and_sized():
    cfg = reduced(get_config("smollm_360m"))
    a = init_params(cfg, seed=3, device="cpu")
    b = init_params(cfg, seed=3, device="cpu")
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), n
    wq = a.blocks[0].attn.wq
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert torch.all(a.final_norm.scale == 1)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = reduced(get_config("smollm_360m"))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)


def test_port_imports_neither_jax_nor_repro():
    """Importing every module of the port leaves jax, repro.* and benchmarks.*
    unloaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "from repro_torch.configs import all_configs; all_configs()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')"
        " or m == 'benchmarks' or m.startswith('benchmarks.')]\n"
        "assert len(mods) >= 56, mods\n"
        "for m in ('models.moe', 'models.mamba2', 'models.xlstm', 'kernels.grouped_matmul',"
        " 'kernels.ssm_scan', 'kernels.matmul_pom', 'kernels.stencil', 'kernels.meta',"
        " 'launch.dryrun', 'distributed.collectives'):"
        " assert 'repro_torch.' + m in mods, m\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr



# --------------------------------------------------------------------------
# the moe, hybrid and ssm families
# --------------------------------------------------------------------------
FAMILY_ARCHS = ["granite_moe_1b", "llama4_maverick_400b", "zamba2_1_2b", "xlstm_1_3b"]


def _family_pair(arch: str, **overrides):
    """(JAX config, JAX params, port config, port model) of a reduced
    ``arch`` on the same weights; JAX runs its Pallas kernels (interpret
    mode) where its models take them.  llama4 keeps a dense layer between
    MoE layers (moe_every 2) and its shared expert."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch), **overrides), use_pallas=True)
    tcfg = reduced(get_config(arch), **overrides)
    jparams = jinit_params(jax.random.key(11), jcfg)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, model


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def family(request):
    return _family_pair(request.param)


def test_family_forward_and_aux_match_jax(family):
    """S 64: the JAX scan takes its Pallas kernel (S % 64 == 0) and the MoE
    capacity (40 at 2 x 64 tokens, top-2 of 4 experts) stays within the
    Pallas grouped matmul's one block."""
    jcfg, jparams, tcfg, model = family
    tokens = np.random.default_rng(20).integers(0, tcfg.vocab_size, (2, 64))
    want, want_aux = jforward(jparams, jcfg, tokens=jnp.asarray(tokens))
    got, aux = forward(model, tokens=torch.from_numpy(tokens))
    assert got.shape == (2, 64, tcfg.padded_vocab_size) and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32)
    assert (float(aux) > 0) == (tcfg.family == "moe")


def _jax_cache_np(cache):
    return jax.tree_util.tree_map(np.asarray, cache)


def _assert_cache_equal(tcache, jcache):
    """Every leaf of the port's cache (nested dicts of tensors) equals the
    JAX cache's leaf of the same path."""
    for name, t in tcache.items():
        if isinstance(t, dict):
            _assert_cache_equal(t, jcache[name])
        else:
            assert tuple(t.shape) == jcache[name].shape, name
            np.testing.assert_allclose(t.numpy(), jcache[name], err_msg=name, **F32)


def test_family_eight_decode_steps_and_cache_match_jax(family):
    jcfg, jparams, tcfg, model = family
    b, max_seq = 2, 16
    toks = np.random.default_rng(21).integers(0, tcfg.vocab_size, (b, 8))
    jcache = jinit_cache(jcfg, b, max_seq)
    tcache = init_cache(tcfg, b, max_seq, device="cpu")
    jstep = jax.jit(lambda p, c, t, q: jdecode_step(p, jcfg, c, t, q))
    for t in range(8):
        pos = np.array([t, t], np.int32)
        jl, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t], jnp.int32), jnp.asarray(pos))
        tl, tcache = decode_step(model, tcache, torch.from_numpy(toks[:, t]),
                                 torch.from_numpy(pos).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    _assert_cache_equal(tcache, _jax_cache_np(jcache))


def test_family_ragged_positions_match_jax(family):
    jcfg, jparams, tcfg, model = family
    b, max_seq = 3, 32
    rng = np.random.default_rng(22)
    jcache = jinit_cache(jcfg, b, max_seq)
    tcache = init_cache(tcfg, b, max_seq, device="cpu")
    jstep = jax.jit(lambda p, c, t, q: jdecode_step(p, jcfg, c, t, q))
    start = np.array([0, 5, 17], np.int32)
    for t in range(4):
        tok = rng.integers(0, tcfg.vocab_size, (b,))
        pos = start + t
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok, jnp.int32), jnp.asarray(pos))
        tl, tcache = decode_step(model, tcache, torch.from_numpy(tok),
                                 torch.from_numpy(pos).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)


def test_family_cache_layouts_match_jax(family):
    jcfg, _, tcfg, _ = family
    jcache = jinit_cache(jcfg, 2, 8)
    tcache = init_cache(tcfg, 2, 8, device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: a.shape, jcache)
    tshapes = {k: ({kk: tuple(vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                   else tuple(v.shape)) for k, v in tcache.items()}
    assert tshapes == jshapes


@pytest.mark.parametrize("arch", ["zamba2_1_2b", "xlstm_1_3b"])
def test_decode_matches_forward_for_recurrent_families(arch):
    """Hybrid and ssm forward equal teacher-forced decode: the chunked scan
    against the recurrent state, over 40 tokens (chunk boundaries, a ragged
    tail)."""
    _, _, tcfg, model = _family_pair(arch)
    tokens = torch.from_numpy(np.random.default_rng(23).integers(0, tcfg.vocab_size, (2, 40)))
    full, _ = forward(model, tokens=tokens)
    cache = init_cache(tcfg, 2, 40, device="cpu")
    for t in range(40):
        logits, cache = decode_step(model, cache, tokens[:, t], torch.tensor([t, t]))
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), **F32)


def test_long_context_decode_matches_jax():
    """Reduced zamba2 against a cache of 131,072 positions filled with
    seeded random values (numpy, the same for both), two decode steps at
    positions 131,070 and 131,071 (RoPE at a long position, the decode
    attention over the whole cache): JAX's ``decode_step`` (its plain
    attention) to the family tolerance, logits and cache."""
    max_seq = 131_072
    jcfg = jreduced(jget_config("zamba2_1_2b"))
    tcfg = reduced(get_config("zamba2_1_2b"))
    jparams = jinit_params(jax.random.key(12), jcfg)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    rng = np.random.default_rng(25)
    host = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32),
        jax.eval_shape(lambda: jinit_cache(jcfg, 1, max_seq)))
    jcache = jax.tree_util.tree_map(jnp.asarray, host)
    tcache = {k: ({kk: torch.from_numpy(vv.copy()) for kk, vv in v.items()})
              for k, v in host.items()}
    jstep = jax.jit(lambda p, c, t, q: jdecode_step(p, jcfg, c, t, q))
    for pos in (max_seq - 2, max_seq - 1):
        tok = rng.integers(0, tcfg.vocab_size, (1,))
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok, jnp.int32),
                           jnp.asarray([pos], jnp.int32))
        tl, tcache = decode_step(model, tcache, torch.from_numpy(tok),
                                 torch.tensor([pos], dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    _assert_cache_equal(tcache, _jax_cache_np(jcache))


def test_moe_forward_equals_decode_only_without_capacity_drops():
    """MoE forward and decode differ by design where the forward's capacity
    drops tokens (decode sees one token a row); with a capacity factor that
    drops nothing they agree."""
    _, _, tcfg, model = _family_pair("granite_moe_1b", capacity_factor=8.0)
    tokens = torch.from_numpy(np.random.default_rng(24).integers(0, tcfg.vocab_size, (2, 16)))
    full, _ = forward(model, tokens=tokens)
    cache = init_cache(tcfg, 2, 16, device="cpu")
    for t in range(16):
        logits, cache = decode_step(model, cache, tokens[:, t], torch.tensor([t, t]))
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), **F32)


def test_moe_dispatch_keeps_the_reference_tokens():
    """Every token's first choice is expert 1, and its second a four-way tie:
    the ties go to the lower expert id (lax.top_k's order), and of the 40
    tokens routed to expert 1 the stable sort keeps the first 32 (the
    capacity), as jnp.argsort does; the other 8 are dropped."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    jcfg, jparams, tcfg, model = _family_pair("granite_moe_1b")
    sub = jparams["blocks"]["l0"]["moe"]
    jp = jax.tree_util.tree_map(lambda a: a[0], sub)
    router = np.zeros_like(np.asarray(jp["router"]))
    router[:, 1] = 10.0                                     # expert 1 for every token
    jp = dict(jp, router=jnp.asarray(router))
    tp = model.blocks[0].l0.moe
    tp.router.copy_(torch.from_numpy(router))
    x = np.random.default_rng(25).normal(size=(1, 40, tcfg.d_model)).astype(np.float32)
    want, waux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(float(aux), float(waux), **F32)
    assert tmoe.capacity(40, tcfg) == 32
