"""The port's dense model against the JAX package's, on the same weights.

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
from repro_torch.models import Model, decode_step, forward, init_cache, init_params
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


@pytest.mark.parametrize("arch", ["smollm_360m", "starcoder2_7b", "musicgen_large",
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


@pytest.mark.parametrize("arch", ["granite_moe_1b", "zamba2_1_2b", "xlstm_1_3b"])
def test_other_families_not_ported(arch):
    cfg = reduced(get_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        init_cache(cfg, 1, 8, device="cpu")


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = reduced(get_config("smollm_360m"))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)


def test_port_imports_neither_jax_nor_repro():
    """Importing every module of the port leaves jax and repro.* unloaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "from repro_torch.configs import all_configs; all_configs()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert len(mods) >= 20, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
