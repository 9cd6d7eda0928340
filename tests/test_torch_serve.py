"""The port's serving loop against a JAX loop that mirrors ``repro.launch.serve``.

Both serve the same converted weights and prompts on the CPU; the greedy
tokens must agree, for smollm_360m and for one model of each of the moe,
hybrid and ssm families.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import decode_step as jdecode_step
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve as serve_mod
from repro_torch.models import decode_step, forward, init_cache
from repro_torch.models.convert import from_jax_params


def _jax_serve(params, cfg, prompts: np.ndarray, g: int) -> np.ndarray:
    """The prefill + greedy loop of ``repro/launch/serve.py``, on one device."""
    b, pl = prompts.shape
    cache = jinit_cache(cfg, b, pl + g)
    step = jax.jit(lambda p, c, t, q: jdecode_step(p, cfg, c, t, q))
    prompts = jnp.asarray(prompts, jnp.int32)
    for t in range(pl):
        logits, cache = step(params, cache, prompts[:, t], jnp.full((b,), t, jnp.int32))
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out = [tok]
    for t in range(pl, pl + g - 1):
        logits, cache = step(params, cache, tok, jnp.full((b,), t, jnp.int32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(tok)
    return np.stack([np.asarray(t) for t in out], axis=1)


@pytest.fixture(scope="module")
def served():
    jcfg = jreduced(jget_config("smollm_360m"))
    tcfg = reduced(get_config("smollm_360m"))
    jparams = jinit_params(jax.random.key(0), jcfg)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    prompts = np.random.default_rng(0).integers(0, tcfg.vocab_size, (3, 8))
    return jcfg, jparams, tcfg, model, prompts


def test_greedy_tokens_match_jax(served):
    jcfg, jparams, _, model, prompts = served
    want = _jax_serve(jparams, jcfg, prompts, 8)
    res = serve_mod.serve(model, torch.from_numpy(prompts), 8)
    assert res.tokens.shape == (3, 8)
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    assert res.prefill_s > 0 and res.decode_s > 0


def test_kept_logits_match_forward(served):
    """The served logits at the prompt positions equal the full forward."""
    _, _, tcfg, model, prompts = served
    res = serve_mod.serve(model, torch.from_numpy(prompts), 4, keep_logits=True)
    assert res.logits.shape == (3, 8 + 4 - 1, tcfg.padded_vocab_size)
    full, _ = forward(model, tokens=torch.from_numpy(prompts))
    np.testing.assert_allclose(res.logits[:, :8].numpy(), full.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(res.logits[:, 7:].argmax(-1).numpy(), res.tokens.numpy())


def test_decode_step_writes_cache_in_place(served):
    _, _, tcfg, model, prompts = served
    cache = init_cache(tcfg, 3, 4, device="cpu")
    k_before = cache["k"]
    _, out = decode_step(model, cache, torch.from_numpy(prompts[:, 0]), torch.zeros(3).long())
    assert out["k"] is k_before
    assert torch.count_nonzero(k_before[:, :, :, 0]) > 0
    assert torch.count_nonzero(k_before[:, :, :, 1:]) == 0


def test_main_cpu_reduced(capsys):
    res = serve_mod.main(["--reduced", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "4", "--gen", "3"])
    assert res.tokens.shape == (2, 3)
    out = capsys.readouterr().out
    assert "arch=smollm_360m" in out and "decode:" in out


def test_main_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.main(["--reduced", "--batch", "1", "--prompt-len", "2", "--gen", "2"])


def test_full_width_on_cuda_is_the_default():
    """The JAX server's --reduced can never be off; the port's is off by default."""
    args = serve_mod.build_parser().parse_args([])
    assert args.reduced is False and args.device == "cuda"
    assert serve_mod.build_parser().parse_args(["--reduced"]).reduced is True



@pytest.mark.parametrize("arch", ["granite_moe_1b", "zamba2_1_2b", "xlstm_1_3b"])
def test_family_greedy_tokens_match_jax(arch):
    """JAX with use_pallas=True: its decode takes the Pallas grouped matmul
    (cap 8) and decode attention in interpret mode."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), use_pallas=True)
    tcfg = reduced(get_config(arch))
    jparams = jinit_params(jax.random.key(3), jcfg)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    prompts = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 6))
    want = _jax_serve(jparams, jcfg, prompts, 6)
    res = serve_mod.serve(model, torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(res.tokens.numpy(), want)


@pytest.mark.parametrize("arch", ["granite_moe_1b", "zamba2_1_2b", "xlstm_1_3b",
                                  "llama4_maverick_400b"])
def test_main_cpu_reduced_every_family(arch, capsys):
    res = serve_mod.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "4", "--gen", "3"])
    assert res.tokens.shape == (2, 3)
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "decode:" in out


def test_unknown_arch_is_refused():
    with pytest.raises(SystemExit):
        serve_mod.build_parser().parse_args(["--arch", "gpt5"])
