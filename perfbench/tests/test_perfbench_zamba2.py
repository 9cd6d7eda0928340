"""The published Zamba2's plain reference (``reference/zamba2.py``) against
``transformers``' ``Zamba2ForCausalLM`` on the same float32 weights, the
faults it has to catch, the parameters it draws, and its model-FLOP count
(``counts/model_zamba2.py``) against ``transformers``' modules on ``meta``
and by hand.

Every use of ``transformers`` is in this file, behind
``pytest.importorskip``; it is imported with its TensorFlow, Flax and JAX
back ends off."""
from __future__ import annotations

import contextlib
import math

import pytest
import torch
import torch.nn.functional as F

from perfbench.counts import model_zamba2 as count
from perfbench.lib import weights
from perfbench.lib.manifest import Manifest
from perfbench.reference import common as C
from perfbench.reference import zamba2
from perfbench.reference.common import init_kind

SEED = 2**31 + 4099
# d 64, 2 B/C groups of 16 over 8 Mamba2 heads of 16, 4 attention heads of 32
# over the 128-wide concatenation, d_ff 96, rank-8 adapters; 7 layers with
# sites at uneven gaps (1, 4, 6), so both shared blocks run and block 0 twice
TINY = dict(num_layers=7, d_model=64, num_heads=4, num_kv_heads=4, head_dim=32, d_ff=96,
            vocab_size=256, norm_eps=1e-5, rope_theta=10000.0, tie_embeddings=True,
            ssm_state=16, ssm_heads=8, ssm_expand=2, param_dtype="float32", ssm_groups=2,
            shared_blocks=2, hybrid_layers=[1, 4, 6], adapter_rank=8)
# S 200 is a multiple of neither side's chunk: the reference's scan runs two
# chunks of 128, the second padded.  transformers' runs one of 256: its
# torch_forward sums the chunk-to-chunk decay over the wrong axis
# (modeling_zamba2.py:882, ``.sum(dim=2)`` where Mamba2's transposes first), so
# across chunks it leaves the recurrence (8e-4 of y's largest value at chunk 16)
BATCH, SEQ, CHUNK = 2, 200, 256
# Zamba2-7B (huggingface.co/Zyphra/Zamba2-7B-Instruct, config.json) cut to its
# first 24 of 81 layers: sites 6, 11, 17 and 23
CUT_7B = dict(num_layers=24, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=224,
              d_ff=14336, vocab_size=32000, norm_eps=1e-5, rope_theta=10000.0,
              tie_embeddings=True, ssm_state=64, ssm_heads=112, ssm_expand=2,
              param_dtype="bfloat16", ssm_groups=2, shared_blocks=2,
              hybrid_layers=[6, 11, 17, 23], adapter_rank=128)
# both sides are float32 and differ only in the order of their sums
LOGIT_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def hf():
    """``transformers``' Zamba2 modules, its other back ends kept unloaded."""
    with pytest.MonkeyPatch.context() as mp:
        for var in ("USE_TF", "USE_FLAX", "USE_JAX"):
            mp.setenv(var, "0")
        return pytest.importorskip("transformers.models.zamba2.modeling_zamba2")


def hf_config(hf, cfg: dict, chunk: int = 256):
    sites = cfg["hybrid_layers"]
    return hf.Zamba2Config(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["d_model"],
        num_hidden_layers=cfg["num_layers"],
        layers_block_type=["hybrid" if i in sites else "mamba" for i in range(cfg["num_layers"])],
        mamba_d_state=cfg["ssm_state"], mamba_d_conv=4, mamba_expand=cfg["ssm_expand"],
        mamba_ngroups=cfg["ssm_groups"], n_mamba_heads=cfg["ssm_heads"], use_conv_bias=True,
        chunk_size=chunk, add_bias_linear=False, intermediate_size=cfg["d_ff"],
        hidden_act="gelu", num_attention_heads=cfg["num_heads"],
        num_key_value_heads=cfg["num_kv_heads"], num_mem_blocks=cfg["shared_blocks"],
        use_shared_attention_adapter=False, adapter_rank=cfg["adapter_rank"],
        use_mem_rope=True, rope_theta=cfg["rope_theta"], rms_norm_eps=cfg["norm_eps"],
        # the reference follows mamba_ssm's kernels and clamps no dt (its first
        # departure); token 0 is an ordinary token (its third)
        time_step_min=1e-30, pad_token_id=None, tie_word_embeddings=True,
        attn_implementation="eager")


def hf_leaves(model, cfg: dict, get) -> dict:
    """Each reference leaf as ``get`` of the ``transformers`` parameter that
    holds it, cut and transposed to the reference's layout (views, so a copy
    into one writes the model's weight)."""
    din, f = cfg["ssm_expand"] * cfg["d_model"], cfg["d_ff"]
    gn = cfg["ssm_groups"] * cfg["ssm_state"]
    m, sites = model.model, cfg["hybrid_layers"]
    out = {"embed.tok": get(m.embed_tokens.weight),
           "final_norm.scale": get(m.final_layernorm.weight)}
    for i, lay in enumerate(m.layers):
        dec = lay.mamba_decoder if i in sites else lay
        mx, pre = dec.mamba, f"blocks.{i}."
        w = get(mx.in_proj.weight).T                       # [z | x | B | C | dt]
        out.update({pre + "ln.scale": get(dec.input_layernorm.weight),
                    pre + "mamba.w_in": w[:, :2 * din], pre + "mamba.w_b": w[:, 2 * din:][:, :gn],
                    pre + "mamba.w_c": w[:, 2 * din + gn:][:, :gn],
                    pre + "mamba.w_dt": w[:, 2 * din + 2 * gn:],
                    pre + "mamba.conv": get(mx.conv1d.weight)[:, 0, :].T,
                    pre + "mamba.conv_bias": get(mx.conv1d.bias),
                    pre + "mamba.a_log": get(mx.A_log), pre + "mamba.dt_bias": get(mx.dt_bias),
                    pre + "mamba.d_skip": get(mx.D), pre + "mamba.norm.scale": get(mx.norm.weight),
                    pre + "mamba.w_out": get(mx.out_proj.weight).T})
    for j, i in enumerate(sites):
        lay, blk = m.layers[i], m.layers[i].shared_transformer
        assert blk.block_id == j % cfg["shared_blocks"]
        adapter = blk.feed_forward.gate_up_proj_adapter_list[j]
        out.update({f"sites.{j}.linear": get(lay.linear.weight).T,
                    f"sites.{j}.adapter_in": get(adapter[0].weight).T,
                    f"sites.{j}.adapter_out": get(adapter[1].weight).T})
        at, ff, pre = blk.self_attn, blk.feed_forward, f"shared.{blk.block_id}."
        gate_up = get(ff.gate_up_proj.weight).T               # [gate | up]
        out.update({pre + "ln1.scale": get(blk.input_layernorm.weight),
                    pre + "attn.wq": get(at.q_proj.weight).T,
                    pre + "attn.wk": get(at.k_proj.weight).T,
                    pre + "attn.wv": get(at.v_proj.weight).T,
                    pre + "attn.wo": get(at.o_proj.weight).T,
                    pre + "ln2.scale": get(blk.pre_ff_layernorm.weight),
                    pre + "mlp.wg": gate_up[:, :f], pre + "mlp.wi": gate_up[:, f:],
                    pre + "mlp.wo": get(ff.down_proj.weight).T})
    return out


def _batch():
    ids = torch.randint(0, TINY["vocab_size"], (BATCH, SEQ + 1),
                        generator=torch.Generator().manual_seed(SEED))
    return ids[:, :-1], ids[:, 1:]


def _reference(p: dict, grads: bool = True):
    tokens, labels = _batch()
    with contextlib.nullcontext() if grads else torch.no_grad():
        x, _ = zamba2.hidden(p, tokens, TINY)
        logits = C.logits(p, x, TINY)
        loss = C.next_token_loss(p, x, labels, TINY)
        if grads:
            loss.backward()
    return logits.detach(), float(loss.detach())


@pytest.fixture(scope="module")
def pair(hf):
    """The reference's weights, logits, loss and gradients, and
    ``transformers``' on a copy of the same weights."""
    specs = zamba2.param_specs(TINY)
    p = weights.reference_params(specs, TINY, SEED, "cpu", requires_grad=True)
    model = hf.Zamba2ForCausalLM(hf_config(hf, TINY, CHUNK)).float()
    views = hf_leaves(model, TINY, lambda t: t.data)
    assert sorted(views) == sorted(n for n, _, _ in specs)
    with torch.no_grad():
        for name, view in views.items():
            assert view.shape == p[name][:view.shape[0]].shape, name
            view.copy_(p[name][:view.shape[0]])
    tokens, labels = _batch()
    hf_logits = model(input_ids=tokens, use_cache=False).logits
    hf_loss = F.cross_entropy(hf_logits.reshape(-1, TINY["vocab_size"]), labels.reshape(-1))
    hf_loss.backward()
    logits, loss = _reference(p)
    return dict(p=p, logits=logits, loss=loss, hf_logits=hf_logits.detach(),
                hf_loss=float(hf_loss.detach()), hf_grads=hf_leaves(model, TINY, lambda t: t.grad))


def _logit_gap(logits, want) -> float:
    return float((logits - want).abs().max() / want.abs().max())


def test_reference_matches_transformers(pair):
    assert _logit_gap(pair["logits"], pair["hf_logits"]) <= LOGIT_TOL
    assert abs(pair["loss"] - pair["hf_loss"]) <= LOGIT_TOL * abs(pair["hf_loss"])
    p, vocab = pair["p"], TINY["vocab_size"]
    assert not p["embed.tok"].grad[vocab:].any()          # the padded rows are not scored
    for name, want in pair["hf_grads"].items():
        got = p[name].grad[:want.shape[0]]
        assert float((got - want).norm()) <= GRAD_TOL * float(want.norm()), name


def test_scan_is_the_recurrence():
    """The grouped scan over two chunks against the recurrence a step at a
    time, head h reading group h // 4."""
    g = torch.Generator().manual_seed(SEED)
    bsz, s, nh, ph, n, groups = 2, SEQ, 8, 16, 16, 2
    x = torch.randn(bsz, s, nh, ph, generator=g)
    log_a = -torch.rand(bsz, s, nh, generator=g)
    b, c = (torch.randn(bsz, s, groups * n, generator=g) for _ in range(2))
    y = zamba2.scan(x, log_a, b, c, groups)
    head_b = b.reshape(bsz, s, groups, n).repeat_interleave(nh // groups, dim=2)
    head_c = c.reshape(bsz, s, groups, n).repeat_interleave(nh // groups, dim=2)
    h = torch.zeros(bsz, nh, ph, n)
    want = []
    for t in range(s):
        h = torch.exp(log_a[:, t])[..., None, None] * h + x[:, t, ..., None] * head_b[:, t, :, None]
        want.append((h * head_c[:, t, :, None]).sum(-1))
    want = torch.stack(want, dim=1)
    assert float((y - want).abs().max()) <= LOGIT_TOL * float(want.abs().max())


def _norm_after_gate(y, z, scale, groups, eps):
    yg = y.reshape(*y.shape[:-1], groups, -1)
    return C.rmsnorm(yg, scale.reshape(groups, -1), eps).reshape(y.shape) * F.silu(z)


def _site_to_residual(p, i, x, e, cfg, j):
    pre = f"blocks.{i}."
    x = x if j is None else x + zamba2.site(p, j, x, e, cfg)
    return x + zamba2.mamba2(p, pre + "mamba.", C.rmsnorm(x, p[pre + "ln.scale"], cfg["norm_eps"]),
                             cfg)


SCAN = zamba2.scan


def _one_group(x, log_a, b, c, groups):
    n = b.shape[-1] // groups
    return SCAN(x, log_a, b[..., :n], c[..., :n], 1)


@pytest.mark.parametrize("fault", ["norm_before_gate", "no_d_skip", "site_to_residual",
                                   "one_group", "scale_head_dim"])
def test_planted_faults_miss(pair, monkeypatch, fault):
    """Each fault misses ``transformers``' logits by at least ten times the
    tolerance the reference meets."""
    p = {n: t.detach() for n, t in pair["p"].items()}
    if fault == "norm_before_gate":
        monkeypatch.setattr(zamba2, "gated_norm", _norm_after_gate)
    elif fault == "no_d_skip":
        p = {n: torch.zeros_like(t) if n.endswith(".d_skip") else t for n, t in p.items()}
    elif fault == "site_to_residual":
        monkeypatch.setattr(zamba2, "layer", _site_to_residual)
    elif fault == "one_group":
        monkeypatch.setattr(zamba2, "scan", _one_group)
    else:                                  # the scale head_dim^-1/2 in place of (head_dim / 2)^-1/2
        monkeypatch.setattr(zamba2, "Q_GAIN", 1.0)
    logits, _ = _reference(p, grads=False)
    assert _logit_gap(logits, pair["hf_logits"]) >= 10 * LOGIT_TOL


@pytest.mark.parametrize("cfg", [TINY, CUT_7B], ids=["tiny", "cut_7b"])
def test_specs_draw_through_init_kind(cfg):
    """Every leaf has a rule: D skips ones, conv biases zeros, the decays and
    step biases their own, the residual outputs N(0, 1 / d_in) / sqrt(2 L),
    every other matrix N(0, 1 / d_in); no 2-D leaf is drawn as a bias."""
    scaled = 1 / math.sqrt(2 * cfg["num_layers"])
    for name, shape, _ in zamba2.param_specs(cfg):
        leaf = name.rsplit(".", 1)[-1]
        kind, std = init_kind(name, shape, cfg)
        if leaf in ("scale", "d_skip"):
            assert kind == "ones", name
        elif leaf == "conv_bias":
            assert kind == "zeros", name
        elif leaf in ("a_log", "dt_bias"):
            assert kind == leaf
        elif name == "embed.tok":
            assert (kind, std) == ("normal", 0.02)
        elif leaf == "conv":
            assert (kind, std) == ("normal", 0.1)
        else:
            assert len(shape) == 2 and not leaf.startswith("b"), name
            want = shape[0] ** -0.5 * (scaled if leaf in ("wo", "w_out") else 1.0)
            assert kind == "normal" and std == pytest.approx(want, rel=1e-15), name


def _meta_model(hf, cfg):
    with torch.device("meta"):
        return hf.Zamba2ForCausalLM(hf_config(hf, cfg))


def test_published_cut_parameter_count(hf):
    """The specs hold as many parameters as ``transformers``' Zamba2-7B cut to
    24 layers, less the table's 768 padding rows."""
    model = _meta_model(hf, CUT_7B)
    published = sum(t.numel() for t in model.parameters())
    specs = sum(math.prod(s) for _, s, _ in zamba2.param_specs(CUT_7B))
    assert published == specs - 768 * 3584 == 2_733_050_240


def test_applied_params_against_transformers(hf):
    """N counts, over ``transformers``' modules, each mixer's in_proj, conv taps
    and out_proj, and at each site the shared block's projections and MLP
    (once a site), the site's adapter and its linear, and the unembedding."""
    m = _meta_model(hf, CUT_7B)
    sites = CUT_7B["hybrid_layers"]
    n = m.lm_head.weight.numel()
    for i, lay in enumerate(m.model.layers):
        mx = (lay.mamba_decoder if i in sites else lay).mamba
        n += sum(t.numel() for t in (mx.in_proj.weight, mx.conv1d.weight, mx.out_proj.weight))
        if i in sites:
            blk, j = lay.shared_transformer, sites.index(i)
            at, ff = blk.self_attn, blk.feed_forward
            n += sum(t.numel() for t in (at.q_proj.weight, at.k_proj.weight, at.v_proj.weight,
                                         at.o_proj.weight, ff.gate_up_proj.weight,
                                         ff.down_proj.weight, lay.linear.weight))
            n += sum(t.numel() for t in ff.gate_up_proj_adapter_list[j].parameters())
    assert count.applied_params(CUT_7B) == n == 3_400_523_776


def test_train_step_by_hand():
    """Zamba2-7B's cut at 4 x 4,096: 6 N T, plus three times causal attention
    at its 4 sites (4 x 224 a visible pair a head, 32 heads, 4,096 x 4,097 / 2
    pairs) and three times the scan (4 x 64 x 64 a head a token, 112 heads,
    24 layers)."""
    t = 4 * 4096
    attention = 4 * 224 * 32 * 4 * (4096 * 4097 // 2) * 4
    scan = 4 * 64 * 64 * 112 * t * 24
    assert (attention, scan) == (3_849_230_221_312, 721_554_505_728)
    want = 6 * 3_400_523_776 * t + 3 * attention + 3 * scan
    assert want == 347_997_443_457_024
    assert count.train_step(CUT_7B, 4, 4096) == want
    assert count.prefill(CUT_7B, 4, 4096) == 2 * 3_400_523_776 * t + attention + scan
    assert 3 * attention / want == pytest.approx(0.0332, abs=1e-4)
    assert 3 * scan / want == pytest.approx(0.0062, abs=1e-4)


def test_the_harness_finds_them_by_name():
    man = Manifest()
    assert man.reference("zamba2") is zamba2
    assert man.model_count("zamba2") is count
