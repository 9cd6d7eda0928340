"""Model FLOPs of a step, for the ``mfu`` metrics: the count of the
references in ``REFERENCES`` (the repository's own blocks of those
families) where no ``counts/model_<reference>.py`` names its own.

6 N T for a train step and 2 N T for a prefill, where N counts the
parameters a token is multiplied by (every projection it passes through:
a shared block once a site, an MoE layer's router and its k routed
experts, the unembedding over the vocabulary; not the input embedding, a
lookup), plus causal attention: 4 D a visible query-key pair a head, x3 in
a train step.  Recomputation is not counted.  The scan's own products are
not counted (under 2% of zamba2's)."""
from __future__ import annotations

from perfbench.counts.flash_attention_fwd import visible

REFERENCES = ("dense", "moe", "hybrid")


def _attn_params(cfg: dict) -> int:
    d = cfg["d_model"]
    hd = cfg["head_dim"] or d // cfg["num_heads"]
    return d * hd * (2 * cfg["num_heads"] + 2 * cfg["num_kv_heads"])


def _mlp_params(cfg: dict, f: int) -> int:
    return (3 if cfg["mlp_gated"] else 2) * cfg["d_model"] * f


def _attention_layers(cfg: dict) -> int:
    if cfg["family"] == "hybrid":
        return cfg["num_layers"] // cfg["attn_every"] if cfg["attn_every"] else 0
    if cfg["family"] in ("dense", "moe"):
        return cfg["num_layers"]
    raise NotImplementedError(f"model FLOPs of the {cfg['family']} family")


def applied_params(cfg: dict) -> int:
    """N: parameters a token is multiplied by, in one forward."""
    d, fam, layers = cfg["d_model"], cfg["family"], cfg["num_layers"]
    n = d * cfg["vocab_size"]
    if fam == "hybrid":
        din = cfg["ssm_expand"] * d
        nh = cfg["ssm_heads"] or cfg["num_heads"]
        mamba = d * 2 * din + 4 * din + 2 * d * cfg["ssm_state"] + d * nh + din * d
        n += layers * mamba
        n += _attention_layers(cfg) * (_attn_params(cfg) + _mlp_params(cfg, cfg["d_ff"]))
    elif fam == "moe":
        every = cfg["moe_every"]
        moe_layers = layers // every
        n += layers * _attn_params(cfg) + (layers - moe_layers) * _mlp_params(cfg, cfg["d_ff"])
        n += moe_layers * (d * cfg["num_experts"]
                           + cfg["experts_per_token"] * _mlp_params(cfg, cfg["d_ff"]))
        if cfg["shared_expert"]:
            n += moe_layers * _mlp_params(cfg, cfg["d_ff"])
    elif fam == "dense":
        n += layers * (_attn_params(cfg) + _mlp_params(cfg, cfg["d_ff"]))
    else:
        raise NotImplementedError(f"model FLOPs of the {fam} family")
    return n


def attention_fwd(cfg: dict, batch: int, seq: int) -> float:
    d = cfg["d_model"]
    hd = cfg["head_dim"] or d // cfg["num_heads"]
    return 4.0 * hd * cfg["num_heads"] * batch * visible(seq, seq, True) * _attention_layers(cfg)


def train_step(cfg: dict, batch: int, seq: int) -> float:
    return 6.0 * applied_params(cfg) * batch * seq + 3.0 * attention_fwd(cfg, batch, seq)


def prefill(cfg: dict, batch: int, seq: int) -> float:
    return 2.0 * applied_params(cfg) * batch * seq + attention_fwd(cfg, batch, seq)
