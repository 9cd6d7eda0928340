"""Model FLOPs of the published Zamba2 (``reference/zamba2.py``), for the
``mfu`` metrics: ``counts/model.py``'s rule, 6 N T for a train step and
2 N T for a prefill, plus causal attention, 4 D a visible query-key pair a
head, x3 in a train step, plus the scan's recurrence at its own cost.

N counts the parameters a token is multiplied by: each Mamba2 mixer's
in_proj (z, x, B, C and dt), its conv taps and its out_proj; at each
hybrid site the shared block's projections and MLP (a shared block once a
site), the site's adapter and its linear; the unembedding over the
vocabulary (not its padded rows, and not the input embedding, a lookup).
Norms, biases, A and D are not counted.

The scan is counted at 4 N P a head a token (the state update
h = a h + B (x) x and the readout y = C . h, 2 N P each), x3 in a train
step, so that ``mfu`` reads the same work whatever chunking a kernel
uses.  Recomputation is not counted."""
from __future__ import annotations

from perfbench.counts.flash_attention_fwd import visible

CONV_W = 4


def applied_params(cfg: dict) -> int:
    """N: parameters a token is multiplied by, in one forward."""
    d, f, r = cfg["d_model"], cfg["d_ff"], cfg["adapter_rank"]
    din = cfg["ssm_expand"] * d
    bc = 2 * cfg["ssm_groups"] * cfg["ssm_state"]
    mixer = d * (2 * din + bc + cfg["ssm_heads"]) + CONV_W * (din + bc) + din * d
    h, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg["head_dim"] or 2 * d // h
    block = 2 * d * hd * (h + 2 * hkv) + h * hd * d + 3 * d * f
    site = block + d * r + r * 2 * f + d * d
    return cfg["num_layers"] * mixer + len(cfg["hybrid_layers"]) * site + d * cfg["vocab_size"]


def attention_fwd(cfg: dict, batch: int, seq: int) -> float:
    hd = cfg["head_dim"] or 2 * cfg["d_model"] // cfg["num_heads"]
    return (4.0 * hd * cfg["num_heads"] * batch * visible(seq, seq, True)
            * len(cfg["hybrid_layers"]))


def scan_fwd(cfg: dict, batch: int, seq: int) -> float:
    p = cfg["ssm_expand"] * cfg["d_model"] // cfg["ssm_heads"]
    return 4.0 * cfg["ssm_state"] * p * cfg["ssm_heads"] * batch * seq * cfg["num_layers"]


def train_step(cfg: dict, batch: int, seq: int) -> float:
    return (6.0 * applied_params(cfg) * batch * seq
            + 3.0 * (attention_fwd(cfg, batch, seq) + scan_fwd(cfg, batch, seq)))


def prefill(cfg: dict, batch: int, seq: int) -> float:
    return (2.0 * applied_params(cfg) * batch * seq + attention_fwd(cfg, batch, seq)
            + scan_fwd(cfg, batch, seq))
