"""Plain PyTorch layers shared by the families' references.

Every function computes in float32 on whatever device its tensors are on,
with no kernel of the program under test, no cache and no batching tricks.
Parameters are a dict of float32 tensors keyed by the program's parameter
names (``blocks.3.mamba.w_in``), laid out ``(d_in, d_out)`` and applied as
``x @ W``.

``lower_precision()`` computes in float8 e4m3 where the program computes in
bfloat16: every projection's operands and output, and the residual stream
between blocks (``act``), are rounded to e4m3 with a per-tensor scale (the
gradient passes straight through).  That is the control the comparison
deciding ``correct`` has to reject for a bfloat16 model.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Params = Dict[str, torch.Tensor]
FP8_MAX = 448.0

_fp8 = False


@contextlib.contextmanager
def lower_precision():
    """Within the block projections (``mm``) and the residual stream
    (``act``) are rounded to float8 e4m3 with a per-tensor scale."""
    global _fp8
    before, _fp8 = _fp8, True
    try:
        yield
    finally:
        _fp8 = before


def _to_fp8(t: torch.Tensor) -> torch.Tensor:
    d = t.detach()
    scale = FP8_MAX / d.abs().amax().clamp(min=1e-30)
    q = (d * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (q - d)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A projection ``x @ w`` in float32 (float8 operands and output under
    ``lower_precision``)."""
    if _fp8:
        return _to_fp8(_to_fp8(x) @ _to_fp8(w))
    return x @ w


def act(x: torch.Tensor) -> torch.Tensor:
    """The residual stream as the model stores it between blocks: float32,
    float8 under ``lower_precision``."""
    return _to_fp8(x) if _fp8 else x


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward when
    autograd records it (the reference fits a full-size step that way)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, H, S, D) at positions 0..S-1, the two
    halves of D rotated together."""
    s, d = x.shape[2], x.shape[3]
    half = d // 2
    freqs = (1.0 / (theta ** (torch.arange(0, half, dtype=torch.float64, device=x.device)
                              / half))).float()
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, row0: int) -> torch.Tensor:
    """Causal softmax attention of the query rows row0.. against keys 0..;
    k and v already cut to the keys those rows can see."""
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    rows = torch.arange(row0, row0 + q.shape[2], device=q.device)[:, None]
    cols = torch.arange(k.shape[2], device=q.device)[None, :]
    scores = scores.masked_fill(cols > rows, float("-inf"))
    return torch.softmax(scores, dim=-1) @ v


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rows: int = 1024) -> torch.Tensor:
    """q (B, H, S, D), k and v (B, Hkv, S, D) -> (B, H, S, D), a block of
    ``rows`` queries at a time (each block recomputed in the backward)."""
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    s = q.shape[2]
    outs = []
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        outs.append(remat(_attend_rows, q[:, :, r0:r1], k[:, :, :r1], v[:, :, :r1], r0)
                    if torch.is_grad_enabled() else
                    _attend_rows(q[:, :, r0:r1], k[:, :, :r1], v[:, :, :r1], r0))
    return torch.cat(outs, dim=2)


def attention(p: Params, pre: str, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """GQA self-attention with RoPE; x (B, S, d)."""
    b, s, _ = x.shape
    hd = cfg["head_dim"] or cfg["d_model"] // cfg["num_heads"]
    h, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    q = mm(x, p[pre + "wq"]).reshape(b, s, h, hd).transpose(1, 2)
    k = mm(x, p[pre + "wk"]).reshape(b, s, hkv, hd).transpose(1, 2)
    v = mm(x, p[pre + "wv"]).reshape(b, s, hkv, hd).transpose(1, 2)
    if cfg["qkv_bias"]:
        raise NotImplementedError("qkv_bias")
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    o = causal_attention(q, k, v).transpose(1, 2).reshape(b, s, h * hd)
    return mm(o, p[pre + "wo"])


def swiglu(p: Params, pre: str, x: torch.Tensor) -> torch.Tensor:
    return mm(F.silu(mm(x, p[pre + "wg"])) * mm(x, p[pre + "wi"]), p[pre + "wo"])


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed.tok"][tokens]


def logits(p: Params, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Float32 logits over the vocabulary (the padded rows of the table are
    not scored)."""
    table = p["embed.tok"] if cfg["tie_embeddings"] else p["embed.out"]
    return x @ table[:cfg["vocab_size"]].T


def next_token_loss(p: Params, x: torch.Tensor, labels: torch.Tensor, cfg: dict,
                    rows: int = 2048) -> torch.Tensor:
    """Mean cross-entropy of the final hidden states x (B, S, d) against
    labels, a block of ``rows`` positions at a time."""
    xf = x.reshape(-1, x.shape[-1])
    lf = labels.reshape(-1).long()
    total = x.new_zeros(())
    for r0 in range(0, xf.shape[0], rows):
        def block(xb, lb):
            lg = logits(p, xb, cfg)
            return torch.sum(torch.logsumexp(lg, dim=-1) - lg.gather(-1, lb[:, None])[:, 0])
        total = total + remat(block, xf[r0:r0 + rows], lf[r0:r0 + rows])
    return total / xf.shape[0]


def init_kind(name: str, shape: Tuple[int, ...], cfg: dict) -> Tuple[str, float]:
    """How the benchmark draws a parameter of this name: ("normal", std),
    ("ones", 0), ("zeros", 0), ("dt_bias", 0) or ("a_log", 0).

    Projections N(0, 1 / d_in), the output projection of every residual
    branch (Mamba2's ``w_out``, attention's and the MLPs' and experts'
    ``wo``) further scaled by 1 / sqrt(2 L) (GPT-2's and Mamba's scaled
    initialisation, L the model's layers); the input embedding N(0, 1)
    (``torch.nn.Embedding``'s), so that the residual stream is O(1) and each
    block adds a small update to it, as in a trained model; the output table
    (and a tied table) N(0, 0.02^2); the conv taps N(0, 0.1^2), norm scales 1, biases 0
    (a leaf whose name starts with ``b`` or ends in ``_bias``); Mamba2's D skip
    (``d_skip``) 1, as published; Mamba2's step bias
    the inverse softplus of a step drawn log-uniform in [1e-3, 1e-1] and
    its decay rate log U(1, 16) (Mamba2's published initialisation).  A
    1-D leaf that none of these names raises ``ValueError``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("scale", "d_skip"):
        return "ones", 0.0
    if leaf in ("a_log", "dt_bias"):
        return leaf, 0.0
    if leaf.startswith("b") or leaf.endswith("_bias"):
        return "zeros", 0.0
    if name == "embed.tok" and not cfg["tie_embeddings"]:
        return "normal", 1.0
    if name.startswith("embed."):
        return "normal", 0.02
    if leaf == "conv":
        return "normal", 0.1
    if len(shape) < 2:
        raise ValueError(f"no rule draws the {len(shape)}-D parameter {name}")
    std = shape[-2] ** -0.5
    if leaf in ("w_out", "wo"):
        std /= math.sqrt(2 * cfg["num_layers"])
    return "normal", std
