"""Parameter / optimizer-state / cache partitioning rules (the port of
``repro.distributed.partition``).

``param_logical_axes`` gives every parameter a tuple of *logical* axes by
its path (MaxText-style); ``MeshContext.spec`` maps those to mesh axes.
``zero1_axes`` additionally shards optimizer moments over the data axis
(ZeRO-1).  Trees here are flat dicts keyed by the port's parameter names
(``blocks.3.attn.wq``: blocks are separate modules, so no leading
``layers`` axis) or, for the decode cache, the nested dicts of
``init_cache`` (whose leaves keep the reference's stacked layouts).  The
rules themselves are the reference's, keyed by its paths:
``models.convert.jax_path`` maps a port name to one.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from .sharding import MeshContext, NamedSharding

Logical = Tuple[Optional[str], ...]


def _axes_for(path: str, shape: Tuple[int, ...], cfg: ModelConfig) -> Logical:
    """Logical axes for a parameter, keyed by its path suffix."""
    nd = len(shape)
    # xLSTM has too few heads to TP-shard the inner projections: replicate
    tpless = cfg.family == "ssm"

    def t(*axes):
        return tuple(axes)

    if "embed/tok" in path or "embed/out" in path:
        return t("vocab", "embed")
    if path.endswith("router"):
        return t("embed", None)
    if "/moe/wi" in path or "/moe/wg" in path:
        return t("experts", "embed", "mlp")
    if "/moe/wo" in path:
        return t("experts", "mlp", "embed")
    if "shared/wi" in path or "shared/wg" in path:
        return t("embed", "mlp")
    if "shared/wo" in path:
        return t("mlp", "embed")
    if path.endswith(("attn/wq", "attn/wk", "attn/wv")):
        return t("embed", None) if tpless else t("embed", "heads")
    if path.endswith(("attn/bq", "attn/bk", "attn/bv")):
        return t(None) if tpless else t("heads")
    if path.endswith("attn/wo"):
        return t(None, "embed") if tpless else t("heads", "embed")
    if path.endswith(("mlp/wi", "mlp/wg")):
        return t("embed", "mlp")
    if path.endswith("mlp/wo"):
        return t("mlp", "embed")
    # mamba2
    if path.endswith("mamba/w_in"):
        return t("embed", "mlp")
    if path.endswith("mamba/conv"):
        return t(None, "mlp")
    if path.endswith(("mamba/w_b", "mamba/w_c")):
        return t("embed", None)
    if path.endswith("mamba/w_dt"):
        return t("embed", "ssm_heads")
    if path.endswith(("mamba/a_log", "mamba/dt_bias")):
        return t("ssm_heads")
    if path.endswith("mamba/w_out"):
        return t("mlp", "embed")
    if path.endswith("mamba/norm/scale"):
        return t("mlp")
    # xlstm (replicated TP-wise; DP/ZeRO carry it)
    if "mlstm" in path or "slstm" in path:
        return tuple([None] * nd)
    # norms and anything else 1-d: replicate
    return tuple([None] * nd)


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Global shape of every parameter (the module built on ``meta``)."""
    from repro_torch.models.model import Model
    return {n: tuple(p.shape) for n, p in Model(cfg, device="meta").named_parameters()}


def param_logical_axes(cfg: ModelConfig) -> Dict[str, Logical]:
    """{port parameter name: logical axes}."""
    from repro_torch.models.convert import jax_path
    return {n: _axes_for(jax_path(n), shape, cfg) for n, shape in param_shapes(cfg).items()}


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (leaves: logical-axis tuples,
    shapes or shardings), with matching trees ``rest``."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def logical_to_sharding(logical_tree, mc: MeshContext, shapes=None):
    """Map logical-axis tuples to ``NamedSharding``s, dropping mesh axes
    that do not divide the corresponding dimension."""
    def conv(axes, shape=None):
        spec = mc.spec(axes)
        if shape is None:
            return NamedSharding(mc, spec)
        return NamedSharding(mc, tuple(ax if ax is None or dim % mc.size(ax) == 0 else None
                                       for dim, ax in zip(shape, spec)))

    if shapes is None:
        return tree_map(conv, logical_tree)
    return tree_map(conv, logical_tree, shapes)


def zero1_axes(logical_tree, shapes, data_size: int):
    """Add a 'data' shard on the first replicated, divisible axis of every
    moment tensor (ZeRO-1)."""
    def z(axes, shape):
        axes = list(axes)
        for i, (ax, dim) in enumerate(zip(axes, shape)):
            if ax is None and dim % data_size == 0 and dim >= data_size:
                axes[i] = "zero"
                return tuple(axes)
        return tuple(axes)

    return tree_map(z, logical_tree, shapes)


def row_params(param_sh: Mapping[str, NamedSharding]) -> list:
    """The parameters the model applies to the residual stream's own rows,
    outside a layer's region: the residual norms' scales (every norm but
    Mamba2's and the mLSTM's, which run inside their blocks on the gathered
    sequence) and an embedding table that ``model`` does not shard (looked
    up on, or applied to, the rank's rows; a ``model``-sharded one gathers
    the ids or reduce-scatters its own gradient).  Under sequence
    parallelism a rank's gradient of each is a partial sum over the
    sequence shards (Megatron's SP gradient all-reduce sums it)."""
    from repro_torch.models.convert import jax_path
    out = []
    for name, sh in param_sh.items():
        path = jax_path(name)
        if path.endswith("/scale"):
            if not path.endswith(("mamba/norm/scale", "mlstm/norm/scale")):
                out.append(name)
        elif path in ("embed/tok", "embed/out") and "model" not in sh.sharded_axes():
            out.append(name)
    return out


def batch_shardings(cfg: ModelConfig, kind: str, mc: MeshContext) -> Dict:
    """Input shardings per shape kind."""
    if kind == "train" or kind == "prefill":
        out = {"labels": mc.sharding(("batch", "seq"))}
        if cfg.frontend:
            out["embeds"] = mc.sharding(("batch", "seq", "embed"))
        else:
            out["tokens"] = mc.sharding(("batch", "seq"))
        return out
    # decode: token + pos
    return {"token": mc.sharding(("batch",)),
            "pos": mc.sharding(("batch",))}


def cache_logical_axes(cfg: ModelConfig, long_context: bool = False):
    """Logical axes for the decode cache (``init_cache``'s structure).
    ``long_context`` asks for the KV sequence over ``model``
    (``kv_seq_sharded``), as the reference does; ``MeshContext.spec`` gives
    ``model`` to ``kv_heads`` first, so the sequence is never sharded and
    the specs equal those without it (ROADMAP Queue 3 item 15)."""
    kv_seq = "kv_seq_sharded" if long_context else "kv_seq"

    def kv_axes():
        return {"k": ("layers", "batch", "kv_heads", kv_seq, None),
                "v": ("layers", "batch", "kv_heads", kv_seq, None)}

    if cfg.family in ("dense", "audio", "vlm"):
        return kv_axes()
    if cfg.family == "moe":
        return {f"l{i}": kv_axes() for i in range(cfg.moe_every)}
    if cfg.family == "hybrid":
        out = {"ssm": {"h": ("layers", "batch", "ssm_heads", None, None),
                       "conv": ("layers", "batch", None, "mlp")}}
        if cfg.attn_every:
            out["shared_kv"] = kv_axes()
        return out
    if cfg.family == "ssm":
        return {"mlstm": {"C": ("layers", "batch", None, None, None),
                          "n": ("layers", "batch", None, None)},
                "slstm": {"c": ("layers", "batch", None, None),
                          "n": ("layers", "batch", None)}}
    raise ValueError(cfg.family)
