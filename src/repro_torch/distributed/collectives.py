"""The collectives of the sharded steps, in place of GSPMD's.

The reference states layouts (``shard_hint``, the parameter and batch
shardings) and lets GSPMD insert the collectives; the port keeps every
tensor as this rank's local shard and issues them here, so the kernels only
ever see plain local tensors.  Outside a mesh context (``current()`` is
None) every function returns its input: the one-process model computes
exactly what it did before.  Inside one, every collective is issued, also
over a group of one rank (mesh 1x1), where it is the identity.

Tensor parallelism follows Megatron: inside a layer that runs on its own
shard of heads, columns, experts or vocab (``TP.local``), a tensor that is
replicated over ``model`` enters through ``copy_to_model`` (f: identity
forward, all-reduce backward, since each rank's gradient is a partial sum)
and a product that is a partial sum leaves through ``reduce_from_model``
(g: all-reduce forward, identity backward, since every rank then holds the
whole gradient).  ``torch.distributed.nn.functional.all_reduce``
differentiates to a second all-reduce and would multiply every
model-replicated gradient by the model size; ``mean_over_model`` uses that
operator, for a sum whose consumers are sharded (Mamba2's norm).

Sequence parallelism (``MeshContext.sp``: the rules map ``"seq"`` to
``model``) keeps the residual stream (B, S, d) as this rank's chunk of the
sequence, S / model rows, on which the norms and residual adds run.  The
two regions of a layer then change (Megatron's SP):

* a layer that runs on its own model shard (``TP.local``) enters through
  an all-gather along the sequence, whose backward is a reduce-scatter
  (each rank's input gradient is a partial sum), and leaves through a
  reduce-scatter in place of g's all-reduce, whose backward is an
  all-gather;
* a layer that computes replicated over ``model`` enters through the same
  all-gather with a backward that takes this rank's chunk (every rank
  computes the whole input gradient), and leaves by taking this rank's
  chunk, whose backward is an all-gather.

``copy_to_model`` and ``reduce_from_model`` are those regions; a block
whose own f's already make its input gradient whole (Mamba2, the MoE)
enters and leaves as a replicated layer does (``tp_`` None) and uses
``to_shards`` (f alone) inside.  A parameter that the model applies to its own rows outside a
region (the residual norms' scales, an embedding table replicated over
``model``) gets a partial gradient: the train step all-reduces it over
``model`` (``distributed/step.py`` ``sync_grads``).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from .sharding import DEFAULT_RULES, MeshContext, current, spec_axes

BATCH_AXES = DEFAULT_RULES["batch"]


# --------------------------------------------------------------------------
# raw collectives (no autograd)
# --------------------------------------------------------------------------
def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of ``t`` concatenated along ``dim``, in group-rank
    (mesh-coordinate) order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``t`` over the group, this rank's chunk along ``dim``."""
    chunks = [c.contiguous() for c in t.chunk(dist.get_world_size(group), dim=dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


def own_chunk(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    return t.chunk(dist.get_world_size(group), dim=dim)[dist.get_rank(group)]


def gather_whole(x: torch.Tensor, sharding) -> torch.Tensor:
    """The global tensor of this rank's shard ``x`` of ``sharding``
    (all-gathered over each sharded dim's axes; every rank calls it)."""
    for dim, entry in enumerate(sharding.spec):
        if entry is not None:
            x = all_gather(x, dim, sharding.mc.group(entry))
    return x


# --------------------------------------------------------------------------
# autograd Functions
# --------------------------------------------------------------------------
class _CopyTo(torch.autograd.Function):
    """f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    """All-reduce forward and backward: a sum whose every consumer holds
    only its own rank's part of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``.  Backward ``"sum"``: reduce-scatter (the
    gathered tensor's gradient is a partial sum on each rank: FSDP over a
    batch axis); ``"slice"``: this rank's chunk (every rank holds the whole
    gradient: a replicated computation)."""

    @staticmethod
    def forward(ctx, x, dim, group, grad):
        ctx.dim, ctx.group, ctx.grad = dim, group, grad
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            return reduce_scatter(g, ctx.dim, ctx.group), None, None, None
        return own_chunk(g, ctx.dim, ctx.group).contiguous(), None, None, None


class _Scatter(torch.autograd.Function):
    """This rank's chunk along ``dim``: ``"sum"`` of the sum over the group
    (reduce-scatter), ``"slice"`` of its own tensor.  Backward: all-gather
    (every rank then holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group, mode):
        ctx.dim, ctx.group = dim, group
        if mode == "sum":
            return reduce_scatter(x, dim, group)
        return own_chunk(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None, None


# --------------------------------------------------------------------------
# the model axis
# --------------------------------------------------------------------------
class TP:
    """How a layer runs over the ``model`` axis.  ``local``: each rank
    computes its own shard (heads, columns, experts, vocab: ``size`` shards,
    this rank's the ``rank``-th); otherwise the layer's model-sharded
    parameters are gathered and it computes replicated (``size`` 1)."""

    def __init__(self, mc: MeshContext, local: bool):
        self.mc = mc
        self.local = local
        self.size = mc.size("model") if local else 1
        self.rank = mc.index("model") if local else 0

    @property
    def group(self):
        return self.mc.group("model")


def spec_of(p: torch.Tensor) -> tuple:
    sh = getattr(p, "sharding", None)
    return sh.spec if sh is not None else ()


def tp(*param_dims, divides=()) -> Optional[TP]:
    """The layer's ``TP`` (None outside a mesh context): local when the mesh
    has a ``model`` axis, each (parameter, dim) of ``param_dims`` is sharded
    over it on that dim, and it divides every count of ``divides`` (heads,
    experts).  The reference's ``logical_to_sharding`` tests divisibility on
    the flattened dimension, so a shard can split a head (smollm_360m's 15
    heads of 64 at model 2): such a layer gathers and computes replicated."""
    mc = current()
    if mc is None:
        return None
    m = mc.shape.get("model")
    local = m is not None and all(n % m == 0 for n in divides) and all(
        "model" in spec_axes(spec_of(p)[d] if d < len(spec_of(p)) else None)
        for p, d in param_dims)
    return TP(mc, local)


def param(p: torch.Tensor, tp_: Optional[TP] = None, rows: bool = False) -> torch.Tensor:
    """Parameter ``p`` as the layer uses it: gathered over ``data`` (FSDP;
    the gradient reduce-scattered back) and, unless the layer runs
    ``tp_.local``, over ``model`` (the gradient sliced back).  ``rows``:
    the layer applies it to this rank's own sequence rows (the unembedding
    under SP), so its gradient over ``model`` is a partial sum and is
    reduce-scattered back too.  Called inside the remat'd block, so the
    recompute gathers again.  ``p`` itself outside a mesh context or when it
    carries no ``sharding``."""
    mc = current()
    spec = spec_of(p)
    if mc is None or not spec:
        return p
    w = p
    for dim, entry in enumerate(spec):
        for a in spec_axes(entry):
            if a == "model" and tp_ is not None and tp_.local:
                continue
            back = "slice" if a == "model" and not (rows and a in mc.seq_axes) else "sum"
            w = _Gather.apply(w, dim, mc.group(a), back)
    return w


SEQ_DIM = 1                      # the sequence's dimension of the residual stream (B, S, d)


def seq_group():
    """The group the residual stream's sequence is split over (None without
    sequence parallelism)."""
    mc = current()
    return mc.group(mc.seq_axes) if mc is not None and mc.sp else None


def seq_shards() -> int:
    """The number of the sequence's shards (1 without sequence
    parallelism)."""
    mc = current()
    return mc.size(mc.seq_axes) if mc is not None else 1


def copy_to_model(x: torch.Tensor, tp_: Optional[TP]) -> torch.Tensor:
    """The entry of a layer from the residual stream (B, S, d).  f at the
    input of a local shard (Megatron's ``copy_to_tensor_model_parallel_
    region``); under SP the all-gather along the sequence, its backward a
    reduce-scatter where the layer is local and this rank's chunk where it
    computes replicated."""
    g = seq_group()
    local = tp_ is not None and tp_.local
    if g is not None:
        return _Gather.apply(x, SEQ_DIM, g, "sum" if local else "slice")
    return _CopyTo.apply(x, tp_.group) if local else x


def reduce_from_model(x: torch.Tensor, tp_: Optional[TP]) -> torch.Tensor:
    """The exit of a layer to the residual stream (B, S, d).  g after a
    row-parallel product (``reduce_from_..._region``): the reference's
    all-reduce after ``wo`` of a sharded ``heads`` / ``mlp`` / ``experts``
    axis, which GSPMD inserts at the ``("batch", "seq", "embed")`` hint
    (``models/model.py:118,136``); under SP a reduce-scatter along the
    sequence where the layer is local, this rank's chunk where it computed
    replicated (both all-gather backward)."""
    g = seq_group()
    local = tp_ is not None and tp_.local
    if g is not None:
        return _Scatter.apply(x, SEQ_DIM, g, "sum" if local else "slice")
    return _ReduceFrom.apply(x, tp_.group) if local else x


def to_shards(x: torch.Tensor, tp_: Optional[TP]) -> torch.Tensor:
    """f alone, inside a block that entered as a replicated layer
    (``copy_to_model(x, None)``: its input whole along the sequence):
    identity forward, all-reduce backward where the layer is local."""
    return _CopyTo.apply(x, tp_.group) if tp_ is not None and tp_.local else x


def mean_over_model(v: torch.Tensor, tp_: Optional[TP]) -> torch.Tensor:
    """The mean of equal-sized local means ``v`` over the model shards,
    all-reduced forward and backward (the norm over Mamba2's ``mlp``-sharded
    inner width, ``models/mamba2.py`` ``rmsnorm``).  ``v`` itself unless
    local (also at size 1: v / 1 is v)."""
    if tp_ is None or not tp_.local:
        return v
    return _AllReduce.apply(v, tp_.group) / tp_.size


# --------------------------------------------------------------------------
# the batch axes (pod x data)
# --------------------------------------------------------------------------
def batch_group(mc: MeshContext):
    """The group over the batch axes present (None without one, or where
    the batch is replicated: ``MeshContext.with_replicated_batch``)."""
    axes = tuple(a for a in BATCH_AXES if a in mc.shape)
    if not axes or mc.replicated_batch:
        return None
    return mc.group(axes)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the batch shards, every rank then holding the
    whole gradient (g): the reference's loss sums over a ``batch``-sharded
    ``nll`` (``models/model.py:255-256``), and the MoE buffer, replicated
    over ``data`` by its ``("experts", "expert_cap", "embed")`` hint
    (``models/moe.py:87``)."""
    mc = current()
    g = batch_group(mc) if mc is not None else None
    return x if g is None else _ReduceFrom.apply(x, g)


def token_sum(x: torch.Tensor) -> torch.Tensor:
    """``batch_sum`` and, under SP, the sum over the sequence shards too (g
    over ``model``): the loss's sums of ``nll`` and of the mask, each
    rank's over its own tokens."""
    x = batch_sum(x)
    g = seq_group()
    return x if g is None else _ReduceFrom.apply(x, g)


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The global tensor of a batch-sharded ``x`` (first dim), in global
    order; consumed replicated, so the gradient is sliced back.  The MoE's
    routing over the global token order (``models/moe.py:64-79``, which
    GSPMD computes on the global arrays)."""
    mc = current()
    g = batch_group(mc) if mc is not None else None
    return x if g is None else _Gather.apply(x, 0, g, "slice")


def batch_place() -> tuple:
    """(this rank's index, the number of batch shards)."""
    mc = current()
    if mc is None or mc.replicated_batch:
        return 0, 1
    axes = tuple(a for a in BATCH_AXES if a in mc.shape)
    return mc.index(axes), mc.size(axes)


# --------------------------------------------------------------------------
# vocab parallelism
# --------------------------------------------------------------------------
def vocab_embed(tok: torch.Tensor, ids: torch.Tensor, tp_: TP) -> torch.Tensor:
    """Embedding lookup in this rank's vocab rows, g over ``model`` (the
    reference's ``jnp.take`` from a ``("vocab", "embed")`` table,
    ``models/layers.py:228``).  Under SP ``ids`` (B, S / model) are this
    rank's sequence chunk: gathered first (no gradient), and the rows leave
    through ``reduce_from_model``'s reduce-scatter, each rank's chunk."""
    g = seq_group()
    if g is not None:
        ids = all_gather(ids, SEQ_DIM, g)
    rows = tok.shape[0]
    local = ids - tp_.rank * rows
    inside = (local >= 0) & (local < rows)
    e = tok[local.clamp(0, rows - 1)]
    e = torch.where(inside[..., None], e, torch.zeros((), dtype=e.dtype, device=e.device))
    return reduce_from_model(e, tp_)


def vocab_nll(logits: torch.Tensor, labels: torch.Tensor, tp_: TP) -> torch.Tensor:
    """-log softmax(logits)[label] of vocab-sharded f32 logits (B, S, V/m)
    (the reference's ``logsumexp`` and ``take_along_axis`` over a ``vocab``
    sharded axis, ``models/model.py:250-252``).  Each rank's logsumexp,
    gathered over ``model`` and combined by a logsumexp over the shards (of
    one shard: the value itself, so a 1x1 mesh gives ``torch.logsumexp``'s
    bits); the gold logit from the rank that holds it, g over ``model``."""
    rows = logits.shape[-1]
    lse = torch.logsumexp(logits, dim=-1)
    lse = torch.logsumexp(_Gather.apply(lse[None], 0, tp_.group, "slice"), dim=0)
    local = labels - tp_.rank * rows
    inside = (local >= 0) & (local < rows)
    gold = torch.gather(logits, -1, local.clamp(0, rows - 1)[..., None])[..., 0]
    gold = torch.where(inside, gold, torch.zeros((), dtype=gold.dtype, device=gold.device))
    return lse - reduce_from_model(gold, tp_)


# --------------------------------------------------------------------------
# the sequence-parallel decode
# --------------------------------------------------------------------------
def decode_partial(q: torch.Tensor, k_range: torch.Tensor, v_range: torch.Tensor,
                   length: torch.Tensor, offset: int):
    """The partial (o, lse) of the cache positions [offset, offset + S_r)
    that ``k_range`` / ``v_range`` (B, Hkv, S_r, D) hold: the decode kernel
    with ``return_lse`` at the local length clamp(length - offset, 0, S_r).
    A range wholly past ``length`` gives o = 0, lse = -inf."""
    from repro_torch.kernels import ops
    local = (length.to(torch.int64) - offset).clamp(0, k_range.shape[2]).to(torch.int32)
    return ops.decode_attention(q, k_range, v_range, length=local, return_lse=True)


def merge_partials(o: torch.Tensor, lse: torch.Tensor, reduce) -> torch.Tensor:
    """Flash-decoding's merge of partial (o, lse) over the ranges:
    ``reduce(t, op)`` combines ``t`` over them (``op`` a ``ReduceOp``, MAX
    or SUM).  m = max lse, w = exp(lse - m), out = sum(w o) / sum(w), in
    f32, returned in o's dtype.  A range with no valid key (lse = -inf)
    weighs 0; a row with none in any range gives 0."""
    m = reduce(lse, dist.ReduceOp.MAX)
    # an empty row everywhere has m = -inf: weigh it against 0 instead, so
    # that exp gives 0 and not NaN
    w = torch.exp(lse - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    num = reduce(o.float() * w[..., None], dist.ReduceOp.SUM)
    den = reduce(w, dist.ReduceOp.SUM)
    # den >= 1 wherever a key is valid (the range at the max weighs 1); 0
    # elsewhere, where num is 0 too
    return (num / den.clamp(min=1.0)[..., None]).to(o.dtype)


def decode_attention_sp(q: torch.Tensor, k_shard: torch.Tensor, v_shard: torch.Tensor,
                        length: Optional[torch.Tensor], group) -> torch.Tensor:
    """Decode attention over a KV cache whose sequence is split over
    ``group``: rank r holds the contiguous positions [r S_l, (r + 1) S_l) of
    the cache in ``k_shard`` / ``v_shard`` (B, Hkv, S_l, D); q (B, Hq, D)
    and ``length`` (B,) int32 (None: every position) are the same on every
    rank.  Returns the whole cache's (B, Hq, D) on every rank, in q's dtype.

    Each rank takes its ``decode_partial``, then ``merge_partials`` over the
    group: an all-reduce MAX of lse, all-reduce SUMs of exp(lse - m) o and
    of exp(lse - m) in f32, a division.  This is what GSPMD does for
    ``ref.decode_attention`` on an S-sharded cache
    (``tests/helpers/dist_checks.py`` ``check_decode_sp_longcontext``).  A
    rank whose range lies wholly past ``length`` (most ranks early in a long
    decode) adds weight 0.

    The model's decode does not call this: the reference's cache specs give
    ``model`` to ``kv_heads`` before ``kv_seq_sharded`` asks for it, so they
    never shard the sequence (ROADMAP Queue 3 item 15)."""
    s_l = k_shard.shape[2]
    if length is None:
        length = torch.full((q.shape[0],), s_l * dist.get_world_size(group),
                            dtype=torch.int32, device=q.device)
    o, lse = decode_partial(q, k_shard, v_shard, length, dist.get_rank(group) * s_l)
    return merge_partials(o, lse, lambda t, op: all_reduce(t, group, op=op))


# --------------------------------------------------------------------------
# counting
# --------------------------------------------------------------------------
@contextlib.contextmanager
def count_collectives():
    """Within the block, ``torch.distributed``'s all_reduce, all_gather and
    reduce_scatter are counted by kind: yields {kind: [calls, bytes]}, the
    bytes those a call hands over (an all-gather's gathered output, the
    others' input), per rank.  The originals are restored on leaving."""
    counts: dict = {}
    orig = {k: getattr(dist, k) for k in ("all_reduce", "all_gather", "reduce_scatter")}

    def nbytes(t) -> int:
        return sum(x.numel() * x.element_size() for x in t) if isinstance(t, (list, tuple)) \
            else t.numel() * t.element_size()

    def wrap(kind, fn):
        def counted(*args, **kw):
            c = counts.setdefault(kind, [0, 0])
            c[0] += 1
            c[1] += nbytes(args[1] if kind == "reduce_scatter" else args[0])
            return fn(*args, **kw)
        return counted
    for k, fn in orig.items():
        setattr(dist, k, wrap(k, fn))
    try:
        yield counts
    finally:
        for k, fn in orig.items():
            setattr(dist, k, fn)
