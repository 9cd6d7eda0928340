"""The train, prefill and decode steps of the port.

Two train-step builders share the name ``make_train_step``, told apart by
their second argument:

* ``make_train_step(cfg, model, ...)``: one card, no mesh (PR 19);
* ``make_train_step(cfg, pcfg, mc, ...)``: the port of
  ``repro.distributed.step.make_train_step``, over the mesh of ``mc``,
  returning ``(step, (param_sh, opt_sh, batch_sh))`` as the reference does.

loss -> backward -> global-norm clip -> AdamW with the cosine learning rate;
every metric a 0-d device tensor, so a step never waits for the device.
The one-card step's phases are the spans ``repro.train.forward``,
``repro.train.backward`` and ``repro.train.optimizer`` (``core/telemetry``:
no-ops unless a trace or a ``torch.profiler`` session records).  On
the card every family's gradient runs on the port's kernels (``kernels.ops``
under autograd), each block recomputed in the backward under remat "full":

* dense: attention's forward and backward on the flash kernels
  (``FlashAttention``);
* moe (granite_moe_1b): the flash kernels, and the experts' grouped
  matmuls forward and backward (dX and dW) on ``csrc/grouped_matmul.cu``
  (``GroupedMatmul``);
* hybrid (zamba2_1_2b): the Mamba2 scan forward and backward on
  ``csrc/ssm_scan.cu`` and the decay-gradient kernel ``csrc/ssm_scan_bwd.cu``
  (``SsmScan``), and the shared attention block's flash kernels;
* ssm (xlstm_1_3b): both mLSTM scans (y and the normaliser) on the same
  scan kernels; the sLSTM forward and backward on ``csrc/slstm.cu``
  (``SlstmScan``), where the reference runs a ``lax.scan``.

The sharded step (GSPMD's work, done by hand): parameters, gradients and
moments are this rank's shards of the reference's specs (``partition.py``;
``place_params`` cuts a model to them).  The forward issues the layers'
collectives (``collectives.py``: FSDP gathers over ``data`` inside the
remat'd blocks, whose backward reduce-scatters; Megatron's f and g over
``model``; the MoE's global routing; the vocab-parallel cross-entropy; the
loss's sums over the batch shards).  After the backward each gradient is
summed over the batch axes its parameter is replicated on: all-reduced, or
reduce-scattered to its moments' shard under ZeRO-1 without FSDP, where
each rank updates its slice of the parameter and the slices are then
all-gathered.  The clip's squared norms are summed over the axes each
gradient is sharded on.  The kernels see plain local tensors; at mesh 1x1
every collective is over one rank and the step launches the same kernels in
the same order as the one-card step.

Sequence parallelism (``mc.sp``: rules that map ``"seq"`` to ``model``, the
dry run's ``sp`` variants): the train and prefill batches are cut along
the sequence over ``model`` too (``batch_shardings``), the residual stream
stays this rank's chunk between the layers (``collectives.py``), and
``sync_grads`` first all-reduces over ``model`` the gradients of the
parameters applied to those rows (``partition.row_params``).  A sequence
that ``model`` does not divide is refused where the batch is cut
(``NamedSharding.local_shape``); the reference would pad it.  The decode
step keeps its one-token residual whole on every rank
(``MeshContext.with_replicated_seq``), as the reference's decode, which
states no ``("batch", "seq")`` layout, does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.core import telemetry
from repro_torch.models.model import Model, decode_step, forward, init_cache, loss_fn
from repro_torch.optim import AdamWState, adamw_update, cosine_schedule
from repro_torch.models.layers import dtype_of
from . import collectives as C
from .partition import (batch_shardings, cache_logical_axes, logical_to_sharding,
                        param_logical_axes, param_shapes, row_params, tree_map, zero1_axes)
from .sharding import MeshContext, NamedSharding, spec_axes, use_mesh

Metrics = Dict[str, torch.Tensor]


def make_train_step(cfg: ModelConfig, target, mc: MeshContext = None, *,
                    peak_lr: float = 3e-4, warmup: int = 100, total_steps: int = 10_000):
    """``target`` a ``Model``: the one-card step, ``step(opt, batch) -> (opt,
    metrics)``, updating the model's parameters in place (made trainable
    here).  ``target`` a ``ParallelConfig``: the sharded step over ``mc``,
    returned as ``(step, (param_sh, opt_sh, batch_sh))`` with
    ``step(model, opt, batch) -> (model, opt, metrics)`` on a model placed by
    ``place_params(model, param_sh)``, moments from ``init_opt_state`` and a
    batch from ``make_device_batch(batch, batch_sh)``.  Metrics ``loss``,
    ``aux``, ``ppl_log``, ``grad_norm``, ``lr`` (global values).  Every
    family trains; the module docstring lists the kernels each one's
    gradient runs on."""
    if isinstance(target, ParallelConfig):
        return _sharded_train_step(cfg, target, mc, peak_lr, warmup, total_steps)
    model = target
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def step(opt: AdamWState, batch: Dict[str, torch.Tensor]) -> Tuple[AdamWState, Metrics]:
        with telemetry.span("repro.train.forward"):
            total, metrics = loss_fn(model, batch)
        with telemetry.span("repro.train.backward"):
            total.backward()
        with telemetry.span("repro.train.optimizer"):
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in params.items()}
            lr = cosine_schedule(opt.step, peak_lr=peak_lr, warmup=warmup, total=total_steps)
            _, opt, om = adamw_update(grads, opt, params, lr=lr)
            for p in params.values():
                p.grad = None
        metrics = dict(metrics)
        metrics.update(om)
        metrics["lr"] = lr
        return opt, metrics

    return step


# --------------------------------------------------------------------------
# shardings
# --------------------------------------------------------------------------
def _known_sizes(cfg: ModelConfig, mc: MeshContext) -> MeshContext:
    """Tells ``shard_hint`` the global sizes of the model's fixed axes."""
    mc.sizes.update(embed=cfg.d_model, vocab=cfg.padded_vocab_size)
    return mc


def _seq_size(mc: MeshContext, batch: Dict[str, torch.Tensor]) -> None:
    """Tells ``shard_hint`` the batch's global sequence length (each entry
    of this rank's batch holds its share of it), so that every ``("batch",
    "seq", ...)`` hint asserts the sequence's shard."""
    mc.sizes["seq"] = next(iter(batch.values())).shape[1] * mc.size(mc.seq_axes)


def make_param_shardings(cfg: ModelConfig, mc: MeshContext, fsdp: bool = False):
    """({name: NamedSharding}, {name: logical axes}, {name: global shape});
    ``fsdp`` adds the ZeRO shard over ``data`` to the parameters."""
    logical = param_logical_axes(cfg)
    shapes = param_shapes(cfg)
    if fsdp:
        logical = zero1_axes(logical, shapes, mc.shape.get("data", 1))
    return logical_to_sharding(logical, mc, shapes), logical, shapes


def make_opt_shardings(cfg: ModelConfig, pcfg: ParallelConfig, mc: MeshContext,
                       logical, shapes) -> AdamWState:
    """AdamWState of shardings: the step replicated, the moments ZeRO-1
    sharded over ``data`` when ``pcfg.zero1``."""
    zl = zero1_axes(logical, shapes, mc.shape.get("data", 1)) if pcfg.zero1 else logical
    return AdamWState(NamedSharding(mc, ()), logical_to_sharding(zl, mc, shapes),
                      logical_to_sharding(zl, mc, shapes))


@torch.no_grad()
def place_params(model: Model, param_sh: Dict[str, NamedSharding]) -> Model:
    """Cuts every parameter of ``model`` (whole, as ``init_params`` or
    ``from_jax_params`` make it) to this rank's shard, in place; each then
    carries its ``sharding`` and ``global_shape``.  Returns the model."""
    for name, p in model.named_parameters():
        sh = param_sh[name]
        p.global_shape = tuple(p.shape)
        p.data = sh.local_slice(p.data).clone()
        p.sharding = sh
    return model


def init_opt_state(model: Model, opt_sh: AdamWState, cfg: ModelConfig) -> AdamWState:
    """Zero moments of this rank's shards (``adamw_init`` on shards)."""
    dt1, dt2 = dtype_of(cfg.optim_state_dtype), dtype_of(cfg.optim_second_dtype or "float32")
    m, v = {}, {}
    for name, p in model.named_parameters():
        shape = getattr(p, "global_shape", tuple(p.shape))
        m[name] = torch.zeros(opt_sh.m[name].local_shape(shape), dtype=dt1, device=p.device)
        v[name] = torch.zeros(opt_sh.v[name].local_shape(shape), dtype=dt2, device=p.device)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=model.device), m, v)


# --------------------------------------------------------------------------
# the sharded train step
# --------------------------------------------------------------------------
def _batch_axes(mc: MeshContext):
    return tuple(a for a in C.BATCH_AXES if a in mc.shape)


def _dim_of(sh: NamedSharding, axis: str):
    """The tensor dim ``sh`` shards over ``axis`` (None if none)."""
    return next((i for i, e in enumerate(sh.spec) if axis in spec_axes(e)), None)


def sync_grads(model: Model, param_sh, opt_sh: AdamWState, mc: MeshContext
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Each parameter's gradient summed over the batch axes its parameter
    is replicated on (an axis it is sharded on was summed by its gather's
    reduce-scatter): all-reduced, or reduce-scattered where its moments are
    sharded on the axis (ZeRO-1 without FSDP).  Under SP the gradients of
    the parameters applied to the residual stream's rows
    (``partition.row_params``) are first summed over the sequence shards,
    one all-reduce over ``model`` a dtype.  Returns (gradients in their
    moments' sharding, the tensors the update writes: each parameter or its
    slice of the moments' shard)."""
    grads, views = {}, {}
    params = dict(model.named_parameters())
    whole = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.items()}
    if mc.sp:
        by_dtype: Dict[torch.dtype, list] = {}
        for n in row_params(param_sh):
            by_dtype.setdefault(whole[n].dtype, []).append(n)
        for names in by_dtype.values():
            flat = C.all_reduce(torch.cat([whole[n].reshape(-1) for n in names]),
                                mc.group(mc.seq_axes))
            parts = flat.split([whole[n].numel() for n in names])
            for n, part in zip(names, parts):
                whole[n] = part.view_as(whole[n])
    for name, p in params.items():
        g = whole[name]
        view = p.data
        held = param_sh[name].sharded_axes()
        for a in _batch_axes(mc):
            if a in held:
                continue
            dim = _dim_of(opt_sh.m[name], a)
            if dim is None:
                g = C.all_reduce(g, mc.group(a))
            else:
                g = C.reduce_scatter(g, dim, mc.group(a))
                view = C.own_chunk(view, dim, mc.group(a))
        grads[name], views[name] = g, view
    return grads, views


def _norm_reduce(opt_sh: AdamWState, mc: MeshContext):
    """The clip's ``reduce``: each squared norm summed over the mesh axes
    its gradient is sharded on (its moments' spec), and only those; one
    all-reduce per axis over the stacked norms that share it."""
    def reduce(sq: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = dict(sq)
        by_axes: Dict[Tuple[str, ...], list] = {}
        for name in sq:
            axes = opt_sh.m[name].sharded_axes()
            if axes:
                by_axes.setdefault(axes, []).append(name)
        for axes, names in by_axes.items():
            v = torch.stack([sq[n] for n in names])
            for a in axes:
                v = C.all_reduce(v, mc.group(a))
            out.update(zip(names, v.unbind(0)))
        return out
    return reduce


def _sharded_train_step(cfg, pcfg, mc, peak_lr, warmup, total_steps):
    _known_sizes(cfg, mc)
    param_sh, logical, shapes = make_param_shardings(cfg, mc, fsdp=pcfg.fsdp)
    opt_sh = make_opt_shardings(cfg, pcfg, mc, logical, shapes)
    batch_sh = batch_shardings(cfg, "train", mc)
    reduce = _norm_reduce(opt_sh, mc)

    def step(model: Model, opt: AdamWState, batch: Dict[str, torch.Tensor]):
        model.requires_grad_(True)
        _seq_size(mc, batch)
        with use_mesh(mc):
            total, metrics = loss_fn(model, batch)
            total.backward()
        grads, views = sync_grads(model, param_sh, opt_sh, mc)
        lr = cosine_schedule(opt.step, peak_lr=peak_lr, warmup=warmup, total=total_steps)
        _, opt, om = adamw_update(grads, opt, views, lr=lr, reduce=reduce)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.grad = None
                if views[name].shape != p.shape:      # ZeRO-1 slices: gather them back
                    full = views[name]
                    for a in reversed(_batch_axes(mc)):
                        dim = _dim_of(opt_sh.m[name], a)
                        if dim is not None and a not in param_sh[name].sharded_axes():
                            full = C.all_gather(full, dim, mc.group(a))
                    p.copy_(full)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["lr"] = lr
        return model, opt, metrics

    return step, (param_sh, opt_sh, batch_sh)


# --------------------------------------------------------------------------
# prefill and decode
# --------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig, pcfg: ParallelConfig, mc: MeshContext):
    """``(prefill, (param_sh, batch_sh))``: ``prefill(model, batch)`` gives
    this rank's logits, sharded ``("batch", "seq", "vocab")`` (under SP the
    sequence over ``model`` and the vocab whole, as the reference's)."""
    _known_sizes(cfg, mc)
    param_sh, _, _ = make_param_shardings(cfg, mc)
    batch_sh = batch_shardings(cfg, "prefill", mc)

    @torch.no_grad()
    def prefill(model: Model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        _seq_size(mc, batch)
        with use_mesh(mc):
            logits, _ = forward(model, tokens=batch.get("tokens"), embeds=batch.get("embeds"))
        return logits

    return prefill, (param_sh, batch_sh)


def cache_shardings(cfg: ModelConfig, mc: MeshContext, batch: int, max_seq: int,
                    long_context: bool = False):
    """The decode cache's shardings (``init_cache``'s structure)."""
    shapes = tree_map(lambda t: tuple(t.shape), init_cache(cfg, batch, max_seq, device="meta"))
    return logical_to_sharding(cache_logical_axes(cfg, long_context=long_context), mc, shapes)


def init_sharded_cache(cfg: ModelConfig, batch: int, max_seq: int, cache_sh) -> dict:
    """This rank's shard of an empty decode cache, on the mesh's device."""
    full = init_cache(cfg, batch, max_seq, device="meta")
    return tree_map(lambda t, sh: torch.zeros(sh.local_shape(t.shape), dtype=t.dtype,
                                              device=sh.mc.device), full, cache_sh)


def make_decode_step(cfg: ModelConfig, pcfg: ParallelConfig, mc: MeshContext, batch: int,
                     max_seq: int, long_context: bool = False):
    """serve_step: one new token against a KV cache of ``max_seq``.
    ``(serve_step, (param_sh, cache_sh, tok_sh))`` with
    ``serve_step(model, cache, token, pos) -> (logits, cache)`` on this
    rank's shards (logits ``("batch", "vocab")``; the cache from
    ``init_sharded_cache``, updated in place).  ``long_context`` gives the
    cache the reference's long-context specs (equal to the others:
    ``cache_logical_axes``).  A batch that the batch shards do not divide
    (the long-context cells' batch of 1) is replicated, as the reference's
    ``tok_sh`` is, and the step runs in ``mc.with_replicated_batch()``:
    every rank computes the whole batch, and no collective sums it over
    the batch axes.  Under SP rules the one-token residual stays whole on
    every rank (``mc.with_replicated_seq()``): the step is the base rules'
    step."""
    _known_sizes(cfg, mc)
    param_sh, _, _ = make_param_shardings(cfg, mc)
    cache_sh = cache_shardings(cfg, mc, batch, max_seq, long_context)
    # divisibility-aware: batch=1 long-context cells replicate the batch axis
    tok_sh = logical_to_sharding(("batch",), mc, (batch,))
    step_mc = mc if tok_sh.spec[0] else mc.with_replicated_batch()
    if step_mc.sp:
        step_mc = step_mc.with_replicated_seq()

    def serve_step(model: Model, cache, token: torch.Tensor, pos: torch.Tensor):
        with use_mesh(step_mc):
            return decode_step(model, cache, token, pos)

    return serve_step, (param_sh, cache_sh, tok_sh)


# --------------------------------------------------------------------------
# stand-ins for every model input (dry-run contract)
# --------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeConfig, for_grad: bool = False
                ) -> Dict[str, torch.Tensor]:
    """``meta`` tensors for one (arch x shape) cell -- no allocation."""
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    if shape.kind in ("train", "prefill"):
        out = {"labels": torch.empty((b, s), dtype=torch.int32, device=meta)}
        if cfg.frontend:
            out["embeds"] = torch.empty((b, s, cfg.d_model), dtype=torch.bfloat16, device=meta)
        else:
            out["tokens"] = torch.empty((b, s), dtype=torch.int32, device=meta)
        return out
    return {"token": torch.empty((b,), dtype=torch.int32, device=meta),
            "pos": torch.empty((b,), dtype=torch.int32, device=meta)}
