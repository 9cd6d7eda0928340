"""The JAX package's shardings, printed as JSON for the port's tests.

Run in a subprocess with 8 fake CPU devices (the device-count flag must be
set before JAX starts, so it cannot run in the pytest process):

    python tests/torch_dist_specs.py CASES_JSON

CASES_JSON: a list of [arch, overrides, mesh name, fsdp, zero1] and,
optionally, sharding-rule overrides (``{"seq": ["model"]}``: the dry run's
``sp`` rules), the config the reduced one with the overrides (``"full"``:
the config itself).  Prints one JSON object: under ``"specs"``, a list with
one entry per case, its parameter, moment, decode-cache (and long-context
decode-cache), batch and prefill-logits specs of ``repro.distributed``,
each spec a list with one entry per dimension (``null``, a mesh-axis name,
or a list of names); under ``"moe_loss"`` the loss of one reference train
step on a capacity-dropping granite config, sharded over a 2x2 mesh and on
one device; and under ``"dryrun_argument_bytes"`` XLA's argument bytes a
device of the reference's small-mesh dry-run cell, under the base rules
(``"base"``) and the ``sp`` rules (``"sp"``).
"""
import os
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import json
import sys

import jax
import numpy as np
from jax.sharding import Mesh

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.configs.base import ParallelConfig, ShapeConfig, get_config, reduced  # noqa: E402
from repro.distributed import step as step_mod  # noqa: E402
from repro.distributed.partition import (batch_shardings, cache_logical_axes,  # noqa: E402
                                         logical_to_sharding)
from repro.distributed.sharding import current, use_mesh  # noqa: E402
from repro.models import init_cache, init_params  # noqa: E402

MESHES = {"1x1": ((1, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CACHE = (8, 16)            # decode cache batch, max_seq
# the config of the MoE check: reduced granite, capacity low enough to drop
MOE_CAPACITY = 0.5
MOE_SHAPE = (4, 32)        # global batch, seq


def mesh_of(name):
    shape, axes = MESHES[name]
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): enc(s.spec)
            for p, s in flat}


def specs(cfg, mesh_name, fsdp, zero1, rules=None):
    with use_mesh(mesh_of(mesh_name), rules=rules):
        mc = current()
        param_sh, logical, shapes = step_mod.make_param_shardings(cfg, mc, fsdp=fsdp)
        opt_sh = step_mod.make_opt_shardings(cfg, ParallelConfig(fsdp=fsdp, zero1=zero1), mc,
                                             logical, shapes)
        cache_shapes = jax.eval_shape(lambda: init_cache(cfg, *CACHE))
        cache_sh = logical_to_sharding(cache_logical_axes(cfg), mc, cache_shapes)
        long_sh = logical_to_sharding(cache_logical_axes(cfg, long_context=True), mc,
                                      cache_shapes)
        return {"params": paths(param_sh), "opt": paths(opt_sh.m),
                "cache": paths(cache_sh), "cache_long": paths(long_sh),
                "batch": {k: paths(batch_shardings(cfg, k, mc))
                          for k in ("train", "prefill", "decode")},
                "logits": enc(mc.sharding(("batch", "seq", "vocab")).spec)}


def moe_loss():
    """The reference's own sharded step against its one-device step."""
    from repro.data import SyntheticLM, make_device_batch
    from repro.optim import adamw_init
    cfg = reduced(get_config("granite_moe_1b"), capacity_factor=MOE_CAPACITY)
    b, s = MOE_SHAPE
    batch_np = SyntheticLM(cfg, ShapeConfig("t", s, b, "train"), seed=1).batch_at(0)
    out = {}
    for name in ("1x1", "2x2"):
        with use_mesh(mesh_of(name)):
            mc = current()
            jitted, (param_sh, opt_sh, batch_sh) = step_mod.make_train_step(
                cfg, ParallelConfig(), mc)
            params = jax.jit(lambda k: init_params(k, cfg), out_shardings=param_sh)(
                jax.random.key(3))
            _, _, metrics = jitted(params, adamw_init(params),
                                   make_device_batch(batch_np, batch_sh))
            out[name] = float(metrics["loss"])
    return out


def dryrun_argument_bytes(rules=None):
    """``check_dryrun_small_mesh``'s cell (reduced granite, vocab 256, a
    train step of 8 x 64 at 2x2x2) under the sharding-rule overrides
    ``rules``: XLA's argument bytes a device."""
    from repro.optim import adamw_init
    cfg = reduced(get_config("granite_moe_1b"), vocab_size=256)
    with use_mesh(mesh_of("2x2x2"), rules=rules):
        jitted, _ = step_mod.make_train_step(cfg, ParallelConfig(), current())
        params = jax.eval_shape(lambda k: init_params(k, cfg),
                                jax.ShapeDtypeStruct((), jax.random.key(0).dtype))
        opt = jax.eval_shape(lambda p: adamw_init(p), params)
        batch = step_mod.input_specs(cfg, ShapeConfig("t", 64, 8, "train"))
        compiled = jitted.lower(params, opt, batch).compile()
        return int(compiled.memory_analysis().argument_size_in_bytes)


def main():
    out = []
    for arch, overrides, mesh_name, fsdp, zero1, *rules in json.loads(sys.argv[1]):
        cfg = get_config(arch) if overrides == "full" else reduced(get_config(arch), **overrides)
        out.append(specs(cfg, mesh_name, fsdp, zero1, *rules))
    print(json.dumps({"specs": out, "moe_loss": moe_loss(),
                      "dryrun_argument_bytes": {
                          "base": dryrun_argument_bytes(),
                          "sp": dryrun_argument_bytes({"seq": ("model",)})}}))


if __name__ == "__main__":
    main()
