"""The families' reduced train step in float64 on both sides: the port's plain
versions against the JAX package with ``jax_enable_x64``.

``tests/test_torch_train_families.py`` holds reduced zamba2's f32 gradients
to 1e-2 of JAX's (``GRAD_TOL``), where granite's and xlstm's sit within
1e-4, and puts the gap down to f32 conditioning.  This probe tells a formula
apart from rounding: both models' explicit f32 casts (``jnp.float32``,
``torch.float32``, ``Tensor.float``) are pointed at float64 in a subprocess
of its own, the same f64 weights (the JAX package's initialisation, cast)
and batch go through ``repro.models.loss_fn`` under ``jax.value_and_grad``
and through the port's ``loss_fn`` and autograd on the CPU.  A wrong
formula on either side would move a gradient by O(1) of its size; f64
rounding over a few layers moves it by ~1e-13.  Measured: reduced zamba2's
loss agrees exactly and its gradients within 1.1e-13 of their largest value
(granite 4.6e-15, xlstm 2.9e-14), so neither side is at fault and the f32
gap is rounding.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parent.parent
# f64 rounding through the reduced models' four layers, with headroom; a
# formula that differs moves a gradient by O(1) of its largest value
F64_GRAD_REL = 1e-10
F64_LOSS_REL = 1e-12

PROBE = r'''
import json, sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
jnp.float32 = jnp.float64                  # the reference's explicit f32 casts
import torch
torch.float32 = torch.float64              # the port's dtype arguments ...
torch.Tensor.float = torch.Tensor.double   # ... and .float() casts
from repro.configs.base import ShapeConfig, get_config as jget_config, reduced as jreduced
from repro.data import SyntheticLM
from repro.models import init_params, loss_fn as jloss_fn
from repro_torch.configs import get_config, reduced
from repro_torch.data import make_device_batch
from repro_torch.models import loss_fn
from repro_torch.models.convert import from_jax_params

arch = sys.argv[1]
jcfg, tcfg = jreduced(jget_config(arch)), reduced(get_config(arch))
params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                init_params(jax.random.key(11), jcfg))
batch = SyntheticLM(jcfg, ShapeConfig("t", 64, 2, "train"), seed=5).batch_at(7)
(jtotal, _), jgrads = jax.value_and_grad(
    lambda p: jloss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
    has_aux=True)(params)
model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
model.requires_grad_(True)
total, _ = loss_fn(model, make_device_batch(batch, "cpu"))
total.backward()
want = {}


def walk(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            walk(v, f"{prefix}{k}.")
        else:
            want[f"{prefix}{k}"] = np.asarray(v)


walk(jgrads, "")
worst, where = 0.0, None
for name, p in model.named_parameters():
    if name.startswith("blocks."):
        _, i, rest = name.split(".", 2)
        w = want["blocks." + rest][int(i)]
    else:
        w = want[name]
    g = p.grad.detach().numpy() if p.grad is not None else np.zeros_like(w)
    rel = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-300))
    if rel > worst:
        worst, where = rel, name
print(json.dumps({"dtypes": sorted({str(p.dtype) for p in model.parameters()}
                                   | {str(total.dtype), str(jtotal.dtype)}),
                  "loss_rel": abs(float(total) - float(jtotal)) / abs(float(jtotal)),
                  "grad_rel": worst, "where": where}))
'''


@pytest.mark.parametrize("arch", ["zamba2_1_2b", "granite_moe_1b"])
def test_reduced_family_matches_jax_in_float64(arch):
    """Reduced zamba2 (and granite, whose f32 gap is already 1e-4) in f64:
    loss within 1e-12 and every gradient within 1e-10 of its largest value
    of JAX's, every tensor of both runs float64."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-W", "ignore", "-c", PROBE, arch], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["dtypes"] == ["float64", "torch.float64"], got
    assert got["loss_rel"] <= F64_LOSS_REL, got
    assert got["grad_rel"] <= F64_GRAD_REL, got
