"""POM core of the port: the paper's DSL, three-level IR and DSE, with a
CUDA backend for the H100.

A copy of ``repro.core`` (the port imports nothing of the JAX package), with
its Pallas backend replaced by ``backend_cuda.py``.  Layers (paper Fig. 7),
top to bottom:
  dsl.py         — POM DSL (var/placeholder/compute + scheduling primitives)
  graph_ir.py    — Graph IR: dataflow graph of compute ops (fusion / DCE /
                   CSE sharing at graph level)
  ir.py          — polyhedral IR (statements: domains + accesses + schedules)
  depgraph.py    — dependence-graph analysis (coarse + fine-grained)
  affine.py      — mini-isl (integer sets/maps, FM elimination, dependence polyhedra)
  transforms.py  — polyhedral loop transformations (interchange/split/tile/skew/…)
  astbuild.py    — polyhedral AST build (isl ast_build analogue)
  loop_ir.py     — annotated loop IR (affine dialect + HLS attributes analogue)
  pipeline.py    — PassManager spine: named passes, per-stage verifiers,
                   POM_DUMP_IR debugging, the `compile(fn, target=...)` entry
  backend_hls.py — synthesizable HLS C emitter (lowering pass)
  backend_jax.py — executable oracle (numpy interpreter, lowering pass; it
                   imports no JAX, the name mirrors the reference file)
  backend_cuda.py — contraction-kernel lowering + whole-program executors
  cost_model.py  — HLS (XC7Z020) analytical model and the H100 roofline
  dse.py         — two-stage DSE engine, run as pipeline passes
"""
from .cost_model import H100, HopperModel, HopperSpec, RooflineTerms
from .dsl import ComputeHandle, PomFunction, Var, compute, function, placeholder, var
from .errors import PomError, PomUserError, PomWarning
from .ir import (Placeholder, p_bfloat16, p_float32, p_float64, p_int8, p_int16,
                 p_int32, p_int64, p_uint8, p_uint16, p_uint32, p_uint64)
from .pipeline import (CompileService, PassManager, ServiceResult, VerifyError,
                       compile, compile_many, serve)
from .telemetry import metrics
from . import telemetry

# NOTE: `compile` is importable explicitly (`from repro_torch.core import
# compile`) but deliberately left out of __all__ so `import *` never shadows
# the builtin.
__all__ = [
    "function", "var", "placeholder", "compute", "PomFunction", "ComputeHandle",
    "Var", "Placeholder", "PassManager", "VerifyError",
    "serve", "compile_many", "CompileService", "ServiceResult",
    "telemetry", "metrics",
    "PomError", "PomUserError", "PomWarning",
    "p_int8", "p_int16", "p_int32", "p_int64",
    "p_uint8", "p_uint16", "p_uint32", "p_uint64",
    "p_float32", "p_float64", "p_bfloat16",
    "H100", "HopperModel", "HopperSpec", "RooflineTerms",
]
