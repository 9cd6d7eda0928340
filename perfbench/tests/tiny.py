"""Small cells made from temporary files, for the CPU tests: a root that
holds the repository's ``BENCHMARK.json`` with five cells added (a hybrid
and an moe train cell, a hybrid prefill cell, and two hybrid train cells
whose configurations name references that exist only under the root: one
cut in depth, with a model count of its own, and one with no count), their
configurations, traffic mixes and limits, the prefill metrics and one new
per-layer metric with its reader.  No file of the repository is edited."""
from __future__ import annotations

import copy
import json
from pathlib import Path

from perfbench.lib.manifest import ROOT, cut_key

HYBRID = dict(name="tiny_hybrid", family="hybrid", num_layers=2, d_model=32, num_heads=2,
              num_kv_heads=2, d_ff=64, vocab_size=256, head_dim=16, ssm_state=8, ssm_heads=2,
              ssm_expand=2, attn_every=2, num_experts=0, experts_per_token=0,
              tie_embeddings=False, dtype="float32", param_dtype="float32")
MOE = dict(name="tiny_moe", num_layers=2, d_model=32, num_heads=2, num_kv_heads=1, d_ff=16,
           vocab_size=256, head_dim=16, num_experts=4, experts_per_token=2,
           capacity_factor=1.25, dtype="float32", param_dtype="float32")
# the hybrid block under a reference name of its own, cut from 4 layers to 2
CUT = dict(HYBRID, name="tiny_cut", reference="tiny_ref",
           reduced=["num_layers: 2 of 4, a CPU test's cut in depth"],
           published={"num_layers": 4}, changed_from_the_port_preset={})
UNCOUNTED = dict(HYBRID, name="tiny_uncounted", reference="tiny_uncounted")
CELLS = {"tiny_hybrid.train": ("tiny_hybrid", "train_tiny"),
         "tiny_moe.train": ("tiny_moe", "train_tiny"),
         "tiny_hybrid.prefill": ("tiny_hybrid", "prefill_tiny"),
         "tiny_cut.train": ("tiny_cut", "train_tiny"),
         "tiny_uncounted.train": ("tiny_uncounted", "train_tiny")}
COUNTED = ["tiny_hybrid.train", "tiny_moe.train", "tiny_cut.train"]
TRAIN_LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2}
PREFILL_LIMITS = {"logit_gap": 1e-3}
READER = '''"""steps_traced: the traced window's steps (a reader added as a new file)."""


def read(name, trace):
    return float(trace.steps) if trace.steps else None
'''
REFERENCE = '''"""The hybrid family's plain reference under a name of its own (a reference
added as a new file); it records the batches it is given."""
from perfbench.reference import hybrid

CALLS = []


def param_specs(cfg):
    return hybrid.param_specs(cfg)


def hidden(p, tokens, cfg):
    CALLS.append(tuple(tokens.shape))
    return hybrid.hidden(p, tokens, cfg)
'''
COUNT = '''"""Model FLOPs of the tiny_ref reference (a count added as a new file): a
fixed number a token."""
PER_TOKEN = 1.0e6


def train_step(cfg, batch, seq):
    return 3 * PER_TOKEN * batch * seq


def prefill(cfg, batch, seq):
    return PER_TOKEN * batch * seq
'''


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(obj if isinstance(obj, str) else json.dumps(obj, indent=1))


def full(small: dict) -> dict:
    """A small configuration with every other key of granite_moe_1b's file."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "granite_moe_1b")
    return {**copy.deepcopy(json.loads((ROOT / entry["file"]).read_text())), **small}


def make_root(tmp: Path, **overrides) -> Path:
    """The root; ``overrides`` change every small configuration (e.g. their
    dtypes)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for small in (HYBRID, MOE, CUT, UNCOUNTED):
        cfg = {**full(small), **overrides}
        path = f"perfbench/configs/{small['name']}.json"
        write(tmp / path, cfg)
        bench["configs"].append({"name": small["name"], "source": "tests", "file": path,
                                 "reduced": [cut_key(e) for e in cfg["reduced"]],
                                 "why": "a CPU test"})
    for name in ("tiny_ref", "tiny_uncounted"):
        write(tmp / f"perfbench/reference/{name}.py", REFERENCE)
    write(tmp / "perfbench/counts/model_tiny_ref.py", COUNT)
    train = json.loads((ROOT / "perfbench/traffic/train_4k.json").read_text())
    write(tmp / "perfbench/traffic/train_tiny.json", {**train, "batch": 2, "seq": 16})
    pre = json.loads((ROOT / "perfbench/traffic/prefill_mix.json").read_text())
    write(tmp / "perfbench/traffic/prefill_tiny.json",
          {**pre, "cycle": [[8, 2], [16, 1], [32, 1]], "trace_requests": 4})
    for cell, (config, traffic) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "a CPU test"})
        limits = PREFILL_LIMITS if traffic.startswith("prefill") else TRAIN_LIMITS
        write(tmp / f"perfbench/limits/{cell}.json", {"limits": limits})
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    trains = [c for c in CELLS if c.endswith(".train")]
    e2e["train_tokens_per_s"]["workloads"] += trains
    for name, unit, better in (("prefill_tokens_per_s", "tokens/s", "higher"),
                               ("prefill_ms_p95", "ms", "lower")):
        bench["end_to_end"].append({"name": name, "unit": unit, "better": better,
                                    "bound": 0.25, "source": "host_clock",
                                    "workloads": ["tiny_hybrid.prefill"]})
    layer = {m["name"]: m for m in bench["per_layer"]}
    layer["mfu.train"]["workloads"] += COUNTED
    bench["per_layer"].append({"name": "mfu.prefill", "unit": "%", "better": "higher",
                               "source": "host_clock", "layer": "model step",
                               "moves": "prefill_tokens_per_s",
                               "workloads": ["tiny_hybrid.prefill"]})
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                               "source": "program_span", "layer": "model step",
                               "moves": "train_tokens_per_s",
                               "workloads": trains})
    write(tmp / "perfbench/metrics/steps_traced.py", READER)
    write(tmp / "BENCHMARK.json", bench)
    return tmp
