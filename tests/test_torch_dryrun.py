"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

A cell runs in a subprocess, as rank 0 of a fake process group, on
``meta`` tensors.  Held here:

* its FLOPs: reduced smollm's sharded train step at mesh 1x1 counts, on
  ``meta``, what a real run of the same step on the CPU counts under
  ``FlopCounterMode`` -- PyTorch's own operators counted by the mode, the
  kernels by their roofline formulas (``kernels/meta.py``) on the shapes
  each call sees (on the CPU the kernels' plain versions run, and what the
  mode counts inside them is set aside);
* the reference's depth P / 2P extrapolation, exact for smollm (P 1);
* the variants: every one of ``dryrun.VARIANTS`` runs; sp's rules split
  the sequence (at mesh 1x1 over one rank: the base step's FLOPs);
  chunk2k's attn_chunk has no effect in the port and is recorded so, its
  FLOPs, bytes and collectives those of base (of bf16logits with it);
* the command line: zamba2_1_2b's long_500k cell at the production 16x16
  mesh (256 fake ranks) gives ``ok``, smollm_360m's is ``skipped``.

The collectives of the 2x2 cells against a gloo run, and the argument
bytes against XLA's, are held in ``tests/test_torch_distributed.py``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticLM, make_device_batch
from repro_torch.distributed import step as step_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import meta as kernel_meta
from repro_torch.launch import dryrun
from repro_torch.models import init_params
from repro_torch.optim import adamw_init

ROOT = Path(__file__).resolve().parent.parent
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
TRAIN = (2, 64)                    # reduced smollm's train cell: batch, seq
VARIANTS = list(dryrun.VARIANTS)


def _smollm():
    return reduced(get_config("smollm_360m"), remat="full")


@pytest.fixture(scope="module")
def smollm_1x1():
    """Reduced smollm's train cell at mesh 1x1 under each variant."""
    b, s = TRAIN
    code = (
        "import json, sys\n"
        "from repro_torch.configs import get_config, reduced\n"
        "from repro_torch.configs.base import ShapeConfig\n"
        "from repro_torch.launch.dryrun import run_cell\n"
        "b, s = json.loads(sys.argv[1])\n"
        "cfg = reduced(get_config('smollm_360m'), remat='full')\n"
        "print(json.dumps({v: run_cell('smollm_360m', ShapeConfig('t', s, b, 'train'),\n"
        "                              mesh='1x1', cfg=cfg, variant=v)\n"
        "                  for v in json.loads(sys.argv[2])}))\n")
    r = subprocess.run([sys.executable, "-c", code, json.dumps([b, s]), json.dumps(VARIANTS)],
                       cwd=ROOT, capture_output=True, text=True, timeout=300, env=ENV)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_meta_flops_equal_a_cpu_run(smollm_1x1, monkeypatch):
    """The dry run's FLOPs of the train step (on ``meta``) are those of one
    real step on the CPU: ``FlopCounterMode``'s count of PyTorch's own
    operators plus the flash kernels' formulas on the shapes their calls
    see, forward (twice a layer under remat "full") and backward."""
    from torch.utils.flop_counter import FlopCounterMode
    report = smollm_1x1["base"]
    assert report["status"] == "ok" and report["cost"]["kernel_flops"] > 0
    cfg = _smollm()
    b, s = TRAIN
    model = init_params(cfg, seed=0, device="cpu")
    step = step_mod.make_train_step(cfg, model)
    opt = adamw_init(dict(model.named_parameters()), cfg.optim_state_dtype,
                     cfg.optim_second_dtype)
    batch = make_device_batch(SyntheticLM(cfg, ShapeConfig("t", s, b, "train"), seed=0)
                              .batch_at(0), "cpu")
    inside = [0]

    def counted(plain, cost):
        def run(*args, **kw):
            before = fc.get_total_flops()
            out = plain(*args, **kw)
            inside[0] += fc.get_total_flops() - before
            kernel_meta.add("cpu", *cost(*args, **kw))
            return out
        return run
    monkeypatch.setattr(flash_mod, "flash_attention_lse_plain", counted(
        flash_mod.flash_attention_lse_plain,
        lambda q, k, v, causal, scale: kernel_meta.attention(q, k, causal, True)))
    monkeypatch.setattr(flash_mod, "flash_attention_backward_plain", counted(
        flash_mod.flash_attention_backward_plain,
        lambda q, k, v, o, lse, do, causal, scale: kernel_meta.attention_backward(q, k, causal)))
    kernel_meta.reset()
    with FlopCounterMode(display=False) as fc:
        step(opt, batch)
    kernels = kernel_meta.counts["cpu"]
    assert kernels[0] == 3 * cfg.num_layers           # 2 forwards and a backward a layer
    assert fc.get_total_flops() - inside[0] == report["cost"]["counted_flops"]
    assert kernels[1] == report["cost"]["kernel_flops"]
    assert report["cost"]["flops"] == report["cost"]["counted_flops"] + kernels[1]


def test_depth_extrapolation_is_exact_for_smollm(smollm_1x1):
    """P = 1 for the dense family: the step at depth 1 and 2 extrapolated
    over the 4 layers is the whole step's FLOPs, kernel bytes and
    collectives."""
    report = smollm_1x1["base"]
    corrected = report["corrected"]
    assert corrected["period"] == 1
    assert corrected["flops"] == report["cost"]["flops"]
    assert corrected["kernel_bytes"] == report["cost"]["kernel_bytes"]
    assert corrected["collectives"] == report["collectives"]


def test_every_variant_runs(smollm_1x1):
    """All of ``dryrun.VARIANTS`` run, the reference's nine.  Remat changes
    the FLOPs (no recompute under "none"), the logits' dtype changes neither
    the FLOPs nor the kernel bytes; the sp variants carry their rules and, at
    mesh 1x1 (one model rank), count the FLOPs and kernel bytes of the base
    rules' step; chunk2k's attn_chunk is taken out and recorded, its FLOPs,
    kernel bytes and collectives base's (bf16logits+chunk2k's those of
    bf16logits)."""
    assert len(VARIANTS) == 9
    assert list(VARIANTS) == ["base", "sp", "bf16logits", "dots", "noremat", "sp+bf16logits",
                              "sp+bf16logits+dots", "chunk2k", "bf16logits+chunk2k"]
    assert all(smollm_1x1[v]["status"] == "ok" for v in VARIANTS)
    flops = {v: smollm_1x1[v]["cost"]["flops"] for v in VARIANTS}
    assert flops["noremat"] < flops["base"] and flops["noremat"] <= flops["dots"]
    assert flops["bf16logits"] == flops["base"]
    assert smollm_1x1["bf16logits"]["cost"]["kernel_bytes"] == \
        smollm_1x1["base"]["cost"]["kernel_bytes"]
    for v in VARIANTS:
        sp = v.startswith("sp")
        assert smollm_1x1[v]["rules"] == ({"seq": ["model"]} if sp else {})
        if sp:
            # the same overrides without the sp rules; the reference has no
            # bf16logits+dots, and the logits' dtype moves neither count
            plain = v[3:] or "base"
            plain = plain if plain in VARIANTS else plain.replace("bf16logits+", "")
            assert flops[v] == flops[plain]
            assert smollm_1x1[v]["cost"]["kernel_bytes"] == \
                smollm_1x1[plain]["cost"]["kernel_bytes"]
    for v, same in (("chunk2k", "base"), ("bf16logits+chunk2k", "bf16logits")):
        got, want = smollm_1x1[v], smollm_1x1[same]
        assert got["no_effect"] == {"attn_chunk": 2048} and "attn_chunk" in \
            got["no_effect_reason"]
        assert got["cost"]["flops"] == want["cost"]["flops"]
        assert got["cost"]["kernel_bytes"] == want["cost"]["kernel_bytes"]
        assert got["collectives"] == want["collectives"]
    assert "no_effect" not in smollm_1x1["base"]


@pytest.mark.parametrize("arch,status", [("zamba2_1_2b", "ok"), ("smollm_360m", "skipped")])
def test_long_500k_at_16x16(arch, status, tmp_path):
    """``python -m repro_torch.launch.dryrun --arch ARCH --shape long_500k``
    at the production mesh: zamba2 (sub-quadratic) runs its decode step on
    256 fake ranks, its KV heads over ``model`` and the batch of 1
    replicated; smollm (full attention) is skipped, as the reference skips
    it.  The report is written to ``--out``."""
    out = tmp_path / "cell.json"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                        "--shape", "long_500k", "--out", str(out)], cwd=ROOT,
                       capture_output=True, text=True, timeout=300, env=ENV)
    assert r.returncode == 0, r.stderr[-4000:]
    report = json.loads(out.read_text())
    assert report["status"] == status and report["mesh"] == "16x16"
    if status == "ok":
        assert report["chips"] == 256 and report["fits"]
        assert report["cost"]["kernels"]["decode_attention"]["calls"] == 6
        # a site's shard: K and V of 2 of the 32 heads (over 16 model ranks)
        # at 524,288 positions, q and o of 2 heads, the length; bf16
        assert report["cost"]["kernels"]["decode_attention"]["bytes"] == \
            6 * (2 * 2 * 524_288 * 64 * 2 + 2 * 2 * 64 * 2 + 4)
        assert report["model_flops_per_device"] == report["model_flops_global"] / 256


def test_meta_branches_give_shapes_and_count_the_bound():
    """A ``meta`` tensor takes each wrapper's shape-only branch: outputs of
    the kernel's shapes and dtypes, and the kernel's roofline work counted
    (decode attention with its lse, the causal flash forward's visible
    half, the grouped matmul, the scan's y and h)."""
    from repro_torch.kernels import decode_attention as dec_mod
    from repro_torch.kernels import grouped_matmul as gmm_mod
    from repro_torch.kernels import ssm_scan as scan_mod
    meta = torch.device("meta")
    kernel_meta.reset()
    q = torch.empty(2, 4, 8, 16, device=meta)
    o, lse = flash_mod.flash_attention(q, q, q, return_lse=True)
    assert o.shape == q.shape and lse.shape == (2, 4, 8) and lse.dtype == torch.float32
    assert kernel_meta.counts["flash_attention"][1] == 4.0 * 16 * 2 * 4 * (8 * 9 // 2)
    qd = torch.empty(2, 4, 16, dtype=torch.bfloat16, device=meta)
    kv = torch.empty(2, 2, 100, 16, dtype=torch.bfloat16, device=meta)
    o, lse = dec_mod.decode_attention(qd, kv, kv, return_lse=True)
    assert o.shape == qd.shape and o.dtype == torch.bfloat16 and lse.shape == (2, 4)
    assert kernel_meta.counts["decode_attention"][1:] == [
        4.0 * 2 * 4 * 100 * 16, (2 * 2 * 2 * 100 * 16 + 2 * 2 * 4 * 16) * 2 + 4 * 2 + 4 * 2 * 4]
    y = gmm_mod.grouped_matmul(torch.empty(3, 8, 16, device=meta),
                               torch.empty(3, 16, 32, device=meta))
    assert y.shape == (3, 8, 32)
    assert kernel_meta.counts["grouped_matmul"][1] == 2.0 * 3 * 8 * 16 * 32
    x = torch.empty(2, 10, 4, 8, dtype=torch.bfloat16, device=meta)
    a = torch.empty(2, 10, 4, device=meta)
    bc = torch.empty(2, 10, 4, 6, device=meta)
    y, h = scan_mod.ssm_scan(x, a, bc, bc)
    assert y.shape == x.shape and y.dtype == torch.bfloat16 and h.shape == (2, 4, 6, 8)
    assert h.dtype == torch.float32 and kernel_meta.counts["ssm_scan"][0] == 1
    assert set(kernel_meta.counts) == {"flash_attention", "decode_attention", "grouped_matmul",
                                       "ssm_scan"}
