"""Distribution of the port (``repro_torch.distributed``, ``launch/mesh.py``)
against the JAX package's, on the CPU.

* Specs: the JAX package's parameter, moment, decode-cache and batch
  shardings, computed in a subprocess with 8 fake CPU devices
  (``tests/torch_dist_specs.py``, as ``tests/helpers/dist_checks.py`` runs
  its checks), against the port's on an abstract mesh: the four families
  (reduced) under ``fsdp`` / ``zero1`` on and off at meshes (1, 1), (2, 2)
  and (2, 2, 2), reduced smollm with 6 / 3 heads (not divisible at model 2)
  and the full ``smollm_360m`` widths, and the long-context cache specs of
  the four families (equal to JAX's, and in JAX equal to the ordinary
  ones: the ``kv_seq_sharded`` rule is dead).  The same subprocess holds the
  reference's own sharded granite step, with tokens dropped, to its
  one-device loss: GSPMD keeps the MoE's global semantics, which the port's
  sharded MoE must reproduce (``tests/test_torch_distributed_train.py``),
  and gives XLA's argument bytes of the reference's small-mesh dry-run
  cell, which the port's dry run must equal.
* In one gloo group of 4 processes (``tests/torch_dist_checks.py``):
  Megatron's conjugate pair leaves replicated gradients as one process
  has them (the all-reduce that differentiates to a second all-reduce
  multiplies them by the model size), int8 compressed sums, GPipe over 4
  stages, a checkpoint saved at 2x2 restored bit for bit at 4x1 and 1x4,
  the server at 2x2, the SP merge of the decode kernel's partial (o, lse)
  against JAX's whole-cache decode, the long-context decode at 2x2 with a
  replicated batch of 1, and the collectives of the four families' steps,
  which the dry run's 2x2 cells must count.  The documented 2x2 command of
  ``launch/train.py`` runs.
* One process: every collective is the identity outside a mesh context,
  and the pieces without a group (placements, local shapes, shard_hint,
  the meshes' refusals, ``input_specs``).
* On the card (``gpu``; they skip here): the NCCL one-rank group at mesh
  1x1, whose sharded step is bit for bit the one-card step.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ParallelConfig, get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import step as step_mod
from repro_torch.distributed.partition import cache_logical_axes
from repro_torch.distributed.sharding import MeshContext, NamedSharding, shard_hint, use_mesh
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.convert import jax_path
from torch_dist_run import TIMEOUT, run_checks, torchrun

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["smollm_360m", "granite_moe_1b", "zamba2_1_2b", "xlstm_1_3b"]
MESHES = {"1x1": ((1, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# the dry run's sp rules: the residual stream's sequence over model
SP_RULES = {"seq": ["model"]}
# [arch, overrides of the reduced config ("full": the config itself), mesh,
# fsdp, zero1] and, for the SP cases, the rule overrides
CASES = ([[a, {}, m, f, z] for a in ARCHS for m in MESHES for f in (False, True)
          for z in (False, True)]
         + [["smollm_360m", {"num_heads": 6, "num_kv_heads": 3}, m, True, True]
            for m in ("2x2", "2x2x2")]
         + [["smollm_360m", "full", m, True, True] for m in ("2x2", "2x2x2")]
         + [[a, {}, m, f, f, SP_RULES] for a in ARCHS for m in ("2x2", "2x2x2")
            for f in (False, True)])
CACHE = (8, 16)            # the decode cache's batch and max_seq (as the helper's)


def case_id(case) -> str:
    arch, ov, m, f, z, *rules = case
    tag = "" if ov == {} else "_full" if ov == "full" else "_6_3_heads"
    return f"{arch}{tag}-{m}-fsdp{int(f)}-zero1{int(z)}" + ("-sp_rules" if rules else "")


# --------------------------------------------------------------------------
# specs against the JAX package's
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_specs():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_dist_specs.py"),
                        json.dumps(CASES)], capture_output=True, text=True, timeout=TIMEOUT,
                       env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _port_specs(case) -> dict:
    arch, ov, mesh_name, fsdp, zero1, *rules = case
    cfg = get_config(arch) if ov == "full" else reduced(get_config(arch), **ov)
    shape, axes = MESHES[mesh_name]
    mc = MeshContext(shape=shape, axis_names=axes, rules=rules[0] if rules else None)
    param_sh, logical, shapes = step_mod.make_param_shardings(cfg, mc, fsdp=fsdp)
    opt_sh = step_mod.make_opt_shardings(cfg, ParallelConfig(fsdp=fsdp, zero1=zero1), mc,
                                         logical, shapes)

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", _enc(v.spec)
    return {"params": {n: _enc(s.spec) for n, s in param_sh.items()},
            "opt": {n: _enc(s.spec) for n, s in opt_sh.m.items()},
            "cache": dict(flat(step_mod.cache_shardings(cfg, mc, *CACHE))),
            "cache_long": dict(flat(step_mod.cache_shardings(cfg, mc, *CACHE,
                                                             long_context=True))),
            "batch": {k: dict(flat(step_mod.batch_shardings(cfg, k, mc)))
                      for k in ("train", "prefill", "decode")},
            "logits": _enc(mc.sharding(("batch", "seq", "vocab")).spec)}


def _against_jax(port: dict, jax_tree: dict) -> None:
    """Every port leaf's spec equals its JAX path's; a block's JAX spec
    leads with the stacked layer axis, replicated."""
    seen = set()
    for name, spec in port.items():
        path = jax_path(name)
        want = jax_tree[path]
        if name.startswith("blocks."):
            assert want[0] is None, (path, want)
            want = want[1:]
        assert spec == want, (name, spec, want)
        seen.add(path)
    assert seen == set(jax_tree), sorted(set(jax_tree) - seen)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_specs_equal_the_jax_package(case, jax_specs):
    """Parameters and moments (by name through ``convert.jax_path``), the
    decode cache, the batch and the prefill's logits: each spec the JAX
    package's (under the sp rules the train and prefill batches
    ``P(("pod", "data"), "model")`` and the logits ``model`` on the
    sequence, the vocab whole)."""
    want = jax_specs["specs"][CASES.index(case)]
    got = _port_specs(case)
    _against_jax(got["params"], want["params"])
    _against_jax(got["opt"], want["opt"])
    assert got["cache"] == want["cache"]
    assert got["batch"] == want["batch"]
    assert got["logits"] == want["logits"]
    if len(case) > 5:
        assert got["batch"]["train"]["tokens"][1] == "model" and got["logits"][1:] == [
            "model", None]


# the four families at each mesh (the cache's specs do not depend on fsdp or
# zero1)
LONG_CASES = [[a, {}, m, True, True] for a in ARCHS for m in MESHES]


@pytest.mark.parametrize("case", LONG_CASES, ids=case_id)
def test_long_context_cache_specs_equal_the_jax_package(case, jax_specs):
    """``cache_logical_axes(cfg, long_context=True)`` through
    ``logical_to_sharding``: every leaf's spec the JAX package's."""
    want = jax_specs["specs"][CASES.index(case)]["cache_long"]
    assert _port_specs(case)["cache_long"] == want


@pytest.mark.parametrize("case", LONG_CASES, ids=case_id)
def test_reference_long_context_rule_is_dead(case, jax_specs):
    """ROADMAP Queue 3 item 15: in the JAX package ``kv_heads`` takes
    ``model`` before ``kv_seq_sharded`` asks for it, so the long-context
    cache specs are the ordinary ones and the KV sequence is never
    sharded."""
    got = jax_specs["specs"][CASES.index(case)]
    assert got["cache_long"] == got["cache"]
    assert all("model" not in (spec[3] or []) for spec in got["cache_long"].values()
               if len(spec) == 5)


def test_indivisible_heads_keep_the_flattened_shard(jax_specs):
    """At model 2 the reference keeps ``wq``'s shard although smollm_360m's
    15 heads of 64 do not split (960 columns, 7.5 heads a rank) and reduced
    smollm's 3 KV heads do not: the port's attention then gathers and
    computes replicated (``collectives.tp`` is not local)."""
    for ov, heads in (({"num_heads": 6, "num_kv_heads": 3}, (6, 3)), ("full", (15, 5))):
        case = ["smollm_360m", ov, "2x2", True, True]
        spec = jax_specs["specs"][CASES.index(case)]["params"]["blocks/attn/wq"]
        assert spec == [None, None, "model"], spec
        cfg = get_config("smollm_360m") if ov == "full" else reduced(get_config("smollm_360m"),
                                                                     **ov)
        mc = MeshContext(shape=(2, 2), axis_names=("data", "model"))
        param_sh, _, _ = step_mod.make_param_shardings(cfg, mc, fsdp=True)
        model = step_mod.Model(cfg, device="meta")
        for n, p in model.named_parameters():
            p.sharding = param_sh[n]
        attn = model.blocks[0].attn
        with use_mesh(mc):
            from repro_torch.models.layers import _attention_tp
            assert not _attention_tp(attn, cfg).local
        assert (cfg.num_heads, cfg.num_kv_heads) == heads


def test_reference_moe_is_global_under_sharding(jax_specs):
    """The reference's granite step with tokens dropped: sharded over a 2x2
    mesh, the loss of its one-device step to 1e-6."""
    loss = jax_specs["moe_loss"]
    assert abs(loss["2x2"] - loss["1x1"]) <= 1e-6 * abs(loss["1x1"]), loss


# --------------------------------------------------------------------------
# 4 gloo processes: the conjugate pair, compression, GPipe, elastic restore
# --------------------------------------------------------------------------
# the SP merge: check_decode_sp_longcontext's b, hq, hkv, s, d, and lengths
# (None: every position) that leave ranks partial or empty
SP_SHAPE = (2, 4, 2, 64, 16)
SP_LENGTHS = [None, [64, 40], [5, 0]]
# the dry run's 2x2 cells: a train step and a prefill (batch, seq), a decode
# step (batch, max_seq)
DRYRUN_TRAIN, DRYRUN_DECODE = (4, 32), (4, 16)


@pytest.fixture(scope="module")
def gloo_checks(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    return run_checks("conjugate,compression,gpipe,elastic,serve,sp_decode,long_decode,"
                      "collectives", {"dir": str(d), "sp_shape": SP_SHAPE,
                                      "sp_lengths": SP_LENGTHS, "dryrun_train": DRYRUN_TRAIN,
                                      "dryrun_decode": DRYRUN_DECODE})


def test_conjugate_pair_keeps_replicated_gradients(gloo_checks):
    """f before a column-parallel product, g after the row-parallel one, at
    model 4: the gradients of a replicated scale before f and one after g,
    of the input and of the shards are the one-process ones (1e-6); with an
    all-reduce that differentiates to a second all-reduce in g's place the
    first scale's gradient is 4 times it."""
    out = gloo_checks["conjugate"]
    assert max(out["grad_rel_errs"]) <= 1e-6
    assert abs(out["all_reduce_backward_scale"] - 4.0) <= 1e-4


def test_compressed_psum_within_5_percent(gloo_checks):
    """int8 + error feedback over 4 ranks: within 5% of the exact sum, the
    same on every rank, the residual not zero (``check_compressed_psum``)."""
    out = gloo_checks["compression"]
    assert out["rel_err"] < 0.05 and out["residual_max"] > 0.0


def test_gpipe_equals_the_sequential_stack(gloo_checks):
    """4 stages, 8 layers, 8 microbatches: the sequential stack to 1e-5."""
    assert gloo_checks["gpipe"]["max_abs_err"] <= 1e-5


def test_elastic_restore_is_bit_for_bit(gloo_checks):
    """A tree and a reduced granite train state saved at 2x2 restore at 4x1
    and 1x4, gathered whole bit for bit."""
    assert set(gloo_checks["elastic"]) == {"4x1", "1x4"}


def test_serve_at_2x2_matches_one_process(gloo_checks):
    """``serve(..., mesh=)`` through ``make_decode_step`` at 2x2: each
    rank's greedy tokens those of one process, the logits within 1e-5
    (reduced smollm and granite, prompt 8, 8 tokens)."""
    assert set(gloo_checks["serve"]) == {"smollm_360m", "granite_moe_1b"}
    assert max(gloo_checks["serve"].values()) <= 1e-5


@pytest.mark.parametrize("lengths", SP_LENGTHS, ids=["full", "ragged", "zero"])
def test_sp_decode_merge_equals_the_whole_cache(lengths, gloo_checks):
    """``collectives.decode_attention_sp`` over 4 gloo ranks, each holding
    16 of the 64 positions (the reference's ``check_decode_sp_longcontext``
    sizes and inputs): JAX's ``ref.decode_attention`` on the whole cache
    within 1e-5, the reference's tolerance.  Length 40 leaves rank 2
    partial and rank 3 empty, 5 ranks 1-3 empty; the row at length 0 is 0
    (JAX's plain version gives NaN there)."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    b, hq, hkv, s, d = SP_SHAPE
    rng = np.random.default_rng(1)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    got = np.asarray(gloo_checks["sp_decode"][json.dumps(lengths)])
    want = np.asarray(jref.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if lengths is None else jnp.asarray(lengths, jnp.int32)))
    rows = [i for i in range(b) if lengths is None or lengths[i] > 0]
    np.testing.assert_allclose(got[rows], want[rows], rtol=1e-5, atol=1e-5)
    assert all(np.all(got[i] == 0) for i in range(b) if i not in rows)


def test_long_context_decode_at_2x2_matches_one_process(gloo_checks):
    """Reduced zamba2 and xlstm, batch 1 replicated over ``data``, 4 steps
    through ``make_decode_step(long_context=True)`` at the end of a seeded
    random cache (``check_long_decode``): xlstm, which computes replicated,
    within 1e-6 of one process (it is bit for bit); zamba2, whose attention
    and Mamba2 run on 2 model shards summed by an all-reduce, within 1e-5
    (it sits 1.2e-6 off in f32 and 2e-15 in f64:
    ``tests/test_torch_distributed_train.py`` holds the f64 run to 1e-10)."""
    out = gloo_checks["long_decode"]
    assert set(out) == {"zamba2_1_2b", "xlstm_1_3b"}
    assert out["xlstm_1_3b"] <= 1e-6 and out["zamba2_1_2b"] <= 1e-5


@pytest.fixture(scope="module")
def dryrun_2x2():
    """The dry run's 2x2 cells of the four reduced families (a train step
    of 4 x 32, a prefill of 4 x 32, a decode step at batch 4 against 16
    positions) under the base and the sp variants, every report in one
    subprocess (a fake process group of 4 ranks)."""
    code = (
        "import json, sys\n"
        "from repro_torch.configs import get_config, reduced\n"
        "from repro_torch.configs.base import ShapeConfig\n"
        "from repro_torch.launch.dryrun import run_cell\n"
        "(b, s), (bd, sd) = json.loads(sys.argv[1])\n"
        "out = {}\n"
        "for arch in json.loads(sys.argv[2]):\n"
        "    cfg = reduced(get_config(arch))\n"
        "    for v in ('base', 'sp'):\n"
        "        out[arch + '|' + v] = {\n"
        "            k: run_cell(arch, ShapeConfig(k, n, m, k), mesh='2x2', cfg=cfg, variant=v)\n"
        "            for k, n, m in (('train', s, b), ('prefill', s, b), ('decode', sd, bd))}\n"
        "print(json.dumps(out))\n")
    r = subprocess.run([sys.executable, "-c", code, json.dumps([DRYRUN_TRAIN, DRYRUN_DECODE]),
                        json.dumps(ARCHS)], cwd=ROOT, capture_output=True, text=True,
                       timeout=TIMEOUT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_collectives_equal_a_gloo_run(arch, kind, dryrun_2x2, gloo_checks):
    """The dry run's collectives at 2x2 (rank 0 of a fake process group, on
    ``meta``) are, by kind, the calls and bytes ``count_collectives`` sees
    on rank 0 of the real gloo run of the same step."""
    report = dryrun_2x2[arch + "|base"][kind]
    assert report["status"] == "ok"
    got = {k: [v["calls"], v["bytes"]] for k, v in report["collectives"].items()}
    assert got == gloo_checks["collectives"][arch][kind]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_collectives_equal_a_gloo_run_under_sp(arch, kind, dryrun_2x2, gloo_checks):
    """The same under the sp rules (``--variant sp``): the dry run's
    collectives are the gloo run's, and in the train and prefill steps the
    sequence's all-gathers and reduce-scatters stand where the base rules
    all-reduce; the decode step, whose residual stays whole, issues the
    base rules' collectives."""
    report = dryrun_2x2[arch + "|sp"][kind]
    assert report["status"] == "ok" and report["rules"] == {"seq": ["model"]}
    got = {k: [v["calls"], v["bytes"]] for k, v in report["collectives"].items()}
    want = gloo_checks["collectives"][arch]["sp"][kind]
    assert got == want
    base = gloo_checks["collectives"][arch][kind]
    if kind == "decode":
        assert want == base
    else:
        assert want["reduce_scatter"][0] > base.get("reduce_scatter", [0])[0]


def _small_mesh_cell(variant: str) -> dict:
    """The port's dry run of the reference's ``check_dryrun_small_mesh``
    cell (reduced granite, vocab 256, train 8 x 64, mesh 2x2x2)."""
    code = ("import json, sys\n"
            "from repro_torch.configs import get_config, reduced\n"
            "from repro_torch.configs.base import ShapeConfig\n"
            "from repro_torch.launch.dryrun import run_cell\n"
            "cfg = reduced(get_config('granite_moe_1b'), vocab_size=256)\n"
            "print(json.dumps(run_cell('granite_moe_1b', ShapeConfig('t', 64, 8, 'train'),\n"
            "                          mesh='2x2x2', cfg=cfg, variant=sys.argv[1])))\n")
    r = subprocess.run([sys.executable, "-c", code, variant], cwd=ROOT, capture_output=True,
                       text=True, timeout=TIMEOUT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr[-4000:]
    report = json.loads(r.stdout.strip().splitlines()[-1])
    assert report["status"] == "ok" and report["chips"] == 8
    return report


def test_dryrun_argument_bytes_equal_xla_s(jax_specs):
    """The reference's ``check_dryrun_small_mesh`` cell: the dry run's
    argument bytes a rank are XLA's ``argument_size_in_bytes`` for the same
    cell: parameter, moment and batch shards and the step count."""
    report = _small_mesh_cell("base")
    assert report["memory"]["argument_size_in_bytes"] == \
        jax_specs["dryrun_argument_bytes"]["base"]


def test_dryrun_argument_bytes_equal_xla_s_under_sp(jax_specs):
    """The same cell under the sp rules: XLA's argument bytes, which are
    the base rules' less half the token and label shards (their sequence
    split over the 2 model ranks)."""
    report = _small_mesh_cell("sp")
    want = jax_specs["dryrun_argument_bytes"]
    assert report["memory"]["argument_size_in_bytes"] == want["sp"]
    assert want["base"] - want["sp"] == 2 * (8 // 4) * (64 // 2) * 4


def test_train_cli_runs_at_2x2(tmp_path):
    """The documented rehearsal: ``torch.distributed.run --nproc-per-node 4
    -m repro_torch.launch.train --device cpu --reduced --mesh 2x2 --steps
    4``; it writes its checkpoint and result.json, and logs once (rank 0)."""
    r = torchrun(["repro_torch.launch.train", "--device", "cpu", "--reduced", "--mesh", "2x2",
                  "--steps", "4", "--workdir", str(tmp_path)], module=True)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.count("fresh start") == 1, r.stdout
    result = json.loads((tmp_path / "result.json").read_text())
    assert result["steps"] == 4 and np.isfinite(result["final_loss"])
    assert (tmp_path / "ckpt" / "LATEST").read_text() == "4"


# --------------------------------------------------------------------------
# one process
# --------------------------------------------------------------------------
def test_collectives_are_the_identity_without_a_mesh():
    x = torch.randn(3, 4, requires_grad=True)
    assert C.current() is None and C.tp() is None
    for fn in (C.copy_to_model, C.reduce_from_model, C.mean_over_model):
        assert fn(x, None) is x
    assert C.param(x) is x and C.batch_sum(x) is x and C.gather_batch(x) is x
    assert C.batch_place() == (0, 1)
    assert shard_hint(x, ("a",)) is x


def test_mesh_context_specs_placements_and_local_shapes():
    from torch.distributed.tensor import Replicate, Shard
    mc = MeshContext(shape=(2, 2, 2), axis_names=("pod", "data", "model"))
    assert mc.spec(("batch", "seq", "embed")) == (("pod", "data"), None, None)
    assert mc.spec(("zero", "heads")) == ("data", "model")
    assert mc.spec(("heads", "mlp")) == ("model", None)        # an axis is used once
    sh = NamedSharding(mc, (("pod", "data"), "model"))
    assert sh.local_shape((8, 6)) == (2, 3)
    assert mc.placements(sh.spec) == (Shard(0), Shard(0), Shard(1))
    t = torch.arange(48).reshape(8, 6)
    assert torch.equal(sh.local_slice(t), t[:2, :3])
    mc2 = MeshContext(shape=(2, 2), axis_names=("data", "model"))
    assert mc2.spec(("batch",)) == ("data",)
    assert mc2.placements(("data", None)) == (Shard(0), Replicate())
    with pytest.raises(ValueError):
        NamedSharding(mc2, ("data",)).local_shape((3,))
    with pytest.raises(ValueError):
        NamedSharding(mc2, ("data",)).local_slice(torch.zeros(3))


def test_shard_hint_asserts_the_local_layout():
    mc = MeshContext(shape=(1, 2), axis_names=("data", "model"))
    mc.sizes.update(embed=8, vocab=16)
    with use_mesh(mc):
        x = torch.zeros(2, 3, 8)
        assert shard_hint(x, ("batch", "seq", "embed")) is x
        assert shard_hint(torch.zeros(2, 3, 8), ("batch", "seq", "vocab")) is not None
        with pytest.raises(ValueError):
            shard_hint(torch.zeros(2, 3, 16), ("batch", "seq", "vocab"))
        with pytest.raises(ValueError):
            shard_hint(x, ("batch", "embed"))


def test_meshes_refuse_what_the_world_cannot_hold(monkeypatch):
    """No process group is touched: the production meshes need 256 / 512
    ranks, and a 2x2 mesh needs 4."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match=r"mesh \(16, 16\) needs 256 devices, found 1"):
        mesh_mod.make_production_mesh()
    with pytest.raises(RuntimeError, match=r"mesh \(2, 16, 16\) needs 512 devices"):
        mesh_mod.make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match=r"mesh \(2, 2\) needs 4 devices"):
        mesh_mod.make_mesh((2, 2), ("data", "model"), device="cpu")
    assert not torch.distributed.is_initialized()


def test_long_context_decode_builds_with_a_replicated_batch():
    """``long_context=True`` asks for ``kv_seq_sharded``; a batch of 1, which
    the 2 data shards do not divide, is replicated (token, pos and the
    cache's batch dim), as the reference's ``tok_sh`` is."""
    cfg = reduced(get_config("zamba2_1_2b"))
    assert cache_logical_axes(cfg, long_context=True)["shared_kv"]["k"][3] == "kv_seq_sharded"
    mc = MeshContext(shape=(2, 2), axis_names=("data", "model"))
    _, (_, cache_sh, tok_sh) = step_mod.make_decode_step(cfg, ParallelConfig(), mc, 1, 16,
                                                         long_context=True)
    assert tok_sh.spec == (None,)
    assert cache_sh["shared_kv"]["k"].spec == (None, None, "model", None, None)
    assert cache_sh["ssm"]["h"].spec == (None, None, "model", None, None)


def test_replicated_batch_makes_the_batch_collectives_identities():
    """In ``with_replicated_batch()`` every collective over the batch axes
    is the identity (no group is touched: the mesh is abstract); the
    context it was made from is unchanged."""
    mc = MeshContext(shape=(2, 2), axis_names=("data", "model"))
    rep = mc.with_replicated_batch()
    x = torch.randn(3, 4)
    with use_mesh(rep):
        assert C.batch_group(rep) is None and C.batch_place() == (0, 1)
        assert C.batch_sum(x) is x and C.gather_batch(x) is x
        assert rep.spec(("batch", "embed")) == mc.spec(("batch", "embed"))
    with use_mesh(mc):
        assert not mc.replicated_batch and C.batch_place() == (0, 2)


def test_sp_rules_split_the_residual_stream_over_model():
    """``{"seq": ("model",)}`` turns on sequence parallelism: ``sp``, the
    residual's and the batch's specs with ``model`` on the sequence, the
    decode step's context with the sequence whole again, and a rule that
    splits it over another axis refused."""
    mc = MeshContext(shape=(2, 2, 2), axis_names=("pod", "data", "model"),
                     rules={"seq": ("model",)})
    assert mc.sp and mc.seq_axes == ("model",)
    assert mc.spec(("batch", "seq", "embed")) == (("pod", "data"), "model", None)
    assert mc.spec(("batch", "seq", "vocab")) == (("pod", "data"), "model", None)
    rep = mc.with_replicated_seq()
    assert not rep.sp and mc.sp and rep.spec(("batch", "seq")) == mc.spec(("batch", "seq"))
    assert not MeshContext(shape=(2, 2), axis_names=("data", "model")).sp
    assert not MeshContext(shape=(4,), axis_names=("data",), rules={"seq": ("model",)}).sp
    with pytest.raises(ValueError, match="over"):
        MeshContext(shape=(2, 2), axis_names=("data", "model"),
                    rules={"batch": None, "seq": ("data",)}).sp
    cfg = reduced(get_config("smollm_360m"))
    _, (_, _, tok_sh) = step_mod.make_decode_step(cfg, ParallelConfig(), mc, 8, 16)
    assert tok_sh.spec == (("pod", "data"),)


def test_a_sequence_model_does_not_divide_is_refused():
    """Under the sp rules a train or prefill batch whose sequence the model
    ranks do not divide is refused where it is cut, with both sizes named
    (the reference would pad it)."""
    mc = MeshContext(shape=(1, 4), axis_names=("data", "model"), rules={"seq": ("model",)})
    cfg = reduced(get_config("smollm_360m"))
    for kind in ("train", "prefill"):
        sh = step_mod.batch_shardings(cfg, kind, mc)["tokens"]
        assert sh.local_shape((2, 32)) == (2, 8)
        with pytest.raises(ValueError, match=r"\(30\).*4 ranks of model"):
            sh.local_slice(torch.zeros(2, 30, dtype=torch.int32))


@pytest.mark.parametrize("arch", ARCHS)
def test_row_params_are_the_residual_norms(arch):
    """``partition.row_params``: the parameters applied to the residual
    stream's rows outside a layer (their SP gradients partial over the
    sequence shards): every residual norm's scale, not Mamba2's or the
    mLSTM's inner norm, and an embedding table only where ``model`` does not
    shard it."""
    from repro_torch.distributed.partition import row_params
    cfg = reduced(get_config(arch))
    mc = MeshContext(shape=(2, 2), axis_names=("data", "model"), rules={"seq": ("model",)})
    param_sh, _, _ = step_mod.make_param_shardings(cfg, mc, fsdp=True)
    rows = row_params(param_sh)
    names = [n for n in param_sh if n.endswith(".scale")]
    inner = [n for n in names if ".mamba.norm." in n or ".mlstm.norm." in n]
    assert sorted(rows) == sorted(set(names) - set(inner)) and "final_norm.scale" in rows
    assert (len(inner) > 0) == (cfg.family in ("hybrid", "ssm"))
    odd = {n: NamedSharding(mc, (None, None)) for n in ("embed.tok", "embed.out")}
    assert row_params(odd) == ["embed.tok", "embed.out"]


def test_input_specs_are_meta_tensors():
    cfg = reduced(get_config("smollm_360m"))
    train = step_mod.input_specs(cfg, ShapeConfig("t", 64, 8, "train"))
    assert {k: (tuple(v.shape), v.dtype, v.device.type) for k, v in train.items()} == {
        "labels": ((8, 64), torch.int32, "meta"), "tokens": ((8, 64), torch.int32, "meta")}
    dec = step_mod.input_specs(cfg, ShapeConfig("d", 128, 4, "decode"))
    assert set(dec) == {"token", "pos"} and dec["pos"].shape == (4,)
    audio = step_mod.input_specs(reduced(get_config("musicgen_large")),
                                 ShapeConfig("t", 16, 2, "prefill"))
    assert audio["embeds"].shape == (2, 16, 128) and audio["embeds"].dtype == torch.bfloat16


def test_compression_roundtrip_error_bound():
    """One block's int8 error is at most its largest |value| / 127."""
    from repro_torch.distributed.compression import dequantize_int8, quantize_int8
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1000,)).astype(np.float32))
    q, s, n = quantize_int8(x)
    back = dequantize_int8(q, s, n, x.shape)
    assert q.dtype == torch.int8 and q.shape == (4, 256)
    assert (back - x).abs().max().item() <= x.abs().max().item() / 127.0 + 1e-6


# --------------------------------------------------------------------------
# the card: the NCCL one-rank group
# --------------------------------------------------------------------------
GPU_ONE_RANK = r'''
import dataclasses, sys, torch
from repro_torch.configs import ParallelConfig, get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticLM, make_device_batch
from repro_torch.distributed import step as S
from repro_torch.distributed.sharding import MeshContext
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import init_params
from repro_torch.optim import adamw_init
mesh = make_mesh((1, 1), ("data", "model"))
assert torch.distributed.get_backend() == "nccl"
for mc, arch in [(MeshContext(mesh, rules), arch) for rules in (None, {"seq": ("model",)})
                 for arch in ("smollm_360m", "granite_moe_1b", "zamba2_1_2b", "xlstm_1_3b")]:
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="bfloat16",
                              param_dtype="bfloat16", remat="full")
    ds = SyntheticLM(cfg, ShapeConfig("t", 64, 2, "train"), seed=0)
    one = init_params(cfg, seed=0)
    step1 = S.make_train_step(cfg, one, peak_lr=1e-3, warmup=0)
    opt1 = adamw_init(dict(one.named_parameters()))
    step, (psh, osh, bsh) = S.make_train_step(cfg, ParallelConfig(), mc, peak_lr=1e-3, warmup=0)
    two = S.place_params(init_params(cfg, seed=0), psh)
    opt2 = S.init_opt_state(two, osh, cfg)
    for i in range(2):
        opt1, m1 = step1(opt1, make_device_batch(ds.batch_at(i), "cuda"))
        two, opt2, m2 = step(two, opt2, make_device_batch(ds.batch_at(i), bsh))
        assert torch.equal(m1["loss"], m2["loss"]), (arch, m1["loss"], m2["loss"])
        assert torch.equal(m1["grad_norm"], m2["grad_norm"]), arch
    for (n, p), q in zip(one.named_parameters(), two.parameters()):
        assert torch.equal(p, q), (arch, n)
print("OK nccl one rank")
torch.distributed.destroy_process_group()
'''


@pytest.mark.gpu
def test_gpu_one_rank_nccl_step_is_the_one_card_step():
    """At mesh 1x1 over a one-rank NCCL group the sharded step of each
    family (reduced, bf16, remat "full"), under the base and the sp rules,
    is bit for bit the one-card step: losses, grad norms and parameters
    after 2 steps.  In a subprocess, so the process group does not outlive
    the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = subprocess.run([sys.executable, "-c", GPU_ONE_RANK], cwd=ROOT, capture_output=True,
                       text=True, timeout=900,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0 and "OK nccl one rank" in r.stdout, r.stderr[-4000:]


@pytest.mark.gpu
def test_gpu_mesh_refuses_a_gloo_group():
    """A mesh on the card needs NCCL: a process group set up for the CPU is
    refused, never used instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    code = ("import torch.distributed as d\n"
            "from repro_torch.launch.mesh import make_mesh\n"
            "make_mesh((1, 1), ('data', 'model'), device='cpu')\n"
            "try:\n    make_mesh((1, 1), ('data', 'model'))\n"
            "except RuntimeError as e:\n    print('refused', e)\n"
            "d.destroy_process_group()\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0 and "refused" in r.stdout, r.stderr[-4000:]
