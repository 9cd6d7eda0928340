"""The manifest, BENCHMARK.json, against the benchmark's contract, and the
data files it names; the checks of a cell's pieces, its configuration and
its model count also on a root of small cells made from temporary files.

A configuration is checked by the config the harness hands the program
(``program_config``), so a field of the port's ``ModelConfig`` whose
default keeps every preset as it is may be added without editing any
configuration file."""
from __future__ import annotations

import copy
import dataclasses
import json
import re
from pathlib import Path

import pytest
import torch

from perfbench.kinds import prefill, train
from perfbench.lib.harness import program_config
from perfbench.lib.manifest import PKG, ROOT, Manifest, cut_key, reference_name
from perfbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in BENCH["workloads"]}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def test_manifest_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"][1] == "perfbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def check_pieces(man: Manifest) -> None:
    """Every cell finds its traffic, kind, limits, configuration and the
    reference its configuration names; every configuration is some cell's."""
    bench = man.data
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = man.traffic(w["traffic"])
        man.kind(traffic["kind"])
        assert man.limits(w["name"])["limits"]
        man.reference(reference_name(man.config(w["config"])))
    assert configs == {w["config"] for w in bench["workloads"]}
    cells = bench["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def check_mfu_counts(man: Manifest) -> None:
    """A cell that lists a metric of the ``mfu`` reader has a configuration
    whose reference some model count counts."""
    cells = {w["name"]: w for w in man.data["workloads"]}
    for m in man.data["per_layer"]:
        if m["name"].split(".", 1)[0] != "mfu":
            continue
        for cell in m.get("workloads", cells):
            ref = reference_name(man.config(cells[cell]["config"]))
            assert man.model_count(ref) is not None, f"{cell} lists {m['name']}: no count of {ref}"


# a configuration file's own keys, beside the fields of the program's config
FILE_KEYS = {"source", "reduced", "deployment", "reference", "assumed", "published",
             "changed_from_the_port_preset"}


def _as_json(obj):
    """As JSON gives it back: a tuple becomes a list."""
    return json.loads(json.dumps(obj))


def check_config(entry: dict, data: dict, port: dict) -> None:
    """The file holds the configuration run.  Each key is a field of the
    program's ``ModelConfig`` or one of the file's own (``FILE_KEYS``).  The
    config the harness hands the program (the file's fields, the program's
    default for any it leaves out) differs from the port's preset ``port``
    (the published model) in exactly the fields named under
    ``changed_from_the_port_preset`` and the keys the file cuts; the
    manifest's ``reduced`` names the keys the file's does, and the file's
    ``published`` block gives each one's published value."""
    from repro_torch.configs.base import ModelConfig
    assert entry["file"].startswith("perfbench/configs/")
    assert data["source"].startswith("https://")
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    for key in data:
        assert key in fields or key in FILE_KEYS, \
            f"{key} is neither a field of the program's config nor a key of the file"
    cut = [cut_key(e) for e in data.get("reduced", [])]
    assert sorted(entry["reduced"]) == sorted(cut), (entry["reduced"], cut)
    assert all(NAME.match(key) for key in entry["reduced"]), entry["reduced"]
    published = data.get("published", {})
    for key in cut:
        assert key in published, f"{key} is cut and its published value is not given"
        assert data.get(key) != published[key], f"{key} is listed as cut and is not"
    allowed = set(data.get("changed_from_the_port_preset", {})) | set(cut)
    run = _as_json(dataclasses.asdict(program_config(data)))
    for key, value in _as_json(port).items():
        if key != "notes":
            assert (run[key] != value) == (key in allowed), key


def test_cells_name_their_pieces():
    check_pieces(Manifest())


def test_mfu_cells_have_a_model_count():
    check_mfu_counts(Manifest())


def test_metrics_moves_and_cells_agree():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for cell in CELLS:
        reported = [n for n, m in E2E.items() if cell in m.get("workloads", CELLS)]
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert any(cell in m.get("workloads", CELLS) for m in BENCH["per_layer"]), cell
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in E2E
        moved = E2E[m["moves"]].get("workloads", list(CELLS))
        assert set(m.get("workloads", moved)) <= set(moved), m["name"]
        Manifest().reader(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, layer


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files_are_the_configurations_run(config):
    from repro_torch.configs import get_config
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    check_config(entry, Manifest().config(config), dataclasses.asdict(get_config(config)))


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench_manifest"))


def _published_preset(data: dict) -> dict:
    """A port preset holding the published model: the file with each key it
    cuts put back to its published value."""
    return dataclasses.asdict(program_config({**data, **data["published"]}))


def test_a_tiny_root_passes_the_manifest_checks(tiny_root):
    """Its cut configuration names a reference and a count that exist only
    under the temporary root."""
    man = Manifest(tiny_root)
    check_pieces(man)
    check_mfu_counts(man)
    entry = next(c for c in man.data["configs"] if c["name"] == "tiny_cut")
    data = man.config("tiny_cut")
    assert entry["reduced"] == ["num_layers"] and data["reference"] == "tiny_ref"
    check_config(entry, data, _published_preset(data))


def test_each_root_finds_its_own_modules(tiny_root, tmp_path):
    """Two roots in one process that hold a reference of the same name each
    get their own, in turn."""
    other = tiny.make_root(tmp_path)
    for root in (tiny_root, other, tiny_root):
        mod = Manifest(root).reference("tiny_ref")
        assert Path(mod.__file__).is_relative_to(root), (mod.__file__, root)


def test_an_mfu_cell_without_a_count_is_refused(tiny_root):
    man = Manifest(tiny_root)
    entry = next(m for m in man.data["per_layer"] if m["name"] == "mfu.train")
    entry["workloads"] = entry["workloads"] + ["tiny_uncounted.train"]
    with pytest.raises(AssertionError, match="tiny_uncounted.train lists mfu.train"):
        check_mfu_counts(man)


def _unlisted(entry, data):
    data["d_ff"] *= 2


def _unpublished(entry, data):
    del data["published"]["num_layers"]


def _not_in_the_manifest(entry, data):
    entry["reduced"] = []


def _not_cut(entry, data):
    data["num_layers"] = data["published"]["num_layers"]


@pytest.mark.parametrize("fault,match", [
    pytest.param(None, None, id="cut"), pytest.param(_unlisted, "d_ff", id="unlisted"),
    pytest.param(_unpublished, "published value", id="unpublished"),
    pytest.param(_not_in_the_manifest, "num_layers", id="not_in_the_manifest"),
    pytest.param(_not_cut, "listed as cut and is not", id="not_cut")])
def test_reduced_names_every_cut(tiny_root, fault, match):
    """A key cut and listed passes; a difference from the preset that no
    entry names fails, as does a cut without its published value or left
    out of the manifest's ``reduced``, or a key listed that is not cut."""
    man = Manifest(tiny_root)
    entry = copy.deepcopy(next(c for c in man.data["configs"] if c["name"] == "tiny_cut"))
    data = man.config("tiny_cut")
    port = _published_preset(data)
    if fault is None:
        check_config(entry, data, port)
        return
    fault(entry, data)
    with pytest.raises(AssertionError, match=match):
        check_config(entry, data, port)


def _grown(monkeypatch):
    """The port's ``ModelConfig`` grown by two defaulted fields, one of them a
    tuple; the harness and the check take it as the program's config."""
    import repro_torch.configs.base as base

    @dataclasses.dataclass(frozen=True)
    class Grown(base.ModelConfig):
        ssm_groups: int = 1
        hybrid_layers: tuple = ()

    monkeypatch.setattr(base, "ModelConfig", Grown)
    return Grown


def _granite(grown, **preset):
    from repro_torch.configs import get_config
    entry = next(c for c in BENCH["configs"] if c["name"] == "granite_moe_1b")
    port = dataclasses.asdict(grown(**{**dataclasses.asdict(get_config("granite_moe_1b")),
                                       **preset}))
    return entry, Manifest().config("granite_moe_1b"), port


@pytest.mark.parametrize("case", ["granite", "tiny", "unset_field", "stray_key",
                                  "tuple_field"])
def test_a_grown_config_needs_no_file_edited(monkeypatch, tiny_root, case):
    """With a field added to the port's config, granite's file and the tiny
    root's pass as they stand; a preset whose new field is not its default
    fails where the file leaves the field out; a file key that is no field
    fails, named; a tuple field equals the file's list."""
    grown = _grown(monkeypatch)
    if case == "granite":
        check_config(*_granite(grown))
    elif case == "tiny":
        man = Manifest(tiny_root)
        check_pieces(man)
        check_mfu_counts(man)
        entry = next(c for c in man.data["configs"] if c["name"] == "tiny_cut")
        data = man.config("tiny_cut")
        check_config(entry, data, _published_preset(data))
    elif case == "unset_field":
        with pytest.raises(AssertionError, match="ssm_groups"):
            check_config(*_granite(grown, ssm_groups=2))
    elif case == "stray_key":
        entry, data, port = _granite(grown)
        data["ssm_group"] = 2
        with pytest.raises(AssertionError, match="ssm_group is neither"):
            check_config(entry, data, port)
    else:
        entry, data, port = _granite(grown, hybrid_layers=(6, 11))
        data["hybrid_layers"] = [6, 11]
        assert port["hybrid_layers"] == (6, 11) != data["hybrid_layers"]
        check_config(entry, data, port)


def test_traffic_is_a_function_of_the_seed():
    mix = Manifest().traffic("prefill_mix")
    a, b = prefill.lengths(mix, 2**31 + 11, 200), prefill.lengths(mix, 2**31 + 11, 200)
    c = prefill.lengths(mix, 2**31 + 12, 200)
    assert a == b and a != c
    assert sorted(a[:16]) == sorted(c[:16])               # every seed the same set of lengths
    assert sorted(a[:16]) == [2048] * 8 + [4096] * 4 + [8192] * 2 + [16384, 32768]
    t1 = prefill.prompt(5, 3, 64, 1000, "cpu")
    assert torch.equal(t1, prefill.prompt(5, 3, 64, 1000, "cpu"))
    assert not torch.equal(t1, prefill.prompt(5, 4, 64, 1000, "cpu"))
    f1, f2 = train.Feed(2**33, 2, 8, 100, "cpu"), train.Feed(2**33, 2, 8, 100, "cpu")
    b1, b2 = f1.next(), f2.next()
    assert torch.equal(b1["tokens"], b2["tokens"]) and torch.equal(b1["labels"], b2["labels"])
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert not torch.equal(f1.next()["tokens"], b1["tokens"])


def test_paths_hold_only_the_benchmark():
    for path in PKG.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./\-]+$", rel), rel

