"""The manifest, BENCHMARK.json, against the benchmark's contract, and the
data files it names."""
from __future__ import annotations

import dataclasses
import json
import re

import pytest
import torch

from perfbench.kinds import prefill, train
from perfbench.lib.manifest import PKG, ROOT, Manifest

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


def test_cells_name_their_pieces():
    man = Manifest()
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = man.traffic(w["traffic"])
        man.kind(traffic["kind"])
        assert man.limits(w["name"])["limits"]
        cfg = man.config(w["config"])
        man.reference(cfg["family"])
    assert configs == {w["config"] for w in BENCH["workloads"]}
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


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
    assert entry["file"].startswith("perfbench/configs/") and entry["reduced"] == []
    data = Manifest().config(config)
    port = dataclasses.asdict(get_config(config))
    changed = data.get("changed_from_the_port_preset", {})
    for key, value in port.items():
        if key != "notes":
            assert key in data, key
            assert (data[key] != value) == (key in changed), key
    assert data["source"].startswith("https://")


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

