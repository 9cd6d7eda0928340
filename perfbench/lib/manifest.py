"""Finds everything of a cell by the names in ``BENCHMARK.json``.

A configuration is ``perfbench/configs/<config>.json`` (the file the
manifest names), a traffic mix ``perfbench/traffic/<traffic>.json``, the
limits that decide ``correct`` ``perfbench/limits/<cell>.json``, a metric's
reader ``perfbench/metrics/<name before the first dot>.py``, a traffic
kind's module ``perfbench/kinds/<kind>.py`` and a family's reference
``perfbench/reference/<family>.py``.  Each is looked up under the given
root first, then beside this file, so a cell, a mix, a configuration or a
metric is added as new files and new manifest entries alone.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import List

PKG = Path(__file__).resolve().parent.parent          # perfbench/
ROOT = PKG.parent                                      # the checkout


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def _find(self, sub: str, name: str, ext: str) -> Path:
        for base in (self.root / "perfbench", PKG):
            path = base / sub / f"{name}{ext}"
            if path.exists():
                return path
        raise FileNotFoundError(f"no perfbench/{sub}/{name}{ext}")

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads(self._find("traffic", name, ".json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads(self._find("limits", cell, ".json").read_text())

    def metrics(self, section: str, cell: str) -> List[dict]:
        """The metrics of ``section`` ("end_to_end" or "per_layer") that the
        cell reports."""
        return [m for m in self.data[section] if cell in m.get("workloads", [cell])]

    def _module(self, sub: str, name: str) -> ModuleType:
        path = self._find(sub, name, ".py")
        modname = f"perfbench.{sub}.{name}"
        if path == PKG / sub / f"{name}.py":
            return importlib.import_module(modname)
        if modname not in sys.modules:
            spec = importlib.util.spec_from_file_location(modname, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[modname] = mod
            spec.loader.exec_module(mod)
        return sys.modules[modname]

    def reader(self, metric: str) -> ModuleType:
        return self._module("metrics", metric.split(".", 1)[0])

    def kind(self, name: str) -> ModuleType:
        return self._module("kinds", name)

    def reference(self, family: str) -> ModuleType:
        return self._module("reference", family)
