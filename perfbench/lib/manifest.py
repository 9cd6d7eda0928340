"""Finds everything of a cell by the names in ``BENCHMARK.json``.

A configuration is ``perfbench/configs/<config>.json`` (the file the
manifest names, under the given root, else in the checkout), a traffic mix
``perfbench/traffic/<traffic>.json``, the limits that decide ``correct``
``perfbench/limits/<cell>.json``, a metric's reader
``perfbench/metrics/<name before the first dot>.py`` and a traffic kind's
module ``perfbench/kinds/<kind>.py``.  Each is looked up under the given
root first, then beside this file, so a cell, a mix, a configuration or a
metric is added as new files and new manifest entries alone.

A configuration names its plain reference with ``"reference": "<name>"``
(its ``family`` where it names none): ``perfbench/reference/<name>.py``.
The same name finds its model-FLOP count, ``perfbench/counts/model_<name>.py``,
else ``perfbench/counts/model.py`` where that module counts the reference
(its ``REFERENCES``); a configuration with neither has no count, and its
``mfu`` metrics read nothing.  A count module has ``train_step(cfg, batch,
seq)`` and ``prefill(cfg, batch, seq)``.

A configuration may be cut from the published model.  Each entry of its
``reduced``, in ``BENCHMARK.json`` and in the file alike, starts with the
key it cuts: in ``BENCHMARK.json`` the key alone, in the file it may go on
(``"num_layers: 24 of 81, the first pipeline stage's share"``).  Both name
the same keys, and the file's ``published`` block gives each one's
published value.  The port's preset of the model holds the published
values: the fields in which the config the harness hands the program
(``lib/harness.program_config``) differs from it are exactly those named
under ``changed_from_the_port_preset`` and those the file cuts.  A file
may leave out a field, which then takes the program's default; a key that
is neither a field nor one of the file's own (``source``, ``reduced``,
``deployment``, ``reference``, ``assumed``, ``published``,
``changed_from_the_port_preset``) is refused.  So a field of the port's
``ModelConfig`` whose default keeps every preset as it is may be added
without editing any configuration file.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import List, Optional

PKG = Path(__file__).resolve().parent.parent          # perfbench/
ROOT = PKG.parent                                      # the checkout


def reference_name(config: dict) -> str:
    """The name of a configuration's plain reference and model count."""
    return config.get("reference", config["family"])


def cut_key(entry: str) -> str:
    """The key an entry of ``reduced`` cuts: what comes before its first colon."""
    return entry.split(":", 1)[0].strip()


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
                path = self.root / c["file"]
                return json.loads((path if path.exists() else ROOT / c["file"]).read_text())
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
        mod = sys.modules.get(modname)
        if mod is None or Path(mod.__file__) != path:     # not yet, or another root's
            spec = importlib.util.spec_from_file_location(modname, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[modname] = mod
            spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str) -> ModuleType:
        return self._module("metrics", metric.split(".", 1)[0])

    def kind(self, name: str) -> ModuleType:
        return self._module("kinds", name)

    def reference(self, name: str) -> ModuleType:
        return self._module("reference", name)

    def model_count(self, reference: str) -> Optional[ModuleType]:
        """The model-FLOP count of a reference, or None where none counts it."""
        try:
            return self._module("counts", f"model_{reference}")
        except FileNotFoundError:
            fallback = self._module("counts", "model")
            return fallback if reference in fallback.REFERENCES else None
