"""Checkpoint manager: async save / verified restore (the port of
``repro.checkpoint.manager``).

Layout:  <dir>/step_<N>/
            arrays.npz          flattened '/'-joined key -> ndarray
            meta.json           step, keys, dtypes, digest
         <dir>/LATEST           committed step number (written last: a crash
                                mid-save never corrupts the restore pointer)

A tree is nested dicts (and named tuples, such as ``AdamWState``) of
tensors or arrays.  numpy has no bfloat16 (the reference relies on
ml_dtypes), so a bf16 tensor is stored as its ``uint16`` bits and
``meta.json`` records its dtype.  ``restore_pytree`` puts each array back on
its template tensor's device and dtype.

Sharded trees (``shardings``: a matching tree of ``NamedSharding``s): a
save gathers every shard to the whole array (a collective: every rank
calls it) and rank 0 writes, in the unchanged format; a restore cuts each
whole array to this rank's shard of the given shardings, whatever mesh
wrote it (elastic: save at 2x2, restore at 4x1 or 1x4).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                 "float32": torch.float32, "float64": torch.float64, "int32": torch.int32,
                 "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}


def _items(tree):
    """(key, child) of a dict or a named tuple."""
    if isinstance(tree, Mapping):
        return list(tree.items())
    return list(tree._asdict().items())


def _is_node(x) -> bool:
    return isinstance(x, Mapping) or hasattr(x, "_asdict")


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in _items(tree):
        key = f"{prefix}{k}"
        if _is_node(v):
            flat.update(_flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def _to_host(x) -> np.ndarray:
    """A host copy of a leaf (bf16 as its uint16 bits)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
            return t.numpy().view(np.uint16)
        return t.numpy()
    return np.array(x)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.asarray(x).dtype.name


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0, or no process group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def snapshot(tree, shardings=None) -> Dict[str, Any]:
    """Everything ``save_pytree`` writes, copied to the host now: later
    in-place updates of the tree's tensors do not reach it.  With
    ``shardings`` every rank gathers each leaf whole, and only the writer
    keeps the host copies (the others get an empty snapshot)."""
    flat = _flatten(tree)
    if shardings is not None:
        from repro_torch.distributed.collectives import gather_whole
        sh = _flatten(shardings)
        flat = {k: gather_whole(v, sh[k]) for k, v in flat.items()}
        if not _writer():
            return {"arrays": {}, "dtypes": {}}
    return {"arrays": {k: _to_host(v) for k, v in flat.items()},
            "dtypes": {k: _dtype_name(v) for k, v in flat.items()}}


def save_pytree(tree, directory: str, step: int, shardings=None) -> Optional[str]:
    """Writes ``tree`` as ``step_<step>`` through a temporary directory
    renamed into place, then moves LATEST (with ``shardings``: gathered,
    written by rank 0 alone; the others return None)."""
    snap = snapshot(tree, shardings)
    return _write(snap, directory, step) if _writer() else None


def _write(snap: Dict[str, Any], directory: str, step: int) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **snap["arrays"])
    with open(os.path.join(tmp, "arrays.npz"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    meta = {
        "step": step,
        "digest": digest,
        "keys": sorted(snap["arrays"]),
        "dtypes": snap["dtypes"],
        "time": time.time(),
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(directory, "LATEST.tmp"), os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> Optional[int]:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _rebuild(template, flat: Dict[str, Any], prefix: str = ""):
    out = {k: (_rebuild(v, flat, f"{prefix}{k}/") if _is_node(v) else flat[f"{prefix}{k}"])
           for k, v in _items(template)}
    return out if isinstance(template, Mapping) else type(template)(**out)


def restore_pytree(template, directory: str, step: Optional[int] = None,
                   shardings=None, verify: bool = True):
    """Restore into the structure of ``template`` (a tree of tensors): each
    leaf a new tensor on its template's device and dtype; with ``shardings``
    (a matching tree of ``NamedSharding``s) this rank's shard of it.
    Returns (tree, step).  Raises ``FileNotFoundError`` without a checkpoint
    and ``IOError`` when the arrays do not match their digest."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    if verify:
        with open(os.path.join(d, "arrays.npz"), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != meta["digest"]:
            raise IOError(f"checkpoint {d} digest mismatch (corrupt)")
    flat = {}
    sh = _flatten(shardings) if shardings is not None else {}
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for key, leaf in _flatten(template).items():
            arr = data[key]
            if meta["dtypes"][key] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr).to(_TORCH_DTYPES[meta["dtypes"][key]])
            if key in sh:
                t = sh[key].local_slice(t).contiguous()
            if isinstance(leaf, torch.Tensor):
                t = t.to(device=leaf.device, dtype=leaf.dtype)
            flat[key] = t
    return _rebuild(template, flat), meta["step"]


class CheckpointManager:
    """Async checkpointing with bounded retention (the newest ``keep``)."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    def save(self, tree, step: int, block: bool = False, shardings=None):
        """Copies ``tree`` to the host before returning (a later optimiser
        step cannot change what is written), then writes it on a thread, or
        here when ``block``.  With ``shardings`` every rank calls this
        (the gather is collective) and rank 0 alone writes."""
        snap = snapshot(tree, shardings)
        if not _writer():
            return

        def work():
            try:
                _write(snap, self.directory, step)
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._last_error = e

        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            if self._last_error:
                e, self._last_error = self._last_error, None
                raise e

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            e, self._last_error = self._last_error, None
            raise e

    def restore(self, template, step: Optional[int] = None, shardings=None):
        return restore_pytree(template, self.directory, step, shardings=shardings)

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)
