"""Deterministic stateless data pipeline (the port of ``repro.data.pipeline``).

Batches are a pure function of (seed, step): after a restart the pipeline
resumes at exactly the same sample without saved iterator state -- the
fault-tolerance property that makes checkpoint/restart bitwise reproducible.
A background prefetch thread hides host-side generation latency.
``SyntheticLM`` is pure numpy, a copy of the reference's, so its batches are
bit-equal to the reference's; ``make_device_batch`` puts one on a device,
or this rank's shard of it on the mesh's device.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


class SyntheticLM:
    """Synthetic next-token-predictable LM stream.

    Sequences follow a noisy affine recurrence over the vocab so that a real
    model can actually reduce loss on it (used by the e2e training example).
    """

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 prefetch: int = 2):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.prefetch = prefetch

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        b, s = self.shape.global_batch, self.shape.seq_len
        rng = np.random.default_rng((self.seed, step))
        v = self.cfg.vocab_size
        start = rng.integers(0, v, (b, 1))
        stride = rng.integers(1, 17, (b, 1))
        pos = np.arange(s + 1)[None, :]
        tokens = (start + stride * pos) % v
        noise = rng.random((b, s + 1)) < 0.05
        tokens = np.where(noise, rng.integers(0, v, (b, s + 1)), tokens)
        out = {"labels": tokens[:, 1:].astype(np.int32)}
        if self.cfg.frontend:
            emb = rng.standard_normal((b, s, self.cfg.d_model)).astype(np.float32)
            out["embeds"] = emb
        else:
            out["tokens"] = tokens[:, :-1].astype(np.int32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, start_step: int) -> Iterator[Dict[str, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                q.put(self.batch_at(step))
                step += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def make_device_batch(batch: Dict[str, np.ndarray], shardings="cuda") -> Dict[str, torch.Tensor]:
    """The host batch as torch tensors: whole on a device (``shardings`` a
    device), or, as the reference places a batch by its shardings (a dict
    of ``NamedSharding``s from ``batch_shardings``), this rank's slice of
    each array on the mesh's device."""
    if not isinstance(shardings, Mapping):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(shardings)
                for k, v in batch.items()}
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        sh = shardings.get(k)
        if sh is None:
            raise KeyError(f"no sharding for batch entry {k!r}")
        out[k] = sh.local_slice(t).contiguous().to(sh.mc.device)
    return out
