"""Logical-axis sharding rules (MaxText-style) and model-side hint hooks.

The port of ``repro.distributed.sharding``.  Models annotate activations
with *logical* axes (``shard_hint``); the launcher installs a
``MeshContext`` mapping logical axes to mesh axes.  With no context
installed (unit tests, one process) hints are no-ops, so model code never
depends on a mesh being present.

Where the reference hands its specs to GSPMD, the port keeps every tensor
as this rank's local shard and issues the collectives itself
(``distributed/collectives.py``).  A spec is a tuple with one entry per
tensor dimension, as ``jax.sharding.PartitionSpec`` holds it: ``None``
(replicated), a mesh-axis name, or a tuple of names (sharded over their
product, the first axis major).  ``MeshContext`` is built from a
``torch.distributed.device_mesh.DeviceMesh`` or, for computing specs
without a process group, from an abstract shape and axis names.

Rules that map ``"seq"`` to ``("model",)`` (the dry run's ``sp`` variants,
as the reference's) turn on Megatron's sequence parallelism: every
``("batch", "seq", ...)`` layout then splits the sequence over ``model``
(``MeshContext.sp``), and ``collectives.py`` keeps the residual stream as
this rank's sequence chunk.
"""
from __future__ import annotations

import contextlib
import copy
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

# logical axis -> mesh axis (None = replicated); tuples shard over several
DEFAULT_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "kv_seq": None,
    "kv_seq_sharded": ("model",),  # long-context decode: SP over the KV cache
    "zero": ("data",),             # ZeRO-1 optimizer-state axis
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_cap": None,
    "layers": None,
    "ssm_heads": ("model",),
    "state": None,
}

Spec = Tuple[object, ...]

_ctx = threading.local()


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (``None``, a name or a tuple)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class MeshContext:
    """Logical -> mesh-axis rules over one mesh, and this rank's place in it.

    ``mesh``: a ``DeviceMesh`` (process groups, this rank's coordinates), or
    None with ``shape`` and ``axis_names`` for an abstract mesh (specs and
    local shapes only; coordinates all 0, no groups).  ``replicated_batch``:
    every rank holds the whole batch (``with_replicated_batch``);
    ``replicated_seq``: every rank holds the whole sequence although the
    rules split it (``with_replicated_seq``)."""

    replicated_batch = False
    replicated_seq = False

    def __init__(self, mesh=None, rules: Optional[Dict] = None, *,
                 shape: Optional[Sequence[int]] = None,
                 axis_names: Optional[Sequence[str]] = None):
        self.mesh = mesh
        if mesh is not None:
            names, sizes = tuple(mesh.mesh_dim_names), tuple(mesh.shape)
            coords = tuple(mesh.get_coordinate())
            if mesh.device_type == "cuda":
                self.device = torch.device("cuda", torch.cuda.current_device())
            else:
                self.device = torch.device(mesh.device_type)
        else:
            names, sizes = tuple(axis_names), tuple(int(s) for s in shape)
            coords = (0,) * len(sizes)
            self.device = None
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        self.coords: Dict[str, int] = dict(zip(names, coords))
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        self.sizes: Dict[str, int] = {}      # logical axis -> global size, for shard_hint
        self._groups: Dict[Tuple[str, ...], object] = {}
        if mesh is not None:
            self._make_groups()

    # -- specs ---------------------------------------------------------------
    def spec(self, logical: Sequence[Optional[str]]) -> Spec:
        axes = []
        used = set()
        for l in logical:
            if l is None:
                axes.append(None)
                continue
            m = self.rules.get(l)
            if m is None:
                axes.append(None)
                continue
            ms = tuple(a for a in m if a in self.axis_names and a not in used)
            used |= set(ms)
            if not ms:
                axes.append(None)
            elif len(ms) == 1:
                axes.append(ms[0])
            else:
                axes.append(ms)
        return tuple(axes)

    def sharding(self, logical: Sequence[Optional[str]]) -> "NamedSharding":
        return NamedSharding(self, self.spec(logical))

    def placements(self, spec: Spec) -> tuple:
        """DTensor placements of ``spec``, one per mesh axis: ``Shard(i)``
        where the axis shards tensor dimension i, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        where = {a: i for i, entry in enumerate(spec) for a in spec_axes(entry)}
        return tuple(Shard(where[a]) if a in where else Replicate() for a in self.axis_names)

    def with_replicated_batch(self) -> "MeshContext":
        """This context (same mesh, rules and groups) for a batch that the
        batch shards do not divide, replicated as the reference's decode
        ``tok_sh`` replicates it (``distributed/step.py:105-107``): every
        collective over the batch axes is then the identity, since
        otherwise a replicated token would be counted once per data rank."""
        mc = copy.copy(self)
        mc.replicated_batch = True
        return mc

    # -- sequence parallelism --------------------------------------------------
    @property
    def seq_axes(self) -> Tuple[str, ...]:
        """The mesh axes the residual stream's sequence is split over: the
        ``"seq"`` entry of ``spec(("batch", "seq", "embed"))``, () unless
        the rules split it (or in ``with_replicated_seq``).  Only ``model``
        may split it: the SP regions of ``collectives.py`` pair the
        sequence's chunks with the model shards."""
        if self.replicated_seq:
            return ()
        axes = spec_axes(self.spec(("batch", "seq", "embed"))[1])
        if axes and axes != ("model",):
            raise ValueError(f"the rules split the sequence over {axes}: the port splits it "
                             "over ('model',) only")
        return axes

    @property
    def sp(self) -> bool:
        """Sequence parallelism: the residual stream is this rank's chunk of
        the sequence (``seq_axes`` not empty)."""
        return bool(self.seq_axes)

    def with_replicated_seq(self) -> "MeshContext":
        """This context (same mesh, rules and groups) for a residual stream
        that the sequence's shards do not divide (the decode step's one
        token over ``model`` > 1), kept whole on every rank: every SP
        collective is then the identity.  GSPMD would pad the dimension
        instead."""
        mc = copy.copy(self)
        mc.replicated_seq = True
        return mc

    # -- this rank's place -----------------------------------------------------
    def size(self, axes) -> int:
        """Ranks along ``axes`` (a name or a tuple; absent axes count 1)."""
        return math.prod(self.shape.get(a, 1) for a in spec_axes(axes))

    def index(self, axes) -> int:
        """This rank's coordinate along ``axes``, the first axis major."""
        i = 0
        for a in spec_axes(axes):
            i = i * self.shape.get(a, 1) + self.coords.get(a, 0)
        return i

    def group(self, axes):
        """The process group of the ranks that differ from this one only
        along ``axes`` (a name or a tuple), in coordinate order."""
        key = tuple(a for a in spec_axes(axes) if a in self.shape)
        if self.mesh is None:
            raise RuntimeError("an abstract MeshContext has no process groups")
        if key not in self._groups:
            raise KeyError(f"no process group over {key} (mesh {self.axis_names})")
        return self._groups[key]

    def _make_groups(self) -> None:
        """One group per mesh axis (the ``DeviceMesh``'s own), and one over
        the batch axes present when there are several: every rank takes part
        in every ``new_group`` call, in the same order."""
        import torch.distributed as dist
        for a in self.axis_names:
            self._groups[(a,)] = self.mesh.get_group(a)
        batch = tuple(a for a in DEFAULT_RULES["batch"] if a in self.shape)
        if len(batch) == 1:
            self._groups[batch] = self._groups[(batch[0],)]
        elif len(batch) > 1:
            ranks = self.mesh.mesh.reshape(tuple(self.shape.values()))
            dims = [self.axis_names.index(a) for a in batch]
            rest = [d for d in range(len(self.axis_names)) if d not in dims]
            flat = ranks.permute(*rest, *dims).reshape(-1, math.prod(self.shape[a] for a in batch))
            for row in flat.tolist():
                g = dist.new_group(row)
                if dist.get_rank() in row:
                    self._groups[batch] = g


class NamedSharding:
    """A spec over one mesh: which shard of a global tensor this rank holds."""

    def __init__(self, mc: MeshContext, spec: Spec):
        self.mc = mc
        self.spec = tuple(spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mc is self.mc
                and other.spec == self.spec)

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = list(shape)
        for i, entry in enumerate(self.spec):
            n = self.mc.size(entry)
            if out[i] % n:
                raise ValueError(f"dimension {i} of {tuple(shape)} ({out[i]}) is not divisible "
                                 f"by the {n} ranks of {entry}")
            out[i] //= n
        return tuple(out)

    def local_slice(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the global tensor ``t`` (a view)."""
        shape = self.local_shape(t.shape)          # raises where a dim does not divide
        for i, entry in enumerate(self.spec):
            if shape[i] != t.shape[i]:
                t = t.narrow(i, self.mc.index(entry) * shape[i], shape[i])
        return t

    def sharded_axes(self) -> Tuple[str, ...]:
        return tuple(a for entry in self.spec for a in spec_axes(entry))


def current() -> Optional[MeshContext]:
    return getattr(_ctx, "mc", None)


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict] = None):
    """Installs a ``MeshContext`` (built over ``mesh``, or ``mesh`` itself
    when it is one) for the block."""
    prev = current()
    _ctx.mc = mesh if isinstance(mesh, MeshContext) else MeshContext(mesh, rules)
    try:
        yield _ctx.mc
    finally:
        _ctx.mc = prev


def shard_hint(x: torch.Tensor, logical: Sequence[Optional[str]]) -> torch.Tensor:
    """The reference's ``with_sharding_constraint``: a no-op outside a mesh
    context; inside one, an assertion of the activation's local layout (one
    logical axis a dimension, and a dimension whose global size the context
    knows holds its share of it).  Returns ``x``."""
    mc = current()
    if mc is None:
        return x
    if x.dim() != len(logical):
        raise ValueError(f"shard_hint: a {x.dim()}-d tensor against axes {tuple(logical)}")
    for dim, (size, ax) in enumerate(zip(x.shape, mc.spec(logical))):
        name = logical[dim]
        if name in mc.sizes and size * mc.size(ax) != mc.sizes[name]:
            raise ValueError(f"shard_hint: dimension {dim} ({name}) holds {size} of "
                             f"{mc.sizes[name]} over {mc.size(ax)} ranks")
    return x
