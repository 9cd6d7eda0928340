"""What may not be loaded in a run: JAX, its libraries and the JAX package
the program was ported from.  Names are compared whole at the top level,
so the program ``repro_torch`` is not the JAX package ``repro``."""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    names = sys.modules if names is None else names
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
