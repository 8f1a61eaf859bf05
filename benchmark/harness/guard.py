"""What the benchmark may not load: JAX, its libraries and the JAX package
the port was made from, compared by whole top-level module names
(`medseg_tpu_torch` is not `medseg_tpu`)."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "medseg_tpu"})


def forbidden(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among `names` (default: sys.modules)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
