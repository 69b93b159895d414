"""The check that no JAX-side module is loaded in the measuring process."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "tpupose"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """Loaded module names whose top-level name (before the first dot) is
    one of ``FORBIDDEN``, compared whole: ``tpupose_torch`` passes."""
    names = sys.modules if names is None else names
    return sorted(n for n in list(names) if n.split(".")[0] in FORBIDDEN)
