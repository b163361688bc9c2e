"""The import guard: a run fails where the process has loaded JAX or the
JAX package.  Module names are compared by their whole top-level name, the
part before the first dot: the port's name begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "akaze_tpu"})


def forbidden_modules(modules=None) -> list:
    """Sorted top-level names in `modules` (default sys.modules) that the
    benchmark may not load."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)
