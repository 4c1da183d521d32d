"""The import guard: no module of JAX, flax or the JAX package may be
loaded in a run. Names are compared by their top-level part (before the
first dot) whole, so `unscene3d_torch` is not taken for `unscene3d_tpu`."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "unscene3d_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """Sorted top-level names of loaded modules that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & FORBIDDEN)
