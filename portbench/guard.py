"""The import guard: a run fails if any loaded module's whole top-level
name (the part before the first dot) is JAX's or the JAX package's."""

from __future__ import annotations

import sys

# `lemo_tpu_torch` begins with `lemo_tpu`, so names are compared whole
BANNED = ("jax", "jaxlib", "flax", "lemo_tpu")
PROGRAM = "lemo_tpu_torch"


def top_level_names(modules=None) -> set[str]:
    return {name.split(".", 1)[0]
            for name in (sys.modules if modules is None else modules)}


def banned_loaded(modules=None) -> list[str]:
    """The banned top-level names among `modules` (default: sys.modules)."""
    return sorted(top_level_names(modules) & set(BANNED))
