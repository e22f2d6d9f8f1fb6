"""Which implementation the kernels' wrappers route to, as one version
number.

A kernel module `watch`es itself: from then on every assignment to one
of its attributes from outside the module (a check that routes an entry
point to its plain twin, a test's monkeypatch) bumps `version()`. What
was built against the old routing, such as a captured step
(`fitting.step_graph`), compares the version it was built at and is
built again. The module's own `global` writes (a kernel built on first
use) do not go through the module's attributes, and count nothing."""

from __future__ import annotations

import sys
import types

_version = 0


class _Watched(types.ModuleType):
    def __setattr__(self, name, value):
        global _version
        _version += 1
        super().__setattr__(name, value)

    def __delattr__(self, name):
        global _version
        _version += 1
        super().__delattr__(name)


def watch(module_name: str) -> None:
    """Count every later assignment to the attributes of the module
    `module_name` (its `__name__`)."""
    sys.modules[module_name].__class__ = _Watched


def version() -> int:
    return _version
