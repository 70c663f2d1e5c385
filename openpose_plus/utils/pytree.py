"""Frozen dataclasses that are JAX pytrees (every field a dynamic leaf)."""

from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls):
    """Decorate `cls` as a frozen dataclass registered with
    jax.tree_util.register_dataclass, plus a `replace(**fields)` copy."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return jax.tree_util.register_dataclass(cls)
