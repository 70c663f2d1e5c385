"""Hierarchical scope timing for the host-side pipeline.

Equivalent of the reference's header-only C++ RAII tracer
(src/tracer.h :: TRACE_SCOPE [MED; empty mount — SURVEY.md §5]) and the
Python measure() helper: nested scopes accumulate wall time + call counts
and print an indented report. Device-side profiling goes through
jax.profiler (see trace_device below); this module times the host pipeline
around it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator

import jax


@dataclass
class _Node:
    name: str
    total_s: float = 0.0
    calls: int = 0
    children: dict[str, "_Node"] = field(default_factory=dict)


class Tracer:
    """Accumulating nested scope timer (thread-local scope stack)."""

    def __init__(self) -> None:
        self._root = _Node("total")
        self._local = threading.local()

    def _stack(self) -> list[_Node]:
        if not hasattr(self._local, "stack"):
            self._local.stack = [self._root]
        return self._local.stack

    @contextlib.contextmanager
    def scope(self, name: str) -> Iterator[None]:
        stack = self._stack()
        parent = stack[-1]
        node = parent.children.setdefault(name, _Node(name))
        stack.append(node)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            node.total_s += time.perf_counter() - t0
            node.calls += 1
            stack.pop()

    def report(self) -> str:
        """Indented per-scope cumulative time/count table (the reference
        tracer's exit report)."""
        lines = ["scope                                    calls      total s      mean ms"]

        def walk(node: _Node, depth: int) -> None:
            for child in node.children.values():
                mean_ms = child.total_s / child.calls * 1e3 if child.calls else 0
                lines.append(
                    f"{'  ' * depth}{child.name:<{40 - 2 * depth}}"
                    f"{child.calls:>6}{child.total_s:>13.3f}{mean_ms:>13.2f}")
                walk(child, depth + 1)

        walk(self._root, 0)
        return "\n".join(lines)

    def reset(self) -> None:
        self._root = _Node("total")
        self._local = threading.local()


GLOBAL_TRACER = Tracer()
scope = GLOBAL_TRACER.scope


@contextlib.contextmanager
def trace_device(log_dir: str) -> Iterator[None]:
    """Capture an XLA device profile (TensorBoard-viewable) around a block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timeit(fn, *args, warmup: int = 2, iters: int = 10,
           block=jax.block_until_ready) -> float:
    """Mean seconds/call of a device function (post-warmup, blocking)."""
    for _ in range(warmup):
        block(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    block(out)
    return (time.perf_counter() - t0) / iters
