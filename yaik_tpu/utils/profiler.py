"""Per-stage host timing + optional device tracing.

The reference's only instrumentation is QueryPerformanceCounter wall-timing
in its decoder test app (testAppWin/main.cpp:22-38,62-102). The rebuild's
equivalent (SURVEY section 5): nested host stage timers around the pipeline
stages (plan/upload/dispatch/emit...), plus a jax.profiler trace wrapper for
device-side inspection.

Usage:
    from yaik_tpu.utils import profiler
    with profiler.enable():
        ... encode/decode calls (stages instrument themselves) ...
        print(profiler.report())

    with profiler.stage("my-stage"):       # explicit stage
        ...

    with profiler.device_trace("/tmp/tb"):  # XLA device trace -> TensorBoard
        ...

Timers are no-ops unless enabled (zero overhead on the hot paths beyond one
truthiness check), keeping the library thread-compatible: enabling is
process-global and meant for interactive profiling, not production."""
from __future__ import annotations

import contextlib
import time

_active: "_Profile | None" = None


class _Node:
    __slots__ = ("name", "total", "count", "children")

    def __init__(self, name):
        self.name = name
        self.total = 0.0
        self.count = 0
        self.children: dict = {}


class _Profile:
    def __init__(self):
        self.root = _Node("total")
        self.stack = [self.root]
        self.t0 = time.perf_counter()

    def push(self, name):
        parent = self.stack[-1]
        node = parent.children.get(name)
        if node is None:
            node = parent.children[name] = _Node(name)
        self.stack.append(node)
        return time.perf_counter()

    def pop(self, t_start):
        node = self.stack.pop()
        node.total += time.perf_counter() - t_start
        node.count += 1


@contextlib.contextmanager
def enable():
    """Activate stage timing for the dynamic extent of the block."""
    global _active
    prev, _active = _active, _Profile()
    try:
        yield _active
    finally:
        _active.root.total = time.perf_counter() - _active.t0
        _active.root.count = 1
        _active, _last[0] = prev, _active


_last = [None]


@contextlib.contextmanager
def stage(name: str):
    """Time one pipeline stage (no-op when profiling is not enabled)."""
    p = _active
    if p is None:
        yield
        return
    t = p.push(name)
    try:
        yield
    finally:
        p.pop(t)


def report(profile: "_Profile | None" = None) -> str:
    """Render the most recent (or given) profile as an indented table."""
    p = profile or _active or _last[0]
    if p is None:
        return "(no profile captured)"
    lines = []

    def walk(node, depth):
        pct = 100.0 * node.total / max(p.root.total, 1e-12)
        lines.append(f"{'  ' * depth}{node.name:<30} "
                     f"{node.total * 1e3:9.2f} ms  x{node.count:<5d} {pct:5.1f}%")
        for ch in node.children.values():
            walk(ch, depth + 1)

    walk(p.root, 0)
    return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture an XLA device profiler trace viewable in TensorBoard
    (jax.profiler.trace wrapper; falls back to a no-op if unavailable)."""
    try:
        import jax
        ctx = jax.profiler.trace(logdir)
    except Exception:       # pragma: no cover - backend without profiler
        yield
        return
    with ctx:
        yield
