"""Runtime build guards: the dynamic complement of tracelint.

The port of ``consul_tpu/analysis/guards.py``.  The reference counts the
programs ``jax.jit`` compiles per entrypoint, so a retrace (a config that
stops hashing equal, a shape that varies between calls) fails loudly
instead of silently recompiling.  The port does not jit: its compile
events are the builds it caches, and those are what this module counts:

* ``sweep.universe._make_sweep``: one batched program per (entrypoint, U,
  telemetry, mesh, exchange), an ``functools.lru_cache``; a miss is a
  build;
* ``ops._build.load``: one ``nvcc`` run per kernel source and flags
  (``ops._build.compiles``); the same library built twice in a process is
  a failure whatever the budget.

Wrap a cached builder in :func:`trace_guard` (or snapshot the named ones
with :func:`guard_entrypoints`) and any build beyond the budget raises
:class:`RetraceError`.  Counts are diffed against a snapshot taken when
the guard is made, so builders shared across tests are guarded
incrementally.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Iterable, Optional

# The port's cached builders, guarded by default.
ENGINE_ENTRYPOINTS = (
    "sweep.universe._make_sweep",
    "ops._build.load",
)


class RetraceError(AssertionError):
    """A guarded builder built more often than its budget."""


def _cache_size_fn(fn: Any) -> Optional[Callable[[], int]]:
    """The build counter of ``fn``: an ``lru_cache``'s misses, or the
    nvcc runs of ``ops._build`` for its ``load``."""
    info = getattr(fn, "cache_info", None)
    if callable(info):
        return lambda: info().misses
    from consul_tpu_torch.ops import _build

    if fn is _build.load or fn is _build.build:
        return lambda: sum(_build.compiles.values())
    return None


def _twice() -> list:
    """Kernel libraries nvcc built more than once in this process."""
    from consul_tpu_torch.ops import _build

    return sorted(k for k, v in _build.compiles.items() if v > 1)


class TraceGuard:
    """Counts builds of one cached callable against a budget.

    ``guard = TraceGuard(_make_sweep)`` snapshots the builder's count;
    every call through the guard (or a later ``guard.check()``) asserts
    that at most ``max_traces`` new builds happened since."""

    def __init__(self, fn: Callable, max_traces: int = 1,
                 name: Optional[str] = None):
        size = _cache_size_fn(fn)
        if size is None:
            raise TypeError(
                f"{name or fn!r} is not a cached builder (no cache_info); "
                "pass it through trace_guard() to cache it")
        functools.update_wrapper(self, fn, updated=())
        self._fn = fn
        self._size = size
        self.max_traces = max_traces
        self.name = name or getattr(fn, "__name__", repr(fn))
        self.calls = 0
        self._base = size()

    @property
    def traces(self) -> int:
        """Builds since this guard was created."""
        return self._size() - self._base

    def check(self) -> None:
        twice = _twice()
        if twice:
            raise RetraceError(
                f"{self.name}: kernel libraries built twice in one "
                f"process: {twice}")
        if self.traces > self.max_traces:
            raise RetraceError(
                f"{self.name} built {self.traces} programs in {self.calls} "
                f"call(s) — budget is {self.max_traces}.  A rebuild means "
                "an argument stopped hashing equal between calls (a fresh "
                "mesh or config object, a keyword spelling): the study is "
                "no longer one cached program.")

    def reset(self) -> None:
        """Re-snapshot: subsequent checks count from now."""
        self._base = self._size()
        self.calls = 0

    def __call__(self, *args, **kwargs):
        out = self._fn(*args, **kwargs)
        self.calls += 1
        self.check()
        return out


def trace_guard(fn: Callable, max_traces: int = 1,
                name: Optional[str] = None, **cache_kwargs) -> TraceGuard:
    """Wrap ``fn`` in a :class:`TraceGuard`, caching it first
    (``functools.lru_cache(**cache_kwargs)``) when it is a plain
    function."""
    if _cache_size_fn(fn) is None:
        fn = functools.lru_cache(**(cache_kwargs or {"maxsize": None}))(fn)
    elif cache_kwargs:
        raise TypeError("cache_kwargs only apply when trace_guard caches "
                        "the function itself; got a cached callable")
    return TraceGuard(fn, max_traces=max_traces, name=name)


def _resolve(path: str):
    import importlib

    module, _, attr = path.rpartition(".")
    return getattr(importlib.import_module(f"consul_tpu_torch.{module}"),
                   attr)


def guard_entrypoints(entrypoints: Iterable[str] = ENGINE_ENTRYPOINTS,
                      max_traces: int = 1) -> dict:
    """Guards over the named cached builders (``module.attr`` under
    ``consul_tpu_torch``); snapshot now, :func:`check_all` later."""
    return {name: TraceGuard(_resolve(name), max_traces=max_traces,
                             name=name)
            for name in entrypoints}


def check_all(guards: dict) -> None:
    """Check every guard; raises :class:`RetraceError` on the first
    over-budget builder."""
    for guard in guards.values():
        guard.check()
