"""Lifeguard suspicion timer (host side): the port's copy of
``consul_tpu/net/suspicion.py``.

Equivalent of memberlist/suspicion.go: starts at the max timeout and is
driven toward the min by independent confirmations on a log scale.  The
timeout math is shared with the simulator via
``consul_tpu_torch.protocol.remaining_suspicion_timeout``.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable

from consul_tpu_torch.protocol import (
    awareness_scaled_timeout,
    remaining_suspicion_timeout,
)


class Suspicion:
    """suspicion.go:50-130 newSuspicion/Confirm.

    ``health_score`` is the local node's Lifeguard NHM at suspicion
    start: the minimum timeout scales by ``score + 1`` (the same shared
    ``awareness_scaled_timeout`` the simulated model applies), so a degraded
    observer waits longer before converting a suspicion into an
    obituary — LHA-Suspicion, the accuracy half of Lifeguard.
    """

    def __init__(
        self,
        from_node: str,
        k: int,
        min_s: float,
        max_s: float,
        timeout_fn: Callable[[int], None],
        health_score: int = 0,
    ):
        self.k = k
        self.min_s = awareness_scaled_timeout(min_s, health_score)
        self.max_s = max(max_s, self.min_s)
        self.confirmations = {from_node}  # the accuser doesn't confirm
        self.n = 0
        self._timeout_fn = timeout_fn
        self._start = time.monotonic()
        timeout = self.min_s if k < 1 else self.max_s
        self._handle = asyncio.get_running_loop().call_later(
            timeout, self._fire
        )

    def _fire(self) -> None:
        self._timeout_fn(self.n)

    def remaining(self) -> float:
        """Seconds left on the timer given current confirmations."""
        total_ms = remaining_suspicion_timeout(
            self.n, self.k, self.min_s * 1000.0, self.max_s * 1000.0
        )
        elapsed = time.monotonic() - self._start
        return total_ms / 1000.0 - elapsed

    def confirm(self, from_node: str) -> bool:
        """Register an independent confirmation; True if it was new
        information (suspicion.go:103-130)."""
        if self.n >= self.k:
            return False
        if from_node in self.confirmations:
            return False
        self.confirmations.add(from_node)
        self.n += 1
        remaining = self.remaining()
        self._handle.cancel()
        loop = asyncio.get_running_loop()
        if remaining > 0:
            self._handle = loop.call_later(remaining, self._fire)
        else:
            self._handle = loop.call_soon(self._fire)
        return True

    def stop(self) -> None:
        self._handle.cancel()
