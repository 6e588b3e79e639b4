"""Lamport clock (serf/lamport.go:10-45): the port's copy of
``consul_tpu/eventing/lamport.py``.

The reference uses atomic CAS; the host plane is single-threaded per
event loop so plain integers suffice, but the three-method interface
(time/increment/witness) is kept identical.
"""

from __future__ import annotations


class LamportClock:
    def __init__(self, start: int = 0):
        self._counter = start

    def time(self) -> int:
        """Current time."""
        return self._counter

    def increment(self) -> int:
        """Advance and return the new time (lamport.go:22-25)."""
        self._counter += 1
        return self._counter

    def witness(self, v: int) -> None:
        """Observe a remote time: ensure ours is at least v+1
        (lamport.go:31-45)."""
        if v >= self._counter:
            self._counter = v + 1
