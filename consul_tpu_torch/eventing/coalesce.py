"""Event coalescing: batch bursty member/user events before delivery; the
port's copy of ``consul_tpu/eventing/coalesce.py``.

Equivalent of ``serf/coalesce.go:9-28`` + ``coalesce_member.go`` +
``coalesce_user.go``: during churn (a partition heals, 500 nodes flap)
the application shouldn't see one event per transition — events buffer
for ``coalesce_period`` after the first arrival (flushing early after
``quiescent_period`` of silence) and each member/user-event name
contributes only its LATEST state to the flushed batch.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional

from consul_tpu_torch.eventing import cluster as _c


def _is_member_event(t) -> bool:
    return t in (
        _c.EventType.MEMBER_JOIN,
        _c.EventType.MEMBER_LEAVE,
        _c.EventType.MEMBER_FAILED,
        _c.EventType.MEMBER_UPDATE,
        _c.EventType.MEMBER_REAP,
    )


class Coalescer:
    """coalesce.go coalesceLoop, shared by the member and user shims."""

    def __init__(
        self,
        emit: Callable,
        coalesce_s: float,
        quiescent_s: float,
    ):
        self._emit = emit
        self.coalesce_s = coalesce_s
        self.quiescent_s = min(quiescent_s, coalesce_s)
        # Latest member event type per member name (coalesce_member.go
        # lastEvents), and latest user event per name.
        self._member_latest: dict[str, tuple] = {}
        self._user_latest: dict[str, "_c.Event"] = {}
        self._flush_task: Optional[asyncio.Task] = None
        self._deadline = 0.0
        self._arrivals = 0

    def handle(self, event) -> bool:
        """Returns True when the event was absorbed for coalescing."""
        if _is_member_event(event.type):
            for m in event.members:
                self._member_latest[m.name] = (event.type, m)
            self._arrivals += 1
            self._schedule()
            return True
        if event.type == _c.EventType.USER:
            self._user_latest[event.name] = event
            self._arrivals += 1
            self._schedule()
            return True
        return False  # queries etc. pass through untouched

    def _schedule(self) -> None:
        loop = asyncio.get_running_loop()
        now = loop.time()
        if self._flush_task is None or self._flush_task.done():
            # First event of a burst: hard deadline = coalesce period.
            self._deadline = now + self.coalesce_s
            self._flush_task = asyncio.create_task(self._flush_loop())

    async def _flush_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            # Flush at the hard deadline, or earlier once the burst
            # goes quiet for quiescent_period (coalesce.go resets the
            # quiescent timer on ANY arrival, so count arrivals — an
            # updating-in-place flap must not read as quiet).
            before = self._arrivals
            wait = min(self.quiescent_s, self._deadline - loop.time())
            if wait > 0:
                await asyncio.sleep(wait)
            if loop.time() >= self._deadline or self._arrivals == before:
                break
        self.flush()

    def flush(self) -> None:
        """One event per member-event type carrying all its members,
        plus each user event's latest occurrence."""
        by_type: dict[int, list] = {}
        for etype, member in self._member_latest.values():
            by_type.setdefault(etype, []).append(member)
        self._member_latest.clear()
        for etype in sorted(by_type):
            self._emit(_c.Event(type=_c.EventType(etype),
                                members=by_type[etype]))
        users = list(self._user_latest.values())
        self._user_latest.clear()
        for ev in users:
            self._emit(ev)

    def stop(self) -> None:
        if self._flush_task is not None:
            self._flush_task.cancel()
        self.flush()
