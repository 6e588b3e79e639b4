"""In-memory pub/sub of state-store changes: snapshot + live follow; the
port's copy of ``consul_tpu/stream/publisher.py``.

Equivalent of ``agent/consul/stream`` (SURVEY.md §2.2): the reference
publishes typed events from state-store commits
(``state/memdb.go:37-41`` changeTrackerDB → ``event_publisher.go``),
holds them in an immutable append-only buffer chain
(``event_buffer.go`` bufferItem) so slow subscribers never block
publishers, and serves each new subscriber a *snapshot* of current
state followed by the live tail (``subscription.go``,
``agent/rpc/subscribe/subscribe.go:45``).

Topics here: ``service_health`` (the reference's ServiceHealth topic —
payload is the service's CheckServiceNode rows, recomputed on every
affecting commit) and ``kv`` (payload is the entry; an extension the
reference serves via blocking queries only).

The buffer chain is garbage-collected by reference counting for free:
the publisher holds only the tail item; a subscriber holds its own
cursor into the chain, so items older than every cursor become
unreachable.
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Any, Callable, Optional

TOPIC_SERVICE_HEALTH = "service_health"
TOPIC_KV = "kv"


@dataclasses.dataclass
class Event:
    """One change notification (stream.Event)."""

    topic: str
    key: str
    index: int
    payload: Any
    # True on the synthetic event that closes a snapshot
    # (pbsubscribe EndOfSnapshot).
    end_of_snapshot: bool = False


class _BufferItem:
    """event_buffer.go bufferItem: immutable once linked."""

    __slots__ = ("events", "next", "ready")

    def __init__(self) -> None:
        self.events: list[Event] = []
        self.next: Optional["_BufferItem"] = None
        self.ready = asyncio.Event()


class SubscriptionClosed(Exception):
    """Subscription force-closed (store abandoned / publisher shut down);
    the consumer must resubscribe and expect a fresh snapshot
    (subscription.go ErrSubscriptionClosed)."""


class Subscription:
    """A cursor over one topic's buffer chain, filtered by key."""

    def __init__(self, topic: str, key: str, snapshot: list[Event],
                 cursor: _BufferItem,
                 publisher: Optional["EventPublisher"] = None):
        self.topic = topic
        self.key = key
        self._pending: list[Event] = snapshot
        self._cursor = cursor
        self._closed = False
        self._publisher = publisher

    def close(self) -> None:
        self._closed = True
        # Unregister so the publisher doesn't pin this subscription —
        # and through its cursor, the whole forward buffer chain —
        # forever (event_publisher.go subscription GC).
        if self._publisher is not None:
            self._publisher._subs.discard(self)
            self._publisher = None

    def _matches(self, ev: Event) -> bool:
        return ev.key == self.key or self.key == ""

    async def next(self, timeout: Optional[float] = None) -> Event:
        """Next matching event: snapshot events first, then the live
        tail.  Raises SubscriptionClosed when force-closed, or
        asyncio.TimeoutError on timeout."""
        while True:
            if self._closed:
                raise SubscriptionClosed(self.topic)
            if self._pending:
                return self._pending.pop(0)
            item = self._cursor
            if not item.ready.is_set():
                if timeout is None:
                    await item.ready.wait()
                else:
                    await asyncio.wait_for(item.ready.wait(), timeout)
            if self._closed:
                raise SubscriptionClosed(self.topic)
            self._pending.extend(
                ev for ev in item.events if self._matches(ev)
            )
            assert item.next is not None
            self._cursor = item.next

    def __aiter__(self):
        return self

    async def __anext__(self) -> Event:
        try:
            return await self.next()
        except SubscriptionClosed as e:
            raise StopAsyncIteration from e


class EventPublisher:
    """event_publisher.go EventPublisher."""

    def __init__(self) -> None:
        self._tails: dict[str, _BufferItem] = {}
        self._snapshot_handlers: dict[
            str, Callable[[str], tuple[int, list[Event]]]
        ] = {}
        self._subs: set[Subscription] = set()

    def register_snapshot_handler(
        self, topic: str, fn: Callable[[str], tuple[int, list[Event]]]
    ) -> None:
        """``fn(key) -> (index, events)`` materializes current state for
        a new subscriber (subscribe.go runs the named snapshot func)."""
        self._snapshot_handlers[topic] = fn

    def _tail(self, topic: str) -> _BufferItem:
        tail = self._tails.get(topic)
        if tail is None:
            tail = _BufferItem()
            self._tails[topic] = tail
        return tail

    def publish(self, events: list[Event]) -> None:
        """Append a commit's events to their topic buffers; wakes every
        waiting subscriber of those topics."""
        by_topic: dict[str, list[Event]] = {}
        for ev in events:
            by_topic.setdefault(ev.topic, []).append(ev)
        for topic, evs in by_topic.items():
            tail = self._tail(topic)
            nxt = _BufferItem()
            tail.events = evs
            tail.next = nxt
            self._tails[topic] = nxt
            tail.ready.set()

    def subscribe(self, topic: str, key: str = "") -> Subscription:
        """Snapshot of current state for (topic, key), then live follow
        from the instant of subscription — no gap, no duplication of
        future events."""
        cursor = self._tail(topic)
        snapshot: list[Event] = []
        handler = self._snapshot_handlers.get(topic)
        if handler is not None:
            index, snapshot = handler(key)
            snapshot = list(snapshot)
            snapshot.append(
                Event(topic=topic, key=key, index=index, payload=None,
                      end_of_snapshot=True)
            )
        sub = Subscription(topic, key, snapshot, cursor, publisher=self)
        self._subs.add(sub)
        return sub

    def close_all(self) -> None:
        """Store abandoned (snapshot restore): every subscriber must
        resubscribe against the new world (event_publisher.go handles
        this by closing subscriptions on index regression)."""
        for sub in list(self._subs):
            sub.close()
        self._subs.clear()
        # Wake blocked subscribers so they observe the close.
        for topic, tail in self._tails.items():
            nxt = _BufferItem()
            tail.events = []
            tail.next = nxt
            self._tails[topic] = nxt
            tail.ready.set()
