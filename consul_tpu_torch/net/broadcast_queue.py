"""Transmit-limited broadcast queue: the port's copy of
``consul_tpu/net/broadcast_queue.py``.

Equivalent of memberlist's TransmitLimitedQueue (queue.go:14-422): each
queued broadcast is retransmitted up to ``retransmit_limit(mult, n)``
times, drained in least-transmitted-first order into a byte budget per
packet; queueing a broadcast for a name invalidates the older one
(queue.go Invalidates / name-keyed replacement).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional

from consul_tpu_torch.protocol import retransmit_limit

_seq = itertools.count()


@dataclasses.dataclass
class _Broadcast:
    name: Optional[str]       # invalidation key (None = never invalidated)
    payload: bytes
    transmits: int = 0
    seq: int = 0              # FIFO tiebreak within a transmit tier
    notify: Optional[Callable[[], None]] = None  # called when finished


class TransmitLimitedQueue:
    """queue.go semantics with a plain sorted scan (the reference uses a
    btree keyed (transmits, -len, -id); queue sizes here are far below
    the scale where that matters)."""

    def __init__(self, num_nodes: Callable[[], int], retransmit_mult: int):
        self._num_nodes = num_nodes
        self._mult = retransmit_mult
        self._items: list[_Broadcast] = []

    def __len__(self) -> int:
        return len(self._items)

    def queue(
        self,
        payload: bytes,
        name: Optional[str] = None,
        notify: Optional[Callable[[], None]] = None,
    ) -> None:
        """Queue a broadcast; a same-name broadcast replaces the old one
        (queue.go:137-178 queueBroadcast invalidation)."""
        if name is not None:
            for old in self._items:
                if old.name == name:
                    if old.notify:
                        old.notify()
                    self._items.remove(old)
                    break
        self._items.append(
            _Broadcast(name=name, payload=payload, seq=next(_seq), notify=notify)
        )

    def get_broadcasts(self, overhead: int, limit: int) -> list[bytes]:
        """Drain up to ``limit`` bytes of broadcasts (plus ``overhead``
        per message), least-transmitted first (queue.go:288-373); each
        inclusion counts as one transmission and broadcasts past the
        retransmit limit are dropped."""
        if not self._items:
            return []
        max_tx = retransmit_limit(self._mult, self._num_nodes())
        self._items.sort(key=lambda b: (b.transmits, b.seq))
        out: list[bytes] = []
        used = 0
        finished: list[_Broadcast] = []
        for b in self._items:
            if used + overhead + len(b.payload) > limit:
                continue
            used += overhead + len(b.payload)
            out.append(b.payload)
            b.transmits += 1
            if b.transmits >= max_tx:
                finished.append(b)
        for b in finished:
            if b.notify:
                b.notify()
            self._items.remove(b)
        return out

    def reset(self) -> None:
        for b in self._items:
            if b.notify:
                b.notify()
        self._items.clear()
