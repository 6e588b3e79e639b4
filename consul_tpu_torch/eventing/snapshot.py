"""Serf gossip snapshot: append-only member/clock log for fast rejoin; the
port's copy of ``consul_tpu/eventing/snapshot.py`` (the same file
grammar, so each package replays the other's files).

Equivalent of ``serf/snapshot.go:17-60`` (Snapshotter): every member
alive/not-alive transition and Lamport clock advance appends one line
to a snapshot file; on restart the file is replayed so the agent knows
its previous clocks (events fired before the crash stay deduplicated)
and the addresses of previously-alive members to auto-rejoin through.
The file compacts when it outgrows ``COMPACT_THRESHOLD`` by rewriting
just the live state (snapshot.go compact()).  A graceful leave writes a
``leave`` marker so a left node does NOT auto-rejoin unless configured
to (serf.go RejoinAfterLeave, agent/consul/server_serf.go:108).

Line grammar (the reference's, minus coordinates):

    alive: <name>: <addr>
    not-alive: <name>
    clock: <n>
    event-clock: <n>
    query-clock: <n>
    leave
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from pathlib import Path
from typing import Optional

log = logging.getLogger("consul_tpu_torch.snapshot")

COMPACT_THRESHOLD = 128 * 1024  # snapshotSizeLimit (scaled down)


@dataclasses.dataclass
class PreviousState:
    """What a replayed snapshot tells a restarting agent."""

    alive: dict[str, str] = dataclasses.field(default_factory=dict)
    clock: int = 0
    event_clock: int = 0
    query_clock: int = 0
    left: bool = False


class Snapshotter:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._fh = None
        self._size = 0
        # Live view, for compaction.
        self._alive: dict[str, str] = {}
        self._clock = 0
        self._event_clock = 0
        self._query_clock = 0
        self._left = False
        self._last_flush = 0.0

    # ------------------------------------------------------------------
    # replay (snapshot.go replay())
    # ------------------------------------------------------------------

    def replay(self) -> PreviousState:
        prev = PreviousState()
        if not self.path.exists():
            return prev
        try:
            for line in self.path.read_text().splitlines():
                if line.startswith("alive: "):
                    rest = line[len("alive: "):]
                    name, _, addr = rest.partition(": ")
                    if name:
                        prev.alive[name] = addr
                elif line.startswith("not-alive: "):
                    prev.alive.pop(line[len("not-alive: "):], None)
                elif line.startswith("clock: "):
                    prev.clock = int(line[len("clock: "):])
                elif line.startswith("event-clock: "):
                    prev.event_clock = int(line[len("event-clock: "):])
                elif line.startswith("query-clock: "):
                    prev.query_clock = int(line[len("query-clock: "):])
                elif line == "leave":
                    # A leave erases the rejoin intent AND resets the
                    # alive set (snapshot.go processLine "leave").
                    prev.left = True
                    prev.alive.clear()
        except (OSError, ValueError) as e:
            log.warning("snapshot replay failed, starting fresh: %s", e)
            return PreviousState()
        self._alive = dict(prev.alive)
        self._left = prev.left
        self._clock = prev.clock
        self._event_clock = prev.event_clock
        self._query_clock = prev.query_clock
        return prev

    # ------------------------------------------------------------------
    # appends (snapshot.go processMemberEvent / updateClock)
    # ------------------------------------------------------------------

    def _append(self, line: str, flush: bool = False) -> None:
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")
            self._size = self.path.stat().st_size if self.path.exists() else 0
        self._fh.write(line + "\n")
        # Coalesced flushing (snapshot.go flushInterval): the file is a
        # rejoin hint, not a durability contract — one flush per window
        # suffices, with forced flushes at the markers that matter.
        now = time.monotonic()
        if flush or now - self._last_flush > 0.5:
            self._fh.flush()
            self._last_flush = now
        self._size += len(line) + 1
        if self._size > COMPACT_THRESHOLD:
            self.compact()

    def alive(self, name: str, addr: str) -> None:
        self._alive[name] = addr
        self._append(f"alive: {name}: {addr}")

    def not_alive(self, name: str) -> None:
        self._alive.pop(name, None)
        self._append(f"not-alive: {name}")

    def update_clock(self, clock: int, event_clock: int,
                     query_clock: int) -> None:
        if clock > self._clock:
            self._clock = clock
            self._append(f"clock: {clock}")
        if event_clock > self._event_clock:
            self._event_clock = event_clock
            self._append(f"event-clock: {event_clock}")
        if query_clock > self._query_clock:
            self._query_clock = query_clock
            self._append(f"query-clock: {query_clock}")

    def leave(self) -> None:
        # Leave resets the alive set and survives compaction
        # (snapshot.go Leave clears aliveNodes and keeps the marker).
        self._left = True
        self._alive.clear()
        self._append("leave", flush=True)

    def compact(self) -> None:
        """Rewrite with just the live state (snapshot.go compact)."""
        tmp = self.path.with_suffix(".tmp")
        with open(tmp, "w") as fh:
            fh.write(f"clock: {self._clock}\n")
            fh.write(f"event-clock: {self._event_clock}\n")
            fh.write(f"query-clock: {self._query_clock}\n")
            for name, addr in self._alive.items():
                fh.write(f"alive: {name}: {addr}\n")
            if self._left:
                fh.write("leave\n")
        if self._fh is not None:
            self._fh.close()
        os.replace(tmp, self.path)
        self._fh = open(self.path, "a")
        self._size = self.path.stat().st_size

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None
