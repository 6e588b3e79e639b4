"""Live log streaming: the ``consul monitor`` data source; the port's copy
of ``consul_tpu/agent/monitor.py``.

Parity model: ``logging/monitor/monitor.go`` — a sink attached to the
process's intercept logger feeds a bounded channel per subscriber;
messages beyond the buffer are DROPPED (and counted) rather than
blocking the logger; ``agent/agent_endpoint.go:1140`` (AgentMonitor)
streams the channel over chunked HTTP at a caller-chosen log level.

Here the "intercept logger" is the stdlib root logger of the
``consul_tpu_torch`` tree: every subsystem logger (serf, raft, http, dns,
proxycfg, ...) hangs under it, so one handler observes them all.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

ROOT_LOGGER = "consul_tpu_torch"
BUFFER_SIZE = 512  # monitor.go: "Defaults to 512"

_LEVELS = {
    "trace": logging.DEBUG,  # stdlib has no TRACE; map to DEBUG
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "err": logging.ERROR,
    "error": logging.ERROR,
}


# Live monitors per logger name + the level each logger held before the
# first monitor lowered it, so the last stop() can restore it (one
# transient API call must not durably change the agent's verbosity).
_active: dict[str, list["Monitor"]] = {}
_saved_levels: dict[str, int] = {}


class Monitor(logging.Handler):
    """monitor.go monitor: Start() yields log lines, Stop() detaches
    and reports how many lines the bounded buffer dropped."""

    def __init__(self, level_name: str = "info",
                 logger_name: str = ROOT_LOGGER,
                 buffer_size: int = BUFFER_SIZE):
        level = _LEVELS.get(level_name.lower())
        if level is None:
            raise ValueError(f"unknown log level {level_name!r}")
        super().__init__(level=level)
        self.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname)s] %(name)s: %(message)s"))
        self._logger_name = logger_name
        self._logger = logging.getLogger(logger_name)
        self._queue: asyncio.Queue[bytes] = asyncio.Queue(buffer_size)
        self.dropped = 0
        self._attached = False

    # -- logging.Handler ------------------------------------------------

    def emit(self, record: logging.LogRecord) -> None:
        try:
            line = (self.format(record) + "\n").encode()
        except Exception:  # noqa: BLE001 — a bad record must not kill logging
            return
        try:
            self._queue.put_nowait(line)
        except asyncio.QueueFull:
            # monitor.go: dropped, counted, never blocks the logger.
            self.dropped += 1

    # -- Monitor interface ----------------------------------------------

    def start(self) -> "Monitor":
        if not self._attached:
            # The monitor must see records below the tree's configured
            # level (the reference's SinkAdapter registers at its own
            # level) — lower the root logger if needed; per-record
            # filtering stays with this handler's own level.  The
            # pre-monitor level is saved once and restored when the
            # LAST live monitor detaches.
            peers = _active.setdefault(self._logger_name, [])
            if not peers:
                _saved_levels[self._logger_name] = self._logger.level
            peers.append(self)
            if self._logger.level == 0 or self._logger.level > self.level:
                self._logger.setLevel(self.level)
            self._logger.addHandler(self)
            self._attached = True
        return self

    def stop(self) -> int:
        if self._attached:
            self._logger.removeHandler(self)
            self._attached = False
            peers = _active.get(self._logger_name, [])
            if self in peers:
                peers.remove(self)
            if not peers:
                self._logger.setLevel(
                    _saved_levels.pop(self._logger_name, 0))
            else:
                # Tighten back to the least-verbose still-needed level.
                want = min(p.level for p in peers)
                saved = _saved_levels.get(self._logger_name, 0)
                self._logger.setLevel(
                    min(want, saved) if saved else want)
        return self.dropped

    async def next_line(self, timeout: Optional[float] = None) -> bytes:
        """Await the next buffered log line (the Start() channel recv)."""
        if timeout is None:
            return await self._queue.get()
        return await asyncio.wait_for(self._queue.get(), timeout)
