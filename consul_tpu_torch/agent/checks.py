"""Health check executors; the port's copy of ``consul_tpu/agent/checks.py``.

Equivalent of ``agent/checks/check.go``: each runner drives one check
definition and reports status transitions into the agent's LocalState
(which anti-entropy then pushes to the catalog).

  CheckTTL      check.go:231 — app heartbeats via the agent API; missing
                the TTL flips the check critical
  CheckMonitor  check.go:63 — run a command periodically; exit 0 =
                passing, 1 = warning, else critical
  CheckTCP      check.go:512 — connect() success = passing
  CheckHTTP     check.go:333 — GET; 2xx passing, 429 warning, else
                critical (body captured as output)
  CheckAlias    alias.go:23 — mirrors the health of another locally
                registered service: any critical -> critical, any
                warning -> warning, all passing -> passing, service
                missing -> critical

Timeouts, first-run randomization (to avoid thundering herds after an
agent restart) and output truncation follow the reference's behavior.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import random
import time
from typing import Callable, Optional

from consul_tpu_torch.store.state import (
    HEALTH_CRITICAL,
    HEALTH_PASSING,
    HEALTH_WARNING,
)

log = logging.getLogger("consul_tpu_torch.checks")

OUTPUT_MAX = 4096  # check.go BufSize truncation analogue

# notify(check_id, status, output)
Notify = Callable[[str, str, str], None]


class CheckRunner:
    check_id: str

    def start(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def stop(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError


@dataclasses.dataclass
class CheckTTL(CheckRunner):
    """TTL check: flips critical unless touched within ttl
    (check.go:231 + agent TTL endpoints)."""

    check_id: str
    ttl_s: float
    notify: Notify
    _task: Optional[asyncio.Task] = None
    _deadline: float = 0.0

    def start(self) -> None:
        self._deadline = time.monotonic() + self.ttl_s
        self._task = asyncio.create_task(self._run())

    def stop(self) -> None:
        if self._task:
            self._task.cancel()

    def set_status(self, status: str, output: str = "") -> None:
        """App heartbeat (pass/warn/fail endpoints): resets the timer."""
        self._deadline = time.monotonic() + self.ttl_s
        self.notify(self.check_id, status, output[:OUTPUT_MAX])

    async def _run(self) -> None:
        while True:
            now = time.monotonic()
            if now >= self._deadline:
                self.notify(
                    self.check_id,
                    HEALTH_CRITICAL,
                    f"TTL expired ({self.ttl_s}s without update)",
                )
                self._deadline = now + self.ttl_s  # re-arm; stays critical
            await asyncio.sleep(
                max(0.01, min(self._deadline - now, self.ttl_s / 2))
            )


class _PeriodicCheck(CheckRunner):
    """Common run-every-interval machinery with first-run stagger."""

    def __init__(self, check_id: str, interval_s: float, timeout_s: float,
                 notify: Notify):
        self.check_id = check_id
        self.interval_s = interval_s
        self.timeout_s = timeout_s or interval_s
        self.notify = notify
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self._task = asyncio.create_task(self._run())

    def stop(self) -> None:
        if self._task:
            self._task.cancel()

    async def _run(self) -> None:
        # Initial stagger within one interval (check.go:94-102).
        await asyncio.sleep(random.random() * min(self.interval_s, 1.0))
        while True:
            try:
                status, output = await asyncio.wait_for(
                    self._probe(), self.timeout_s
                )
            except asyncio.TimeoutError:
                status, output = HEALTH_CRITICAL, "check timed out"
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — a probe error is a result
                status, output = HEALTH_CRITICAL, str(e)
            self.notify(self.check_id, status, output[:OUTPUT_MAX])
            await asyncio.sleep(self.interval_s)

    async def _probe(self) -> tuple[str, str]:  # pragma: no cover - iface
        raise NotImplementedError


class CheckMonitor(_PeriodicCheck):
    """Script check: exit 0 passing / 1 warning / other critical
    (check.go:63 CheckMonitor)."""

    def __init__(self, check_id: str, command: str, interval_s: float,
                 notify: Notify, timeout_s: float = 30.0):
        super().__init__(check_id, interval_s, timeout_s, notify)
        self.command = command

    async def _probe(self) -> tuple[str, str]:
        proc = await asyncio.create_subprocess_shell(
            self.command,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.STDOUT,
        )
        out, _ = await proc.communicate()
        output = out.decode(errors="replace")
        if proc.returncode == 0:
            return HEALTH_PASSING, output
        if proc.returncode == 1:
            return HEALTH_WARNING, output
        return HEALTH_CRITICAL, output


class CheckTCP(_PeriodicCheck):
    """TCP connect check (check.go:512)."""

    def __init__(self, check_id: str, addr: str, interval_s: float,
                 notify: Notify, timeout_s: float = 10.0):
        super().__init__(check_id, interval_s, timeout_s, notify)
        host, _, port = addr.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)

    async def _probe(self) -> tuple[str, str]:
        reader, writer = await asyncio.open_connection(self.host, self.port)
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:  # noqa: BLE001
            pass
        return HEALTH_PASSING, f"TCP connect {self.host}:{self.port}: Success"


class CheckHTTP(_PeriodicCheck):
    """HTTP GET check (check.go:333): 2xx passing, 429 warning, other
    critical.  Minimal HTTP/1.1 client over asyncio sockets (no external
    client library in the image)."""

    def __init__(self, check_id: str, url: str, interval_s: float,
                 notify: Notify, timeout_s: float = 10.0):
        super().__init__(check_id, interval_s, timeout_s, notify)
        self.url = url
        # Parse http://host:port/path
        rest = url.split("://", 1)[-1]
        hostport, slash, path = rest.partition("/")
        host, _, port = hostport.partition(":")
        self.host = host
        self.port = int(port or 80)
        self.path = slash + path or "/"

    async def _probe(self) -> tuple[str, str]:
        reader, writer = await asyncio.open_connection(self.host, self.port)
        try:
            writer.write(
                f"GET {self.path} HTTP/1.1\r\nHost: {self.host}\r\n"
                f"Connection: close\r\nUser-Agent: consul-tpu-check\r\n\r\n"
                .encode()
            )
            await writer.drain()
            raw = await reader.read(OUTPUT_MAX)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass
        status_line = raw.split(b"\r\n", 1)[0].decode(errors="replace")
        parts = status_line.split()
        code = int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else 0
        body = raw.split(b"\r\n\r\n", 1)[-1].decode(errors="replace")
        output = f"HTTP GET {self.url}: {code} Output: {body}"
        if 200 <= code < 300:
            return HEALTH_PASSING, output
        if code == 429:
            return HEALTH_WARNING, output
        return HEALTH_CRITICAL, output


class CheckAlias(CheckRunner):
    """alias.go:23 CheckAlias: reflect another service's health."""

    def __init__(self, check_id: str, alias_service: str,
                 lookup: Callable[[str], Optional[list[str]]],
                 notify: Notify, interval_s: float = 1.0):
        self.check_id = check_id
        self.alias_service = alias_service
        self.lookup = lookup
        self.notify = notify
        self.interval_s = interval_s
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()

    async def _loop(self) -> None:
        while True:
            statuses = self.lookup(self.alias_service)
            if statuses is None:
                self.notify(self.check_id, HEALTH_CRITICAL,
                            "aliased service is not registered")
            elif HEALTH_CRITICAL in statuses:
                self.notify(self.check_id, HEALTH_CRITICAL,
                            "aliased check is critical")
            elif HEALTH_WARNING in statuses:
                self.notify(self.check_id, HEALTH_WARNING,
                            "aliased check is warning")
            else:
                # No checks at all counts as passing (alias.go
                # CheckIfServiceIDExists + empty check set).
                self.notify(self.check_id, HEALTH_PASSING,
                            "all checks passing")
            await asyncio.sleep(self.interval_s)


def build_check_runner(
    defn: dict,
    notify: Notify,
    alias_lookup: Optional[Callable[[str], Optional[list[str]]]] = None,
) -> Optional[CheckRunner]:
    """Map a check definition dict to its executor (agent.go
    addCheck dispatch): ttl | script/args | tcp | http | alias."""
    cid = defn.get("check_id") or defn.get("name")
    interval = _seconds(defn.get("interval", 10.0))
    timeout = _seconds(defn.get("timeout", 0.0))
    if defn.get("alias_service"):
        if alias_lookup is None:
            return None
        return CheckAlias(cid, defn["alias_service"], alias_lookup, notify,
                          interval_s=interval or 1.0)
    if defn.get("ttl"):
        return CheckTTL(cid, _seconds(defn["ttl"]), notify)
    if defn.get("script") or defn.get("args"):
        cmd = defn.get("script") or " ".join(defn["args"])
        return CheckMonitor(cid, cmd, interval, notify,
                            timeout_s=timeout or 30.0)
    if defn.get("tcp"):
        return CheckTCP(cid, defn["tcp"], interval, notify,
                        timeout_s=timeout or 10.0)
    if defn.get("http"):
        return CheckHTTP(cid, defn["http"], interval, notify,
                         timeout_s=timeout or 10.0)
    return None  # bare catalog check with no executor


def _seconds(v) -> float:
    from consul_tpu_torch.agent.server import _parse_ttl

    return _parse_ttl(v)
