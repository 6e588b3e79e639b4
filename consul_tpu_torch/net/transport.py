"""The transport seam: the port's copy of the ``Transport`` and ``Stream``
interfaces of ``consul_tpu/net/transport.py``.

The reference's Transport interface (memberlist/transport.go:28-66) is
the seam that lets a simulated population stand in for the kernel:
packets in/out plus reliable streams in/out.  A host agent takes any
object with these methods; :class:`consul_tpu_torch.net.SimTransport` is
the port's.
"""

from __future__ import annotations

import abc
from typing import Optional


class Transport(abc.ABC):
    """transport.go:28-66: packet + stream primitives."""

    @abc.abstractmethod
    def local_addr(self) -> str:
        ...

    @abc.abstractmethod
    async def write_to(self, payload: bytes, addr: str) -> float:
        """Best-effort packet send; returns the send timestamp."""

    @abc.abstractmethod
    async def recv_packet(self) -> tuple[bytes, str, float]:
        """Next inbound packet: (payload, from_addr, timestamp)."""

    @abc.abstractmethod
    async def dial(self, addr: str, timeout: float) -> "Stream":
        """Open a reliable stream to addr (push/pull, fallback ping)."""

    @abc.abstractmethod
    async def accept_stream(self) -> "Stream":
        """Next inbound stream."""

    @abc.abstractmethod
    async def shutdown(self) -> None:
        ...


class Stream(abc.ABC):
    """Minimal framed reliable stream."""

    @abc.abstractmethod
    async def send(self, payload: bytes) -> None:
        ...

    @abc.abstractmethod
    async def recv(self, timeout: Optional[float] = None) -> bytes:
        ...

    @abc.abstractmethod
    async def close(self) -> None:
        ...
