"""Pluggable transports: the port's copy of ``consul_tpu/net/transport.py``.

The reference's Transport interface (memberlist/transport.go:28-66) is
the seam that lets a simulated population stand in for the kernel:
packets in/out plus reliable streams in/out.  A host agent takes any
object with these methods.

  InMemoryNetwork / InMemoryTransport -- the deterministic in-process fake
      network (memberlist/mock_transport.go:14-66 MockNetwork): N
      transports wired through asyncio queues with fake addresses,
      optional per-packet loss and latency for fault injection (the
      serf messageDropper analogue, serf/config.go:250-255).
  UDPTransport -- real sockets: UDP datagrams for packets, TCP for
      streams (memberlist/net_transport.go).
  SimTransport (``net/sim_transport.py``) -- a population simulated on
      the device.
"""

from __future__ import annotations

import abc
import asyncio
import random
import time
from typing import Callable, Optional


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


# ----------------------------------------------------------------------
# In-memory network (the default unit of testing)
# ----------------------------------------------------------------------


_EOF = object()  # close sentinel on the queue


class _QueueStream(Stream):
    def __init__(self):
        self._a_to_b: asyncio.Queue = asyncio.Queue()
        self._b_to_a: asyncio.Queue = asyncio.Queue()
        self.closed = False

    def peer(self) -> "_QueueStream":
        p = _QueueStream.__new__(_QueueStream)
        p._a_to_b, p._b_to_a = self._b_to_a, self._a_to_b
        p.closed = False
        return p

    async def send(self, payload: bytes) -> None:
        if self.closed:
            raise ConnectionError("stream closed")
        await self._a_to_b.put(payload)

    async def recv(self, timeout: Optional[float] = None) -> bytes:
        if self.closed:
            raise ConnectionError("stream closed")
        if timeout is None:
            frame = await self._b_to_a.get()
        else:
            frame = await asyncio.wait_for(self._b_to_a.get(), timeout)
        if frame is _EOF:
            # Like a TCP FIN: the peer closed; wake any other blocked
            # reader too, then surface the failure.
            self.closed = True
            self._b_to_a.put_nowait(_EOF)
            raise ConnectionError("stream closed by peer")
        return frame

    async def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        # Notify the peer's (possibly blocked) recv.
        self._a_to_b.put_nowait(_EOF)
        # And our own, in case another task is blocked on it.
        self._b_to_a.put_nowait(_EOF)


class InMemoryNetwork:
    """mock_transport.go MockNetwork: a registry of in-process transports
    with fake addresses, plus fault-injection knobs."""

    def __init__(
        self,
        loss: float = 0.0,
        latency_s: float = 0.0,
        seed: int = 0,
        drop_fn: Optional[Callable[[bytes, str, str], bool]] = None,
    ):
        self.transports: dict[str, "InMemoryTransport"] = {}
        self.loss = loss
        self.latency_s = latency_s
        self.drop_fn = drop_fn  # (payload, src, dst) -> drop?
        self._rng = random.Random(seed)
        self._next = 0

    def new_transport(self, name: Optional[str] = None) -> "InMemoryTransport":
        addr = name or f"mem://node{self._next}"
        self._next += 1
        if addr in self.transports:
            raise ValueError(f"duplicate transport address {addr}")
        t = InMemoryTransport(self, addr)
        self.transports[addr] = t
        return t

    def _should_drop(self, payload: bytes, src: str, dst: str) -> bool:
        if self.drop_fn is not None and self.drop_fn(payload, src, dst):
            return True
        return self.loss > 0 and self._rng.random() < self.loss

    async def deliver(self, payload: bytes, src: str, dst: str) -> None:
        target = self.transports.get(dst)
        if target is None or target._closed:
            return  # packets to dead nodes vanish, like UDP
        if self._should_drop(payload, src, dst):
            return
        if self.latency_s > 0:
            asyncio.get_running_loop().call_later(
                self.latency_s, target._enqueue, payload, src
            )
        else:
            target._enqueue(payload, src)


class InMemoryTransport(Transport):
    def __init__(self, net: InMemoryNetwork, addr: str):
        self._net = net
        self._addr = addr
        self._packets: asyncio.Queue = asyncio.Queue()
        self._streams: asyncio.Queue = asyncio.Queue()
        self._closed = False

    def local_addr(self) -> str:
        return self._addr

    async def write_to(self, payload: bytes, addr: str) -> float:
        if self._closed:
            raise ConnectionError("transport shut down")
        await self._net.deliver(payload, self._addr, addr)
        return time.monotonic()

    def _enqueue(self, payload: bytes, src: str) -> None:
        if not self._closed:
            self._packets.put_nowait((payload, src, time.monotonic()))

    async def recv_packet(self) -> tuple[bytes, str, float]:
        return await self._packets.get()

    async def dial(self, addr: str, timeout: float) -> Stream:
        target = self._net.transports.get(addr)
        if target is None or target._closed:
            raise ConnectionError(f"no listener at {addr}")
        s = _QueueStream()
        await target._streams.put((s.peer(), self._addr))
        return s

    async def accept_stream(self) -> Stream:
        s, _src = await self._streams.get()
        return s

    async def shutdown(self) -> None:
        self._closed = True
        self._net.transports.pop(self._addr, None)


# ----------------------------------------------------------------------
# Real sockets: UDP packets + TCP streams (net_transport.go)
# ----------------------------------------------------------------------


class _TCPStream(Stream):
    """Length-prefixed frames over a TCP connection."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._r, self._w = reader, writer

    async def send(self, payload: bytes) -> None:
        self._w.write(len(payload).to_bytes(4, "big") + payload)
        await self._w.drain()

    async def recv(self, timeout: Optional[float] = None) -> bytes:
        async def _read():
            hdr = await self._r.readexactly(4)
            return await self._r.readexactly(int.from_bytes(hdr, "big"))

        if timeout is None:
            return await _read()
        return await asyncio.wait_for(_read(), timeout)

    async def close(self) -> None:
        self._w.close()
        try:
            await self._w.wait_closed()
        except Exception:
            pass


class UDPTransport(Transport):
    """UDP datagrams on addr 'host:port'; TCP streams on the same port
    (net_transport.go:40-50 binds both)."""

    def __init__(self, bind_host: str = "127.0.0.1", bind_port: int = 0):
        self._bind = (bind_host, bind_port)
        self._packets: asyncio.Queue = asyncio.Queue()
        self._streams: asyncio.Queue = asyncio.Queue()
        self._udp: Optional[asyncio.DatagramTransport] = None
        self._tcp: Optional[asyncio.AbstractServer] = None
        self._addr = ""

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        packets = self._packets

        class Proto(asyncio.DatagramProtocol):
            def datagram_received(self, data, addr):
                packets.put_nowait(
                    (data, f"{addr[0]}:{addr[1]}", time.monotonic())
                )

        self._udp, _ = await loop.create_datagram_endpoint(
            Proto, local_addr=self._bind
        )
        host, port = self._udp.get_extra_info("sockname")[:2]

        async def on_conn(reader, writer):
            await self._streams.put(_TCPStream(reader, writer))

        self._tcp = await asyncio.start_server(on_conn, host, port)
        self._addr = f"{host}:{port}"

    def local_addr(self) -> str:
        return self._addr

    async def write_to(self, payload: bytes, addr: str) -> float:
        host, port = addr.rsplit(":", 1)
        self._udp.sendto(payload, (host, int(port)))
        return time.monotonic()

    async def recv_packet(self) -> tuple[bytes, str, float]:
        return await self._packets.get()

    async def dial(self, addr: str, timeout: float) -> Stream:
        host, port = addr.rsplit(":", 1)
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, int(port)), timeout
        )
        return _TCPStream(reader, writer)

    async def accept_stream(self) -> Stream:
        return await self._streams.get()

    async def shutdown(self) -> None:
        if self._udp:
            self._udp.close()
        if self._tcp:
            self._tcp.close()
            await self._tcp.wait_closed()
