"""Wire format: message type enum, msgpack codec, compound messages.

The port's copy of ``consul_tpu/net/wire.py``: the reference's packet
grammar (memberlist/net.go:44-95), one byte of message type followed by a
msgpack body, and ``compound`` packets that carry several messages in one
datagram (util.go:157-217).

The reference encodes bodies with the ``msgpack`` package.  The port
carries its own codec in pure Python, :func:`packb` and :func:`unpackb`,
so that it runs where that package is not installed.  It covers every
format ``msgpack.packb(body, use_bin_type=True)`` emits for None, bool,
int, float, str, bytes, list/tuple and dict, with the same bytes, and
decodes as ``msgpack.unpackb(raw, raw=False)`` does.  Ext types are not
part of the grammar: encoding or decoding one raises.
"""

from __future__ import annotations

import enum
import struct
from typing import Any, Iterable


class MessageType(enum.IntEnum):
    """memberlist/net.go:44-59 messageType enum (same numbering)."""

    PING = 0
    INDIRECT_PING = 1
    ACK_RESP = 2
    SUSPECT = 3
    ALIVE = 4
    DEAD = 5
    PUSH_PULL = 6
    COMPOUND = 7
    USER = 8            # carries an opaque delegate payload (serf)
    COMPRESS = 9        # reserved, not implemented
    ENCRYPT = 10        # reserved, not implemented
    NACK_RESP = 11
    HAS_CRC = 12        # reserved
    ERR = 13


# msgpack-python's classes that encode as ext types; the port has no ext.
_EXT_CLASSES = ("ExtType", "Timestamp")


def _pack_int(x: int, out: list) -> None:
    if 0 <= x <= 0x7F:
        out.append(struct.pack("B", x))
    elif -32 <= x < 0:
        out.append(struct.pack("b", x))
    elif x > 0:
        for limit, head, fmt in ((0xFF, 0xCC, "B"), (0xFFFF, 0xCD, ">H"),
                                 (0xFFFFFFFF, 0xCE, ">I"),
                                 (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
            if x <= limit:
                out.append(bytes([head]) + struct.pack(fmt, x))
                return
        raise OverflowError("Integer value out of range")
    else:
        for limit, head, fmt in ((-(2 ** 7), 0xD0, "b"),
                                 (-(2 ** 15), 0xD1, ">h"),
                                 (-(2 ** 31), 0xD2, ">i"),
                                 (-(2 ** 63), 0xD3, ">q")):
            if x >= limit:
                out.append(bytes([head]) + struct.pack(fmt, x))
                return
        raise OverflowError("Integer value out of range")


# Length headers: (largest length, struct format) for 8, 16 and 32 bits.
_LENGTHS = ((0xFF, "B"), (0xFFFF, ">H"), (0xFFFFFFFF, ">I"))


def _pack_len(n: int, fix: tuple | None, heads: tuple, what: str,
              out: list) -> None:
    """The header of a string, binary, array or map of ``n`` units:
    ``fix`` = (largest fix length, base byte) where the format has one,
    ``heads`` the head bytes of its widest length headers (three for
    str and bin, 8 to 32 bits; two for array and map, 16 and 32)."""
    if fix is not None and n <= fix[0]:
        out.append(bytes([fix[1] | n]))
        return
    for head, (limit, fmt) in zip(heads, _LENGTHS[-len(heads):]):
        if n <= limit:
            out.append(bytes([head]) + struct.pack(fmt, n))
            return
    raise ValueError(f"{what} is too large")


def _pack(x: Any, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif isinstance(x, int):
        _pack_int(int(x), out)
    elif isinstance(x, float):
        out.append(struct.pack(">Bd", 0xCB, x))
    elif isinstance(x, (bytes, bytearray, memoryview)):
        data = bytes(x)
        _pack_len(len(data), None, (0xC4, 0xC5, 0xC6), "bytes object", out)
        out.append(data)
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _pack_len(len(data), (31, 0xA0), (0xD9, 0xDA, 0xDB), "str", out)
        out.append(data)
    elif isinstance(x, dict):
        _pack_len(len(x), (15, 0x80), (0xDE, 0xDF), "dict", out)
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif type(x).__name__ in _EXT_CLASSES:
        raise TypeError(f"can not serialize {type(x).__name__!r}: the wire "
                        "grammar has no ext types")
    elif isinstance(x, (list, tuple)):
        _pack_len(len(x), (15, 0x90), (0xDC, 0xDD), "list", out)
        for v in x:
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(x).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)``, byte for byte."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("Unpack failed: incomplete input")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# Fixed-width formats: head byte -> struct format.
_SCALARS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
# Variable-length formats: head byte -> (kind, length format).
_SIZED = {
    0xC4: ("bin", "B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xD9: ("str", "B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_EXT_HEADS = frozenset((0xC7, 0xC8, 0xC9, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8))


def _unpack_sized(r: _Reader, kind: str, n: int) -> Any:
    if kind == "bin":
        return r.take(n)
    if kind == "str":
        return r.take(n).decode("utf-8")
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _unpack(r)
        if type(k) not in (str, bytes):
            raise ValueError(f"{type(k).__name__} is not allowed for map "
                             "key when strict_map_key=True")
        out[k] = _unpack(r)
    return out


def _unpack(r: _Reader) -> Any:
    head = r.unpack("B")
    if head <= 0x7F:
        return head
    if head >= 0xE0:
        return head - 0x100
    if 0x80 <= head <= 0x8F:
        return _unpack_sized(r, "map", head & 0x0F)
    if 0x90 <= head <= 0x9F:
        return _unpack_sized(r, "array", head & 0x0F)
    if 0xA0 <= head <= 0xBF:
        return _unpack_sized(r, "str", head & 0x1F)
    if head == 0xC0:
        return None
    if head in (0xC2, 0xC3):
        return head == 0xC3
    if head in _SCALARS:
        return r.unpack(_SCALARS[head])
    if head in _SIZED:
        kind, fmt = _SIZED[head]
        return _unpack_sized(r, kind, r.unpack(fmt))
    if head in _EXT_HEADS:
        raise ValueError(f"ext type 0x{head:02x}: the wire grammar has none")
    raise ValueError(f"Unpack failed: reserved byte 0x{head:02x}")


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data, raw=False)`` for the formats :func:`packb`
    writes (and float32): arrays decode as lists, map keys must be str or
    bytes, and trailing bytes raise."""
    r = _Reader(bytes(data))
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("Unpack failed: extra data")
    return obj


def encode(msg_type: MessageType, body: Any) -> bytes:
    """One byte of type + msgpack body (net.go encode / util.go:37-52)."""
    return bytes([msg_type]) + packb(body)


def decode(raw: bytes) -> tuple[MessageType, Any]:
    if not raw:
        raise ValueError("empty packet")
    return MessageType(raw[0]), unpackb(raw[1:])


def make_compound(messages: Iterable[bytes]) -> bytes:
    """COMPOUND byte + count + u16 lengths + bodies (util.go:157-177)."""
    msgs = list(messages)
    if len(msgs) > 255:
        raise ValueError("too many messages for one compound packet")
    out = [bytes([MessageType.COMPOUND]), bytes([len(msgs)])]
    for m in msgs:
        out.append(struct.pack(">H", len(m)))
    out.extend(msgs)
    return b"".join(out)


def split_compound(raw: bytes) -> list[bytes]:
    """Inverse of make_compound; raw includes the leading COMPOUND byte
    (util.go:180-217 decodeCompoundMessage)."""
    if not raw or raw[0] != MessageType.COMPOUND:
        raise ValueError("not a compound message")
    n = raw[1]
    lengths = struct.unpack_from(f">{n}H", raw, 2)
    parts, off = [], 2 + 2 * n
    for ln in lengths:
        if off + ln > len(raw):
            raise ValueError("truncated compound message")
        parts.append(raw[off : off + ln])
        off += ln
    return parts
