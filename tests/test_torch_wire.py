"""The port's wire codec (``consul_tpu_torch/net/wire.py``) against the
``msgpack`` package the JAX package encodes with: the same bytes as
``msgpack.packb(body, use_bin_type=True)``, the same values as
``msgpack.unpackb(raw, raw=False)``, at every width boundary."""

import math

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from consul_tpu.net import wire as j_wire
from consul_tpu_torch.net import wire

# Each integer format's edges: fixint, 8, 16, 32 and 64 bits, both signs.
EDGES = sorted({s * b + d for b in (2 ** 5, 2 ** 7, 2 ** 8, 2 ** 15, 2 ** 16,
                                    2 ** 31, 2 ** 32, 2 ** 63)
                for s in (1, -1) for d in (-1, 0, 1)
                if -(2 ** 63) <= s * b + d < 2 ** 64})
# Each length format's edges: fix, 8, 16 and 32-bit lengths.
LENGTHS = (0, 15, 16, 31, 32, 255, 256, 65535, 65536)


def _same(body) -> None:
    raw = msgpack.packb(body, use_bin_type=True)
    assert wire.packb(body) == raw
    got = wire.unpackb(raw)
    assert got == msgpack.unpackb(raw, raw=False)
    assert wire.packb(got) == msgpack.packb(got, use_bin_type=True)


ints = st.one_of(st.sampled_from(EDGES),
                 st.integers(-(2 ** 63), 2 ** 64 - 1))
scalars = st.one_of(
    st.none(), st.booleans(), ints,
    st.floats(allow_nan=False, width=64), st.floats(allow_nan=False,
                                                     width=32),
    st.text(max_size=40), st.binary(max_size=40),
    st.sampled_from(["a" * 31, "a" * 32, "é" * 16, b"b" * 255, b"b" * 256]),
)
bodies = st.recursive(
    scalars,
    lambda inner: st.one_of(
        st.lists(inner, max_size=18),
        st.tuples(inner, inner),
        st.dictionaries(st.one_of(st.text(max_size=8),
                                  st.binary(max_size=8)),
                        inner, max_size=18),
    ),
    max_leaves=40,
)


@settings(max_examples=300, deadline=None)
@given(bodies)
def test_codec_matches_msgpack(body):
    _same(body)


@pytest.mark.parametrize("x", EDGES)
def test_integer_edges(x):
    _same(x)
    _same([x, -x if -x >= -(2 ** 63) else 0, {"v": x}])


@pytest.mark.parametrize("n", LENGTHS)
def test_length_edges(n):
    _same("s" * n)
    _same(b"\x00" * n)
    _same(list(range(n)))
    _same({str(i): i for i in range(n)})


def test_floats_and_out_of_range():
    for x in (0.0, -0.0, 1.5, math.inf, -math.inf, 1e308, 5e-324):
        _same(x)
    raw32 = msgpack.packb(1.1, use_single_float=True)
    assert wire.unpackb(raw32) == msgpack.unpackb(raw32, raw=False)
    assert math.isnan(wire.unpackb(msgpack.packb(math.nan)))
    for x in (2 ** 64, -(2 ** 63) - 1):
        with pytest.raises(OverflowError):
            wire.packb(x)


def test_ext_types_raise():
    with pytest.raises(TypeError):
        wire.packb(msgpack.ExtType(1, b"x"))
    with pytest.raises(TypeError):
        wire.packb({"t": msgpack.Timestamp(1, 0)})
    with pytest.raises(TypeError):
        wire.packb({1, 2})
    for ext in (msgpack.ExtType(1, b"x"), msgpack.ExtType(2, b"y" * 300)):
        with pytest.raises(ValueError, match="ext"):
            wire.unpackb(msgpack.packb(ext))


def test_malformed_input_raises():
    raw = msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError):
        wire.unpackb(raw[:-1])
    with pytest.raises(ValueError):
        wire.unpackb(raw + b"\x00")
    with pytest.raises(ValueError):
        wire.unpackb(b"\xc1")
    with pytest.raises(ValueError, match="map key"):
        wire.unpackb(msgpack.packb({1: 2}))


@pytest.mark.parametrize("body", [
    {1: 2}, {-3: "a", 7: {2 ** 40: [1, {None: True}]}}, {1.5: b"x", "k": 0},
    {True: [], b"b": {"s": {9: 9}}},
])
def test_loose_map_keys(body):
    """``strict_map_key=False``, as the snapshot archive reads its state:
    any key msgpack decodes, the same values; the default still refuses."""
    raw = msgpack.packb(body, use_bin_type=True)
    assert wire.packb(body) == raw
    got = wire.unpackb(raw, strict_map_key=False)
    assert got == msgpack.unpackb(raw, raw=False, strict_map_key=False)
    assert got == body
    with pytest.raises(ValueError, match="map key"):
        wire.unpackb(raw)
    with pytest.raises(ValueError, match="map key"):
        wire.unpackb(raw, strict_map_key=True)


def test_messages_and_compound_match_reference():
    bodies = [{"seq": -7, "node": "host0", "from": "sim-3"},
              {"name": "sim-1", "addr": "sim://1", "inc": 2 ** 20,
               "status": 0, "meta": b""},
              {"nodes": [{"name": f"sim-{i}"} for i in range(20)]}]
    msgs = []
    for t, body in zip((wire.MessageType.PING, wire.MessageType.ALIVE,
                        wire.MessageType.PUSH_PULL), bodies):
        got = wire.encode(t, body)
        assert got == j_wire.encode(j_wire.MessageType(int(t)), body)
        assert wire.decode(got) == j_wire.decode(got)
        msgs.append(got)
    for k in (0, 1, 3):
        packed = wire.make_compound(msgs[:k])
        assert packed == j_wire.make_compound(msgs[:k])
        assert wire.split_compound(packed) == j_wire.split_compound(packed)
    assert [int(m) for m in wire.MessageType] == [
        int(m) for m in j_wire.MessageType]
    with pytest.raises(ValueError):
        wire.make_compound([b"x"] * 256)
    with pytest.raises(ValueError):
        wire.split_compound(wire.make_compound(msgs)[:-1])
    with pytest.raises(ValueError):
        wire.decode(b"")
