"""The port's outbox router and ring exchange against a numpy router and
the JAX package's ``exchange="alltoall"`` path.

The JAX ring kernel itself does not run on the installed jax (its
``pltpu.TPUCompilerParams`` is gone), so the port's ring is held against
the JAX all_to_all transport, which the reference defines to be
bit-equal to it, and against a brute-force numpy router.  The
multi-plane entry point (C planes in their packed buffers straight into
the inbox layout) is held against numpy at C in {1, 2, 4, 5}, with
budgets and row pitches that break 16-byte alignment; on the CPU its
wrapper takes the plain version, which ``chip_smoke.py`` holds the CUDA
kernel against on the card.  Tolerance: bit-equality everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from consul_tpu.parallel import make_mesh
from consul_tpu.parallel.mesh import NODE_AXIS
from consul_tpu.parallel.shard import exchange_outbox as j_exchange_outbox
from consul_tpu.parallel.shard import outbox_budget as j_outbox_budget
from consul_tpu.parallel.shard import pack_outbox as j_pack_outbox
from consul_tpu_torch.ops import (
    ring_exchange,
    ring_exchange_plain,
    ring_exchange_planes,
    ring_exchange_planes_plain,
)
from consul_tpu_torch.parallel import (
    exchange_outbox,
    outbox_budget,
    outbox_pitch,
    pack_outbox,
)

N, A_LEN = 64, 120
CASES = [(2, 3), (4, 64)]  # tight budget that overflows; three ring hops


def _numpy_router(recv, val, ok, d_shards, blk, budget):
    """Brute force: per (src, dst) pair, remote-destined messages land in
    stream order until the budget; the rest drop.  Returns the inbox
    rows ``[dst][src] -> [(recv, val), ...]`` and the dropped count."""
    inbox = [[[] for _ in range(d_shards)] for _ in range(d_shards)]
    dropped = 0
    for src in range(d_shards):
        for i in range(recv.shape[1]):
            dst = int(recv[src, i]) // blk
            if not ok[src, i] or dst == src:
                continue
            if len(inbox[dst][src]) < budget:
                inbox[dst][src].append((int(recv[src, i]), int(val[src, i])))
            else:
                dropped += 1
    return inbox, dropped


def _data(seed, d_shards):
    rng = np.random.default_rng(seed)
    recv = rng.integers(0, N, (d_shards, A_LEN)).astype(np.int32)
    val = rng.integers(0, 1000, (d_shards, A_LEN)).astype(np.int32)
    ok = rng.random((d_shards, A_LEN)) < 0.7
    return recv, val, ok


def _port_route(recv, val, ok, d_shards, budget, backend):
    blk = N // d_shards
    r, v, o = (torch.from_numpy(x) for x in (recv, val, ok))
    dest = r.to(torch.int64) // blk
    me = torch.arange(d_shards)[:, None]
    packed, dropped = pack_outbox(dest, o & (dest != me), (r, v),
                                  d_shards, budget)
    ib_r, ib_v = exchange_outbox(packed, backend=backend)
    return ib_r.numpy(), ib_v.numpy(), int(dropped.sum())


_JAX_RUNS = {}


def _jax_route(d_shards, budget):
    """The JAX package's pack + all_to_all inside shard_map (one compile
    per case)."""
    if (d_shards, budget) in _JAX_RUNS:
        return _JAX_RUNS[d_shards, budget]
    from jax.experimental.shard_map import shard_map

    blk = N // d_shards

    def body(recv, val, ok):
        me = jax.lax.axis_index(NODE_AXIS)
        r, v, o = recv.reshape(-1), val.reshape(-1), ok.reshape(-1)
        dest = r // blk
        packed, dropped = j_pack_outbox(dest, o & (dest != me), (r, v),
                                        d_shards, budget)
        ib_r, ib_v = j_exchange_outbox(packed, backend="alltoall")
        return ib_r[None], ib_v[None], jax.lax.psum(dropped, NODE_AXIS)[None]

    run = jax.jit(shard_map(
        body, mesh=make_mesh(jax.devices()[:d_shards]),
        in_specs=(P(NODE_AXIS, None),) * 3,
        out_specs=(P(NODE_AXIS, None), P(NODE_AXIS, None), P(NODE_AXIS)),
        check_rep=False,
    ))
    _JAX_RUNS[d_shards, budget] = run
    return run


def _rows(ib_r, ib_v, d_shards, budget):
    """Inbox as ``[dst][src] -> [(recv, val), ...]`` in slot order."""
    return [[
        [(int(r), int(v)) for r, v in zip(
            ib_r[dst, src * budget:(src + 1) * budget],
            ib_v[dst, src * budget:(src + 1) * budget]) if r >= 0]
        for src in range(d_shards)] for dst in range(d_shards)]


@pytest.mark.parametrize("backend", ["alltoall", "ring"])
@pytest.mark.parametrize("d_shards,budget", CASES)
@pytest.mark.parametrize("seed", range(3))
def test_pack_exchange_matches_numpy(d_shards, budget, backend, seed):
    recv, val, ok = _data(seed, d_shards)
    ib_r, ib_v, dropped = _port_route(recv, val, ok, d_shards, budget,
                                      backend)
    want, want_dropped = _numpy_router(recv, val, ok, d_shards,
                                       N // d_shards, budget)
    assert dropped == want_dropped
    # The port sorts stably, so each row keeps stream order exactly.
    assert _rows(ib_r, ib_v, d_shards, budget) == want
    if budget == 3:
        assert dropped > 0, "tight budget must exercise the drop path"


@pytest.mark.parametrize("d_shards,budget", CASES)
@pytest.mark.parametrize("seed", range(3))
def test_ring_and_alltoall_match_jax_alltoall(d_shards, budget, seed):
    """ring plain == alltoall == the JAX all_to_all inbox, bit for bit.

    JAX packs with ``lax.sort(num_keys=1)``, whose order within one
    destination is not promised; XLA's CPU sort kept stream order in
    every case here, as the port's stable sort does, so the inboxes
    (slot order and, under the tight budget, the choice of dropped
    messages) are compared exactly."""
    recv, val, ok = _data(seed, d_shards)
    ring_r, ring_v, ring_drop = _port_route(recv, val, ok, d_shards, budget,
                                            "ring")
    a2a_r, a2a_v, a2a_drop = _port_route(recv, val, ok, d_shards, budget,
                                         "alltoall")
    np.testing.assert_array_equal(ring_r, a2a_r)
    np.testing.assert_array_equal(ring_v, a2a_v)
    assert ring_drop == a2a_drop

    j_r, j_v, j_drop = _jax_route(d_shards, budget)(
        jnp.asarray(recv), jnp.asarray(val), jnp.asarray(ok)
    )
    assert int(np.asarray(j_drop)[0]) == ring_drop
    np.testing.assert_array_equal(ring_r, np.asarray(j_r))
    np.testing.assert_array_equal(ring_v, np.asarray(j_v))


@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("c,budget", [(1, 7), (4, 64), (5, 9)])
def test_ring_plain_is_the_all_to_all_layout(d, c, budget):
    rng = np.random.default_rng(d * 100 + c)
    box = torch.from_numpy(
        rng.integers(-2 ** 31, 2 ** 31 - 1, (d, d, c, budget)).astype(np.int32)
    )
    want = box.transpose(0, 1).contiguous()
    assert torch.equal(ring_exchange_plain(box), want)
    # On a CPU tensor the wrapper takes the plain version and launches
    # nothing.
    before = ring_exchange.launches
    assert torch.equal(ring_exchange(box), want)
    assert ring_exchange.launches == before


def test_ring_exchange_checks_its_input():
    box = torch.zeros((2, 2, 1, 4), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        ring_exchange(box.to(torch.int64))
    with pytest.raises(ValueError, match="box"):
        ring_exchange(torch.zeros((2, 3, 1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        ring_exchange(box.expand(2, 2, 2, 4).transpose(0, 1))
    # A device that is neither the CPU nor CUDA never gets the plain
    # version.
    with pytest.raises(ValueError, match="cpu or cuda"):
        ring_exchange(box.to("meta"))


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="exchange backend"):
        exchange_outbox((torch.zeros((2, 2, 4), dtype=torch.int32),),
                        backend="carrier-pigeon")


@pytest.mark.parametrize("stream,shards", [
    (1000, 1), (8000, 8), (100, 8), (16, 8), (500_000, 8), (96, 4), (7, 3),
])
def test_budget_formula_matches_jax(stream, shards):
    assert outbox_budget(stream, shards) == j_outbox_budget(stream, shards)


def _packed_planes(d, c, budget, pitch, seed):
    """C planes ``[D, D, budget]`` as views of ``[D, pitch]`` buffers (the
    layout ``pack_outbox`` leaves), with numpy copies of their values."""
    rng = np.random.default_rng(seed)
    bufs = rng.integers(-2 ** 31, 2 ** 31 - 1, (c, d, pitch)).astype(np.int32)
    planes = tuple(torch.from_numpy(b)[:, :d * budget].unflatten(
        -1, (d, budget)) for b in bufs)
    return planes, [b[:, :d * budget].reshape(d, d, budget) for b in bufs]


# 62 keeps the alignment class of the 100k sparse budget (40062 = 2 mod 4).
PLANE_BUDGETS = (7, 62, 64)


@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("c", [1, 2, 4, 5])
@pytest.mark.parametrize("budget", PLANE_BUDGETS)
def test_ring_planes_is_the_all_to_all_layout(d, c, budget):
    """Each packed plane becomes ``[D_dst, D_src*budget]`` with row dst
    holding what every source addressed to dst, at outbox_pitch and at
    an odd pitch; the CPU wrapper launches nothing."""
    for pitch in (outbox_pitch(d, budget), d * budget + 1):
        planes, want = _packed_planes(d, c, budget, pitch, d * 31 + c)
        before = ring_exchange.launches
        for got in (ring_exchange_planes_plain(planes),
                    ring_exchange_planes(planes)):
            assert len(got) == c
            for g, w in zip(got, want):
                assert g.dtype == torch.int32 and g.is_contiguous()
                np.testing.assert_array_equal(
                    g.numpy(), w.transpose(1, 0, 2).reshape(d, d * budget))
        assert ring_exchange.launches == before


@pytest.mark.parametrize("c", [1, 2, 4, 5])
def test_ring_box_is_the_planes_exchange(c):
    """The box entry point and the planes entry point give one layout."""
    d, budget = 8, 62
    planes, _ = _packed_planes(d, c, budget, outbox_pitch(d, budget), c)
    box = torch.stack(planes, dim=2).contiguous()
    inbox = ring_exchange(box)
    for i, got in enumerate(ring_exchange_planes(planes)):
        assert torch.equal(inbox[:, :, i].reshape(d, d * budget), got)


def test_ring_planes_checks_its_input():
    planes, _ = _packed_planes(2, 2, 8, outbox_pitch(2, 8), 0)
    with pytest.raises(TypeError, match="int32"):
        ring_exchange_planes((planes[0].to(torch.int64),))
    with pytest.raises(ValueError, match="shape"):
        ring_exchange_planes((planes[0], planes[1][:, :, :4]))
    with pytest.raises(ValueError, match="stride"):
        ring_exchange_planes((planes[0], planes[1].contiguous()))
    with pytest.raises(ValueError, match="unit stride"):
        ring_exchange_planes((planes[0].transpose(1, 2),))
    with pytest.raises(ValueError, match="1 to 8 planes"):
        ring_exchange_planes(planes * 5)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ring_exchange_planes(tuple(p.to("meta") for p in planes))


@pytest.mark.parametrize("d_shards,budget", [(2, 3), (4, 7), (8, 62)])
def test_pack_outbox_pitch_keeps_the_packed_values(d_shards, budget):
    """The packed rows start 16-byte aligned (pitch a multiple of 4, the
    drop slot and padding after the slots), and the planes hold what the
    JAX package's ``pack_outbox`` packs, shard by shard."""
    rng = np.random.default_rng(d_shards)
    a_len = 90
    recv = rng.integers(0, 64, (d_shards, a_len)).astype(np.int32)
    val = rng.integers(-50, 50, (d_shards, a_len)).astype(np.int32)
    ok = rng.random((d_shards, a_len)) < 0.8
    dest = torch.from_numpy(recv).long() // (64 // d_shards)
    cols = (torch.from_numpy(recv), torch.from_numpy(val))
    packed, dropped = pack_outbox(dest, torch.from_numpy(ok), cols,
                                  d_shards, budget)
    pitch = outbox_pitch(d_shards, budget)
    assert pitch % 4 == 0 and pitch > d_shards * budget
    for c, plane in enumerate(packed):
        assert plane.shape == (d_shards, d_shards, budget)
        assert plane.stride() == (pitch, budget, 1)
        assert plane.storage_offset() == c * d_shards * pitch
    jpack = jax.jit(j_pack_outbox, static_argnums=(3, 4))
    for src in range(d_shards):
        (j_r, j_v), j_drop = jpack(
            jnp.asarray(dest[src].int().numpy()), jnp.asarray(ok[src]),
            (jnp.asarray(recv[src]), jnp.asarray(val[src])), d_shards,
            budget)
        np.testing.assert_array_equal(packed[0][src].numpy(), np.asarray(j_r))
        np.testing.assert_array_equal(packed[1][src].numpy(), np.asarray(j_v))
        assert int(dropped[src]) == int(j_drop)
    if budget == 3:
        assert int(dropped.sum()) > 0


def test_exchange_outbox_ring_equals_alltoall_at_five_planes():
    """The sparse twin's five columns through both transports."""
    d, budget = 4, 62
    planes, _ = _packed_planes(d, 5, budget, outbox_pitch(d, budget), 9)
    for a, b in zip(exchange_outbox(planes, backend="ring"),
                    exchange_outbox(planes, backend="alltoall")):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The universe axis: a sweep's [U, D, D, budget] planes in one exchange.
# ---------------------------------------------------------------------------


def _packed_universe_planes(u, d, c, budget, pitch, seed):
    """C planes ``[U, D, D, budget]`` as views of the one ``(C, U, D,
    pitch)`` buffer ``pack_outbox`` leaves for leading dims ``[U, D]``,
    with numpy copies of their values."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(-2 ** 31, 2 ** 31 - 1, (c, u, d, pitch)).astype(np.int32)
    planes = tuple(torch.from_numpy(buf)[i, ..., :d * budget].unflatten(
        -1, (d, budget)) for i in range(c))
    return planes, [buf[i, ..., :d * budget].reshape(u, d, d, budget)
                    for i in range(c)]


_JAX_UNIVERSE_RUNS = {}


def _jax_universe_alltoall(u, d, c):
    """The JAX package's all_to_all exchange of C planes inside shard_map,
    vmapped over U universes as its composed sweep runs it."""
    if (u, d, c) in _JAX_UNIVERSE_RUNS:
        return _JAX_UNIVERSE_RUNS[u, d, c]
    from jax.experimental.shard_map import shard_map

    def body(*planes):
        return tuple(p[None] for p in j_exchange_outbox(
            tuple(p[0] for p in planes), backend="alltoall"))

    shards = shard_map(
        body, mesh=make_mesh(jax.devices()[:d]),
        in_specs=(P(NODE_AXIS),) * c, out_specs=(P(NODE_AXIS),) * c,
        check_rep=False)
    run = jax.jit(jax.vmap(shards))
    _JAX_UNIVERSE_RUNS[u, d, c] = run
    return run


@pytest.mark.parametrize("u", [1, 3])
@pytest.mark.parametrize("c", [1, 5])
def test_ring_planes_universe_axis_is_the_all_to_all_layout(u, c):
    """``[U, D, D, budget]`` planes, read where ``pack_outbox`` leaves them
    (universe stride ``D*pitch``) at outbox_pitch and at an odd pitch,
    become ``[U, D_dst, D_src*budget]`` inboxes equal to the JAX
    package's all_to_all under vmap, universe by universe; the CPU
    wrapper launches nothing."""
    d, budget = 4, 62
    run = _jax_universe_alltoall(u, d, c)
    for pitch in (outbox_pitch(d, budget), d * budget + 1):
        planes, want = _packed_universe_planes(u, d, c, budget, pitch,
                                               u * 7 + c)
        assert planes[0].stride() == (d * pitch, pitch, budget, 1)
        ref = run(*(jnp.asarray(w) for w in want))
        before = ring_exchange.launches
        for got in (ring_exchange_planes_plain(planes),
                    ring_exchange_planes(planes),
                    exchange_outbox(planes, backend="ring"),
                    exchange_outbox(planes, backend="alltoall")):
            assert len(got) == c
            for g, r in zip(got, ref):
                assert g.dtype == torch.int32 and g.shape == (u, d, d * budget)
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert ring_exchange.launches == before


@pytest.mark.parametrize("c", [1, 5])
def test_ring_planes_u1_equals_the_plain_call(c):
    """A universe axis of 1 gives the 3-D call's inboxes."""
    d, budget = 8, 62
    planes, _ = _packed_universe_planes(1, d, c, budget,
                                        outbox_pitch(d, budget), c)
    for a, b in zip(ring_exchange_planes(planes),
                    ring_exchange_planes(tuple(p[0] for p in planes))):
        assert torch.equal(a[0], b)


def test_ring_planes_universe_axis_checks_its_input():
    """Planes of one exchange share their universe stride (and every other
    stride); a 5-D plane is no plane."""
    planes, _ = _packed_universe_planes(2, 2, 2, 8, outbox_pitch(2, 8), 0)
    with pytest.raises(ValueError, match="stride"):
        ring_exchange_planes((planes[0], planes[1].contiguous()))
    other = torch.zeros((2, 3, 2, 2, 8), dtype=torch.int32)[:, 0]
    assert other.shape == planes[0].shape
    with pytest.raises(ValueError, match="stride"):
        ring_exchange_planes((planes[0], other))
    with pytest.raises(ValueError, match=r"\[U, D, D, budget\]"):
        ring_exchange_planes((planes[0][None],))
