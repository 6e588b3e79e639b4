"""Fault-injection schedules: the environment of a Lifeguard study.

The port of ``consul_tpu/sim/faults.py``.  A :class:`FaultSchedule` is a
static, hashable description of the environment; every query is a
function of ``(schedule, tick[, key])`` on tensors, so a round reads it
without leaving the device.

  LossRamp      piecewise-constant extra packet loss over time
  Partition     cross-segment edges drop with ``severity`` in [start, heal)
  DegradedSet   a pseudo-random subset whose sends drop and whose probes
                see late acks
  ChurnWindow   nodes independently offline with a per-tick probability
  BandwidthSchedule
                per-directed-link WAN capacity of the geo plane
                (:func:`link_capacity_at`); a Lifeguard config rejects it

Independent drop processes combine as ``1 - prod(1 - p_i)`` in the
reference's float32 operation order.

A universe sweep may set a severity (``LossRamp.scale``,
``DegradedSet.drop/late/frac``, ``Partition.severity``,
``ChurnWindow.p_offline``, ``BandwidthSchedule.scale``) to a ``[U]``
tensor; the evaluators then return one value (or plane) per universe,
``[U, ...]``, with ``tick`` ``[U]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from consul_tpu_torch.ops import PRNGKey, owned_uniform, uniform
from consul_tpu_torch.ops.knobs import is_knob, lift


def _static_zero(x) -> bool:
    """Known before the run to contribute nothing, so the evaluators skip
    it: a Python number <= 0.  A swept value is never skipped, even at
    0.0: the reference skips only its constants, and its traced zero
    takes the arithmetic path."""
    return not is_knob(x) and x <= 0.0


def _per_node(x):
    """A per-universe value ``[*B]`` as a column against ``[*B, n]``; a
    Python number as it is."""
    return lift(x, 1) if is_knob(x) else x


@dataclasses.dataclass(frozen=True)
class LossRamp:
    """Piecewise-constant extra loss: ``pieces`` is a sorted tuple of
    (start_tick, loss); 0 before the first piece, each piece holds until
    the next starts.  ``scale`` multiplies every piece (clipped to [0, 1])."""

    pieces: tuple[tuple[int, float], ...]
    scale: float = 1.0

    def __post_init__(self):
        starts = [s for s, _ in self.pieces]
        if starts != sorted(starts):
            raise ValueError(f"LossRamp pieces must be sorted, got {starts}")
        for _, p in self.pieces:
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"loss {p} outside [0, 1]")
        if not is_knob(self.scale) and self.scale < 0.0:
            raise ValueError(f"scale {self.scale} must be >= 0")


@dataclasses.dataclass(frozen=True)
class Partition:
    """Cross-segment edges drop with ``severity`` in [start, heal).
    Node i belongs to segment ``i * segments // n``."""

    start: int
    heal: int
    segments: int = 2
    severity: float = 1.0


@dataclasses.dataclass(frozen=True)
class DegradedSet:
    """A pseudo-random ``frac`` of nodes whose sends drop with ``drop``
    and whose probes see the ack late with ``late``.  Membership is a
    function of (seed, n) alone."""

    frac: float
    drop: float = 0.5
    late: float = 0.0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ChurnWindow:
    """During [start, end) each node is independently offline with
    probability ``p_offline`` per tick (back in the next draw)."""

    start: int
    end: int
    p_offline: float


@dataclasses.dataclass(frozen=True)
class BandwidthSchedule:
    """Piecewise per-link WAN capacity (bytes/tick) for the geo plane:
    ``pieces`` sorted (start_tick, capacity), ``src``/``dst`` select one
    directed segment link (-1 = every link), ``scale`` multiplies every
    piece."""

    pieces: tuple[tuple[int, float], ...]
    src: int = -1
    dst: int = -1
    scale: float = 1.0

    def __post_init__(self):
        starts = [s for s, _ in self.pieces]
        if starts != sorted(starts):
            raise ValueError(
                f"BandwidthSchedule pieces must be sorted, got {starts}"
            )
        for _, cap in self.pieces:
            if cap < 0:
                raise ValueError(f"capacity {cap} must be >= 0 bytes/tick")
        if not is_knob(self.scale) and self.scale < 0.0:
            raise ValueError(f"scale {self.scale} must be >= 0")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    ramps: tuple[LossRamp, ...] = ()
    partitions: tuple[Partition, ...] = ()
    degraded: tuple[DegradedSet, ...] = ()
    churn: tuple[ChurnWindow, ...] = ()
    bandwidth: tuple[BandwidthSchedule, ...] = ()

    def compose(self, other: "FaultSchedule") -> "FaultSchedule":
        """Union of fault processes."""
        return FaultSchedule(
            ramps=self.ramps + other.ramps,
            partitions=self.partitions + other.partitions,
            degraded=self.degraded + other.degraded,
            churn=self.churn + other.churn,
            bandwidth=self.bandwidth + other.bandwidth,
        )

    @property
    def has_faults(self) -> bool:
        return bool(self.ramps or self.partitions or self.degraded
                    or self.churn or self.bandwidth)


# ---------------------------------------------------------------------------
# Evaluators.  ``tick`` is an int32 0-dim tensor on the study's device.
# ---------------------------------------------------------------------------


def _ramp_losses(ramp: LossRamp, device):
    """Each piece's loss as the reference's float32
    ``clip(loss * scale, 0, 1)``: Python floats for a constant scale, a
    ``[*B, P]`` tensor for a swept one."""
    pieces = np.asarray([p for _, p in ramp.pieces], np.float32)
    if is_knob(ramp.scale):
        base = torch.from_numpy(pieces).to(device)
        return torch.clamp(base * ramp.scale[..., None], 0.0, 1.0).unbind(-1)
    scaled = np.clip(pieces * np.float32(ramp.scale), 0.0, 1.0)
    return [float(x) for x in scaled.astype(np.float32)]


def extra_loss_at(sched: FaultSchedule, tick: torch.Tensor) -> torch.Tensor:
    """float32 ``[*B]``: extra loss from all ramps at ``tick``, combined
    as independent drop processes.  The piece in force is the last one
    whose start is <= tick (the reference's right-sided searchsorted)."""
    keep = torch.ones((), dtype=torch.float32, device=tick.device)
    for ramp in sched.ramps:
        loss = torch.zeros((), dtype=torch.float32, device=tick.device)
        for (start, _), value in zip(ramp.pieces,
                                     _ramp_losses(ramp, tick.device)):
            loss = torch.where(tick >= start, value, loss)
        keep = keep * (1.0 - loss)
    return 1.0 - keep


def combine_loss(a, b):
    """Combined drop probability of two independent loss processes."""
    return 1.0 - (1.0 - a) * (1.0 - b)


def _members(d: DegradedSet, n: int, device) -> torch.Tensor:
    """bool[n]: the set's membership, the one definition every degraded
    evaluator shares: ``jax.random.bernoulli(PRNGKey(seed), frac, (n,))``,
    i.e. a float32 uniform below float32 ``frac``."""
    u = uniform(PRNGKey(d.seed, device=device), (n,))
    if is_knob(d.frac):
        return u < lift(d.frac, 1)
    return u < torch.full((), d.frac, dtype=torch.float32, device=device)


def degraded_send_ok(sched: FaultSchedule, n: int, device) -> torch.Tensor:
    """float32[n]: per-node send survival multiplier (1.0 = healthy)."""
    ok = torch.ones(n, dtype=torch.float32, device=device)
    for d in sched.degraded:
        if _static_zero(d.frac):
            continue
        ok = ok * torch.where(_members(d, n, device),
                              _per_node(1.0 - d.drop), 1.0)
    return ok


def degraded_mask(sched: FaultSchedule, n: int, device) -> torch.Tensor:
    """bool[n]: nodes degraded by ANY set (for reporting)."""
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    for d in sched.degraded:
        if _static_zero(d.frac):
            continue
        mask = mask | _members(d, n, device)
    return mask


def degraded_late(sched: FaultSchedule, n: int, device) -> torch.Tensor:
    """float32[n]: per-node probability that a probe the node performs
    sees its ack arrive late."""
    keep = torch.ones(n, dtype=torch.float32, device=device)
    for d in sched.degraded:
        if _static_zero(d.frac) or _static_zero(d.late):
            continue
        keep = keep * torch.where(_members(d, n, device),
                                  _per_node(1.0 - d.late), 1.0)
    return 1.0 - keep


def segment_ids(partition: Partition, n: int, device) -> torch.Tensor:
    """int32[n]: which side of the split each node is on."""
    ids = torch.arange(n, dtype=torch.int32, device=device)
    return ids * partition.segments // n


def segment_bounds(partition: Partition, n: int) -> list[int]:
    """The first node of each segment, and n: segment s is the contiguous
    block ``[bounds[s], bounds[s+1])`` of :func:`segment_ids`."""
    segs = partition.segments
    return [-(-seg * n // segs) for seg in range(segs)] + [n]


def partition_severity_at(partition: Partition,
                          tick: torch.Tensor) -> torch.Tensor:
    """float32 ``[*B]``: the partition's severity at ``tick`` (0 outside
    its window)."""
    active = (tick >= partition.start) & (tick < partition.heal)
    sev = partition.severity
    if not is_knob(sev):
        sev = torch.full((), sev, dtype=torch.float32, device=tick.device)
    return torch.where(active, sev, 0.0)


def edge_block_prob(sched: FaultSchedule, tick: torch.Tensor,
                    src: torch.Tensor, dst: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Per-edge drop probability from all partitions for (src, dst)
    index tensors, which broadcast against each other; in a sweep
    (``tick`` ``[*B]``) their broadcast shape starts with ``B``."""
    shape = torch.broadcast_shapes(src.shape, dst.shape)
    keep = torch.ones(shape, dtype=torch.float32, device=tick.device)
    for part in sched.partitions:
        seg = segment_ids(part, n, tick.device)
        cross = seg[src.long()] != seg[dst.long()]
        sev = partition_severity_at(part, tick)
        sev = lift(sev, cross.dim() - sev.dim())
        keep = keep * torch.where(cross, 1.0 - sev, 1.0)
    return 1.0 - keep


def offline_prob_at(sched: FaultSchedule, tick: torch.Tensor) -> torch.Tensor:
    """float32 ``[*B]``: per-node offline probability at ``tick``."""
    keep = torch.ones((), dtype=torch.float32, device=tick.device)
    for w in sched.churn:
        active = (tick >= w.start) & (tick < w.end)
        keep = keep * torch.where(active, 1.0 - w.p_offline, 1.0)
    return 1.0 - keep


def online_mask(sched: FaultSchedule, key: torch.Tensor, tick: torch.Tensor,
                n: int) -> torch.Tensor:
    """bool[n]: nodes participating this tick.  The churn coin rides the
    owned per-(round, node) streams: node i's depends on ``(key, i)``."""
    if not sched.churn:
        return torch.ones((*tick.shape, n), dtype=torch.bool,
                          device=tick.device)
    ids = torch.arange(n, dtype=torch.int32, device=tick.device)
    return owned_uniform(key, ids) >= offline_prob_at(sched, tick)[..., None]


def _link_mask(bs: BandwidthSchedule, segments: int,
               device) -> torch.Tensor:
    """bool[S, S] on ``device``: the directed links a schedule constrains
    (``src``/``dst`` select one segment each, -1 every segment)."""
    seg = torch.arange(segments, device=device)
    mask = torch.ones((segments, segments), dtype=torch.bool, device=device)
    for sel, name in ((bs.src, "src"), (bs.dst, "dst")):
        if sel < 0:
            continue
        if sel >= segments:
            raise ValueError(
                f"BandwidthSchedule {name}={sel} outside [0, {segments})"
            )
        pick = seg == sel
        mask = mask & (pick[:, None] if name == "src" else pick[None, :])
    return mask


def link_capacity_at(sched: FaultSchedule, tick: torch.Tensor, segments: int,
                     base: float) -> torch.Tensor:
    """float32[*B, S, S]: per-directed-link capacity in bytes/tick at
    ``tick``.  ``base`` is the static per-link ceiling; schedules only
    tighten it.  The piece in force is the last whose start is <= tick
    (the reference's right-sided searchsorted; before the first piece the
    base applies), scaled in float32 by ``scale`` (a swept ``[*B]``
    scale scales each universe's pieces on the device); schedules
    combine by per-link minimum and the result is clipped to [0, base]."""
    dev = tick.device
    base_t = torch.full((), base, dtype=torch.float32, device=dev)
    cap = torch.full((*tick.shape, segments, segments), base,
                     dtype=torch.float32, device=dev)
    for bs in sched.bandwidth:
        pieces = np.asarray([c for _, c in bs.pieces], np.float32)
        if is_knob(bs.scale):
            vals = (torch.from_numpy(pieces).to(dev)
                    * bs.scale[..., None]).unbind(-1)
        else:
            vals = (pieces * np.float32(bs.scale)).tolist()
        val = base_t
        for (start, _), value in zip(bs.pieces, vals):
            val = torch.where(tick >= start, value, val)
        mask = _link_mask(bs, segments, dev)
        cap = torch.where(mask, torch.minimum(cap, val[..., None, None]), cap)
    return torch.clamp(cap, min=0.0, max=float(np.float32(base)))
