"""Host-plane Vivaldi client: one node's network coordinate; the port's
copy of ``consul_tpu/net/vivaldi.py``.

Host float64 arithmetic, separate from the device model in
``consul_tpu_torch/models/vivaldi.py`` (the same tuning): each agent
keeps its own coordinate and folds in one (peer_coordinate, rtt)
observation per completed SWIM probe, exactly serf's ping-delegate path
(serf/ping_delegate.go:46-90 → coordinate/client.go:121-196 Update).

Used on the WAN gossip pool to order datacenters by round-trip distance
(agent/router/router.go:534 GetDatacentersByDistance) and on the LAN
pool for the coordinate catalog (agent/consul/coordinate_endpoint.go).
"""

from __future__ import annotations

import dataclasses
import math

# coordinate/config.go:62-71 DefaultConfig.
DIMENSIONALITY = 8
VIVALDI_ERROR_MAX = 1.5
VIVALDI_CE = 0.25
VIVALDI_CC = 0.25
ADJUSTMENT_WINDOW = 20
HEIGHT_MIN = 10.0e-6
GRAVITY_RHO = 150.0
LATENCY_FILTER_SIZE = 3
ZERO_THRESHOLD = 1.0e-6


@dataclasses.dataclass
class Coordinate:
    """coordinate/coordinate.go Coordinate (seconds-denominated)."""

    vec: list[float] = dataclasses.field(
        default_factory=lambda: [0.0] * DIMENSIONALITY
    )
    error: float = VIVALDI_ERROR_MAX
    adjustment: float = 0.0
    height: float = HEIGHT_MIN

    def to_wire(self) -> dict:
        return {
            "vec": list(self.vec),
            "error": self.error,
            "adjustment": self.adjustment,
            "height": self.height,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "Coordinate":
        return cls(
            vec=list(d.get("vec", [0.0] * DIMENSIONALITY)),
            error=float(d.get("error", VIVALDI_ERROR_MAX)),
            adjustment=float(d.get("adjustment", 0.0)),
            height=float(d.get("height", HEIGHT_MIN)),
        )

    def is_valid(self) -> bool:
        """client.go checkCoordinate / coordinate.go IsValid +
        IsCompatibleWith: right dimensionality, all components finite.
        Invalid peer coordinates are rejected before they can corrupt
        ours (a truncated vector or NaN would otherwise propagate
        through every subsequent ack we send)."""
        if len(self.vec) != DIMENSIONALITY:
            return False
        try:
            return all(
                math.isfinite(v)
                for v in (*self.vec, self.error, self.adjustment, self.height)
            )
        except TypeError:
            return False

    def raw_distance_to(self, other: "Coordinate") -> float:
        """coordinate.go:141-145: Euclidean part + heights, seconds."""
        s = sum((a - b) ** 2 for a, b in zip(self.vec, other.vec))
        return math.sqrt(s) + self.height + other.height

    def distance_to(self, other: "Coordinate") -> float:
        """coordinate.go:121-133 DistanceTo incl. adjustments."""
        dist = self.raw_distance_to(other)
        adjusted = dist + self.adjustment + other.adjustment
        return adjusted if adjusted > 0.0 else dist


class VivaldiClient:
    """coordinate/client.go Client: Update / latency filter / gravity."""

    def __init__(self) -> None:
        self.coord = Coordinate()
        self.origin = Coordinate()
        self._adj_samples = [0.0] * ADJUSTMENT_WINDOW
        self._adj_index = 0
        self._latency_filters: dict[str, list[float]] = {}

    def get_coordinate(self) -> Coordinate:
        return self.coord

    def _latency_filter(self, node: str, rtt: float) -> float:
        """client.go:120-140: per-peer moving median of the raw RTTs."""
        samples = self._latency_filters.setdefault(node, [])
        samples.append(rtt)
        if len(samples) > LATENCY_FILTER_SIZE:
            samples.pop(0)
        return sorted(samples)[len(samples) // 2]

    def update(self, node: str, other: Coordinate, rtt_s: float) -> Coordinate:
        """client.go:94-117 Update: filter, Vivaldi step, adjustment,
        gravity.  ``rtt_s`` in seconds; returns the new coordinate."""
        if rtt_s <= 0 or not other.is_valid():
            return self.coord
        rtt = self._latency_filter(node, rtt_s)
        self._update_vivaldi(other, rtt)
        self._update_adjustment(other, rtt)
        self._update_gravity()
        return self.coord

    def _update_vivaldi(self, other: Coordinate, rtt: float) -> None:
        """client.go:144-167: error-weighted EWMA confidence + force."""
        c = self.coord
        rtt = max(rtt, ZERO_THRESHOLD)
        dist = c.raw_distance_to(other)
        wrongness = abs(dist - rtt) / rtt

        total_error = max(c.error + other.error, ZERO_THRESHOLD)
        weight = c.error / total_error
        c.error = min(
            c.error * (1 - VIVALDI_CE * weight)
            + wrongness * VIVALDI_CE * weight,
            VIVALDI_ERROR_MAX,
        )
        force = VIVALDI_CC * weight * (rtt - dist)
        self._apply_force(other, force)

    def _apply_force(self, other: Coordinate, force: float) -> None:
        """coordinate.go:104-118 ApplyForce: push along the unit vector
        away from ``other`` (random direction if colocated), heights
        coupled."""
        c = self.coord
        unit, mag = _unit_vector_at(c.vec, other.vec)
        c.vec = [a + u * force for a, u in zip(c.vec, unit)]
        if mag > ZERO_THRESHOLD:
            c.height = max(
                (c.height + other.height) * force / mag + c.height,
                HEIGHT_MIN,
            )

    def _update_adjustment(self, other: Coordinate, rtt: float) -> None:
        """client.go:170-187: windowed mean of (rtt - raw distance) / 2."""
        c = self.coord
        self._adj_samples[self._adj_index] = rtt - c.raw_distance_to(other)
        self._adj_index = (self._adj_index + 1) % ADJUSTMENT_WINDOW
        c.adjustment = sum(self._adj_samples) / (2.0 * ADJUSTMENT_WINDOW)

    def _update_gravity(self) -> None:
        """client.go:190-196: quadratic pull toward the origin keeps the
        constellation centered."""
        c = self.coord
        dist = c.raw_distance_to(self.origin)
        force = -1.0 * (dist / GRAVITY_RHO) ** 2
        unit, _ = _unit_vector_at(c.vec, self.origin.vec)
        c.vec = [a + u * force for a, u in zip(c.vec, unit)]


_dir_state = 0x9E3779B9


def _unit_vector_at(a: list, b: list) -> tuple[list, float]:
    """coordinate.go:148-179 unitVectorAt: (a-b)/||a-b||, or a
    deterministic pseudo-random unit vector for coincident points."""
    global _dir_state
    diff = [x - y for x, y in zip(a, b)]
    mag = math.sqrt(sum(d * d for d in diff))
    if mag > ZERO_THRESHOLD:
        return [d / mag for d in diff], mag
    out = []
    for _ in diff:
        _dir_state = (_dir_state * 1103515245 + 12345) & 0x7FFFFFFF
        out.append((_dir_state / 0x7FFFFFFF) - 0.5)
    m = math.sqrt(sum(d * d for d in out)) or 1.0
    return [d / m for d in out], 0.0
