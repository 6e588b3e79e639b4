"""Protocol scaling formulas the ported families need (host-side scalars).

The slice's copy of ``consul_tpu/protocol/formulas.py``.  Sources in the
memberlist reference:
  - suspicion_timeout:           util.go:64-69
  - retransmit_limit:            util.go:72-76
  - remaining_suspicion_timeout: suspicion.go:86-97
  - awareness_scaled_timeout:    awareness.go:60-69
  - awareness_probe_delta:       state.go:283-497 probeNode
  - push_pull_scale:             util.go:89-97
"""

from __future__ import annotations

import math

# util.go:89-97 pushPullScaleThreshold: no push/pull scaling up to 32 nodes.
PUSH_PULL_SCALE_THRESHOLD = 32


def suspicion_timeout(suspicion_mult: int, n: int, interval_ms: float) -> float:
    """Base suspicion timeout before confirmations, in ms:
    ``mult * max(1, log10(max(1, n))) * interval`` with the node scale
    kept to 1/1000 (util.go:64-69 truncates ``nodeScale*1000`` into an
    integer Duration)."""
    node_scale = max(1.0, math.log10(max(1.0, float(n))))
    return suspicion_mult * math.floor(node_scale * 1000.0) * interval_ms / 1000.0


def suspicion_timeout_bounds(
    suspicion_mult: int, max_timeout_mult: int, n: int, interval_ms: float
) -> tuple[float, float]:
    """(min, max) suspicion timeout in ms (state.go:1187-1217): max is
    ``SuspicionMaxTimeoutMult * min``."""
    lo = suspicion_timeout(suspicion_mult, n, interval_ms)
    return lo, max_timeout_mult * lo


def remaining_suspicion_timeout(
    confirmations: int, k: int, min_ms: float, max_ms: float
) -> float:
    """Total suspicion timeout in ms after ``confirmations`` independent
    confirmations (suspicion.go:86-97, Lifeguard): driven from max toward
    min on a log scale, ``max - log(c+1)/log(k+1) * (max-min)``, floored
    to ms and clamped to >= min."""
    if k < 1:
        return min_ms
    frac = math.log(confirmations + 1.0) / math.log(k + 1.0)
    raw = max_ms - frac * (max_ms - min_ms)
    return max(math.floor(raw), min_ms)


def awareness_scaled_timeout(timeout, score):
    """Lifeguard timeout scaling (awareness.go:60-69 ScaleTimeout): a
    node with health ``score`` waits ``score + 1`` times longer.  Pure
    arithmetic, so it serves Python numbers and tensors alike."""
    return timeout * (score + 1)


def awareness_clamp(score: int, max_multiplier: int) -> int:
    """awareness.go:30-42 ApplyDelta clamp: score in [0, max_multiplier - 1]."""
    return min(max(score, 0), max_multiplier - 1)


def awareness_probe_delta(
    success: bool, expected_nacks: int = 0, nacks: int = 0
) -> int:
    """Health-score delta of one probe cycle (state.go probeNode): an
    acked probe -1; a failed one with relays +missing nacks; a failed
    one without relays +1."""
    if success:
        return -1
    if expected_nacks > 0:
        return max(expected_nacks - nacks, 0)
    return 1


def retransmit_limit(retransmit_mult: int, n: int) -> int:
    """Number of times a broadcast is retransmitted: mult * ceil(log10(n+1)).

    memberlist/util.go:72-76.
    """
    return retransmit_mult * int(math.ceil(math.log10(float(n + 1))))


def push_pull_scale(interval_ms: float, n: int) -> float:
    """Scaled push/pull (full state sync) interval in ms.

    memberlist/util.go:89-97: no scaling until n > 32, then
    ``ceil(log2(n) - log2(32)) + 1`` multiplier (doubles every doubling).
    """
    if n <= PUSH_PULL_SCALE_THRESHOLD:
        return interval_ms
    multiplier = math.ceil(
        math.log2(float(n)) - math.log2(float(PUSH_PULL_SCALE_THRESHOLD))
    ) + 1.0
    return multiplier * interval_ms
