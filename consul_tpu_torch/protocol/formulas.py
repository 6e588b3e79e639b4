"""Protocol scaling formulas the ported families need (host-side scalars)."""

from __future__ import annotations

import math


def retransmit_limit(retransmit_mult: int, n: int) -> int:
    """Number of times a broadcast is retransmitted: mult * ceil(log10(n+1)).

    memberlist/util.go:72-76.
    """
    return retransmit_mult * int(math.ceil(math.log10(float(n + 1))))
