"""Config fields that a universe sweep turns into per-universe tensors.

A sweep (``consul_tpu_torch.sweep``) rebuilds a config with each swept
knob set to a ``[U]`` tensor, one value per universe, where a plain run
has a Python number.  The reference computes a traced knob's consumers
in float32 at run time, in another order than the constant folding of a
Python number, so a consumer takes one of two paths: :func:`is_knob`
tells them apart, and :func:`lift` shapes a ``[U]`` knob to broadcast
against a ``[U, ...]`` plane.
"""

from __future__ import annotations

import torch


def is_knob(x) -> bool:
    """True for a swept (per-universe tensor) config value."""
    return isinstance(x, torch.Tensor)


def lift(x: torch.Tensor, trailing: int) -> torch.Tensor:
    """A ``[*B]`` tensor as ``[*B, 1, ...]`` with ``trailing`` unit axes."""
    return x.reshape(*x.shape, *([1] * trailing))


def col(x: torch.Tensor) -> torch.Tensor:
    """A per-universe value (``[*B]``, or a 0-dim one) as a column against
    ``[*B, n]`` node planes."""
    return x[..., None]


def keep_prob(loss, trailing: int):
    """``1 - loss`` as a delivery probability against ``[*B, ...]`` draws
    with ``trailing`` axes after the universe's: a Python float, or a
    swept ``[U]`` loss in float32 arithmetic."""
    keep = 1.0 - loss
    return lift(keep, trailing) if is_knob(keep) else keep

