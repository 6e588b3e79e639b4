"""Carry state and keys between the JAX package and the port, as numpy.

The parity tests start both packages from the same state: the JAX
state's leaves go through ``np.asarray`` and :func:`state_from_numpy`,
and a ``uint32[2]`` jax key through :func:`key_from_numpy`.  Nothing here
imports JAX; the arrays are plain numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from consul_tpu_torch.models.broadcast import BroadcastState


def key_from_numpy(key, device="cpu") -> torch.Tensor:
    """A ``uint32[..., 2]`` key as the port's int64 ``[..., 2]`` key."""
    k = np.asarray(key)
    if k.dtype != np.uint32 or k.shape[-1:] != (2,):
        raise ValueError(f"expected uint32[..., 2], got {k.dtype}{k.shape}")
    return torch.from_numpy(k.astype(np.int64)).to(device)


def state_from_numpy(state, device="cpu") -> BroadcastState:
    """A ``BroadcastState`` of numpy arrays (the JAX state through
    ``np.asarray``) as the port's state on ``device``, dtype for dtype."""
    return BroadcastState(*(
        torch.from_numpy(np.array(getattr(state, name), copy=True)).to(device)
        for name in BroadcastState._fields
    ))


def state_to_numpy(state):
    """The port's state NamedTuple with numpy leaves (same class)."""
    return type(state)(*(t.detach().cpu().numpy() for t in state))
