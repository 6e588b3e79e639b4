"""Carry state and keys between the JAX package and the port, as numpy.

The parity tests start both packages from the same state: the JAX
state's leaves go through ``np.asarray`` and :func:`state_from_numpy`,
and a ``uint32[2]`` jax key through :func:`key_from_numpy`.  Nothing here
imports JAX; the arrays are plain numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def _port_state_classes() -> dict:
    """The port's state NamedTuples by class name (each is named as its
    counterpart in the JAX package)."""
    from consul_tpu_torch.geo.model import GeoState
    from consul_tpu_torch.models import (
        BroadcastState,
        MembershipState,
        MultiDCState,
        SparseMembershipState,
        SwimState,
        VivaldiState,
    )
    from consul_tpu_torch.streamcast.model import StreamcastState

    return {cls.__name__: cls for cls in (
        BroadcastState, GeoState, MembershipState, MultiDCState,
        SparseMembershipState, StreamcastState, SwimState, VivaldiState)}


def key_from_numpy(key, device="cpu") -> torch.Tensor:
    """A ``uint32[..., 2]`` key as the port's int64 ``[..., 2]`` key."""
    k = np.asarray(key)
    if k.dtype != np.uint32 or k.shape[-1:] != (2,):
        raise ValueError(f"expected uint32[..., 2], got {k.dtype}{k.shape}")
    return torch.from_numpy(k.astype(np.int64)).to(device)


def state_from_numpy(state, device="cpu", state_cls=None):
    """A state NamedTuple of numpy arrays (the JAX state through
    ``np.asarray``) as the port's ``state_cls`` on ``device``, leaf for
    leaf and dtype for dtype; 0-d leaves (``tick``) stay 0-dim.  Without
    ``state_cls``, the port's class of the same name as the state's
    (``BroadcastState``, ``SwimState``, ``MultiDCState``, ``GeoState``,
    ``VivaldiState``, ``StreamcastState``, ...)."""
    if state_cls is None:
        name = type(state).__name__
        state_cls = _port_state_classes().get(name)
        if state_cls is None:
            raise TypeError(f"no port state class named {name!r}")
    return state_cls(*(
        torch.from_numpy(np.array(getattr(state, name), copy=True)).to(device)
        for name in state_cls._fields
    ))


def state_to_numpy(state):
    """The port's state NamedTuple with numpy leaves (same class)."""
    return type(state)(*(t.detach().cpu().numpy() for t in state))
