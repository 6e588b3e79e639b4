"""Where the port runs: CUDA unless the caller asks for another device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device, and raises where there is none: the port has no silent CPU
    fallback, so a CPU run is always one the caller asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def device_scalar(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` as a 0-dim (or, for a tensor, same-shape) ``dtype`` tensor on
    ``device``, with no wait on the device.

    ``torch.as_tensor(3.0, device="cuda")`` builds the value on the host
    and copies it with a stream synchronisation; ``torch.full`` fills it
    in on the device instead.  A tensor is only cast and moved."""
    if isinstance(x, (bool, int, float)):
        return torch.full((), x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)
