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
