"""Ring outbox exchange over D logical shards held on one device.

The port of ``consul_tpu/ops/ring_exchange.py``.  The TPU kernel moves
each shard's outbox rows to their destination chips in D-1 remote-DMA
hops (hop h: shard ``me`` sends row ``(me+h) % D`` into row ``me`` of
that shard's inbox; the self row is a local copy), which yields exactly
the ``lax.all_to_all`` layout.  One H100 holds all D shards, so the
stacked outboxes ``box[src, dst, C, budget]`` become the inbox layout
``inbox[dst, src, C, budget]`` in one launch of the CUDA kernel
``csrc/ring_exchange.cu``: D*D row-block copies in the same hop order.

:func:`ring_exchange` launches the kernel for a CUDA tensor and takes
the plain version :func:`ring_exchange_plain` only for a CPU tensor.
``ring_exchange.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from consul_tpu_torch.ops import _build

# Enough chunks per row that the grid holds about this many blocks
# (several per SM), but no chunk under 1024 int32.
_TARGET_BLOCKS = 1024
_MIN_CHUNK = 1024


def ring_exchange_plain(box: torch.Tensor) -> torch.Tensor:
    """The plain version: per shard ``me`` and hop ``h`` in the kernel's
    order, ``inbox[dst, me] = box[me, dst]`` with ``dst = (me+h) % D``."""
    d = box.shape[0]
    inbox = torch.empty_like(box)
    for me in range(d):
        for h in range(d):
            dst = (me + h) % d
            inbox[dst, me] = box[me, dst]
    return inbox


def _check_box(box: torch.Tensor) -> None:
    if box.dtype != torch.int32:
        raise TypeError(f"ring_exchange takes int32, got {box.dtype}")
    if box.dim() != 4 or box.shape[0] != box.shape[1]:
        raise ValueError(
            f"ring_exchange takes box[D, D, C, budget], got {tuple(box.shape)}"
        )
    if not box.is_contiguous():
        raise ValueError("ring_exchange takes a contiguous box")


def _launch_lib():
    lib = _build.load("ring_exchange")
    fn = lib.ring_exchange_launch
    if fn.argtypes is None:
        # Without argtypes ctypes passes each Python int as a 32-bit int
        # and cuts the pointers.
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ring_exchange(box: torch.Tensor) -> torch.Tensor:
    """int32 ``box[D_src, D_dst, C, budget]`` -> ``inbox[D_dst, D_src, C,
    budget]`` with ``inbox[dst, src] = box[src, dst]``.

    A CPU tensor goes through :func:`ring_exchange_plain`; a CUDA tensor
    launches the kernel on the current stream or raises."""
    _check_box(box)
    if box.device.type == "cpu":
        return ring_exchange_plain(box)
    if box.device.type != "cuda":
        raise ValueError(f"ring_exchange runs on cpu or cuda, not {box.device}")
    inbox = torch.empty_like(box)
    d = box.shape[0]
    row_len = box.shape[2] * box.shape[3]
    if inbox.numel() == 0:
        return inbox
    chunks = max(1, min(-(-_TARGET_BLOCKS // (d * d)),
                        -(-row_len // _MIN_CHUNK)))
    launch = _launch_lib()
    with torch.cuda.device(box.device):
        stream = torch.cuda.current_stream(box.device).cuda_stream
        rc = launch(box.data_ptr(), inbox.data_ptr(), d, row_len, chunks,
                    stream)
    if rc != 0:
        raise RuntimeError(f"ring_exchange kernel launch failed: cudaError {rc}")
    ring_exchange.launches += 1
    return inbox


ring_exchange.launches = 0
