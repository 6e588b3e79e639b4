"""Ring outbox exchange over D logical shards held on one device.

The port of ``consul_tpu/ops/ring_exchange.py``.  The TPU kernel moves
each shard's outbox rows to their destination chips in D-1 remote-DMA
hops (hop h: shard ``me`` sends row ``(me+h) % D`` into row ``me`` of
that shard's inbox; the self row is a local copy), which yields exactly
the ``lax.all_to_all`` layout.  One H100 holds all D shards, so the
exchange is D*D segment copies per payload plane in the same hop order,
one launch of the CUDA kernel ``csrc/ring_exchange.cu`` for all C planes.

:func:`ring_exchange_planes` is the exchange as the sharded plane calls
it: C outbox planes ``[D_src, D_dst, budget]`` (any row pitch, as
``parallel.shard.pack_outbox`` leaves them) become C inboxes ``[D_dst,
D_src*budget]``.  A sweep's planes carry a leading universe axis, ``[U,
D_src, D_dst, budget]`` -> ``[U, D_dst, D_src*budget]``, and all U
universes and C planes still go through one launch.  :func:`ring_exchange` is the reference's box form,
``box[src, dst, C, budget] -> inbox[dst, src, C, budget]``, as a thin call
of the same launch.  Each launches the kernel for CUDA tensors and takes
its plain version (:func:`ring_exchange_planes_plain`,
:func:`ring_exchange_plain`) only for CPU tensors.  Both count their
launches in ``ring_exchange.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from consul_tpu_torch.ops import _build

MAX_PLANES = 8  # pointer slots in the kernel's by-value parameter struct

_launch_fn = None


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


def ring_exchange_planes_plain(planes) -> tuple:
    """The plain version of :func:`ring_exchange_planes`: per plane, shard
    ``me`` and hop ``h``, ``out[..., dst, me*budget:(me+1)*budget] =
    plane[..., me, dst]`` with ``dst = (me+h) % D``, for every universe
    of a leading ``[U]`` axis at once."""
    *lead, d, _, budget = planes[0].shape
    outs = []
    for p in planes:
        out = torch.empty((*lead, d, d * budget), dtype=p.dtype,
                          device=p.device)
        for me in range(d):
            for h in range(d):
                dst = (me + h) % d
                out[..., dst, me * budget:(me + 1) * budget] = p[..., me, dst,
                                                                 :]
        outs.append(out)
    return tuple(outs)


def _check_box(box: torch.Tensor) -> None:
    if box.dtype != torch.int32:
        raise TypeError(f"ring_exchange takes int32, got {box.dtype}")
    if box.dim() != 4 or box.shape[0] != box.shape[1]:
        raise ValueError(
            f"ring_exchange takes box[D, D, C, budget], got {tuple(box.shape)}"
        )
    if not box.is_contiguous():
        raise ValueError("ring_exchange takes a contiguous box")


def _check_planes(planes) -> None:
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(
            f"ring_exchange_planes takes 1 to {MAX_PLANES} planes, got "
            f"{len(planes)}"
        )
    p0 = planes[0]
    if p0.dtype != torch.int32:
        raise TypeError(f"ring_exchange_planes takes int32, got {p0.dtype}")
    if (p0.dim() not in (3, 4) or p0.shape[-3] != p0.shape[-2]
            or p0.stride(-1) != 1):
        raise ValueError(
            "ring_exchange_planes takes planes [D, D, budget] or [U, D, D, "
            "budget] with unit stride along budget, got "
            f"{tuple(p0.shape)} {p0.stride()}"
        )
    if p0.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"ring_exchange runs on cpu or cuda, not {p0.device}"
        )
    def like(q):
        return q.dtype, q.shape, q.stride(), q.device

    if any(like(q) != like(p0) for q in planes[1:]):
        raise ValueError(
            "ring_exchange_planes takes planes of one dtype, shape, stride "
            f"and device, got {[like(q) for q in planes]}"
        )


def _launch_lib():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load("ring_exchange").ring_exchange_planes_launch
        # Without argtypes ctypes passes each Python int as a 32-bit int
        # and cuts the pointers.
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       ctypes.c_int, *(ctypes.c_longlong,) * 7,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def _launch(src_ptrs, src_strides, out_ptrs, out_strides, u: int, d: int,
            budget: int, device: torch.device) -> None:
    """One kernel launch on the current stream of ``device``: plane c's
    segment ``(u, me, dst)`` of ``budget`` int32 at ``src_ptrs[c] + u *
    src_strides[0] + me * src_strides[1] + dst * src_strides[2]`` (in
    words) goes to ``out_ptrs[c] + u * out_strides[0] + dst *
    out_strides[1] + me * out_strides[2]``."""
    c = len(src_ptrs)
    arr = ctypes.c_void_p * c
    launch = _launch_lib()
    idx = device.index
    args = (c, arr(*src_ptrs), arr(*out_ptrs), u, d, budget, *src_strides,
            *out_strides)
    if idx == torch.cuda.current_device():
        rc = launch(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(device):
            rc = launch(*args, torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError(f"ring_exchange kernel launch failed: cudaError {rc}")
    ring_exchange.launches += 1


def ring_exchange_planes(planes) -> tuple:
    """int32 outbox planes ``[D_src, D_dst, budget]`` or, with a sweep's
    universe axis, ``[U, D_src, D_dst, budget]`` (one shape and stride for
    all, unit stride along budget) -> inboxes ``[(U,) D_dst, D_src*budget]``
    with ``out[u, dst, src*budget:(src+1)*budget] = plane[u, src, dst]``:
    the ``lax.all_to_all`` layout, every universe and plane in one launch.
    The inboxes are the planes of one ``[C, (U,) D, D*budget]`` tensor.

    CPU tensors go through :func:`ring_exchange_planes_plain`; CUDA
    tensors launch the kernel on the current stream or raise."""
    _check_planes(planes)
    p0 = planes[0]
    if p0.device.type == "cpu":
        return ring_exchange_planes_plain(planes)
    *lead, d, _, budget = p0.shape
    u = lead[0] if lead else 1
    c = len(planes)
    out = torch.empty((c, *lead, d, d * budget), dtype=torch.int32,
                      device=p0.device)
    if budget and d and u:
        base, size = out.data_ptr(), u * d * d * budget * 4
        src_u = p0.stride(0) if lead else 0
        _launch([p.data_ptr() for p in planes],
                (src_u, *p0.stride()[-3:-1]),
                [base + i * size for i in range(c)],
                (d * d * budget, d * budget, budget), u, d, budget,
                p0.device)
    return out.unbind(0)


def ring_exchange(box: torch.Tensor) -> torch.Tensor:
    """int32 ``box[D_src, D_dst, C, budget]`` -> ``inbox[D_dst, D_src, C,
    budget]`` with ``inbox[dst, src] = box[src, dst]``: the C column
    planes of the box go through one launch of the planes kernel.

    A CPU tensor goes through :func:`ring_exchange_plain`; a CUDA tensor
    launches the kernel on the current stream or raises."""
    _check_box(box)
    if box.device.type == "cpu":
        return ring_exchange_plain(box)
    if box.device.type != "cuda":
        raise ValueError(f"ring_exchange runs on cpu or cuda, not {box.device}")
    d, _, c, budget = box.shape
    if c > MAX_PLANES:
        raise ValueError(
            f"ring_exchange takes at most {MAX_PLANES} columns, got {c}"
        )
    inbox = torch.empty_like(box)
    if inbox.numel() == 0:
        return inbox
    row = budget * 4
    src, out = box.data_ptr(), inbox.data_ptr()
    _launch([src + i * row for i in range(c)], (0, *box.stride()[:2]),
            [out + i * row for i in range(c)], (0, *inbox.stride()[:2]), 1, d,
            budget, box.device)
    return inbox


ring_exchange.launches = 0
