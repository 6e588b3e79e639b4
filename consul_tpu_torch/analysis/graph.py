"""One tick of a program as an ATen graph: the port's jaxpr.

The reference's analyzers read ``jax.make_jaxpr`` of a study: an ordered,
typed, shaped program that allocates nothing, whose ``lax.scan`` body is
the tick.  The port's studies are Python loops over eager ATen calls, so
:func:`capture` runs the program cut to one tick under ``FakeTensorMode``
(tensors with shapes, dtypes and devices but no storage, so a 10M-node
program allocates nothing) and records every ATen call it dispatches into
a ``torch.fx.Graph``: the same capture ``make_fx`` makes (a test holds the
two to one sequence of ATen calls), at about a fifth of its cost a node,
which is what lets ``cli check`` trace the whole registry in seconds.

What the graph holds beyond ``make_fx``'s:

* every node's port stack frames (``node.meta["stack"]``, innermost
  last), so a finding cites ``file:line`` as the reference cites an
  equation's source;
* the storage of each output and the storages the program released right
  after the node (``meta["out"]``, ``meta["frees"]``): eager PyTorch frees
  a tensor when its last Python reference dies, and a finalizer on every
  fake tensor reads exactly that, which is what J6's live-set sweep runs
  on;
* an in-place write through a view (``out[..., t].copy_(v)``) as a
  :func:`write_through` node on the view's base, so data flow reaches the
  tensor the program returns;
* the threefry block function as one node (target
  :func:`consul_tpu_torch.ops.threefry.threefry2x32`, the reference's
  ``threefry2x32`` primitive): four of five ATen calls of a tick are its
  twenty rounds, which no rule reads; the bytes its rounds hold at
  their peak are measured once a shape (``meta["scratch"]``, for J6);
* each host synchronisation of ``ops.sortmerge.host_cond`` as a
  :func:`host_sync` node (``meta["sync"]``: its site, and whether it is a
  branch or a loop predicate), with the branch the trace takes named by
  ``branch``: ``"taken"`` runs every conditional branch, ``"skipped"``
  none; a loop predicate (the Knuth and rejection Poisson loops) holds
  for :data:`LOOP_BLOCKS` reads and then ends the loop;
* the ring kernel as its one ``consul_tpu_torch::ring_exchange_planes``
  node (``ops/ring_exchange.py``).

A host read that no override covers (``.item()``, ``bool()`` of a tensor)
or an ATen call whose output shape depends on data (``nonzero``, a boolean
mask) cannot be traced: :class:`Untraceable` names the call and its port
frame, and the analyses report it as a finding.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import weakref
from pathlib import Path
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

PACKAGE = Path(__file__).resolve().parents[1]
_SELF = str(Path(__file__).resolve())
# Reads of a loop predicate before the traced loop ends: one Knuth block
# (``ops.threefry.POISSON_BLOCK`` iterations), one rejection round.
LOOP_BLOCKS = 1
BRANCHES = ("taken", "skipped")
# Functions whose ``host_cond`` reads continue a loop rather than choose
# a branch.
_LOOP_SITES = frozenset({"_poisson_knuth", "_poisson_rejection"})


class Untraceable(RuntimeError):
    """The tick could not be traced: a host read of a value with no
    override, or an output shape that depends on data."""

    def __init__(self, message: str, where: str = ""):
        super().__init__(f"{message} at {where or '<unknown>'}")
        self.reason = message
        self.where = where


@dataclasses.dataclass(frozen=True)
class TMeta:
    """Shape, dtype and storage of one traced tensor."""

    shape: tuple
    dtype: torch.dtype
    storage: int
    storage_bytes: int

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n * self.dtype.itemsize


@dataclasses.dataclass
class TickInfo:
    """What the analyses read beside the graph.

    ``inputs``/``outputs`` name the flattened leaves (``[0].knows`` as the
    reference's ``keystr``); the first ``n_state`` inputs are the state the
    engine carries from tick to tick, and with ``carried`` the first
    ``n_state`` outputs are that state after the tick, leaf for leaf
    (output ``i`` is input ``i`` of the next tick).  ``tick_outputs`` are the
    per-tick output buffers (their bytes scale with ``steps``), ``syncs``
    the host reads in order."""

    program: str
    branch: str
    steps: int
    inputs: list
    input_meta: list
    n_state: int
    outputs: list
    carried: bool
    tick_outputs: list
    syncs: list
    constants: dict


# Frames of the Python installation (torch, the standard library) are
# not the program's.
_INSTALL = tuple(sorted({sys.prefix, sys.base_prefix, sys.exec_prefix,
                         torch.__file__.rsplit("/torch/", 1)[0]}))


def _port_frames(start) -> tuple:
    """``(file, line, function)`` of each frame of the traced code below
    ``start`` (innermost last): the installation's frames and this
    module's own left out."""
    out = []
    f = start
    while f is not None:
        name = f.f_code.co_filename
        if name != _SELF and not name.startswith(_INSTALL) and \
                not name.startswith("<"):
            out.append((name, f.f_lineno, f.f_code.co_name))
        f = f.f_back
    out.reverse()
    return tuple(out)


def where(node) -> str:
    """``file:line`` of a node's innermost port frame (relative to the
    repository), '' when it has none."""
    return _site(node.meta.get("stack") if hasattr(node, "meta") else ())


def host_sync(pred, site: str = ""):
    """Target of a traced host read: returns its predicate (the branch the
    trace took is fixed in the graph)."""
    return pred


def write_through(base, written):
    """Target of an in-place write into a view of ``base``: the write has
    already landed in ``base``'s storage, which this returns."""
    return base


def constant(value):
    """Target of a tensor the traced code captured from outside the tick
    (a module constant, a host array turned into a tensor)."""
    return value


class _Capture(TorchDispatchMode):
    """Records the ATen calls dispatched under it into ``graph``."""

    def __init__(self, graph: torch.fx.Graph):
        super().__init__()
        self.graph = graph
        self.env: dict = {}          # id(tensor) -> node
        self.live: dict = {}         # storage address -> (tensors, name)
        self.pending_frees: list = []
        self.last: Optional[torch.fx.Node] = None
        self.recording = True
        self.constants: dict = {}
        self.index = 0
        self.scratch: dict = {}

    # -- tensors and their nodes -----------------------------------------

    def _track(self, t: torch.Tensor, node) -> TMeta:
        """Bind ``t`` to ``node`` and count it on its storage.  A storage
        is named by a serial of its own: a freed storage's address can be
        handed to the next one."""
        cdata = t.untyped_storage()._cdata
        nbytes = t.untyped_storage().nbytes()
        count, key = self.live.get(cdata, (0, None))
        if key is None:
            key = self.serial = getattr(self, "serial", 0) + 1
        self.live[cdata] = (count + 1, key)
        self.env[id(t)] = node
        weakref.finalize(t, self._died, id(t), cdata, node)
        return TMeta(tuple(t.shape), t.dtype, key, nbytes)

    def _died(self, tid: int, cdata: int, node) -> None:
        if self.env.get(tid) is node:
            del self.env[tid]
        count, key = self.live[cdata]
        if count == 1:
            del self.live[cdata]
            self.pending_frees.append(key)
        else:
            self.live[cdata] = (count - 1, key)

    def _rebind(self, t: torch.Tensor, node) -> None:
        self.env[id(t)] = node

    def node_of(self, t: torch.Tensor):
        node = self.env.get(id(t))
        if node is not None:
            return node
        # A tensor that entered the tick from outside: a module constant or
        # a host value the code made into a tensor without a dispatch.
        name = f"_const{len(self.constants)}"
        self.constants[name] = t
        node = self._emit(constant, (t,), {}, t, record_args=False)
        node.meta["constant"] = name
        return node

    def _arg(self, a):
        if isinstance(a, torch.Tensor):
            return self.node_of(a)
        if isinstance(a, (list, tuple)):
            return type(a)(self._arg(x) for x in a)
        return a

    def _emit(self, target, args, kwargs, out, record_args: bool = True,
              frames=None):
        """A node calling ``target``; ``out`` is what the call returned (a
        tensor, or a list or tuple of them, read through getitem nodes)."""
        node = self.graph.call_function(
            target,
            tuple(self._arg(a) for a in args) if record_args else (),
            {k: self._arg(v) for k, v in kwargs.items()} if record_args
            else {})
        node.meta["stack"] = (frames if frames is not None
                              else _port_frames(sys._getframe(2)))
        node.meta["index"] = self.index
        node.meta["frees"] = ()
        self.index += 1
        self._flush_frees()
        self.last = node
        if isinstance(out, torch.Tensor):
            node.meta["out"] = (self._track(out, node),)
            return node
        node.meta["out"] = ()
        for i, t in enumerate(out if isinstance(out, (list, tuple))
                              else ()):
            if isinstance(t, torch.Tensor):
                item = self.graph.call_function(_getitem, (node, i))
                item.meta.update(stack=node.meta["stack"],
                                 index=node.meta["index"], frees=(),
                                 out=(self._track(t, item),))
                # What dies next dies after the outputs exist.
                self.last = item
        return node

    def _flush_frees(self) -> None:
        """Attach the storages released since the last node to it."""
        if self.pending_frees and self.last is not None:
            self.last.meta["frees"] = (tuple(self.last.meta["frees"])
                                       + tuple(self.pending_frees))
        self.pending_frees = []

    # -- dispatch --------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.recording:
            return func(*args, **kwargs)
        frames = _port_frames(sys._getframe(1))
        site = _site(frames)
        try:
            out = func(*args, **kwargs)
        except torch._subclasses.fake_tensor.DataDependentOutputException:
            raise Untraceable(f"host read {func}", site) from None
        except torch._subclasses.fake_tensor.DynamicOutputShapeException:
            raise Untraceable(
                f"output shape depends on data: {func}", site) from None
        if func in _HOST_READS:
            raise Untraceable(f"host read {func}", site)
        if not isinstance(out, (torch.Tensor, list, tuple)):
            return out  # metadata (a device, a size): no node
        mutated = _mutated_arg(func, args)
        node = self._emit(func, args, kwargs, out, frames=frames)
        if mutated is not None:
            self._write(mutated, node)
        return out

    def _write(self, target: torch.Tensor, node) -> None:
        """``target`` was written in place by ``node``: later reads of it,
        and of the tensor it views, see the write."""
        self._rebind(target, node)
        base = target._base
        if base is not None and id(base) in self.env:
            wt = self.graph.call_function(
                write_through, (self.env[id(base)], node))
            wt.meta.update(stack=node.meta["stack"],
                           index=node.meta["index"], out=(), frees=(),
                           held=self._held_by_writer())
            self._rebind(base, wt)

    def _held_by_writer(self) -> frozenset:
        """The storages the writing frame's locals hold (a tensor, or one
        inside a tuple, list or NamedTuple): what a loop in that frame
        carries into its next iteration until it rebinds them."""
        f = sys._getframe(2)
        while f is not None and (f.f_code.co_filename == _SELF or
                                 f.f_code.co_filename.startswith(_INSTALL)):
            f = f.f_back
        held = set()
        for v in (f.f_locals.values() if f is not None else ()):
            for t in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(t, torch.Tensor):
                    entry = self.live.get(t.untyped_storage()._cdata)
                    if entry is not None:
                        held.add(entry[1])
        return frozenset(held)

    # -- host reads and the threefry block -------------------------------

    def sync(self, pred, branch: str, counts: dict) -> bool:
        frames = _port_frames(sys._getframe(2))
        if frames and frames[-1][2] == "host_cond":
            frames = frames[:-1]
        fn = frames[-1][2] if frames else ""
        kind = "loop" if fn in _LOOP_SITES else "branch"
        site = _site(frames)
        if kind == "loop":
            counts[site] = counts.get(site, 0) + 1
            value = counts[site] < LOOP_BLOCKS
        else:
            value = branch == "taken"
        node = self.graph.call_function(host_sync, (self.node_of(pred),
                                                    site))
        node.meta.update(stack=frames, index=self.index, out=(), frees=(),
                         sync={"site": site, "kind": kind, "value": value,
                               "function": fn,
                               "stack_functions": tuple(
                                   f for _, _, f in frames)})
        self.index += 1
        self._flush_frees()
        self.last = node
        return value

    def threefry(self, real, k0, k1, x0, x1):
        """The block function as one node; the bytes its twenty rounds
        hold at their peak (``meta["scratch"]``: its two outputs, which
        the node's getitem children then keep, and the temporaries) are
        measured by running it once a shape, unrecorded."""
        key = tuple(tuple(t.shape) for t in (k0, k1, x0, x1))
        self.recording = False
        try:
            if key not in self.scratch:
                self.scratch[key] = _scratch_of(real, (k0, k1, x0, x1))
            shape = torch.broadcast_shapes(*key)
            outs = [torch.empty(shape, dtype=torch.int64, device=k0.device)
                    for _ in range(2)]
        finally:
            self.recording = True
        node = self._emit(real, (k0, k1, x0, x1), {}, tuple(outs))
        node.meta["scratch"] = self.scratch[key]
        return outs[0], outs[1]


class _Peak(TorchDispatchMode):
    """Counts the live bytes of the storages made under it and their
    peak: reference counts, as the capture reads them."""

    def __init__(self):
        super().__init__()
        self.live: dict = {}
        self.total = self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, torch.Tensor):
                cdata = t.untyped_storage()._cdata
                count, nbytes = self.live.get(
                    cdata, (0, t.untyped_storage().nbytes()))
                if not count:
                    self.total += nbytes
                    self.peak = max(self.peak, self.total)
                self.live[cdata] = (count + 1, nbytes)
                weakref.finalize(t, self._died, cdata)
        return out

    def _died(self, cdata: int) -> None:
        count, nbytes = self.live[cdata]
        if count == 1:
            del self.live[cdata]
            self.total -= nbytes
        else:
            self.live[cdata] = (count - 1, nbytes)


def _scratch_of(fn, args) -> int:
    """Bytes of the storages ``fn(*args)`` holds at its peak, what it
    returns included."""
    with _Peak() as mode:
        fn(*args)
    return mode.peak


# ATen calls that hand a tensor's value to the host.
_HOST_READS = frozenset({
    torch.ops.aten._local_scalar_dense.default,
    torch.ops.aten.is_nonzero.default,
    torch.ops.aten.equal.default,
    torch.ops.aten.item.default,
})


def _getitem(seq, i):
    return seq[i]


_ROOT = str(PACKAGE.parent) + "/"


def _rel(file: str) -> str:
    return file[len(_ROOT):] if file.startswith(_ROOT) else file


def _site(frames) -> str:
    """``file:line`` of the innermost of ``frames``, '' when empty."""
    if not frames:
        return ""
    file, line, _ = frames[-1]
    return f"{_rel(file)}:{line}"


def _mutated_arg(func, args):
    """The tensor argument an in-place or ``out=`` ATen call writes."""
    schema = getattr(func, "_schema", None)
    if schema is None:
        return None
    for a, val in zip(schema.arguments, args):
        if a.alias_info is not None and a.alias_info.is_write and \
                isinstance(val, torch.Tensor):
            return val
    return None


@contextlib.contextmanager
def _overrides(cap: _Capture, branch: str):
    """The trace-time hooks: ``host_cond`` records a sync node, the
    threefry block function records one node."""
    from consul_tpu_torch.ops import sortmerge, threefry

    counts: dict = {}
    real = threefry.threefry2x32
    saved = sortmerge.host_cond.override
    sortmerge.host_cond.override = lambda pred: cap.sync(pred, branch,
                                                         counts)
    threefry.threefry2x32 = lambda k0, k1, x0, x1: cap.threefry(
        real, k0, k1, x0, x1)
    try:
        yield
    finally:
        sortmerge.host_cond.override = saved
        threefry.threefry2x32 = real


def _names(tree) -> list:
    return [pytree.keystr(p) for p, _ in pytree.tree_flatten_with_path(
        tree)[0]]


def capture(program: str, fn: Callable, make_args: Callable, steps: int,
            branch: str = "taken") -> torch.fx.GraphModule:
    """The graph of ``fn(*make_args(device))`` (``fn`` the program cut to
    one tick) on fake CPU tensors: a ``GraphModule`` of ATen calls with a
    :class:`TickInfo` as ``gm.tick``.  ``steps`` is the trip count of the
    study the tick belongs to.  Raises :class:`Untraceable`."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if branch not in BRANCHES:
        raise ValueError(f"branch {branch!r} not in {BRANCHES}")
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    graph = torch.fx.Graph()
    cap = _Capture(graph)
    cpu = torch.device("cpu")
    with fake:
        args = make_args(cpu)
    leaves = pytree.tree_leaves(args)
    names = _names(args)
    input_meta = []
    for i, (name, leaf) in enumerate(zip(names, leaves)):
        node = graph.placeholder(f"arg{i}")
        node.meta.update(stack=(), index=-1, frees=(), name=name)
        if isinstance(leaf, torch.Tensor):
            node.meta["out"] = (cap._track(leaf, node),)
            input_meta.append(node.meta["out"][0])
        else:
            node.meta["out"] = ()
            input_meta.append(None)
    n_state = len(pytree.tree_leaves(args[0]))
    with fake, cap, _overrides(cap, branch):
        out = fn(*args)
    cap._flush_frees()
    out_leaves, _ = pytree.tree_flatten(out)
    out_names = _names(out)
    out_nodes = [cap.node_of(x) if isinstance(x, torch.Tensor) else x
                 for x in out_leaves]
    graph.output(tuple(out_nodes))
    carried = len(pytree.tree_leaves(out[0])) == n_state
    tick_outputs = [i for i, x in enumerate(out_leaves)
                    if i >= n_state and isinstance(x, torch.Tensor)
                    and _written_buffer(out_nodes[i])]
    syncs = [n.meta["sync"] for n in graph.nodes
             if n.target is host_sync]
    root = torch.nn.Module()
    gm = torch.fx.GraphModule(root, graph)
    gm.tick = TickInfo(
        program=program, branch=branch, steps=steps, inputs=names,
        input_meta=input_meta, n_state=n_state, outputs=out_names,
        carried=carried, tick_outputs=tick_outputs, syncs=syncs,
        constants=dict(cap.constants))
    return gm


def _written_buffer(node) -> bool:
    """A per-tick output buffer: allocated once and written through views
    every tick (its last definition is a write into it)."""
    return getattr(node, "target", None) is write_through


def trace_program(prog, branch: str = "taken") -> torch.fx.GraphModule:
    """:func:`capture` of a registry ``SimProgram`` cut to one tick."""
    fn = prog.at_steps(1) if prog.at_steps is not None else prog.build()[0]
    _, make_args = prog.build()
    return capture(prog.name, fn, make_args, prog.steps or 1, branch)


def input_nodes(gm) -> list:
    return [n for n in gm.graph.nodes if n.op == "placeholder"]


def output_nodes(gm) -> list:
    (out,) = [n for n in gm.graph.nodes if n.op == "output"]
    return list(out.args[0])
