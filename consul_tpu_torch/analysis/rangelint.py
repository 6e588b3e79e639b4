"""rangelint: interval abstract interpretation over one tick's ATen graph.

The port of ``consul_tpu/analysis/rangelint.py``.  tracelint sees the code
you wrote, jaxlint the shapes and bytes of the ATen calls; this module
reasons about the *values* that flow through them.  Every registered
program's tick graph (``SimProgram.traces()``: fake tensors, nothing
allocated) is walked by an abstract interpreter whose domain is one
interval per tensor (every element lies in it).  Input intervals come
from the registry's bound metadata (``SimProgram.bounds``: node ids in
[-1, n-1], ticks at 0, budgets from the config); the graph is run to the
carry fixpoint of the state the engine hands from tick to tick, with the
reference's trip-count widening (``steps`` is the trip count); everything
else is transfer functions per ATen call with a dtype-range top.

Rules (``--list-rules`` prints this table):

  J7  integer-overflow      a signed-integer ATen call whose exact result
                            range (unbounded integers from the derived
                            bounds) escapes its result dtype: silent
                            int32/int16/int8 wraparound at the declared
                            config.  The uint32 words that ``ops/
                            threefry.py`` and ``ops/sampling.py`` hold in
                            int64 are exempt: their wraparound is the
                            generator.  Dual output: a narrowing
                            certificate per state plane (the minimal
                            signed dtype that provably holds its fixpoint
                            range), read at 10M nodes through
                            ``SimProgram.scale`` (:func:`narrowing_ledger`).
  J8  prng-key-lineage      a threefry key drawn by two draw sites, split
                            twice, drawn after a split, or drawn from while
                            it is the scan key itself (every tick the same
                            stream).  Read from the block function's nodes
                            and their frames in ``ops/threefry.py``:
                            ``fold_in``, ``split`` and the draws
                            (``random_bits``); a ``fold_in`` with a
                            distinct salt is a new key.
  J9  loud-accounting       a masked drop site in the tick (a scatter,
                            ``index_put_`` or ``index_fill_`` whose index
                            comes from a boolean mask and may land on the
                            sentinel slot the port drops, its emulation of
                            JAX's dropped scatter) where no value derived
                            from the mask reaches the tick's outputs
                            outside the scatter itself: units vanish
                            without a carried counter seeing them.

The fixpoint and its widening
-----------------------------

The tick is iterated: ``c1 = c0 ∪ f(c0)``, ``c2 = c1 ∪ f(c1)``.  If
``c2 == c1`` the carry converged.  Otherwise the per-tick growth ``d = c2
- c1`` is extrapolated over the trip count (``hi = hi(c2) + d·(steps-2)``)
and verified with one more tick under saturating semantics; super-linear
growth falls to the dtype top.  J7 fires only on intervals whose every
input was derived (never on a dtype-range top), so precision loss can cost
certificates but never invents findings.  A program traced on two branches
is analysed on each; its certificates take the join.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from typing import Iterable, Optional

import torch
from torch.utils import _pytree as pytree

from consul_tpu_torch.analysis import graph as g
from consul_tpu_torch.analysis.jaxlint import Finding, format_bytes
from consul_tpu_torch.analysis.tracelint import suppressed_at

RULES: dict[str, str] = {
    "J7": "integer-overflow: a signed-int op whose derived result range "
          "escapes its dtype (silent wraparound); threefry's uint32 words "
          "exempt",
    "J8": "prng-key-lineage: a key drawn twice, split twice, drawn after "
          "a split, or the scan key drawn from unfolded",
    "J9": "loud-accounting: a mask-gated drop site whose mask reaches no "
          "output of the tick — silent unit loss",
}
RANGELINT_RULES = RULES

_INF = float("inf")
_SCAN_FIX_ITERS = 2
_WIDEN_ROUNDS = 3
_U32_MAX = (1 << 32) - 1
# Files whose int64 arithmetic is uint32 words: wraparound is the point.
_WRAP_FILES = ("ops/threefry.py", "ops/sampling.py")


@dataclasses.dataclass(frozen=True)
class Bound:
    """Value bound of one argument leaf: ``Bound(lo, hi)`` claims every
    element lies in [lo, hi]; ``Bound.any()`` claims nothing (keys,
    planes with no derivable contract)."""

    lo: Optional[float] = None
    hi: Optional[float] = None

    @staticmethod
    def any() -> "Bound":
        return Bound(None, None)

    @property
    def known(self) -> bool:
        return self.lo is not None and self.hi is not None


@dataclasses.dataclass(frozen=True)
class IV:
    """One abstract value: [lo, hi] over every element; ``known`` means
    derived (bounds, constants, transfer rules), not a dtype-range
    default: only derived intervals may raise J7."""

    lo: float
    hi: float
    known: bool

    def hull(self, other: "IV") -> "IV":
        return IV(min(self.lo, other.lo), max(self.hi, other.hi),
                  self.known and other.known)

    def contains(self, other: "IV") -> bool:
        return self.lo <= other.lo and other.hi <= self.hi


def _is_int(d) -> bool:
    return d is not None and not d.is_floating_point and \
        not d.is_complex and d != torch.bool


def _is_signed(d) -> bool:
    return _is_int(d) and d.is_signed


def _int_range(d) -> tuple:
    info = torch.iinfo(d)
    return int(info.min), int(info.max)


def _top_of(d) -> IV:
    if d is None:
        return IV(-_INF, _INF, False)
    if d == torch.bool:
        return IV(0, 1, True)
    if _is_int(d):
        lo, hi = _int_range(d)
        return IV(lo, hi, False)
    return IV(-_INF, _INF, False)


_SIGNED_MINIMA = (torch.int8, torch.int16, torch.int32)


def minimal_signed_dtype(lo: float, hi: float) -> Optional[str]:
    """Smallest signed dtype holding [lo, hi], None past int32."""
    for d in _SIGNED_MINIMA:
        info = torch.iinfo(d)
        if info.min <= lo and hi <= info.max:
            return str(d).replace("torch.", "")
    return None


@dataclasses.dataclass(frozen=True)
class NarrowingCertificate:
    """J7's dual output for one state plane: the proven fixpoint range,
    the minimal safe signed dtype, and the bytes a copy of the state
    would save."""

    program: str
    plane: str
    dtype: str
    lo: int
    hi: int
    minimal: str
    elements: int
    bytes_now: int
    bytes_minimal: int

    @property
    def saved_bytes(self) -> int:
        return self.bytes_now - self.bytes_minimal

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["saved_bytes"] = self.saved_bytes
        return out


@dataclasses.dataclass
class RangeReport:
    findings: list
    certificates: list


def _name(node) -> str:
    t = node.target
    if isinstance(t, torch._ops.OpOverload):
        return t.overloadpacket.__name__
    return getattr(t, "__name__", str(t))


def _dtype(node, i: int = 0):
    out = node.meta.get("out", ()) if hasattr(node, "meta") else ()
    return out[i].dtype if len(out) > i else None


def _shape(node, i: int = 0) -> tuple:
    while isinstance(node, torch.fx.Node) and node.target is g.write_through:
        node = node.args[0]  # a write leaves its buffer's shape
    out = node.meta.get("out", ()) if hasattr(node, "meta") else ()
    return tuple(out[i].shape) if len(out) > i else ()


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _const_iv(v) -> IV:
    if isinstance(v, bool):
        return IV(int(v), int(v), True)
    if isinstance(v, (int, float)):
        if isinstance(v, float) and not math.isfinite(v):
            return IV(-_INF, _INF, False)
        return IV(v, v, True)
    return IV(-_INF, _INF, False)


def _tensor_iv(t: torch.Tensor) -> IV:
    if t.numel() == 0 or t.numel() > (1 << 22) or t.is_complex():
        return _top_of(t.dtype)
    try:
        lo, hi = t.min().item(), t.max().item()
    except (RuntimeError, NotImplementedError):
        return _top_of(t.dtype)
    if isinstance(lo, float) and not (math.isfinite(lo)
                                      and math.isfinite(hi)):
        return IV(-_INF, _INF, False)
    return IV(lo, hi, True)


def _tdiv(a: float, b: float) -> float:
    if b == 0:
        return 0
    if a in (-_INF, _INF) or b in (-_INF, _INF):
        return 0 if b in (-_INF, _INF) else math.copysign(_INF, a * b)
    q = abs(int(a)) // abs(int(b))
    return q if (a >= 0) == (b >= 0) else -q


def _fdiv(a: float, b: float) -> float:
    if b == 0:
        return 0
    if a in (-_INF, _INF) or b in (-_INF, _INF):
        return 0 if b in (-_INF, _INF) else math.copysign(_INF, a * b)
    return int(a) // int(b)


class _Interp:
    """The interval interpreter of one tick graph."""

    def __init__(self, program: str, rules: frozenset):
        self.program = program
        self.rules = rules
        self.findings: list = []
        self.noisy = True
        self.saturate = False
        self._flagged: set = set()

    def report(self, node, rule: str, message: str,
               where: Optional[str] = None) -> None:
        if rule not in self.rules or not self.noisy:
            return
        if where is None:
            where = g.where(node) if node is not None else ""
        if suppressed_at(where, rule):
            return
        key = (rule, where, _name(node) if node is not None else "")
        if key in self._flagged:
            return
        self._flagged.add(key)
        self.findings.append(Finding(self.program, rule, message, where))

    # -- helpers ---------------------------------------------------------

    def _val(self, env, a) -> IV:
        if isinstance(a, torch.fx.Node):
            v = env.get(a)
            if isinstance(v, IV) and v.lo <= v.hi:
                return v
            return _top_of(_dtype(a))
        return _const_iv(a)

    def _raw(self, env, a) -> IV:
        """``a``'s interval, the empty one of a buffer not yet written
        included."""
        v = env.get(a) if isinstance(a, torch.fx.Node) else None
        return v if isinstance(v, IV) else self._val(env, a)

    def _wraps(self, node) -> bool:
        stack = node.meta.get("stack") or ()
        return bool(stack) and stack[-1][0].endswith(_WRAP_FILES)

    def _settle(self, node, iv: IV, d=None) -> IV:
        """Clamp an exact result to its dtype, flagging J7 on a proven
        signed escape."""
        d = d if d is not None else _dtype(node)
        if not _is_int(d):
            return iv
        lo_d, hi_d = _int_range(d)
        if iv.known and (iv.lo < lo_d or iv.hi > hi_d):
            if self.saturate:
                return IV(max(iv.lo, lo_d), min(iv.hi, hi_d), True)
            if _is_signed(d) and not self._wraps(node):
                self.report(
                    node, "J7",
                    f"{_name(node)} result range [{int(iv.lo)}, "
                    f"{int(iv.hi)}] escapes {str(d).replace('torch.', '')}"
                    f" [{lo_d}, {hi_d}] — silent wraparound (widen the "
                    "plane, clamp the operand, or restructure)")
            return IV(lo_d, hi_d, False)
        return IV(max(iv.lo, lo_d), min(iv.hi, hi_d), iv.known)

    # -- evaluation ------------------------------------------------------

    def run(self, gm, in_ivs: list) -> dict:
        env: dict = {}
        for node, iv in zip(g.input_nodes(gm), in_ivs):
            d = _dtype(node)
            if iv is None or not iv.known:
                iv = _top_of(d)
            elif _is_int(d):
                lo, hi = _int_range(d)
                iv = IV(max(iv.lo, lo), min(iv.hi, hi), True)
            env[node] = iv
        for node in gm.graph.nodes:
            if node.op != "call_function":
                continue
            try:
                env[node] = self.eval(env, node)
            except Exception:  # noqa: BLE001 - the analysis must not die
                env[node] = self._top_node(node)
        return env

    def _top_node(self, node):
        outs = node.meta.get("out", ())
        if len(outs) == 1:
            return _top_of(outs[0].dtype)
        return None

    def eval(self, env, node):
        name = _name(node)
        args = node.args
        if node.target is g._getitem:
            src = env.get(args[0])
            if isinstance(src, list) and args[1] < len(src):
                return src[args[1]]
            parent = args[0]
            if isinstance(parent, torch.fx.Node) and \
                    _name(parent) == "unbind" and _dim0(parent):
                return _filled(self._row(env, parent.args[0], args[1]),
                               _dtype(node))
            if isinstance(src, IV):
                return src
            return _top_of(_dtype(node))
        if node.target is g.write_through:
            return self._raw(env, args[0]).hull(self._val(env, args[1]))
        if node.target is g.host_sync:
            return self._val(env, args[0])
        if node.target is g.constant:
            name_c = node.meta.get("constant")
            t = self.constants.get(name_c)
            return _tensor_iv(t) if t is not None else _top_of(
                _dtype(node))
        handler = getattr(self, "_p_" + name, None)
        if handler is not None:
            return handler(env, node, args)
        if name in _PASS:
            return self._val(env, args[0])
        if name in _CMP or name in _BOOL:
            return IV(0, 1, True)
        return self._top_node(node)

    def _p_select(self, env, node, args):
        if args[1] == 0:
            return _filled(self._row(env, args[0], args[2]), _dtype(node))
        return self._val(env, args[0])

    def _row(self, env, x, i: int, depth: int = 0) -> IV:
        """The value of row ``i`` (along dim 0) of ``x``, following the
        writes into a buffer's rows one by one: a buffer whose rows are
        written separately (the outbox's columns) keeps one interval a
        row rather than their join."""
        if not isinstance(x, torch.fx.Node) or depth > 64:
            return self._val(env, x)
        if x.target is g.write_through:
            base = self._row(env, x.args[0], i, depth + 1)
            j = _written_row(x.args[1])
            if j is not None and j != i:
                return base
            return base.hull(self._val(env, x.args[1]))
        if x.op == "call_function" and _keeps_dim0(x):
            return self._row(env, x.args[0], i, depth + 1)
        return self._raw(env, x)

    # -- arithmetic ------------------------------------------------------

    def _bin(self, env, node, f, a, b) -> IV:
        a, b = self._val(env, a), self._val(env, b)
        if not (a.known and b.known):
            return _top_of(_dtype(node))
        try:
            c = [f(x, y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
        except (OverflowError, ValueError, ZeroDivisionError):
            return _top_of(_dtype(node))
        if any(isinstance(x, float) and math.isnan(x) for x in c):
            return _top_of(_dtype(node))
        return self._settle(node, IV(min(c), max(c), True))

    def _p_add(self, env, node, args):
        alpha = node.kwargs.get("alpha", 1)
        return self._bin(env, node, lambda x, y: x + alpha * y, args[0],
                         args[1])

    def _p_sub(self, env, node, args):
        alpha = node.kwargs.get("alpha", 1)
        return self._bin(env, node, lambda x, y: x - alpha * y, args[0],
                         args[1])

    def _p_rsub(self, env, node, args):
        return self._bin(env, node, lambda x, y: y - x, args[0], args[1])

    def _p_mul(self, env, node, args):
        return self._bin(env, node, lambda x, y: x * y, args[0], args[1])

    def _p_addcmul(self, env, node, args):
        v = node.kwargs.get("value", args[3] if len(args) > 3 else 1)
        prod = self._bin(env, node, lambda x, y: x * y, args[1], args[2])
        base = self._val(env, args[0])
        if not (prod.known and base.known):
            return _top_of(_dtype(node))
        c = [x + v * y for x in (base.lo, base.hi) for y in (prod.lo,
                                                              prod.hi)]
        return IV(min(c), max(c), True)

    def _p_div(self, env, node, args):
        a, b = self._val(env, args[0]), self._val(env, args[1])
        mode = node.kwargs.get("rounding_mode")
        if not (a.known and b.known) or b.lo <= 0 <= b.hi:
            return _top_of(_dtype(node))
        if mode == "trunc":
            return self._bin(env, node, _tdiv, args[0], args[1])
        if mode == "floor":
            return self._bin(env, node, _fdiv, args[0], args[1])
        return self._bin(env, node, lambda x, y: x / y, args[0], args[1])

    def _p_floor_divide(self, env, node, args):
        a, b = self._val(env, args[0]), self._val(env, args[1])
        if not (a.known and b.known) or b.lo <= 0 <= b.hi:
            return _top_of(_dtype(node))
        return self._bin(env, node, _fdiv, args[0], args[1])

    def _p_remainder(self, env, node, args):
        # Python's floor modulo: the sign of the divisor.
        a, b = self._val(env, args[0]), self._val(env, args[1])
        d = _dtype(node)
        if not b.known or b.lo <= 0:
            return _top_of(d)
        hi = b.hi - 1 if _is_int(d) else b.hi
        if a.known and 0 <= a.lo and a.hi < b.lo:
            return a
        if a.known and a.lo >= 0:
            return IV(0, min(a.hi, hi), True)
        return IV(0, hi, True)

    def _p_fmod(self, env, node, args):
        a, b = self._val(env, args[0]), self._val(env, args[1])
        if not b.known or b.lo <= 0:
            return _top_of(_dtype(node))
        hi = b.hi - 1 if _is_int(_dtype(node)) else b.hi
        if a.known and a.lo >= 0:
            return IV(0, min(a.hi, hi), True)
        return IV(-hi, hi, a.known)

    def _p_neg(self, env, node, args):
        a = self._val(env, args[0])
        return self._settle(node, IV(-a.hi, -a.lo, a.known))

    def _p_abs(self, env, node, args):
        a = self._val(env, args[0])
        lo = 0 if a.lo <= 0 <= a.hi else min(abs(a.lo), abs(a.hi))
        return self._settle(node, IV(lo, max(abs(a.lo), abs(a.hi)),
                                     a.known))

    def _p_sign(self, env, node, args):
        return IV(-1, 1, True)

    def _p_maximum(self, env, node, args):
        a, b = self._val(env, args[0]), self._val(env, args[1])
        return IV(max(a.lo, b.lo), max(a.hi, b.hi), a.known and b.known)

    def _p_minimum(self, env, node, args):
        a, b = self._val(env, args[0]), self._val(env, args[1])
        return IV(min(a.lo, b.lo), min(a.hi, b.hi), a.known and b.known)

    def _p_clamp(self, env, node, args):
        x = self._val(env, args[0])
        lo_a = node.kwargs.get("min", args[1] if len(args) > 1 else None)
        hi_a = node.kwargs.get("max", args[2] if len(args) > 2 else None)
        lo, hi, known = x.lo, x.hi, x.known
        if lo_a is not None:
            b = self._val(env, lo_a)
            lo, hi = max(lo, b.lo), max(hi, b.hi)
            known = known or (b.known and b.lo == b.hi and x.known)
        if hi_a is not None:
            b = self._val(env, hi_a)
            lo, hi = min(lo, b.lo), min(hi, b.hi)
        if not x.known and lo_a is not None and hi_a is not None:
            a, b = self._val(env, lo_a), self._val(env, hi_a)
            if a.known and b.known:
                return IV(a.lo, b.hi, True)
        return IV(min(lo, hi), max(lo, hi), known)

    def _p_clamp_min(self, env, node, args):
        return self._p_clamp(env, node, (args[0], args[1]))

    def _p_clamp_max(self, env, node, args):
        return self._p_clamp(env, node, (args[0], None, args[1]))

    def _p_pow(self, env, node, args):
        a, e = self._val(env, args[0]), args[1]
        if not isinstance(e, (int, float)) or not a.known or e < 0:
            return _top_of(_dtype(node))
        c = [a.lo ** e, a.hi ** e] + ([0] if a.lo <= 0 <= a.hi else [])
        return self._settle(node, IV(min(c), max(c), True))

    def _shift(self, env, node, args, left: bool):
        a, s = self._val(env, args[0]), self._val(env, args[1])
        if not (a.known and s.known) or s.lo < 0 or s.hi > 63:
            return _top_of(_dtype(node))
        if not left and a.lo < 0:
            return _top_of(_dtype(node))
        op = (lambda x, t: int(x) << int(t)) if left else (
            lambda x, t: int(x) >> int(t))
        c = [op(x, t) for x in (a.lo, a.hi) for t in (s.lo, s.hi)]
        return self._settle(node, IV(min(c), max(c), True))

    def _p___lshift__(self, env, node, args):
        return self._shift(env, node, args, True)

    _p_bitwise_left_shift = _p___lshift__

    def _p___rshift__(self, env, node, args):
        return self._shift(env, node, args, False)

    _p_bitwise_right_shift = _p___rshift__

    def _p_bitwise_and(self, env, node, args):
        if _dtype(node) == torch.bool:
            a, b = self._val(env, args[0]), self._val(env, args[1])
            if (a.known and a.hi == 0) or (b.known and b.hi == 0):
                return IV(0, 0, True)
            if a.known and b.known and a.lo == 1 and b.lo == 1:
                return IV(1, 1, True)
            return IV(0, 1, True)
        a, b = self._val(env, args[0]), self._val(env, args[1])
        for m, x in ((b, a), (a, b)):
            if m.known and m.lo == m.hi and m.lo >= 0:
                mask = int(m.lo)
                if (mask + 1) & mask == 0 and x.known and 0 <= x.lo and \
                        x.hi <= mask:
                    return x  # a low-bits mask leaves [0, mask] intact
            if m.known and m.lo >= 0:
                if x.known and x.lo >= 0:
                    return IV(0, min(m.hi, x.hi), True)
                return IV(0, m.hi, True)
        return _top_of(_dtype(node))

    def _bitor(self, env, node, args):
        a, b = self._val(env, args[0]), self._val(env, args[1])
        if _dtype(node) == torch.bool:
            if (a.known and a.lo == 1) or (b.known and b.lo == 1):
                return IV(1, 1, True)
            if a.known and b.known and a.hi == 0 and b.hi == 0:
                return IV(0, 0, True)
            return IV(0, 1, True)
        if a.known and b.known and a.lo >= 0 and b.lo >= 0:
            bits = max(int(a.hi).bit_length(), int(b.hi).bit_length())
            return IV(0, (1 << bits) - 1, True)
        return _top_of(_dtype(node))

    _p_bitwise_or = _p_bitwise_xor = _bitor

    def _p_bitwise_not(self, env, node, args):
        a = self._val(env, args[0])
        if _dtype(node) == torch.bool:
            if a.known and a.lo == a.hi:
                return IV(1 - a.lo, 1 - a.lo, True)
            return IV(0, 1, True)
        if a.known:
            return IV(-a.hi - 1, -a.lo - 1, True)
        return _top_of(_dtype(node))

    _p_logical_not = _p_bitwise_not

    def _p_logical_and(self, env, node, args):
        return self._p_bitwise_and(env, node, args)

    _p_logical_or = _bitor

    def _p__to_copy(self, env, node, args):
        a = self._val(env, args[0])
        d_out = _dtype(node)
        d_in = _dtype(args[0]) if isinstance(args[0], torch.fx.Node) \
            else None
        if not a.known:
            return _top_of(d_out)
        if d_out == torch.bool:
            if a.lo > 0 or a.hi < 0:
                return IV(1, 1, True)
            if a.lo == a.hi == 0:
                return IV(0, 0, True)
            return IV(0, 1, True)
        if d_in is not None and d_in.is_floating_point and _is_int(d_out):
            if a.lo in (-_INF, _INF) or a.hi in (-_INF, _INF):
                return _top_of(d_out)
            iv = IV(math.trunc(a.lo), math.trunc(a.hi), True)
        elif d_in == torch.int64 and d_out == torch.int32 and \
                0 <= a.lo and a.hi <= _U32_MAX:
            # A uint32 word (an int32 key or bits held in int64, masked
            # with 0xFFFFFFFF) read back as int32: a reinterpretation.
            return a if a.hi <= _int_range(d_out)[1] else _top_of(d_out)
        else:
            iv = a
        return self._settle(node, iv)

    def _round_op(self, env, node, args, f):
        a = self._val(env, args[0])
        if not a.known or a.lo in (-_INF, _INF) or a.hi in (-_INF, _INF):
            return a
        return IV(f(a.lo), f(a.hi), True)

    def _p_floor(self, env, node, args):
        return self._round_op(env, node, args, math.floor)

    def _p_ceil(self, env, node, args):
        return self._round_op(env, node, args, math.ceil)

    def _p_trunc(self, env, node, args):
        return self._round_op(env, node, args, math.trunc)

    def _p_round(self, env, node, args):
        return self._round_op(env, node, args, round)

    # -- selection and comparison ----------------------------------------

    def _p_where(self, env, node, args):
        if len(args) < 3:
            return _top_of(_dtype(node))
        c = self._val(env, args[0])
        a, b = self._val(env, args[1]), self._val(env, args[2])
        if c.known and c.lo == c.hi == 1:
            return a
        if c.known and c.lo == c.hi == 0:
            return b
        return a.hull(b)

    def _cmp(self, env, node, args, op):
        a, b = self._val(env, args[0]), self._val(env, args[1])
        if a.known and b.known:
            lo_true = op(a.lo, b.lo) and op(a.lo, b.hi) and \
                op(a.hi, b.lo) and op(a.hi, b.hi)
            if lo_true and op in (_LT, _LE, _GT, _GE):
                return IV(1, 1, True)
            never = {
                _LT: a.lo >= b.hi, _LE: a.lo > b.hi, _GT: a.hi <= b.lo,
                _GE: a.hi < b.lo, _EQ: a.hi < b.lo or b.hi < a.lo,
                _NE: a.lo == a.hi == b.lo == b.hi,
            }[op]
            if never:
                return IV(0, 0, True)
            if op is _EQ and a.lo == a.hi == b.lo == b.hi:
                return IV(1, 1, True)
            if op is _NE and (a.hi < b.lo or b.hi < a.lo):
                return IV(1, 1, True)
        return IV(0, 1, True)

    def _p_lt(self, env, node, args):
        return self._cmp(env, node, args, _LT)

    def _p_le(self, env, node, args):
        return self._cmp(env, node, args, _LE)

    def _p_gt(self, env, node, args):
        return self._cmp(env, node, args, _GT)

    def _p_ge(self, env, node, args):
        return self._cmp(env, node, args, _GE)

    def _p_eq(self, env, node, args):
        return self._cmp(env, node, args, _EQ)

    def _p_ne(self, env, node, args):
        return self._cmp(env, node, args, _NE)

    # -- creation --------------------------------------------------------

    def _p_full(self, env, node, args):
        return self._settle(node, _const_iv(args[1]))

    def _p_new_full(self, env, node, args):
        return self._settle(node, _const_iv(args[2]))

    def _p_full_like(self, env, node, args):
        return self._settle(node, _const_iv(args[1]))

    def _p_scalar_tensor(self, env, node, args):
        return self._settle(node, _const_iv(args[0]))

    def _p_zeros(self, env, node, args):
        return IV(0, 0, True)

    _p_zeros_like = _p_new_zeros = _p_zeros

    def _p_ones(self, env, node, args):
        return IV(1, 1, True)

    _p_ones_like = _p_new_ones = _p_ones

    def _p_empty(self, env, node, args):
        return _EMPTY

    _p_empty_like = _p_new_empty = _p_empty_strided = _p_empty

    def _p_fill_(self, env, node, args):
        return self._val(env, args[1])

    def _p_arange(self, env, node, args):
        vals = [a for a in args if isinstance(a, (int, float))]
        if len(vals) == 1:
            start, end, step = 0, vals[0], 1
        elif len(vals) >= 2:
            start, end = vals[0], vals[1]
            step = vals[2] if len(vals) > 2 else 1
        else:
            return _top_of(_dtype(node))
        n = _numel(_shape(node))
        if n == 0:
            return IV(0, 0, True)
        last = start + step * (n - 1)
        return IV(min(start, last), max(start, last), True)

    def _p_lift_fresh(self, env, node, args):
        return self._val(env, args[0])

    def _p_copy_(self, env, node, args):
        return self._val(env, args[1])

    def _p_copy(self, env, node, args):
        return self._val(env, args[1])

    def _p_stack(self, env, node, args):
        ivs = [self._val(env, a) for a in args[0]]
        out = ivs[0]
        for iv in ivs[1:]:
            out = out.hull(iv)
        return out

    _p_cat = _p_stack

    # -- reductions ------------------------------------------------------

    def _reduced(self, node, args) -> int:
        shape = _shape(args[0]) if isinstance(args[0], torch.fx.Node) \
            else ()
        dims = args[1] if len(args) > 1 else node.kwargs.get("dim")
        if dims is None or dims == []:
            return max(_numel(shape), 1)
        if isinstance(dims, int):
            dims = [dims]
        n = 1
        for d in dims:
            n *= shape[d] if shape else 1
        return max(n, 1)

    def _p_sum(self, env, node, args):
        a = self._val(env, args[0])
        if not a.known:
            return _top_of(_dtype(node))
        m = self._reduced(node, args)
        return self._settle(node, IV(min(a.lo * m, a.lo),
                                     max(a.hi * m, a.hi), True))

    def _p_cumsum(self, env, node, args):
        a = self._val(env, args[0])
        if not a.known:
            return _top_of(_dtype(node))
        shape = _shape(args[0])
        m = shape[args[1]] if shape else 1
        return self._settle(node, IV(min(a.lo * m, a.lo),
                                     max(a.hi * m, a.hi), True))

    def _p_amax(self, env, node, args):
        return self._val(env, args[0])

    _p_amin = _p_mean = _p_amax

    def _p_max(self, env, node, args):
        a = self._val(env, args[0])
        if len(args) > 1 and isinstance(args[1], torch.fx.Node):
            return self._p_maximum(env, node, args)
        if len(args) > 1:  # max.dim: (values, indices)
            shape = _shape(args[0])
            return [a, IV(0, max(shape[args[1]] - 1, 0), True)]
        return a

    def _p_min(self, env, node, args):
        a = self._val(env, args[0])
        if len(args) > 1 and isinstance(args[1], torch.fx.Node):
            return self._p_minimum(env, node, args)
        if len(args) > 1:
            shape = _shape(args[0])
            return [a, IV(0, max(shape[args[1]] - 1, 0), True)]
        return a

    def _p_cummax(self, env, node, args):
        shape = _shape(args[0])
        return [self._val(env, args[0]),
                IV(0, max(shape[args[1]] - 1, 0), True)]

    _p_cummin = _p_cummax

    def _p_sort(self, env, node, args):
        shape = _shape(args[0])
        dim = node.kwargs.get("dim", args[1] if len(args) > 1
                              and isinstance(args[1], int) else -1)
        n = shape[dim] if shape else 1
        return [self._val(env, args[0]), IV(0, max(n - 1, 0), True)]

    def _p_topk(self, env, node, args):
        shape = _shape(args[0])
        dim = args[2] if len(args) > 2 else -1
        n = shape[dim] if shape else 1
        return [self._val(env, args[0]), IV(0, max(n - 1, 0), True)]

    def _p_argmax(self, env, node, args):
        shape = _shape(args[0])
        dim = args[1] if len(args) > 1 else None
        n = _numel(shape) if dim is None else shape[dim]
        return IV(0, max(n - 1, 0), True)

    _p_argmin = _p_argmax

    # -- scatters --------------------------------------------------------

    def _scatter(self, env, node, base, src, combine: str) -> IV:
        a = self._val(env, base)
        b = self._val(env, src)
        if combine == "set":
            return a.hull(b)
        if combine == "add":
            if not (a.known and b.known):
                return _top_of(_dtype(node))
            n = max(_numel(_shape(src)) if isinstance(src, torch.fx.Node)
                    else 1, 1)
            return self._settle(node, IV(a.lo + n * min(b.lo, 0),
                                         a.hi + n * max(b.hi, 0), True))
        return _top_of(_dtype(node))

    def _p_scatter(self, env, node, args):
        src = args[3] if len(args) > 3 else node.kwargs.get("value", 0)
        red = node.kwargs.get("reduce")
        return self._scatter(env, node, args[0], src,
                             "add" if red == "add" else "set")

    _p_scatter_ = _p_scatter

    def _p_scatter_add(self, env, node, args):
        return self._scatter(env, node, args[0], args[3], "add")

    _p_scatter_add_ = _p_scatter_add

    def _p_scatter_reduce(self, env, node, args):
        red = args[4] if len(args) > 4 else node.kwargs.get("reduce")
        include = node.kwargs.get("include_self", True)
        if red in ("amax", "amin"):
            a, b = self._val(env, args[0]), self._val(env, args[3])
            return a.hull(b) if include else b.hull(a)
        if red == "sum":
            return self._scatter(env, node, args[0], args[3], "add")
        return _top_of(_dtype(node))

    _p_scatter_reduce_ = _p_scatter_reduce

    def _p_index_put(self, env, node, args):
        acc = args[3] if len(args) > 3 else node.kwargs.get(
            "accumulate", False)
        return self._scatter(env, node, args[0], args[2],
                             "add" if acc else "set")

    _p_index_put_ = _p_index_put

    def _p_index_fill(self, env, node, args):
        return self._scatter(env, node, args[0], args[3], "set")

    _p_index_fill_ = _p_index_fill

    def _p_index_add(self, env, node, args):
        return self._scatter(env, node, args[0], args[3], "add")

    _p_index_add_ = _p_index_add

    def _p_masked_fill(self, env, node, args):
        return self._scatter(env, node, args[0], args[2], "set")

    _p_masked_fill_ = _p_masked_fill

    def _p_threefry2x32(self, env, node, args):
        return [IV(0, 0xFFFFFFFF, True), IV(0, 0xFFFFFFFF, True)]


# An uninitialised buffer (``empty``) holds no value until written: the
# empty interval, which a write's hull replaces and a read makes the top.
_EMPTY = IV(_INF, -_INF, True)


def _filled(iv: IV, d) -> IV:
    return iv if iv.lo <= iv.hi else _top_of(d)


def _dim0(node) -> bool:
    dim = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim", 0)
    return dim == 0


def _keeps_dim0(node) -> bool:
    """A view whose leading dimension is its input's (a slice or a
    reshape of the trailing dimensions)."""
    name = _name(node)
    if name == "slice":
        return len(node.args) > 1 and node.args[1] not in (0,) and \
            _shape(node)[:1] == _shape(node.args[0])[:1]
    if name in ("view", "_unsafe_view", "reshape", "unflatten", "alias"):
        a = node.args[0]
        return isinstance(a, torch.fx.Node) and \
            _shape(node)[:1] == _shape(a)[:1] and len(_shape(a)) > 1
    return False


def _written_row(written) -> Optional[int]:
    """The dim-0 row of the buffer an in-place node wrote (through
    ``unbind(buf)[j]`` or ``select(buf, 0, j)``), None if not one row."""
    if not isinstance(written, torch.fx.Node) or not written.args:
        return None
    v = written.args[0]
    for _ in range(8):
        if not isinstance(v, torch.fx.Node) or v.op != "call_function":
            return None
        if v.target is g._getitem and isinstance(v.args[0], torch.fx.Node) \
                and _name(v.args[0]) == "unbind" and _dim0(v.args[0]):
            return v.args[1]
        if _name(v) == "select" and v.args[1] == 0:
            return v.args[2]
        if _name(v) in ("view", "slice", "unsqueeze", "expand"):
            v = v.args[0]
            continue
        return None
    return None


_LT = lambda x, y: x < y  # noqa: E731
_LE = lambda x, y: x <= y  # noqa: E731
_GT = lambda x, y: x > y  # noqa: E731
_GE = lambda x, y: x >= y  # noqa: E731
_EQ = lambda x, y: x == y  # noqa: E731
_NE = lambda x, y: x != y  # noqa: E731
# Calls whose values are their first operand's (views, copies, gathers).
_PASS = frozenset({
    "view", "reshape", "_unsafe_view", "unsqueeze", "squeeze", "expand",
    "expand_as", "select", "slice", "permute", "transpose", "t", "clone",
    "contiguous", "alias", "detach", "flatten", "unflatten", "narrow",
    "diagonal", "index", "index_select", "gather", "take_along_dim",
    "roll", "flip", "repeat", "unbind", "split", "chunk", "movedim",
    "as_strided", "lift_fresh_copy", "take", "split_with_sizes",
    "unsafe_split", "view_as", "index_copy",
})
_CMP = frozenset({"isnan", "isinf", "isfinite", "isneginf", "isposinf"})
_BOOL = frozenset({"any", "all", "logical_xor"})


# ---------------------------------------------------------------------------
# The carry fixpoint
# ---------------------------------------------------------------------------


def _carry_in(gm, carry: list, base: list) -> list:
    ins = list(base)
    for i, iv in enumerate(carry):
        ins[i] = iv
    return ins


def _outs(gm, env) -> list:
    out = []
    for n in g.output_nodes(gm):
        v = env.get(n) if isinstance(n, torch.fx.Node) else None
        if isinstance(n, torch.fx.Node) and n.op == "placeholder":
            v = env.get(n)
        out.append(v if isinstance(v, IV) else _top_of(
            _dtype(n) if isinstance(n, torch.fx.Node) else None))
    return out


def _fixpoint(interp: _Interp, gm, in_ivs: list) -> list:
    """The state planes' entry-fixpoint intervals (the reference's
    ``_eval_scan`` widening, with the tick's trip count)."""
    tick = gm.tick
    ns = tick.n_state if tick.carried else 0
    if not ns:
        return []
    length = max(int(tick.steps), 1)
    ins = g.input_nodes(gm)
    dts = [_dtype(ins[i]) for i in range(ns)]
    carry = [in_ivs[i] if in_ivs[i] is not None and in_ivs[i].known
             else _top_of(dts[i]) for i in range(ns)]
    history = [list(carry)]
    converged = False
    for _ in range(_SCAN_FIX_ITERS):
        outs = _outs(gm, interp.run(gm, _carry_in(gm, carry, in_ivs)))
        nxt = [c.hull(outs[i]) for i, c in enumerate(carry)]
        if all(c.contains(x) for c, x in zip(carry, nxt)):
            converged = True
            break
        carry = nxt
        history.append(nxt)
    if not converged and len(history) >= 3:
        c1, c2 = history[-2], history[-1]
        deltas = [(a.lo - b.lo, b.hi - a.hi) for a, b in zip(c1, c2)]
        noisy, interp.noisy = interp.noisy, False
        interp.saturate = True
        # Extrapolate the per-tick growth over the trip count and verify
        # it at the widened carry; a plane whose growth there exceeds the
        # delta is widened again with the growth it showed (the state
        # planes feed each other, so the first delta can be a tick
        # early), up to _WIDEN_ROUNDS times, then falls to the top.
        pending = set(range(len(c2)))
        stable = list(c2)
        for _ in range(_WIDEN_ROUNDS):
            widened = []
            for i, (b, (dl, dh), d) in enumerate(zip(c2, deltas, dts)):
                if not b.known:
                    widened.append(_top_of(d))
                    continue
                iv = IV(b.lo - dl * max(length - 2, 0),
                        b.hi + dh * max(length - 2, 0), True)
                if _is_int(d):
                    lo_d, hi_d = _int_range(d)
                    iv = IV(max(iv.lo, lo_d), min(iv.hi, hi_d), True)
                widened.append(iv)
            outs = _outs(gm, interp.run(gm, _carry_in(gm, widened,
                                                      in_ivs)))
            again = set()
            for i in pending:
                w, o, (dl, dh), c0 = (widened[i], outs[i], deltas[i],
                                      history[0][i])
                if w.contains(o):
                    stable[i] = c0.hull(o)
                elif (o.lo >= w.lo - max(dl, 0) - 1
                      and o.hi <= w.hi + max(dh, 0) + 1):
                    stable[i] = w.hull(o)
                elif o.known and w.known:
                    deltas[i] = (max(dl, w.lo - o.lo), max(dh, o.hi - w.hi))
                    again.add(i)
                else:
                    stable[i] = _top_of(dts[i])
            for i in set(range(len(c2))) - pending:
                stable[i] = widened[i].hull(outs[i]) if not \
                    widened[i].contains(outs[i]) else stable[i]
            pending = again
            if not pending:
                break
        for i in pending:
            stable[i] = _top_of(dts[i])
        outs = _outs(gm, interp.run(gm, _carry_in(gm, stable, in_ivs)))
        carry = [c0.hull(outs[i]) if w.contains(outs[i]) else w
                 for i, (w, c0) in enumerate(zip(stable, history[0]))]
        interp.saturate = False
        interp.noisy = noisy
    return carry


# ---------------------------------------------------------------------------
# J8 and J9
# ---------------------------------------------------------------------------

_SHAPE_ONLY = frozenset({
    "view", "reshape", "_unsafe_view", "unsqueeze", "squeeze", "expand",
    "clone", "contiguous", "alias", "detach", "_to_copy", "slice",
    "permute", "transpose", "broadcast_tensors",
})


def _key_of(word) -> Optional[torch.fx.Node]:
    """The key a threefry word operand was read from: up through shape-only
    calls to ``key[..., 0|1]``, then up through shape-only calls again."""
    n = word
    for _ in range(16):
        if not isinstance(n, torch.fx.Node) or n.op != "call_function":
            return None
        name = _name(n)
        if name == "select":
            src = n.args[0]
            nd = len(_shape(src))
            if n.args[1] in (-1, nd - 1):
                k = src
                for _ in range(16):
                    if isinstance(k, torch.fx.Node) and \
                            k.op == "call_function" and \
                            _name(k) in _SHAPE_ONLY:
                        k = k.args[0]
                    else:
                        break
                return k
            return None
        if name in _SHAPE_ONLY or name == "index":
            n = n.args[0]
            continue
        return None
    return None


def _threefry_kind(node) -> str:
    fns = [f for file, _, f in node.meta.get("stack") or ()
           if file.endswith("ops/threefry.py")]
    if fns and fns[-1] == "fold_in":
        return "fold"
    if "split" in fns:
        return "split"
    return "draw"


def _draw_site(node) -> str:
    """``file:line`` of the call that asked for a threefry block: the
    innermost frame outside the generator's own modules."""
    stack = [f for f in node.meta.get("stack") or ()
             if not f[0].endswith(_WRAP_FILES)]
    return g._site(stack) or g.where(node)


def _check_keys(interp: _Interp, gm) -> None:
    if "J8" not in interp.rules:
        return
    uses: dict = {}
    key_inputs = {n for n in g.input_nodes(gm)
                  if _dtype(n) == torch.int64 and _shape(n)[-1:] == (2,)}
    for n in gm.graph.nodes:
        if getattr(n.target, "__name__", "") != "threefry2x32":
            continue
        key = _key_of(n.args[0])
        if key is None:
            continue
        kind = _threefry_kind(n)
        uses.setdefault(key, {}).setdefault(kind, []).append(n)
        if kind == "draw" and key in key_inputs:
            interp.report(
                n, "J8",
                "draw from the scan key itself: every tick sees the same "
                "stream (fold_in the tick first)", where=_draw_site(n))
    for key, kinds in uses.items():
        draws, splits = kinds.get("draw", []), kinds.get("split", [])
        if len(draws) >= 2:
            interp.report(draws[1], "J8",
                          "threefry key consumed by two draw sites — the "
                          "second draw replays the first one's stream "
                          "(split the key or fold_in a distinct salt)",
                          where=_draw_site(draws[1]))
        if len(splits) >= 2:
            interp.report(splits[1], "J8",
                          "threefry key split twice — both splits derive "
                          "the SAME children (split once)",
                          where=_draw_site(splits[1]))
        if draws and splits and len(draws) < 2 and len(splits) < 2:
            interp.report(draws[0], "J8",
                          "threefry key drawn from after being split — the "
                          "draw correlates with the split's children",
                          where=_draw_site(draws[0]))


_SCATTERS = {
    # name -> (operand position, index position, dim position or None)
    "scatter": (0, 2, 1), "scatter_": (0, 2, 1), "scatter_add": (0, 2, 1),
    "scatter_add_": (0, 2, 1), "scatter_reduce": (0, 2, 1),
    "scatter_reduce_": (0, 2, 1), "index_fill": (0, 2, 1),
    "index_fill_": (0, 2, 1), "index_add": (0, 2, 1),
    "index_add_": (0, 2, 1), "index_put": (0, 1, None),
    "index_put_": (0, 1, None), "index_copy": (0, 2, 1),
}


def _bool_ancestors(node, limit: int = 4000) -> list:
    out, stack, seen = [], [node], set()
    while stack and len(seen) < limit:
        v = stack.pop()
        if not isinstance(v, torch.fx.Node) or v in seen:
            continue
        seen.add(v)
        if _dtype(v) == torch.bool:
            out.append(v)
        stack.extend(v.all_input_nodes)
    return out


def _check_drops(interp: _Interp, gm, env) -> None:
    if "J9" not in interp.rules:
        return
    outset = {n for n in g.output_nodes(gm) if isinstance(n, torch.fx.Node)}
    for n in gm.graph.nodes:
        spec = _SCATTERS.get(_name(n)) if n.op == "call_function" else None
        if spec is None:
            continue
        op_pos, idx_pos, dim_pos = spec
        if len(n.args) <= idx_pos:
            continue
        idx = n.args[idx_pos]
        base_shape = _shape(n.args[op_pos])
        idx_nodes = [i for i in (idx if isinstance(idx, (list, tuple))
                                 else [idx]) if isinstance(i, torch.fx.Node)]
        if not idx_nodes or not base_shape:
            continue
        dim = n.args[dim_pos] if dim_pos is not None and \
            len(n.args) > dim_pos else 0
        size = base_shape[dim] if isinstance(dim, int) and \
            -len(base_shape) <= dim < len(base_shape) else base_shape[0]
        ivs = [env.get(i) for i in idx_nodes]
        if all(isinstance(iv, IV) and iv.known and 0 <= iv.lo
               and iv.hi <= size - 2 for iv in ivs):
            continue  # no index can reach the dropped sentinel slot
        masks = [m for i in idx_nodes for m in _bool_ancestors(i)]
        if not masks:
            continue
        if _reaches(masks, n, outset):
            continue
        interp.report(
            n, "J9",
            f"{_name(n)} can drop masked units (its index may reach the "
            "sentinel slot) and no value derived from its mask reaches the "
            "tick's outputs — a silent drop; count it into a carried "
            "counter (offered == delivered + dropped)")


def _reaches(masks, skip, outset) -> bool:
    stack, seen = list(masks), set()
    while stack:
        v = stack.pop()
        if v in seen:
            continue
        seen.add(v)
        if v in outset:
            return True
        for u in v.users:
            if u is skip or u.op == "output":
                if u.op == "output":
                    return True
                continue
            stack.append(u)
    return False


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _flatten_bounds(args, bounds) -> list:
    flat_args = pytree.tree_leaves(args)
    if bounds is None:
        return [None] * len(flat_args)
    flat_bounds = pytree.tree_leaves(
        bounds, is_leaf=lambda x: isinstance(x, Bound))
    if len(flat_bounds) != len(flat_args):
        raise ValueError(
            f"bounds pytree has {len(flat_bounds)} leaves, args have "
            f"{len(flat_args)} — they must be congruent")
    return [b if isinstance(b, Bound) else None for b in flat_bounds]


def analyze_program(program: str, traced, *,
                    bounds: Optional[list] = None,
                    leaf_names: Optional[list] = None,
                    rules: Optional[Iterable[str]] = None) -> RangeReport:
    """Run the interval interpreter over one traced program (a tick graph
    or the list of its branches).  ``bounds`` is a flat list aligned with
    the graph's inputs of :class:`Bound`/None; ``leaf_names`` defaults to
    the trace's own."""
    active = frozenset(rules) if rules is not None else frozenset(RULES)
    unknown = active - set(RULES)
    if unknown:
        raise ValueError(
            f"unknown rule(s) {sorted(unknown)}; known: {sorted(RULES)}")
    graphs = traced if isinstance(traced, (list, tuple)) else [traced]
    interp = _Interp(program, active)
    fixes: Optional[list] = None
    gm0 = graphs[0]
    n_in = len(g.input_nodes(gm0))
    bounds = list(bounds or [None] * n_in)
    bounds += [None] * (n_in - len(bounds))
    in_ivs = [IV(b.lo, b.hi, True) if b is not None and b.known else None
              for b in bounds]
    for gm in graphs:
        interp.constants = gm.tick.constants
        fix = _fixpoint(interp, gm, in_ivs)
        final = interp.run(gm, _carry_in(gm, fix, in_ivs))
        _check_keys(interp, gm)
        _check_drops(interp, gm, final)
        fixes = fix if fixes is None else [a.hull(b) for a, b in
                                           zip(fixes, fix)]
    names = list(leaf_names or gm0.tick.inputs)
    certs: list = []
    if "J7" in active:
        for i, iv in enumerate(fixes or []):
            m = gm0.tick.input_meta[i]
            if m is None or not _is_signed(m.dtype):
                continue
            if not iv.known or iv.lo == -_INF or iv.hi == _INF:
                continue
            minimal = minimal_signed_dtype(iv.lo, iv.hi)
            if minimal is None:
                continue
            elements = _numel(m.shape)
            min_size = getattr(torch, minimal).itemsize
            certs.append(NarrowingCertificate(
                program=program, plane=names[i],
                dtype=str(m.dtype).replace("torch.", ""), lo=int(iv.lo),
                hi=int(iv.hi), minimal=minimal, elements=elements,
                bytes_now=elements * m.dtype.itemsize,
                bytes_minimal=elements * min_size))
    return RangeReport(findings=interp.findings, certificates=certs)


def analyze_spec(name: str, spec, traced=None,
                 rules: Optional[Iterable[str]] = None) -> RangeReport:
    """Trace and analyze one ``SimProgram`` with its bound metadata.  Pass
    ``traced`` (a graph or the list of its branches) to reuse a trace
    another pass made (``cli check`` traces each program once)."""
    if traced is None:
        try:
            traced = spec.traces()
        except g.Untraceable as e:
            return RangeReport(findings=[Finding(
                name, "J7", f"the tick cannot be traced: {e.reason}",
                where=e.where)], certificates=[])
    bounds = None
    bound_fn = getattr(spec, "bounds", None)
    if bound_fn is not None:
        gm = traced[0] if isinstance(traced, (list, tuple)) else traced
        _, make_args = spec.build()
        with torch.device("meta"):
            args = make_args(torch.device("meta"))
        bounds = _flatten_bounds(args, bound_fn())
        del gm
    return analyze_program(name, traced, bounds=bounds, rules=rules)


def lint_registry(programs: dict,
                  rules: Optional[Iterable[str]] = None) -> tuple:
    """Analyze a registry of SimProgram specs.  Returns (findings,
    {program: [NarrowingCertificate, ...]})."""
    findings: list = []
    certs: dict = {}
    for name, spec in programs.items():
        rep = analyze_spec(name, spec, rules=rules)
        findings.extend(rep.findings)
        certs[name] = rep.certificates
    return findings, certs


def narrowing_ledger(spec, at_n: int) -> RangeReport:
    """The 10M-node reading: re-trace ``spec`` through its ``scale`` hook
    at population ``at_n`` and analyze it."""
    scale = getattr(spec, "scale", None)
    if scale is None:
        raise ValueError(f"{spec.name} has no scale hook")
    return analyze_spec(f"{spec.name}@n={at_n}", scale(at_n))


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="rangelint",
        description="interval-domain abstract interpretation over one tick "
                    "of each registered program (J7 overflow + narrowing "
                    "certificates, J8 key lineage, J9 loud accounting; "
                    "fake tensors only)")
    parser.add_argument("--rules", default="",
                        help="comma-separated rule ids (default: all)")
    parser.add_argument("--list-rules", action="store_true",
                        dest="list_rules")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--set", choices=("small", "big", "all"),
                        default="all", dest="which")
    parser.add_argument("--at-n", type=int, default=0, dest="at_n",
                        help="additionally read the narrowing ledger at "
                             "this population via the registry's scale "
                             "hooks (e.g. 10000000)")
    args = parser.parse_args(argv)
    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0
    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    try:
        from consul_tpu_torch.sim.registry import jaxlint_registry

        include = (("small", "big") if args.which == "all"
                   else (args.which,))
        programs = jaxlint_registry(include=include)
        findings, certs = lint_registry(programs, rules=rules)
        ledgers = {}
        if args.at_n:
            for name, spec in programs.items():
                if getattr(spec, "scale", None) is None:
                    continue
                rep = narrowing_ledger(spec, args.at_n)
                ledgers[name] = rep
                findings.extend(rep.findings)
    except ValueError as e:
        print(f"rangelint: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_json() for f in findings],
            "programs": len(programs),
            "certificates": {n: [c.to_json() for c in cs]
                             for n, cs in certs.items() if cs},
            "ledger": {n: [c.to_json() for c in rep.certificates]
                       for n, rep in ledgers.items()},
        }))
    else:
        for f in findings:
            print(f.format())
        shown = 0
        for n, cs in sorted(certs.items()):
            for c in cs:
                if c.saved_bytes > 0 and shown < 40:
                    print(f"rangelint: {n}: {c.plane} {c.dtype} "
                          f"[{c.lo}, {c.hi}] -> {c.minimal} (saves "
                          f"{format_bytes(c.saved_bytes)}/copy)",
                          file=sys.stderr)
                    shown += 1
    if findings:
        print(f"rangelint: {len(findings)} finding(s) in "
              f"{len(programs)} program(s)", file=sys.stderr)
        return 1
    if args.format != "json":
        print(f"rangelint: clean ({len(programs)} program(s))",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
