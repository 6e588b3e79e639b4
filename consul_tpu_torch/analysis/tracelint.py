"""tracelint: a static pass over the port's simulation plane.

The port of ``consul_tpu/analysis/tracelint.py``.  A study of the port is
a Python loop over eager ATen calls, so the regressions the reference's
AST pass keeps out of its ``lax.scan`` bodies cost the port a stalled
launch queue, a wider tensor or another study: a Python branch on a
tensor's value (a host read), a silent int64/float64, a draw from the
global generator, a boolean mask (a data-dependent shape, itself a host
read), in-place writes into the state a tick was handed.  This module is
that discipline, mechanized over ``models/ sim/ ops/ parallel/
streamcast/ geo/ sweep/ obs/``.

Which functions count as *traced code* (the tick functions):

  * functions named ``*_round``;
  * functions whose signature declares a tensor parameter, an annotation
    mentioning ``torch.Tensor`` or a state type ending in ``State``: the
    rounds, the ``*_scan`` bodies the engine loops over and their helpers;
  * any function nested inside one of the above.

Inside traced code a forward taint pass marks every local derived from a
tensor parameter; parameters annotated ``int``/``float``/``*Config``/...
stay untainted, and so do a tensor's metadata (``.shape``, ``.dtype``,
``.device``, ``.dim()``, ``.numel()``, ``len()``), so ``if cfg.delivery
== "edges"`` and ``if x.dim() == 1`` never fire while ``if state.tick >
0`` does.

Rules (``--list-rules`` prints this table):

  R1  python-branch-on-traced   ``if``/``while``/``assert``/ternary on a
                                tensor's value (a host read per tick)
  R2  host-sync                 ``.item()``/``.tolist()``/``.cpu()``/
                                ``.numpy()``/``np.asarray()``/``bool()``/
                                ``int()``/``float()`` of a tensor, and
                                ``host_cond()``, the port's counted read
  R3  dtype-discipline          ``torch.zeros|ones|full|empty|arange|
                                tensor|as_tensor`` without ``dtype=``, or
                                any 64-bit dtype (``torch.int64``,
                                ``torch.float64``, ...) outside the
                                declared sites of :data:`DECLARED_64BIT`
  R4  impure-call               ``torch.rand*``/``randint``/``bernoulli``/
                                ``multinomial``/``normal``/``.normal_()``
                                without ``generator=``, ``time.*``,
                                ``random.*``, ``np.random.*`` in tick code:
                                the port's draws are threefry, and the
                                global generator would be another study
  R5  bad-cache-args            a cached builder (``functools.lru_cache``,
                                ``sweep/universe._make_sweep``) called with
                                an unhashable or per-call argument
  R6  boolean-indexing          ``x[mask]``, ``nonzero``, ``argwhere``,
                                ``masked_select``, ``unique`` or one-argument
                                ``torch.where``: a data-dependent shape
  R7  python-loop-over-traced   ``for`` over a tensor
  R8  state-mutation            an in-place write (``x[i] = ...``,
                                ``x.add_(...)``, ``x.copy_(...)``) into a
                                tensor the tick was handed, or a view of
                                one: a round never writes into its input
  R9  kw-cache-call             an argument of a cached builder passed by
                                keyword: ``lru_cache`` keys keyword and
                                positional calls apart, so each spelling
                                builds its own program

Suppression: append ``# tracelint: disable=R3 (why)`` to the line, with
the reason in the parentheses (or after ``--``).  A suppression without a
reason suppresses nothing.  The runtime complement, counting the builds
the port caches, lives in :mod:`consul_tpu_torch.analysis.guards`.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import re
import sys
from pathlib import Path
from typing import Iterable, Optional

RULES: dict[str, str] = {
    "R1": "python-branch-on-traced: `if`/`while`/`assert`/ternary on a "
          "tensor's value reads it on the host every tick (use "
          "torch.where)",
    "R2": "host-sync: .item()/.tolist()/.cpu()/.numpy()/bool()/int()/"
          "float() of a tensor, or host_cond(), inside tick code stalls "
          "the launch queue",
    "R3": "dtype-discipline: tensor constructor without dtype=, or a "
          "64-bit dtype outside the declared sites",
    "R4": "impure-call: the global generator, time.*/random.*/np.random.* "
          "inside tick code (the port's draws are threefry)",
    "R5": "bad-cache-args: a cached builder called with an unhashable or "
          "per-call argument misses its cache every call",
    "R6": "boolean-indexing: data-dependent shapes (x[mask], nonzero, "
          "masked_select) read the size on the host — use "
          "torch.where(mask, a, b) / masked reductions",
    "R7": "python-loop-over-traced: `for` over a tensor unrolls one "
          "launch set per element",
    "R8": "state-mutation: an in-place write into a tensor the tick was "
          "handed (a round never writes into its input)",
    "R9": "kw-cache-call: an argument of a cached builder passed by "
          "keyword — lru_cache keys keyword and positional calls apart",
}

# The port's deliberate 64-bit sites (ROADMAP Queue 3), by file and
# function, each with its reason: R3 and J2 stay quiet here and fire
# anywhere new.  A function of "*" covers the whole file.
_INDEX = ("ATen indices: gather, scatter, index_put, index_select and sort "
          "take or give int64")
_F64 = "XLA's fused multiply-add rounds once: the port takes it in float64"


def _index_sites(*functions: str) -> dict:
    return dict.fromkeys(functions, _INDEX)


DECLARED_64BIT: dict[str, dict[str, str]] = {
    "ops/threefry.py": {
        "*": "threefry keys and draws are uint32 words held in int64: "
             "PyTorch has no uint32 +, << or >> on the CPU",
    },
    "ops/xla_math.py": {"*": _F64},
    "device.py": {
        "device_scalar": "a Python int staged at the caller's dtype, int64 "
                         "for threefry words and ATen indices",
    },
    "models/swim.py": {
        "timeout_table": _F64, "traced_timeout_table": _F64,
        **_index_sites("timeout_ticks_of", "swim_round"),
    },
    "geo/model.py": {
        "lan_arrivals": "1 - exp(-lam) rounded once, taken in float64",
        **_index_sites("_ring_slots", "geo_constants", "geo_init",
                       "geo_round", "link_plane", "merge"),
    },
    "sim/faults.py": {
        "_link_mask": "segment ids, compared once a study with a "
                      "schedule's selectors",
    },
    "sim/load.py": {
        "standing_backlog": "event positions, compared with the backlog",
    },
    "sweep/universe.py": {
        "keys": "the universes' ids folded into threefry keys",
    },
    "models/broadcast.py": _index_sites("spend_budget"),
    "models/lifeguard.py": _index_sites("lifeguard_round"),
    "models/multidc.py": _index_sites("multidc_round"),
    "models/membership.py": _index_sites(
        "_set_cols", "finish_round", "gossip_stage", "membership_round",
        "push_pull_draws", "push_pull_full", "row_of", "scatter_cells",
        "spend_gossip", "table_at", "take_rows", "top_slots"),
    "models/membership_sparse.py": _index_sites(
        "_merge_step", "_view_of", "densify", "sparse_finish_round",
        "sparse_gossip_stage", "sparse_spend"),
    "obs/spec.py": _index_sites("shard_keep"),
    "ops/compact.py": _index_sites("compact_to_budget"),
    "ops/scatter.py": _index_sites("_masked_targets"),
    "ops/sortmerge.py": _index_sites(
        "_allocate_and_merge", "_first_of_group", "_group_sum",
        "_insert_rows_one", "_lexsort2", "_merge_into_rows",
        "_segmented_max3", "_segmented_sum", "flat", "merge_into_rows",
        "row_base", "row_locate_lo"),
    "parallel/shard.py": _index_sites(
        "_global_initiators", "_mark", "_owned_legs", "_route_and_exchange",
        "_rows", "exchange", "exchange_phase_walls", "merge", "pack_outbox",
        "per_shard", "sharded_broadcast_scan", "sharded_geo_scan",
        "sharded_membership_plan", "sharded_membership_round",
        "sharded_sparse_membership_round", "sharded_streamcast_scan"),
    "sim/engine.py": _index_sites("membership_scan"),
    "streamcast/model.py": _index_sites(
        "admit_stage", "chunk_index", "chunk_validity", "finish_stage",
        "select_chunk", "streamcast_round"),
    "streamcast/window.py": _index_sites("admit"),
}


_LINES: dict = {}


def suppressed_at(where: str, rule: str) -> bool:
    """Whether the source line ``where`` (``path:line``, relative to the
    repository or absolute) carries a reasoned ``# tracelint: disable``
    of ``rule``: the graph passes' findings honour the same comments."""
    path, _, line = where.rpartition(":")
    if not path or not line.isdigit():
        return False
    p = Path(path)
    if not p.is_absolute():
        p = Path(__file__).resolve().parents[2] / p
    if p not in _LINES:
        try:
            _LINES[p] = _ModuleLinter._suppressions(p.read_text())
        except OSError:
            _LINES[p] = {}
    rules = _LINES[p].get(int(line), ())
    return rules is None or rule in rules


def declared_64bit(file: str, function: str) -> Optional[str]:
    """The reason a 64-bit value is deliberate in ``function`` of ``file``
    (a path ending in the package-relative name), None if it is not."""
    for rel, sites in DECLARED_64BIT.items():
        if file == rel or file.endswith("/" + rel):
            return sites.get(function) or sites.get("*")
    return None


# Tensor constructors that must pin a dtype.
_CTORS = frozenset({
    "torch.zeros", "torch.ones", "torch.full", "torch.empty",
    "torch.arange", "torch.tensor", "torch.as_tensor",
})
_WIDE_DTYPES = frozenset(
    [f"torch.{n}" for n in ("int64", "long", "float64", "double", "uint64",
                            "complex128", "cdouble")]
    + [f"numpy.{n}" for n in ("int64", "float64", "uint64", "complex128",
                              "longdouble")]
)
_HOST_SYNC_BUILTINS = frozenset({"float", "int", "bool", "complex"})
_HOST_SYNC_FUNCS = frozenset({"numpy.asarray", "numpy.array"})
_HOST_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
# The port's counted host read (ops/sortmerge.host_cond).
_HOST_COND = "host_cond"
_RANDOM_FUNCS = frozenset({
    "torch.rand", "torch.rand_like", "torch.randn", "torch.randn_like",
    "torch.randint", "torch.randint_like", "torch.randperm",
    "torch.bernoulli", "torch.multinomial", "torch.normal",
    "torch.poisson",
})
_RANDOM_METHODS = frozenset({
    "normal_", "uniform_", "random_", "exponential_", "bernoulli_",
    "geometric_", "log_normal_", "cauchy_",
})
_IMPURE_EXACT = frozenset({"os.urandom", "id", "input"})
_IMPURE_PREFIXES = (
    "time.", "random.", "numpy.random.", "datetime.", "uuid.", "secrets.",
)
_DYNAMIC_SHAPE_FUNCS = frozenset({
    "torch.nonzero", "torch.argwhere", "torch.masked_select",
    "torch.unique", "torch.unique_consecutive",
})
_DYNAMIC_SHAPE_METHODS = frozenset({"nonzero", "masked_select", "unique",
                                    "argwhere"})
_STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda",
                           "layout", "itemsize"})
_STATIC_METHODS = frozenset({
    "dim", "size", "numel", "element_size", "stride", "is_contiguous",
    "nelement", "data_ptr", "storage_offset", "get_device",
})
# Methods that return a view of their tensor (R8 follows aliases).
_VIEW_METHODS = frozenset({
    "view", "reshape", "unbind", "select", "narrow", "expand", "transpose",
    "permute", "squeeze", "unsqueeze", "flatten", "view_as", "expand_as",
    "movedim", "unflatten", "split", "chunk", "diagonal", "t",
})
_INPLACE_METHODS = frozenset({
    "add_", "sub_", "mul_", "div_", "copy_", "fill_", "zero_",
    "index_put_", "index_fill_", "index_copy_", "index_add_", "scatter_",
    "scatter_add_", "scatter_reduce_", "masked_fill_", "masked_scatter_",
    "clamp_", "clamp_min_", "clamp_max_", "bitwise_and_", "bitwise_or_",
    "bitwise_xor_", "logical_and_", "logical_or_", "put_", "set_",
    "resize_", "maximum_", "minimum_", "neg_", "abs_",
})

_SUPPRESS_RE = re.compile(
    r"#\s*tracelint:\s*disable(?:=(?P<rules>[A-Z0-9,\s]+?))?"
    r"\s*(?:\((?P<why>[^)]+)\)|--\s*(?P<why2>\S.*))?\s*$"
)


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col} {self.rule} {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` as a string, or None for non-name expressions."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _ann_str(node: Optional[ast.AST]) -> str:
    if node is None:
        return ""
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - malformed annotation
        return ""


_TRACED_ANN_TOKENS = ("torch.Tensor", "Tensor")
_STATIC_ANN_RE = re.compile(
    r"^(Optional\[)?(int|float|bool|str|bytes|tuple|list|dict|frozenset|"
    r"[A-Za-z_.]*(Config|Profile|Schedule|Callable|device|dtype))\b"
)


def _annotation_kind(ann: str) -> str:
    """'traced' | 'static' | 'unknown' for a parameter annotation."""
    if not ann:
        return "unknown"
    if any(tok in ann for tok in _TRACED_ANN_TOKENS):
        return "traced"
    if re.search(r"State\b", ann):
        return "traced"
    if "np.ndarray" in ann or "numpy.ndarray" in ann:
        return "static"
    if _STATIC_ANN_RE.match(ann):
        return "static"
    return "unknown"


class _Imports:
    """Alias resolution: ``np.int64`` -> ``numpy.int64`` etc."""

    def __init__(self, tree: ast.Module):
        self.alias: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.alias[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.level:
                    continue
                for a in node.names:
                    self.alias[a.asname or a.name] = (
                        f"{node.module}.{a.name}"
                    )

    def resolve(self, dotted: Optional[str]) -> Optional[str]:
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        base = self.alias.get(head, head)
        return f"{base}.{rest}" if rest else base


class _Reporter:
    def __init__(self, path: str, rules: frozenset[str],
                 suppressions: dict[int, Optional[set[str]]]):
        self.path = path
        self.rules = rules
        self.suppressions = suppressions
        self._seen: set[tuple[int, int, str]] = set()
        self.violations: list[Violation] = []

    def report(self, node: ast.AST, rule: str, message: str) -> None:
        if rule not in self.rules:
            return
        line = getattr(node, "lineno", 0)
        col = getattr(node, "col_offset", 0) + 1
        if line in self.suppressions:
            suppressed = self.suppressions[line]
            if suppressed is None or rule in suppressed:
                return
        key = (line, col, rule)
        if key in self._seen:
            return
        self._seen.add(key)
        self.violations.append(Violation(self.path, line, col, rule,
                                         message))


def _is_structural_test(node: ast.expr) -> bool:
    """Tests of Python structure, not tensor values: ``x is None``,
    ``isinstance(x, T)``, ``hasattr``, ``len``, ``is_knob``."""
    if isinstance(node, ast.Compare):
        return all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops)
    if isinstance(node, ast.Call):
        fn = _dotted(node.func)
        return fn in ("isinstance", "hasattr", "callable", "len", "is_knob",
                      "torch.is_tensor")
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        return _is_structural_test(node.operand)
    if isinstance(node, ast.BoolOp):
        return all(_is_structural_test(v) for v in node.values)
    return False


class _FunctionLinter:
    """Forward taint pass + rule checks over one traced function."""

    def __init__(self, fn, imports: _Imports, reporter: _Reporter,
                 outer_taint: dict[str, bool], outer_alias: frozenset,
                 static_params: frozenset[str], mod: "_ModuleLinter",
                 nested: bool = False):
        self.fn = fn
        self.imports = imports
        self.reporter = reporter
        self.outer = outer_taint
        self.mod = mod
        self.tainted: set[str] = set()
        self.bool_masks: set[str] = set()
        self.static_containers: set[str] = set()
        # Names bound to a tensor the tick was handed (or a view of one).
        self.alias: set[str] = set(outer_alias)
        self.reporting = False
        self.static_params = static_params
        self._sequence_iters: set = set()
        for a in (*fn.args.posonlyargs, *fn.args.args,
                  *fn.args.kwonlyargs):
            if a.arg in static_params or a.arg in ("self", "cls"):
                continue
            ann = _ann_str(a.annotation)
            kind = _annotation_kind(ann)
            # A tick function's unannotated parameters are its
            # configuration and plans; a closure's are the values it is
            # handed inside the tick.
            if kind == "traced" or (kind == "unknown" and nested):
                self.tainted.add(a.arg)
            if re.match(r"^(list|tuple|Sequence|Iterable)\b", ann):
                self.static_containers.add(a.arg)
            if re.search(r"State\b", ann) or (
                    kind == "unknown" and a.arg == "state"
                    and fn.name.endswith("_round")):
                self.alias.add(a.arg)
                self.tainted.add(a.arg)

    # -- taint -----------------------------------------------------------

    def _name_tainted(self, name: str) -> bool:
        if name in self.tainted:
            return True
        if name in self.static_params:
            return False
        return self.outer.get(name, False)

    def taint(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return self._name_tainted(node.id)
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.taint(node.value)
        if isinstance(node, ast.Call):
            return self._taint_call(node)
        if isinstance(node, ast.Subscript):
            t = self.taint(node.value) or self.taint(node.slice)
            if self.reporting:
                self._check_bool_index(node)
            return t
        if isinstance(node, ast.IfExp):
            if self.reporting and self.taint(node.test) and not (
                _is_structural_test(node.test)
            ):
                self.reporter.report(
                    node, "R1",
                    "ternary on a tensor's value reads it on the host — "
                    "use torch.where",
                )
            return (self.taint(node.test) or self.taint(node.body)
                    or self.taint(node.orelse))
        if isinstance(node, ast.Lambda):
            sub = _FunctionLinter.__new__(_FunctionLinter)
            sub.__dict__.update(self.__dict__)
            sub.outer = self._env()
            sub.tainted = {a.arg for a in node.args.args}
            sub.bool_masks = set()
            sub.static_containers = set()
            sub.static_params = frozenset()
            sub.alias = set(self.alias)
            sub.taint(node.body)
            return False
        t = False
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                t = self.taint(child) or t
            elif isinstance(child, ast.comprehension):
                it = self.taint(child.iter)
                if (self.reporting and it
                        and id(child.iter) not in self._sequence_iters
                        and not self._is_static_container(child.iter)):
                    self.reporter.report(
                        child.iter, "R7",
                        "comprehension over a tensor — one launch set per "
                        "element (use a batched op)",
                    )
                t = it or t
        return t

    def _env(self) -> dict[str, bool]:
        env = dict(self.outer)
        for name in self.static_params:
            env[name] = False
        for name in self.tainted:
            env[name] = True
        return env

    def _taint_call(self, node: ast.Call) -> bool:
        resolved = self.imports.resolve(_dotted(node.func))
        if resolved in ("tuple", "list", "dict", "sum", "any", "all") and \
                node.args and isinstance(node.args[0], ast.GeneratorExp):
            # tuple(f(p) for p in planes): a sequence of tensors rebuilt.
            self._sequence_iters.update(
                id(g.iter) for g in node.args[0].generators)
        arg_taints = [self.taint(a) for a in node.args]
        kw_taints = [self.taint(k.value) for k in node.keywords]
        any_arg = any(arg_taints) or any(kw_taints)
        if self.reporting:
            self._check_call(node, resolved, any_arg)
        if resolved in ("len", "isinstance", "hasattr", "is_knob") or (
                _dotted(node.func) or "").endswith(_HOST_COND):
            # Structure, or a host bool already read (R2 reports it).
            return False
        if isinstance(node.func, ast.Attribute) and (
                node.func.attr in _STATIC_METHODS):
            self.taint(node.func.value)
            return False
        func_taint = (
            isinstance(node.func, ast.Attribute)
            and self.taint(node.func.value)
        ) or (
            isinstance(node.func, ast.Name)
            and self._name_tainted(node.func.id)
        )
        return any_arg or func_taint

    # -- rule checks -----------------------------------------------------

    def _check_call(self, node: ast.Call, resolved: Optional[str],
                    any_arg: bool) -> None:
        fn_name = _dotted(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        # R2: host syncs.
        if fn_name in _HOST_SYNC_BUILTINS and any_arg:
            self.reporter.report(
                node, "R2",
                f"{fn_name}() of a tensor reads it on the host — keep it on "
                "the device or return it from the scan",
            )
        elif resolved in _HOST_SYNC_FUNCS and any_arg:
            self.reporter.report(
                node, "R2",
                f"{resolved}() of a tensor copies it to the host inside "
                "tick code",
            )
        elif attr in _HOST_SYNC_METHODS and self.taint(node.func.value):
            self.reporter.report(
                node, "R2",
                f".{attr}() of a tensor is a host sync inside tick code",
            )
        elif (fn_name or "").split(".")[-1] == _HOST_COND:
            self.reporter.report(
                node, "R2",
                "host_cond() reads a device predicate on the host: only "
                "PERF.md section 2's syncs may (suppress with the reason)",
            )
        # R4: impurity.
        if resolved is not None:
            if resolved in _RANDOM_FUNCS and not any(
                    k.arg == "generator" for k in node.keywords):
                self.reporter.report(
                    node, "R4",
                    f"{resolved}() draws from the global generator — the "
                    "port's draws are threefry (ops/threefry.py)",
                )
            elif resolved in _IMPURE_EXACT or resolved.startswith(
                    _IMPURE_PREFIXES):
                self.reporter.report(
                    node, "R4",
                    f"{resolved}() inside tick code makes each run another "
                    "study — pass the value in, or draw from a threefry key",
                )
        if attr in _RANDOM_METHODS and not any(
                k.arg == "generator" for k in node.keywords):
            self.reporter.report(
                node, "R4",
                f".{attr}() draws from the global generator — the port's "
                "draws are threefry",
            )
        # R6: data-dependent output shapes.
        if resolved in _DYNAMIC_SHAPE_FUNCS or (
                attr in _DYNAMIC_SHAPE_METHODS
                and self.taint(node.func.value)):
            self.reporter.report(
                node, "R6",
                f"{resolved or attr}() has a data-dependent output shape "
                "(its size is read on the host) — use torch.where(mask, a, "
                "b) or a masked reduction",
            )
        elif resolved == "torch.where" and len(node.args) == 1:
            self.reporter.report(
                node, "R6",
                "one-argument torch.where is nonzero() in disguise — use "
                "the three-argument form",
            )
        # R8: in-place writes into a handed-in tensor.
        if attr in _INPLACE_METHODS and self._is_alias(node.func.value):
            self.reporter.report(
                node, "R8",
                f".{attr}() writes into a tensor the tick was handed — a "
                "round returns new planes (torch.where, clone first)",
            )

    def _is_alias(self, node: ast.expr) -> bool:
        """A tensor the tick was handed, or a view of one."""
        if isinstance(node, ast.Name):
            return node.id in self.alias
        if isinstance(node, ast.Attribute):
            return node.attr not in _STATIC_ATTRS and self._is_alias(
                node.value)
        if isinstance(node, ast.Subscript):
            return self._is_alias(node.value)
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            return (node.func.attr in _VIEW_METHODS
                    and self._is_alias(node.func.value))
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self._is_alias(e) for e in node.elts)
        return False

    def _check_bool_index(self, node: ast.Subscript) -> None:
        if not self.taint(node.value):
            return
        idx = node.slice
        boolish = (
            (isinstance(idx, ast.Compare)
             and not _is_structural_test(idx)
             and self.taint(idx))
            or (isinstance(idx, ast.UnaryOp)
                and isinstance(idx.op, (ast.Not, ast.Invert))
                and self.taint(idx))
            or (isinstance(idx, ast.BinOp)
                and isinstance(idx.op, (ast.BitAnd, ast.BitOr))
                and self.taint(idx) and self._is_mask(idx))
            or (isinstance(idx, ast.Name) and idx.id in self.bool_masks)
        )
        if boolish:
            self.reporter.report(
                node, "R6",
                "boolean-mask indexing gives a data-dependent shape — use "
                "torch.where(mask, a, b)",
            )

    def _is_mask(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.bool_masks
        if isinstance(node, ast.Compare):
            return True
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr)):
            return self._is_mask(node.left) or self._is_mask(node.right)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op,
                                                        ast.Invert):
            return self._is_mask(node.operand)
        return False

    # -- statement walk --------------------------------------------------

    def run(self) -> None:
        self.reporting = False
        self._visit_body(self.fn.body)
        self.reporting = True
        self._visit_body(self.fn.body)

    def _visit_body(self, stmts: list) -> None:
        for stmt in stmts:
            self._visit_stmt(stmt)

    def _bind(self, target: ast.expr, tainted: bool, boolish: bool,
              container: bool = False, alias: bool = False) -> None:
        if isinstance(target, ast.Name):
            (self.tainted.add if tainted else self.tainted.discard)(
                target.id)
            (self.bool_masks.add if boolish and tainted
             else self.bool_masks.discard)(target.id)
            (self.static_containers.add if container
             else self.static_containers.discard)(target.id)
            (self.alias.add if alias else self.alias.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, tainted, boolish, alias=alias)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, tainted, boolish, alias=alias)
        elif isinstance(target, (ast.Attribute, ast.Subscript)):
            if self.reporting and self._is_alias(target.value):
                kind = ("attribute" if isinstance(target, ast.Attribute)
                        else "subscript")
                self.reporter.report(
                    target, "R8",
                    f"in-place {kind} assignment writes into a tensor the "
                    "tick was handed — return a new plane (torch.where, "
                    "NamedTuple._replace)",
                )

    def _is_bool_expr(self, node: ast.expr) -> bool:
        return isinstance(node, (ast.Compare, ast.BoolOp)) or (
            isinstance(node, ast.UnaryOp)
            and isinstance(node.op, (ast.Not, ast.Invert))
        ) or self._is_mask(node)

    def _is_static_container(self, node: ast.expr) -> bool:
        if isinstance(node, (ast.List, ast.Tuple, ast.ListComp,
                             ast.SetComp, ast.DictComp)):
            return True
        if isinstance(node, ast.Call) and _dotted(node.func) in (
                "zip", "enumerate", "reversed", "sorted"):
            # Python structure of tensors (pytree plumbing), not a tensor.
            return True
        if isinstance(node, ast.Call) and _dotted(node.func) == "range":
            return not any(self.taint(a) for a in node.args)
        if isinstance(node, ast.BoolOp):
            return all(self._is_static_container(v) for v in node.values)
        return (isinstance(node, ast.Name)
                and node.id in self.static_containers)

    def _visit_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            t = self.taint(stmt.value)
            boolish = self._is_bool_expr(stmt.value)
            alias = self._is_alias(stmt.value)
            if (isinstance(stmt.value, ast.Tuple)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], (ast.Tuple, ast.List))
                    and len(stmt.targets[0].elts) == len(stmt.value.elts)):
                for tgt, val in zip(stmt.targets[0].elts, stmt.value.elts):
                    self._bind(tgt, self.taint(val),
                               self._is_bool_expr(val),
                               alias=self._is_alias(val))
            else:
                container = self._is_static_container(stmt.value)
                for tgt in stmt.targets:
                    self._bind(tgt, t, boolish, container=container,
                               alias=alias)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._bind(stmt.target, self.taint(stmt.value),
                           self._is_bool_expr(stmt.value),
                           alias=self._is_alias(stmt.value))
        elif isinstance(stmt, ast.AugAssign):
            t = self.taint(stmt.value) or self.taint(stmt.target)
            if self.reporting and self._is_alias(stmt.target):
                self.reporter.report(
                    stmt, "R8",
                    "augmented assignment writes in place into a tensor "
                    "the tick was handed — use x = x + y",
                )
            self._bind(stmt.target, t, False)
        elif isinstance(stmt, (ast.If, ast.While)):
            if (self.reporting and self.taint(stmt.test)
                    and not _is_structural_test(stmt.test)):
                kw = "if" if isinstance(stmt, ast.If) else "while"
                self.reporter.report(
                    stmt, "R1",
                    f"`{kw}` on a tensor's value reads it on the host every "
                    "tick — use torch.where (or host_cond where PERF.md "
                    "allows a sync)",
                )
            else:
                self.taint(stmt.test)
            self._visit_body(stmt.body)
            self._visit_body(stmt.orelse)
        elif isinstance(stmt, ast.Assert):
            if (self.reporting and self.taint(stmt.test)
                    and not _is_structural_test(stmt.test)):
                self.reporter.report(
                    stmt, "R1",
                    "`assert` on a tensor's value reads it on the host — "
                    "return a flag instead",
                )
            else:
                self.taint(stmt.test)
        elif isinstance(stmt, ast.For):
            iter_taint = self.taint(stmt.iter)
            report = iter_taint and not self._is_static_container(stmt.iter)
            if self.reporting and report:
                self.reporter.report(
                    stmt, "R7",
                    "`for` over a tensor — one launch set per element (use "
                    "a batched op)",
                )
            self._bind(stmt.target, iter_taint, False)
            self._visit_body(stmt.body)
            self._visit_body(stmt.orelse)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            sub = _FunctionLinter(
                stmt, self.imports, self.reporter, self._env(),
                frozenset(self.alias), self.mod._static_params(stmt),
                self.mod, nested=True)
            sub.reporting = False
            sub._visit_body(stmt.body)
            if self.reporting:
                sub.reporting = True
                sub._visit_body(stmt.body)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self.taint(stmt.value)
        elif isinstance(stmt, ast.Expr):
            self.taint(stmt.value)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                self.taint(item.context_expr)
            self._visit_body(stmt.body)
        elif isinstance(stmt, ast.Try):
            self._visit_body(stmt.body)
            for handler in stmt.handlers:
                self._visit_body(handler.body)
            self._visit_body(stmt.orelse)
            self._visit_body(stmt.finalbody)


class _ModuleLinter:
    def __init__(self, tree: ast.Module, source: str, path: str,
                 rules: frozenset[str]):
        self.tree = tree
        self.path = path
        self.imports = _Imports(tree)
        self.reporter = _Reporter(path, rules, self._suppressions(source))

    @staticmethod
    def _suppressions(source: str) -> dict[int, Optional[set[str]]]:
        """Line -> suppressed rules (None: all) of every suppression that
        states its reason."""
        out: dict[int, Optional[set[str]]] = {}
        for i, line in enumerate(source.splitlines(), start=1):
            m = _SUPPRESS_RE.search(line)
            if not m or not (m.group("why") or m.group("why2")):
                continue
            spec = m.group("rules")
            out[i] = (None if spec is None else
                      {r.strip() for r in spec.split(",") if r.strip()})
        return out

    def run(self) -> list[Violation]:
        self._collect_cached_builders()
        self._check_module_wide()
        for node in self.tree.body:
            self._lint_scope(node, function=None)
        return self.reporter.violations

    # -- R5/R9: cached builders ------------------------------------------

    def _collect_cached_builders(self) -> None:
        """Module functions under ``functools.lru_cache``/``cache``."""
        self.cached: set[str] = set()
        for node in self.tree.body:
            if not isinstance(node, ast.FunctionDef):
                continue
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if self.imports.resolve(_dotted(target)) in (
                        "functools.lru_cache", "functools.cache",
                        "lru_cache", "cache"):
                    self.cached.add(node.name)

    def _check_cache_call(self, node: ast.Call) -> None:
        if not (isinstance(node.func, ast.Name)
                and node.func.id in self.cached):
            return
        for a in [*node.args, *(k.value for k in node.keywords)]:
            if isinstance(a, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                              ast.DictComp, ast.SetComp, ast.Lambda,
                              ast.GeneratorExp)):
                self.reporter.report(
                    node, "R5",
                    f"{node.func.id}() is cached (lru_cache): a "
                    f"{type(a).__name__} argument is unhashable or new "
                    "every call, so the cache never hits",
                )
        for k in node.keywords:
            if k.arg is not None:
                self.reporter.report(
                    node, "R9",
                    f"argument {k.arg!r} of cached {node.func.id}() passed "
                    "by keyword — lru_cache keys keyword and positional "
                    "calls apart, so this spelling builds its own program "
                    "(pass it positionally)",
                )

    # -- traced-function discovery --------------------------------------

    def _static_params(self, fn) -> frozenset[str]:
        return frozenset(
            a.arg for a in (*fn.args.posonlyargs, *fn.args.args,
                            *fn.args.kwonlyargs)
            if _annotation_kind(_ann_str(a.annotation)) == "static")

    def _is_traced(self, fn) -> bool:
        if fn.name.endswith("_round"):
            return True
        return any(_annotation_kind(_ann_str(a.annotation)) == "traced"
                   for a in (*fn.args.posonlyargs, *fn.args.args,
                             *fn.args.kwonlyargs))

    def _lint_scope(self, node: ast.stmt, function) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if isinstance(node, ast.FunctionDef) and self._is_traced(node):
                _FunctionLinter(node, self.imports, self.reporter, {},
                                frozenset(), self._static_params(node),
                                self).run()
            else:
                for inner in node.body:
                    self._lint_scope(inner, node)
        elif isinstance(node, ast.ClassDef):
            for inner in node.body:
                self._lint_scope(inner, function)

    # -- module-wide checks (R3, R5, R9) --------------------------------

    def _functions(self):
        """node -> name of the innermost enclosing function."""
        owner: dict = {}

        def walk(node, fn):
            for child in ast.iter_child_nodes(node):
                name = (child.name if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn)
                owner[child] = name
                walk(child, name)

        walk(self.tree, "<module>")
        return owner

    def _check_module_wide(self) -> None:
        owner = self._functions()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                self._check_cache_call(node)
                resolved = self.imports.resolve(_dotted(node.func))
                if resolved in _CTORS and not any(
                        kw.arg == "dtype" for kw in node.keywords):
                    self.reporter.report(
                        node, "R3",
                        f"{resolved}() without dtype= — the plane's dtype "
                        "must be stated, not inferred from a Python value",
                    )
            elif isinstance(node, ast.Attribute):
                resolved = self.imports.resolve(_dotted(node))
                if resolved in _WIDE_DTYPES and declared_64bit(
                        self.path, owner.get(node, "<module>")) is None:
                    self.reporter.report(
                        node, "R3",
                        f"64-bit dtype {resolved} outside the declared "
                        "sites (tracelint.DECLARED_64BIT) — the simulation "
                        "plane is 32-bit",
                    )


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def lint_source(source: str, path: str = "<string>",
                rules: Optional[Iterable[str]] = None) -> list[Violation]:
    """Lint Python source text; returns violations sorted by position."""
    active = frozenset(rules) if rules is not None else frozenset(RULES)
    unknown = active - set(RULES)
    if unknown:
        raise ValueError(
            f"unknown rule(s) {sorted(unknown)}; known: {sorted(RULES)}"
        )
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Violation(path, e.lineno or 0, (e.offset or 0), "E0",
                          f"syntax error: {e.msg}")]
    out = _ModuleLinter(tree, source, path, active).run()
    return sorted(out, key=lambda v: (v.line, v.col, v.rule))


def lint_file(path: str | Path,
              rules: Optional[Iterable[str]] = None) -> list[Violation]:
    p = Path(path)
    return lint_source(p.read_text(), str(p), rules)


def lint_paths(paths: Iterable[str | Path],
               rules: Optional[Iterable[str]] = None) -> list[Violation]:
    """Lint files and/or directory trees (``*.py``, recursively)."""
    out: list[Violation] = []
    for path in paths:
        p = Path(path)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                out.extend(lint_file(f, rules))
        else:
            out.extend(lint_file(p, rules))
    return out


def default_paths() -> list[Path]:
    """The simulation plane: the tick code of this package (the list
    ``tests/test_torch_tracelint.py`` gates at zero violations)."""
    root = Path(__file__).resolve().parent.parent
    return [root / "models", root / "sim", root / "ops",
            root / "parallel", root / "sweep", root / "streamcast",
            root / "geo", root / "obs"]


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tracelint",
        description="static analysis of the port's simulation plane",
    )
    parser.add_argument("paths", nargs="*",
                        help="files or directories (default: the "
                             "package's models/ sim/ ops/ ...)")
    parser.add_argument("--rules", default="",
                        help="comma-separated rule ids (default: all)")
    parser.add_argument("--list-rules", action="store_true",
                        dest="list_rules")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text",
                        help="json: one machine-readable object with "
                             "every violation")
    args = parser.parse_args(argv)
    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0
    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    files: list[Path] = []
    for p in (args.paths or default_paths()):
        p = Path(p)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    try:
        violations = lint_paths(files, rules)
    except (ValueError, OSError) as e:
        print(f"tracelint: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        import json

        print(json.dumps({
            "violations": [v.to_json() for v in violations],
            "files": len(files),
        }))
        return 1 if violations else 0
    for v in violations:
        print(v.format())
    if violations:
        print(f"tracelint: {len(violations)} violation(s) in "
              f"{len(files)} file(s)", file=sys.stderr)
        return 1
    print(f"tracelint: clean ({len(files)} file(s))", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
