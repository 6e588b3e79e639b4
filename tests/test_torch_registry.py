"""The program registry (``consul_tpu_torch.sim.registry``) against the JAX
package's (``consul_tpu.sim.engine.jaxlint_registry``) on the CPU, under
the 8 virtual devices of ``tests/conftest.py``.

* the small and big registries hold the same names in the same order (94
  and 14), with the same declared fields;
* ``state_bytes()`` equals the sum of the reference's ``jax.eval_shape``
  leaf bytes for every program, big ones included, but for the one
  layout difference: the port's key is int64[2] (two uint32 words in
  int64), the reference's uint32[2], 8 bytes more for each key (U keys in
  a sweep);
* building the registries and sizing every program allocates nothing
  outside the ``meta`` device;
* one small program per entrypoint (the 8 unsharded scans, the 5 sharded
  twins, ``sweep_scan``) runs from the same initial state and
  ``PRNGKey(0)`` in both packages, outputs and final state bit-equal.  The
  aggregate paths among them (SWIM's and Lifeguard's defaults, multi-DC,
  geo's LAN arrivals) may differ only where a receiver's uniform lies
  between the two packages' arrival thresholds
  (``torch_parity.check_arrivals``); none does at these configs, so they
  are held equal.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.sim import engine as j_engine
from consul_tpu.sweep import universe as j_universe
from consul_tpu_torch.sim import engine, registry
from torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIELDS = ("entrypoint", "n", "devices", "per_chip", "budgeted",
          "abstract_only", "note")


@pytest.fixture(scope="module")
def registries():
    assert len(jax.devices()) == 8
    return {tier: (j_engine.jaxlint_registry(include=(tier,)),
                   registry.jaxlint_registry(include=(tier,)))
            for tier in ("small", "big")}


@pytest.mark.parametrize("tier,count", [("small", 94), ("big", 14)])
def test_names_order_and_fields_match(registries, tier, count):
    want, got = registries[tier]
    assert len(got) == count
    assert list(got) == list(want)
    for name, prog in got.items():
        assert prog.name == name
        for f in FIELDS:
            assert getattr(prog, f) == getattr(want[name], f), (name, f)


def test_engine_exports_the_registry():
    assert engine.jaxlint_registry is registry.jaxlint_registry
    assert engine.EQUIV_PAIRS is registry.EQUIV_PAIRS
    for name in ("SimProgram", "EquivPair", "sparse_program_at",
                 "swim_program_at", "broadcast_program_at",
                 "walk_equiv_pairs"):
        assert getattr(engine, name) is getattr(registry, name)


def _keys_in(name: str) -> int:
    """Keys among a program's arguments: U for a sweep, else 1."""
    if name.startswith("sweep_"):
        return int(name.split("/U")[1].split("x")[0].split("/")[0])
    return 1


@pytest.mark.parametrize("tier", ["small", "big"])
def test_state_bytes_match_eval_shape(registries, tier):
    want, got = registries[tier]
    for name, prog in got.items():
        _, args = want[name].build()
        ref = sum(np.dtype(leaf.dtype).itemsize * int(np.prod(leaf.shape))
                  for leaf in jax.tree_util.tree_leaves(args))
        # The stated layout difference: an int64[2] key against uint32[2].
        assert prog.state_bytes() == ref + 8 * _keys_in(name), name


def test_big_state_bytes_are_the_sizes_phase_14_predicts_from(registries):
    _, big = registries["big"]
    assert big["sparse@10m"].state_bytes() == 7_810_000_028
    assert big["membership@16k"].state_bytes() == 4_295_229_460
    assert big["sweep_sparse@100k/U8"].state_bytes() == 624_800_256


class _WatchAllocations(torch.overrides.TorchFunctionMode):
    """Records every torch call that returns a tensor off ``meta``."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.made.append((getattr(func, "__name__", str(func)),
                                  tuple(t.shape)))
        return out


def test_building_and_sizing_allocate_nothing():
    with _WatchAllocations() as watch:
        progs = registry.jaxlint_registry()
        sizes = {name: p.state_bytes() for name, p in progs.items()}
    # 19.9 GB of arguments were sized, and no torch call made a tensor off
    # the meta device: no state, no key, no staging of config values.
    assert sum(sizes.values()) > 19e9
    assert watch.made == []


def test_scale_hooks_rebuild_the_entrypoint():
    for fn, entry in ((registry.sparse_program_at, "sparse_membership_scan"),
                      (registry.swim_program_at, "swim_scan"),
                      (registry.broadcast_program_at, "broadcast_scan")):
        prog = fn(256)
        want = getattr(j_engine, fn.__name__)(256)
        assert (prog.name, prog.entrypoint, prog.n) == (
            want.name, entry, 256)
        _, args = want.build()
        ref = sum(np.dtype(x.dtype).itemsize * int(np.prod(x.shape))
                  for x in jax.tree_util.tree_leaves(args))
        assert prog.state_bytes() == ref + 8


def _np_leaves(tree, jax_side: bool) -> list:
    if jax_side:
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
    return [x.numpy() for x in torch.utils._pytree.tree_leaves(tree)]


def _reference_args(name: str, prog):
    """The reference program's arguments as the port makes its own: the
    initial state and PRNGKey(0); a sweep's state stacked U times, U
    copies of the key, each knob at the config's own value."""
    fn, args = prog.build()
    if not name.startswith("sweep_"):
        return fn, (prog.init(), jax.random.PRNGKey(0))
    _, keys_abs, values_abs = args
    # The reference's sweep build binds its static structure as defaults.
    bound = inspect.signature(prog.build).parameters
    model, cfg, knobs, U = (bound[k].default
                            for k in ("model", "cfg", "knobs", "U"))
    assert keys_abs.shape == (U, 2)
    spec = j_universe.SWEEP_ENTRYPOINTS[model]
    state = spec.init(cfg)
    stacked = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (U,) + a.shape), state)
    keys = jnp.broadcast_to(jax.random.PRNGKey(0)[None], (U, 2))
    values = tuple(
        jnp.full((U,), getattr(*j_universe._resolve_path(cfg, p)),
                 j_universe.knob_dtype(p))
        for p in knobs)
    assert [v.shape for v in values] == [v.shape for v in values_abs]
    return fn, (stacked, keys, values)


ONE_PER_ENTRYPOINT = [
    "broadcast@small", "membership@small", "sparse@small", "swim@small",
    "lifeguard@small", "multidc@small", "streamcast@small", "geo@small",
    "sharded_broadcast@small/D2", "sharded_membership@small/D2",
    "sharded_sparse@small/D2", "sharded_streamcast@small/D2",
    "sharded_geo@small/D2",
    "sweep_lifeguard@small/U8", "sweep_membership@small/U8xD2",
]


@pytest.mark.parametrize("name", ONE_PER_ENTRYPOINT)
def test_program_bit_equal_to_reference(registries, name):
    want_reg, got_reg = registries["small"]
    fn, args = _reference_args(name, want_reg[name])
    want = _np_leaves(fn(*args), jax_side=True)
    got_fn, make_args = got_reg[name].build()
    got = _np_leaves(got_fn(*make_args("cpu")), jax_side=False)
    assert len(got) == len(want), name
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.dtype == w.dtype, (name, i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{name} leaf {i}")


def test_every_entrypoint_is_covered(registries):
    _, got = registries["small"]
    assert ({got[n].entrypoint for n in ONE_PER_ENTRYPOINT}
            == {p.entrypoint for p in got.values()})
