"""ops/compact.py: ``compact_to_budget`` against the JAX package on the CPU.

Random masks from numpy seeds, budgets below, at and above the wanted
count, with and without the ``first=`` priority class: every output
(slot table, taken, kept, dropped) bit-equal, dtype included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.ops.compact import compact_to_budget as j_compact
from consul_tpu_torch.ops import compact_to_budget

_j_compact = jax.jit(j_compact, static_argnums=(1,))


def _case(seed, a_len, p_want=0.4, p_first=0.3):
    rng = np.random.default_rng(seed)
    want = rng.random(a_len) < p_want
    first = rng.random(a_len) < p_first
    return want, first


def _budgets(count: int, a_len: int):
    return sorted({1, max(1, count // 2), max(1, count), count + 1,
                   a_len})


@pytest.mark.parametrize("use_first", [False, True])
@pytest.mark.parametrize("seed,a_len", [(0, 1), (1, 7), (2, 64), (3, 257),
                                        (4, 1000)])
def test_matches_reference(seed, a_len, use_first):
    want, first = _case(seed, a_len)
    for budget in _budgets(int(want.sum()), a_len):
        if use_first:
            ref = _j_compact(jnp.asarray(want), budget, jnp.asarray(first))
            got = compact_to_budget(torch.from_numpy(want), budget,
                                    torch.from_numpy(first))
        else:
            ref = _j_compact(jnp.asarray(want), budget)
            got = compact_to_budget(torch.from_numpy(want), budget)
        for name, r, g in zip(("idx", "taken", "kept", "dropped"), ref, got):
            r, g = np.asarray(r), g.numpy()
            assert r.dtype == g.dtype, (name, r.dtype, g.dtype)
            np.testing.assert_array_equal(
                r, g, err_msg=f"{name} budget={budget} first={use_first}")


def test_priority_class_admits_first():
    """Class-major, stream order within each class: a budget of 3 over a
    stream whose priority entries come last takes those first."""
    want = torch.tensor([True, True, True, True, True])
    first = torch.tensor([False, False, False, True, True])
    idx, taken, kept, dropped = compact_to_budget(want, 3, first)
    assert idx.tolist() == [3, 4, 0]
    assert taken.all() and int(dropped) == 2
    assert kept.tolist() == [True, False, False, True, True]


def test_all_empty_stream():
    idx, taken, kept, dropped = compact_to_budget(
        torch.zeros(6, dtype=torch.bool), 4)
    assert idx.tolist() == [5, 5, 5, 5] and not taken.any()
    assert not kept.any() and int(dropped) == 0
