"""``utils.jit.hoisted_jit``: closed-over arrays become arguments of the
compiled program, and the program computes what ``jax.jit`` computes."""

import numpy as np
import jax
import jax.numpy as jnp

from tempestmodel_tpu.utils.jit import hoisted_jit


def _closure():
    table = jnp.asarray(np.random.default_rng(0).standard_normal(4096))
    index = np.arange(4096)[::-1].copy()           # a NumPy constant

    def f(x, y):
        return {"a": x * table[index] + y, "b": jnp.sum(table) * y}
    return f, table


def test_hoisted_constants_are_arguments():
    f, table = _closure()
    x, y = jnp.ones(4096), jnp.float64(2.0)
    h = hoisted_jit(f)
    compiled = h.compile(x, y)
    args = compiled.memory_analysis().argument_size_in_bytes
    # the table and the index arrive as arguments, not as constants
    assert args >= x.nbytes + y.nbytes + table.nbytes + 4096 * 4
    plain = jax.jit(f).lower(x, y).compile()
    assert (plain.memory_analysis().argument_size_in_bytes
            == x.nbytes + y.nbytes)
    # equal up to the summation order: plain jit folds sum(table) at
    # compile time
    got, want = h(x, y), jax.jit(f)(x, y)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-14, atol=0)


def test_hoisted_inlines_under_an_outer_trace():
    f, _ = _closure()
    h = hoisted_jit(f)
    x, y = jnp.arange(4096.0), jnp.float64(0.5)
    outer = hoisted_jit(lambda x, y: h(x, y)["a"] * 2.0)
    np.testing.assert_array_equal(np.asarray(outer(x, y)),
                                  np.asarray(jax.jit(f)(x, y)["a"] * 2.0))
    # one entry per argument signature
    h(x, y)
    h(x.astype(jnp.float32), y)
    assert len(h._entries) == 2
