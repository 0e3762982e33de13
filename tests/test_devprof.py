"""The trace reduction behind every device-time number (utils/devprof):
overlapping events on the device's stream lines count once."""

import jax
import jax.numpy as jnp
import pytest

from tempestmodel_tpu.utils.devprof import reduce_events, trace_call


def test_busy_is_the_union_of_intervals():
    ms = 1_000_000                                   # ns per ms
    events = [("b", 5 * ms, 15 * ms), ("a", 0, 10 * ms),
              ("c", 20 * ms, 30 * ms), ("a", 22 * ms, 25 * ms)]
    r = reduce_events(events)
    assert r["busy_ms"] == pytest.approx(25.0)       # [0, 15] + [20, 30]
    assert r["window_ms"] == pytest.approx(30.0)
    assert r["n_kernels"] == 4
    assert r["kernels_ms"] == pytest.approx({"a": 13.0, "b": 10.0,
                                             "c": 10.0})


def test_no_events_reads_zero():
    r = reduce_events([])
    assert (r["busy_ms"], r["n_kernels"], r["window_ms"]) == (0.0, 0, 0.0)


def test_trace_without_a_gpu_is_an_error():
    """A CPU trace has no GPU stream lines: the measurement fails instead
    of reporting a CPU time as device time."""
    f = jax.jit(lambda x: jnp.sin(x) + 1.0)
    with pytest.raises(RuntimeError, match="no GPU stream events"):
        trace_call(f, jnp.ones(8), reps=1)
