"""The Triton-route banded-solve kernel vs its XLA reference (interpret
mode), and the platform choice around it.

The banded solver kernel (``ops/pallas_banded.py``) replaces the
reference's per-column LAPACK DGBSV loop
(``src/atm/VerticalDynamicsFEM.cpp:1437-1464``); on CPU it runs in the
Pallas interpreter (explicit ``interpret=True``), so these tests validate
the kernel logic that the GPU compiles.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tempestmodel_tpu import backend
from tempestmodel_tpu.models.vertical_banded import (
    banded_solve_t, banded_solve_multi_t, interleave_perm)
from tempestmodel_tpu.ops import pallas_banded
from tempestmodel_tpu.ops.pallas_banded import (banded_solve_pallas,
                                               banded_solve_multi_pallas)


def _random_banded(n, q, ncol, seed=0, dtype=np.float64):
    """Diagonally-dominant banded systems in the (n, 2q+1, ncol) layout."""
    rng = np.random.default_rng(seed)
    b = 2 * q + 1
    bands = rng.standard_normal((n, b, ncol)).astype(dtype)
    # strong diagonal (the HEVI Newton systems carry I/dt)
    bands[:, q, :] += 2.0 * b
    # zero out-of-range diagonals (extractor band guarantee)
    rows = np.arange(n)
    for d in range(b):
        col = rows + d - q
        bad = (col < 0) | (col >= n)
        bands[bad, d, :] = 0.0
    rhs = rng.standard_normal((n, ncol)).astype(dtype)
    return jnp.asarray(bands), jnp.asarray(rhs)


def _dense_solve(bands, rhs, q):
    """Dense reference solve of the banded layout."""
    n, b, ncol = bands.shape
    X = np.zeros((n, ncol))
    bands = np.asarray(bands)
    rhs = np.asarray(rhs)
    for c in range(ncol):
        A = np.zeros((n, n))
        for d in range(b):
            for i in range(n):
                j = i + d - q
                if 0 <= j < n:
                    A[i, j] = bands[i, d, c]
        X[:, c] = np.linalg.solve(A, rhs[:, c])
    return X


@pytest.mark.parametrize("q", [1, 2, 4])
def test_pallas_banded_matches_scan_and_dense(q):
    n, ncol = 3 * 10 + 1, 24
    bands, rhs = _random_banded(n, q, ncol, seed=q)
    x_scan = np.asarray(banded_solve_t(bands, rhs, q))
    x_pl = np.asarray(banded_solve_pallas(bands, rhs, q, block=16,
                                          interpret=True))
    x_dense = _dense_solve(bands, rhs, q)
    np.testing.assert_allclose(x_scan, x_dense, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(x_pl, x_scan, rtol=1e-10, atol=1e-10)


def test_pallas_banded_column_padding():
    """ncol smaller than one block: the masked lanes of the only program."""
    n, q, ncol = 13, 2, 7
    bands, rhs = _random_banded(n, q, ncol, seed=3)
    x_scan = np.asarray(banded_solve_t(bands, rhs, q))
    x_pl = np.asarray(banded_solve_pallas(bands, rhs, q, block=16,
                                          interpret=True))
    np.testing.assert_allclose(x_pl, x_scan, rtol=1e-10, atol=1e-10)


def test_pallas_banded_ragged_last_block():
    """ncol not a multiple of the block: full programs plus a masked
    last one; no column is dropped or written twice."""
    n, q, ncol = 19, 4, 40
    bands, rhs = _random_banded(n, q, ncol, seed=7)
    x_scan = np.asarray(banded_solve_t(bands, rhs, q))
    x_pl = np.asarray(banded_solve_pallas(bands, rhs, q, block=16,
                                          interpret=True))
    assert np.isfinite(x_pl).all()
    np.testing.assert_allclose(x_pl, x_scan, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("q,ncol", [(1, 32), (2, 21)])
def test_pallas_banded_multi_rhs(q, ncol):
    """R = 3 right-hand sides against one factorization (the tracer
    update's form) == the multi-RHS scan and the dense solve."""
    n, R = 30, 3
    bands, _ = _random_banded(n, q, ncol, seed=11 + q)
    rhs = jnp.asarray(np.random.default_rng(q).standard_normal((n, R, ncol)))
    x_scan = np.asarray(banded_solve_multi_t(bands, rhs, q))
    x_pl = np.asarray(banded_solve_multi_pallas(bands, rhs, q, block=16,
                                                interpret=True))
    assert x_pl.shape == (n, R, ncol)
    np.testing.assert_allclose(x_pl, x_scan, rtol=1e-10, atol=1e-10)
    for r in range(R):
        np.testing.assert_allclose(
            x_pl[:, r], _dense_solve(bands, rhs[:, r], q),
            rtol=1e-10, atol=1e-10)


def test_pallas_banded_rejects_bad_shapes():
    bands, rhs = _random_banded(9, 2, 8)
    with pytest.raises(ValueError, match="half-bandwidth"):
        banded_solve_pallas(bands, rhs, 3, interpret=True)
    with pytest.raises(ValueError, match="power of two"):
        banded_solve_pallas(bands, rhs, 2, block=12, interpret=True)


def test_backend_solver_choice_by_platform():
    assert backend.banded_solver("cpu") == "scan"
    assert backend.banded_solver("gpu") == "triton"
    with pytest.raises(NotImplementedError, match="rocm"):
        backend.banded_solver("rocm")
    # the tests run on the CPU: the default platform picks the scan
    assert backend.banded_solver() == "scan"


def test_backend_never_chooses_interpret_mode(monkeypatch):
    """On a GPU the backend calls the compiled kernel (interpret=False);
    on the CPU it calls the scan, never the interpreter."""
    calls = []

    def fake(name):
        def f(bands, rhs, q, **kw):
            calls.append((name, kw))
            return rhs
        return f

    monkeypatch.setattr(pallas_banded, "banded_solve_pallas",
                        fake("single"))
    monkeypatch.setattr(pallas_banded, "banded_solve_multi_pallas",
                        fake("multi"))
    bands, rhs = _random_banded(9, 2, 8)
    gpu, cpu = backend.banded_solver("gpu"), backend.banded_solver("cpu")
    backend.banded_solve(bands, rhs, 2, solver=gpu)
    backend.banded_solve_multi(bands, rhs[:, None], 2, solver=gpu)
    assert calls == [("single", {"interpret": False}),
                     ("multi", {"interpret": False})]
    calls.clear()
    x = backend.banded_solve(bands, rhs, 2, solver=cpu)
    assert calls == []
    np.testing.assert_allclose(np.asarray(x),
                               np.asarray(banded_solve_t(bands, rhs, 2)))
    # the default is the platform's choice: the scan on the CPU
    x = backend.banded_solve(bands, rhs, 2)
    assert calls == []
    with pytest.raises(ValueError, match="lapack"):
        backend.banded_solve(bands, rhs, 2, solver="lapack")


def test_compile_cache_placement(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR set: the package sets no cache (JAX reads
    the variable itself).  Unset: a fixed directory inside the checkout,
    never a temporary or per-process name."""
    assert backend.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}) is None
    path = backend.compile_cache_dir({})
    repo = __import__("pathlib").Path(__file__).resolve().parent.parent
    assert path == str(repo / ".jax_cache")
    assert backend.compile_cache_dir({"TMPDIR": "/x"}) == path
    gitignore = (repo / ".gitignore").read_text().split()
    assert ".jax_cache/" in gitignore

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))
    backend.configure_compile_cache({"JAX_COMPILATION_CACHE_DIR": "/x"})
    assert updates == []
    backend.configure_compile_cache({})
    assert updates == [("jax_compilation_cache_dir", path)]


def test_interleave_perm_roundtrip():
    nz = 7
    perm = interleave_perm(nz)
    assert sorted(perm.tolist()) == list(range(3 * nz + 1))
    inv = np.argsort(perm)
    np.testing.assert_array_equal(perm[inv], np.arange(3 * nz + 1))


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 3])
def test_pallas_banded_compiled_on_gpu(gpu, R):
    """The kernel as the GPU compiles it (no interpreter) == the scan on
    the same card, float32 at a width with a ragged last block."""
    n, q, ncol = 91, 4, 1000
    bands, _ = _random_banded(n, q, ncol, seed=R, dtype=np.float32)
    rhs = jnp.asarray(np.random.default_rng(R).standard_normal(
        (n, R, ncol)).astype(np.float32))
    got = np.asarray(banded_solve_multi_pallas(bands, rhs, q))
    want = np.asarray(banded_solve_multi_t(bands, rhs, q))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
