"""Platform decisions, in one place.

Which implementation runs an operation that has a hand-written kernel,
and where the persistent compile cache lives.  Every caller asks here;
no other module looks at the platform.

- ``gpu``: the z-first engine's batched banded solve runs the
  Triton-route Pallas kernel (``ops/pallas_banded``).  Everything else
  is plain JAX compiled by XLA.
- ``cpu``: the banded solve runs the ``lax.scan`` reference
  (``models/vertical_banded``).
- any other platform raises.

The reference-layout engine always runs the ``lax.scan`` solve: it is
the plain reference the z-first engine is checked against, and XLA can
partition it when that engine runs under GSPMD.  A caller may name the
implementation (``solver=``), as the benchmark does to time the step
with the scan.

Interpret mode is never chosen here; only tests ask for it.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

SOLVERS = {"gpu": "triton", "cpu": "scan"}

# <checkout>/.jax_cache: a fixed path (the path is part of the cache key,
# so a directory that moves never hits); listed in .gitignore
REPO_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def platform() -> str:
    return jax.default_backend()


def banded_solver(plat: str | None = None) -> str:
    """"triton" or "scan": the banded-solve implementation for ``plat``
    (default: the platform JAX computes on)."""
    plat = platform() if plat is None else plat
    try:
        return SOLVERS[plat]
    except KeyError:
        raise NotImplementedError(
            f"no banded-solve implementation for platform {plat!r} "
            f"(supported: {sorted(SOLVERS)})") from None


def _pick(solver: str | None) -> str:
    solver = banded_solver() if solver is None else solver
    if solver not in SOLVERS.values():
        raise ValueError(f"unknown banded solver {solver!r} "
                         f"(known: {sorted(set(SOLVERS.values()))})")
    return solver


def banded_solve(bands, rhs, q: int, solver: str | None = None):
    """Batched banded solve, ``bands`` (n, 2q+1, ncol), ``rhs`` (n, ncol).
    ``solver``: "triton" or "scan" (default: ``banded_solver()``)."""
    if _pick(solver) == "triton":
        from .ops.pallas_banded import banded_solve_pallas
        return banded_solve_pallas(bands, rhs, q, interpret=False)
    from .models.vertical_banded import banded_solve_t
    return banded_solve_t(bands, rhs, q)


def banded_solve_multi(bands, rhs, q: int, solver: str | None = None):
    """Shared-matrix multi-RHS form, ``rhs`` (n, R, ncol)."""
    if _pick(solver) == "triton":
        from .ops.pallas_banded import banded_solve_multi_pallas
        return banded_solve_multi_pallas(bands, rhs, q, interpret=False)
    from .models.vertical_banded import banded_solve_multi_t
    return banded_solve_multi_t(bands, rhs, q)


def compile_cache_dir(environ=os.environ) -> str | None:
    """The directory the package sets as JAX's compile cache, or None
    when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then reads it itself
    and the package sets nothing)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(REPO_CACHE_DIR)


def configure_compile_cache(environ=os.environ) -> None:
    path = compile_cache_dir(environ)
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
