"""Pallas kernel (Triton route): batched no-pivot banded LU solve.

The "batched Thomas/banded vertical solver" of the north star
(BASELINE.json): each of ~1e5 independent column systems (the HEVI
vertical implicit Newton systems, half-bandwidth q) is solved by one GPU
thread.  A program owns ``block`` consecutive columns and walks the rows
in a loop, keeping the last q U-rows and forward values in registers, so
the whole solve is ONE kernel launch instead of the XLA scan of 2n
dependent steps (``models/vertical_banded.banded_solve_t``).  The U
factor and the forward solution go to two scratch outputs that the back
substitution reads again.

Layout contract matches ``banded_solve_t``: bands (n, 2q+1, ncol) with
band[i, d] = A[i, i+d-q], rhs (n, ncol).  Out-of-range band entries must
be zero (guaranteed by the assemblers).  Columns past ``ncol`` in the
last program are masked: they load an identity row and store nothing, so
no padded copy of the bands is made.

``interpret=True`` runs the same kernel in the Pallas interpreter (CPU
tests); the platform choice lives in ``tempestmodel_tpu.backend``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt


def _solve_kernel(q, n, ncol, block, R, bands_ref, rhs_ref,
                  out_ref, u_ref, y_ref):
    """Forward elimination once per column, then R back substitutions.

    ``rhs_ref``/``out_ref``/``y_ref``: (n, R, ncol); ``u_ref``:
    (n, q+1, ncol).  Every value handled is a (block,) vector, one lane
    per column (Triton tensors must have power-of-two extents, and 2q+1
    and R are not)."""
    cols = pl.program_id(0) * block + jnp.arange(block)
    live = cols < ncol
    dtype = out_ref.dtype
    one = jnp.ones((block,), dtype)
    zero = jnp.zeros((block,), dtype)

    def ld(ref, *idx, other=0.0):
        return plt.load(ref.at[idx + (cols,)], mask=live, other=other)

    def st(ref, val, *idx):
        plt.store(ref.at[idx + (cols,)], val, mask=live)

    def fwd(i, carry):
        u_prev, y_prev = carry     # q U-rows of q+1 vectors; q rows of R
        w = [ld(bands_ref, i, d, other=1.0 if d == q else 0.0)
             for d in range(2 * q + 1)]
        y = [ld(rhs_ref, i, r) for r in range(R)]
        for t in range(q):
            # eliminate column i-q+t with U row i-q+t; before row q the
            # dummy identity rows and the zero band entry make it a no-op
            f = w[t] / u_prev[t][0]
            for k in range(q):
                w[t + 1 + k] = w[t + 1 + k] - f * u_prev[t][1 + k]
            y = [y[r] - f * y_prev[t][r] for r in range(R)]
        u_i = tuple(w[q:])
        for k in range(q + 1):
            st(u_ref, u_i[k], i, k)
        for r in range(R):
            st(y_ref, y[r], i, r)
        return u_prev[1:] + (u_i,), y_prev[1:] + (tuple(y),)

    ident = (one,) + (zero,) * q
    jax.lax.fori_loop(0, n, fwd, ((ident,) * q, ((zero,) * R,) * q))

    def bwd(j, x_next):            # x_next[d]: solution row i+1+d
        i = n - 1 - j
        u = [ld(u_ref, i, k, other=1.0 if k == 0 else 0.0)
             for k in range(q + 1)]
        x_i = []
        for r in range(R):
            acc = ld(y_ref, i, r)
            for d in range(q):
                acc = acc - u[d + 1] * x_next[d][r]
            x_i.append(acc / u[0])
            st(out_ref, x_i[r], i, r)
        return (tuple(x_i),) + x_next[:-1]

    jax.lax.fori_loop(0, n, bwd, ((zero,) * R,) * q)


def banded_solve_multi_pallas(bands, rhs, q: int, block: int = 128,
                              interpret: bool = False):
    """Solve the batched banded systems for R shared-matrix right-hand
    sides in one kernel: ``bands`` (n, 2q+1, ncol), ``rhs`` (n, R, ncol)
    -> (n, R, ncol).  The elimination runs ONCE per column; each RHS only
    pays the substitutions (the reference's DGETRF-once /
    DGETRS-per-species tracer update, ``VerticalDynamicsFEM.cpp:4028-4262``).
    ``block``: columns per program, a power of two (one column per
    thread of the program's 4 warps at the default 128)."""
    n, b, ncol = bands.shape
    R = rhs.shape[1]
    if b != 2 * q + 1 or rhs.shape != (n, R, ncol):
        raise ValueError(f"bands {bands.shape} / rhs {rhs.shape} do not "
                         f"match half-bandwidth q={q}")
    if block & (block - 1):
        raise ValueError(f"block={block} is not a power of two")
    dtype = bands.dtype
    kernel = functools.partial(_solve_kernel, q, n, ncol, block, R)
    out, _, _ = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(ncol, block),),
        out_shape=(jax.ShapeDtypeStruct((n, R, ncol), dtype),
                   jax.ShapeDtypeStruct((n, q + 1, ncol), dtype),
                   jax.ShapeDtypeStruct((n, R, ncol), dtype)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="banded_solve",
    )(bands, rhs.astype(dtype))
    return out


def banded_solve_pallas(bands, rhs, q: int, block: int = 128,
                        interpret: bool = False):
    """Single right-hand side: ``bands`` (n, 2q+1, ncol), ``rhs``
    (n, ncol) -> (n, ncol)."""
    return banded_solve_multi_pallas(bands, rhs[:, None], q, block=block,
                                     interpret=interpret)[:, 0]
