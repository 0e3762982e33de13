"""Schur-complement vertical implicit solve.

JAX analog of ``VerticalDynamicsSchur`` (``--vmethod SCHUR``,
``VerticalDynamicsSchur.cpp:1395-1770``): the W unknowns are eliminated
through the DIAGONAL of the W-W Jacobian block (the reference divides by
``dDG[MatFIx(FWIx,i,FWIx,i)]`` only, ``:1640-1660`` — off-diagonal W-W
couplings are dropped by construction), producing a 2-variable
(Rt_k, Rho_k)-interleaved banded Schur system of size 2 nz that is
solved with the same batched no-pivot banded LU as the full system, then
W is back-substituted.

Because the W-W off-diagonals (KE/vertical-upwinding couplings in this
formulation) are dropped, the step is a quasi-Newton update: it differs
from the exact-Jacobian solvers at O(residual * dropped terms) but
converges to the same solution with Newton iterations — mirroring the
approximation the reference makes.

All tensors keep the huge column axis LAST (lanes-aligned).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .vertical_banded import interleave_perm, banded_solve_t


def _subblock_maps(nz: int, q: int, qlev: int):
    """Host-side index maps from full interleaved bands to per-variable
    sub-bands in level space.

    Full bands: (n, 2q+1, ncol) interleaved (Rt_k, W_k, Rho_k).
    Sub-band J_ab: (rows_a, 2qlev+1) with J_ab[k, d] = J[a_k, b_{k+d-qlev}].
    Returns {(a, b): (row_idx, diag_idx, valid)} arrays shaped
    (rows_a, 2qlev+1).
    """
    perm = interleave_perm(nz)              # block -> interleaved position
    pos = np.argsort(perm)                  # block index -> interleaved row
    blocks = {"rt": np.arange(nz), "w": np.arange(nz, 2 * nz + 1),
              "rho": np.arange(2 * nz + 1, 3 * nz + 1)}
    maps = {}
    for a, arows in blocks.items():
        for b, bcols in blocks.items():
            na, nb = len(arows), len(bcols)
            k = np.arange(na)[:, None]
            d = np.arange(2 * qlev + 1)[None, :]
            l = k + d - qlev
            valid = (l >= 0) & (l < nb)
            lc = np.clip(l, 0, nb - 1)
            ri = pos[arows][:, None] * np.ones_like(d)      # interleaved row
            ci = pos[bcols[lc]]                             # interleaved col
            off = ci - ri + q
            inband = valid & (off >= 0) & (off <= 2 * q)
            maps[(a, b)] = (ri.astype(np.int64),
                            np.clip(off, 0, 2 * q).astype(np.int64),
                            inband)
    return maps


def _extract_sub(bands, mp, dtype):
    """(rows_a, 2qlev+1, ncol) sub-band from full (n, 2q+1, ncol) bands."""
    ri, off, ok = mp
    sub = bands[jnp.asarray(ri), jnp.asarray(off)]          # (ra, 2ql+1, ncol)
    return sub * jnp.asarray(ok, dtype=dtype)[..., None]


def _band_matvec(sub, x, qlev):
    """y[k] = sum_d sub[k, d] * x[k + d - qlev] (x: (rows_b, ncol))."""
    rows = sub.shape[0]
    nb = x.shape[0]
    out = jnp.zeros((rows, sub.shape[2]), sub.dtype)
    for d in range(sub.shape[1]):
        s = d - qlev
        lo_r, hi_r = max(0, -s), min(rows, nb - s)
        if lo_r >= hi_r:
            continue
        out = out.at[lo_r:hi_r].add(
            sub[lo_r:hi_r, d] * x[lo_r + s:hi_r + s])
    return out


def _band_product(A, B, qa, qb, rows_b, rows_out):
    """Banded product C = A @ B in level space.

    A: (rows_out, 2qa+1, ncol) mapping rows_b-space -> rows_out-space;
    B: (rows_b, 2qb+1, ncol) mapping cols-space -> rows_b-space.
    Returns C: (rows_out, 2(qa+qb)+1, ncol).
    """
    qc = qa + qb
    ncol = A.shape[2]
    C = jnp.zeros((rows_out, 2 * qc + 1, ncol), A.dtype)
    for da in range(2 * qa + 1):
        sa = da - qa
        for db in range(2 * qb + 1):
            sb = db - qb
            dc = sa + sb + qc
            # C[k, dc] += A[k, da] * B[k+sa, db]; m = k+sa within rows_b
            lo = max(0, -sa)
            hi = min(rows_out, rows_b - sa)
            if lo >= hi:
                continue
            C = C.at[lo:hi, dc].add(
                A[lo:hi, da] * B[lo + sa:hi + sa, db])
    return C


def schur_newton_update(batched_resid, x0, q: int, nz: int, vo: int,
                        multi_jvp=None):
    """One quasi-Newton step via Schur elimination of W.

    ``batched_resid``: (ncol, n) -> (ncol, n);  ``x0``: (ncol, n);
    ``multi_jvp``: fused tangent evaluator (required for band extraction
    speed; falls back to AD when None).
    """
    from .vertical_banded import extract_bands_t

    ncol, n = x0.shape
    dtype = x0.dtype
    perm = jnp.asarray(interleave_perm(nz))
    inv_perm = jnp.argsort(perm)
    bands = extract_bands_t(batched_resid, x0, q, perm, inv_perm,
                            multi_jvp=multi_jvp)        # (n, 2q+1, ncol)
    f = batched_resid(x0)                               # (ncol, n)
    b_rt = f[:, :nz].T
    b_w = f[:, nz:2 * nz + 1].T
    b_rho = f[:, 2 * nz + 1:].T                         # (rows, ncol)

    qlev = vo + 1
    maps = _subblock_maps(nz, q, qlev)
    sub = {k: _extract_sub(bands, mp, dtype) for k, mp in maps.items()}

    d_w = sub[("w", "w")][:, qlev]                      # (nz+1, ncol) diag
    inv_dw = 1.0 / d_w

    # Schur sub-bands: S_ab = J_ab - J_aw D^-1 J_wb
    S = {}
    for a in ("rt", "rho"):
        for b in ("rt", "rho"):
            # scale J_wb rows by 1/D before the product
            Jwb = sub[("w", b)] * inv_dw[:, None, :]
            prod = _band_product(sub[(a, "w")], Jwb, qlev, qlev,
                                 nz + 1, nz)
            qc = 2 * qlev
            # embed J_ab (2qlev+1) into the wider (2qc+1) band
            base = jnp.zeros((nz, 2 * qc + 1, ncol), dtype)
            base = base.at[:, qc - qlev:qc + qlev + 1].set(sub[(a, b)])
            S[(a, b)] = base - prod

    # rhs_schur = b_a - J_aw D^-1 b_w
    dwbw = inv_dw * b_w
    r_rt = b_rt - _band_matvec(sub[("rt", "w")], dwbw, qlev)
    r_rho = b_rho - _band_matvec(sub[("rho", "w")], dwbw, qlev)

    # assemble 2-variable interleaved banded system (Rt_k, Rho_k)
    qc = 2 * qlev
    qs = 2 * qc + 1
    n2 = 2 * nz
    bands_s = jnp.zeros((n2, 2 * qs + 1, ncol), dtype)
    var_of = {0: "rt", 1: "rho"}
    for ai in (0, 1):
        a = var_of[ai]
        for bi in (0, 1):
            b = var_of[bi]
            for d in range(2 * qc + 1):
                s_lev = d - qc
                # row 2k+ai, col 2(k+s_lev)+bi -> offset 2 s_lev + (bi-ai)
                off = 2 * s_lev + (bi - ai) + qs
                k = np.arange(nz)
                l = k + s_lev
                ok = (l >= 0) & (l < nz)
                if not ok.any():
                    continue
                rows2 = 2 * k[ok] + ai
                bands_s = bands_s.at[jnp.asarray(rows2), off].set(
                    S[(a, b)][jnp.asarray(k[ok]), d])
    rhs_s = jnp.zeros((n2, ncol), dtype)
    rhs_s = rhs_s.at[0::2].set(r_rt).at[1::2].set(r_rho)

    sol = banded_solve_t(bands_s, rhs_s, qs)            # (2nz, ncol)
    dx_rt, dx_rho = sol[0::2], sol[1::2]

    # back out W: dx_w = D^-1 (b_w - J_w,rt dx_rt - J_w,rho dx_rho)
    dx_w = inv_dw * (b_w
                     - _band_matvec(sub[("w", "rt")], dx_rt, qlev)
                     - _band_matvec(sub[("w", "rho")], dx_rho, qlev))

    dx = jnp.concatenate([dx_rt.T, dx_w.T, dx_rho.T], axis=1)
    return x0 - dx
