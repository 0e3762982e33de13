"""Tracer transport for the z-first fast engine.

Tracers ride the fast state as ONE flat field ``Tracers`` of shape
``(ntr * nz, 6, A, B)`` (species-major), so the per-stage DSS is one
scalar DSS call for all species and every elementwise update is one
fused pass.

Semantics are the reference-layout tracer path of
``models/nonhydro.py`` (horizontal weak-form advective flux in
``horizontal_tendency``, the linear implicit column update with
factorization reuse across species of ``update_column_tracers`` —
reference ``VerticalDynamicsFEM::UpdateColumnTracers``,
``VerticalDynamicsFEM.cpp:3783-4262`` with DGETRF/DGETRS LU reuse —
and the two mass-conservative positivity filters,
``HorizontalDynamicsFEM.cpp:213-320`` / ``VerticalDynamicsFEM.cpp:
4286-4349``), re-expressed on the z-first layout; equality vs the
reference-layout engine is pinned at 1e-11 fp64 in
``tests/test_fast_tracers.py``.
"""

from __future__ import annotations

import jax.numpy as jnp

from .engine import FastGeometry, colop, hweak_div


def _ntr(tr, nz):
    assert tr.shape[0] % nz == 0
    return tr.shape[0] // nz


def _tile_levels(f, ntr):
    """(nz, 6, A, B) -> (ntr*nz, 6, A, B) species broadcast."""
    return jnp.broadcast_to(f[None], (ntr,) + f.shape).reshape(
        (ntr * f.shape[0],) + f.shape[1:])


def _bcast_mul(f, tr, ntr):
    """f (nz, P, A, B) * tr (ntr*nz, P, A, B) without materializing the
    species-tiled f: a 5-D broadcast multiply XLA fuses, then a free
    leading-dim merge back to the flat layout."""
    t5 = tr.reshape((ntr,) + f.shape)
    return (f[None] * t5).reshape(tr.shape)


def horizontal_update(base_tr, ueval, dt_s, fg: FastGeometry):
    """base + dt_s * advective tendency of the evaluation state's
    tracers (the ``horizontal_tendency`` tracer rows, z-first).

    ``base_tr``: flat tracer field or 2-term ((c1, t1), (c2, t2)) RK
    combination."""
    u, v = ueval["U"], ueval["V"]
    tr = ueval["Tracers"]
    ntr = _ntr(tr, fg.nz)
    w_n = colop(fg.interp_i2n, ueval["W"])
    con_ua = (fg.c2_aa[None] * u + fg.c2_ab[None] * v
              + fg.con_a_xi * w_n)
    con_ub = (fg.c2_ba[None] * u + fg.c2_bb[None] * v
              + fg.con_b_xi * w_n)
    fa = _bcast_mul(fg.jac3d * con_ua, tr, ntr)
    fb = _bcast_mul(fg.jac3d * con_ub, tr, ntr)
    dtr = _bcast_mul(1.0 / fg.jac3d, -hweak_div(fa, fb, fg), ntr)
    if isinstance(base_tr, tuple):
        (c1, t1), (c2, t2) = base_tr
        base = c1 * t1 + c2 * t2
    else:
        base = base_tr
    return base + dt_s * dtr


def _flat(f):
    return f.reshape(f.shape[0], -1)


def _tracer_band_statics(fg: FastGeometry):
    """Static tensors of the banded tracer Jacobian.

    The tracer system J = I/dt + (1/J_n) D_i2n diag(J_i u^xi) I_n2i -
    pen is BANDED with half-bandwidth q_tr (tridiagonal at vo=1): for
    offset o, J[k, k+o] = inv_jac[k] * sum_m S_o[k, m] * (J_i xid)[m]
    - Pl_d[o][k] wl[k] - Pr_d[o][k] wr[k] + [o == 0]/dt with the static
    convolution S_o[k, m] = D_i2n[k, m] * I_n2i[m, k+o].
    """
    import numpy as np
    nz = fg.nz
    D = np.asarray(fg.diff_i2n, np.float64)       # (nz, nz+1)
    I = np.asarray(fg.interp_n2i, np.float64)     # (nz+1, nz)
    Pl = (np.asarray(fg.penalty_left, np.float64)
          if fg.penalty_left is not None else np.zeros((nz, nz)))
    Pr = (np.asarray(fg.penalty_right, np.float64)
          if fg.penalty_right is not None else np.zeros((nz, nz)))
    dense_struct = (np.abs(D) @ np.abs(I)) + np.abs(Pl) + np.abs(Pr)
    q_tr = 0
    for k in range(nz):
        for l in range(nz):
            if dense_struct[k, l] != 0.0:
                q_tr = max(q_tr, abs(k - l))
    S = {}
    Pl_d = {}
    Pr_d = {}
    for o in range(-q_tr, q_tr + 1):
        So = np.zeros((nz, nz + 1))
        pl = np.zeros(nz)
        pr = np.zeros(nz)
        for k in range(nz):
            l = k + o
            if 0 <= l < nz:
                for m in range(nz + 1):
                    So[k, m] = D[k, m] * I[m, l]
                pl[k] = Pl[k, l]
                pr[k] = Pr[k, l]
        S[o] = So
        Pl_d[o] = pl
        Pr_d[o] = pr
    return {"q": q_tr, "S": S, "Pl_d": Pl_d, "Pr_d": Pr_d}


def update_column_tracers(d, w_new, fg: FastGeometry, dt, statics=None,
                          solver=None):
    """Linear implicit vertical tracer update with TRUE factorization
    reuse across species (z-first port of
    ``nonhydro.update_column_tracers``): the species share one band
    matrix per column, so all right-hand sides are stacked on a species
    axis and solved in ONE multi-RHS banded solve — the elimination
    runs once per column and each species only pays the substitution
    (the reference's DGETRF-once / DGETRS-per-species,
    ``VerticalDynamicsFEM.cpp:3783-4262``).

    Solved BANDED (half-bandwidth ~2*vo; tridiagonal at vo=1) via the
    same no-pivot banded machinery as the main implicit solve."""
    from ..backend import banded_solve_multi

    tr_f, bands, F, q_tr = tracer_system(d, w_new, fg, dt, statics)
    sol = banded_solve_multi(bands, F, q_tr, solver=solver)
    return (tr_f - jnp.moveaxis(sol, 1, 0)).reshape(d["Tracers"].shape)


def tracer_system(d, w_new, fg: FastGeometry, dt, statics=None):
    """(tr_f, bands, F, q): the species-flattened tracers (ntr, nz, Q),
    the shared band matrix (nz, 2q+1, Q) and the multi-RHS residual
    (nz, ntr, Q) of the implicit tracer update, and its half-bandwidth;
    the update is ``tr_f - solve(bands, F)``."""
    nz = fg.nz
    tr = d["Tracers"]
    ntr = _ntr(tr, nz)
    shp = tr.shape[1:]
    Q = shp[0] * shp[1] * shp[2]
    if statics is None:
        statics = _tracer_band_statics(fg)
    q_tr = statics["q"]

    u_i = fg.interp_n2i @ _flat(d["U"])
    v_i = fg.interp_n2i @ _flat(d["V"])
    caxi_i = _flat(fg.con_a_xi_int)
    cbxi_i = _flat(fg.con_b_xi_int)
    cxx_i = _flat(fg.con_xi_xi_int)
    mask = jnp.ones((nz + 1, 1), tr.dtype).at[0].set(0.0).at[-1].set(0.0)
    adv = caxi_i * u_i + cbxi_i * v_i
    xid0 = (adv + cxx_i * _flat(d["W"])) * mask
    xid_new = (adv + cxx_i * _flat(w_new)) * mask

    jac_i = _flat(fg.jac3d_int)
    inv_jac = 1.0 / _flat(fg.jac3d)
    jxid = jac_i * xid_new                        # (nz+1, Q)

    vo = fg.vo
    nfe = nz // vo
    has_pen = nfe > 1 and fg.penalty_left is not None
    if has_pen:
        wb = jnp.abs(xid0[vo:nz:vo])
        wl = fg.wscat_left @ wb                   # (nz, Q)
        wr = fg.wscat_right @ wb
    # banded Jacobian (nz, 2q+1, Q)
    slots = []
    dtype = tr.dtype
    for o in range(-q_tr, q_tr + 1):
        band = inv_jac * (jnp.asarray(statics["S"][o], dtype) @ jxid)
        if has_pen:
            band = band - (jnp.asarray(statics["Pl_d"][o], dtype)[:, None]
                           * wl
                           + jnp.asarray(statics["Pr_d"][o], dtype)[:, None]
                           * wr)
        if o == 0:
            band = band + 1.0 / dt
        slots.append(band)
    bands = jnp.stack(slots, axis=1)              # (nz, 2q+1, Q)

    # RHS stacked species-axis-middle (nz, ntr, Q): the einsums place
    # the species axis directly where the multi-RHS solver wants it
    tr_f = tr.reshape(ntr, nz, Q)
    tr_i = jnp.einsum("ML,tLq->tMq", fg.interp_n2i, tr_f)
    mf = jxid[None] * tr_i * mask[None]
    F = jnp.einsum("KM,tMq->Ktq", fg.diff_i2n, mf) * inv_jac[:, None]
    if has_pen:
        F = F - (jnp.einsum("KL,tLq->Ktq", fg.penalty_left, tr_f)
                 * wl[:, None]
                 + jnp.einsum("KL,tLq->Ktq", fg.penalty_right, tr_f)
                 * wr[:, None])

    return tr_f, bands, F, q_tr


def filter_column(tr, fg: FastGeometry):
    """Mass-conservative column positivity filter (z-first)."""
    nz = fg.nz
    ntr = _ntr(tr, nz)
    t4 = tr.reshape((ntr, nz) + tr.shape[1:])
    area = fg.area3d[None]
    total = jnp.sum(t4 * area, axis=1, keepdims=True)
    pos = jnp.maximum(t4, 0.0)
    pos_mass = jnp.sum(pos * area, axis=1, keepdims=True)
    ratio = jnp.where(pos_mass > 0.0, total / pos_mass, 0.0)
    return (pos * jnp.maximum(ratio, 0.0)).reshape(tr.shape)


def filter_horizontal(tr, fg: FastGeometry):
    """Per-element horizontal positivity filter (z-first)."""
    ne_a = fg.A // fg.p
    ne_b = fg.B // fg.p
    ntr = _ntr(tr, fg.nz)

    t_e = tr.reshape(ntr, fg.nz, fg.npanels, ne_a, fg.p, ne_b, fg.p)
    a_e = fg.area3d.reshape(
        1, fg.nz, fg.npanels, ne_a, fg.p, ne_b, fg.p)
    total = jnp.sum(t_e * a_e, axis=(4, 6), keepdims=True)
    pos = jnp.maximum(t_e, 0.0)
    pos_mass = jnp.sum(pos * a_e, axis=(4, 6), keepdims=True)
    ratio = jnp.where(pos_mass > 0.0, total / pos_mass, 0.0)
    return (pos * jnp.maximum(ratio, 0.0)).reshape(tr.shape)


def scalar_laplacian_tr(tr, fg: FastGeometry):
    """Horizontal Laplacian of the flat tracer field (nu4 work pass);
    the z-varying Jacobian broadcasts over species instead of being
    tiled (see _bcast_mul)."""
    from .engine import hderiv_a, hderiv_b, hweak_div
    ntr = _ntr(tr, fg.nz)
    da = hderiv_a(tr, fg)
    db = hderiv_b(tr, fg)
    c_aa, c_ab = fg.c2_aa[None], fg.c2_ab[None]
    c_ba, c_bb = fg.c2_ba[None], fg.c2_bb[None]
    ga = _bcast_mul(fg.jac3d, c_aa * da + c_ab * db, ntr)
    gb = _bcast_mul(fg.jac3d, c_ba * da + c_bb * db, ntr)
    return _bcast_mul(1.0 / fg.jac3d, hweak_div(ga, gb, fg), ntr)
