"""Channel-stacked HEVI vertical implicit solve (LOR staggering).

Port of ``models/nonhydro._column_residual`` / ``assemble_bands_analytic``
/ ``vertical_banded.banded_newton_update`` to the leading-channel layout:
every column operator application is a clean ``(K, nz) @ (nz, ncol)``
GEMM, the Newton system interleave is a reshape (not a gather), and the
banded solve (``backend.banded_solve``) takes the ``(n, 2q+1, ncol)``
layout this produces natively.

Semantics (including the ``ref_jacobian`` reference-Jacobian mode and the
AD-subgradient sign conventions) match the reference-layout path; see the
docstrings there for the C++ citations.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..models.nonhydro import exner_from_rhotheta
from .engine import FastGeometry


def static_aux(fg: FastGeometry):
    """The state-independent flattened-metric entries of the implicit
    aux dict.  Precompute ONCE per configuration (engine factories call
    this at build time) instead of reshaping the metric tensors inside
    every jitted step."""
    def fl(f):
        return f.reshape(f.shape[0], -1)

    c2 = jnp.stack([fg.c2_aa.reshape(-1), fg.c2_ab.reshape(-1),
                    fg.c2_ba.reshape(-1), fg.c2_bb.reshape(-1)])
    return {
        "c2": c2,
        "con_a_xi": fl(fg.con_a_xi), "con_b_xi": fl(fg.con_b_xi),
        "con_xi_xi": fl(fg.con_xi_xi),
        "con_a_xi_int": fl(fg.con_a_xi_int),
        "con_b_xi_int": fl(fg.con_b_xi_int),
        "con_xi_xi_int": fl(fg.con_xi_xi_int),
        "jac": fl(fg.jac3d), "jac_int": fl(fg.jac3d_int),
        "deriv_r_int": fl(fg.deriv_r_xi_int),
    }


def _prep_aux(d, fg: FastGeometry, saux=None):
    """Fixed per-column inputs of the implicit system, (rows, ncol)."""
    U = d["U"]
    Q = U.shape[1] * U.shape[2] * U.shape[3]

    def fl(f):
        return f.reshape(f.shape[0], Q)

    u_n = fl(U)
    v_n = fl(d["V"])
    ni = fg.interp_n2i.shape[0]
    big_u = fg.n2i_stack @ u_n        # one GEMM: [interp_n2i; diff_n2i]
    big_v = fg.n2i_stack @ v_n
    u_i = big_u[:ni]
    v_i = big_v[:ni]
    du_i = big_u[ni:]
    dv_i = big_v[ni:]

    if saux is None:
        saux = static_aux(fg)
    aux = dict(saux, u_n=u_n, v_n=v_n, u_i=u_i, v_i=v_i,
               du_i=du_i, dv_i=dv_i)
    x_parts = (fl(d["Rt"]), fl(d["W"]), fl(d["Rho"]))
    return x_parts, aux


def residual_lor(x_parts, x0_parts, aux, fg: FastGeometry, constants, dt):
    """(f_rt, f_w, f_rho) of the HEVI column residual, batched over
    columns with the level axis leading.  Port of
    ``nonhydro._column_residual``; the time term uses x0 explicitly so
    multi-iteration Newton works."""
    nz = fg.nz
    rt, w, rho = x_parts
    rt0, w0, rho0 = x0_parts
    c = constants

    w_n = fg.interp_i2n @ w
    rho_i = fg.interp_n2i @ rho
    rt_i = fg.interp_n2i @ rt

    exner_n = exner_from_rhotheta(rt, c)
    dpi_i = fg.diff_n2i @ exner_n

    xid_n = (aux["con_a_xi"] * aux["u_n"] + aux["con_b_xi"] * aux["v_n"]
             + aux["con_xi_xi"] * w_n)
    xid_i = (aux["con_a_xi_int"] * aux["u_i"]
             + aux["con_b_xi_int"] * aux["v_i"]
             + aux["con_xi_xi_int"] * w)
    xid_i = xid_i.at[0].set(0.0).at[-1].set(0.0)

    mf_i = aux["jac_int"] * rho_i * xid_i
    mf_i = mf_i.at[0].set(0.0).at[-1].set(0.0)
    f_rho = (fg.diff_i2n @ mf_i) / aux["jac"]

    pf_i = aux["jac_int"] * rt_i * xid_i
    pf_i = pf_i.at[0].set(0.0).at[-1].set(0.0)
    f_rt = (fg.diff_i2n @ pf_i) / aux["jac"]

    con_ua_n = (fg.c2_aa.reshape(1, -1) * aux["u_n"]
                + fg.c2_ab.reshape(1, -1) * aux["v_n"]
                + aux["con_a_xi"] * w_n)
    con_ub_n = (fg.c2_ba.reshape(1, -1) * aux["u_n"]
                + fg.c2_bb.reshape(1, -1) * aux["v_n"]
                + aux["con_b_xi"] * w_n)
    ke_n = 0.5 * (con_ua_n * aux["u_n"] + con_ub_n * aux["v_n"]
                  + xid_n * w_n)
    dke_i = fg.diff_n2i @ ke_n

    con_ua_i = (fg.c2_aa.reshape(1, -1) * aux["u_i"]
                + fg.c2_ab.reshape(1, -1) * aux["v_i"]
                + aux["con_a_xi_int"] * w)
    con_ub_i = (fg.c2_ba.reshape(1, -1) * aux["u_i"]
                + fg.c2_bb.reshape(1, -1) * aux["v_i"]
                + aux["con_b_xi_int"] * w)
    curl = -con_ua_i * aux["du_i"] - con_ub_i * aux["dv_i"]

    pgf = dpi_i * rt_i / rho_i
    f_w = pgf + constants.g * aux["deriv_r_int"] + dke_i + curl
    f_w = f_w.at[0].set(0.0).at[-1].set(0.0)

    vo = fg.vo
    if fg.penalty_left is not None and nz // vo > 1:
        wb = jnp.abs(xid_i[vo:nz:vo])
        wl = fg.wscat_left @ wb
        wr = fg.wscat_right @ wb
        f_rt = f_rt - (fg.penalty_left @ rt) * wl \
            - (fg.penalty_right @ rt) * wr
        f_rho = f_rho - (fg.penalty_left @ rho) * wl \
            - (fg.penalty_right @ rho) * wr
    ddw = fg.diffdiff_i2i @ w
    ddw = ddw.at[0].set(0.0).at[-1].set(0.0)
    upwind_coeff = 0.5 / nz
    f_w = f_w - upwind_coeff * jnp.abs(xid_i) * ddw
    f_w = f_w.at[0].set(0.0).at[-1].set(0.0)

    inv_dt = 1.0 / dt
    return (f_rt + (rt - rt0) * inv_dt,
            f_w + (w - w0) * inv_dt,
            f_rho + (rho - rho0) * inv_dt)


def _shift_rows(b, o, K):
    """out[k] = b[k + o] for k in [0, K), zero out of range."""
    L = b.shape[0]
    k0, k1 = max(0, -o), min(K, L - o)
    pre = jnp.zeros((k0,) + b.shape[1:], b.dtype)
    post = jnp.zeros((K - k1,) + b.shape[1:], b.dtype)
    return jnp.concatenate([pre, b[k0 + o:k1 + o], post], axis=0)


def assemble_bands(x_parts, aux, fg: FastGeometry, statics, constants, dt,
                   ref_jacobian: bool = False):
    """Banded Jacobian (n, 2q+1, ncol) of the column residual.

    Port of ``nonhydro.assemble_bands_analytic`` (same static tensors from
    ``band_assembly_statics``; same exact/reference Jacobian modes), built
    with leading-row GEMMs and finishing with reshapes instead of the
    (2, 0, 1) transposes of the trailing-column layout.
    """
    c = constants
    nz = fg.nz
    q = statics["q"]
    b = 2 * q + 1
    rt0, w0, rho0 = x_parts
    ncol = rt0.shape[1]
    dtype = rt0.dtype

    w_n0 = fg.interp_i2n @ w0
    rho_i0 = fg.interp_n2i @ rho0
    rt_i0 = fg.interp_n2i @ rt0
    pi_n0 = exner_from_rhotheta(rt0, c)
    dpi_drt = (c.Rd / (c.Cp - c.Rd)) * pi_n0 / rt0
    dpi_i0 = fg.diff_n2i @ pi_n0
    cXi = aux["con_xi_xi_int"]
    xid_n0 = (aux["con_a_xi"] * aux["u_n"] + aux["con_b_xi"] * aux["v_n"]
              + aux["con_xi_xi"] * w_n0)
    xid_i0 = (aux["con_a_xi_int"] * aux["u_i"]
              + aux["con_b_xi_int"] * aux["v_i"] + cXi * w0)
    mask = jnp.ones((nz + 1, 1), dtype).at[0].set(0.0).at[-1].set(0.0)
    xid_i0 = xid_i0 * mask
    jac_i = aux["jac_int"]
    inv_jac = 1.0 / aux["jac"]
    curl_coef = -(aux["con_a_xi_int"] * aux["du_i"]
                  + aux["con_b_xi_int"] * aux["dv_i"])
    ddw0 = (fg.diffdiff_i2i @ w0) * mask
    upw_c = 0.5 / nz
    if ref_jacobian:
        sgn_xid = jnp.sign(xid_i0)
    else:
        sgn_xid = jnp.where(xid_i0 >= 0, 1.0, -1.0)

    d1 = jac_i * xid_i0
    e_rt = jac_i * rt_i0 * cXi * mask
    e_rho = jac_i * rho_i0 * cXi * mask
    inv_rho_i = 1.0 / rho_i0
    r1 = rt_i0 * inv_rho_i
    r2 = dpi_i0 * inv_rho_i
    r3 = -dpi_i0 * rt_i0 * inv_rho_i * inv_rho_i

    has_pen = statics["has_penalty"]
    if has_pen:
        vo = statics["vo"]
        edge_sl = slice(vo, nz, vo)
        wb0 = jnp.abs(xid_i0[edge_sl])
        wl0 = fg.wscat_left @ wb0
        wr0 = fg.wscat_right @ wb0
        lrt0 = fg.penalty_left @ rt0
        rrt0 = fg.penalty_right @ rt0
        lrho0 = fg.penalty_left @ rho0
        rrho0 = fg.penalty_right @ rho0
        if ref_jacobian:
            sgn_edge = jnp.sign(xid_i0[edge_sl]) * cXi[edge_sl]
        else:
            sgn_edge = jnp.where(xid_i0[edge_sl] >= 0, 1.0, -1.0) \
                * cXi[edge_sl]

    def npa(a):
        return jnp.asarray(a, dtype)

    def col(vec):
        """(K,) static band vector -> (K, 1) broadcaster."""
        return npa(vec)[:, None]

    zrow_n = jnp.zeros((nz, ncol), dtype)
    zrow_i = jnp.zeros((nz + 1, ncol), dtype)
    rt_slots = [zrow_n] * b
    rho_slots = [zrow_n] * b
    w_slots = [zrow_i] * b

    # (rt,rt) and (rho,rho)
    for o in statics["offs0"]:
        d = q + 3 * o
        val = inv_jac * (npa(statics["TA"][o]) @ d1)
        if has_pen:
            val = val - wl0 * col(statics["Pl_b"][o]) \
                - wr0 * col(statics["Pr_b"][o])
        if o == 0:
            val = val + 1.0 / dt
        rt_slots[d] = rt_slots[d] + val
        rho_slots[d] = rho_slots[d] + val

    # (rt,w): delta = +1
    for o in statics["offs_p1"]:
        d = q + 3 * o + 1
        v_rt = inv_jac * col(statics["Di2n_b"][o]) * _shift_rows(e_rt, o, nz)
        if has_pen:
            v_rt = v_rt - lrt0 * (npa(statics["Ul"][o]) @ sgn_edge) \
                - rrt0 * (npa(statics["Ur"][o]) @ sgn_edge)
        rt_slots[d] = rt_slots[d] + v_rt

    # (rho,w): delta = -1
    for o in statics["offs_m1"]:
        d = q + 3 * o - 1
        v_rho = inv_jac * col(statics["Di2n_b"][o]) \
            * _shift_rows(e_rho, o, nz)
        if has_pen:
            v_rho = v_rho - lrho0 * (npa(statics["Ul"][o]) @ sgn_edge) \
                - rrho0 * (npa(statics["Ur"][o]) @ sgn_edge)
        rho_slots[d] = rho_slots[d] + v_rho

    # (w,rt): delta = -1
    for o in statics["offs_m1"]:
        d = q + 3 * o - 1
        v = mask * (r1 * col(statics["Dn2i_b"][o])
                    * _shift_rows(dpi_drt, o, nz + 1)
                    + r2 * col(statics["In2i_b"][o]))
        w_slots[d] = w_slots[d] + v

    # (w,rho): delta = +1
    for o in statics["offs_p1"]:
        d = q + 3 * o + 1
        v2 = mask * r3 * col(statics["In2i_b"][o])
        w_slots[d] = w_slots[d] + v2

    # (w,w)
    for o in statics["offs0"]:
        d = q + 3 * o
        val = npa(statics["TB"][o]) @ xid_n0
        val = val - upw_c * jnp.abs(xid_i0) * col(statics["DDb"][o])
        if o == 0:
            val = val - upw_c * sgn_xid * ddw0 * cXi * mask
            if not ref_jacobian:
                val = val + curl_coef
        val = val * mask
        if o >= 1:
            last_col = jnp.zeros((nz + 1, 1), dtype).at[nz - o].set(1.0)
            w_slots[d - 1] = w_slots[d - 1] + val * last_col
            val = val * (1.0 - last_col)
        if o == 0:
            val = val + 1.0 / dt
        w_slots[d] = w_slots[d] + val

    # interleave rows [Rt_k, W_k, Rho_k]*, W_nz — reshapes only
    rt_t = jnp.stack(rt_slots, axis=1)                # (nz, b, ncol)
    rho_t = jnp.stack(rho_slots, axis=1)
    w_t = jnp.stack(w_slots, axis=1)                  # (nz+1, b, ncol)
    trip = jnp.stack([rt_t, w_t[:nz], rho_t], axis=1)  # (nz, 3, b, ncol)
    return jnp.concatenate(
        [trip.reshape(3 * nz, b, ncol), w_t[nz:]], axis=0)


def _interleave(f_rt, f_w, f_rho, nz):
    trip = jnp.stack([f_rt, f_w[:nz], f_rho], axis=1)  # (nz, 3, ncol)
    return jnp.concatenate(
        [trip.reshape(3 * nz, -1), f_w[nz:]], axis=0)


def _deinterleave(dx, nz):
    d_rt = dx[0:3 * nz:3]
    d_w = jnp.concatenate([dx[1:3 * nz:3], dx[3 * nz:]], axis=0)
    d_rho = dx[2:3 * nz:3]
    return d_rt, d_w, d_rho


def vertical_implicit(d, fg: FastGeometry, constants, dt, q, statics,
                      newton_iters: int = 1, ref_jacobian: bool = False,
                      saux=None, solver=None):
    """Batched Newton-banded implicit update of (Rt, W, Rho).

    ``saux``: precomputed ``static_aux(fg)`` (hoists the constant metric
    flattening out of the jitted step).  ``solver``: the banded-solve
    implementation (``backend.banded_solve``; default by platform)."""
    from ..backend import banded_solve

    nz = fg.nz
    shp = d["U"].shape[1:]
    x0_parts, aux = _prep_aux(d, fg, saux)

    x_parts = x0_parts
    for _ in range(newton_iters):
        f_rt, f_w, f_rho = residual_lor(
            x_parts, x0_parts, aux, fg, constants, dt)
        f = _interleave(f_rt, f_w, f_rho, nz)
        bands = assemble_bands(x_parts, aux, fg, statics, constants, dt,
                               ref_jacobian=ref_jacobian)
        dx = banded_solve(bands, f, q, solver=solver)
        d_rt, d_w, d_rho = _deinterleave(dx, nz)
        x_parts = (x_parts[0] - d_rt, x_parts[1] - d_w,
                   x_parts[2] - d_rho)

    rt, w, rho = x_parts
    return dict(d, Rt=rt.reshape((nz,) + shp),
                W=w.reshape((nz + 1,) + shp),
                Rho=rho.reshape((nz,) + shp))
