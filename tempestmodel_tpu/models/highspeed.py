"""HighSpeedDynamics: momentum-form SE-horizontal / FD-vertical dycore.

JAX re-design of the reference's ``--hmethod hs`` path
(``src/atm/HighSpeedDynamics.{h,cpp}``), the second acoustic-implicit
dynamics variant:

- prognostic variables are CONTRAVARIANT MOMENTA (the reference requires
  the ``PROGNOSTIC_CONTRAVARIANT_MOMENTA`` build, ``HighSpeedDynamics
  .cpp:60-63``): MU = rho*u^a, MV = rho*u^b on levels, Rt = rho*theta,
  Rho on levels, MW = rho*w (physical vertical momentum) on interfaces.
- the vertical discretization is 2nd-order finite differences in
  physical z (``dataZn``/``dataZi`` spacings), not the vertical FEM
  operators of ``VerticalDynamicsFEM`` — that is what makes it "high
  speed": the implicit acoustic step reduces to one symmetric
  tridiagonal solve per column (``StepImplicitCombine``,
  ``HighSpeedDynamics.cpp:1007-1521``), batched here over every column
  at once through ``jax.lax.linalg.tridiagonal_solve``.
- the explicit step (``StepExplicitCombine``, ``:363-1006``) is the
  flux-form SE dynamics: variational (stiffness) horizontal flux
  divergences of mass / potential-temperature density / vertical
  momentum, strong-form pressure + kinetic-energy gradients along z
  surfaces, and the 2-D vector-invariant vorticity force.
- the driver is the fused-combine ARS343 scheme
  (``TimestepSchemeARS343b.cpp``): 4 explicit stages, 3 implicit
  acoustic solves, stage states recombined linearly ("Combine"
  interface) instead of storing tendencies.

Deviations (documented):
- tracers are not advected by the HS path (the reference's HS build has
  no tracer terms in StepExplicitCombine either — only the positivity
  filter).
- the nu4 hyperdiffusion tail is applied in velocity form by the shared
  ``hyperdiff.step_after_subcycle_nh`` after converting back, instead
  of re-deriving the momentum-form Laplacians
  (``HighSpeedDynamics.cpp:1527-2170``); the operators agree on smooth
  fields to the same truncation order.
- the surface boundary condition is w = 0 (flat bottom), exactly as the
  reference imposes (``dataUpdateREdge(WIx,...,0) = 0``, ``:1506``);
  terrain metrics are carried but the HS bottom BC does not follow
  terrain.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import sem


# ---------------------------------------------------------------------------
# state conversion: velocity form (U, V cov / W = u_xi)  <->  momentum form
# ---------------------------------------------------------------------------

def _w_nodes(w_e):
    """0.5-average an interface field to levels (reference convention)."""
    return 0.5 * (w_e[..., :-1] + w_e[..., 1:])


def _edge_avg(f_n):
    """0.5-average a level field to INTERIOR interfaces (k = 1..nz-1)."""
    return 0.5 * (f_n[..., :-1] + f_n[..., 1:])


def _pad_interfaces(f_int):
    """Pad an interior-interface (..., nz-1) field with zero boundaries."""
    z = jnp.zeros_like(f_int[..., :1])
    return jnp.concatenate([z, f_int, z], axis=-1)


def to_momentum(s, geom):
    """Velocity-form state dict -> momentum-form dict {MU, MV, Rt, Rho, MW}.

    w_phys = W / (dz/dxi) on interfaces (the covariant vertical velocity
    relation u_xi = (dz/dxi) * w for Gal-Chen metrics); horizontal
    contravariant components from the 3-D metric identity
    u^i = h^ij (u_j - z_j w).
    """
    rho = s["Rho"]
    zxi_i = geom.deriv_r_int[..., 2]
    w_e = s["W"] / zxi_i
    w_n = _w_nodes(w_e)
    za = geom.deriv_r[..., 0]
    zb = geom.deriv_r[..., 1]
    ua_eff = s["U"] - za * w_n
    ub_eff = s["V"] - zb * w_n
    c2 = geom.con2d
    con_ua = c2[..., 0, 0, None] * ua_eff + c2[..., 0, 1, None] * ub_eff
    con_ub = c2[..., 1, 0, None] * ua_eff + c2[..., 1, 1, None] * ub_eff
    rho_e = _pad_interfaces(_edge_avg(rho))
    rho_e = rho_e.at[..., 0].set(rho[..., 0]).at[..., -1].set(rho[..., -1])
    return {
        "MU": rho * con_ua,
        "MV": rho * con_ub,
        "Rt": s["Rt"],
        "Rho": rho,
        "MW": rho_e * w_e,
    }


def from_momentum(m, geom):
    """Momentum-form dict -> velocity-form state (exact inverse)."""
    rho = m["Rho"]
    con_ua = m["MU"] / rho
    con_ub = m["MV"] / rho
    rho_e = _pad_interfaces(_edge_avg(rho))
    rho_e = rho_e.at[..., 0].set(rho[..., 0]).at[..., -1].set(rho[..., -1])
    w_e = m["MW"] / rho_e
    w_n = _w_nodes(w_e)
    cv = geom.cov2d
    za = geom.deriv_r[..., 0]
    zb = geom.deriv_r[..., 1]
    u_cov = (cv[..., 0, 0, None] * con_ua + cv[..., 0, 1, None] * con_ub
             + za * w_n)
    v_cov = (cv[..., 1, 0, None] * con_ua + cv[..., 1, 1, None] * con_ub
             + zb * w_n)
    return {
        "U": u_cov,
        "V": v_cov,
        "Rt": m["Rt"],
        "W": geom.deriv_r_int[..., 2] * w_e,
        "Rho": rho,
    }


# ---------------------------------------------------------------------------
# explicit tendencies (StepExplicitCombine, HighSpeedDynamics.cpp:363-1006)
# ---------------------------------------------------------------------------

def hs_explicit_tendency(m, geom, constants):
    """Time-tendencies of the momentum-form state (no dt, no DSS)."""
    nea, neb, p = geom.nea, geom.neb, geom.p
    da, db = geom.delta_a, geom.delta_b
    D, S = geom.deriv, geom.stiff

    mu, mv = m["MU"], m["MV"]
    rt, rho, mw = m["Rt"], m["Rho"], m["MW"]
    c = constants

    z_n, z_i = geom.z_lev, geom.z_int
    dz_lev = z_i[..., 1:] - z_i[..., :-1]            # level thickness (nz,)
    dz_hat = z_n[..., 1:] - z_n[..., :-1]            # node spacing (nz-1,)

    # ---- interface auxiliaries (interior k = 1..nz-1, zero-padded) -----
    inv_rho_e = 1.0 / _edge_avg(rho)
    mu_e = _edge_avg(mu)
    mv_e = _edge_avg(mv)
    mw_int = mw[..., 1:-1]
    za_i = geom.deriv_r_int[..., 1:-1, 0]
    zb_i = geom.deriv_r_int[..., 1:-1, 1]
    # sdot: vertical mass flux through the moving level surface, per rho
    sdot = (mw_int - mu_e * za_i - mv_e * zb_i) * inv_rho_e
    sdot_ua = _pad_interfaces(sdot * mu_e)
    sdot_ub = _pad_interfaces(sdot * mv_e)
    jac_i = geom.jac3d_int
    vmflux_base = jac_i[..., 1:-1] * mw_int * inv_rho_e
    vmflux_a = _pad_interfaces(vmflux_base * mu_e)
    vmflux_b = _pad_interfaces(vmflux_base * mv_e)

    # ---- level auxiliaries ---------------------------------------------
    inv_rho = 1.0 / rho
    con_ua = mu * inv_rho
    con_ub = mv * inv_rho
    cv = geom.cov2d
    cov_ua = cv[..., 0, 0, None] * con_ua + cv[..., 0, 1, None] * con_ub
    cov_ub = cv[..., 1, 0, None] * con_ua + cv[..., 1, 1, None] * con_ub
    jac = geom.jac3d
    mflux_a = jac * mu
    mflux_b = jac * mv
    theta = rt * inv_rho
    pflux_a = mflux_a * theta
    pflux_b = mflux_b * theta
    ke = 0.5 * (cov_ua * con_ua + cov_ub * con_ub)
    # vertical momentum flux sdot*W at nodes (mass-weighted)
    sdot_w_n = (_w_nodes(mw)
                - geom.deriv_r[..., 0] * mu
                - geom.deriv_r[..., 1] * mv)
    pres = c.pressure_from_rhotheta(rt)

    # ---- horizontal derivatives ----------------------------------------
    div_mass = sem.weak_div(mflux_a, mflux_b, S, nea, neb, p, da, db)
    div_pres = sem.weak_div(pflux_a, pflux_b, S, nea, neb, p, da, db)
    dp_a, dp_b = sem.deriv_both(pres, D, nea, neb, p, da, db)
    dke_a, dke_b = sem.deriv_both(ke, D, nea, neb, p, da, db)
    dcovub_a = sem.deriv_a(cov_ub, D, nea, neb, p, da)
    dcovua_b = sem.deriv_b(cov_ua, D, nea, neb, p, db)

    # pressure gradient along z surfaces: remove the slope contribution
    # with a centered z-derivative (one-sided at top/bottom, :801-822)
    dzp_int = (pres[..., 1:] - pres[..., :-1]) / dz_hat     # (nz-1,)
    dzp = jnp.concatenate([
        dzp_int[..., :1],
        (pres[..., 2:] - pres[..., :-2]) / (z_n[..., 2:] - z_n[..., :-2]),
        dzp_int[..., -1:],
    ], axis=-1)
    dp_a = dp_a - geom.deriv_r[..., 0] * dzp
    dp_b = dp_b - geom.deriv_r[..., 1] * dzp

    c2 = geom.con2d
    con_dp_a = c2[..., 0, 0, None] * dp_a + c2[..., 0, 1, None] * dp_b
    con_dp_b = c2[..., 1, 0, None] * dp_a + c2[..., 1, 1, None] * dp_b
    con_dke_a = c2[..., 0, 0, None] * dke_a + c2[..., 0, 1, None] * dke_b
    con_dke_b = c2[..., 1, 0, None] * dke_a + c2[..., 1, 1, None] * dke_b

    inv_j2d = (1.0 / geom.jac2d)[..., None]
    abs_vort = geom.coriolis[..., None] + inv_j2d * (dcovub_a - dcovua_b)
    vort_a = -abs_vort * inv_j2d * cov_ub
    vort_b = abs_vort * inv_j2d * cov_ua

    inv_jac = 1.0 / jac
    flux_div = inv_jac * div_mass
    dz_mom_a = (sdot_ua[..., 1:] - sdot_ua[..., :-1]) / dz_lev
    dz_mom_b = (sdot_ub[..., 1:] - sdot_ub[..., :-1]) / dz_lev

    d_mu = (-con_dp_a - rho * (con_dke_a + vort_a)
            - flux_div * con_ua - dz_mom_a)
    if geom.is_xz:
        d_mv = jnp.zeros_like(mv)
    else:
        d_mv = (-con_dp_b - rho * (con_dke_b + vort_b)
                - flux_div * con_ub - dz_mom_b)
    d_rho = -flux_div
    d_rt = -inv_jac * div_pres

    # ---- W tendency on interior interfaces ------------------------------
    div_w = sem.weak_div(vmflux_a, vmflux_b, S, nea, neb, p, da, db)
    dz_wflux = (sdot_w_n[..., 1:] - sdot_w_n[..., :-1]) / dz_hat
    d_mw = _pad_interfaces(-(div_w[..., 1:-1] / jac_i[..., 1:-1] + dz_wflux))

    return {"MU": d_mu, "MV": d_mv, "Rt": d_rt, "Rho": d_rho, "MW": d_mw}


# ---------------------------------------------------------------------------
# implicit acoustic solve (StepImplicitCombine, :1007-1521)
# ---------------------------------------------------------------------------

def hs_implicit_update(m, geom, constants, dt):
    """One implicit acoustic solve: tridiagonal in W, then mass/theta flux.

    Returns the updated momentum-form state (combine = copy of the
    argument, the ARS343b usage).  The linear system couples W at
    interfaces k-1, k, k+1 through the linearized pressure and buoyancy
    terms; the reference solves it per column with the Thomas algorithm
    (``USE_VECTOR_TRIDIAGONAL_SOLVE``); here every column at once.
    """
    c = constants
    rt, rho, mw = m["Rt"], m["Rho"], m["MW"]
    z_n, z_i = geom.z_lev, geom.z_int
    nz = rt.shape[-1]
    dtype = rt.dtype

    pres = c.pressure_from_rhotheta(rt)
    dpdtheta = c.gamma * pres / rt                  # levels

    rho_e = _edge_avg(rho)                          # interior (nz-1,)
    theta_e = _edge_avg(rt) / rho_e

    inv_dz_lev = 1.0 / (z_i[..., 1:] - z_i[..., :-1])      # (nz,)
    inv_dz_hat = 1.0 / (z_n[..., 1:] - z_n[..., :-1])      # (nz-1,)

    # interior rows k = 1..nz-1: index arrays by level slices
    inv_dz_k = inv_dz_lev[..., 1:]                  # level k
    inv_dz_km = inv_dz_lev[..., :-1]                # level k-1
    dpdt_k = dpdtheta[..., 1:]
    dpdt_km = dpdtheta[..., :-1]
    # theta_e at interfaces k-1 / k+1 (zero-padded: multiplies W=0 rows)
    theta_pad = _pad_interfaces(theta_e)            # (nz+1,)
    th_km = theta_pad[..., :-2]                     # interface k-1
    th_k = theta_e                                  # interface k
    th_kp = theta_pad[..., 2:]                      # interface k+1

    dt2 = dt * dt
    g = c.g
    a_int = -dt2 * inv_dz_km * (inv_dz_hat * dpdt_km * th_km - 0.5 * g)
    b_int = 1.0 + dt2 * (
        inv_dz_hat * th_k * (dpdt_k * inv_dz_k + dpdt_km * inv_dz_km)
        + 0.5 * g * (inv_dz_k - inv_dz_km))
    c_int = -dt2 * inv_dz_k * (inv_dz_hat * dpdt_k * th_kp + 0.5 * g)
    d_int = mw[..., 1:-1] - dt * (
        inv_dz_hat * (pres[..., 1:] - pres[..., :-1]) + g * rho_e)

    # boundary rows: W(0) = W(nz) = 0
    one = jnp.ones_like(a_int[..., :1])
    zero = jnp.zeros_like(one)
    dl = jnp.concatenate([zero, a_int, zero], axis=-1)
    dd = jnp.concatenate([one, b_int, one], axis=-1)
    du = jnp.concatenate([zero, c_int, zero], axis=-1)
    rhs = jnp.concatenate([zero, d_int, zero], axis=-1)

    # batched Thomas solve over all columns
    P, A, B = rt.shape[:3]
    shape = (P * A * B, nz + 1)
    w_new = jax.lax.linalg.tridiagonal_solve(
        dl.reshape(shape), dd.reshape(shape), du.reshape(shape),
        rhs.reshape(shape)[..., None])[..., 0].reshape(rt.shape[:3] + (nz + 1,))
    w_new = w_new.astype(dtype)

    # updates (:1416-1506): implicit vertical mass and rhotheta fluxes
    dz_mass = (w_new[..., 1:] - w_new[..., :-1]) * inv_dz_lev
    w_theta = w_new * _pad_interfaces(theta_e)
    dz_ptheta = (w_theta[..., 1:] - w_theta[..., :-1]) * inv_dz_lev

    return {
        "MU": m["MU"],
        "MV": m["MV"],
        "Rt": rt - dt * dz_ptheta,
        "Rho": rho - dt * dz_mass,
        "MW": w_new.at[..., 0].set(0.0),
    }


# ---------------------------------------------------------------------------
# DSS for the momentum-form state
# ---------------------------------------------------------------------------

def make_momentum_dss(geom) -> Callable:
    """DSS of {MU, MV, Rt, Rho, MW}: CONTRAVARIANT panel-edge transforms.

    Contravariant components transform with the inverse-transpose of the
    covariant edge matrices (``CubedSphereTrans::VecPanelTrans`` vs
    ``CoVecPanelTrans``), so the momentum DSS cannot reuse
    ``apply_dss_vector`` directly.
    """
    from ..grid.geometry import CubedSphereGeometry
    from ..grid.cartesian import CartesianGeometry

    if isinstance(geom, CartesianGeometry):
        from ..grid.cartesian import apply_dss_cartesian

        def dss_cart(m):
            out = {k: apply_dss_cartesian(v, geom) for k, v in m.items()}
            # no-flux walls: zero normal contravariant momentum
            if geom.bc_x == "noflux":
                out["MU"] = out["MU"].at[:, 0].set(0.0).at[:, -1].set(0.0)
            if geom.bc_y == "noflux":
                out["MV"] = out["MV"].at[:, :, 0].set(0.0) \
                                     .at[:, :, -1].set(0.0)
            return out

        return dss_cart

    assert isinstance(geom, CubedSphereGeometry)
    from ..parallel.dss import apply_dss_scalar, apply_dss_vector

    cov = np.asarray(geom.edge_mats)
    contra = jnp.asarray(np.swapaxes(np.linalg.inv(cov), -1, -2),
                         dtype=jnp.asarray(geom.jac2d).dtype)

    def dss_sphere(m):
        mu, mv = apply_dss_vector(m["MU"], m["MV"], geom, mats=contra)
        return {
            "MU": mu,
            "MV": mv,
            "Rt": apply_dss_scalar(m["Rt"], geom),
            "Rho": apply_dss_scalar(m["Rho"], geom),
            "MW": apply_dss_scalar(m["MW"], geom),
        }

    return dss_sphere


# ---------------------------------------------------------------------------
# ARS343b fused-combine driver (TimestepSchemeARS343b.cpp)
# ---------------------------------------------------------------------------

def _ars343b_combos():
    """Stage-combination coefficients of the fused ARS(3,4,3) driver.

    Transcribed from ``TimestepSchemeARS343b.cpp:52-172`` (Ascher,
    Ruuth & Spiteri 1997, p. 9 tableau, re-expressed as running linear
    combinations of the 7 stored stage states).
    """
    g = 0.4358665215084590
    b1 = -1.5 * g * g + 4.0 * g - 0.25
    b2 = 1.5 * g * g - 5.0 * g + 1.25
    a42 = a43 = 0.5529291480359398
    a31 = ((1.0 - 4.5 * g + 1.5 * g * g) * a42
           + (2.75 - 10.5 * g + 3.75 * g * g) * a43
           - 3.5 + 13.0 * g - 4.5 * g * g)
    a32 = ((-1.0 + 4.5 * g - 1.5 * g * g) * a42
           + (-2.75 + 10.5 * g - 3.75 * g * g) * a43
           + 4.0 - 12.5 * g + 4.5 * g * g)
    a41 = 1.0 - a42 - a43

    imp = [[g, 0.0, 0.0, 0.0],
           [0.5 * (1.0 - g), g, 0.0, 0.0],
           [b1, b2, g, 0.0],
           [b1, b2, g, 0.0]]
    exp_ = [[g, 0.0, 0.0, 0.0],
            [a31, a32, 0.0, 0.0],
            [a41, a42, a43, 0.0],
            [0.0, b1, b2, g]]

    diag_exp = [exp_[s][s] for s in range(4)]
    diag_imp = [imp[s][s] for s in range(4)]

    u2f = [1.0 - exp_[1][0] / exp_[0][0],
           exp_[1][0] / exp_[0][0] - imp[1][0] / imp[0][0],
           imp[1][0] / imp[0][0]]

    u3f = [1.0 - exp_[2][0] / exp_[0][0],
           exp_[2][0] / exp_[0][0] - imp[2][0] / imp[0][0],
           imp[2][0] / imp[0][0],
           exp_[2][1] / exp_[1][1] - imp[2][1] / imp[1][1],
           imp[2][1] / imp[1][1]]
    u3f7 = -exp_[2][1] / exp_[1][1]
    for i in range(3):
        u3f[i] += u3f7 * u2f[i]

    u4f = [1.0 - exp_[3][0] / exp_[0][0],
           exp_[3][0] / exp_[0][0] - imp[3][0] / imp[0][0],
           imp[3][0] / imp[0][0],
           exp_[3][1] / exp_[1][1] - imp[3][1] / imp[1][1],
           imp[3][1] / imp[1][1],
           exp_[3][2] / exp_[2][2] - imp[3][2] / imp[2][2],
           imp[3][2] / imp[2][2]]
    u4f7 = -exp_[3][1] / exp_[1][1]
    u4f8 = -exp_[3][2] / exp_[2][2]
    for i in range(3):
        u4f[i] += u4f7 * u2f[i] + u4f8 * u3f[i]
    u4f[3] += u4f8 * u3f[3]
    u4f[4] += u4f8 * u3f[4]

    return diag_exp, diag_imp, u2f, u3f, u4f


def _combine(insts, coeffs):
    """Linear combination of momentum-state pytrees."""
    out = jax.tree_util.tree_map(lambda a: coeffs[0] * a, insts[0])
    for s in range(1, len(insts)):
        out = jax.tree_util.tree_map(
            lambda a, b: a + coeffs[s] * b, out, insts[s])
    return out


def make_hs_step(cfg, geom, dss_state: Callable, ref_state=None):
    """(first_step, step) for ``--hmethod hs`` (self-starting, carry unused).

    Matches the Strang-stepper interface so it slots into ``Model`` /
    ``make_nh_step``.  One step = the full ARS343b stage sequence
    (``TimestepSchemeARS343b.cpp:176-245``) in momentum form, followed
    by the shared nu4 hyperdiffusion + Rayleigh tail in velocity form.
    """
    from . import hyperdiff

    constants = cfg.constants
    dt = cfg.dt
    diag_exp, diag_imp, u2f, u3f, u4f = _ars343b_combos()
    dss_m = make_momentum_dss(geom)

    def explicit(insts, coeffs, arg, dts):
        tend = hs_explicit_tendency(arg, geom, constants)
        out = _combine(insts, coeffs)
        out = jax.tree_util.tree_map(
            lambda a, t: a + (dts * dt) * t, out, tend)
        return dss_m(out)          # PostProcessSubstage

    def implicit(arg, dts):
        return dss_m(hs_implicit_update(arg, geom, constants, dts * dt))

    @jax.jit
    def step(state, carry=None):
        u0 = to_momentum(state, geom)
        uf1 = explicit([u0], [1.0], u0, diag_exp[0])
        u1 = implicit(uf1, diag_imp[0])
        uf2 = explicit([u0, uf1, u1], u2f, u1, diag_exp[1])
        u2 = implicit(uf2, diag_imp[1])
        uf3 = explicit([u0, uf1, u1, uf2, u2], u3f, u2, diag_exp[2])
        u3 = implicit(uf3, diag_imp[2])
        uf4 = explicit([u0, uf1, u1, uf2, u2, uf3, u3], u4f, u3, diag_exp[3])
        s = from_momentum(uf4, geom)
        s = hyperdiff.step_after_subcycle_nh(
            s, dt, cfg, geom, dss_state, ref_state)
        return s, 0.0

    @jax.jit
    def first_step(state):
        return step(state, None)

    return first_step, step
