"""Reed-Jablonowski (2012) DCMIP "simple physics" package.

JAX port of ``test/dcmip2016/interface/simple_physics_v6.f90``
(wrapped by ``test/dcmip2016/DCMIPPhysics.cpp``): large-scale condensation,
Smith-Vogl surface fluxes (implicit), and Ekman boundary-layer diffusion
solved with the Thomas algorithm — all batched over every column.

Level ordering here is the model's (k=0 surface .. k=nz-1 top); the
reference Fortran orders top-down, so its k+1 recurrences become k-1 here.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..model import WorkflowProcess

# constants (simple_physics_v6.f90:230-270)
GRAVIT = 9.80616
RAIR = 287.0
CPAIR = 1.0045e3
LATVAP = 2.5e6
RH2O = 461.5
EPSILO = RAIR / RH2O
ZVIR = (RH2O / RAIR) - 1.0
C_DRAG = 0.0011
SST_TC = 302.15
T0C = 273.16
E0 = 610.78
RHOW = 1000.0
CD0 = 0.0007
CD1 = 0.000065
CM = 0.002
V20 = 20.0
P0 = 100000.0
PBLTOP = 85000.0
PBLCONST = 10000.0


def _qsat(p, t):
    return EPSILO * E0 / p * jnp.exp(-LATVAP / RH2O * (1.0 / t - 1.0 / T0C))


def simple_physics_update(u, v, t, q, pmid, pint, ps, tsurf, dt,
                          rj2012_precip: bool = True, wind_speed=None):
    """One physics step on (..., nz) columns, k=0 at the surface.

    Returns (u, v, t, q, precl).  ``pint``: (..., nz+1) interface pressures
    with pint[..., 0] = ps.  ``u``/``v`` may be any fixed pointwise linear
    combination of the physical wind components (e.g. covariant) since the
    PBL/drag operator is a per-column scalar linear operator; pass
    ``wind_speed`` = |v|(surface) explicitly in that case.
    """
    nz = t.shape[-1]
    pdel = pint[..., :-1] - pint[..., 1:]            # > 0
    rpdel = 1.0 / pdel

    precl = jnp.zeros(t.shape[:-1], t.dtype)

    # ---- large-scale condensation (RJ2012) ----
    if rj2012_precip:
        qsat = _qsat(pmid, t)
        cond = (q - qsat) / (1.0 + (LATVAP / CPAIR)
                             * (EPSILO * LATVAP * qsat / (RAIR * t * t)))
        cond = jnp.where(q > qsat, cond, 0.0)
        t = t + LATVAP / CPAIR * cond
        q = q - cond
        precl = precl + jnp.sum(cond * pdel, axis=-1) / (dt * GRAVIT * RHOW)

    # ---- surface fluxes (implicit, lowest level) ----
    za = (RAIR / GRAVIT * t[..., 0] * (1.0 + ZVIR * q[..., 0]) * 0.5
          * (jnp.log(ps) - jnp.log(pint[..., 1])))
    if wind_speed is None:
        wind = jnp.sqrt(u[..., 0] ** 2 + v[..., 0] ** 2)
    else:
        wind = wind_speed
    cd = jnp.where(wind < V20, CD0 + CD1 * wind, CM)
    qsats = _qsat(ps, tsurf)
    mfac = 1.0 / (1.0 + cd * wind * dt / za)
    tfac = 1.0 / (1.0 + C_DRAG * wind * dt / za)
    u = u.at[..., 0].set(u[..., 0] * mfac)
    v = v.at[..., 0].set(v[..., 0] * mfac)
    t = t.at[..., 0].set(
        (t[..., 0] + C_DRAG * wind * tsurf * dt / za) * tfac)
    q = q.at[..., 0].set(
        (q[..., 0] + C_DRAG * wind * qsats * dt / za) * tfac)

    # ---- boundary-layer diffusivities (RJ2012 configuration) ----
    # Km/Ke at interfaces (index k = interface below level k)
    pint_decay = jnp.exp(-((PBLTOP - pint) / PBLCONST) ** 2)
    kfac = jnp.where(pint >= PBLTOP, 1.0, pint_decay)
    km_i = cd[..., None] * wind[..., None] * za[..., None] * kfac
    ke_i = C_DRAG * wind[..., None] * za[..., None] * kfac

    # tridiagonal coefficients: CA couples level k to k+1 (above),
    # CC couples level k to k-1 (below); interface k+1 sits between them.
    rho_i = (pint[..., 1:-1]
             / (RAIR * 0.5 * (t[..., 1:] * (1.0 + ZVIR * q[..., 1:])
                              + t[..., :-1] * (1.0 + ZVIR * q[..., :-1]))))
    dpm = pmid[..., :-1] - pmid[..., 1:]             # > 0
    diff_m = dt * GRAVIT * GRAVIT * km_i[..., 1:-1] * rho_i * rho_i / dpm
    diff_e = dt * GRAVIT * GRAVIT * ke_i[..., 1:-1] * rho_i * rho_i / dpm

    zeros = jnp.zeros(t.shape[:-1] + (1,), t.dtype)
    cam = jnp.concatenate([rpdel[..., :-1] * diff_m, zeros], axis=-1)
    ccm = jnp.concatenate([zeros, rpdel[..., 1:] * diff_m], axis=-1)
    ca = jnp.concatenate([rpdel[..., :-1] * diff_e, zeros], axis=-1)
    cc = jnp.concatenate([zeros, rpdel[..., 1:] * diff_e], axis=-1)

    # Thomas sweep from the surface upward (reference k=pver..1)
    theta = t * (P0 / pmid) ** (RAIR / CPAIR)

    def sweep(carry, inp):
        ce_m_prev, ce_e_prev, fu_p, fv_p, ft_p, fq_p = carry
        cam_k, ccm_k, ca_k, cc_k, u_k, v_k, th_k, q_k = inp
        dm = 1.0 + cam_k + ccm_k - ccm_k * ce_m_prev
        de = 1.0 + ca_k + cc_k - cc_k * ce_e_prev
        ce_m = cam_k / dm
        ce_e = ca_k / de
        fu = (u_k + ccm_k * fu_p) / dm
        fv = (v_k + ccm_k * fv_p) / dm
        ft = (th_k + cc_k * ft_p) / de
        fq = (q_k + cc_k * fq_p) / de
        return ((ce_m, ce_e, fu, fv, ft, fq),
                (ce_m, ce_e, fu, fv, ft, fq))

    z0 = jnp.zeros(t.shape[:-1], t.dtype)
    seq = [jnp.moveaxis(a, -1, 0)
           for a in (cam, ccm, ca, cc, u, v, theta, q)]
    _, outs = jax.lax.scan(sweep, (z0, z0, z0, z0, z0, z0), tuple(seq))
    ce_m, ce_e, fu, fv, ft, fq = [jnp.moveaxis(o, 0, -1) for o in outs]

    # back substitution from the top downward
    def back(carry, inp):
        u_n, v_n, th_n, q_n = carry
        ce_m_k, ce_e_k, fu_k, fv_k, ft_k, fq_k = inp
        u_k = ce_m_k * u_n + fu_k
        v_k = ce_m_k * v_n + fv_k
        th_k = ce_e_k * th_n + ft_k
        q_k = ce_e_k * q_n + fq_k
        return (u_k, v_k, th_k, q_k), (u_k, v_k, th_k, q_k)

    seq2 = [jnp.moveaxis(a, -1, 0)
            for a in (ce_m, ce_e, fu, fv, ft, fq)]
    _, outs2 = jax.lax.scan(back, (z0, z0, z0, z0), tuple(seq2),
                            reverse=True)
    u2, v2, th2, q2 = [jnp.moveaxis(o, 0, -1) for o in outs2]

    t2 = th2 * (pmid / P0) ** (RAIR / CPAIR)
    return u2, v2, t2, q2, precl


def moist_baro_tsurf(lat):
    """Latitude-dependent Tsurf for the moist baroclinic wave test."""
    a = 6371220.0
    omega = 7.29212e-5
    pi = np.pi
    u0 = 35.0
    t00 = 288.0
    latw = 2.0 * pi / 9.0
    eta0 = 0.252
    etav = (1.0 - eta0) * 0.5 * pi
    q0 = 0.021
    ts = (t00 + pi * u0 / RAIR * 1.5 * np.sin(etav)
          * np.cos(etav) ** 0.5
          * ((-2.0 * np.sin(lat) ** 6 * (np.cos(lat) ** 2 + 1.0 / 3.0)
              + 10.0 / 63.0) * u0 * np.cos(etav) ** 1.5
             + (8.0 / 5.0 * np.cos(lat) ** 3
                * (np.sin(lat) ** 2 + 2.0 / 3.0) - pi / 4.0)
             * a * omega * 0.5))
    return ts / (1.0 + ZVIR * q0 * np.exp(-((lat / latw) ** 4)))


class DCMIPSimplePhysics(WorkflowProcess):
    """Simple physics on the model state (tracer 0 = rho*qv).

    ``test``: "tropical_cyclone" (constant SST) or "moist_baroclinic"
    (latitude-dependent Tsurf).
    """

    def __init__(self, interval: float = 0.0,
                 test: str = "tropical_cyclone",
                 rj2012_precip: bool = True):
        super().__init__(interval)
        self.test = test
        self.rj2012_precip = rj2012_precip
        self._jitted = None
        self.precl = None

    def perform(self, model, t_now):
        if self._jitted is None:
            geom = model.geom
            c = model.cfg.constants
            dt = self.interval if self.interval > 0 else model.cfg.dt
            if self.test == "tropical_cyclone":
                tsurf = jnp.full(np.asarray(geom.lat).shape, SST_TC,
                                 model.cfg.dtype)
            else:
                tsurf = jnp.asarray(moist_baro_tsurf(np.asarray(geom.lat)),
                                    model.cfg.dtype)
            a_r = c.earth_radius
            rj = self.rj2012_precip

            def update(state):
                from ..models.nonhydro import colop
                rho = state["Rho"]
                rt = state["Rt"]
                q = state["Tracers"][0] / rho
                pmid = c.pressure_from_rhotheta(rt)
                rt_i = colop(geom.interp_n2i, rt)
                pint = c.pressure_from_rhotheta(rt_i)
                ps = pint[..., 0]
                tv = pmid / (rho * c.Rd)
                temp = tv / (1.0 + 0.61 * q)
                # surface wind speed from the metric:
                # |u|^2 = u_a u^a + u_b u^b
                con = geom.con2d
                ua_con = (con[..., 0, 0, None] * state["U"]
                          + con[..., 0, 1, None] * state["V"])
                ub_con = (con[..., 1, 0, None] * state["U"]
                          + con[..., 1, 1, None] * state["V"])
                speed = jnp.sqrt(jnp.maximum(
                    ua_con[..., 0] * state["U"][..., 0]
                    + ub_con[..., 0] * state["V"][..., 0], 0.0))
                # the PBL operator is per-column scalar-linear: apply it to
                # the covariant components directly (exact)
                u2, v2, t2, q2, precl = simple_physics_update(
                    state["U"], state["V"], temp, q, pmid, pint, ps,
                    jnp.broadcast_to(tsurf, ps.shape), dt,
                    rj2012_precip=rj, wind_speed=speed)
                tv2 = t2 * (1.0 + 0.61 * q2)
                rt2 = rho * tv2 * (c.P0 / pmid) ** (c.Rd / c.Cp)
                tr = state["Tracers"].at[0].set(q2 * rho)
                return dict(state, U=u2, V=v2, Rt=rt2, Tracers=tr), precl

            self._jitted = jax.jit(update)
        new_state, precl = self._jitted(model.state)
        self.precl = precl
        return new_state
