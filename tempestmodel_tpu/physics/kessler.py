"""Kessler (1969) warm-rain microphysics, batched over all columns.

JAX port of the DCMIP2016 Kessler kernel
(reference ``test/dcmip2016/interface/kessler.f90``, wrapped by
``test/dcmip2016/KesslerPhysics.cpp``): autoconversion/accretion,
saturation adjustment, rain evaporation, and subcycled upstream rain
sedimentation.  The per-column Fortran loop becomes one vectorized update
over every column at once; the CFL-limited subcycle count is the global
maximum (``lax.while_loop`` with a traced trip count).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..model import WorkflowProcess

F2X = 17.27
F5 = 237.3 * F2X * 2500000.0 / 1003.0
XK = 0.2875
PSL = 1000.0          # sea-level pressure (mb)
RHO_WATER = 1000.0    # liquid water density (kg/m^3)


def kessler_column_update(theta, qv, qc, qr, rho, pk, z, dt):
    """One Kessler physics step.

    All inputs (..., nz) with level index increasing upward; ``pk`` is the
    Exner function (p/p0)^(R/cp); returns
    (theta', qv', qc', qr', precl) with precl (...,) in m/s.
    """
    r = 0.001 * rho
    rhalf = jnp.sqrt(rho[..., 0:1] / rho)
    pc = 3.8 / (pk ** (1.0 / XK) * PSL)
    dz = z[..., 1:] - z[..., :-1]

    def velqr_of(qr_):
        return 36.34 * (jnp.maximum(qr_ * r, 0.0) ** 0.1364) * rhalf

    velqr = velqr_of(qr)
    # global CFL-limited subcycle count
    vel_low = velqr[..., :-1]
    dt_max = jnp.min(jnp.where(vel_low != 0.0,
                               0.8 * dz / jnp.maximum(vel_low, 1e-30),
                               dt))
    dt_max = jnp.minimum(dt_max, dt)
    rainsplit = jnp.ceil(dt / dt_max).astype(jnp.int32)
    dt0 = dt / rainsplit.astype(theta.dtype)

    def body(carry):
        i, theta, qv, qc, qr, velqr, precl = carry
        precl = precl + rho[..., 0] * qr[..., 0] * velqr[..., 0] / RHO_WATER

        # upstream sedimentation
        flux = r * qr * velqr
        sed_low = dt0 * (flux[..., 1:] - flux[..., :-1]) / (r[..., :-1] * dz)
        sed_top = -dt0 * qr[..., -1] * velqr[..., -1] / (
            0.5 * (z[..., -1] - z[..., -2]))
        sed = jnp.concatenate([sed_low, sed_top[..., None]], axis=-1)

        # autoconversion + accretion (KW 2.13)
        qrprod = qc - (qc - dt0 * jnp.maximum(0.001 * (qc - 0.001), 0.0)) \
            / (1.0 + dt0 * 2.2 * jnp.maximum(qr, 0.0) ** 0.875)
        qc = jnp.maximum(qc - qrprod, 0.0)
        qr = jnp.maximum(qr + qrprod + sed, 0.0)

        # saturation vapor mixing ratio (KW 2.11)
        tpk = pk * theta
        qvs = pc * jnp.exp(F2X * (tpk - 273.0) / (tpk - 36.0))
        prod = (qv - qvs) / (1.0 + qvs * F5 / (tpk - 36.0) ** 2)

        # rain evaporation (KW 2.14)
        rqr = jnp.maximum(r * qr, 0.0)
        ern = dt0 * ((1.6 + 124.9 * rqr ** 0.2046) * rqr ** 0.525) \
            / (2550000.0 * pc / (3.8 * qvs) + 540000.0) \
            * jnp.maximum(qvs - qv, 0.0) / (r * qvs)
        ern = jnp.minimum(ern, jnp.maximum(-prod - qc, 0.0))
        ern = jnp.minimum(ern, qr)

        # saturation adjustment (KW 3.10)
        dcond = jnp.maximum(prod, -qc)
        theta = theta + 2500000.0 / (1003.0 * pk) * (dcond - ern)
        qv = jnp.maximum(qv - dcond + ern, 0.0)
        qc = qc + dcond
        qr = qr - ern

        velqr = velqr_of(qr)
        return (i + 1, theta, qv, qc, qr, velqr, precl)

    def cond(carry):
        return carry[0] < rainsplit

    precl0 = jnp.zeros(theta.shape[:-1], theta.dtype)
    _, theta, qv, qc, qr, _, precl = jax.lax.while_loop(
        cond, body, (jnp.int32(0), theta, qv, qc, qr, velqr, precl0))
    return theta, qv, qc, qr, precl / rainsplit.astype(theta.dtype)


class KesslerPhysics(WorkflowProcess):
    """Kessler microphysics on the model state.

    Expects tracers [rho*qv, rho*qc, rho*qr] (moisture densities); updates
    Rt (via theta) and the tracers; accumulates precipitation in
    ``self.precl`` (reference ``KesslerPhysics.cpp``).
    """

    def __init__(self, interval: float = 0.0):
        super().__init__(interval)
        self._jitted = None
        self.precl = None

    def perform(self, model, t):
        if model.state["Tracers"].shape[0] < 3:
            raise ValueError(
                "KesslerPhysics requires tracers [rho*qv, rho*qc, rho*qr]")
        if self._jitted is None:
            geom = model.geom
            constants = model.cfg.constants
            dt = self.interval if self.interval > 0 else model.cfg.dt

            def update(state):
                rho = state["Rho"]
                theta = state["Rt"] / rho
                pk = constants.exner_from_rhotheta(state["Rt"]) / constants.Cp
                qv = state["Tracers"][0] / rho
                qc = state["Tracers"][1] / rho
                qr = state["Tracers"][2] / rho
                th2, qv2, qc2, qr2, precl = kessler_column_update(
                    theta, qv, qc, qr, rho, pk, geom.z_lev, dt)
                tr = jnp.stack([qv2 * rho, qc2 * rho, qr2 * rho], axis=0)
                if state["Tracers"].shape[0] > 3:
                    tr = jnp.concatenate([tr, state["Tracers"][3:]], axis=0)
                return dict(state, Rt=th2 * rho, Tracers=tr), precl

            self._jitted = jax.jit(update)
        new_state, precl = self._jitted(model.state)
        self.precl = precl
        model.user_data["PRECL"] = precl     # large-scale precip (m/s)
        return new_state
