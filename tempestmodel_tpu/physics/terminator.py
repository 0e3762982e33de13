"""'Terminator' toy chemistry (DCMIP2016 test 3).

JAX port of the reference Fortran kernel
(``test/dcmip2016/interface/Terminator.f90``, wrapped by
``test/dcmip2016/TerminatorPhysics.cpp``): Cl/Cl2 photolytic toy chemistry
with an exact local solution; Cly = Cl + 2*Cl2 is conserved exactly, which
makes it a sharp tracer-transport correctness diagnostic.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..model import WorkflowProcess

CLY_CONSTANT = 4.0e-6
K1_LAT_CENTER = np.deg2rad(20.0)
K1_LON_CENTER = np.deg2rad(300.0)


def k_vals(lat, lon):
    k1 = jnp.maximum(
        0.0, jnp.sin(lat) * np.sin(K1_LAT_CENTER)
        + jnp.cos(lat) * np.cos(K1_LAT_CENTER) * jnp.cos(lon - K1_LON_CENTER))
    return k1, 1.0


def terminator_tendency(lat, lon, cl, cl2, dt):
    """(dcl/dt, dcl2/dt) via the exact local solution."""
    k1, k2 = k_vals(lat, lon)
    r = k1 / (4.0 * k2)
    cly = cl + 2.0 * cl2
    det = jnp.sqrt(r * r + 2.0 * r * cly)
    expdt = jnp.exp(-4.0 * k2 * det * dt)
    el = jnp.where(jnp.abs(det * k2 * dt) > 1e-16,
                   (1.0 - expdt) / jnp.maximum(det, 1e-300) / dt,
                   4.0 * k2)
    cl_f = (-el * (cl - det + r) * (cl + det + r)
            / (1.0 + expdt + dt * el * (cl + r)))
    return cl_f, -cl_f / 2.0


def terminator_initial(lat, lon):
    """Equilibrium (cl, cl2) initial condition (numpy, host-side)."""
    k1 = np.maximum(
        0.0, np.sin(lat) * np.sin(K1_LAT_CENTER)
        + np.cos(lat) * np.cos(K1_LAT_CENTER) * np.cos(lon - K1_LON_CENTER))
    k2 = 1.0
    r = k1 / (4.0 * k2)
    det = np.sqrt(r * r + 2.0 * CLY_CONSTANT * r)
    cl = det - r
    cl2 = CLY_CONSTANT / 2.0 - (det - r) / 2.0
    return cl, cl2


class TerminatorPhysics(WorkflowProcess):
    """Applies the chemistry to tracers [..., cl*rho, cl2*rho] (last two)."""

    def __init__(self, interval: float = 0.0, cl_index: int = 0):
        super().__init__(interval)
        self.cl_index = cl_index
        self._jitted = None

    def perform(self, model, t):
        if self._jitted is None:
            geom = model.geom
            dt = self.interval if self.interval > 0 else model.cfg.dt
            i0 = self.cl_index

            def update(state):
                rho = state["Rho"]
                cl = state["Tracers"][i0] / rho
                cl2 = state["Tracers"][i0 + 1] / rho
                lat = geom.lat[..., None]
                lon = geom.lon[..., None]
                clf, cl2f = terminator_tendency(lat, lon, cl, cl2, dt)
                tr = state["Tracers"]
                tr = tr.at[i0].set((cl + dt * clf) * rho)
                tr = tr.at[i0 + 1].set((cl2 + dt * cl2f) * rho)
                return dict(state, Tracers=tr)

            self._jitted = jax.jit(update)
        return self._jitted(model.state)
