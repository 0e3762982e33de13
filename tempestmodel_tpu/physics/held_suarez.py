"""Held-Suarez (1994) idealized physics as a WorkflowProcess.

JAX port of the reference ``HeldSuarezPhysics``
(``src/atm/HeldSuarezPhysics.{h,cpp}``): backward-Euler boundary-layer
Rayleigh friction on the horizontal velocity and Newtonian relaxation of
temperature to the radiative-equilibrium profile, applied to the RhoTheta
prognostic via the Ullrich update (``HeldSuarezPhysics.cpp:200-212``).
The whole column update is one jitted elementwise function over the grid.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..model import WorkflowProcess

# Reference parameter values (HeldSuarezPhysics.h:26-47)
BOUNDARY_SIGMA = 0.7
K_FRICTION = 1.0 / 86400.0
K_A = (1.0 / 40.0) / 86400.0
K_S = (1.0 / 4.0) / 86400.0
DELTA_T_Y = 60.0
DELTA_THETA_Z = 10.0
T_MIN = 200.0
T_MAX = 315.0


def held_suarez_update(state, geom, constants, dt):
    """Apply one Held-Suarez physics step of length dt (pure function)."""
    c = constants
    lat = geom.lat[..., None]

    rt = state["Rt"]
    rho = state["Rho"]

    # surface pressure from the bottom-interface rho*theta (interpolated)
    rt_i0 = jnp.einsum("L,...L->...", geom.interp_n2i[0], rt)
    psurf = c.pressure_from_rhotheta(rt_i0)[..., None]

    pres = c.pressure_from_rhotheta(rt)
    sigma = pres / psurf
    bscale = jnp.maximum(
        (sigma - BOUNDARY_SIGMA) / (1.0 - BOUNDARY_SIGMA), 0.0)

    # boundary-layer friction (backward Euler)
    fric = 1.0 / (1.0 + K_FRICTION * bscale * dt)
    u = state["U"] * fric
    v = state["V"] * fric

    # temperature relaxation
    temp = pres / (rho * c.Rd)
    sl, cl = jnp.sin(lat), jnp.cos(lat)
    kt = K_A + (K_S - K_A) * bscale * cl ** 4
    teq = (T_MAX - DELTA_T_Y * sl * sl
           - DELTA_THETA_Z * jnp.log(pres / c.P0) * cl * cl)
    teq = teq * (pres / c.P0) ** c.kappa
    teq = jnp.maximum(teq, T_MIN)

    # Ullrich RhoTheta update (reference :200-212)
    gam = c.gamma
    ddh = -kt / gam * (1.0 + (gam - 1.0) * teq / temp)
    h = -kt / gam * (1.0 - teq / temp)
    rt_new = rt * (1.0 + dt / (1.0 - dt * ddh) * h)

    return dict(state, U=u, V=v, Rt=rt_new)


class HeldSuarezPhysics(WorkflowProcess):
    """Held-Suarez forcing fired every ``interval`` model seconds."""

    def __init__(self, interval: float):
        super().__init__(interval)
        self._jitted = None

    def perform(self, model, t):
        if self._jitted is None:
            geom, constants = model.geom, model.cfg.constants
            dt = self.interval if self.interval > 0 else model.cfg.dt
            self._jitted = jax.jit(
                lambda s: held_suarez_update(s, geom, constants, dt))
        return self._jitted(model.state)
