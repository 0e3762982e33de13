"""Advection equation set: passive tracer transport in a prescribed wind.

JAX analog of the reference ``EquationSet::AdvectionEquations``
(``src/atm/EquationSet.cpp:30-45``: zero prognostic components, tracers
only).  The wind is supplied by the test case as covariant (U, V) fields
(optionally a callable of time); tracers advance with the same variational
flux divergence + DSS + positivity filter as the full model.
"""

from __future__ import annotations

from typing import Callable, Union

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from ..ops import sem
from ..parallel import dss as sphere_dss
from ..timestep.explicit import erk_substep


def advection_tendency(tracers, u_cov, v_cov, geom):
    """d(rho q)/dt = -(1/J) div(J u^i q) for each tracer (2-D)."""
    nea, neb, p = geom.nea, geom.neb, geom.p
    da, db = geom.delta_a, geom.delta_b
    con = geom.con2d
    con_u = con[..., 0, 0] * u_cov + con[..., 0, 1] * v_cov
    con_v = con[..., 1, 0] * u_cov + con[..., 1, 1] * v_cov
    base_a = geom.jac2d * con_u
    base_b = geom.jac2d * con_v
    tr = jnp.moveaxis(tracers, 0, -1)              # (P, A, B, ntr)
    div = sem.weak_div(base_a[..., None] * tr, base_b[..., None] * tr,
                       geom.stiff, nea, neb, p, da, db)
    return jnp.moveaxis(-div / geom.jac2d[..., None], -1, 0)


def make_advection_step(cfg: ModelConfig, geom,
                        wind: Union[tuple, Callable]):
    """Jitted advection step: tracers -> tracers.

    ``wind``: (U_cov, V_cov) arrays, or callable t -> (U_cov, V_cov).
    """
    dt = cfg.dt

    def get_wind(t):
        if callable(wind):
            return wind(t)
        return wind

    def dss_tracers(tr):
        return jax.vmap(
            lambda x: sphere_dss.apply_dss_scalar(x, geom))(tr)

    @jax.jit
    def step(tracers, t):
        u, v = get_wind(t)

        def stage(base, ueval, dt_s):
            tend = advection_tendency(ueval, u, v, geom)
            return dss_tracers(base + dt_s * tend)

        return erk_substep(cfg.explicit_scheme, tracers, dt, stage)

    return step
