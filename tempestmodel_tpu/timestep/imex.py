"""IMEX additive Runge-Kutta (ARK) schemes in U-form.

JAX equivalent of the reference ARK family
(``src/atm/TimestepSchemeARS222/ARS232/ARK232/ARS343/ARS443/SSP3332.cpp``).
The reference reconstructs stage tendencies through LinearCombineData
tricks over 5-9 data instances; here the explicit tendencies F(u_j) and
implicit increments G(u_j) are stored directly as pytrees and each stage is

    uf_i = DSS[ u0 + dt (sum_{j<=i} Aexp[i][j] F_j + sum_{j<i} Aimp[i][j] G_j) ]
    u_{i+1} = VerticalImplicit(uf_i, Aimp[i][i] dt);  G_i = (u_{i+1}-uf_i)/(Aimp[i][i] dt)

followed by the hyperdiffusion/Rayleigh tail over the full dt — exactly the
reference orchestration (DSS is linear and idempotent, so accumulating raw
tendencies then applying DSS per stage is equivalent to the reference's
combination of DSS'd instances).
"""

from __future__ import annotations

import math
from typing import Callable

import jax

from ..config import ModelConfig, TimestepSchemeType
from ..models import nonhydro
from ..models import hyperdiff
from .explicit import tree_axpy


def _tableaux(kind: TimestepSchemeType):
    """(Aexp, Aimp) stage coefficient tables (U-form, reference values)."""
    s2 = math.sqrt(2.0)
    if kind == TimestepSchemeType.ARS222:
        g = 1.0 - 0.5 * s2
        d = 1.0 - 1.0 / (2.0 * g)
        return ([[g, 0.0], [d, 1.0 - d]],
                [[g, 0.0], [1.0 - g, g]])
    if kind == TimestepSchemeType.ARS232:
        g = 1.0 - 1.0 / s2
        d = -2.0 * s2 / 3.0
        return ([[g, 0, 0], [d, 1.0 - d, 0], [0.0, 1.0 - g, g]],
                [[g, 0, 0], [1.0 - g, g, 0], [1.0 - g, g, 0.0]])
    if kind == TimestepSchemeType.ARK232:
        g = 1.0 - 1.0 / s2
        d = 1.0 / (2.0 * s2)
        al = (3.0 + 2.0 * s2) / 6.0
        return ([[2 * g, 0, 0], [1.0 - al, al, 0], [d, d, g]],
                [[g, g, 0], [d, d, g], [d, d, g]])
    if kind in (TimestepSchemeType.ARS343, TimestepSchemeType.ARS343B):
        # ARS343b (TimestepSchemeARS343b.cpp) carries the identical
        # Ascher et al. 1997 tableau; the reference variant differs only
        # in evaluating stages through fused StepExplicitCombine calls —
        # an implementation detail XLA fusion subsumes here.
        g = 0.4358665215084590
        b1 = -1.5 * g * g + 4.0 * g - 0.25
        b2 = 1.5 * g * g - 5.0 * g + 1.25
        a42 = 0.5529291480359398
        a43 = a42
        a31 = ((1.0 - 4.5 * g + 1.5 * g * g) * a42
               + (2.75 - 10.5 * g + 3.75 * g * g) * a43
               - 3.5 + 13.0 * g - 4.5 * g * g)
        a32 = ((-1.0 + 4.5 * g - 1.5 * g * g) * a42
               + (-2.75 + 10.5 * g - 3.75 * g * g) * a43
               + 4.0 - 12.5 * g + 4.5 * g * g)
        a41 = 1.0 - a42 - a43
        return ([[g, 0, 0, 0], [a31, a32, 0, 0], [a41, a42, a43, 0],
                 [0.0, b1, b2, g]],
                [[g, 0, 0, 0], [0.5 * (1.0 - g), g, 0, 0],
                 [b1, b2, g, 0], [b1, b2, g, 0.0]])
    if kind == TimestepSchemeType.ARS443:
        return ([[1 / 2, 0, 0, 0], [11 / 18, 1 / 18, 0, 0],
                 [5 / 6, -5 / 6, 1 / 2, 0], [1 / 4, 7 / 4, 3 / 4, -7 / 4]],
                [[1 / 2, 0, 0, 0], [1 / 6, 1 / 2, 0, 0],
                 [-1 / 2, 1 / 2, 1 / 2, 0], [3 / 2, -3 / 2, 1 / 2, 1 / 2]])
    if kind == TimestepSchemeType.SSP3332:
        g = 1.0 - 1.0 / s2
        return ([[0.0, 0, 0, 0], [1.0, 0, 0, 0], [1 / 4, 1 / 4, 0, 0],
                 [1 / 6, 1 / 6, 2 / 3, 0.0]],
                [[g, 0, 0, 0], [1.0 - 2.0 * g, g, 0, 0],
                 [0.5 - g, 0.0, g, 0], [1 / 6, 1 / 6, 2 / 3, 0.0]])
    raise ValueError(f"not an IMEX scheme: {kind}")


def make_imex_step(cfg: ModelConfig, geom, dss_state: Callable,
                   ref_state=None):
    """Jitted IMEX-ARK step: state -> state (self-starting, no carry)."""
    if cfg.timescheme == TimestepSchemeType.GARK2:
        return _make_gark2_step(cfg, geom, dss_state, ref_state)
    aexp, aimp = _tableaux(cfg.timescheme)
    s = len(aexp)
    constants = cfg.constants
    dt = cfg.dt

    if cfg.vertical_solver == "banded":
        q = nonhydro.estimate_bandwidth(geom, constants)
        band_statics = nonhydro.band_assembly_statics(geom, q)
    else:
        q = 0
        band_statics = None

    def explicit_tendency(u):
        """Horizontal + explicit-vertical tendency (per unit time)."""
        tend = nonhydro.horizontal_tendency(u, geom, constants)
        vinc = nonhydro.vertical_explicit_increment(u, geom, 1.0)
        tend["U"] = tend["U"] + vinc["U"]
        tend["V"] = tend["V"] + vinc["V"]
        return tend

    def postprocess(u):
        return dss_state(nonhydro.apply_w_boundary(u, geom))

    def implicit(u, dti):
        return nonhydro.vertical_implicit(
            u, geom, constants, dti, newton_iters=cfg.newton_iterations,
            solver=cfg.vertical_solver, q=q, band_statics=band_statics,
                ref_jacobian=(cfg.jacobian_mode == "reference"))

    @jax.jit
    def step(state):
        u0 = state
        u = u0
        F = []
        G = []
        for i in range(s):
            F.append(explicit_tendency(u))
            uf = u0
            for j in range(i + 1):
                if aexp[i][j] != 0.0:
                    uf = tree_axpy(uf, F[j], aexp[i][j] * dt)
            for j in range(i):
                if aimp[i][j] != 0.0:
                    uf = jax.tree_util.tree_map(
                        lambda a, b: a + aimp[i][j] * dt * b, uf, G[j])
            uf = postprocess(uf)
            if aimp[i][i] != 0.0:
                u = implicit(uf, aimp[i][i] * dt)
                G.append(jax.tree_util.tree_map(
                    lambda a, b: (a - b) / (aimp[i][i] * dt), u, uf))
            else:
                u = uf
                G.append(jax.tree_util.tree_map(lambda a: a * 0.0, uf))
        return hyperdiff.step_after_subcycle_nh(
            u, dt, cfg, geom, dss_state, ref_state)

    return step


def _make_gark2_step(cfg: ModelConfig, geom, dss_state: Callable,
                     ref_state=None):
    """2nd-order IMEX-GARK step (Sandu & Gunther 2013, example 7).

    Reference ``TimestepSchemeGARK2.cpp``.  The GARK coupling tables do
    not fit the plain ARK U-form loop: the stage-2 explicit tendency is
    evaluated at uf2 = u0 + dt F0 + dt G1 (the explicit-implicit coupling
    row) while the stage-2 implicit input combines the implicit-explicit
    row z2 = u0 + alpha dt F0 + (1-gamma) dt G1 + (1-alpha) dt F(uf2).
    """
    g = 1.0 - 0.5 * math.sqrt(2.0)   # m_dgamma
    al = 0.5                         # m_dalpha
    constants = cfg.constants
    dt = cfg.dt

    if cfg.vertical_solver == "banded":
        q = nonhydro.estimate_bandwidth(geom, constants)
        band_statics = nonhydro.band_assembly_statics(geom, q)
    else:
        q = 0
        band_statics = None

    def explicit_tendency(u):
        tend = nonhydro.horizontal_tendency(u, geom, constants)
        vinc = nonhydro.vertical_explicit_increment(u, geom, 1.0)
        tend["U"] = tend["U"] + vinc["U"]
        tend["V"] = tend["V"] + vinc["V"]
        return tend

    def postprocess(u):
        return dss_state(nonhydro.apply_w_boundary(u, geom))

    def implicit(u, dti):
        return nonhydro.vertical_implicit(
            u, geom, constants, dti, newton_iters=cfg.newton_iterations,
            solver=cfg.vertical_solver, q=q, band_statics=band_statics,
                ref_jacobian=(cfg.jacobian_mode == "reference"))

    @jax.jit
    def step(u0):
        F0 = explicit_tendency(u0)
        # stage 1: uf1 = u0 + g dt F0; u1 implicit over g dt
        uf1 = postprocess(tree_axpy(u0, F0, g * dt))
        u1 = implicit(uf1, g * dt)
        G1 = jax.tree_util.tree_map(
            lambda a, b: (a - b) / (g * dt), u1, uf1)
        # explicit-implicit coupling point: uf2 = u0 + dt F0 + dt G1
        uf2 = postprocess(tree_axpy(tree_axpy(u0, F0, dt), G1, dt))
        F1 = explicit_tendency(uf2)
        # stage 2 implicit input:
        #   z2 = u0 + al dt F0 + (1-g) dt G1 + (1-al) dt F1
        z2 = tree_axpy(tree_axpy(tree_axpy(
            u0, F0, al * dt), G1, (1.0 - g) * dt), F1, (1.0 - al) * dt)
        z2 = postprocess(z2)
        u2 = implicit(z2, g * dt)
        return hyperdiff.step_after_subcycle_nh(
            u2, dt, cfg, geom, dss_state, ref_state)

    return step
