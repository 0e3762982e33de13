"""Shallow-water spectral-element dynamics on the cubed sphere.

JAX re-design of the reference
``HorizontalDynamicsFEM::StepShallowWater``
(``src/atm/HorizontalDynamicsFEM.cpp:321-640``): the vector-invariant
shallow-water equations in covariant equiangular components,

    d(u_a)/dt = -d_a(K + g H) + (f J + zeta) u^b
    d(u_b)/dt = -d_b(K + g H) - (f J + zeta) u^a
    dH/dt     = -(1/J) [weak_div of J u^i (H - Zs)]

where zeta = d_a u_b - d_b u_a (= J times relative vorticity), K is the
specific kinetic energy, and the mass flux uses the variational
(stiffness-matrix) form.  All per-element scalar loops of the reference
become batched tensor-product contractions over the element-stacked
(6, A, B) layout (see ``ops/sem.py``).

State dict: {"U": covariant alpha velocity, "V": covariant beta velocity,
"H": free-surface height}, each (6, A, B), plus optional "Tracers"
(ntracer, 6, A, B).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..grid.geometry import CubedSphereGeometry
from ..ops import sem


def sw_tendency(state, geom: CubedSphereGeometry, constants):
    """Element-local shallow-water tendencies (no DSS, no dt).

    Returns a dict of the same structure as ``state``.
    """
    ne, p, delta = geom.ne, geom.p, geom.delta_a
    D, S = geom.deriv, geom.stiff

    u = state["U"]
    v = state["V"]
    h = state["H"]

    # contravariant velocities (reference :429-441)
    con_u = geom.con2d[..., 0, 0] * u + geom.con2d[..., 0, 1] * v
    con_v = geom.con2d[..., 1, 0] * u + geom.con2d[..., 1, 1] * v

    # specific kinetic energy + geopotential (reference :443-449)
    ke = 0.5 * (con_u * u + con_v * v) + constants.g * h

    # mass fluxes (reference :455-476): J * u^i * (H - Zs)
    depth = h - geom.topo
    flux_a = geom.jac2d * con_u * depth
    flux_b = geom.jac2d * con_v * depth

    # derivatives
    dke_a, dke_b = sem.deriv_both(ke, D, ne, ne, p, delta, delta)
    dv_a = sem.deriv_a(v, D, ne, ne, p, delta)   # d(u_b)/da
    du_b = sem.deriv_b(u, D, ne, ne, p, delta)   # d(u_a)/db
    zeta = dv_a - du_b                       # J * relative vorticity

    div_mass = sem.weak_div(flux_a, flux_b, S, ne, ne, p, delta, delta)

    # absolute vorticity rotation + pressure-gradient terms (reference :583-607)
    fJ = geom.coriolis * geom.jac2d
    du = -dke_a + con_v * (zeta + fJ)
    dv = -dke_b - con_u * (zeta + fJ)
    dh = -div_mass / geom.jac2d

    out = {"U": du, "V": dv, "H": dh}

    if "Tracers" in state:
        base_a = geom.jac2d * con_u
        base_b = geom.jac2d * con_v
        tr = state["Tracers"]
        ta = base_a[None] * tr
        tb = base_b[None] * tr
        out["Tracers"] = -sem.weak_div(ta, tb, S, ne, ne, p, delta, delta) / geom.jac2d[None]

    return out


def sw_energy(state, geom: CubedSphereGeometry, constants):
    """Discrete total energy integral (reference ``Grid::ComputeTotalEnergy``)."""
    u, v, h = state["U"], state["V"], state["H"]
    con_u = geom.con2d[..., 0, 0] * u + geom.con2d[..., 0, 1] * v
    con_v = geom.con2d[..., 1, 0] * u + geom.con2d[..., 1, 1] * v
    depth = h - geom.topo
    ke = 0.5 * depth * (con_u * u + con_v * v)
    pe = 0.5 * constants.g * (h * h - geom.topo * geom.topo)
    return jnp.sum((ke + pe) * geom.area2d)


def sw_potential_enstrophy(state, zeta, geom: CubedSphereGeometry):
    """Potential enstrophy 0.5 (f + zeta/J)^2 / depth integral."""
    depth = state["H"] - geom.topo
    abs_vort = geom.coriolis + zeta / geom.jac2d
    return jnp.sum(0.5 * abs_vort * abs_vort / depth * geom.area2d)
