"""Scalar and vector (hyper)diffusion for the SE dynamics.

JAX equivalent of
``HorizontalDynamicsFEM::ApplyScalarHyperdiffusion`` (reference
``src/atm/HorizontalDynamicsFEM.cpp:1867-2205``),
``ApplyVectorHyperdiffusion`` (``:2207-2420``) and the nu4 orchestration of
``StepAfterSubCycle`` (``:2637-2726``):

  order 2:  u += dt * nu * Lap(u)          (one weak Laplacian + DSS)
  order 4:  w = Lap(u); DSS(w); u -= dt * nu_local * Lap(w); DSS(u)

with nu_local = nu * (delta_alpha / reference_length)**3.2 applied on the
second pass only (fScaleNuLocally), reference_length = pi/2/30
(``GridCSGLL.cpp:87``).  Scalars diffuse with the weak scalar Laplacian;
velocities diffuse through separate divergence/vorticity damping.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..grid.geometry import CubedSphereGeometry
from ..ops import sem
from ..parallel import dss


def scalar_laplacian(f, geom: CubedSphereGeometry, jac=None):
    """Weak-form scalar Laplacian: (1/J) weak_div(J g^{ij} d_j f).

    ``jac``: the 3D Jacobian stack for level/interface fields (defaults to
    the 2D Jacobian); the horizontal contravariant metric is always the 2D
    one, matching the reference (which feeds ContraMetric2DA/B).
    """
    nea, neb, p = geom.nea, geom.neb, geom.p
    da_, db_ = geom.delta_a, geom.delta_b
    if jac is None:
        jac = geom.jac2d
    extra = f.ndim - 3
    con = geom.con2d.reshape(geom.con2d.shape[:3] + (1,) * extra + (2, 2))
    j = (jac if jac.ndim == f.ndim
         else jac.reshape(jac.shape + (1,) * (f.ndim - jac.ndim)))
    da, db = sem.deriv_both(f, geom.deriv, nea, neb, p, da_, db_)
    ga = j * (con[..., 0, 0] * da + con[..., 0, 1] * db)
    gb = j * (con[..., 1, 0] * da + con[..., 1, 1] * db)
    return sem.weak_div(ga, gb, geom.stiff, nea, neb, p, da_, db_) / j


def curl_and_div(u, v, geom: CubedSphereGeometry):
    """Relative vorticity and divergence of the covariant velocity field.

    Reference: ``GridPatchCSGLL::ComputeCurlAndDiv``
    (``src/atm/GridPatchCSGLL.cpp:1132-1305``):
      div  = (d_a(J u^a) + d_b(J u^b)) / J     (strong form)
      curl = (d_a u_b - d_b u_a) / J
    """
    nea, neb, p = geom.nea, geom.neb, geom.p
    da_, db_ = geom.delta_a, geom.delta_b
    extra = u.ndim - 3
    con = geom.con2d.reshape(geom.con2d.shape[:3] + (1,) * extra + (2, 2))
    j2 = geom.jac2d.reshape(geom.jac2d.shape + (1,) * extra)
    con_u = con[..., 0, 0] * u + con[..., 0, 1] * v
    con_v = con[..., 1, 0] * u + con[..., 1, 1] * v
    d_ju_a = sem.deriv_a(j2 * con_u, geom.deriv, nea, neb, p, da_)
    d_jv_b = sem.deriv_b(j2 * con_v, geom.deriv, nea, neb, p, db_)
    dv_a = sem.deriv_a(v, geom.deriv, nea, neb, p, da_)
    du_b = sem.deriv_b(u, geom.deriv, nea, neb, p, db_)
    div = (d_ju_a + d_jv_b) / j2
    curl = (dv_a - du_b) / j2
    return curl, div


def vector_hyperdiff_update(u, v, nu_div, nu_vort, geom: CubedSphereGeometry):
    """One application of the div/vort-split vector diffusion operator.

    Returns (Du, Dv) with the same sign convention as the reference's
    ``dataUpdate -= dDeltaT * dUpdate`` with positive dt: the caller applies
    ``u_new = u - dt * Du``.  Reference: ``ApplyVectorHyperdiffusion``.
    """
    curl, div = curl_and_div(u, v, geom)
    # weak gradient (stiffness transpose) of div and curl
    wda_div = _weak_grad_a(div, geom)
    wdb_div = _weak_grad_b(div, geom)
    wda_curl = _weak_grad_a(curl, geom)
    wdb_curl = _weak_grad_b(curl, geom)
    extra = u.ndim - 3
    con = geom.con2d.reshape(geom.con2d.shape[:3] + (1,) * extra + (2, 2))
    j2 = geom.jac2d.reshape(geom.jac2d.shape + (1,) * extra)
    du = nu_div * wda_div - nu_vort * j2 * (
        con[..., 1, 0] * wda_curl + con[..., 1, 1] * wdb_curl)
    dv = nu_div * wdb_div + nu_vort * j2 * (
        con[..., 0, 0] * wda_curl + con[..., 0, 1] * wdb_curl)
    return du, dv


def uniform_diffusion_update(upd, ueval, ref_state, nu_s, nu_v, dt, geom):
    """Uniform (nu2) diffusion against the reference state.

    Reference ``HorizontalDynamicsFEM.cpp:1817-1860`` (end of every
    explicit stage when ``Grid::HasUniformDiffusion``): the Laplacians
    are evaluated at the STAGE INPUT ``ueval`` (iDataInitial) minus the
    reference, and added to the stage update ``upd``: vector Laplacian of
    (U,V) with the vector coefficient, scalar Laplacian of Rt (scalar
    coeff) and W (vector coeff).  Tracer mixing-ratio diffusion
    (``:1105-1150``) is folded into the horizontal tendency by the
    caller when tracers are present.
    """
    out = dict(upd)
    du, dv = vector_hyperdiff_update(
        ueval["U"] - ref_state["U"], ueval["V"] - ref_state["V"],
        nu_v, nu_v, geom)
    out["U"] = upd["U"] - dt * du
    out["V"] = upd["V"] - dt * dv
    # scalar_laplacian returns +lap; heat-equation damping adds it
    out["Rt"] = upd["Rt"] + dt * nu_s * scalar_laplacian(
        ueval["Rt"] - ref_state["Rt"], geom, geom.jac3d)
    out["W"] = upd["W"] + dt * nu_v * scalar_laplacian(
        ueval["W"] - ref_state["W"], geom, geom.jac3d_int)
    return out


def _weak_grad_a(f, geom):
    return sem.weak_grad_a(f, geom.stiff, geom.nea, geom.neb, geom.p,
                           geom.delta_a)


def _weak_grad_b(f, geom):
    return sem.weak_grad_b(f, geom.stiff, geom.nea, geom.neb, geom.p,
                           geom.delta_b)


def nu_local_scale(geom) -> float:
    """(delta_a / reference_length)**3.2 (reference :1967-1975).

    reference_length = pi/60 on the cubed sphere (``GridCSGLL.cpp:87``);
    Cartesian tests set min(domain width, 110 km).
    """
    return float((geom.delta_a / geom.reference_length) ** 3.2)


def step_after_subcycle_nh(state, dt, cfg, geom, dss_state: Callable,
                           ref_state=None, halo=None):
    """nu4/nu2 hyperviscosity for the nonhydrostatic state (Strang tail).

    Reference ``StepAfterSubCycle`` (``HorizontalDynamicsFEM.cpp:2637-2726``):
    scalar (hyper)diffusion on Rt/W/Rho/tracers (each at its own vertical
    location/Jacobian), div/vort-split vector diffusion on U/V, with DSS
    between and after the two passes, followed by the tracer positivity
    filter and (APPLY_RAYLEIGH_WITH_HYPERVIS) Rayleigh damping.

    ``halo``: no-flux halo shadow of ``state`` (cartesian bc_x="noflux"
    only).  When given, returns (state, halo_out) with halo_out the
    post-DSS pre-Rayleigh edge state (the halo content the next step's
    instances inherit); the reference's working-pass DSS averages the
    edge Laplacian against a ZeroData'd halo.
    """
    from . import nonhydro as nh

    shadowed = halo is not None
    hal_out = [halo]

    def finish(s, with_dss):
        # reference order: positivity filter -> DSS -> Rayleigh
        if "Tracers" in s:
            s = dict(s, Tracers=nh.filter_negative_tracers_horizontal(
                s["Tracers"], geom))
        if with_dss:
            s = dss_state(s, halo=halo) if shadowed else dss_state(s)
            hal_out[0] = s
        if cfg.rayleigh_damping and ref_state is not None:
            s = nh.apply_rayleigh(s, geom, ref_state, dt)
        return (s, hal_out[0]) if shadowed else s

    if not cfg.hyperdiffusion or (
            cfg.nu_scalar == 0 and cfg.nu_div == 0 and cfg.nu_vort == 0):
        return finish(state, with_dss=False)

    scale = nu_local_scale(geom) if cfg.hypervis_order == 4 else 1.0
    nu_s = cfg.nu_scalar * scale
    nu_d = cfg.nu_div * scale
    nu_v = cfg.nu_vort * scale

    def scalar_parts(s, sign_dt, nus):
        out = {}
        jac_rt = (geom.jac3d_int
                  if s["Rt"].shape[-1] == s["W"].shape[-1] else geom.jac3d)
        out["Rt"] = sign_dt * nus * scalar_laplacian(s["Rt"], geom, jac_rt)
        jac_w = (geom.jac3d
                 if s["W"].shape[-1] == s["Rho"].shape[-1]
                 else geom.jac3d_int)
        out["W"] = sign_dt * nus * scalar_laplacian(s["W"], geom, jac_w)
        out["Rho"] = sign_dt * nus * scalar_laplacian(s["Rho"], geom,
                                                      geom.jac3d)
        if "Tracers" in s:
            out["Tracers"] = sign_dt * nus * scalar_laplacian(
                s["Tracers"].transpose(1, 2, 3, 4, 0), geom,
                geom.jac3d).transpose(4, 0, 1, 2, 3)
        return out

    if cfg.hypervis_order == 2:
        parts = scalar_parts(state, dt, nu_s)
        du, dv = vector_hyperdiff_update(
            state["U"], state["V"], cfg.nu_div, cfg.nu_vort, geom)
        out = dict(state)
        for k, v in parts.items():
            out[k] = state[k] + v
        out["U"] = state["U"] - dt * du
        out["V"] = state["V"] - dt * dv
        return finish(out, with_dss=True)

    # ---- order 4: Lap pass -> DSS -> -dt * nu_local * Lap pass -> DSS ----
    work = scalar_parts(state, 1.0, 1.0)
    wu, wv = vector_hyperdiff_update(state["U"], state["V"], 1.0, 1.0, geom)
    work["U"] = -wu
    work["V"] = -wv
    if shadowed:
        # working instance was ZeroData'd: its halo is zero
        zero_halo = jax.tree_util.tree_map(lambda a: a * 0.0, work)
        work = dss_state(work, halo=zero_halo)
    else:
        work = dss_state(work)

    parts = scalar_parts(work, -dt, nu_s)
    du, dv = vector_hyperdiff_update(work["U"], work["V"], nu_d, nu_v, geom)
    out = dict(state)
    for k, v in parts.items():
        out[k] = state[k] + v
    out["U"] = state["U"] + dt * du
    out["V"] = state["V"] + dt * dv
    return finish(out, with_dss=True)


def step_after_subcycle_sw(state, dt, cfg, geom: CubedSphereGeometry,
                           dss_state: Callable):
    """nu4 hyperviscosity for the shallow-water state (Strang tail).

    ``dss_state``: callable applying DSS to a full state dict.
    Mirrors StepAfterSubCycle's order-4 branch exactly: Laplacian pass,
    DSS, second Laplacian with locally-scaled nu, DSS.
    """
    if not cfg.hyperdiffusion or (
            cfg.nu_scalar == 0 and cfg.nu_div == 0 and cfg.nu_vort == 0):
        return dss_state(state)

    scale = nu_local_scale(geom) if cfg.hypervis_order == 4 else 1.0
    nu_s = cfg.nu_scalar * scale
    nu_d = cfg.nu_div * scale
    nu_v = cfg.nu_vort * scale

    if cfg.hypervis_order == 2:
        h_new = state["H"] + dt * nu_s * scalar_laplacian(state["H"], geom)
        du, dv = vector_hyperdiff_update(
            state["U"], state["V"], cfg.nu_div, cfg.nu_vort, geom)
        out = {"U": state["U"] - dt * du, "V": state["V"] - dt * dv, "H": h_new}
        if "Tracers" in state:
            out["Tracers"] = state["Tracers"] + dt * nu_s * scalar_laplacian(
                state["Tracers"].transpose(1, 2, 3, 0), geom
            ).transpose(3, 0, 1, 2)
        return dss_state(out)

    # ---- order 4 ----
    # first application (dt=1, nu=1), then DSS of the working state
    work = {
        "H": scalar_laplacian(state["H"], geom),
    }
    wu, wv = vector_hyperdiff_update(state["U"], state["V"], 1.0, 1.0, geom)
    # first pass stores -(operator) exactly as the reference (dt=+1)
    work["U"] = -wu
    work["V"] = -wv
    if "Tracers" in state:
        work["Tracers"] = scalar_laplacian(
            state["Tracers"].transpose(1, 2, 3, 0), geom).transpose(3, 0, 1, 2)
    work = dss_state(work)

    # second application with -dt and locally-scaled nu
    h_new = state["H"] - dt * nu_s * scalar_laplacian(work["H"], geom)
    du, dv = vector_hyperdiff_update(work["U"], work["V"], nu_d, nu_v, geom)
    out = {"U": state["U"] + dt * du, "V": state["V"] + dt * dv, "H": h_new}
    if "Tracers" in state:
        out["Tracers"] = state["Tracers"] - dt * nu_s * scalar_laplacian(
            work["Tracers"].transpose(1, 2, 3, 0), geom).transpose(3, 0, 1, 2)
    return dss_state(out)
