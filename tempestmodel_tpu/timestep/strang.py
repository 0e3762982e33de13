"""Strang-split HEVI timestep scheme.

JAX equivalent of ``TimestepSchemeStrang::Step``
(``src/atm/TimestepSchemeStrang.cpp:450-674``): on the first step an
implicit vertical half-step; afterwards the previous implicit increment is
carried over (``m_dCarryoverCombination``); then the explicit RK substep
(horizontal + explicit vertical terms with DSS per stage), the nu4
hyperdiffusion tail, and the closing implicit vertical solve with optional
off-centering.  The reference's 5 data instances become two pytrees
(state, carry) threaded through one jitted function.
"""

from __future__ import annotations

from typing import Callable

import jax

from ..config import ModelConfig
from ..models import nonhydro
from ..models import hyperdiff
from .explicit import erk_substep, tree_axpy
from ..utils.jit import hoisted_jit


def make_strang_step(cfg: ModelConfig, geom, dss_state: Callable,
                     ref_state=None, mesh=None):
    """Returns (first_step, step) jitted functions.

    first_step(state) -> (state, carry);  step(state, carry) -> (state, carry)
    ``ref_state``: reference state for Rayleigh damping (APPLY_RAYLEIGH_WITH_
    HYPERVIS) and uniform diffusion.
    ``mesh``: optional device mesh — run the column-local vertical implicit
    solve under shard_map (zero collectives) instead of GSPMD partitioning
    of the column flatten.
    """
    constants = cfg.constants
    dt = cfg.dt
    oc = cfg.off_centering

    uniform_on = ((cfg.nu_uniform_scalar != 0.0
                   or cfg.nu_uniform_vector != 0.0)
                  and ref_state is not None)
    # no-flux lateral BC (either axis: x for the xz slices, y for the
    # baroclinic channel, Baroclinic3DCartesianTest.cpp:144-147): emulate
    # the reference's per-instance halos by threading a "shadow" state
    # through the RK combinations (see erk_substep shadow0)
    noflux = (getattr(geom, "bc_x", "periodic") == "noflux"
              or getattr(geom, "bc_y", "periodic") == "noflux")

    def stage(base, ueval, dt_s, shadow=None):
        tend = nonhydro.horizontal_tendency(ueval, geom, constants)
        upd = tree_axpy(base, tend, dt_s)
        vinc = nonhydro.vertical_explicit_increment(ueval, geom, dt_s)
        upd["U"] = upd["U"] + vinc["U"]
        upd["V"] = upd["V"] + vinc["V"]
        if uniform_on:
            upd = hyperdiff.uniform_diffusion_update(
                upd, ueval, ref_state, cfg.nu_uniform_scalar,
                cfg.nu_uniform_vector, dt_s, geom)
        upd = nonhydro.apply_w_boundary(upd, geom)
        if shadow is not None:
            return dss_state(upd, halo=shadow)
        return dss_state(upd)

    from ..config import VerticalStaggering
    lorenz = cfg.vertical_staggering == VerticalStaggering.LORENZ
    if cfg.vertical_solver == "banded" and lorenz:
        q = nonhydro.estimate_bandwidth(geom, constants)
        band_statics = nonhydro.band_assembly_statics(
            geom, q, upwind_thermo=cfg.upwind_thermo)
    else:
        # non-Lorenz staggerings solve dense (vertical_implicit falls
        # back internally; the banded layout is Lorenz-specific)
        q = 0
        band_statics = None

    def implicit(s, dti):
        def core(st, gm):
            return nonhydro.vertical_implicit(
                st, gm, constants, dti, newton_iters=cfg.newton_iterations,
                solver=cfg.vertical_solver, q=q, band_statics=band_statics,
                ref_jacobian=(cfg.jacobian_mode == "reference"),
                upwind_thermo=cfg.upwind_thermo)
        if mesh is not None:
            from ..parallel.dss_shardmap import wrap_columnwise
            out = wrap_columnwise(core, mesh, geom)(s)
        else:
            out = core(s, geom)
        if "Tracers" in out:
            out = dict(out, Tracers=nonhydro.filter_negative_tracers_column(
                out["Tracers"], geom))
        return out

    def tail(state, hal=None):
        """Explicit RK + hyperdiffusion + closing implicit (shared path)."""
        u4 = erk_substep(cfg.explicit_scheme, state, dt, stage,
                         shadow0=hal if noflux else None)
        if noflux:
            u1, hal = hyperdiff.step_after_subcycle_nh(
                u4, dt, cfg, geom, dss_state, ref_state, halo=u4)
        else:
            u1 = hyperdiff.step_after_subcycle_nh(
                u4, dt, cfg, geom, dss_state, ref_state)
        u0 = implicit(u1, 0.5 * (1.0 + oc) * dt)
        if oc != 0.0:
            u0 = jax.tree_util.tree_map(
                lambda a, b: 0.5 * (2.0 - oc) * a + 0.5 * oc * b, u0, u1)
        carry = jax.tree_util.tree_map(lambda a, b: a - b, u0, u1)
        if noflux:
            carry = {"inc": carry, "halo": hal}
        return u0, carry

    if cfg.explicit_vertical or cfg.timescheme.value == "erk":
        # Fully-explicit path (--explicitvertical / TimestepSchemeERK):
        # vertical terms join the RK stages; no implicit solve, no carry.
        def stage_full(base, ueval, dt_s):
            tend = nonhydro.horizontal_tendency(ueval, geom, constants)
            vtend = nonhydro.vertical_explicit_tendency(
                ueval, geom, constants)
            for k, v in vtend.items():
                tend[k] = tend[k] + v
            upd = tree_axpy(base, tend, dt_s)
            vinc = nonhydro.vertical_explicit_increment(ueval, geom, dt_s)
            upd["U"] = upd["U"] + vinc["U"]
            upd["V"] = upd["V"] + vinc["V"]
            if uniform_on:
                upd = hyperdiff.uniform_diffusion_update(
                    upd, ueval, ref_state, cfg.nu_uniform_scalar,
                    cfg.nu_uniform_vector, dt_s, geom)
            upd = nonhydro.apply_w_boundary(upd, geom)
            return dss_state(upd)

        @hoisted_jit
        def erk_first(state):
            u4 = erk_substep(cfg.explicit_scheme, state, dt, stage_full)
            u1 = hyperdiff.step_after_subcycle_nh(
                u4, dt, cfg, geom, dss_state, ref_state)
            zero = jax.tree_util.tree_map(lambda a: a * 0.0, u1)
            return u1, zero

        @hoisted_jit
        def erk_step(state, carry):
            return erk_first(state)

        return erk_first, erk_step

    @hoisted_jit
    def first_step(state):
        hal = state if noflux else None   # t=0 halos = initial edge values
        state = implicit(state, 0.5 * dt)
        return tail(state, hal)

    @hoisted_jit
    def step(state, carry):
        if noflux:
            hal = carry["halo"]
            carry = carry["inc"]
        else:
            hal = None
        state = jax.tree_util.tree_map(lambda a, b: a + b, state, carry)
        if "Tracers" in state:
            state = dict(state, Tracers=nonhydro.filter_negative_tracers_column(
                state["Tracers"], geom))
        return tail(state, hal)

    return first_step, step
