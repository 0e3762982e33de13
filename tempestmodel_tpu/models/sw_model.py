"""Shallow-water model driver: config -> geometry + jitted step function.

JAX analog of the reference ``Model`` + ``TimestepSchemeStrang``
wiring for the 2D equation set (vertical dynamics stubbed, so a Strang step
reduces to: explicit RK stages with DSS after each stage, then the nu4
hyperviscosity tail -- exactly ``TimestepSchemeStrang::Step``,
``src/atm/TimestepSchemeStrang.cpp:460-690``, with
``VerticalDynamicsStub``).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from ..grid.geometry import CubedSphereGeometry, build_geometry
from ..parallel import dss as dss_mod
from ..timestep.explicit import erk_substep
from . import shallow_water as sw
from . import hyperdiff


def build_sw_geometry(cfg: ModelConfig, topography=None) -> CubedSphereGeometry:
    return build_geometry(
        ne=cfg.ne, p=cfg.order, constants=cfg.constants,
        nz=1, ztop=1.0, topography=topography, dtype=cfg.dtype)


def make_sw_step(cfg: ModelConfig, geom: CubedSphereGeometry) -> Callable:
    """Returns step(state) -> state advancing one dt (jit-compiled)."""

    def dss_state(s):
        out = dict(s)
        u, v = dss_mod.apply_dss_vector(s["U"], s["V"], geom)
        out["U"], out["V"] = u, v
        out["H"] = dss_mod.apply_dss_scalar(s["H"], geom)
        if "Tracers" in s:
            out["Tracers"] = dss_mod.apply_dss_scalar(
                s["Tracers"].transpose(1, 2, 3, 0), geom).transpose(3, 0, 1, 2)
        return out

    def stage(base, ueval, dt_s):
        tend = sw.sw_tendency(ueval, geom, cfg.constants)
        return dss_state(jax.tree_util.tree_map(
            lambda b, t: b + dt_s * t, base, tend))

    @jax.jit
    def step(state):
        u1 = erk_substep(cfg.explicit_scheme, state, cfg.dt, stage)
        return hyperdiff.step_after_subcycle_sw(
            u1, cfg.dt, cfg, geom, dss_state)

    return step


def run(cfg: ModelConfig, state, nsteps: int, geom=None):
    """Convenience loop (host-side; use lax.scan variants for benchmarks)."""
    if geom is None:
        geom = build_sw_geometry(cfg)
    step = make_sw_step(cfg, geom)
    for _ in range(nsteps):
        state = step(state)
    return state


def make_sw_multistep(cfg: ModelConfig, geom: CubedSphereGeometry,
                      inner_steps: int) -> Callable:
    """steps fused under one jit with lax.scan (for benchmarking)."""
    step = make_sw_step(cfg, geom)

    @jax.jit
    def multi(state):
        def body(s, _):
            return step(s), None
        out, _ = jax.lax.scan(body, state, None, length=inner_steps)
        return out

    return multi
