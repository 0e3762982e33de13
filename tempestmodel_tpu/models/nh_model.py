"""Nonhydrostatic model driver: config -> geometry + jitted Strang stepper.

The Cartesian-plane analog of the reference's
``TempestSetupCartesianModel`` wiring (``TempestInitialize.h:580-705``)
with ``TimestepSchemeStrang`` + ``HorizontalDynamicsFEM`` +
``VerticalDynamicsFEM``.
"""

from __future__ import annotations

from typing import Callable

import jax

from ..config import ModelConfig, GridKind, TimestepSchemeType
from ..grid import cartesian as cart
from ..grid import geometry as sphere_geom
from ..parallel import dss as sphere_dss
from ..grid.vertical_stretch import get_stretch
from ..timestep.strang import make_strang_step
from ..utils.jit import hoisted_jit


def _stretch(cfg: ModelConfig):
    return get_stretch(cfg.vertical_stretch)


def build_nh_cartesian_geometry(cfg: ModelConfig, topography=None,
                                ztop: float = None, rayleigh=None,
                                bc_x: str = "periodic",
                                bc_y: str = "periodic",
                                reference_latitude: float = 0.0):
    return cart.build_cartesian_geometry(
        nex=cfg.nex, ney=cfg.ney, p=cfg.order, nz=cfg.nz,
        x_extent=cfg.x_extent, y_extent=cfg.y_extent,
        ztop=ztop if ztop is not None else cfg.ztop,
        constants=cfg.constants, vertical_order=cfg.vertical_order,
        topography=topography, rayleigh=rayleigh, bc_x=bc_x, bc_y=bc_y,
        is_xz=(cfg.grid_kind == GridKind.CARTESIAN_XZ),
        reference_latitude=reference_latitude,
        staggering=cfg.vertical_staggering.value,
        vdisc=cfg.vertical_discretization,
        stretch=_stretch(cfg), dtype=cfg.dtype)


def make_cartesian_dss(geom, mesh=None) -> Callable:
    """DSS over the full nonhydrostatic state (flat metric: all scalars).

    ``mesh``: optional jax.sharding.Mesh — use the explicit
    shard_map + ppermute halo-exchange DSS (``parallel/dss_shardmap``)
    instead of relying on GSPMD auto-partitioning.
    """
    if mesh is not None:
        from ..parallel.dss_shardmap import make_cartesian_dss_shardmap
        dss_fn = make_cartesian_dss_shardmap(geom, mesh)
    else:
        dss_fn = lambda f, halo=None: cart.apply_dss_cartesian(
            f, geom, halo=halo)

    def dss_state(s, halo=None):
        out = {}
        for k, f in s.items():
            hk = halo.get(k) if halo is not None else None
            if k == "Tracers":
                if hk is None:
                    out[k] = jax.vmap(lambda x: dss_fn(x))(f)
                else:
                    out[k] = jax.vmap(
                        lambda x, h: dss_fn(x, halo=h))(f, hk)
            else:
                out[k] = dss_fn(f, halo=hk)
        # NOTE: no u^a=0 overwrite here — the reference's no-flux velocity
        # fix (ApplyBoundaryConditions) writes halo nodes its DSS never
        # reads (GridPatchCartesianGLL.cpp:1180: pairs (0,1) while the
        # averaging pairs (3,4)), so at the wall U is averaged with its
        # lagged halo exactly like a scalar.  apply_noflux_x remains
        # available as the clean SEM treatment for non-parity use.
        return out
    return dss_state


def build_nh_sphere_geometry(cfg: ModelConfig, topography=None,
                             ztop: float = None, rayleigh=None):
    return sphere_geom.build_geometry(
        ne=cfg.ne, p=cfg.order, constants=cfg.constants, nz=cfg.nz,
        ztop=ztop if ztop is not None else cfg.ztop,
        topography=topography, vertical_order=cfg.vertical_order,
        staggering=cfg.vertical_staggering.value,
        vdisc=cfg.vertical_discretization,
        rayleigh=rayleigh, stretch=_stretch(cfg), dtype=cfg.dtype)


def make_sphere_dss(geom, mesh=None) -> Callable:
    """DSS over the nonhydrostatic state on the cubed sphere.

    U/V transform as a covariant vector pair across panel edges
    (``TransformHaloVelocities``); Rt/W/Rho/tracers are scalars.

    ``mesh``: optional jax.sharding.Mesh — use the explicit
    shard_map + routed-ppermute edge-exchange DSS
    (``parallel/dss_shardmap``) instead of GSPMD auto-partitioning.
    """
    if mesh is not None:
        from ..parallel.dss_shardmap import make_sphere_dss_shardmap
        dss_s, dss_v = make_sphere_dss_shardmap(geom, mesh)
    else:
        # single-device path: the slice/scatter formulation (the
        # scatter-minimal variant is parallel/dss_gather.py)
        dss_s = lambda f: sphere_dss.apply_dss_scalar(f, geom)
        dss_v = lambda u, v: sphere_dss.apply_dss_vector(u, v, geom)

    def dss_state(s):
        out = dict(s)
        u, v = dss_v(s["U"], s["V"])
        out["U"], out["V"] = u, v
        for k in ("Rt", "W", "Rho"):
            out[k] = dss_s(s[k])
        if "Tracers" in s:
            out["Tracers"] = jax.vmap(dss_s)(s["Tracers"])
        return out
    return dss_state


def make_nh_step(cfg: ModelConfig, geom, ref_state=None, mesh=None):
    """(first_step, step) jitted Strang-HEVI steppers for this config.

    ``mesh``: optional device mesh — route DSS through the explicit
    shard_map halo-exchange layer (O(surface) communication) instead of
    GSPMD auto-partitioning.
    """
    if cfg.grid_kind == GridKind.CUBED_SPHERE:
        dss_state = make_sphere_dss(geom, mesh=mesh)
    else:
        dss_state = make_cartesian_dss(geom, mesh=mesh)
    from ..config import TimestepSchemeType
    if cfg.timescheme == TimestepSchemeType.SPEX:
        from .split_explicit import make_spex_step
        return make_spex_step(cfg, geom, dss_state, ref_state)
    if cfg.timescheme == TimestepSchemeType.HS:
        from .highspeed import make_hs_step
        return make_hs_step(cfg, geom, dss_state, ref_state)
    return make_strang_step(cfg, geom, dss_state, ref_state, mesh=mesh)


def make_nh_imex_step(cfg: ModelConfig, geom, ref_state=None, mesh=None):
    """Jitted IMEX-ARK stepper (self-starting): state -> state."""
    from ..timestep.imex import make_imex_step
    if cfg.grid_kind == GridKind.CUBED_SPHERE:
        dss_state = make_sphere_dss(geom, mesh=mesh)
    else:
        dss_state = make_cartesian_dss(geom, mesh=mesh)
    return make_imex_step(cfg, geom, dss_state, ref_state)


def make_nh_multistep(cfg: ModelConfig, geom, inner_steps: int,
                      ref_state=None, mesh=None):
    """K Strang steps fused under one jit with lax.scan (benchmark path)."""
    first_step, step = make_nh_step(cfg, geom, ref_state, mesh=mesh)

    @hoisted_jit
    def multi(state, carry):
        def body(sc, _):
            s, c = step(*sc)
            return (s, c), None
        (s, c), _ = jax.lax.scan(body, (state, carry), None,
                                 length=inner_steps)
        return s, c

    return first_step, multi


def run_nh(cfg: ModelConfig, state, nsteps: int, geom):
    first_step, step = make_nh_step(cfg, geom)
    state, carry = first_step(state)
    for _ in range(nsteps - 1):
        state, carry = step(state, carry)
    return state
