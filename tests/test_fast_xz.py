"""Cartesian-xz z-first fast engine == reference-layout engine.

Round-5 VERDICT item 3: the BASELINE config #2 family (Schar mountain
waves and the other periodic xz slices) runs on the same z-first
engine as the sphere — one panel, periodic wrap-sum DSS
(``fast/dss._pair_masks(wrap=True)``), xz-gated V tendency.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tempestmodel_tpu.config import ModelConfig, GridKind
from tempestmodel_tpu.models import nh_model
from tempestmodel_tpu.testcases.nonhydro_xz import (ScharMountain,
                                                   InertiaGravityWave)
from tempestmodel_tpu import fast


def _schar_setup(nex=8, nz=8, **kw):
    tc = ScharMountain()
    cfg = ModelConfig(grid_kind=GridKind.CARTESIAN_XZ, nex=nex, ney=1,
                      order=4, nz=nz, x_extent=tc.x_extent,
                      ztop=tc.ztop, dt=1.0, hyperdiffusion=True,
                      nu_scalar=1e7, nu_div=1e7, nu_vort=1e7,
                      rayleigh_damping=True,
                      vertical_solver="banded", dtype=jnp.float64, **kw)
    geom = nh_model.build_nh_cartesian_geometry(
        cfg, topography=tc.topography, ztop=tc.ztop,
        rayleigh=tc.rayleigh_strength, bc_x="periodic", bc_y="periodic")
    state = tc.initial_state(geom, cfg.constants, dtype=jnp.float64)
    ref_state = tc.reference_state(geom, cfg.constants, dtype=jnp.float64)
    return cfg, geom, state, ref_state


def _igw_setup(nex=10, nz=10):
    tc = InertiaGravityWave()
    cfg = ModelConfig(grid_kind=GridKind.CARTESIAN_XZ, nex=nex, ney=1,
                      order=4, nz=nz, x_extent=tc.x_extent,
                      ztop=tc.ztop, dt=1.0, hyperdiffusion=False,
                      vertical_solver="banded", dtype=jnp.float64)
    geom = nh_model.build_nh_cartesian_geometry(
        cfg, ztop=tc.ztop, bc_x="periodic", bc_y="periodic")
    state = tc.initial_state(geom, cfg.constants, dtype=jnp.float64)
    return cfg, geom, state, None


def _run_ref(cfg, geom, state, nsteps, ref_state=None):
    first_step, step = nh_model.make_nh_step(cfg, geom,
                                             ref_state=ref_state)
    s, c = first_step(state)
    for _ in range(nsteps - 1):
        s, c = step(s, c)
    return s


def _run_fast(cfg, geom, state, nsteps, ref_state=None):
    first_step, step = fast.make_fast_step(cfg, geom,
                                           ref_state=ref_state)
    X = fast.pack_state(state)
    X, c = first_step(X)
    for _ in range(nsteps - 1):
        X, c = step(X, c)
    return fast.unpack_state(X, cfg.nz)


def _compare(s_ref, s_fast, tol):
    # V on an xz slice is driven only by roundoff (weak-gradient edge
    # terms that cancel after DSS, ~1e-21 in both engines) — normalize
    # the velocity components by the common velocity scale
    vel_scale = max(np.max(np.abs(np.asarray(s_ref["U"]))),
                    np.max(np.abs(np.asarray(s_ref["V"]))))
    for k in ("U", "V", "Rt", "W", "Rho"):
        a = np.asarray(s_ref[k])
        b = np.asarray(s_fast[k])
        scale = (vel_scale if k in ("U", "V")
                 else np.max(np.abs(a))) + 1e-300
        err = np.max(np.abs(a - b)) / scale
        assert err < tol, f"{k}: rel err {err:.3e} (tol {tol})"


def test_fast_engine_supported_xz_predicate():
    cfg, geom, _, _ = _igw_setup()
    assert fast.engine.fast_engine_supported(cfg, geom=geom)
    # no geom -> cannot check BCs -> unsupported
    assert not fast.engine.fast_engine_supported(cfg)
    # no-flux BCs keep the reference-layout engine
    geom_nf = nh_model.build_nh_cartesian_geometry(
        cfg, bc_x="noflux", bc_y="periodic")
    assert not fast.engine.fast_engine_supported(cfg, geom=geom_nf)


def test_fast_xz_matches_reference_layout_flat():
    """Flat-terrain periodic xz (inertia-gravity wave): 3 steps."""
    cfg, geom, state, _ = _igw_setup()
    s_ref = _run_ref(cfg, geom, state, 3)
    s_fast = _run_fast(cfg, geom, state, 3)
    _compare(s_ref, s_fast, 1e-11)


@pytest.mark.slow
def test_fast_xz_matches_reference_layout_schar():
    """Schar terrain + Rayleigh + nu4 (the BASELINE #2 family): 2 steps."""
    cfg, geom, state, ref_state = _schar_setup()
    s_ref = _run_ref(cfg, geom, state, 2, ref_state=ref_state)
    s_fast = _run_fast(cfg, geom, state, 2, ref_state=ref_state)
    _compare(s_ref, s_fast, 1e-11)


@pytest.mark.slow
def test_model_driver_selects_fast_xz():
    from tempestmodel_tpu.model import Model
    from tempestmodel_tpu.config import EquationSet
    tc = InertiaGravityWave()
    base = dict(equation_set=EquationSet.PRIMITIVE_NONHYDRO,
                grid_kind=GridKind.CARTESIAN_XZ, nex=10, ney=1, order=4,
                nz=10, x_extent=tc.x_extent, ztop=tc.ztop, dt=1.0,
                hyperdiffusion=False, vertical_solver="banded",
                dtype=jnp.float64)
    m_fast = Model(ModelConfig(**base), testcase=tc)
    assert m_fast._fast, "fast engine should be selected for periodic xz"
    m_fast.go(nsteps=2)
    m_ref = Model(ModelConfig(**base, fuse_pallas=False), testcase=tc)
    assert not m_ref._fast
    m_ref.go(nsteps=2)
    _compare(m_ref.state, m_fast.state, 1e-11)
