"""Analytic banded-Jacobian assembly vs AD band extraction.

``nonhydro.assemble_bands_analytic`` must produce exactly the same
banded matrix as the (2q+1)-coloring AD extraction
(``vertical_banded.extract_bands_t``) of the column residual — it is the
analytic analog of the reference's hand-coded ``BuildJacobianF``
(``src/atm/VerticalDynamicsFEM.cpp:3191``), used as the fast path.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tempestmodel_tpu.config import ModelConfig, GridKind
from tempestmodel_tpu.models import nh_model, nonhydro
from tempestmodel_tpu.models import vertical_banded as vb



def _perturbed_state(geom, constants, seed=0):
    """Hydrostatic-ish background + noise so no Jacobian term vanishes."""
    rng = np.random.default_rng(seed)
    shape3 = geom.jac3d.shape[:3]
    nz = geom.nz

    def noisy(base, shape):
        return jnp.asarray(base * (1.0 + 0.05 * rng.standard_normal(shape)))

    return {
        "U": noisy(10.0, shape3 + (nz,)),
        "V": noisy(5.0, shape3 + (nz,)),
        "Rt": noisy(300.0, shape3 + (nz,)),
        "W": jnp.asarray(0.5 * rng.standard_normal(shape3 + (nz + 1,))),
        "Rho": noisy(1.0, shape3 + (nz,)),
    }


def _compare_bands(geom, constants, dt=30.0, seed=0):
    nz = geom.nz
    state = _perturbed_state(geom, constants, seed)
    x0, aux, gmats, _ = nonhydro._implicit_aux(state, geom)
    q = nonhydro.estimate_bandwidth(geom, constants)
    statics = nonhydro.band_assembly_statics(geom, q)

    perm = jnp.asarray(vb.interleave_perm(nz))
    inv_perm = jnp.argsort(perm)

    def batched_resid(xs):
        return jax.vmap(
            lambda x, a: nonhydro._column_residual(
                x, a, gmats, constants, dt, nz))(xs, aux)

    bands_ad = np.asarray(vb.extract_bands_t(
        batched_resid, x0, q, perm, inv_perm))
    bands_an = np.asarray(nonhydro.assemble_bands_analytic(
        x0, aux, gmats, statics, constants, dt, nz))

    assert bands_an.shape == bands_ad.shape
    # tight absolute floor: physically-tiny couplings (e.g. the (rho,w)
    # mass-flux block, ~1e-7 of the diagonal) must land in the right slot
    scale = np.abs(bands_ad).max()
    np.testing.assert_allclose(bands_an, bands_ad, rtol=1e-10,
                               atol=1e-16 * scale)


@pytest.mark.parametrize("vo,nz", [(1, 8), (2, 8), (3, 9)])
def test_bands_analytic_xz(vo, nz):
    """Cartesian xz slice, varying vertical order (penalty active)."""
    cfg = ModelConfig(grid_kind=GridKind.CARTESIAN_XZ, nex=3, ney=1,
                      order=4, nz=nz, ztop=10e3, x_extent=(0.0, 20e3),
                      y_extent=(0.0, 1e3), dt=1.0, vertical_order=vo,
                      hyperdiffusion=False)
    geom = nh_model.build_nh_cartesian_geometry(cfg)
    _compare_bands(geom, cfg.constants, seed=vo)


def test_bands_analytic_sphere():
    """Cubed-sphere geometry (terrain-free, Lorenz staggering)."""
    cfg = ModelConfig(grid_kind=GridKind.CUBED_SPHERE, ne=2, order=4,
                      nz=6, ztop=30e3, dt=100.0, hyperdiffusion=False)
    geom = nh_model.build_nh_sphere_geometry(cfg, ztop=30e3)
    _compare_bands(geom, cfg.constants, dt=100.0, seed=7)


def test_bands_analytic_single_element_column():
    """nfe == 1: the penalty terms vanish (has_penalty False branch)."""
    cfg = ModelConfig(grid_kind=GridKind.CARTESIAN_XZ, nex=3, ney=1,
                      order=4, nz=6, ztop=10e3, x_extent=(0.0, 20e3),
                      y_extent=(0.0, 1e3), dt=1.0, vertical_order=6,
                      hyperdiffusion=False)
    geom = nh_model.build_nh_cartesian_geometry(cfg)
    _compare_bands(geom, cfg.constants, seed=3)


def test_newton_update_equivalence():
    """Full banded Newton step: analytic-bands path == AD-bands path."""
    cfg = ModelConfig(grid_kind=GridKind.CARTESIAN_XZ, nex=3, ney=1,
                      order=4, nz=8, ztop=10e3, x_extent=(0.0, 20e3),
                      y_extent=(0.0, 1e3), dt=1.0, hyperdiffusion=False)
    geom = nh_model.build_nh_cartesian_geometry(cfg)
    constants = cfg.constants
    nz = geom.nz
    state = _perturbed_state(geom, constants, seed=11)
    q = nonhydro.estimate_bandwidth(geom, constants)
    statics = nonhydro.band_assembly_statics(geom, q)

    out_ad = nonhydro.vertical_implicit(state, geom, constants, 0.5,
                                        solver="banded", q=q)
    out_an = nonhydro.vertical_implicit(state, geom, constants, 0.5,
                                        solver="banded", q=q,
                                        band_statics=statics)
    for k in out_ad:
        np.testing.assert_allclose(np.asarray(out_an[k]),
                                   np.asarray(out_ad[k]),
                                   rtol=1e-11, atol=1e-11)
