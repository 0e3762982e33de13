"""The z-first DSS (``fast/dss.py``) vs the reference-layout DSS
formulations: ``parallel/dss.py`` on the cubed sphere, and
``grid/cartesian.apply_dss_cartesian`` (periodic wrap-sums) on the plane.

The fast engine's equality tests cover the DSS end-to-end; this file
pins it in isolation.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tempestmodel_tpu.config import ModelConfig, GridKind
from tempestmodel_tpu.grid.cartesian import apply_dss_cartesian
from tempestmodel_tpu.models import nh_model
from tempestmodel_tpu.fast import engine, dss
from tempestmodel_tpu.parallel import dss as ref_dss


def _setup(ne=4, nz=6):
    cfg = ModelConfig(grid_kind=GridKind.CUBED_SPHERE, ne=ne, order=4,
                      nz=nz, dt=100.0, dtype=jnp.float64)
    geom = nh_model.build_nh_sphere_geometry(cfg, ztop=1e4)
    fg = engine.build_fast_geometry(geom, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    d = {k: jnp.asarray(rng.standard_normal(
        (nz + (1 if k == "W" else 0), 6, fg.A, fg.A)))
        for k in engine.FIELDS}
    return geom, fg, d


def test_dss_scalar_matches_reference_formulation():
    geom, fg, d = _setup()
    out = dss.dss_scalar(d["Rt"], fg.inv_mult, fg.dss_links, fg.p)
    # reference-layout formulation on the z-last field
    want = ref_dss.apply_dss_scalar(jnp.moveaxis(d["Rt"], 0, -1), geom)
    np.testing.assert_allclose(np.asarray(jnp.moveaxis(out, 0, -1)),
                               np.asarray(want), rtol=0, atol=1e-13)


def test_dss_vector_matches_reference_formulation():
    geom, fg, d = _setup()
    u, v = dss.dss_vector(d["U"], d["V"], fg.inv_mult, fg.e_rot,
                          fg.dss_links, fg.p)
    wu, wv = ref_dss.apply_dss_vector(jnp.moveaxis(d["U"], 0, -1),
                                      jnp.moveaxis(d["V"], 0, -1), geom)
    np.testing.assert_allclose(np.asarray(jnp.moveaxis(u, 0, -1)),
                               np.asarray(wu), rtol=0, atol=1e-13)
    np.testing.assert_allclose(np.asarray(jnp.moveaxis(v, 0, -1)),
                               np.asarray(wv), rtol=0, atol=1e-13)


def test_dss_link_table_needs_one_link_per_edge():
    _, fg, _ = _setup(ne=2, nz=1)
    links = fg.dss_links
    with pytest.raises(ValueError, match="two links"):
        dss._link_tables(links + links[:1], 6)
    with pytest.raises(ValueError, match="exactly one link"):
        dss._link_tables(links[1:], 6)


@pytest.mark.parametrize("nex,ney,swap", [(5, 3, False), (6, 1, True)])
def test_dss_periodic_wrap_matches_cartesian(nex, ney, swap):
    """One panel, no links: pair sums with the periodic wrap on both
    axes, in the engine's natural and (a, b)-transposed layouts."""
    nz = 3
    cfg = ModelConfig(grid_kind=GridKind.CARTESIAN_3D, nex=nex, ney=ney,
                      order=4, nz=nz, x_extent=(0.0, 1e5),
                      y_extent=(0.0, 6e4),
                      ztop=1e4, dt=1.0, dtype=jnp.float64)
    geom = nh_model.build_nh_cartesian_geometry(
        cfg, ztop=1e4, bc_x="periodic", bc_y="periodic")
    fg = engine.build_fast_geometry_cartesian(geom, dtype=jnp.float64,
                                              swap_ab=swap)
    assert fg.wrap == (True, True) and fg.dss_links == ()
    rng = np.random.default_rng(nex)
    f = rng.standard_normal((1, nex * 4, ney * 4, nz))       # z-last
    want = np.asarray(apply_dss_cartesian(jnp.asarray(f), geom))
    zf = np.moveaxis(f, -1, 0)                               # z-first
    if swap:
        zf = np.swapaxes(zf, 2, 3)
    got = np.asarray(dss.dss_scalar(jnp.asarray(zf), fg.inv_mult,
                                    fg.dss_links, fg.p, wrap=fg.wrap))
    back = np.swapaxes(got, 2, 3) if swap else got
    np.testing.assert_allclose(np.moveaxis(back, 0, -1), want,
                               rtol=0, atol=1e-13)
    # a vector pair has no rotation on the plane: each component DSSes
    # like a scalar
    u, v = dss.dss_vector(jnp.asarray(zf), jnp.asarray(2.0 * zf),
                          fg.inv_mult, fg.e_rot, fg.dss_links, fg.p,
                          wrap=fg.wrap)
    np.testing.assert_allclose(np.asarray(u), got, rtol=0, atol=1e-13)
    np.testing.assert_allclose(np.asarray(v), 2.0 * got, rtol=0,
                               atol=1e-12)
