"""Interpolation from the cubed-sphere GLL grid to a regular lat-lon grid.

JAX analog of ``Grid::ReduceInterpolate`` +
``OutputManagerReference`` (``src/atm/OutputManagerReference.cpp:304-760``,
``src/atm/Grid.cpp:507-611``): instead of per-rank partial sums MPI-reduced
to rank 0, a precomputed static gather + GLL basis contraction evaluates
every output point in one batched einsum (host- or device-side).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import jax.numpy as jnp

from ..grid import cubed_sphere as cst
from ..grid.geometry import CubedSphereGeometry
from ..ops import quadrature as quad


@dataclasses.dataclass
class LatLonInterp:
    """Precomputed sampling of (nlat, nlon) points on the GLL grid."""
    lat: np.ndarray            # (nlat,)
    lon: np.ndarray            # (nlon,)
    panel: Any                 # (npt,) int
    ia: Any                    # (npt, p) A-node gather indices
    ib: Any                    # (npt, p) B-node gather indices
    ca: Any                    # (npt, p) alpha basis coefficients
    cb: Any                    # (npt, p) beta basis coefficients
    # unit-basis velocity transform at output points:
    # (ulon, ulat) = T @ (u_cov_alpha, u_cov_beta)
    vec_t: Any                 # (npt, 2, 2)

    @property
    def shape(self):
        return (len(self.lat), len(self.lon))

    def scalar(self, f):
        """Interpolate a (6, A, B[, nz]) field -> (nlat, nlon[, nz])."""
        f = jnp.asarray(f)
        blocks = f[self.panel[:, None, None], self.ia[:, :, None],
                   self.ib[:, None, :]]
        out = jnp.einsum("qi,qj,qij...->q...", self.ca, self.cb, blocks)
        return out.reshape(self.shape + f.shape[3:])

    def vector(self, u_cov, v_cov, earth_radius: float):
        """Covariant (U, V) fields -> physical (ulon, ulat) m/s."""
        ua = self.scalar(u_cov).reshape(-1, *u_cov.shape[3:])
        ub = self.scalar(v_cov).reshape(-1, *u_cov.shape[3:])
        extra = (1,) * (ua.ndim - 1)
        t = self.vec_t.reshape(self.vec_t.shape[0], *extra, 2, 2)
        ulon = t[..., 0, 0] * ua + t[..., 0, 1] * ub
        ulat = t[..., 1, 0] * ua + t[..., 1, 1] * ub
        scale = 1.0 / earth_radius
        return (ulon.reshape(self.shape + u_cov.shape[3:]) * scale,
                ulat.reshape(self.shape + u_cov.shape[3:]) * scale)


def build_latlon_interp(geom: CubedSphereGeometry, nlat: int, nlon: int,
                        dtype=jnp.float64) -> LatLonInterp:
    """Precompute the interpolation tables (host-side).

    Output grid matches the reference default: equally spaced cell-center
    latitudes in (-90, 90), longitudes in [0, 360).
    """
    ne, p = geom.ne, geom.p
    delta = float(geom.delta_a)
    lat = (np.arange(nlat) + 0.5) / nlat * np.pi - 0.5 * np.pi
    lon = np.arange(nlon) / nlon * 2.0 * np.pi

    LON, LAT = np.meshgrid(lon, lat)
    lonf, latf = LON.ravel(), LAT.ravel()
    X, Y, panel = cst.xyp_from_rll(lonf, latf)
    alpha, beta = np.arctan(X), np.arctan(Y)

    # containing element + local [0, 1] coordinate
    x01, _ = quad.gauss_lobatto(p, 0.0, 1.0)

    def locate(c):
        e = np.clip(((c + 0.25 * np.pi) / delta).astype(np.int64), 0, ne - 1)
        loc = (c + 0.25 * np.pi) / delta - e
        return e, loc

    ea, la = locate(alpha)
    eb, lb = locate(beta)

    npt = len(lonf)
    ca = np.zeros((npt, p))
    cb = np.zeros((npt, p))
    for q in range(npt):
        ca[q] = quad.lagrange_interp_coeffs(x01, la[q])
        cb[q] = quad.lagrange_interp_coeffs(x01, lb[q])
    ia = ea[:, None] * p + np.arange(p)[None, :]
    ib = eb[:, None] * p + np.arange(p)[None, :]

    # covariant -> unit-sphere-basis velocity transform at output points
    vec_t = np.zeros((npt, 2, 2))
    for pa in range(6):
        m = panel == pa
        if not m.any():
            continue
        for col, (ua, ub) in enumerate(((1.0, 0.0), (0.0, 1.0))):
            ulon_c, ulat_c = cst.vec_sphere_from_cov(
                X[m], Y[m], pa, np.full(m.sum(), ua), np.full(m.sum(), ub))
            vec_t[m, 0, col] = ulon_c
            vec_t[m, 1, col] = ulat_c

    cast = lambda v: jnp.asarray(v, dtype=dtype)
    return LatLonInterp(
        lat=lat, lon=lon,
        panel=jnp.asarray(panel), ia=jnp.asarray(ia), ib=jnp.asarray(ib),
        ca=cast(ca), cb=cast(cb), vec_t=cast(vec_t))
