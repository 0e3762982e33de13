"""Cartesian-plane GLL grid geometry (x-z slice and doubly-periodic 3D).

JAX analog of the reference ``GridCartesianGLL`` /
``GridPatchCartesianGLL::EvaluateGeometricTerms``
(``src/atm/GridPatchCartesianGLL.cpp:197-460``): flat 2D metric, beta-plane
Coriolis, and the "6th-order decay" terrain-following vertical coordinate.

Layout matches the cubed-sphere module with a single panel: fields are
(1, A, B[, nz]) with A = nex*p, B = ney*p, so all SEM operators and model
code are shared.  DSS reduces to interior element-boundary averaging plus
periodic wrap at the lateral boundaries.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from ..constants import PhysicalConstants
from ..ops import quadrature as quad
from ..ops import column_ops as co


def _decay(reta):
    """Terrain decay profile b(reta) of the Cartesian vertical coordinate.

    z = ztop*reta + (1 - reta) * b(reta) * Zs with
    b = cos(pi reta/2)^6 + reta sin(pi reta/2)/4
    (reference ``GridPatchCartesianGLL.cpp:305-340``, power=6, botRate=1).
    """
    c = np.cos(0.5 * np.pi * reta)
    s = np.sin(0.5 * np.pi * reta)
    return c ** 6 + 0.25 * reta * s


def _decay_z_terms(reta, ztop, zs):
    """(z, db_scale, dxz) at given reta: z, the horizontal-derivative scale
    factor (1-reta)*b (multiplying dZs/da), and dz/dxi.

    Matches the reference's expressions verbatim, including its dDxZ which
    folds the analytic derivative of (1-reta)*b(reta).
    """
    power = 6.0
    c = np.cos(0.5 * np.pi * reta)
    s = np.sin(0.5 * np.pi * reta)
    b = c ** power + 0.25 * reta * s
    z = ztop * reta + (1.0 - reta) * b * zs
    hscale = (1.0 - reta) * b
    dxz = ztop + zs * (
        - b
        + (1.0 - reta) * (
            -3.0 * np.pi * c ** (power - 1.0) * s
            + 0.25 * s
            + np.pi / 8.0 * reta * c))
    return z, hscale, dxz


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class CartesianGeometry:
    """Precomputed geometry for a Cartesian-plane GLL grid (1 panel)."""

    # --- static ---
    nex: int
    ney: int
    p: int
    nz: int
    vo: int
    is_xz: bool
    delta_a: float            # element width in x (m)
    delta_b: float            # element width in y (m)
    reference_length: float

    # --- array leaves ---
    gll_w: Any
    deriv: Any                # (p, p)
    stiff: Any                # (p, p)
    x: Any                    # (A,)
    y: Any                    # (B,)
    coriolis: Any             # (1, A, B)
    jac2d: Any                # (1, A, B)
    con2d: Any                # (1, A, B, 2, 2)
    cov2d: Any
    area2d: Any
    inv_mult: Any             # (1, A, B) 1/multiplicity for DSS
    topo: Any                 # (1, A, B)
    dtopo: Any                # (1, A, B, 2)
    # vertical / 3D
    jac3d: Any                # (1, A, B, nz)
    jac3d_int: Any
    deriv_r: Any              # (1, A, B, nz, 3)
    deriv_r_int: Any
    con_a_xi: Any             # g^{a,xi}
    con_b_xi: Any
    con_xi_xi: Any
    con_a_xi_int: Any
    con_b_xi_int: Any
    con_xi_xi_int: Any
    area3d: Any
    area3d_int: Any
    z_lev: Any
    z_int: Any
    rayleigh_lev: Any
    rayleigh_int: Any
    # vertical column operators (dense matrices over the level axis)
    interp_n2i: Any
    interp_i2n: Any
    diff_n2n: Any
    diff_n2n_zb: Any
    diff_n2i: Any
    diff_i2n: Any
    diff_i2i: Any
    diffdiff_n2n: Any
    diffdiff_i2i: Any
    penalty_left: Any
    penalty_right: Any
    wscat_left: Any
    wscat_right: Any
    # lateral BCs: "periodic" | "noflux" (reference
    # Grid::BoundaryCondition_NoFlux, GridPatchCartesianGLL.cpp:928-1075)
    bc_x: str = "periodic"
    bc_y: str = "periodic"

    _STATIC = ("nex", "ney", "p", "nz", "vo", "is_xz",
               "delta_a", "delta_b", "reference_length", "bc_x", "bc_y")

    def tree_flatten(self):
        d = dataclasses.asdict(self)
        static = {k: d.pop(k) for k in self._STATIC}
        keys = tuple(sorted(d))
        return tuple(d[k] for k in keys), (static, keys)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        static, keys = aux
        return cls(**static, **dict(zip(keys, leaves)))

    @property
    def nea(self):
        return self.nex

    @property
    def neb(self):
        return self.ney


def _eval_rayleigh(rayleigh, z, x, y):
    """Evaluate a Rayleigh strength callable of (z[, x, y]) on the grid."""
    if rayleigh is None:
        return np.zeros(z.shape)
    import inspect
    # pass (x, y) whenever the callable accepts them — optional x/y
    # parameters (the testcase convention) still carry lateral sponges
    nparams = len(inspect.signature(rayleigh).parameters)
    if nparams >= 2:
        xb = np.broadcast_to(x[None, :, None, None], z.shape)
        yb = np.broadcast_to(y[None, None, :, None], z.shape)
        return np.asarray(rayleigh(z, xb, yb))
    return np.asarray(rayleigh(z))


def build_cartesian_geometry(
    nex: int,
    ney: int,
    p: int,
    nz: int,
    x_extent,
    y_extent,
    ztop: float,
    constants: PhysicalConstants,
    vertical_order: int = 1,
    topography=None,
    is_xz: bool = True,
    reference_latitude: float = 0.0,
    stretch=None,
    rayleigh=None,
    bc_x: str = "periodic",
    bc_y: str = "periodic",
    staggering: str = "LOR",
    vdisc: str = "FE",
    dtype=jnp.float64,
) -> CartesianGeometry:
    """Precompute the Cartesian geometry pytree (host-side float64).

    ``topography``: callable (x, y) -> Zs or None.
    """
    A, B = nex * p, ney * p
    x01, w01 = quad.gauss_lobatto(p, 0.0, 1.0)
    D = quad.derivative_matrix(x01)
    S = quad.stiffness_matrix(x01, w01)

    Lx = x_extent[1] - x_extent[0]
    Ly = y_extent[1] - y_extent[0]
    da = Lx / nex
    db = Ly / ney
    x = x_extent[0] + da * (np.repeat(np.arange(nex), p) + np.tile(x01, nex))
    y = y_extent[0] + db * (np.repeat(np.arange(ney), p) + np.tile(x01, ney))

    # beta-plane Coriolis (reference :245-260); zero for xz slices
    if is_xz:
        cor = np.zeros((1, A, B))
    else:
        y0 = 0.5 * abs(Ly)
        fp = 2.0 * constants.omega * np.sin(reference_latitude)
        betap = (2.0 * constants.omega * np.cos(reference_latitude)
                 / constants.earth_radius)
        cor = np.broadcast_to(
            fp + betap * (y[None, :] - y0), (1, A, B)).copy()

    jac2d = np.ones((1, A, B))
    con2d = np.zeros((1, A, B, 2, 2))
    con2d[..., 0, 0] = 1.0
    con2d[..., 1, 1] = 1.0
    cov2d = con2d.copy()
    w2d = w01[:, None] * w01[None, :]
    arow = np.tile(w2d.reshape(1, p, 1, p), (nex, 1, ney, 1)).reshape(A, B)
    area2d = (arow * da * db)[None]

    # DSS multiplicity: interior element boundaries 2x; periodic wrap edges 2x
    def mult1(ne, wrap=True):
        m = np.ones(ne * p)
        for e in range(1, ne):
            m[e * p - 1] = 2.0
            m[e * p] = 2.0
        if ne > 0 and wrap:
            m[0] *= 2.0
            m[-1] *= 2.0
        return m
    inv_mult = 1.0 / (mult1(nex, bc_x == "periodic")[:, None]
                      * mult1(ney, bc_y == "periodic")[None, :])[None]

    if topography is None:
        topo = np.zeros((1, A, B))
    else:
        topo = np.asarray(
            topography(x[:, None] * np.ones((1, B)),
                       np.ones((A, 1)) * y[None, :]),
            dtype=np.float64)[None]
    # SE derivative of topography (element-local), then DSS averaging —
    # the reference's DataType_TopographyDeriv exchange
    # (``GridCartesianGLL.cpp:531-612``); basis is uniform so no vector
    # rotation, and wrap applies only on periodic axes.
    topo_e = topo.reshape(1, nex, p, ney, p)
    dtopo = np.zeros((1, A, B, 2))
    dtopo[..., 0] = np.einsum("Pasbt,si->Paibt", topo_e, D).reshape(1, A, B) / da
    dtopo[..., 1] = np.einsum("Pasbt,ti->Pasbi", topo_e, D).reshape(1, A, B) / db

    def _dss_np(f):
        f = f.copy()
        for axis, (nel, wrap) in ((1, (nex, bc_x == "periodic")),
                                  (2, (ney, bc_y == "periodic"))):
            if nel <= 1 and not wrap:
                continue
            fm = np.moveaxis(f, axis, 1)
            s = fm[:, p - 1:-1:p] + fm[:, p::p]
            fm[:, p - 1:-1:p] = s
            fm[:, p::p] = s
            if wrap:
                s = fm[:, 0] + fm[:, -1]
                fm[:, 0] = s
                fm[:, -1] = s
            f = np.moveaxis(fm, 1, axis)
        return f * inv_mult
    dtopo[..., 0] = _dss_np(dtopo[..., 0])
    dtopo[..., 1] = _dss_np(dtopo[..., 1])

    # vertical coordinate + column operators
    if staggering == "INT":
        ops = co.build_column_ops_interfaces(nz, vertical_order, stretch)
    elif vdisc == "FV":
        ops = co.build_column_ops_fv(nz, vertical_order, stretch)
    else:
        ops = co.build_column_ops(nz, vertical_order, stretch)
    reta_lev, reta_int = ops.reta_lev, ops.reta_int

    zs = topo[..., None]           # (1, A, B, 1)
    da_zs = dtopo[..., 0:1]
    db_zs = dtopo[..., 1:2]

    def vert(reta):
        z, hscale, dxz = _decay_z_terms(reta, ztop, zs)
        daz = hscale * da_zs
        dbz = hscale * db_zs
        dxz = np.broadcast_to(dxz, daz.shape)
        jac = dxz * 1.0
        con_a_xi = -daz / dxz
        con_b_xi = -dbz / dxz
        con_xi_xi = (1.0 + daz * daz + dbz * dbz) / (dxz * dxz)
        deriv_r = np.stack([np.broadcast_to(daz, daz.shape),
                            np.broadcast_to(dbz, daz.shape), dxz], axis=-1)
        return z, jac, con_a_xi, con_b_xi, con_xi_xi, deriv_r

    z_lev, jac3d, ca, cb, cx, dr = vert(reta_lev)
    z_int, jac3d_int, ca_i, cb_i, cx_i, dr_i = vert(reta_int)

    area3d = jac3d * (arow * da * db)[None, ..., None] * ops.na_lev
    area3d_int = jac3d_int * (arow * da * db)[None, ..., None] * ops.na_int

    z_lev = np.broadcast_to(z_lev, jac3d.shape)
    z_int = np.broadcast_to(z_int, jac3d_int.shape)

    cast = lambda v: jnp.asarray(v, dtype=dtype)
    return CartesianGeometry(
        nex=nex, ney=ney, p=p, nz=nz, vo=ops.vo, is_xz=is_xz,
        delta_a=float(da), delta_b=float(db),
        reference_length=float(min(abs(Lx), 110000.0)),
        gll_w=cast(w01), deriv=cast(D), stiff=cast(S),
        x=cast(x), y=cast(y), coriolis=cast(cor),
        jac2d=cast(jac2d), con2d=cast(con2d), cov2d=cast(cov2d),
        area2d=cast(area2d), inv_mult=cast(inv_mult),
        topo=cast(topo), dtopo=cast(dtopo),
        jac3d=cast(jac3d), jac3d_int=cast(jac3d_int),
        deriv_r=cast(dr), deriv_r_int=cast(dr_i),
        con_a_xi=cast(ca), con_b_xi=cast(cb), con_xi_xi=cast(cx),
        con_a_xi_int=cast(ca_i), con_b_xi_int=cast(cb_i),
        con_xi_xi_int=cast(cx_i),
        area3d=cast(area3d), area3d_int=cast(area3d_int),
        z_lev=cast(z_lev), z_int=cast(z_int),
        rayleigh_lev=cast(_eval_rayleigh(
            rayleigh, np.broadcast_to(z_lev, jac3d.shape), x, y)),
        rayleigh_int=cast(_eval_rayleigh(
            rayleigh, np.broadcast_to(z_int, jac3d_int.shape), x, y)),
        interp_n2i=cast(ops.interp_n2i), interp_i2n=cast(ops.interp_i2n),
        diff_n2n=cast(ops.diff_n2n), diff_n2n_zb=cast(ops.diff_n2n_zb),
        diff_n2i=cast(ops.diff_n2i), diff_i2n=cast(ops.diff_i2n),
        diff_i2i=cast(ops.diff_i2i),
        diffdiff_n2n=cast(ops.diffdiff_n2n),
        diffdiff_i2i=cast(ops.diffdiff_i2i),
        penalty_left=(None if ops.penalty_left is None
                      else cast(ops.penalty_left)),
        penalty_right=(None if ops.penalty_right is None
                       else cast(ops.penalty_right)),
        wscat_left=(None if ops.wscat_left is None
                    else cast(ops.wscat_left)),
        wscat_right=(None if ops.wscat_right is None
                     else cast(ops.wscat_right)),
        bc_x=bc_x, bc_y=bc_y,
    )


# ---------------------------------------------------------------------------
# DSS for the periodic Cartesian grid
# ---------------------------------------------------------------------------

def _pair_sum_axis(f, ne: int, p: int, axis: int, periodic: bool):
    """Sum coincident element-boundary copies along one axis."""
    sl = [slice(None)] * f.ndim

    def take(idx):
        s = list(sl)
        s[axis] = idx
        return tuple(s)

    hi = f[take(slice(p - 1, -1, p))]
    lo = f[take(slice(p, None, p))]
    s = hi + lo
    f = f.at[take(slice(p - 1, -1, p))].set(s)
    f = f.at[take(slice(p, None, p))].set(s)
    if periodic:
        edge = f[take(0)] + f[take(-1)]
        f = f.at[take(0)].set(edge)
        f = f.at[take(-1)].set(edge)
    return f


def apply_dss_cartesian(f, geom: CartesianGeometry, halo=None):
    """DSS of a scalar (1, A, B, ...) field.

    x edges: periodic wrap-sum, or for ``bc_x == "noflux"`` an average
    with the halo copy of the edge node (reference
    ``GridCartesianGLL::ApplyDSS``: the halo coincides spatially with the
    boundary node and carries the value from the instance's last
    DSS/copy, ``GridCartesianGLL.cpp:600-660``).  ``halo``: array whose
    x-edge values are the current halo contents; None = halo tracks the
    edge (identity average).
    """
    f = _pair_sum_axis(f, geom.nex, geom.p, 1, geom.bc_x == "periodic")
    f = _pair_sum_axis(f, geom.ney, geom.p, 2, geom.bc_y == "periodic")
    w = geom.inv_mult
    f = f * w.reshape(w.shape + (1,) * (f.ndim - 3))
    if geom.bc_x == "noflux" and halo is not None:
        f = f.at[:, 0].set(0.5 * (f[:, 0] + halo[:, 0]))
        f = f.at[:, -1].set(0.5 * (f[:, -1] + halo[:, -1]))
    if geom.bc_y == "noflux" and halo is not None:
        f = f.at[:, :, 0].set(0.5 * (f[:, :, 0] + halo[:, :, 0]))
        f = f.at[:, :, -1].set(0.5 * (f[:, :, -1] + halo[:, :, -1]))
    return f


def apply_noflux_x(state, geom: CartesianGeometry):
    """Impose zero normal contravariant velocity u^a = 0 at the x edges.

    Reference ``GridPatchCartesianGLL::ApplyBoundaryConditions``
    (``:928-1075``): U at the boundary is set so that
    g^{aa} U + g^{ab} V + g^{a,xi} W = 0 with the boundary V/W values.
    Applied after DSS (the reference's pre-DSS halo write + averaging
    has the same fixed point).
    """
    if geom.bc_x != "noflux":
        return state
    u = state["U"]
    gaa = geom.con2d[..., 0, 0, None]
    gab = geom.con2d[..., 0, 1, None]
    w_n = jnp.einsum("KL,...L->...K", geom.interp_i2n, state["W"])
    u_fix = -(gab * state["V"] + geom.con_a_xi * w_n) / gaa
    u = u.at[:, 0].set(u_fix[:, 0]).at[:, -1].set(u_fix[:, -1])
    return dict(state, U=u)


def apply_noflux_y(state, geom: CartesianGeometry):
    """Impose zero normal contravariant velocity u^b = 0 at the y edges.

    Mirror of :func:`apply_noflux_x` for channel grids (reference
    ``GridPatchCartesianGLL::ApplyBoundaryConditions`` with
    ``m_iLatBC[1/3] == BoundaryCondition_NoFlux``, e.g. the 3-D Cartesian
    baroclinic channel ``test/nonhydro_xz/Baroclinic3DCartesianTest.cpp:
    144-147``)."""
    if geom.bc_y != "noflux":
        return state
    v = state["V"]
    gbb = geom.con2d[..., 1, 1, None]
    gab = geom.con2d[..., 0, 1, None]
    w_n = jnp.einsum("KL,...L->...K", geom.interp_i2n, state["W"])
    v_fix = -(gab * state["U"] + geom.con_b_xi * w_n) / gbb
    v = v.at[:, :, 0].set(v_fix[:, :, 0]).at[:, :, -1].set(v_fix[:, :, -1])
    return dict(state, V=v)
