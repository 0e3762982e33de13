"""Cubed-sphere GLL grid geometry: node coordinates, metric terms, DSS tables.

JAX re-design of the reference Tempest grid layer
(``src/atm/GridCSGLL.cpp``, ``src/atm/GridPatchCSGLL.cpp:295-578``
``EvaluateGeometricTerms``).  Instead of per-patch C++ objects, all geometry
is precomputed host-side (numpy float64) into a single pytree of arrays with
the global element-stacked layout::

    scalar field      : (6, A, B)         A = B = ne * p   (2D / shallow water)
    3D level field    : (6, A, B, nz)
    3D interface field: (6, A, B, nz + 1)

where coincident GLL nodes at element boundaries are stored duplicated
(matching the reference patch layout, ``GridPatch.cpp:334-367``) so that
each element occupies a contiguous (p, p) block and DSS is a local
averaging operation.

DSS metadata (edge-coincidence tables, panel-to-panel covariant vector
transform matrices, node multiplicities) is derived *numerically* from
coordinate coincidence rather than from a hand-maintained case table
(reference: ``GridCSGLL::GetOpposingDirection`` + ``CoVecPanelTrans``).
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
from . import cubed_sphere as cst

EDGE_LEFT, EDGE_RIGHT, EDGE_BOTTOM, EDGE_TOP = 0, 1, 2, 3
EDGE_NAMES = ("left", "right", "bottom", "top")


def _edge_line_coords(alpha: np.ndarray, edge: int):
    """(alpha_i, beta_i) coordinate arrays of the nodes along a panel edge."""
    n = len(alpha)
    lo = np.full(n, -np.pi / 4)
    hi = np.full(n, np.pi / 4)
    if edge == EDGE_LEFT:
        return lo, alpha
    if edge == EDGE_RIGHT:
        return hi, alpha
    if edge == EDGE_BOTTOM:
        return alpha, lo
    if edge == EDGE_TOP:
        return alpha, hi
    raise ValueError(edge)


@dataclasses.dataclass(frozen=True)
class EdgeLink:
    """Connectivity of one panel edge to its coincident neighbor edge."""
    panel: int
    edge: int
    nbr_panel: int
    nbr_edge: int
    flip: bool                 # neighbor line must be reversed to align
    # (n, 2, 2) covariant vector transform: v_here = M @ v_neighbor,
    # evaluated at each of this edge's nodes.
    cov_vec_transform: Any     # np/jnp array


@dataclasses.dataclass(frozen=True)
class CornerLink:
    """A cube corner: 3 coincident panel-corner nodes."""
    # each entry: (panel, ia, ib)
    nodes: tuple


def gll_axis(ne: int, p: int):
    """Element-stacked GLL node coordinates along a panel axis.

    Returns (nodes, elem_weights) with nodes shape (ne*p,): for element e,
    node i sits at -pi/4 + (e + x01_i) * delta, matching the reference
    (``GridPatchCSGLL.cpp:179+``, coordinates built per element from GLL
    points on [0, 1]).
    """
    x01, w01 = quad.gauss_lobatto(p, 0.0, 1.0)
    delta = 0.5 * np.pi / ne
    nodes = (-0.25 * np.pi
             + delta * (np.repeat(np.arange(ne), p) + np.tile(x01, ne)))
    return nodes, np.tile(w01, ne)


def _panel_xyz(alpha: np.ndarray, panel: int):
    """Unit-sphere xyz of the (A, B) node grid of one panel."""
    A = len(alpha)
    X = np.tan(alpha)[:, None] * np.ones((1, A))
    Y = np.ones((A, 1)) * np.tan(alpha)[None, :]
    return np.stack(cst.xyz_from_xyp(X, Y, panel), axis=-1)  # (A, B, 3)


def _match_edges(ne: int, p: int):
    """Numerically derive the edge-to-edge coincidence table of the cube.

    For each (panel, edge) find the (neighbor panel, neighbor edge, flip)
    whose node line occupies the same points on the sphere.
    """
    alpha, _ = gll_axis(ne, p)
    lines = {}
    for pa in range(6):
        for e in range(4):
            a, b = _edge_line_coords(alpha, e)
            xyz = np.stack(cst.xyz_from_xyp(np.tan(a), np.tan(b), pa), axis=-1)
            lines[(pa, e)] = xyz
    links = {}
    for pa in range(6):
        for e in range(4):
            me = lines[(pa, e)]
            found = None
            for qa in range(6):
                if qa == pa:
                    continue
                for f in range(4):
                    other = lines[(qa, f)]
                    if np.allclose(me, other, atol=1e-12):
                        found = (qa, f, False)
                    elif np.allclose(me, other[::-1], atol=1e-12):
                        found = (qa, f, True)
                    if found:
                        break
                if found:
                    break
            assert found is not None, f"no neighbor for panel {pa} edge {e}"
            links[(pa, e)] = found
    return links


def _edge_cov_transforms(ne: int, p: int, links):
    """Per-edge-node 2x2 matrices M: v_cov_here = M @ v_cov_neighbor.

    Computed by the exact chain rule through the unit-sphere basis:
    columns of M are cov_here(sphere(cov_neighbor = e_k)).  At cube-corner
    nodes the sphere basis is fine (edge nodes never sit at panel centers,
    where the polar gnomonic map is singular).
    """
    alpha, _ = gll_axis(ne, p)
    out = {}
    for (pa, e), (qa, f, flip) in links.items():
        a_here, b_here = _edge_line_coords(alpha, e)
        a_nbr, b_nbr = _edge_line_coords(alpha, f)
        if flip:
            a_nbr, b_nbr = a_nbr[::-1], b_nbr[::-1]
        Xh, Yh = np.tan(a_here), np.tan(b_here)
        Xn, Yn = np.tan(a_nbr), np.tan(b_nbr)
        n = len(Xh)
        M = np.zeros((n, 2, 2))
        for col, (ua, ub) in enumerate(((np.ones(n), np.zeros(n)),
                                        (np.zeros(n), np.ones(n)))):
            ulon, ulat = cst.vec_sphere_from_cov(Xn, Yn, qa, ua, ub)
            ca, cb = cst.vec_cov_from_sphere(Xh, Yh, pa, ulon, ulat)
            M[:, 0, col] = ca
            M[:, 1, col] = cb
        out[(pa, e)] = M
    return out


def _corner_links(ne: int, p: int):
    """The 8 cube corners as triples of (panel, ia, ib) stored nodes."""
    A = ne * p
    idx = {(-1, -1): (0, 0), (1, -1): (A - 1, 0),
           (-1, 1): (0, A - 1), (1, 1): (A - 1, A - 1)}
    # Group panel-corner nodes by xyz
    groups = {}
    for pa in range(6):
        for (sa, sb), (ia, ib) in idx.items():
            X = np.tan(sa * np.pi / 4)
            Y = np.tan(sb * np.pi / 4)
            xyz = np.round(np.array(cst.xyz_from_xyp(X, Y, pa)), 10)
            groups.setdefault(tuple(xyz), []).append((pa, ia, ib))
    corners = []
    for xyz, nodes in groups.items():
        assert len(nodes) == 3, f"cube corner with {len(nodes)} panels"
        corners.append(CornerLink(nodes=tuple(nodes)))
    assert len(corners) == 8
    return corners


def _dss_vector_np(fu, fv, edge_meta, edge_mats, inv_mult, p: int):
    """Host-side DSS of a covariant vector pair (numpy port of
    ``parallel/dss.apply_dss_vector``), used for geometry precompute
    (topography derivatives)."""
    def pair_sum(f):
        f = f.copy()
        s = f[:, p - 1:-1:p] + f[:, p::p]
        f[:, p - 1:-1:p] = s
        f[:, p::p] = s
        s = f[:, :, p - 1:-1:p] + f[:, :, p::p]
        f[:, :, p - 1:-1:p] = s
        f[:, :, p::p] = s
        return f

    def get_edge(f, panel, edge):
        if edge == EDGE_LEFT:
            return f[panel, 0, :]
        if edge == EDGE_RIGHT:
            return f[panel, -1, :]
        if edge == EDGE_BOTTOM:
            return f[panel, :, 0]
        return f[panel, :, -1]

    def add_edge(f, panel, edge, val):
        if edge == EDGE_LEFT:
            f[panel, 0, :] += val
        elif edge == EDGE_RIGHT:
            f[panel, -1, :] += val
        elif edge == EDGE_BOTTOM:
            f[panel, :, 0] += val
        else:
            f[panel, :, -1] += val

    su, sv = pair_sum(np.asarray(fu)), pair_sum(np.asarray(fv))
    gathered = []
    for (pa, e, qa, qe, flip) in edge_meta:
        lu = get_edge(su, qa, qe)
        lv = get_edge(sv, qa, qe)
        if flip:
            lu, lv = lu[::-1], lv[::-1]
        M = np.asarray(edge_mats[pa, e])              # (A, 2, 2)
        tu = M[:, 0, 0] * lu + M[:, 0, 1] * lv
        tv = M[:, 1, 0] * lu + M[:, 1, 1] * lv
        gathered.append((pa, e, tu, tv))
    for (pa, e, tu, tv) in gathered:
        add_edge(su, pa, e, tu)
        add_edge(sv, pa, e, tv)
    w = np.asarray(inv_mult)
    return su * w, sv * w


def node_multiplicity(ne: int, p: int) -> np.ndarray:
    """(6, A, B) count of stored copies coincident with each node."""
    A = ne * p
    m1 = np.ones(A)
    # interior element boundaries: two copies along that axis
    for e in range(1, ne):
        m1[e * p - 1] = 2.0
        m1[e * p] = 2.0
    # panel edges: shared with one neighboring panel
    m1[0] *= 2.0
    m1[-1] *= 2.0
    mult = m1[:, None] * m1[None, :]
    mult = np.broadcast_to(mult, (6, A, A)).copy()
    # cube corners: 3 panels meet, not 4
    mult[:, 0, 0] = 3.0
    mult[:, -1, 0] = 3.0
    mult[:, 0, -1] = 3.0
    mult[:, -1, -1] = 3.0
    return mult


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class CubedSphereGeometry:
    """All precomputed geometry for a cubed-sphere GLL grid.

    Static metadata (ne, p, edge tables) lives in aux_data; arrays are leaves
    so the whole object can be passed through jit.
    """

    # --- static (hashable) ---
    ne: int
    p: int
    nz: int
    vo: int
    # edge links: tuple of (panel, edge, nbr_panel, nbr_edge, flip)
    edge_meta: tuple
    corner_meta: tuple

    # --- array leaves ---
    gll_w: Any            # (p,) GLL weights on [0,1]
    deriv: Any            # (p, p) D[m, i] = L_m'(x_i)
    stiff: Any            # (p, p) S[m, i] = D[m, i] w_i / w_m
    interp_gl: Any        # (p, p) node -> Gauss point interpolation (for remap)
    alpha: Any            # (A,) equiangular node coords
    lon: Any              # (6, A, B)
    lat: Any              # (6, A, B)
    coriolis: Any         # (6, A, B)
    jac2d: Any            # (6, A, B)
    con2d: Any            # (6, A, B, 2, 2) contravariant 2D metric g^{ij}
    cov2d: Any            # (6, A, B, 2, 2) covariant 2D metric g_{ij}
    area2d: Any           # (6, A, B) quadrature area weights J*wi*wj*dA*dB
    inv_mult: Any         # (6, A, B) 1/multiplicity for DSS
    edge_mats: Any        # (6, 4, A, 2, 2) per-edge cov vector transforms
    delta: float          # element width in alpha/beta
    topo: Any             # (6, A, B) surface height Zs
    dtopo: Any            # (6, A, B, 2) (dZs/da, dZs/db)
    # 3D (present when nz > 1; otherwise zero-size placeholders)
    jac3d: Any            # (6, A, B, nz)
    jac3d_int: Any        # (6, A, B, nz+1)
    deriv_r: Any          # (6, A, B, nz, 3)   (dDaR, dDbR, dDxR) on levels
    deriv_r_int: Any      # (6, A, B, nz+1, 3) on interfaces
    con_a_xi: Any         # (6, A, B, nz) g^{a,xi} component on levels
    con_b_xi: Any         # (6, A, B, nz)
    con_xi_xi: Any        # (6, A, B, nz)
    con_a_xi_int: Any     # (6, A, B, nz+1)
    con_b_xi_int: Any
    con_xi_xi_int: Any
    area3d: Any           # (6, A, B, nz)
    area3d_int: Any       # (6, A, B, nz+1)
    z_lev: Any            # (6, A, B, nz)    physical z of model levels
    z_int: Any            # (6, A, B, nz+1)  physical z of interfaces
    rayleigh_lev: Any     # (6, A, B, nz)    Rayleigh strength (0 if unused)
    rayleigh_int: Any     # (6, A, B, nz+1)
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

    def tree_flatten(self):
        d = dataclasses.asdict(self)
        static = {k: d.pop(k) for k in ("ne", "p", "nz", "vo", "edge_meta",
                                        "corner_meta", "delta")}
        keys = tuple(sorted(d))
        return tuple(d[k] for k in keys), (static, keys)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        static, keys = aux
        return cls(**static, **dict(zip(keys, leaves)))

    @property
    def npx(self):
        return self.ne * self.p

    # Rectangular-grid-generic aliases (panels are square)
    @property
    def nea(self):
        return self.ne

    @property
    def neb(self):
        return self.ne

    @property
    def delta_a(self):
        return self.delta

    @property
    def delta_b(self):
        return self.delta

    @property
    def reference_length(self):
        """Hyperdiffusion reference length (``GridCSGLL.cpp:87``)."""
        return 0.5 * np.pi / 30.0

    @property
    def is_xz(self):
        return False


def build_geometry(
    ne: int,
    p: int,
    constants: PhysicalConstants,
    nz: int = 1,
    ztop: float = 1.0,
    topography=None,
    vertical_order: int = 1,
    stretch=None,
    rayleigh=None,
    staggering: str = "LOR",
    vdisc: str = "FE",
    dtype=jnp.float64,
) -> CubedSphereGeometry:
    """Precompute the full geometry pytree (host-side, float64).

    ``topography``: callable (lon, lat) -> Zs, or None for flat.
    Vertical coordinate arrays follow the reference Gal-Chen & Somerville
    linear terrain-following form (``GridPatchCSGLL.cpp:430-470``):
    z = Zs + (ztop - Zs) * reta.
    """
    A = ne * p
    x01, w01 = quad.gauss_lobatto(p, 0.0, 1.0)
    D = quad.derivative_matrix(x01)
    S = quad.stiffness_matrix(x01, w01)
    xg, _ = quad.gauss(p, 0.0, 1.0)
    interp_gl = quad.interpolation_matrix(x01, xg)

    alpha, _ = gll_axis(ne, p)
    delta = 0.5 * np.pi / ne
    Xn = np.tan(alpha)

    a_r = constants.earth_radius

    X = Xn[:, None] * np.ones((1, A))
    Y = np.ones((A, 1)) * Xn[None, :]
    d2 = 1.0 + X * X + Y * Y
    dd = np.sqrt(d2)

    lon = np.zeros((6, A, A))
    lat = np.zeros((6, A, A))
    for pa in range(6):
        lon[pa], lat[pa] = cst.rll_from_xyp(X, Y, pa)

    coriolis = 2.0 * constants.omega * np.sin(lat)

    # 2D metric (same on every panel in gnomonic coords):
    # reference GridPatchCSGLL.cpp:390-425
    jac2d_p = (1.0 + X * X) * (1.0 + Y * Y) / (dd * d2) * a_r * a_r
    cscale = d2 / ((1.0 + X * X) * (1.0 + Y * Y)) / (a_r * a_r)
    con2d_p = np.zeros((A, A, 2, 2))
    con2d_p[..., 0, 0] = cscale * (1.0 + Y * Y)
    con2d_p[..., 0, 1] = cscale * X * Y
    con2d_p[..., 1, 0] = cscale * X * Y
    con2d_p[..., 1, 1] = cscale * (1.0 + X * X)
    vscale = a_r * a_r * (1.0 + X * X) * (1.0 + Y * Y) / (d2 * d2)
    cov2d_p = np.zeros((A, A, 2, 2))
    cov2d_p[..., 0, 0] = vscale * (1.0 + X * X)
    cov2d_p[..., 0, 1] = -vscale * X * Y
    cov2d_p[..., 1, 0] = -vscale * X * Y
    cov2d_p[..., 1, 1] = vscale * (1.0 + Y * Y)

    w2d = (w01[:, None] * w01[None, :])
    arow = np.tile(w2d.reshape(1, p, 1, p), (ne, 1, ne, 1)).reshape(A, A)
    area2d_p = jac2d_p * arow * delta * delta

    jac2d = np.broadcast_to(jac2d_p, (6, A, A))
    con2d = np.broadcast_to(con2d_p, (6, A, A, 2, 2))
    cov2d = np.broadcast_to(cov2d_p, (6, A, A, 2, 2))
    area2d = np.broadcast_to(area2d_p, (6, A, A))

    inv_mult = 1.0 / node_multiplicity(ne, p)

    # --- DSS connectivity ---
    links = _match_edges(ne, p)
    mats = _edge_cov_transforms(ne, p, links)
    edge_meta = tuple(
        (pa, e, *links[(pa, e)]) for pa in range(6) for e in range(4))
    corner_meta = tuple(c.nodes for c in _corner_links(ne, p))
    edge_mats = np.zeros((6, 4, A, 2, 2))
    for pa in range(6):
        for e in range(4):
            edge_mats[pa, e] = mats[(pa, e)]

    # --- topography ---
    if topography is None:
        topo = np.zeros((6, A, A))
    else:
        topo = np.asarray(topography(lon, lat), dtype=np.float64)
    # Derivatives of topography: element-local SE derivative, then DSS
    # averaging WITH the covariant vector transform across panel edges —
    # the reference's DataType_TopographyDeriv exchange
    # (``GridCSGLL.cpp:458-560`` + ``TransformTopographyDeriv``,
    # ``GridPatchCSGLL.cpp:1928``).  Without it the terrain metric is
    # discontinuous at element/panel boundaries at truncation level
    # (measured: 1-step JW parity improves W from ~2e-1 to roundoff).
    dtopo = np.zeros((6, A, A, 2))
    # axes: (panel, elemA, nodeA, elemB, nodeB); deriv at node i = sum_s f[s] D[s, i]
    topo_e = topo.reshape(6, ne, p, ne, p)
    dtopo[..., 0] = np.einsum("Pasbt,si->Paibt", topo_e, D).reshape(6, A, A) / delta
    dtopo[..., 1] = np.einsum("Pasbt,ti->Pasbi", topo_e, D).reshape(6, A, A) / delta
    dtopo[..., 0], dtopo[..., 1] = _dss_vector_np(
        dtopo[..., 0], dtopo[..., 1], edge_meta, edge_mats,
        inv_mult, p)

    # --- vertical coordinate + column operators ---
    # (reference GridGLL::InitializeVerticalCoordinate, GridGLL.cpp:470-550)
    if staggering == "INT":
        ops = co.build_column_ops_interfaces(nz, vertical_order, stretch)
    elif vdisc == "FV":
        ops = co.build_column_ops_fv(nz, vertical_order, stretch)
    else:
        ops = co.build_column_ops(nz, vertical_order, stretch)
    reta_lev, reta_int = ops.reta_lev, ops.reta_int
    w_lev, w_int = ops.na_lev, ops.na_int

    zs = topo[..., None]
    z_lev = np.broadcast_to(zs + (ztop - zs) * reta_lev, (6, A, A, nz)).copy()
    z_int = np.broadcast_to(zs + (ztop - zs) * reta_int,
                            (6, A, A, nz + 1)).copy()

    # Gal-Chen derivatives (reference GridPatchCSGLL.cpp:440-466):
    # dDaR = (1 - reta) dZs/da ; dDxR = ztop - Zs
    da_zs = dtopo[..., 0:1]
    db_zs = dtopo[..., 1:2]
    dxr = (ztop - zs)   # (6, A, A, 1)

    def vert_metric(reta):
        nk = len(reta)
        daR = (1.0 - reta) * da_zs
        dbR = (1.0 - reta) * db_zs
        dxR = np.broadcast_to(dxr, daR.shape)
        jac = dxR * (jac2d[..., None] / 1.0)
        cs = cscale[None, ..., None]
        con_a_xi = -cs / dxR * ((1.0 + Y * Y)[None, ..., None] * daR
                                + (X * Y)[None, ..., None] * dbR)
        con_b_xi = -cs / dxR * ((X * Y)[None, ..., None] * daR
                                + (1.0 + X * X)[None, ..., None] * dbR)
        con_xi_xi = (1.0 / (dxR * dxR)
                     - (con_a_xi * daR + con_b_xi * dbR) / dxR)
        deriv_r = np.stack([daR, dbR, dxR], axis=-1)
        return jac, con_a_xi, con_b_xi, con_xi_xi, deriv_r

    jac3d, con_a_xi, con_b_xi, con_xi_xi, deriv_r = vert_metric(reta_lev)
    (jac3d_int, con_a_xi_int, con_b_xi_int,
     con_xi_xi_int, deriv_r_int) = vert_metric(reta_int)

    area3d = jac3d * (arow * delta * delta)[None, ..., None] * w_lev
    area3d_int = jac3d_int * (arow * delta * delta)[None, ..., None] * w_int

    cast = lambda x: jnp.asarray(x, dtype=dtype)
    return CubedSphereGeometry(
        ne=ne, p=p, nz=nz, vo=ops.vo,
        edge_meta=edge_meta, corner_meta=corner_meta,
        gll_w=cast(w01), deriv=cast(D), stiff=cast(S), interp_gl=cast(interp_gl),
        alpha=cast(alpha), lon=cast(lon), lat=cast(lat),
        coriolis=cast(coriolis), jac2d=cast(jac2d), con2d=cast(con2d),
        cov2d=cast(cov2d), area2d=cast(area2d), inv_mult=cast(inv_mult),
        edge_mats=cast(edge_mats), delta=float(delta),
        topo=cast(topo), dtopo=cast(dtopo),
        jac3d=cast(jac3d), jac3d_int=cast(jac3d_int),
        deriv_r=cast(deriv_r), deriv_r_int=cast(deriv_r_int),
        con_a_xi=cast(con_a_xi), con_b_xi=cast(con_b_xi),
        con_xi_xi=cast(con_xi_xi),
        con_a_xi_int=cast(con_a_xi_int), con_b_xi_int=cast(con_b_xi_int),
        con_xi_xi_int=cast(con_xi_xi_int),
        area3d=cast(area3d), area3d_int=cast(area3d_int),
        z_lev=cast(z_lev), z_int=cast(z_int),
        rayleigh_lev=cast(rayleigh(z_lev) if rayleigh is not None
                          else np.zeros(jac3d.shape)),
        rayleigh_int=cast(rayleigh(z_int) if rayleigh is not None
                          else np.zeros(jac3d_int.shape)),
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
    )
