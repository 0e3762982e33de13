"""Z-first engine: geometry, DSS, tendencies, Strang driver.

Semantics are a one-to-one port of the reference-layout engine
(``models/nonhydro.py`` horizontal/vertical dynamics,
``models/hyperdiff.py`` nu4 tail, ``parallel/dss.py`` DSS,
``timestep/strang.py`` driver) — citations to the C++ reference live
there.  What changes here is the execution shape:

  state dict {U,V,Rt,W,Rho} of (6, A, B, nz[+1])
    ->  fast state dict of (nz[+1], 6, A, B)   ("z-first")

so that vertical column operators are clean leading-axis GEMMs,
horizontal derivatives are dense block-diagonal (A, A) GEMMs over the
whole field, DSS is a few fused elementwise passes per field
(``fast/dss``), and every RK combination fuses into full-field
elementwise kernels.  The only hand-written kernel on the path is the
batched banded solve of the implicit step (``backend.banded_solve``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from ..config import ModelConfig, GridKind, VerticalStaggering
from ..constants import PhysicalConstants
from ..grid.geometry import CubedSphereGeometry
from ..models import nonhydro
from ..timestep.explicit import ExplicitSubScheme
from ..utils.jit import hoisted_jit
from . import dss as fdss

FIELDS = ("U", "V", "Rt", "Rho", "W")


def pack_state(state):
    """Reference layout (6,A,B,nz[+1]) -> z-first (nz[+1],6,A,B).

    Tracers (ntr, 6, A, B, nz) become ONE flat species-major field
    (ntr*nz, 6, A, B) so per-stage DSS/updates are single launches."""
    out = {k: jnp.moveaxis(jnp.asarray(state[k]), -1, 0) for k in FIELDS}
    if "Tracers" in state:
        tr = jnp.asarray(state["Tracers"])
        ntr, P, A, B, nz = tr.shape
        out["Tracers"] = jnp.moveaxis(tr, -1, 1).reshape(ntr * nz, P, A, B)
    return out


def unpack_state(d, nz: int = None):
    """Z-first fast state -> reference-layout state dict."""
    out = {k: jnp.moveaxis(d[k], 0, -1) for k in FIELDS}
    if "Tracers" in d:
        t = d["Tracers"]
        nzz = d["Rt"].shape[0]
        ntr = t.shape[0] // nzz
        out["Tracers"] = jnp.moveaxis(
            t.reshape((ntr, nzz) + t.shape[1:]), 1, -1)
    return out


def tree_map(f, *trees):
    return {k: f(*(t[k] for t in trees)) for k in trees[0]}


# ---------------------------------------------------------------------------
# Fast geometry (host-precomputed, z-first layout)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FastGeometry:
    """Precomputed arrays for the z-first engine (plain object; closed
    over by the step, which ``utils.jit.hoisted_jit`` compiles with the
    arrays as arguments)."""
    nz: int
    p: int
    ne: int
    A: int
    vo: int
    is_xz: bool
    delta: float
    reference_length: float
    dss_links: tuple     # (panel, edge, nbr_panel, nbr_edge, flip) x 24
    # dense (A, A) horizontal operators along the first (a) axis
    DA: Any          # strong derivative: out_i = sum_s DA[i,s] f_s
    Sd: Any          # stiffness/delta:   weak_div = -(Sd@fa + fb@Sd^T)
    DA_elem: Any     # (p, p) raw GLL derivative matrix D[s, i]
    S_elem: Any      # (p, p) raw stiffness matrix S[i, s]
    # vertical column operators (same matrices as CubedSphereGeometry)
    interp_n2i: Any
    interp_i2n: Any
    diff_n2n: Any
    diff_n2i: Any
    diff_i2n: Any
    diff_i2i: Any
    diffdiff_i2i: Any
    penalty_left: Any
    penalty_right: Any
    wscat_left: Any
    wscat_right: Any
    # metric terms, z-first
    c2_aa: Any       # (6, A, B)
    c2_ab: Any
    c2_ba: Any
    c2_bb: Any
    jac2d: Any       # (6, A, B)
    fj: Any          # coriolis * jac2d (6, A, B)
    inv_mult: Any    # (6, A, B)
    jac3d: Any       # (nz, 6, A, B)
    jac3d_int: Any   # (nz+1, 6, A, B)
    con_a_xi: Any    # (nz, 6, A, B)
    con_b_xi: Any
    con_xi_xi: Any
    con_a_xi_int: Any    # (nz+1, 6, A, B)
    con_b_xi_int: Any
    con_xi_xi_int: Any
    deriv_r_a: Any   # (nz, 6, A, B)   dDaR on levels
    deriv_r_b: Any
    deriv_r_xi_int: Any  # (nz+1, 6, A, B) dDxR on interfaces
    rayleigh_lev: Any
    rayleigh_int: Any
    e_rot: Any       # (4, 24, A): [r00, r01, r10, r11] covariant transform
    area3d: Any = None   # (nz, 6, A, B) z-first (tracer positivity filters)
    # (B, B) operators along the second (b) axis — equal to DA/Sd on a
    # square block; they differ when the engine runs on a rectangular
    # per-device block of a sharded mesh (A, B are then LOCAL extents)
    B: int = 0
    DA_b: Any = None
    Sd_b: Any = None
    # stacked [interp_n2i; diff_n2i]: the implicit prep reads U/V once
    # for both operators
    n2i_stack: Any = None         # (2*(nz+1), nz)
    # grid family: 6 cubed-sphere panels with edge links, or 1 Cartesian
    # panel with per-axis periodic wrap-sums in the DSS
    npanels: int = 6
    wrap: tuple = (False, False)
    # xz slice: which ENGINE velocity slot carries the physical V whose
    # tendency is identically zero ("V" natural, "U" when ab_swapped)
    xz_zero: str = None
    # Cartesian grids with a short y extent run TRANSPOSED (x on the
    # minor, contiguous axis): engine (a, b) = physical (y, x), engine U/V =
    # physical V/U, fj negated — an exact relabeling of the equations
    # (orientation flip).  pack/unpack swap at the step boundary.
    ab_swapped: bool = False
    # hyperviscosity local scale always uses the physical delta_a
    # (reference nu_local_scale), which differs from the engine's
    # first-axis element width when ab_swapped
    nu_delta: float = None


def build_fast_geometry(geom: CubedSphereGeometry,
                        dtype=jnp.float32) -> FastGeometry:
    nz, p, ne = geom.nz, geom.p, geom.ne
    A = ne * p
    f64 = np.float64

    D = np.asarray(geom.deriv, f64)
    S = np.asarray(geom.stiff, f64)
    delta = float(geom.delta)
    DA = np.kron(np.eye(ne), D.T) / delta
    Sd = np.kron(np.eye(ne), S) / delta

    def zf(a):
        return jnp.asarray(np.moveaxis(np.asarray(a, f64), -1, 0), dtype)

    def c(a):
        return jnp.asarray(np.asarray(a, f64), dtype)

    n_edges = len(geom.edge_meta)
    e_rot = np.zeros((4, n_edges, A), f64)
    mats = np.asarray(geom.edge_mats, f64)          # (6, 4, A, 2, 2)
    for i, (pa, e, qa, qe, flip) in enumerate(geom.edge_meta):
        M = mats[pa, e]                              # (A, 2, 2)
        e_rot[0, i] = M[:, 0, 0]
        e_rot[1, i] = M[:, 0, 1]
        e_rot[2, i] = M[:, 1, 0]
        e_rot[3, i] = M[:, 1, 1]

    con2d = np.asarray(geom.con2d, f64)
    cor = np.asarray(geom.coriolis, f64)
    j2 = np.asarray(geom.jac2d, f64)

    n2i_stack = np.concatenate([np.asarray(geom.interp_n2i, f64),
                                np.asarray(geom.diff_n2i, f64)], axis=0)

    return FastGeometry(
        n2i_stack=c(n2i_stack),
        nz=nz, p=p, ne=ne, A=A, B=A, vo=geom.vo, is_xz=False, delta=delta,
        reference_length=float(geom.reference_length),
        dss_links=tuple(geom.edge_meta),
        DA=c(DA), Sd=c(Sd), DA_b=c(DA), Sd_b=c(Sd), DA_elem=D, S_elem=S,
        interp_n2i=c(geom.interp_n2i), interp_i2n=c(geom.interp_i2n),
        diff_n2n=c(geom.diff_n2n), diff_n2i=c(geom.diff_n2i),
        diff_i2n=c(geom.diff_i2n), diff_i2i=c(geom.diff_i2i),
        diffdiff_i2i=c(geom.diffdiff_i2i),
        penalty_left=(None if geom.penalty_left is None
                      else c(geom.penalty_left)),
        penalty_right=(None if geom.penalty_right is None
                       else c(geom.penalty_right)),
        wscat_left=(None if geom.wscat_left is None
                    else c(geom.wscat_left)),
        wscat_right=(None if geom.wscat_right is None
                     else c(geom.wscat_right)),
        c2_aa=c(con2d[..., 0, 0]), c2_ab=c(con2d[..., 0, 1]),
        c2_ba=c(con2d[..., 1, 0]), c2_bb=c(con2d[..., 1, 1]),
        jac2d=c(j2), fj=c(cor * j2),
        inv_mult=c(geom.inv_mult),
        jac3d=zf(geom.jac3d), jac3d_int=zf(geom.jac3d_int),
        con_a_xi=zf(geom.con_a_xi), con_b_xi=zf(geom.con_b_xi),
        con_xi_xi=zf(geom.con_xi_xi),
        con_a_xi_int=zf(geom.con_a_xi_int),
        con_b_xi_int=zf(geom.con_b_xi_int),
        con_xi_xi_int=zf(geom.con_xi_xi_int),
        area3d=zf(geom.area3d),
        deriv_r_a=zf(np.asarray(geom.deriv_r, f64)[..., 0]),
        deriv_r_b=zf(np.asarray(geom.deriv_r, f64)[..., 1]),
        deriv_r_xi_int=zf(np.asarray(geom.deriv_r_int, f64)[..., 2]),
        rayleigh_lev=zf(geom.rayleigh_lev),
        rayleigh_int=zf(geom.rayleigh_int),
        e_rot=c(e_rot),
    )


def _swap_ab_state(d):
    """(a, b)-transpose a z-first state dict and relabel U <-> V (an
    involution).  Together with ``fj -> -fj`` this is an EXACT
    relabeling of the equations (orientation flip): the engine runs in
    (b, a) coordinates so the long Cartesian x axis is the minor,
    contiguous axis (the natural (..., A, 4) xz layout would put a
    4-wide axis there)."""
    m = {"U": "V", "V": "U"}
    return {m.get(k, k): jnp.swapaxes(v, -2, -1) for k, v in d.items()}


def build_fast_geometry_cartesian(geom, dtype=jnp.float32,
                                  swap_ab=None) -> FastGeometry:
    """FastGeometry from a ``CartesianGeometry`` (xz slice or 3-D plane).

    One panel, no edge links: the DSS runs pure pair-sums with
    per-axis periodic wrap (``fast/dss._pair_masks(wrap=True)``), the
    analog of ``GridCartesianGLL::ApplyDSS`` periodic averaging
    (``/root/reference/src/atm/GridCartesianGLL.cpp:600-660``).  Only
    periodic lateral BCs are supported here — no-flux configs keep the
    reference-layout engine (their lagged-halo semantics thread a shadow
    state through the RK combinations).

    ``swap_ab`` (default: auto when the y extent is much shorter than
    x): run the engine transposed — see ``_swap_ab_state``."""
    nz, p = geom.nz, geom.p
    f64 = np.float64
    if swap_ab is None:
        swap_ab = geom.ney * p < geom.nex * p and geom.ney * p < 32

    D = np.asarray(geom.deriv, f64)
    S = np.asarray(geom.stiff, f64)
    if swap_ab:
        ne_a, ne_b = geom.ney, geom.nex
        d_a, d_b = geom.delta_b, geom.delta_a
        wrap = (geom.bc_y == "periodic", geom.bc_x == "periodic")
        fj_sign = -1.0
    else:
        ne_a, ne_b = geom.nex, geom.ney
        d_a, d_b = geom.delta_a, geom.delta_b
        wrap = (geom.bc_x == "periodic", geom.bc_y == "periodic")
        fj_sign = 1.0
    A = ne_a * p
    B = ne_b * p

    def zf(a):
        """(1, A, B, nz) -> z-first (nz, 1, A, B), (a, b)-transposed
        when swapped."""
        out = np.moveaxis(np.asarray(a, f64), -1, 0)
        if swap_ab:
            out = np.swapaxes(out, 2, 3)
        return jnp.asarray(out, dtype)

    def c2d(a):
        out = np.asarray(a, f64)
        if swap_ab:
            out = np.swapaxes(out, 1, 2)
        return jnp.asarray(out, dtype)

    def c(a):
        return jnp.asarray(np.asarray(a, f64), dtype)

    con2d = np.asarray(geom.con2d, f64)
    cor = np.asarray(geom.coriolis, f64)
    j2 = np.asarray(geom.jac2d, f64)
    n2i_stack = np.concatenate([np.asarray(geom.interp_n2i, f64),
                                np.asarray(geom.diff_n2i, f64)], axis=0)
    dra = np.asarray(geom.deriv_r, f64)[..., 0]
    drb = np.asarray(geom.deriv_r, f64)[..., 1]
    if swap_ab:
        c2aa, c2bb = con2d[..., 1, 1], con2d[..., 0, 0]
        c2ab, c2ba = con2d[..., 1, 0], con2d[..., 0, 1]
        caxi, cbxi = geom.con_b_xi, geom.con_a_xi
        caxi_i, cbxi_i = geom.con_b_xi_int, geom.con_a_xi_int
        dra, drb = drb, dra
    else:
        c2aa, c2bb = con2d[..., 0, 0], con2d[..., 1, 1]
        c2ab, c2ba = con2d[..., 0, 1], con2d[..., 1, 0]
        caxi, cbxi = geom.con_a_xi, geom.con_b_xi
        caxi_i, cbxi_i = geom.con_a_xi_int, geom.con_b_xi_int

    return FastGeometry(
        n2i_stack=c(n2i_stack),
        nz=nz, p=p, ne=ne_a, A=A, B=B, vo=geom.vo,
        is_xz=bool(geom.is_xz), delta=float(d_a),
        nu_delta=float(geom.delta_a),
        reference_length=float(geom.reference_length),
        npanels=1, wrap=wrap, ab_swapped=bool(swap_ab),
        xz_zero=(("U" if swap_ab else "V") if geom.is_xz else None),
        dss_links=(),
        DA=c(np.kron(np.eye(ne_a), D.T) / d_a),
        Sd=c(np.kron(np.eye(ne_a), S) / d_a),
        DA_b=c(np.kron(np.eye(ne_b), D.T) / d_b),
        Sd_b=c(np.kron(np.eye(ne_b), S) / d_b),
        DA_elem=D, S_elem=S,
        interp_n2i=c(geom.interp_n2i), interp_i2n=c(geom.interp_i2n),
        diff_n2n=c(geom.diff_n2n), diff_n2i=c(geom.diff_n2i),
        diff_i2n=c(geom.diff_i2n), diff_i2i=c(geom.diff_i2i),
        diffdiff_i2i=c(geom.diffdiff_i2i),
        penalty_left=(None if geom.penalty_left is None
                      else c(geom.penalty_left)),
        penalty_right=(None if geom.penalty_right is None
                       else c(geom.penalty_right)),
        wscat_left=(None if geom.wscat_left is None
                    else c(geom.wscat_left)),
        wscat_right=(None if geom.wscat_right is None
                     else c(geom.wscat_right)),
        c2_aa=c2d(c2aa), c2_ab=c2d(c2ab),
        c2_ba=c2d(c2ba), c2_bb=c2d(c2bb),
        jac2d=c2d(j2), fj=c2d(fj_sign * cor * j2),
        inv_mult=c2d(geom.inv_mult),
        jac3d=zf(geom.jac3d), jac3d_int=zf(geom.jac3d_int),
        con_a_xi=zf(caxi), con_b_xi=zf(cbxi),
        con_xi_xi=zf(geom.con_xi_xi),
        con_a_xi_int=zf(caxi_i),
        con_b_xi_int=zf(cbxi_i),
        con_xi_xi_int=zf(geom.con_xi_xi_int),
        area3d=zf(geom.area3d),
        deriv_r_a=zf(dra),
        deriv_r_b=zf(drb),
        deriv_r_xi_int=zf(np.asarray(geom.deriv_r_int, f64)[..., 2]),
        rayleigh_lev=zf(geom.rayleigh_lev),
        rayleigh_int=zf(geom.rayleigh_int),
        # no panel links -> the rotation table is never indexed; a
        # 1-entry dummy keeps every array dimension nonzero
        e_rot=c(np.zeros((4, 1, A))),
    )


# ---------------------------------------------------------------------------
# Horizontal operators (dense (A, A), z-batched)
# ---------------------------------------------------------------------------

def hderiv_a(f, fg: FastGeometry):
    return jnp.einsum("is,cpsb->cpib", fg.DA, f)


def hderiv_b(f, fg: FastGeometry):
    return jnp.einsum("cpas,is->cpai", f, fg.DA_b)


def hweak_div(fa, fb, fg: FastGeometry):
    """Variational divergence (positive = divergence), sem.weak_div port."""
    wa = jnp.einsum("is,cpsb->cpib", fg.Sd, fa)
    wb = jnp.einsum("cpas,is->cpai", fb, fg.Sd_b)
    return -(wa + wb)


def hweak_grad(f, fg: FastGeometry):
    """(-Sd @ f, -f @ Sd^T): weak gradients along a and b."""
    return (-jnp.einsum("is,cpsb->cpib", fg.Sd, f),
            -jnp.einsum("cpas,is->cpai", f, fg.Sd_b))


def colop(M, f):
    """Vertical column operator over the leading z axis (one dot, no
    explicit flatten of the field)."""
    return jnp.einsum("KL,L...->K...", M, f)


# ---------------------------------------------------------------------------
# DSS (plain JAX; see fast/dss.py)
# ---------------------------------------------------------------------------

def apply_dss(d, fg: FastGeometry, rayleigh=None):
    """DSS of the full fast state (U/V rotate as a covariant pair), then
    the optional Rayleigh finish.  All tracer species DSS as one flat
    scalar field; tracers are never Rayleigh-damped (reference
    ApplyRayleighFriction)."""
    u, v = fdss.dss_vector(d["U"], d["V"], fg.inv_mult, fg.e_rot,
                           fg.dss_links, fg.p, wrap=fg.wrap)
    out = {"U": u, "V": v}
    for k in ("Rt", "Rho", "W"):
        out[k] = fdss.dss_scalar(d[k], fg.inv_mult, fg.dss_links, fg.p,
                                 wrap=fg.wrap)
    if rayleigh is not None:
        out = apply_rayleigh(out, *rayleigh)
    if "Tracers" in d:
        out["Tracers"] = fdss.dss_scalar(
            d["Tracers"], fg.inv_mult, fg.dss_links, fg.p, wrap=fg.wrap)
    return out


# ---------------------------------------------------------------------------
# Nonhydrostatic tendencies (LOR staggering)
# ---------------------------------------------------------------------------

def horizontal_tendency(d, fg: FastGeometry, constants: PhysicalConstants):
    """Port of ``nonhydro.horizontal_tendency`` (LOR branch), with the
    vertical penalty upwinding of U/V
    (``nonhydro.vertical_explicit_increment``) folded into the U/V rows."""
    nz = fg.nz
    u, v = d["U"], d["V"]
    rt, rho, w = d["Rt"], d["Rho"], d["W"]

    w_n = colop(fg.interp_i2n, w)

    c_aa, c_ab = fg.c2_aa[None], fg.c2_ab[None]
    c_ba, c_bb = fg.c2_ba[None], fg.c2_bb[None]
    con_ua = c_aa * u + c_ab * v + fg.con_a_xi * w_n
    con_ub = c_ba * u + c_bb * v + fg.con_b_xi * w_n
    con_ux = fg.con_a_xi * u + fg.con_b_xi * v + fg.con_xi_xi * w_n

    ke = 0.5 * (con_ua * u + con_ub * v + con_ux * w_n)
    exner = nonhydro.exner_from_rhotheta(rt, constants)

    du_dxi = colop(fg.diff_n2n, u)
    dv_dxi = colop(fg.diff_n2n, v)

    dv_da = hderiv_a(v, fg)
    du_db = hderiv_b(u, fg)
    dwn_da = hderiv_a(w_n, fg)
    dwn_db = hderiv_b(w_n, fg)

    jzeta_a = dwn_db - dv_dxi
    jzeta_b = du_dxi - dwn_da
    jzeta_x = dv_da - du_db

    ucz_a = con_ub * jzeta_x - con_ux * jzeta_b
    ucz_b = con_ux * jzeta_a - con_ua * jzeta_x
    ucz_x = -con_ua * dwn_da - con_ub * dwn_db

    base_a = fg.jac3d * con_ua
    base_b = fg.jac3d * con_ub
    div_rho = hweak_div(base_a * rho, base_b * rho, fg)
    div_rt = hweak_div(base_a * rt, base_b * rt, fg)

    dke_a = hderiv_a(ke, fg)
    dke_b = hderiv_b(ke, fg)
    dpi_a = hderiv_a(exner, fg)
    dpi_b = hderiv_b(exner, fg)

    theta = rt / rho
    fj = fg.fj[None]

    dU = (ucz_a + fj * con_ub
          - (dpi_a * theta + dke_a + constants.g * fg.deriv_r_a))
    if fg.xz_zero == "V":
        # xz slice: no physical-V tendency (nonhydro.horizontal_tendency
        # is_xz branch); the explicit vertical penalty still applies
        dV = jnp.zeros_like(v)
    else:
        dV = (ucz_b - fj * con_ua
              - (dpi_b * theta + dke_b + constants.g * fg.deriv_r_b))
    if fg.xz_zero == "U":
        # ab-swapped xz: the ENGINE U slot is the physical V
        dU = jnp.zeros_like(u)
    dRho = -div_rho / fg.jac3d
    dRt = -div_rt / fg.jac3d

    dW = colop(fg.interp_n2i, ucz_x)
    dW = dW.at[0].set(0.0).at[-1].set(0.0)

    # --- vertical explicit penalty upwinding of U/V (per unit dt) --------
    u_i = colop(fg.interp_n2i, u)
    v_i = colop(fg.interp_n2i, v)
    xid = (fg.con_a_xi_int * u_i + fg.con_b_xi_int * v_i
           + fg.con_xi_xi_int * w)
    xid = xid.at[0].set(0.0).at[-1].set(0.0)
    vo = fg.vo
    if fg.penalty_left is not None and nz // vo > 1:
        wb = jnp.abs(xid[vo:nz:vo])                        # (nfe-1, ...)
        wl = colop(fg.wscat_left, wb)
        wr = colop(fg.wscat_right, wb)
        dU = dU + colop(fg.penalty_left, u) * wl \
            + colop(fg.penalty_right, u) * wr
        dV = dV + colop(fg.penalty_left, v) * wl \
            + colop(fg.penalty_right, v) * wr

    return {"U": dU, "V": dV, "Rt": dRt, "Rho": dRho, "W": dW}


def apply_w_boundary(d, fg: FastGeometry):
    """Diagnostic bottom W from u^xi(surface) = 0 (nonhydro.apply_w_boundary)."""
    u0 = colop(fg.interp_n2i[0:1], d["U"])[0]
    v0 = colop(fg.interp_n2i[0:1], d["V"])[0]
    w0 = -(fg.con_a_xi_int[0] * u0 + fg.con_b_xi_int[0] * v0) \
        / fg.con_xi_xi_int[0]
    return dict(d, W=d["W"].at[0].set(w0))


# ---------------------------------------------------------------------------
# Hyperdiffusion tail (nu4 / nu2), hyperdiff.step_after_subcycle_nh port
# ---------------------------------------------------------------------------

def scalar_laplacian(f, jac, fg: FastGeometry):
    da = hderiv_a(f, fg)
    db = hderiv_b(f, fg)
    c_aa, c_ab = fg.c2_aa[None], fg.c2_ab[None]
    c_ba, c_bb = fg.c2_ba[None], fg.c2_bb[None]
    ga = jac * (c_aa * da + c_ab * db)
    gb = jac * (c_ba * da + c_bb * db)
    return hweak_div(ga, gb, fg) / jac


def vector_hyperdiff_update(u, v, nu_div, nu_vort, fg: FastGeometry):
    c_aa, c_ab = fg.c2_aa[None], fg.c2_ab[None]
    c_ba, c_bb = fg.c2_ba[None], fg.c2_bb[None]
    j2 = fg.jac2d[None]
    con_u = c_aa * u + c_ab * v
    con_v = c_ba * u + c_bb * v
    div = (hderiv_a(j2 * con_u, fg) + hderiv_b(j2 * con_v, fg)) / j2
    curl = (hderiv_a(v, fg) - hderiv_b(u, fg)) / j2
    wda_div, wdb_div = hweak_grad(div, fg)
    wda_curl, wdb_curl = hweak_grad(curl, fg)
    du = nu_div * wda_div - nu_vort * j2 * (
        c_ba * wda_curl + c_bb * wdb_curl)
    dv = nu_div * wdb_div + nu_vort * j2 * (
        c_aa * wda_curl + c_ab * wdb_curl)
    return du, dv


def apply_rayleigh(d, fac, ref_term):
    """X <- fac * X + (1 - fac) * Xref with ref_term = (1 - fac) * Xref.
    fac has Rho rows = 1, so Rho is never damped."""
    return tree_map(lambda x, f, r: f * x + r, d, fac, ref_term)


def step_after_subcycle(d, dt, cfg: ModelConfig, fg: FastGeometry,
                        rayleigh=None, dss_fn=None):
    """nu4/nu2 hyperviscosity + DSS (+ optional Rayleigh) Strang tail.

    ``dss_fn(d, rayleigh=None)``: full-state DSS with the optional
    Rayleigh finish (the mesh engine passes its routed exchange)."""
    if dss_fn is None:
        dss_fn = lambda ds, rayleigh=None: apply_dss(ds, fg, rayleigh)
    has_tr = "Tracers" in d

    def finish(ds):
        # reference order: tracer positivity filter -> DSS -> Rayleigh
        # (hyperdiff.step_after_subcycle_nh finish)
        if has_tr:
            from . import tracers as ftr
            ds = dict(ds, Tracers=ftr.filter_horizontal(
                ds["Tracers"], fg))
        return dss_fn(ds, rayleigh=rayleigh)

    if not cfg.hyperdiffusion or (
            cfg.nu_scalar == 0 and cfg.nu_div == 0 and cfg.nu_vort == 0):
        out = d
        if has_tr:
            from . import tracers as ftr
            out = dict(out, Tracers=ftr.filter_horizontal(
                out["Tracers"], fg))
        if rayleigh is not None:
            out = dict(out, **apply_rayleigh(
                {k: out[k] for k in FIELDS}, *rayleigh))
        return out

    scale = ((fg.nu_delta if fg.nu_delta is not None else fg.delta)
             / fg.reference_length) ** 3.2 \
        if cfg.hypervis_order == 4 else 1.0
    nu_s = cfg.nu_scalar * scale
    nu_d = cfg.nu_div * scale
    nu_v = cfg.nu_vort * scale

    if cfg.hypervis_order == 2:
        du, dv = vector_hyperdiff_update(
            d["U"], d["V"], cfg.nu_div, cfg.nu_vort, fg)
        out = {
            "U": d["U"] - dt * du, "V": d["V"] - dt * dv,
            "Rt": d["Rt"] + dt * nu_s * scalar_laplacian(
                d["Rt"], fg.jac3d, fg),
            "Rho": d["Rho"] + dt * nu_s * scalar_laplacian(
                d["Rho"], fg.jac3d, fg),
            "W": d["W"] + dt * nu_s * scalar_laplacian(
                d["W"], fg.jac3d_int, fg),
        }
        if has_tr:
            from . import tracers as ftr
            out["Tracers"] = d["Tracers"] + dt * nu_s * \
                ftr.scalar_laplacian_tr(d["Tracers"], fg)
        return finish(out)

    # order 4: Lap pass -> DSS -> -dt * nu_local * Lap pass -> DSS
    wu, wv = vector_hyperdiff_update(d["U"], d["V"], 1.0, 1.0, fg)
    work = {
        "U": -wu, "V": -wv,
        "Rt": scalar_laplacian(d["Rt"], fg.jac3d, fg),
        "Rho": scalar_laplacian(d["Rho"], fg.jac3d, fg),
        "W": scalar_laplacian(d["W"], fg.jac3d_int, fg),
    }
    if has_tr:
        from . import tracers as ftr
        work["Tracers"] = ftr.scalar_laplacian_tr(d["Tracers"], fg)
    work = dss_fn(work)

    du, dv = vector_hyperdiff_update(work["U"], work["V"], nu_d, nu_v, fg)
    out = {
        "U": d["U"] + dt * du, "V": d["V"] + dt * dv,
        "Rt": d["Rt"] - dt * nu_s * scalar_laplacian(
            work["Rt"], fg.jac3d, fg),
        "Rho": d["Rho"] - dt * nu_s * scalar_laplacian(
            work["Rho"], fg.jac3d, fg),
        "W": d["W"] - dt * nu_s * scalar_laplacian(
            work["W"], fg.jac3d_int, fg),
    }
    if has_tr:
        out["Tracers"] = d["Tracers"] - dt * nu_s * \
            ftr.scalar_laplacian_tr(work["Tracers"], fg)
    return finish(out)


# ---------------------------------------------------------------------------
# Strang-HEVI driver
# ---------------------------------------------------------------------------

def fast_engine_supported(cfg: ModelConfig, has_tracers: bool = False,
                          mesh=None, geom=None) -> bool:
    """The configurations the z-first engine covers.

    Grids: the cubed sphere (with optional device mesh), and the
    Cartesian grids (xz slice / 3-D plane) with PERIODIC lateral BCs —
    pass ``geom`` so the boundary conditions can be checked; no-flux
    configs keep the reference-layout engine (lagged-halo shadow state).
    """
    from ..config import TimestepSchemeType
    if cfg.grid_kind == GridKind.CUBED_SPHERE:
        grid_ok = True
    elif cfg.grid_kind in (GridKind.CARTESIAN_XZ, GridKind.CARTESIAN_3D):
        grid_ok = (geom is not None and mesh is None
                   and getattr(geom, "bc_x", None) == "periodic"
                   and getattr(geom, "bc_y", None) == "periodic")
    else:
        grid_ok = False
    ok = (grid_ok
          and cfg.vertical_staggering == VerticalStaggering.LORENZ
          and cfg.timescheme == TimestepSchemeType.STRANG
          and not cfg.explicit_vertical
          and cfg.vertical_solver == "banded"
          and cfg.nu_uniform_scalar == 0.0
          and cfg.nu_uniform_vector == 0.0
          and cfg.upwind_thermo)
    if ok and mesh is not None:
        A = cfg.ne * cfg.order
        try:
            mx, my = mesh.shape["x"], mesh.shape["y"]
        except (KeyError, AttributeError):
            return False
        ok = (A % mx == 0 and A % my == 0
              and (A // mx) % cfg.order == 0 and (A // my) % cfg.order == 0)
    return ok


def _rayleigh_terms(cfg: ModelConfig, geom, ref_state, fg=None):
    """(fac, ref_term) z-first damping tensors, or None (host precompute;
    the reference's 10-cycle implicit Rayleigh factor).  ``fg``: the
    engine geometry — drives the xz V exemption (the engine slot named
    by ``fg.xz_zero`` holds the physical V, never damped) and the
    (a, b)-transposed layout of swapped Cartesian engines."""
    if not (cfg.rayleigh_damping and ref_state is not None):
        return None
    n_cycles = 10
    dt = cfg.dt
    swapped = fg is not None and fg.ab_swapped
    xz_zero = fg.xz_zero if fg is not None else None

    def fac_of(r):
        f = (1.0 / (1.0 + dt * np.asarray(r, np.float64)
                    / n_cycles)) ** n_cycles
        f = np.moveaxis(f, -1, 0)
        return np.swapaxes(f, 2, 3) if swapped else f

    fac_lev = fac_of(geom.rayleigh_lev)
    fac_int = fac_of(geom.rayleigh_int)
    fac = {"U": fac_lev, "V": fac_lev, "Rt": fac_lev,
           "Rho": np.ones_like(fac_lev), "W": fac_int}
    if xz_zero is not None:
        fac[xz_zero] = np.ones_like(fac_lev)   # physical V: never damped
    fac = {k: jnp.asarray(v, cfg.dtype) for k, v in fac.items()}
    ref_zf = pack_state({k: jnp.asarray(np.asarray(v), cfg.dtype)
                         for k, v in ref_state.items()})
    if swapped:
        ref_zf = _swap_ab_state(ref_zf)
    ref_term = tree_map(lambda f, r: (1.0 - f) * r, fac, ref_zf)
    return (fac, ref_term)


def _strang_fns(cfg: ModelConfig, fg: FastGeometry, rayleigh, dss_fn,
                implicit_fn):
    """The Strang-HEVI step on z-first state, parameterized over the DSS
    and implicit-solve implementations so the single-device and
    shard_map-distributed engines share one driver.

    Returns unjitted (first_fn, step_fn): first_fn(d) -> (d, carry),
    step_fn(d, carry) -> (d, carry).
    """
    constants = cfg.constants
    dt = cfg.dt
    oc = cfg.off_centering

    def axpy(base, tend, dt_s):
        return tree_map(lambda b, t: b + dt_s * t, base, tend)

    def comb(*coeff_states):
        coeffs, states = zip(*coeff_states)
        return tree_map(
            lambda *xs: sum(c * x for c, x in zip(coeffs, xs)), *states)

    def stage(base, ueval, dt_s):
        """base: state dict or 2-term ((c1, d1), (c2, d2)) combination."""
        bb = comb(*base) if isinstance(base, tuple) else base
        tend = horizontal_tendency(ueval, fg, constants)
        upd = axpy({k: bb[k] for k in FIELDS}, tend, dt_s)
        upd = apply_w_boundary(upd, fg)
        if "Tracers" in ueval:
            from . import tracers as ftr
            base_tr = (tuple((c, b["Tracers"]) for c, b in base)
                       if isinstance(base, tuple) else base["Tracers"])
            upd["Tracers"] = ftr.horizontal_update(base_tr, ueval, dt_s, fg)
        return dss_fn(upd)

    def erk(X0):
        scheme = cfg.explicit_scheme
        if scheme == ExplicitSubScheme.FORWARD_EULER:
            return stage(X0, X0, dt)
        if scheme == ExplicitSubScheme.RK4:
            u1 = stage(X0, X0, 0.5 * dt)
            u2 = stage(X0, u1, 0.5 * dt)
            u3 = stage(X0, u2, dt)
            base = comb((-1.0 / 3.0, X0), (1.0 / 3.0, u1),
                        (2.0 / 3.0, u2), (1.0 / 3.0, u3))
            return stage(base, u3, dt / 6.0)
        if scheme == ExplicitSubScheme.SSPRK3:
            u1 = stage(X0, X0, dt)
            u2 = stage(((0.75, X0), (0.25, u1)), u1, 0.25 * dt)
            return stage(((1.0 / 3.0, X0), (2.0 / 3.0, u2)),
                         u2, 2.0 * dt / 3.0)
        if scheme == ExplicitSubScheme.KGU35:
            u1 = stage(X0, X0, dt / 5.0)
            u2 = stage(X0, u1, dt / 5.0)
            u3 = stage(X0, u2, dt / 3.0)
            u2b = stage(X0, u3, 2.0 * dt / 3.0)
            return stage(((-0.25, X0), (1.25, u1)), u2b, 0.75 * dt)
        if scheme == ExplicitSubScheme.SSPRK53:
            c1 = 0.377268915331368
            c3 = 0.242995220537396
            c4 = 0.238458932846290
            c5 = 0.287632146308408
            u1 = stage(X0, X0, c1 * dt)
            u2 = stage(u1, u1, c1 * dt)
            u3 = stage(((0.355909775063327, X0),
                        (0.644090224936674, u2)), u2, c3 * dt)
            u0b = stage(((0.367933791638137, X0),
                         (0.632066208361863, u3)), u3, c4 * dt)
            return stage(((0.762406163401431, u0b),
                          (0.237593836598569, u2)), u0b, c5 * dt)
        raise ValueError(f"unsupported explicit scheme {scheme}")

    def tail(X):
        u4 = erk(X)
        u1 = step_after_subcycle(u4, dt, cfg, fg, rayleigh=rayleigh,
                                 dss_fn=dss_fn)
        u0 = implicit_fn(u1, 0.5 * (1.0 + oc) * dt)
        if oc != 0.0:
            u0 = comb((0.5 * (2.0 - oc), u0), (0.5 * oc, u1))
        # the LOR implicit solve only updates (Rt, W, Rho) [+ Tracers];
        # U and V pass through unchanged, so the Strang carryover is
        # identically zero there — carry only the updated fields (the
        # reference carries 5 instance buffers; two are provably no-ops)
        ck = ("Rt", "W", "Rho") + (("Tracers",) if "Tracers" in u0
                                   else ())
        carry = {k: u0[k] - u1[k] for k in ck}
        return u0, carry

    def first_fn(d):
        return tail(implicit_fn(d, 0.5 * dt))

    def step_fn(d, carry):
        X0 = dict(d)
        for k in carry:
            X0[k] = d[k] + carry[k]
        if "Tracers" in X0:
            from . import tracers as ftr
            X0["Tracers"] = ftr.filter_column(X0["Tracers"], fg)
        return tail(X0)

    return first_fn, step_fn


def make_fast_step(cfg: ModelConfig, geom: CubedSphereGeometry,
                   ref_state=None, mesh=None, ntracers: int = 0,
                   solver=None):
    """(first_step, step) on the fast state: step(d, carry) -> (d, carry).

    Drop-in semantics of ``timestep/strang.make_strang_step`` for the
    supported configuration subset (``fast_engine_supported``).

    ``mesh``: optional ``jax.sharding.Mesh`` with axes ("x", "y") — the
    SAME z-first engine runs per-shard inside one ``shard_map``, with the
    statically-routed ppermute DSS of ``fast/mesh_dss.py`` as the only
    communication (the distributed analog of the reference's one hot
    loop being its distributed loop, ``HorizontalDynamicsFEM.cpp:701`` +
    ``Connectivity.cpp:928``).

    ``solver``: the banded-solve implementation of the single-device
    engine (``backend.banded_solve``; default by platform).
    """
    if mesh is not None:
        return _make_fast_step_mesh(cfg, geom, ref_state, mesh,
                                    ntracers=ntracers)

    from . import implicit as fimp

    constants = cfg.constants
    if hasattr(geom, "nex"):          # CartesianGeometry
        fg = build_fast_geometry_cartesian(geom, dtype=cfg.dtype)
    else:
        fg = build_fast_geometry(geom, dtype=cfg.dtype)

    q = nonhydro.estimate_bandwidth(geom, constants)
    statics = nonhydro.band_assembly_statics(geom, q)
    rayleigh = _rayleigh_terms(cfg, geom, ref_state, fg=fg)
    saux = fimp.static_aux(fg)

    def implicit_fn(d, dti):
        out = fimp.vertical_implicit(
            d, fg, constants, dti, q, statics,
            newton_iters=cfg.newton_iterations,
            ref_jacobian=(cfg.jacobian_mode == "reference"), saux=saux,
            solver=solver)
        if "Tracers" in d:
            from . import tracers as ftr
            if not hasattr(implicit_fn, "_tr_statics"):
                implicit_fn._tr_statics = ftr._tracer_band_statics(fg)
            tr = ftr.update_column_tracers(
                d, out["W"], fg, dti, statics=implicit_fn._tr_statics,
                solver=solver)
            out = dict(out, Tracers=ftr.filter_column(tr, fg))
        return out

    first_fn, step_fn = _strang_fns(
        cfg, fg, rayleigh,
        lambda d, rayleigh=None: apply_dss(d, fg, rayleigh), implicit_fn)
    if fg.ab_swapped:
        # the engine runs (a, b)-transposed with U/V relabeled; the
        # public step signature keeps the natural packed layout — swap
        # at the boundary (the carry stays in engine layout, opaque to
        # callers).  See _swap_ab_state.
        inner_first, inner_step = first_fn, step_fn

        def first_fn(d):
            s, c = inner_first(_swap_ab_state(d))
            return _swap_ab_state(s), c

        def step_fn(d, carry):
            s, c = inner_step(_swap_ab_state(d), carry)
            return _swap_ab_state(s), c

    return hoisted_jit(first_fn), hoisted_jit(step_fn)


def _make_fast_step_mesh(cfg: ModelConfig, geom: CubedSphereGeometry,
                         ref_state, mesh, ntracers: int = 0):
    """The z-first engine distributed over a device mesh: the entire
    Strang step runs inside ONE shard_map; per-shard compute is the same
    code as the single-device engine on a rectangular (a, b) block, and
    all communication is the routed ppermute exchange of
    ``fast/mesh_dss.py`` (cross-shard element pairs + panel edges)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from . import implicit as fimp
    from . import mesh_dss

    constants = cfg.constants
    fg_full = build_fast_geometry(geom, dtype=cfg.dtype)
    mx, my = mesh.shape["x"], mesh.shape["y"]
    A, p = fg_full.A, fg_full.p
    a, b = A // mx, A // my
    if A % mx or A % my or a % p or b % p:
        raise ValueError(
            f"fast mesh engine needs mesh sizes dividing ne: A={A}, "
            f"p={p}, mesh=({mx},{my})")

    f64 = np.float64
    D = np.asarray(fg_full.DA_elem, f64)
    S = np.asarray(fg_full.S_elem, f64)
    delta = fg_full.delta

    def cc(x):
        return jnp.asarray(x, cfg.dtype)

    # geometry fields that must arrive per-shard (everything with a
    # horizontal extent); small operators stay in the closure
    BIG3 = ("c2_aa", "c2_ab", "c2_ba", "c2_bb", "jac2d", "fj", "inv_mult")
    BIG4 = ("jac3d", "jac3d_int", "con_a_xi", "con_b_xi", "con_xi_xi",
            "con_a_xi_int", "con_b_xi_int", "con_xi_xi_int",
            "deriv_r_a", "deriv_r_b", "deriv_r_xi_int", "area3d")
    gbig = {k: getattr(fg_full, k) for k in BIG3 + BIG4}
    gspec = {k: (P(None, "x", "y") if k in BIG3
                 else P(None, None, "x", "y")) for k in gbig}
    template = dataclasses.replace(
        fg_full, A=a, B=b,
        DA=cc(np.kron(np.eye(a // p), D.T) / delta),
        Sd=cc(np.kron(np.eye(a // p), S) / delta),
        DA_b=cc(np.kron(np.eye(b // p), D.T) / delta),
        Sd_b=cc(np.kron(np.eye(b // p), S) / delta),
        rayleigh_lev=None, rayleigh_int=None,
        **{k: None for k in gbig})

    q = nonhydro.estimate_bandwidth(geom, constants)
    statics = nonhydro.band_assembly_statics(geom, q)
    rayleigh = _rayleigh_terms(cfg, geom, ref_state)
    ray = {} if rayleigh is None else {"fac": rayleigh[0],
                                       "ref": rayleigh[1]}
    rayspec = {k: {f: P(None, None, "x", "y") for f in v}
               for k, v in ray.items()}
    # each card keeps its own block of the geometry between steps
    gbig, ray = jax.device_put(
        (gbig, ray), jax.tree.map(lambda spec: NamedSharding(mesh, spec),
                                  (gspec, rayspec),
                                  is_leaf=lambda x: isinstance(x, P)))

    dss_state_fn = mesh_dss.make_state_dss_mesh(
        fg_full.dss_links, np.asarray(fg_full.e_rot), mx, my, A, p,
        fg_full.nz, overlap=cfg.halo_overlap)

    tr_statics = None
    if ntracers > 0:
        from . import tracers as ftr
        tr_statics = ftr._tracer_band_statics(fg_full)
    sspec = {k: P(None, None, "x", "y") for k in FIELDS}
    if ntracers > 0:
        sspec = dict(sspec, Tracers=P(None, None, "x", "y"))

    def build_fns(fg_loc, ray_loc):
        def implicit_fn(d, dti):
            out = fimp.vertical_implicit(
                d, fg_loc, constants, dti, q, statics,
                newton_iters=cfg.newton_iterations,
                ref_jacobian=(cfg.jacobian_mode == "reference"))
            if "Tracers" in d:
                from . import tracers as ftr
                tr = ftr.update_column_tracers(
                    d, out["W"], fg_loc, dti, statics=tr_statics)
                out = dict(out, Tracers=ftr.filter_column(tr, fg_loc))
            return out

        rr = None if not ray_loc else (ray_loc["fac"], ray_loc["ref"])

        def dss_fn(d, rayleigh=None):
            out = dss_state_fn(d, fg_loc.inv_mult)
            if rayleigh is not None:
                # restrict the fused Rayleigh finish to the dynamics
                # fields: tracers DSS through the same payload but are
                # never Rayleigh-damped (reference ApplyRayleighFriction)
                out = dict(out, **apply_rayleigh(
                    {k: out[k] for k in FIELDS}, *rayleigh))
            return out

        return _strang_fns(cfg, fg_loc, rr, dss_fn, implicit_fn)

    def body_first(d, gb, ray_loc):
        fg_loc = dataclasses.replace(template, **gb)
        return build_fns(fg_loc, ray_loc)[0](d)

    def body_step(d, carry, gb, ray_loc):
        fg_loc = dataclasses.replace(template, **gb)
        return build_fns(fg_loc, ray_loc)[1](d, carry)

    # check_vma=False: the banded-solve kernel cannot declare
    # varying-mesh-axes metadata on its out_shapes
    ckeys = ("Rt", "W", "Rho") + (("Tracers",) if ntracers > 0 else ())
    cspec = {k: P(None, None, "x", "y") for k in ckeys}
    smap_first = jax.shard_map(body_first, mesh=mesh,
                               in_specs=(sspec, gspec, rayspec),
                               out_specs=(sspec, cspec), check_vma=False)
    smap_step = jax.shard_map(body_step, mesh=mesh,
                              in_specs=(sspec, cspec, gspec, rayspec),
                              out_specs=(sspec, cspec), check_vma=False)

    @hoisted_jit
    def first_step(d):
        return smap_first(d, gbig, ray)

    @hoisted_jit
    def step(d, carry):
        return smap_step(d, carry, gbig, ray)

    return first_step, step


def make_fast_multistep(cfg: ModelConfig, geom: CubedSphereGeometry,
                        inner_steps: int, ref_state=None, mesh=None,
                        ntracers: int = 0):
    """K fast steps fused under one jit with lax.scan (removes per-step
    dispatch latency; the dict-of-arrays carry keeps scan copies small)."""
    first_step, step = make_fast_step(cfg, geom, ref_state, mesh=mesh,
                                      ntracers=ntracers)

    @hoisted_jit
    def multi(d, carry):
        def body(sc, _):
            s, c = step(*sc)
            return (s, c), None
        (s, c), _ = jax.lax.scan(body, (d, carry), None,
                                 length=inner_steps)
        return s, c

    return first_step, multi

# ---------------------------------------------------------------------------
# IMEX-ARK family on the z-first engine
# ---------------------------------------------------------------------------

IMEX_SCHEMES = ("ars222", "ars232", "ark232", "gark2", "ars343",
                "ars343b", "ars443", "ssp3332")


def fast_imex_supported(cfg: ModelConfig, has_tracers: bool = False,
                        geom=None) -> bool:
    """Whether the IMEX-ARK family can run on the z-first engine: same
    envelope as the Strang fast engine (grid/staggering/solver), any
    ``_tableaux`` scheme or GARK2, single device, no tracers (the IMEX
    drivers carry tendencies as full state trees; the reference
    registers IMEX without tracer transport either,
    ``TempestInitialize.h:192-291``)."""
    from ..config import TimestepSchemeType
    if cfg.timescheme.value not in IMEX_SCHEMES or has_tracers:
        return False
    return fast_engine_supported(
        cfg.with_(timescheme=TimestepSchemeType.STRANG), geom=geom)


def make_fast_imex_step(cfg: ModelConfig, geom, ref_state=None):
    """Jitted IMEX-ARK step on the z-first engine: z-last state ->
    z-last state (drop-in for ``nh_model.make_nh_imex_step``, single
    device).  Reuses the z-first tendency (with the penalty upwinding
    folded), the DSS, the banded implicit solve and the nu4 tail; stage
    combinations follow ``timestep/imex.py`` exactly (reference
    ``TimestepSchemeARS343.cpp`` etc).  Pack/unpack transposes run at
    the step boundary."""
    import math as _math
    from . import implicit as fimp
    from ..timestep.imex import _tableaux
    from ..config import TimestepSchemeType

    constants = cfg.constants
    dt = cfg.dt
    if hasattr(geom, "nex"):
        fg = build_fast_geometry_cartesian(geom, dtype=cfg.dtype)
    else:
        fg = build_fast_geometry(geom, dtype=cfg.dtype)
    q = nonhydro.estimate_bandwidth(geom, constants)
    statics = nonhydro.band_assembly_statics(geom, q)
    rayleigh = _rayleigh_terms(cfg, geom, ref_state, fg=fg)
    saux = fimp.static_aux(fg)

    def tend(u):
        return horizontal_tendency(u, fg, constants)

    def post(u):
        return apply_dss(apply_w_boundary(u, fg), fg)

    def implicit(u, dti):
        return fimp.vertical_implicit(
            u, fg, constants, dti, q, statics,
            newton_iters=cfg.newton_iterations,
            ref_jacobian=(cfg.jacobian_mode == "reference"), saux=saux)

    def tail(u):
        return step_after_subcycle(u, dt, cfg, fg, rayleigh=rayleigh)

    def axpy(b, t, c):
        return tree_map(lambda x, y: x + c * y, b, t)

    if cfg.timescheme == TimestepSchemeType.GARK2:
        g = 1.0 - 0.5 * _math.sqrt(2.0)
        al = 0.5

        def body(u0):
            F0 = tend(u0)
            uf1 = post(axpy(u0, F0, g * dt))
            u1 = implicit(uf1, g * dt)
            G1 = tree_map(lambda a, b: (a - b) / (g * dt), u1, uf1)
            uf2 = post(axpy(axpy(u0, F0, dt), G1, dt))
            F1 = tend(uf2)
            z2 = axpy(axpy(axpy(u0, F0, al * dt), G1, (1.0 - g) * dt),
                      F1, (1.0 - al) * dt)
            z2 = post(z2)
            u2 = implicit(z2, g * dt)
            return tail(u2)
    else:
        aexp, aimp = _tableaux(cfg.timescheme)
        s = len(aexp)

        def body(u0):
            u = u0
            F = []
            G = []
            for i in range(s):
                F.append(tend(u))
                uf = u0
                for j in range(i + 1):
                    if aexp[i][j] != 0.0:
                        uf = axpy(uf, F[j], aexp[i][j] * dt)
                for j in range(i):
                    if aimp[i][j] != 0.0:
                        uf = axpy(uf, G[j], aimp[i][j] * dt)
                uf = post(uf)
                if aimp[i][i] != 0.0:
                    u = implicit(uf, aimp[i][i] * dt)
                    G.append(tree_map(
                        lambda a, b: (a - b) / (aimp[i][i] * dt), u, uf))
                else:
                    u = uf
                    G.append(tree_map(lambda a: a * 0.0, uf))
            return tail(u)

    @hoisted_jit
    def step(state):
        d = pack_state(state)
        if fg.ab_swapped:
            d = _swap_ab_state(d)
        out = body(d)
        if fg.ab_swapped:
            out = _swap_ab_state(out)
        return unpack_state(out)

    return step
