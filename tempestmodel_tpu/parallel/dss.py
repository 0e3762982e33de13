"""Direct stiffness summation (DSS) on the cubed-sphere GLL grid.

JAX equivalent of the reference's halo exchange + edge averaging
(``GridCSGLL::ApplyDSS``, ``src/atm/GridCSGLL.cpp:435-780``, and the MPI
``ExchangeBufferRegistry``, ``src/atm/Connectivity.cpp``).

Design: coincident GLL nodes are stored duplicated.  DSS replaces every
coincident group by its mean.  Instead of the reference's sequential
alpha-then-beta averaging + special-cased corners (which equals the
symmetric mean in exact arithmetic), we compute

    dss(f) = (sum over coincident copies of f) * (1 / multiplicity)

with three structured steps, all static gathers that XLA partitions
cleanly under pjit:

  1. pairwise add across interior element boundaries (alpha then beta)
  2. add the neighbor panel's edge-line sums (orientation-corrected,
     with 2x2 covariant vector rotation for velocity pairs)
  3. add the third panel's contribution at the 8 cube corners
  4. multiply by the precomputed 1/multiplicity field

Works on any trailing shape (scalar fields, level stacks, interface stacks).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..grid.geometry import (CubedSphereGeometry, EDGE_LEFT, EDGE_RIGHT,
                             EDGE_BOTTOM, EDGE_TOP)


def _pair_sum_interior(f, ne: int, p: int):
    """Add coincident element-boundary copies within each panel (both axes)."""
    # alpha direction: columns e*p-1 and e*p coincide for e = 1..ne-1
    hi = f[:, p - 1:-1:p]       # (6, ne-1, B, ...) columns e*p-1, e=1..ne-1
    lo = f[:, p::p]             # columns e*p
    s = hi + lo
    f = f.at[:, p - 1:-1:p].set(s)
    f = f.at[:, p::p].set(s)
    # beta direction
    hi = f[:, :, p - 1:-1:p]
    lo = f[:, :, p::p]
    s = hi + lo
    f = f.at[:, :, p - 1:-1:p].set(s)
    f = f.at[:, :, p::p].set(s)
    return f


def _get_edge(f, panel: int, edge: int):
    if edge == EDGE_LEFT:
        return f[panel, 0, :]
    if edge == EDGE_RIGHT:
        return f[panel, -1, :]
    if edge == EDGE_BOTTOM:
        return f[panel, :, 0]
    if edge == EDGE_TOP:
        return f[panel, :, -1]
    raise ValueError(edge)


def _add_edge(f, panel: int, edge: int, val):
    if edge == EDGE_LEFT:
        return f.at[panel, 0, :].add(val)
    if edge == EDGE_RIGHT:
        return f.at[panel, -1, :].add(val)
    if edge == EDGE_BOTTOM:
        return f.at[panel, :, 0].add(val)
    if edge == EDGE_TOP:
        return f.at[panel, :, -1].add(val)
    raise ValueError(edge)


def apply_dss_scalar(f, geom: CubedSphereGeometry):
    """DSS of a scalar field (6, A, B, ...)."""
    ne, p = geom.ne, geom.p
    s = _pair_sum_interior(f, ne, p)
    # gather all neighbor edge lines from the *pre-edge-sum* panel sums
    gathered = []
    for (pa, e, qa, qe, flip) in geom.edge_meta:
        line = _get_edge(s, qa, qe)
        if flip:
            line = line[::-1]
        gathered.append((pa, e, line))
    out = s
    for (pa, e, line) in gathered:
        out = _add_edge(out, pa, e, line)
    # cube corners: add the third panel's (diagonal) contribution.
    # After edge sums, corner holds self + two neighbors... each corner node
    # belongs to 2 edges of its panel, so both neighbor-panel corner values
    # were already added: total = self + nbr1 + nbr2 = full 3-way sum.
    w = geom.inv_mult
    return out * w.reshape(w.shape + (1,) * (f.ndim - 3))


def apply_dss_vector(fu, fv, geom: CubedSphereGeometry, mats=None):
    """DSS of a covariant vector field pair (U_alpha, U_beta).

    Neighbor-panel contributions are rotated into the local covariant basis
    with the precomputed per-edge-node 2x2 matrices (the analog of
    ``TransformHaloVelocities``, ``GridPatchCSGLL.cpp:1783+``, derived there
    from ``CubedSphereTrans::CoVecPanelTrans``).

    ``mats``: override the (6, 4, A, 2, 2) edge transform set — used by
    the HighSpeedDynamics momentum DSS, whose CONTRAVARIANT components
    transform with the inverse-transpose matrices.
    """
    ne, p = geom.ne, geom.p
    if mats is None:
        mats = geom.edge_mats
    su = _pair_sum_interior(fu, ne, p)
    sv = _pair_sum_interior(fv, ne, p)
    gathered = []
    for (pa, e, qa, qe, flip) in geom.edge_meta:
        lu = _get_edge(su, qa, qe)
        lv = _get_edge(sv, qa, qe)
        if flip:
            lu, lv = lu[::-1], lv[::-1]
        M = mats[pa, e]                 # (A, 2, 2)
        shape_extra = (1,) * (lu.ndim - 1)
        m00 = M[:, 0, 0].reshape(M.shape[0], *shape_extra)
        m01 = M[:, 0, 1].reshape(M.shape[0], *shape_extra)
        m10 = M[:, 1, 0].reshape(M.shape[0], *shape_extra)
        m11 = M[:, 1, 1].reshape(M.shape[0], *shape_extra)
        tu = m00 * lu + m01 * lv
        tv = m10 * lu + m11 * lv
        gathered.append((pa, e, tu, tv))
    for (pa, e, tu, tv) in gathered:
        su = _add_edge(su, pa, e, tu)
        sv = _add_edge(sv, pa, e, tv)
    w = geom.inv_mult
    w = w.reshape(w.shape + (1,) * (fu.ndim - 3))
    return su * w, sv * w


def apply_dss_state_sw(state, geom: CubedSphereGeometry):
    """DSS of the shallow-water state dict {U, V, H}."""
    u, v = apply_dss_vector(state["U"], state["V"], geom)
    h = apply_dss_scalar(state["H"], geom)
    return {"U": u, "V": v, "H": h}
