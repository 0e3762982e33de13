"""Z-first DSS in plain JAX (XLA fuses it; no kernel).

The DSS of ``parallel/dss.py`` (interior element pair-sums, neighbor-panel
edge contributions, multiplicity normalization) on the engine's
(K, P, A, B) layout:

1. pair sums along A and B: each element-boundary node adds its partner
   on the other side of the boundary (a masked ±1 roll).  ``wrap`` makes
   an axis periodic: the first and last lines then pair too (the
   Cartesian grids, ``grid/cartesian._pair_sum_axis``);
2. panel edges: all 4 edge lines of all panels are read once from the
   pair-summed field, and each destination edge takes its linked source
   line (reversed where the link flips) with one static gather; the
   covariant (U, V) pair rotates it with the per-node 2x2 panel
   transforms (``TransformHaloVelocities`` analog, tables from
   ``grid/geometry.edge_mats``);
3. the edge lines are padded back to full size and added, and the sum is
   scaled by the inverse multiplicity: one elementwise pass.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..grid.geometry import EDGE_LEFT, EDGE_RIGHT, EDGE_BOTTOM, EDGE_TOP


def _pair_masks(n: int, p: int, wrap: bool):
    """Receive masks (n,) of the -1 and +1 rolls along an axis of n
    nodes: the last node of an element takes its right neighbor, the
    first node its left one; without ``wrap`` the two ends of the axis
    take nothing."""
    i = np.arange(n)
    m_hi = i % p == p - 1
    m_lo = i % p == 0
    if not wrap:
        m_hi &= i < n - 1
        m_lo &= i > 0
    return m_hi, m_lo


def pair_sum(x, p: int, axes=(2, 3), wrap=(False, False)):
    """Element-boundary pair sums along ``axes`` of ``x``, by default
    axes 2 (A) and 3 (B) of a (K, P, A, B) field; equals
    ``parallel/dss._pair_sum_interior``.  The mesh DSS runs it on each
    card's block and on edge lines (``fast/mesh_dss``): the two ends of
    a block pair with other cards, so they take nothing here."""
    for axis, w in zip(axes, wrap):
        n = x.shape[axis]
        shape = [1] * x.ndim
        shape[axis] = n
        m_hi, m_lo = (jnp.asarray(m.reshape(shape), x.dtype)
                      for m in _pair_masks(n, p, w))
        x = (x + jnp.roll(x, -1, axis) * m_hi
             + jnp.roll(x, 1, axis) * m_lo)
    return x


def _edge_lines(x):
    """(K, P, 4, L): the four edge lines of every panel, in EDGE_* order
    (left/right run along B, bottom/top along A; the sphere has A == B)."""
    lines = [None] * 4
    lines[EDGE_LEFT] = x[:, :, 0, :]
    lines[EDGE_RIGHT] = x[:, :, -1, :]
    lines[EDGE_BOTTOM] = x[:, :, :, 0]
    lines[EDGE_TOP] = x[:, :, :, -1]
    return jnp.stack(lines, axis=2)


def _link_tables(links, P: int):
    """Static gather indices into the (K, 2*P*4, L) [lines; reversed
    lines] stack, and the link number, for every destination edge
    (pa, e) in (P, 4) order."""
    src = np.zeros(P * 4, np.int64)
    link_of = np.zeros(P * 4, np.int64)
    seen = np.zeros(P * 4, bool)
    for i, (pa, e, qa, qe, flip) in enumerate(links):
        dst = pa * 4 + e
        if seen[dst]:
            raise ValueError(f"panel {pa} edge {e} has two links")
        seen[dst] = True
        src[dst] = (P * 4 if flip else 0) + qa * 4 + qe
        link_of[dst] = i
    if not seen.all():
        raise ValueError("every panel edge needs exactly one link")
    return src, link_of


def _incoming(fields, links, rot=None):
    """Per-field (K, P, 4, L) sums arriving at each panel edge from its
    linked neighbor edge; ``rot`` (4, nlinks, L) rotates fields[0:2] as a
    covariant pair."""
    K, P = fields[0].shape[:2]
    src, link_of = _link_tables(links, P)
    out = []
    for x in fields:
        flat = _edge_lines(x).reshape(K, P * 4, -1)
        both = jnp.concatenate([flat, flat[..., ::-1]], axis=1)
        out.append(both[:, src].reshape(K, P, 4, -1))
    if rot is not None:
        m = rot[:, link_of].reshape(4, 1, P, 4, -1)
        lu, lv = out[0], out[1]
        out[0] = m[0] * lu + m[1] * lv
        out[1] = m[2] * lu + m[3] * lv
    return out


def _finish(x, inc, imult):
    """x + the incoming edge lines (padded to full size), times the
    inverse multiplicity."""
    A, B = x.shape[2], x.shape[3]
    z = (0, 0)
    if inc is not None:
        x = (x
             + jnp.pad(inc[:, :, EDGE_LEFT, None, :], (z, z, (0, A - 1), z))
             + jnp.pad(inc[:, :, EDGE_RIGHT, None, :], (z, z, (A - 1, 0), z))
             + jnp.pad(inc[:, :, EDGE_BOTTOM, :, None], (z, z, z, (0, B - 1)))
             + jnp.pad(inc[:, :, EDGE_TOP, :, None], (z, z, z, (B - 1, 0))))
    return x * imult[None]


def dss_scalar(f, imult, links, p: int, wrap=(False, False)):
    """DSS of a scalar (K, P, A, B) field."""
    x = pair_sum(f, p, wrap=wrap)
    inc = _incoming([x], links)[0] if links else None
    return _finish(x, inc, imult)


def dss_vector(u, v, imult, rot, links, p: int, wrap=(False, False)):
    """DSS of a covariant vector pair (K, P, A, B) x 2."""
    x = pair_sum(u, p, wrap=wrap)
    y = pair_sum(v, p, wrap=wrap)
    if not links:
        return _finish(x, None, imult), _finish(y, None, imult)
    iu, iv = _incoming([x, y], links, rot)
    return _finish(x, iu, imult), _finish(y, iv, imult)
