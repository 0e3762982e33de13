"""Scatter-minimal DSS: slice pair-sums + ONE combined edge scatter.

The naive slice/scatter DSS in ``dss.py`` is algebraically right but
lowers to many full-buffer ``dynamic-update-slice`` ops per model step,
because every one of the 24 panel edges is a separate ``.at[].add`` on
a full field.

What this module does instead:

  1. interior element-boundary pair-sums as 4 static slice updates
     (as ``dss.py``, XLA handles contiguous-stride updates well);
  2. all 24 cross-panel edge additions batched into ONE scatter-add
     with a precomputed flat destination-index vector (corners receive
     their two neighbor-panel copies through duplicate indices, which
     scatter-add accumulates) — one buffer pass instead of 24 separate
     ``.at[edge].add`` rewrites;
  3. a fused multiply by 1/multiplicity.

The model keeps ``dss.py`` on the reference-layout hot path (this
variant was not faster in full-step timing); this module is retained as
an independent specification of the DSS operator: its roundoff-equality
tests (``tests/test_dss.py``) pin the same
operator (corner accumulation included).

Vector pairs transform with the per-edge 2x2 covariant matrices applied
to the thin gathered lines; contravariant momenta (HighSpeedDynamics)
use the inverse-transpose set.

Reference: ``GridCSGLL::ApplyDSS`` (``src/atm/GridCSGLL.cpp:435-780``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from ..grid.geometry import (EDGE_LEFT, EDGE_RIGHT, EDGE_BOTTOM, EDGE_TOP)


@dataclass(frozen=True)
class DSSTables:
    ne: int
    p: int
    dst: Any             # (24*A,) flat destination node ids, edge order
    src_meta: Any        # tuple of 24 (qa, qe, flip) line sources
    mats: Any            # (24, A, 2, 2) covariant line transforms
    mats_contra: Any     # same, inverse-transpose (momentum DSS)
    inv_mult: Any        # (6, A, B)
    A: int


def _edge_flat_ids(pa: int, e: int, A: int) -> np.ndarray:
    ii = np.arange(A)
    if e == EDGE_LEFT:
        a, b = np.zeros(A, dtype=np.int64), ii
    elif e == EDGE_RIGHT:
        a, b = np.full(A, A - 1, dtype=np.int64), ii
    elif e == EDGE_BOTTOM:
        a, b = ii, np.zeros(A, dtype=np.int64)
    elif e == EDGE_TOP:
        a, b = ii, np.full(A, A - 1, dtype=np.int64)
    else:
        raise ValueError(e)
    return pa * A * A + a * A + b


def build_dss_tables(geom, dtype=None) -> DSSTables:
    ne, p = geom.ne, geom.p
    A = ne * p
    dst, meta, mats = [], [], []
    cov = np.asarray(geom.edge_mats)
    for (pa, e, qa, qe, flip) in geom.edge_meta:
        dst.append(_edge_flat_ids(pa, e, A))
        meta.append((qa, qe, flip))
        mats.append(cov[pa, e])
    mats = np.stack(mats)                       # (24, A, 2, 2)
    contra = np.swapaxes(np.linalg.inv(mats), -1, -2)
    dtype = dtype or jnp.asarray(geom.jac2d).dtype
    return DSSTables(
        ne=ne, p=p,
        dst=jnp.asarray(np.concatenate(dst), dtype=jnp.int32),
        src_meta=tuple(meta),
        mats=jnp.asarray(mats, dtype=dtype),
        mats_contra=jnp.asarray(contra, dtype=dtype),
        inv_mult=jnp.asarray(geom.inv_mult, dtype=dtype),
        A=A)


def _get_line(f, panel: int, edge: int):
    if edge == EDGE_LEFT:
        return f[panel, 0, :]
    if edge == EDGE_RIGHT:
        return f[panel, -1, :]
    if edge == EDGE_BOTTOM:
        return f[panel, :, 0]
    if edge == EDGE_TOP:
        return f[panel, :, -1]
    raise ValueError(edge)


def _pair_sums(f, _unused, ne: int, p: int):
    # slice-based coincident-pair sums (4 static updates; measured
    # faster than the 0/1-matrix matmul at f32-highest precision, which
    # costs ~10 ms/step of 3-pass MXU work at ne30 L30)
    hi = f[:, p - 1:-1:p]
    lo = f[:, p::p]
    s = hi + lo
    f = f.at[:, p - 1:-1:p].set(s).at[:, p::p].set(s)
    hi = f[:, :, p - 1:-1:p]
    lo = f[:, :, p::p]
    s = hi + lo
    return f.at[:, :, p - 1:-1:p].set(s).at[:, :, p::p].set(s)


def _edge_lines(s, tab: DSSTables):
    """(24, A, ...) stacked neighbor edge lines (flip-corrected)."""
    lines = []
    for (qa, qe, flip) in tab.src_meta:
        ln = _get_line(s, qa, qe)
        lines.append(ln[::-1] if flip else ln)
    return jnp.stack(lines)


def _scatter_finish(s, vals24, tab: DSSTables, trailing_ndim: int):
    """One combined scatter-add of all 24 edge-line contributions."""
    A = tab.A
    flat = s.reshape((6 * A * A,) + s.shape[3:])
    out = flat.at[tab.dst].add(vals24.reshape((24 * A,) + vals24.shape[2:]))
    out = out.reshape(s.shape)
    w = tab.inv_mult.reshape(tab.inv_mult.shape + (1,) * trailing_ndim)
    return out * w


def dss_scalar_gather(f, tab: DSSTables):
    """DSS of a scalar (6, A, B, ...) field."""
    s = _pair_sums(f, None, tab.ne, tab.p)
    return _scatter_finish(s, _edge_lines(s, tab), tab, f.ndim - 3)


def dss_vector_gather(fu, fv, tab: DSSTables, wv=None):
    """DSS of a covariant vector pair with panel-edge transforms.

    ``wv="contra"`` or a (24, A, 2, 2) array: alternate line-transform
    set (contravariant momenta use the inverse-transpose matrices)."""
    if wv is None:
        mats = tab.mats
    elif isinstance(wv, str) and wv == "contra":
        mats = tab.mats_contra
    else:
        mats = wv
    su = _pair_sums(fu, None, tab.ne, tab.p)
    sv = _pair_sums(fv, None, tab.ne, tab.p)
    lu = _edge_lines(su, tab)
    lv = _edge_lines(sv, tab)
    ext = (Ellipsis,) + (None,) * (fu.ndim - 3)
    tu = mats[:, :, 0, 0][ext] * lu + mats[:, :, 0, 1][ext] * lv
    tv = mats[:, :, 1, 0][ext] * lu + mats[:, :, 1, 1][ext] * lv
    return (_scatter_finish(su, tu, tab, fu.ndim - 3),
            _scatter_finish(sv, tv, tab, fv.ndim - 3))


def build_contra_wv(geom):
    """Back-compat helper: the contravariant line-transform set."""
    return build_dss_tables(geom).mats_contra
