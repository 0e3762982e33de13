"""Spectral-element tensor-product derivative operators.

JAX core of the reference's GLL stencil loops
(``src/atm/HorizontalDynamicsFEM.cpp:840-841`` and the per-node inner loops
at ``:701-1786``): instead of scalar gather loops per GLL node, fields with
the element-stacked layout (npanel, A, B, ...) are reshaped to expose the
per-element (p, p) block and derivatives become small batched matmuls that
XLA fuses and maps onto the MXU/VPU.

Conventions (matching ``GridGLL::Initialize``, ``GridGLL.cpp:86-183``):
  deriv  D[m, i] = L_m'(x_i) on the unit element [0, 1]
  stiff  S[m, i] = D[m, i] * w_i / w_m
  strong derivative at node i:  (df)_i = sum_s f_s D[s, i] / delta
  weak (variational) flux div:  (div f)_i = -sum_s f_s S[i, s] / delta

Grids may be rectangular: nea/neb elements and delta_a/delta_b spacings per
axis (cubed-sphere panels are square; Cartesian planes are not).
"""

from __future__ import annotations

import jax.numpy as jnp


def _split(f, nea: int, neb: int, p: int):
    """(P, A, B, ...) -> (P, nea, p, neb, p, ...)."""
    rest = f.shape[3:]
    return f.reshape(f.shape[0], nea, p, neb, p, *rest)


def _merge(f):
    """(P, nea, p, neb, p, ...) -> (P, A, B, ...)."""
    rest = f.shape[5:]
    return f.reshape(f.shape[0], f.shape[1] * f.shape[2],
                     f.shape[3] * f.shape[4], *rest)


def deriv_a(f, D, nea: int, neb: int, p: int, delta_a: float):
    """Strong-form alpha derivative of an element-stacked field."""
    fe = _split(f, nea, neb, p)
    out = jnp.einsum("si,Pasb...->Paib...", D, fe)
    return _merge(out) / delta_a


def deriv_b(f, D, nea: int, neb: int, p: int, delta_b: float):
    """Strong-form beta derivative."""
    fe = _split(f, nea, neb, p)
    ft = jnp.moveaxis(fe, 4, -1)            # beta-node axis last
    out = jnp.einsum("si,P...s->P...i", D, ft)
    out = jnp.moveaxis(out, -1, 4)
    return _merge(out) / delta_b


def deriv_both(f, D, nea: int, neb: int, p: int,
               delta_a: float, delta_b: float):
    """(df/da, df/db) in one call."""
    fe = _split(f, nea, neb, p)
    da = jnp.einsum("si,Pasb...->Paib...", D, fe)
    ft = jnp.moveaxis(fe, 4, -1)
    db = jnp.einsum("si,P...s->P...i", D, ft)
    db = jnp.moveaxis(db, -1, 4)
    return _merge(da) / delta_a, _merge(db) / delta_b


def weak_div(fa, fb, Smat, nea: int, neb: int, p: int,
             delta_a: float, delta_b: float):
    """Variational flux divergence (positive = divergence).

    Matches the reference's stiffness-matrix update
    (``HorizontalDynamicsFEM.cpp:519-560``) up to overall sign: here
    ``weak_div ~ +div F`` in the weak sense, so tendencies subtract it.
    """
    fae = _split(fa, nea, neb, p)
    fbe = _split(fb, nea, neb, p)
    da = jnp.einsum("is,Pasb...->Paib...", Smat, fae)
    fbt = jnp.moveaxis(fbe, 4, -1)
    db = jnp.einsum("is,P...s->P...i", Smat, fbt)
    db = jnp.moveaxis(db, -1, 4)
    return -(_merge(da) / delta_a + _merge(db) / delta_b)


# ---------------------------------------------------------------------------
# Block-diagonal GEMM formulation
#
# The per-element (p, p) contractions can be expressed as ONE dense matmul
# against a block-diagonal (A, A) operator (blocks = the p x p element
# matrix).  This maps the whole derivative onto a single GEMM instead of
# ne^2 tiny batched contractions; the extra zero-block FLOPs are cheap
# (the op is memory-bandwidth-bound).
# ---------------------------------------------------------------------------

def block_diag_operator(M, ne: int):
    """(A, A) block-diagonal expansion of a (p, p) element operator."""
    import numpy as np
    p = M.shape[0]
    A = ne * p
    out = np.zeros((A, A), dtype=np.asarray(M).dtype)
    for e in range(ne):
        out[e * p:(e + 1) * p, e * p:(e + 1) * p] = np.asarray(M)
    return out


def deriv_a_dense(f, Dfull_a, delta_a: float):
    """Strong alpha derivative via the (A, A) block-diagonal operator.

    ``Dfull_a[s, i] = D[s%p, i%p]`` within diagonal blocks: the derivative
    at node i is sum_s f[s] Dfull[s, i].
    """
    return jnp.einsum("si,Psb...->Pib...", Dfull_a, f) / delta_a


def deriv_b_dense(f, Dfull_b, delta_b: float):
    """Strong beta derivative: contract axis 2 against the operator."""
    out = jnp.tensordot(f, Dfull_b, axes=[[2], [0]])
    # tensordot appends the result axis; restore (P, A, B, ...) order
    out = jnp.moveaxis(out, -1, 2)
    return out / delta_b


def weak_div_dense(fa, fb, Sfull_a, Sfull_b, delta_a: float, delta_b: float):
    """Variational divergence via block-diagonal stiffness operators."""
    da = jnp.einsum("is,Psb...->Pib...", Sfull_a, fa)
    db = jnp.moveaxis(jnp.tensordot(fb, Sfull_b.T, axes=[[2], [0]]), -1, 2)
    return -(da / delta_a + db / delta_b)


def weak_grad_a(f, Smat, nea: int, neb: int, p: int, delta_a: float):
    """-sum_s f_s S[i, s] / delta along alpha (reference dDaDiv loops)."""
    fe = _split(f, nea, neb, p)
    out = jnp.einsum("is,Pasb...->Paib...", Smat, fe)
    return -_merge(out) / delta_a


def weak_grad_b(f, Smat, nea: int, neb: int, p: int, delta_b: float):
    fe = _split(f, nea, neb, p)
    ft = jnp.moveaxis(fe, 4, -1)
    out = jnp.einsum("is,P...s->P...i", Smat, ft)
    return -jnp.moveaxis(out, -1, 4).reshape(f.shape) / delta_b
