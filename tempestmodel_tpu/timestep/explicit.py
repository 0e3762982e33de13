"""Explicit Runge-Kutta sub-schemes used inside Strang/ERK stepping.

JAX equivalent of the explicit branches of
``TimestepSchemeStrang::Step`` (reference
``src/atm/TimestepSchemeStrang.cpp:460-690``) and the stage-combination
constants (``:55-140``).  The reference juggles 5 persistent state
instances with CopyData/LinearCombineData; here stages are just local
pytrees inside one jitted function -- XLA does the buffer reuse.

The caller provides ``stage(base, u_eval, dt_s) -> new_state``: one
forward-Euler-like substep evaluated at ``u_eval`` and added onto ``base``
(including DSS and any model-specific post-processing; the reference's
StepExplicit + PostProcessSubstage pair).
"""

from __future__ import annotations

from typing import Callable

import jax

from ..config import ExplicitSubScheme


def tree_axpy(base, tendency, dt):
    """base + dt * tendency over matching pytree keys (missing keys pass)."""
    out = dict(base)
    for k, t in tendency.items():
        out[k] = base[k] + dt * t
    return out


def _comb(coeffs_states):
    """Linear combination of (coeff, state) pairs."""
    coeffs, states = zip(*coeffs_states)
    return jax.tree_util.tree_map(
        lambda *xs: sum(c * x for c, x in zip(coeffs, xs)), *states)


def erk_substep(scheme: ExplicitSubScheme, u0, dt, stage: Callable,
                shadow0=None):
    """One full explicit RK step u0 -> u_new.

    ``stage(base, u_eval, dt_s)`` performs base + dt_s * T(u_eval) with DSS.

    ``shadow0``: optional "halo shadow" of u0 for no-flux boundary
    emulation (reference per-instance halos, which flow through
    CopyData/LinearCombineData like data and sync to the edge value at
    every DSS).  When given, ``stage`` is called with a 4th argument —
    the shadow of the stage's base (stage OUTPUTS are their own shadow,
    since DSS syncs halo = edge; only u0's interior has drifted from its
    halo).
    """
    if shadow0 is None:
        def S(base, ueval, dts, sh):
            return stage(base, ueval, dts)
    else:
        S = stage

    if scheme == ExplicitSubScheme.FORWARD_EULER:
        return S(u0, u0, dt, shadow0)

    if scheme == ExplicitSubScheme.RK4:
        u1 = S(u0, u0, 0.5 * dt, shadow0)
        u2 = S(u0, u1, 0.5 * dt, shadow0)
        u3 = S(u0, u2, dt, shadow0)
        cs = [(-1.0 / 3.0, u0), (1.0 / 3.0, u1),
              (2.0 / 3.0, u2), (1.0 / 3.0, u3)]
        base = _comb(cs)
        sh = _comb([(-1.0 / 3.0, shadow0)] + cs[1:]) if shadow0 is not None \
            else None
        return S(base, u3, dt / 6.0, sh)

    if scheme == ExplicitSubScheme.SSPRK3:
        u1 = S(u0, u0, dt, shadow0)
        base = _comb([(0.75, u0), (0.25, u1)])
        sh = _comb([(0.75, shadow0), (0.25, u1)]) \
            if shadow0 is not None else None
        u2 = S(base, u1, 0.25 * dt, sh)
        base = _comb([(1.0 / 3.0, u0), (2.0 / 3.0, u2)])
        sh = _comb([(1.0 / 3.0, shadow0), (2.0 / 3.0, u2)]) \
            if shadow0 is not None else None
        return S(base, u2, (2.0 / 3.0) * dt, sh)

    if scheme == ExplicitSubScheme.KGU35:
        u1 = S(u0, u0, dt / 5.0, shadow0)
        u2 = S(u0, u1, dt / 5.0, shadow0)
        u3 = S(u0, u2, dt / 3.0, shadow0)
        u2b = S(u0, u3, 2.0 * dt / 3.0, shadow0)
        base = _comb([(-0.25, u0), (1.25, u1)])
        sh = _comb([(-0.25, shadow0), (1.25, u1)]) \
            if shadow0 is not None else None
        return S(base, u2b, 0.75 * dt, sh)

    if scheme == ExplicitSubScheme.SSPRK53:
        c1 = 0.377268915331368
        c3 = 0.242995220537396
        c4 = 0.238458932846290
        c5 = 0.287632146308408
        u1 = S(u0, u0, c1 * dt, shadow0)
        u2 = S(u1, u1, c1 * dt, u1)
        base = _comb([(0.355909775063327, u0), (0.644090224936674, u2)])
        sh = _comb([(0.355909775063327, shadow0),
                    (0.644090224936674, u2)]) \
            if shadow0 is not None else None
        u3 = S(base, u2, c3 * dt, sh)
        base = _comb([(0.367933791638137, u0), (0.632066208361863, u3)])
        sh = _comb([(0.367933791638137, shadow0),
                    (0.632066208361863, u3)]) \
            if shadow0 is not None else None
        u0b = S(base, u3, c4 * dt, sh)
        base = _comb([(0.762406163401431, u0b), (0.237593836598569, u2)])
        sh = _comb([(0.762406163401431, u0b), (0.237593836598569, u2)]) \
            if shadow0 is not None else None
        return S(base, u0b, c5 * dt, sh)

    raise ValueError(f"unknown explicit scheme {scheme}")


# Maximum stable Courant numbers of KGU35 vs horizontal order
# (reference TimestepSchemeStrang.cpp:140-197, continuous part).
KGU35_MAX_COURANT = {
    2: 4.0, 3: 2.580678, 4: 2.121307, 5: 1.851593, 6: 1.651180,
    7: 1.512724, 8: 1.402086, 9: 1.315476, 10: 1.243615,
}
