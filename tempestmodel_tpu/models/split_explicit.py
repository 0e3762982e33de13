"""Split-explicit (acoustic-substepped) nonhydrostatic dynamics.

JAX re-design of the reference's WRF/Klemp-Wilhelmson family
(``SplitExplicitDynamics.{h,cpp}``, driver ``TimestepSchemeSplitExp.cpp``,
selected by ``--hmethod SPEX --timescheme spex``):

- each KGU35 macro-stage evaluates the FULL slow+fast tendency once
  (``CalculateTendencies``, SplitExplicitDynamics.cpp:347-960), then runs
  3 acoustic subcycles advancing state INCREMENTS with the linearized
  fast (acoustic) operator (``FirstAcousticLoop`` :961,
  ``PerformAcousticLoop`` :1447);
- the horizontal acoustic update is forward-explicit with divergence
  damping via forward-weighting of the pressure increment
  (beta_d, ``:1560-1566``);
- the vertical acoustic update is implicit and off-centered
  (beta_s = 0.1, ``:1247``), trapezoidal in the vertical fast operator.

Deliberate deviations (documented intentionally, not bugs):
- the reference Schur-reduces the vertical acoustic system to a
  tridiagonal in W with finite-difference z-derivatives
  (``:1250-1340``); here the UNREDUCED linear system
  (I + ts L_v) x'' = r over (Rt', W', Rho') is solved directly with the
  batched banded machinery (``vertical_banded``)
  using the same spectral-element column operators as the rest of the
  framework, with L_v the analytic fast-only Jacobian.  Same math,
  no reduction step, and the solve vectorizes over every column.
- the reference's trailing ``ns`` explicit vertical substeps
  (TimestepSchemeSplitExp.cpp:155-210) are not reproduced: vertical
  acoustic stiffness is already handled implicitly inside the acoustic
  loop here, and vertical advection rides in the slow tendency.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from ..ops import sem
from . import nonhydro
from . import hyperdiff
from .nonhydro import colop
from .vertical_banded import interleave_perm, banded_solve_t
from ..timestep.explicit import erk_substep


def fast_column_multi_jvp(x0, aux, g, constants, nz, tangents):
    """Tangents of the FAST (acoustic) part of the column residual.

    The acoustic operator L_v: linearized vertical flux divergence of
    (Rt, Rho) and linearized PGF+buoyancy in W — the column residual
    (``nonhydro._column_residual``) minus advective KE/curl terms,
    upwinding, penalties, and the time term.  ``x0``: (ncol, n) base;
    ``tangents``: (S, ncol, n) -> (S, ncol, n).
    """
    c = constants

    def split(x):
        return x[..., :nz], x[..., nz:2 * nz + 1], x[..., 2 * nz + 1:]

    rt0, w0, rho0 = split(x0)
    rho_i0 = colop(g["interp_n2i"], rho0)
    rt_i0 = colop(g["interp_n2i"], rt0)
    pi_n0 = nonhydro.exner_from_rhotheta(rt0, c)
    dpi_drt = (c.Rd / (c.Cp - c.Rd)) * pi_n0 / rt0
    dpi_i0 = colop(g["diff_n2i"], pi_n0)
    cXi = aux["con_xi_xi_int"]
    xid_i0 = (aux["con_a_xi_int"] * aux["u_i"]
              + aux["con_b_xi_int"] * aux["v_i"] + cXi * w0)
    mask_i = jnp.ones(nz + 1, x0.dtype).at[0].set(0.0).at[-1].set(0.0)
    xid_i0 = xid_i0 * mask_i
    jac, jac_i = aux["jac"], aux["jac_int"]
    inv_jac = 1.0 / jac

    drt, dw, drho = split(tangents)
    drho_i = colop(g["interp_n2i"], drho)
    drt_i = colop(g["interp_n2i"], drt)
    dpi_n = dpi_drt * drt
    ddpi_i = colop(g["diff_n2i"], dpi_n)
    dxid_i = cXi * dw * mask_i

    dmf_i = jac_i * (drho_i * xid_i0 + rho_i0 * dxid_i) * mask_i
    df_rho = colop(g["diff_i2n"], dmf_i) * inv_jac
    dpf_i = jac_i * (drt_i * xid_i0 + rt_i0 * dxid_i) * mask_i
    df_rt = colop(g["diff_i2n"], dpf_i) * inv_jac

    dpgf = (ddpi_i * rt_i0 / rho_i0 + dpi_i0 * drt_i / rho_i0
            - dpi_i0 * rt_i0 * drho_i / (rho_i0 * rho_i0))
    df_w = dpgf * mask_i

    return jnp.concatenate([df_rt, df_w, df_rho], axis=-1)


def _extract_fast_bands(fast_jvp, x_shape, dtype, q, perm, inv_perm):
    """Band diagonals of L_v via (2q+1)-coloring of the fast JVP.

    Returns (n, 2q+1, ncol) in the interleaved ordering (same layout as
    ``vertical_banded.extract_bands_t``).
    """
    import numpy as np
    ncol, n = x_shape
    b = 2 * q + 1
    cols = jnp.arange(n)
    seeds = jnp.stack(
        [jnp.broadcast_to((cols % b == c).astype(dtype), (ncol, n))
         for c in range(b)])
    jvs = fast_jvp(seeds[:, :, inv_perm])[:, :, perm]
    stacked = jnp.swapaxes(jvs, 1, 2)                 # (b, n, ncol)

    rows = np.arange(n)
    band_rows = []
    for d in range(b):
        col_idx = rows + d - q
        color = np.mod(col_idx, b)
        valid = (col_idx >= 0) & (col_idx < n)
        sel = stacked[jnp.asarray(color), jnp.asarray(rows)]
        band_rows.append(sel * jnp.asarray(valid, dtype=dtype)[:, None])
    return jnp.stack(band_rows, axis=1)               # (n, b, ncol)


def _hflux_div_linear(geom, q0, du, dv):
    """Linearized horizontal flux divergence -div(J q0 u'(du,dv))/J.

    The acoustic-loop horizontal mass/rhotheta flux increments
    (``PerformAcousticLoop`` nodal mass/pressure updates): increment
    winds against the base-state density/rhotheta.
    """
    nea, neb, p = geom.nea, geom.neb, geom.p
    da, db = geom.delta_a, geom.delta_b
    c2 = geom.con2d
    con_u = c2[..., 0, 0, None] * du + c2[..., 0, 1, None] * dv
    con_v = c2[..., 1, 0, None] * du + c2[..., 1, 1, None] * dv
    div = sem.weak_div(geom.jac3d * con_u * q0, geom.jac3d * con_v * q0,
                       geom.stiff, nea, neb, p, da, db)
    return -div / geom.jac3d


def make_acoustic_loop(cfg: ModelConfig, geom, q: int,
                       beta_s: float = 0.1, beta_d: float = 0.1,
                       nsub: int = 3):
    """Returns acoustic_loop(state_eval, tend, dt_s) -> increment pytree.

    ``nsub`` fixed acoustic subcycles of dt_s/nsub each (the reference
    hardcodes 3, SplitExplicitDynamics.cpp:2244-2271); ``beta_s``
    off-centers the vertical implicit solve; ``beta_d`` forward-weights
    the pressure increment for divergence damping.
    """
    constants = cfg.constants
    nz = geom.nz
    nea, neb, p = geom.nea, geom.neb, geom.p
    da, db = geom.delta_a, geom.delta_b
    perm = jnp.asarray(interleave_perm(nz))
    inv_perm = jnp.argsort(perm)

    def acoustic_loop(state, tend, dt_s):
        dtau = dt_s / nsub
        ts_i = dtau * 0.5 * (1.0 + beta_s)    # implicit weight
        ts_e = dtau * 0.5 * (1.0 - beta_s)    # explicit weight

        x0, aux, gmats, (P, A, B) = nonhydro._implicit_aux(state, geom)
        ncol = P * A * B

        def fast_jvp(t):
            return fast_column_multi_jvp(x0, aux, gmats, constants, nz, t)

        bands_L = _extract_fast_bands(
            fast_jvp, x0.shape, x0.dtype, q, perm, inv_perm)
        n = 3 * nz + 1
        eye = jnp.zeros((n, 2 * q + 1, 1), x0.dtype).at[:, q, :].set(1.0)
        bands_A = eye + ts_i * bands_L

        theta0 = state["Rt"] / state["Rho"]
        pi0 = nonhydro.exner_from_rhotheta(state["Rt"], constants)
        dpi_drt0 = ((constants.Rd / (constants.Cp - constants.Rd))
                    * pi0 / state["Rt"])

        def flatcol(f):         # (P,A,B,nz*) -> (ncol, nz*)
            return f.reshape(ncol, f.shape[-1])

        t_col = jnp.concatenate(
            [flatcol(tend["Rt"]), flatcol(tend["W"]),
             flatcol(tend["Rho"])], axis=-1)          # (ncol, n)
        wmask_col = jnp.concatenate(
            [jnp.ones(nz), jnp.ones(nz + 1).at[0].set(0.0).at[-1].set(0.0),
             jnp.ones(nz)]).astype(x0.dtype)

        zero = {
            "U": jnp.zeros_like(state["U"]),
            "V": jnp.zeros_like(state["V"]),
            "Rt": jnp.zeros_like(state["Rt"]),
            "W": jnp.zeros_like(state["W"]),
            "Rho": jnp.zeros_like(state["Rho"]),
        }

        def subcycle(carry, _):
            inc, rt_prev = carry
            # 1. forward-weighted pressure increment (divergence damping)
            rt_fw = (1.0 + beta_d) * inc["Rt"] - beta_d * rt_prev
            dpi = dpi_drt0 * rt_fw
            dpi_a, dpi_b = sem.deriv_both(dpi, geom.deriv, nea, neb, p,
                                          da, db)
            # 2. horizontal momentum increment (covariant form: the PGF
            #    is -theta d_a(pi), no metric raising needed)
            u_new = inc["U"] + dtau * (tend["U"] - theta0 * dpi_a)
            if geom.is_xz:
                v_new = inc["V"]
            else:
                v_new = inc["V"] + dtau * (tend["V"] - theta0 * dpi_b)

            # 3. horizontal flux divergence of the increment winds
            dh_rho = _hflux_div_linear(geom, state["Rho"], u_new, v_new)
            dh_rt = _hflux_div_linear(geom, state["Rt"], u_new, v_new)

            # 4. vertical implicit solve for (Rt', W', Rho')
            x_inc = jnp.concatenate(
                [flatcol(inc["Rt"]), flatcol(inc["W"]),
                 flatcol(inc["Rho"])], axis=-1)       # (ncol, n)
            lv_x = fast_jvp(x_inc[None])[0]
            dh_col = jnp.concatenate(
                [flatcol(dh_rt), jnp.zeros((ncol, nz + 1), x0.dtype),
                 flatcol(dh_rho)], axis=-1)
            rhs = (x_inc + dtau * (t_col + dh_col) - ts_e * lv_x)
            rhs = rhs * wmask_col[None, :]
            rhs_t = rhs[:, perm].T                    # (n, ncol)
            sol_t = banded_solve_t(bands_A, rhs_t, q)
            sol = sol_t.T[:, inv_perm]                # (ncol, n)

            new = {
                "U": u_new, "V": v_new,
                "Rt": sol[:, :nz].reshape(P, A, B, nz),
                "W": sol[:, nz:2 * nz + 1].reshape(P, A, B, nz + 1),
                "Rho": sol[:, 2 * nz + 1:].reshape(P, A, B, nz),
            }
            return (new, inc["Rt"]), None

        (inc, _), _ = jax.lax.scan(
            subcycle, (zero, zero["Rt"]), None, length=nsub)
        out = dict(inc)
        if "Tracers" in tend:
            out["Tracers"] = dt_s * tend["Tracers"]
        return out

    return acoustic_loop


def make_spex_step(cfg: ModelConfig, geom, dss_state, ref_state=None):
    """(first_step, step) for the split-explicit scheme.

    Matches the Strang-stepper interface (carry unused) so it can slot
    into ``Model``/``make_nh_step``.  Macro scheme: KGU35 over full
    tendencies with 3 acoustic subcycles per stage
    (TimestepSchemeSplitExp.cpp:76-123), then the nu4 hyperdiffusion
    tail (StepAfterSubCycle).
    """
    from ..config import ExplicitSubScheme
    constants = cfg.constants
    dt = cfg.dt
    q = nonhydro.estimate_bandwidth(geom, constants)
    acoustic_loop = make_acoustic_loop(cfg, geom, q)

    def full_tendency(s):
        tend = nonhydro.horizontal_tendency(s, geom, constants)
        vtend = nonhydro.vertical_explicit_tendency(s, geom, constants)
        for k, v in vtend.items():
            tend[k] = tend[k] + v
        # penalty upwinding of horizontal winds (VerticalDynamics
        # StepExplicit) as a tendency
        vinc = nonhydro.vertical_explicit_increment(s, geom, 1.0)
        tend["U"] = tend["U"] + vinc["U"]
        tend["V"] = tend["V"] + vinc["V"]
        return dss_state(tend)

    # No-flux lateral walls: SPEX does not thread the Strang stepper's
    # per-instance halo shadows, so enforce u^a/u^b = 0 at the walls
    # directly after DSS (the clean SEM treatment; documented deviation
    # from the reference's halo-averaging quirk).
    noflux_x = getattr(geom, "bc_x", "periodic") == "noflux"
    noflux_y = getattr(geom, "bc_y", "periodic") == "noflux"

    def post(upd):
        upd = dss_state(upd)
        if noflux_x:
            from ..grid.cartesian import apply_noflux_x
            upd = apply_noflux_x(upd, geom)
        if noflux_y:
            from ..grid.cartesian import apply_noflux_y
            upd = apply_noflux_y(upd, geom)
        return upd

    def substage(base, ueval, dt_s):
        tend = full_tendency(ueval)
        inc = acoustic_loop(ueval, tend, dt_s)
        upd = jax.tree_util.tree_map(lambda a, b: a + b, base, inc)
        upd = nonhydro.apply_w_boundary(upd, geom)
        return post(upd)

    @jax.jit
    def first_step(state):
        u4 = erk_substep(ExplicitSubScheme.KGU35, state, dt, substage)
        u1 = hyperdiff.step_after_subcycle_nh(u4, dt, cfg, geom,
                                              dss_state, ref_state)
        if noflux_x:
            from ..grid.cartesian import apply_noflux_x
            u1 = apply_noflux_x(u1, geom)
        if noflux_y:
            from ..grid.cartesian import apply_noflux_y
            u1 = apply_noflux_y(u1, geom)
        zero = jax.tree_util.tree_map(lambda a: a * 0.0, u1)
        return u1, zero

    @jax.jit
    def step(state, carry):
        return first_step(state)

    return first_step, step
