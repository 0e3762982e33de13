"""Mesh-distributed z-first fast engine: sharded == single-device.

The round-4 requirement that the perf path and the distribution path be
the SAME code: ``fast.make_fast_step(..., mesh=...)`` runs the z-first
engine per-shard inside one shard_map with the statically-routed
ppermute DSS (``fast/mesh_dss.py``) as the only communication.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

from tempestmodel_tpu.config import ModelConfig, GridKind
from tempestmodel_tpu.models import nh_model
from tempestmodel_tpu import fast
from tempestmodel_tpu.fast import engine, mesh_dss
from tempestmodel_tpu.testcases.nonhydro_sphere import (
    BaroclinicWaveUMJS, MountainWaveSphere)


def _mesh(mx, my):
    return Mesh(np.array(jax.devices()[:mx * my]).reshape(mx, my),
                ("x", "y"))


def _sphere_setup(ne=4, nz=6, **kw):
    tc = BaroclinicWaveUMJS(pert="exp")
    cfg = ModelConfig(grid_kind=GridKind.CUBED_SPHERE, ne=ne, order=4,
                      nz=nz, ztop=tc.ztop, dt=100.0, hyperdiffusion=True,
                      nu_scalar=1e15, nu_div=1e15, nu_vort=1e15,
                      vertical_solver="banded", dtype=jnp.float64, **kw)
    geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
    state = tc.initial_state(geom, cfg.constants, dtype=jnp.float64)
    return cfg, geom, state


def _max_rel(a_dict, b_dict):
    return max(float(jnp.max(jnp.abs(a_dict[k] - b_dict[k]))
                     / (jnp.max(jnp.abs(b_dict[k])) + 1e-300))
               for k in engine.FIELDS)


@pytest.mark.parametrize("mx,my", [(2, 4), (2, 2), (1, 4), (1, 1)])
def test_mesh_dss_equals_single_device(mx, my):
    """The routed-exchange DSS equals the single-device Pallas DSS on
    every mesh shape (including degenerate 1x1 = all-local routing)."""
    cfg, geom, _ = _sphere_setup()
    fg = engine.build_fast_geometry(geom, dtype=jnp.float64)
    nz, A = fg.nz, fg.A
    rng = np.random.default_rng(0)
    d = {k: jnp.asarray(rng.standard_normal(
        (nz + (1 if k == "W" else 0), 6, A, A)))
        for k in engine.FIELDS}
    ref = engine.apply_dss(d, fg)

    mesh = _mesh(mx, my)
    dssfn = mesh_dss.make_state_dss_mesh(
        fg.dss_links, np.asarray(fg.e_rot), mx, my, A, fg.p, nz)
    sspec = {k: P(None, None, "x", "y") for k in engine.FIELDS}
    f = jax.jit(jax.shard_map(
        lambda s, w: dssfn(s, w), mesh=mesh,
        in_specs=(sspec, P(None, "x", "y")), out_specs=sspec))
    sh = {k: jax.device_put(v, NamedSharding(mesh,
                                             P(None, None, "x", "y")))
          for k, v in d.items()}
    w = jax.device_put(fg.inv_mult, NamedSharding(mesh, P(None, "x", "y")))
    with mesh:
        out = f(sh, w)
    assert _max_rel(out, ref) < 1e-13


def test_edge_routing_is_point_to_point():
    """Static routing invariants: every destination-edge node is covered
    exactly once per link, and the exchanged volume is O(surface) — the
    24 lines are moved once, not replicated mesh-wide (the psum
    formulation moves ~2 * 24*A per DEVICE; routed moves 24*A total
    minus the locally-satisfied segments)."""
    cfg, geom, _ = _sphere_setup()
    A = cfg.ne * cfg.order
    for mx, my in [(2, 4), (2, 2), (1, 4)]:
        local, rounds = mesh_dss.build_edge_routing(geom.edge_meta,
                                                    mx, my, A)
        n_links = len(geom.edge_meta)
        cover = np.zeros((n_links, A), np.int32)
        for m in local:
            cover[m.link, m.g0:m.g1] += 1
        for rnd in rounds:
            srcs = [k[0] for k, _ in rnd]
            dsts = [k[1] for k, _ in rnd]
            assert len(set(srcs)) == len(srcs), "round reuses a source"
            assert len(set(dsts)) == len(dsts), "round reuses a dest"
            for _, ms in rnd:
                for m in ms:
                    cover[m.link, m.g0:m.g1] += 1
        assert (cover == 1).all(), "edge-line coverage not exactly once"
        moved = sum(m.src_hi - m.src_lo for r in rounds for _, ms in r
                    for m in ms)
        assert moved <= n_links * A
        # routed total across ALL devices is below what the psum
        # formulation sends per single device (2*(n-1)/n * 24A each way)
        assert moved < 2 * n_links * A * (mx * my - 1) / (mx * my)


@pytest.mark.parametrize("mx,my", [(2, 4), (2, 2), (1, 4)])
def test_mesh_fast_engine_collective_bytes(mx, my):
    """The compiled mesh step emits ONLY collective-permutes — no
    all-reduce / all-gather of anything: the edge exchange is routed
    point-to-point (the reference's per-patch-pair ExchangeBuffers,
    ``Connectivity.h:67``) — and the total permute volume equals the
    EXACT static routing prediction: 7 DSS calls (5 RK stages + the two
    nu4 passes) x ``mesh_dss.expected_exchange_bytes`` (round-4 VERDICT
    weak #6: the old <1.5x-state bound could not catch a 2x exchange
    regression)."""
    from tempestmodel_tpu.parallel.analyze import collective_report
    cfg, geom, state = _sphere_setup(ne=4, nz=6)
    mesh = _mesh(mx, my)
    first_step, _ = fast.make_fast_step(cfg, geom, mesh=mesh)
    X = fast.pack_state(state)
    rep = collective_report(first_step, (X,), mesh,
                            P(None, None, "x", "y"))
    assert "all-reduce" not in rep.counts, rep.counts
    assert "all-gather" not in rep.counts, rep.counts
    total = sum(rep.bytes_.values())
    A = cfg.ne * cfg.order
    ktot = 5 * cfg.nz + 1
    per_call = mesh_dss.expected_exchange_bytes(
        geom.edge_meta, mx, my, A, ktot, itemsize=8)
    assert total == 7 * per_call, (total, 7 * per_call, rep.counts)


@pytest.mark.slow
def test_mesh_fast_engine_matches_single_device():
    cfg, geom, state = _sphere_setup(ne=4, nz=6)
    nsteps = 3
    fs, st = fast.make_fast_step(cfg, geom)
    X, c = fs(fast.pack_state(state))
    for _ in range(nsteps - 1):
        X, c = st(X, c)

    mesh = _mesh(2, 4)
    fsm, stm = fast.make_fast_step(cfg, geom, mesh=mesh)
    spec = NamedSharding(mesh, P(None, None, "x", "y"))
    Xm = {k: jax.device_put(v, spec)
          for k, v in fast.pack_state(state).items()}
    with mesh:
        Xm, cm = fsm(Xm)
        for _ in range(nsteps - 1):
            Xm, cm = stm(Xm, cm)
    assert _max_rel(Xm, X) < 1e-11


@pytest.mark.slow
def test_mesh_fast_engine_rayleigh_topography():
    """Mesh engine with terrain + Rayleigh damping (MountainWaveSphere):
    the damping reference terms ride through shard_map sharded."""
    tc = MountainWaveSphere()
    cfg = ModelConfig(grid_kind=GridKind.CUBED_SPHERE, ne=4, order=4,
                      nz=8, ztop=tc.ztop, dt=50.0, hyperdiffusion=True,
                      nu_scalar=1e14, nu_div=1e14, nu_vort=1e14,
                      rayleigh_damping=True,
                      vertical_solver="banded", dtype=jnp.float64)
    geom = nh_model.build_nh_sphere_geometry(
        cfg, topography=tc.topography, ztop=tc.ztop,
        rayleigh=tc.rayleigh_strength)
    state = tc.initial_state(geom, cfg.constants, dtype=jnp.float64)
    ref_state = tc.reference_state(geom, cfg.constants,
                                   dtype=jnp.float64)

    fs, st = fast.make_fast_step(cfg, geom, ref_state=ref_state)
    X, c = fs(fast.pack_state(state))
    X, c = st(X, c)

    mesh = _mesh(2, 2)
    fsm, stm = fast.make_fast_step(cfg, geom, ref_state=ref_state,
                                   mesh=mesh)
    spec = NamedSharding(mesh, P(None, None, "x", "y"))
    Xm = {k: jax.device_put(v, spec)
          for k, v in fast.pack_state(state).items()}
    with mesh:
        Xm, cm = fsm(Xm)
        Xm, cm = stm(Xm, cm)
    assert _max_rel(Xm, X) < 1e-11


def test_fast_engine_supported_mesh_predicate():
    cfg, _, _ = _sphere_setup()
    mesh = _mesh(2, 4)
    assert engine.fast_engine_supported(cfg, mesh=mesh)
    # ne*p = 16 not divisible into p-multiples by mx=3 is impossible to
    # build here (devices are 8); instead check a my that violates
    # element divisibility: my=8 -> A/my = 2 < p
    mesh_bad = Mesh(np.array(jax.devices()[:8]).reshape(1, 8), ("x", "y"))
    assert not engine.fast_engine_supported(cfg, mesh=mesh_bad)


@pytest.mark.parametrize("mx,my", [(2, 4), (1, 4), (2, 2)])
def test_overlap_schedule_bit_equal(mx, my):
    """The overlap-scheduled DSS (collectives issued from line-only
    compute before interior work — the reference's Isend-early /
    Wait-late, ``Grid.cpp:627-665``) is BITWISE equal to the inline
    schedule."""
    cfg, geom, _ = _sphere_setup()
    fg = engine.build_fast_geometry(geom, dtype=jnp.float64)
    nz, A = fg.nz, fg.A
    rng = np.random.default_rng(3)
    d = {k: jnp.asarray(rng.standard_normal(
        (nz + (1 if k == "W" else 0), 6, A, A)))
        for k in engine.FIELDS}
    mesh = _mesh(mx, my)
    sspec = {k: P(None, None, "x", "y") for k in engine.FIELDS}
    outs = []
    for overlap in (False, True):
        dssfn = mesh_dss.make_state_dss_mesh(
            fg.dss_links, np.asarray(fg.e_rot), mx, my, A, fg.p, nz,
            overlap=overlap)
        f = jax.jit(jax.shard_map(
            lambda s, w: dssfn(s, w), mesh=mesh,
            in_specs=(sspec, P(None, "x", "y")), out_specs=sspec))
        sh = {k: jax.device_put(v, NamedSharding(
            mesh, P(None, None, "x", "y"))) for k, v in d.items()}
        w = jax.device_put(fg.inv_mult,
                           NamedSharding(mesh, P(None, "x", "y")))
        with mesh:
            outs.append(f(sh, w))
    for k in engine.FIELDS:
        a = np.asarray(outs[0][k])
        b = np.asarray(outs[1][k])
        assert np.array_equal(a, b), \
            f"{k}: overlap schedule differs (max {np.max(np.abs(a - b))})"


@pytest.mark.slow
def test_overlap_engine_step_equal():
    """Full mesh step with halo_overlap=True equals the inline-schedule
    step to roundoff (same trajectory through the whole Strang step)."""
    cfg, geom, state = _sphere_setup(ne=4, nz=6)
    mesh = _mesh(2, 4)
    spec = NamedSharding(mesh, P(None, None, "x", "y"))
    res = []
    for overlap in (False, True):
        c2 = cfg.with_(halo_overlap=overlap)
        fsm, stm = fast.make_fast_step(c2, geom, mesh=mesh)
        Xm = {k: jax.device_put(v, spec)
              for k, v in fast.pack_state(state).items()}
        with mesh:
            Xm, cm = fsm(Xm)
            Xm, cm = stm(Xm, cm)
        res.append(Xm)
    assert _max_rel(res[1], res[0]) == 0.0


@pytest.mark.slow
def test_mesh_fast_engine_tracers():
    """The mesh fast engine carries tracers: species ride the packed
    DSS payload (dynamic field layout in fast/mesh_dss), the banded
    tracer column update runs shard-local, and the trajectory matches
    the single-device fast engine."""
    from tempestmodel_tpu.testcases.dcmip2016 import MoistBaroclinicWave
    tc = MoistBaroclinicWave()
    cfg = ModelConfig(grid_kind=GridKind.CUBED_SPHERE, ne=4, order=4,
                      nz=8, ztop=tc.ztop, dt=100.0, hyperdiffusion=True,
                      nu_scalar=1e15, nu_div=1e15, nu_vort=1e15,
                      vertical_solver="banded", dtype=jnp.float64)
    geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
    state = tc.initial_state(geom, cfg.constants, dtype=jnp.float64)
    ntr = state["Tracers"].shape[0]

    fs, st = fast.make_fast_step(cfg, geom)
    X, c = fs(fast.pack_state(state))
    X, c = st(X, c)

    mesh = _mesh(2, 4)
    fsm, stm = fast.make_fast_step(cfg, geom, mesh=mesh, ntracers=ntr)
    spec = NamedSharding(mesh, P(None, None, "x", "y"))
    Xm = {k: jax.device_put(v, spec)
          for k, v in fast.pack_state(state).items()}
    with mesh:
        Xm, cm = fsm(Xm)
        Xm, cm = stm(Xm, cm)
    err = max(float(jnp.max(jnp.abs(Xm[k] - X[k]))
                    / (jnp.max(jnp.abs(X[k])) + 1e-300)) for k in Xm)
    assert err < 1e-11, err


@pytest.mark.slow
def test_mesh_fast_engine_tracers_rayleigh():
    """Mesh + tracers + Rayleigh damping together: the fused Rayleigh
    finish must only touch the five dynamics fields (tracers are never
    damped) — regression for the KeyError the advisor reproduced when
    the mesh dss_fn damped the full DSS payload."""
    tc = MountainWaveSphere()
    cfg = ModelConfig(grid_kind=GridKind.CUBED_SPHERE, ne=4, order=4,
                      nz=8, ztop=tc.ztop, dt=50.0, hyperdiffusion=True,
                      nu_scalar=1e14, nu_div=1e14, nu_vort=1e14,
                      rayleigh_damping=True,
                      vertical_solver="banded", dtype=jnp.float64)
    geom = nh_model.build_nh_sphere_geometry(
        cfg, topography=tc.topography, ztop=tc.ztop,
        rayleigh=tc.rayleigh_strength)
    state = dict(tc.initial_state(geom, cfg.constants, dtype=jnp.float64))
    ref_state = tc.reference_state(geom, cfg.constants, dtype=jnp.float64)
    A = cfg.ne * cfg.order
    rng = np.random.default_rng(7)
    ntr = 2
    state["Tracers"] = jnp.asarray(
        np.abs(rng.standard_normal((ntr, 6, A, A, cfg.nz))) * 1e-3)

    fs, st = fast.make_fast_step(cfg, geom, ref_state=ref_state)
    X, c = fs(fast.pack_state(state))
    X, c = st(X, c)

    mesh = _mesh(2, 2)
    fsm, stm = fast.make_fast_step(cfg, geom, ref_state=ref_state,
                                   mesh=mesh, ntracers=ntr)
    spec = NamedSharding(mesh, P(None, None, "x", "y"))
    Xm = {k: jax.device_put(v, spec)
          for k, v in fast.pack_state(state).items()}
    with mesh:
        Xm, cm = fsm(Xm)
        Xm, cm = stm(Xm, cm)
    err = max(float(jnp.max(jnp.abs(Xm[k] - X[k]))
                    / (jnp.max(jnp.abs(X[k])) + 1e-300)) for k in Xm)
    assert err < 1e-11, err


@pytest.mark.slow
def test_model_driver_mesh():
    """Model(mesh=...) runs the fast engine distributed and matches the
    single-device driver (the reference's Grid::DistributePatches analog
    at driver level)."""
    from tempestmodel_tpu.model import Model
    from tempestmodel_tpu.config import EquationSet
    tc = BaroclinicWaveUMJS(pert="exp")
    base = dict(equation_set=EquationSet.PRIMITIVE_NONHYDRO,
                grid_kind=GridKind.CUBED_SPHERE, ne=4, order=4, nz=8,
                ztop=tc.ztop, dt=200.0, hyperdiffusion=True,
                nu_scalar=1e15, nu_div=1e15, nu_vort=1e15,
                vertical_solver="banded", dtype=jnp.float64)
    mesh = _mesh(2, 4)
    m_mesh = Model(ModelConfig(**base), testcase=tc, mesh=mesh)
    assert m_mesh._fast
    m_mesh.go(nsteps=2)
    m_single = Model(ModelConfig(**base), testcase=tc)
    m_single.go(nsteps=2)
    err = max(float(jnp.max(jnp.abs(jnp.asarray(m_mesh.state[k])
                                    - m_single.state[k]))
                    / (jnp.max(jnp.abs(m_single.state[k])) + 1e-300))
              for k in m_single.state)
    assert err < 1e-11, err


def _pallas_call_sites(jaxpr, inside=False):
    """For every pallas_call in ``jaxpr`` (nested jaxprs included):
    whether it sits inside a shard_map."""
    from jax.extend.core import ClosedJaxpr, Jaxpr
    sites = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            sites.append(inside)
            continue
        for v in eqn.params.values():
            for x in (v if isinstance(v, (tuple, list)) else (v,)):
                sub = x.jaxpr if isinstance(x, ClosedJaxpr) else x
                if isinstance(sub, Jaxpr):
                    sites += _pallas_call_sites(
                        sub, inside or eqn.primitive.name == "shard_map")
    return sites


@pytest.mark.parametrize("fuse", [True, False], ids=["z-first", "reference"])
def test_banded_kernel_never_under_gspmd(monkeypatch, fuse):
    """On a 2x2 mesh with the GPU's solver choice, the Triton banded
    solve appears only inside the z-first engine's shard_map, where each
    card solves its own columns.  GSPMD cannot partition a pallas_call:
    it would gather the bands onto every card.  The reference-layout
    engine runs the lax.scan solve, which XLA partitions."""
    from tempestmodel_tpu import backend
    from tempestmodel_tpu.model import Model
    from tempestmodel_tpu.config import EquationSet
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    tc = BaroclinicWaveUMJS(pert="exp")
    cfg = ModelConfig(equation_set=EquationSet.PRIMITIVE_NONHYDRO,
                      grid_kind=GridKind.CUBED_SPHERE, ne=4, order=4, nz=6,
                      ztop=tc.ztop, dt=200.0, hyperdiffusion=True,
                      nu_scalar=1e15, nu_div=1e15, nu_vort=1e15,
                      dtype=jnp.float32, fuse_pallas=fuse)
    m = Model(cfg, testcase=tc, mesh=_mesh(2, 2))
    assert m._fast == fuse
    x = fast.pack_state(m.state) if fuse else m.state
    first = jax.make_jaxpr(m._first_step)(x)
    carry = jax.eval_shape(m._first_step, x)[1]
    step = jax.make_jaxpr(m._step)(x, carry)
    sites = (_pallas_call_sites(first.jaxpr)
             + _pallas_call_sites(step.jaxpr))
    if fuse:
        assert sites and all(sites), sites
    else:
        assert sites == []
