#!/usr/bin/env python3
"""Proof that the z-first engine runs on an NVIDIA GPU.

    python chip_smoke.py          # one GPU: phases (a)-(c)
    python chip_smoke.py --four   # four GPUs: phase (d) only

(a) the card and the software: JAX version, devices, name and power limit.
(b) the batched banded solve of the implicit step, compiled for the card
    at the flagship widths (n = 3*30+1 rows, the Newton bandwidth, 86,400
    columns; and the tracer form with R = 3 right-hand sides), against
    the ``lax.scan`` reference on the card and a float64 NumPy solve of a
    sample of columns; device time of both from a profiler trace.
(c) the three configurations ``bench.py`` carries, through ``Model`` and
    ``go()``: UMJS baroclinic wave ne30 p4 L30, DCMIP2016 moist wave with
    3 tracers, Schar x-z slice nex100 p4 L40, all float32.  Each runs
    COMPARE_STEPS steps on the z-first engine and on the reference-layout
    engine (``fuse_pallas=False``, whose banded solve is the
    ``lax.scan``); the two must agree within the float32 tolerance
    below.  The z-first engine runs on to STEPS steps, every field
    finite.  Then one short CLI run.
(d) ``--four``: the flagship on a 2x2 device mesh (routed ppermute DSS,
    halo overlap), MESH_STEPS steps, against the single-card trajectory
    of the same engine; each card must hold a quarter of the state.

Compilation dominates the run time: every engine compiles its first
step and its steady-state step, and nothing else.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; any failed
phase exits non-zero and prints no such line.  Exits non-zero at once
when JAX finds no GPU, or when the package is not next to this script.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# Float32 tolerances, relative to each field's max |value|:
# - banded solve vs the float64 solve: no pivoting, but the I/dt
#   diagonal keeps the systems well conditioned, so the error is f32
#   round-off (eps 6e-8) grown by ~n row operations: order 1e-5;
# - kernel vs scan: the same operations in the same order, only FMA
#   contraction and division rounding may differ;
# - engine vs engine after STEPS steps: two association orders of the
#   same steps (the two engines agree to 1e-11 in float64, tests/); f32
#   round-off grows through 5 RK stages, the nu4 tail and the Newton
#   solve of every step.  U, V and W are measured against at least the
#   common velocity scale max(|U|, |V|): W of a balanced state is
#   itself O(1e-2) m/s, mostly f32 noise of the hydrostatic balance, so
#   its own max is no scale.  On the H100 in f32 the engines differed by
#   at most 3e-4 (U/V) after 6 steps at ne30; 1e-3 leaves room for that
#   growth.  A semantic fault fails it: with the kinetic-energy gradient
#   or the curl term left out of the z-first W equation, the UMJS check
#   at ne6 on the CPU (f32, 6 steps) reads Rho 1.6e-3, Rt 1.8e-3 and
#   U/V 2.2-2.4e-3 (clean: 2e-5, 2e-6, 1e-4); W itself moves only to
#   1.4-1.7e-5 of the velocity scale (clean 2e-7), since the fault
#   spreads through the whole column.  A 4e-4 error in g (9.81 for
#   9.80616) stays below it (3.4e-4).
TOL_SOLVE_F64 = 1e-4
TOL_KERNEL_SCAN = 1e-5
TOL_ENGINES = 1e-3
STEPS = 6
MESH_STEPS = 3
# Steps at which the engines are compared; the z-first engine then runs
# on to STEPS.  The reference-layout engine compiles each of its two
# step functions in ~200 s on an H100 host, and a cold run must end in
# 1200 s (6-step comparisons everywhere took 1064 s).  The moist wave
# shares every layer with UMJS but the tracers, whose whole path (the
# advection, DSS, multi-RHS implicit solve and filter) runs in its
# first step, so it is compared there.
COMPARE_STEPS = {"umjs": STEPS, "dcmip_moist": 1, "schar_xz": STEPS}

# XLA's GPU compiler, split into parallel LLVM modules: the reference-
# layout engine compiles into thousands of kernels (on a 16-core H100
# host its first step compiled in 182 s this way)
COMPILE_FLAGS = ("--xla_gpu_enable_llvm_module_compilation_parallelism=true",
                 "--xla_gpu_force_compilation_parallelism="
                 f"{min(os.cpu_count() or 1, 16)}")


def set_compile_flags():
    """Add COMPILE_FLAGS to XLA_FLAGS (before JAX starts its backend)."""
    flags = os.environ.get("XLA_FLAGS", "").split()
    names = {f.split("=")[0] for f in flags}
    flags += [f for f in COMPILE_FLAGS if f.split("=")[0] not in names]
    os.environ["XLA_FLAGS"] = " ".join(flags)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def rel_err(a, b):
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# (b) banded solve
# ---------------------------------------------------------------------------

def phase_banded(ne=30, nz=30, sample=64):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from tempestmodel_tpu import backend
    from tempestmodel_tpu.config import ModelConfig, GridKind
    from tempestmodel_tpu.fast import engine as fe, implicit as fimp
    from tempestmodel_tpu.fast import tracers as ftr
    from tempestmodel_tpu.models import nh_model, nonhydro
    from tempestmodel_tpu.models.vertical_banded import (
        banded_solve_t, banded_solve_multi_t)
    from tempestmodel_tpu.ops.pallas_banded import (
        banded_solve_pallas, banded_solve_multi_pallas)
    from tempestmodel_tpu.testcases.dcmip2016 import MoistBaroclinicWave
    from tempestmodel_tpu.utils.devprof import trace_call

    tc = MoistBaroclinicWave()
    cfg = ModelConfig(grid_kind=GridKind.CUBED_SPHERE, ne=ne, order=4,
                      nz=nz, ztop=tc.ztop, dt=100.0, dtype=jnp.float32)
    geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
    state = tc.initial_state(geom, cfg.constants, dtype=jnp.float32)
    fg = fe.build_fast_geometry(geom, dtype=jnp.float32)
    q = nonhydro.estimate_bandwidth(geom, cfg.constants)
    statics = nonhydro.band_assembly_statics(geom, q)
    d = fe.pack_state(state)
    dt = 0.5 * cfg.dt

    @jax.jit
    def newton_system(d):
        x0, aux = fimp._prep_aux(d, fg)
        f = fimp._interleave(*fimp.residual_lor(x0, x0, aux, fg,
                                                cfg.constants, dt), nz)
        return fimp.assemble_bands(x0, aux, fg, statics, cfg.constants,
                                   dt), f

    @jax.jit
    def tracer_system(d):
        # the initial state is at rest vertically: give the implicit
        # tracer update a vertical velocity of O(0.1 m/s) from a seed
        w = d["W"] + 0.1 * jax.random.normal(jax.random.key(0),
                                             d["W"].shape, d["W"].dtype)
        _, bands, F, _ = ftr.tracer_system(d, w, fg, dt)
        return bands, F

    q_tr = ftr._tracer_band_statics(fg)["q"]
    cases = [
        ("main", q, newton_system(d),
         jax.jit(lambda b, f: banded_solve_pallas(b, f, q)),
         jax.jit(lambda b, f: banded_solve_t(b, f, q))),
        ("tracers", q_tr, tracer_system(d),
         jax.jit(lambda b, f: banded_solve_multi_pallas(b, f, q_tr)),
         jax.jit(lambda b, f: banded_solve_multi_t(b, f, q_tr))),
    ]
    rng = np.random.default_rng(0)
    ok = True
    for name, qq, (bands, rhs), kern, scan in cases:
        n, b, ncol = bands.shape
        x_k = kern(bands, rhs)
        x_s = scan(bands, rhs)
        # float64 dense solve of a sample of columns of the same bands
        cols = rng.choice(ncol, size=min(sample, ncol), replace=False)
        B = np.asarray(bands, np.float64)[:, :, cols]
        Rh = np.asarray(rhs, np.float64).reshape(n, -1, ncol)[:, :, cols]
        X64 = np.zeros_like(Rh)
        for j in range(len(cols)):
            A = np.zeros((n, n))
            for dd in range(b):
                i = np.arange(n)
                c = i + dd - qq
                m = (c >= 0) & (c < n)
                A[i[m], c[m]] = B[i[m], dd, j]
            X64[:, :, j] = np.linalg.solve(A, Rh[:, :, j])
        xk = np.asarray(x_k).reshape(n, -1, ncol)
        e64 = rel_err(xk[:, :, cols], X64)
        eks = rel_err(x_k, x_s)
        finite = bool(np.isfinite(xk).all())
        t_k = trace_call(kern, bands, rhs)
        t_s = trace_call(scan, bands, rhs)
        passed = finite and e64 < TOL_SOLVE_F64 and eks < TOL_KERNEL_SCAN
        ok &= passed
        print(f"(b) banded {name}: n={n} q={qq} R={xk.shape[1]} "
              f"ncol={ncol} finite={finite} "
              f"rel_err_vs_f64={e64:.3e} (tol {TOL_SOLVE_F64:g}) "
              f"rel_err_kernel_vs_scan={eks:.3e} (tol {TOL_KERNEL_SCAN:g}) "
              f"kernel_device_ms={t_k['busy_ms']:.4f} "
              f"kernels={t_k['n_kernels']} "
              f"scan_device_ms={t_s['busy_ms']:.4f} "
              f"scan_kernels={t_s['n_kernels']} "
              f"{'PASS' if passed else 'FAIL'}", flush=True)
    print(f"(b) backend.banded_solver() on {backend.platform()}: "
          f"{backend.banded_solver()}", flush=True)
    return ok


# ---------------------------------------------------------------------------
# (c) the three bench configurations through Model.go()
# ---------------------------------------------------------------------------

def configs(ne=30, nz=30, nex=100, nz_xz=40):
    """name -> (ModelConfig kwargs, testcase factory)."""
    import jax.numpy as jnp
    from tempestmodel_tpu.config import GridKind, EquationSet
    from tempestmodel_tpu.testcases.dcmip2016 import MoistBaroclinicWave
    from tempestmodel_tpu.testcases.nonhydro_sphere import BaroclinicWaveUMJS
    from tempestmodel_tpu.testcases.nonhydro_xz import ScharMountain

    sphere = dict(equation_set=EquationSet.PRIMITIVE_NONHYDRO,
                  grid_kind=GridKind.CUBED_SPHERE, ne=ne, order=4, nz=nz,
                  dt=100.0, hyperdiffusion=True, nu_scalar=1e15,
                  nu_div=1e15, nu_vort=1e15, dtype=jnp.float32)
    schar = ScharMountain
    return {
        "umjs": (sphere, lambda: BaroclinicWaveUMJS(pert="exp")),
        "dcmip_moist": (sphere, MoistBaroclinicWave),
        "schar_xz": (dict(equation_set=EquationSet.PRIMITIVE_NONHYDRO,
                          grid_kind=GridKind.CARTESIAN_XZ, nex=nex, ney=1,
                          order=4, nz=nz_xz, x_extent=schar().x_extent,
                          y_extent=schar().y_extent, dt=0.5,
                          hyperdiffusion=True, nu_scalar=1e7, nu_div=1e7,
                          nu_vort=1e7, rayleigh_damping=True,
                          dtype=jnp.float32), schar),
    }


def run_model(kw, make_tc, fast, nsteps, mesh=None, **extra):
    """A ``Model`` of one configuration run ``nsteps`` through ``go()``;
    (model, seconds including compilation).  A z-first model's first
    step is compiled ahead of time, and its ``memory_analysis()`` kept
    on ``model.first_step_memory``."""
    import jax
    from tempestmodel_tpu import fast as fast_engine
    from tempestmodel_tpu.config import ModelConfig
    from tempestmodel_tpu.model import Model
    tc = make_tc()
    cfg = ModelConfig(**dict(kw, ztop=tc.ztop, fuse_pallas=fast, **extra))
    m = Model(cfg, testcase=tc, mesh=mesh)
    if m._fast != fast:
        raise RuntimeError(f"fuse_pallas={fast} but Model chose "
                           f"{'z-first' if m._fast else 'reference'}")
    t0 = time.perf_counter()
    if fast:
        m.first_step_memory = m._first_step.compile(
            fast_engine.pack_state(m.state)).memory_analysis()
    m.go(nsteps=nsteps)
    jax.block_until_ready(m.state)
    return m, time.perf_counter() - t0


def compare_states(a, b):
    """{field: max |a - b| / scale}.  A field's scale is its own max
    |b|; for U, V and W it is at least the common velocity scale
    max(|U|, |V|): on an x-z slice V is driven by round-off alone, and W
    of a balanced state is small, so their own maxima are no scale."""
    import numpy as np
    amax = {k: float(np.max(np.abs(np.asarray(v, np.float64))))
            for k, v in b.items()}
    vel = max(amax["U"], amax["V"])
    out = {}
    for k in b:
        x = np.asarray(a[k], np.float64)
        y = np.asarray(b[k], np.float64)
        scale = max(amax[k], vel) if k in ("U", "V", "W") else amax[k]
        out[k] = float(np.max(np.abs(x - y)) / (scale + 1e-30))
    return out


def within_tolerance(errs):
    return all(e < TOL_ENGINES for e in errs.values())


def all_finite(state):
    import numpy as np
    return all(bool(np.isfinite(np.asarray(v)).all())
               for v in state.values())


def phase_engines(sizes=None):
    """Each configuration on both engines, compared after COMPARE_STEPS
    steps (the first step runs every layer: implicit half-step, 5 RK
    stages with DSS, the nu4 tail, the implicit solve; the later ones
    the steady-state step); the z-first engine then runs on to STEPS."""
    import jax
    ok = True
    for name, (kw, make_tc) in configs(**(sizes or {})).items():
        try:
            n = COMPARE_STEPS[name]
            m_fast, t_fast = run_model(kw, make_tc, fast=True, nsteps=n)
            m_ref, t_ref = run_model(kw, make_tc, fast=False, nsteps=n)
            errs = compare_states(m_fast.state, m_ref.state)
            passed = within_tolerance(errs)
            shapes = {k: tuple(v.shape) for k, v in m_fast.state.items()}
            print(f"(c) {name}: {n} steps, z-first vs reference-layout "
                  f"rel err " + " ".join(f"{k}={e:.3e}"
                                         for k, e in errs.items())
                  + f" (tol {TOL_ENGINES:g}); incl. compile: z-first "
                  f"{t_fast:.1f} s, reference {t_ref:.1f} s; "
                  f"shapes={shapes}", flush=True)
            print(f"(c) {name}: first-step memory_analysis: "
                  f"{m_fast.first_step_memory}", flush=True)
            t0 = time.perf_counter()
            if STEPS > n:
                m_fast.go(nsteps=STEPS - n)
                jax.block_until_ready(m_fast.state)
            fin = all_finite(m_fast.state)
            passed &= fin
            print(f"(c) {name}: z-first after {STEPS} steps finite={fin} "
                  f"({time.perf_counter() - t0:.1f} s after the "
                  f"comparison) {'PASS' if passed else 'FAIL'}", flush=True)
            ok &= passed
        except Exception:
            traceback.print_exc()
            print(f"(c) {name}: FAIL (exception)", flush=True)
            ok = False
    return ok


def phase_cli(resolution=8, levels=10):
    from tempestmodel_tpu import cli
    argv = ["--case", "umjs_pert", "--resolution", str(resolution),
            "--levels", str(levels), "--dt", "300", "--nsteps", "1",
            "--fp32", "--norefstate"]
    print(f"(c) CLI: python -m tempestmodel_tpu {' '.join(argv)}",
          flush=True)
    rc = cli.main(argv)
    print(f"(c) CLI exit code {rc} {'PASS' if rc == 0 else 'FAIL'}",
          flush=True)
    return rc == 0


# ---------------------------------------------------------------------------
# (d) the 2x2 mesh
# ---------------------------------------------------------------------------

def phase_mesh(sizes=None):
    import numpy as np
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) != 4:
        raise RuntimeError(f"--four needs 4 devices, found {len(devs)}")
    mesh = Mesh(np.asarray(devs).reshape(2, 2), ("x", "y"))
    kw, make_tc = configs(**(sizes or {}))["umjs"]
    m_mesh, t_mesh = run_model(kw, make_tc, fast=True, nsteps=MESH_STEPS,
                               mesh=mesh, halo_overlap=True)
    # each card holds a quarter of every field
    total = 0
    quarter = True
    for k, v in m_mesh._fast_state.items():
        shards = v.addressable_shards
        per_dev = {str(s.device): s.data.nbytes for s in shards}
        total += v.nbytes
        quarter &= (len(per_dev) == 4
                    and all(b * 4 == v.nbytes for b in per_dev.values()))
        print(f"(d) {k}: global {tuple(v.shape)}, shard "
              f"{tuple(shards[0].data.shape)}, bytes/device "
              f"{sorted(set(per_dev.values()))}", flush=True)
    print(f"(d) state bytes {total}, per device {total // 4}, "
          f"quarter_each={quarter}", flush=True)
    m_one, t_one = run_model(kw, make_tc, fast=True, nsteps=MESH_STEPS)
    errs = compare_states(jax.device_get(m_mesh.state),
                          jax.device_get(m_one.state))
    # the mesh engine runs the same per-card arithmetic; only the DSS
    # summation order at cross-card edges differs, so the single-card
    # tolerance applies
    passed = quarter and within_tolerance(errs) and all_finite(
        m_mesh.state)
    print(f"(d) 2x2 mesh vs one card after {MESH_STEPS} steps rel err "
          + " ".join(f"{k}={e:.3e}" for k, e in errs.items())
          + f" (tol {TOL_ENGINES:g}); incl. compile: "
          f"mesh {t_mesh:.1f} s, one card {t_one:.1f} s "
          f"{'PASS' if passed else 'FAIL'}", flush=True)
    return passed


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 2x2 mesh phase on four GPUs")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "tempestmodel_tpu")):
        fail("the tempestmodel_tpu package is not next to this script")
    sys.path.insert(0, HERE)
    set_compile_flags()
    import jax
    import tempestmodel_tpu  # noqa: F401  (precision pin, compile cache)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        fail(f"JAX found no GPU (platform {dev.platform!r})")

    # (a)
    print(f"(a) jax {jax.__version__}, devices {jax.devices()}, kind "
          f"{dev.device_kind!r}, XLA_FLAGS {os.environ['XLA_FLAGS']!r}",
          flush=True)
    print(f"(a) nvidia-smi: {gpu_name_and_power()}", flush=True)
    t0 = time.perf_counter()
    if args.four:
        results = {"mesh": phase_mesh()}
    else:
        results = {"banded": phase_banded()}
        print(f"(b) done at {time.perf_counter() - t0:.1f} s", flush=True)
        results["engines"] = phase_engines()
        print(f"(c) engines done at {time.perf_counter() - t0:.1f} s",
              flush=True)
        results["cli"] = phase_cli()
    print(f"phases {results}, {time.perf_counter() - t0:.1f} s", flush=True)
    if not all(results.values()):
        fail(f"failed phases: {[k for k, v in results.items() if not v]}")
    print(json.dumps({"ok": True,
                      "device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())}}),
          flush=True)


if __name__ == "__main__":
    main()
