"""Benchmark: grid-point-steps/s of the z-first engine on one GPU.

    python bench.py [--cells umjs,dcmip_moist,schar_xz] [--steps 10]

Prints one JSON line per cell.  The cells are the three configurations
``chip_smoke.py`` checks (same ``configs()``): the UMJS baroclinic wave
at cubed sphere ne30 p4 L30 (BASELINE.json headline config), the
DCMIP2016 moist wave with 3 tracers, and the Schar x-z slice nex100 p4
L40, all float32, Strang-HEVI with nu4 hyperdiffusion.

dt = 100 s on the sphere: the KGU35 stability bound at ne30 p4 is
CFL 2.12 (TimestepSchemeStrang.cpp:140-197).

Each line records what it ran on (platform, device kind and count, the
card's power limit, XLA_FLAGS, the banded-solve implementation) and:

- ``ms_per_step``: host clock around ``steps`` eager steps (one
  dispatch each), best of 3, ending in block_until_ready;
- ``device_busy_ms_per_step``, ``device_idle_share``,
  ``kernels_per_step``, ``top_kernels_ms``: one step's profiler trace
  (``utils/devprof``);
- ``phases_ms``: device busy time of each layer of the step compiled
  alone, in the reference's FunctionTimer names (Model.cpp:520-689):
  HorizontalStep = one RK stage's tendency + update, Communicate = one
  full-state DSS, StepAfterSubCycle = the nu4 tail (2 DSS inside),
  VerticalStepImplicit = the Newton-banded solve (+ tracers).  Use them
  to rank layers; the step fuses across their boundaries;
- ``gbytes_lb_per_step`` and ``sol_ms_per_step``: the state read and
  written once per pass (5 RK stages, 2 nu4 passes, the implicit
  solve) over the card's peak bandwidth;
- ``ms_per_step_scan`` (and its device busy time and kernel count): the
  same step with the ``lax.scan`` banded solve in place of the Triton
  kernel, the end-to-end test of keeping the kernel.

A machine without a GPU, or a GPU not in ``PEAKS``, is an error.
"""

import argparse
import json
import os
import subprocess
import time

from chip_smoke import set_compile_flags

# Published peaks by JAX device_kind: (f32 FLOP/s outside the tensor
# cores, HBM bytes/s); the step is bound by bytes, so only the second is
# used today.  Source: NVIDIA H100 data sheet, SXM part, dense
# rates at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (67e12, 3.35e12),
}


def power_limit():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def _best_ms(fn, reps=3):
    import jax
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def phase_fns(cfg, model):
    """{FunctionTimer name: jitted z-first layer} of a fast Model."""
    import jax
    from tempestmodel_tpu.fast import engine as fe, implicit as fimp
    from tempestmodel_tpu.fast import tracers as ftr
    from tempestmodel_tpu.models import nonhydro

    geom, constants = model.geom, cfg.constants
    if hasattr(geom, "nex"):
        fg = fe.build_fast_geometry_cartesian(geom, dtype=cfg.dtype)
    else:
        fg = fe.build_fast_geometry(geom, dtype=cfg.dtype)
    q = nonhydro.estimate_bandwidth(geom, constants)
    statics = nonhydro.band_assembly_statics(geom, q)

    def engine_layout(d):
        return fe._swap_ab_state(d) if fg.ab_swapped else d

    def stage(d):
        d = engine_layout(d)
        tend = fe.horizontal_tendency(d, fg, constants)
        upd = fe.apply_w_boundary(
            {k: d[k] + cfg.dt * tend[k] for k in fe.FIELDS}, fg)
        if "Tracers" in d:
            upd["Tracers"] = ftr.horizontal_update(d["Tracers"], d,
                                                   cfg.dt, fg)
        return upd

    def implicit(d):
        d = engine_layout(d)
        out = fimp.vertical_implicit(d, fg, constants, 0.5 * cfg.dt, q,
                                     statics)
        if "Tracers" in d:
            out = dict(out, Tracers=ftr.update_column_tracers(
                d, out["W"], fg, 0.5 * cfg.dt))
        return out

    return {
        "HorizontalStep": jax.jit(stage),
        "Communicate": jax.jit(
            lambda d: fe.apply_dss(engine_layout(d), fg)),
        "StepAfterSubCycle": jax.jit(
            lambda d: fe.step_after_subcycle(engine_layout(d), cfg.dt,
                                             cfg, fg)),
        "VerticalStepImplicit": jax.jit(implicit),
    }


def run_cell(name, steps):
    import jax
    from chip_smoke import configs, run_model
    from tempestmodel_tpu import backend, fast
    from tempestmodel_tpu.utils.devprof import trace_call

    dev = jax.devices()[0]
    _, peak_bw = PEAKS[dev.device_kind]
    kw, make_tc = configs()[name]
    model, _ = run_model(kw, make_tc, fast=True, nsteps=2)
    cfg = model.cfg
    s, c = model._fast_state, model._fast_carry

    def per_step(step):
        """(host ms/step of ``steps`` eager steps, best of 3; one step's
        trace) for a compiled step function."""
        def run():
            x = (s, c)
            for _ in range(steps):
                x = step(*x)
            return x
        jax.block_until_ready(run())
        return _best_ms(run) / steps, trace_call(step, s, c)

    ms, tr = per_step(model._step)
    out_s, _ = model._step(s, c)
    finite = all(bool(jax.numpy.isfinite(v).all()) for v in out_s.values())
    phases = {k: trace_call(f, s) for k, f in phase_fns(cfg, model).items()}
    # the same step with the lax.scan banded solve in place of the kernel
    ntr = s["Tracers"].shape[0] // cfg.nz if "Tracers" in s else 0
    _, step_scan = fast.make_fast_step(cfg, model.geom,
                                       ref_state=model.reference,
                                       ntracers=ntr, solver="scan")
    ms_scan, tr_scan = per_step(step_scan)

    state_bytes = sum(v.nbytes for v in s.values())
    bytes_lb = 2 * (5 + 2 + 1) * state_bytes
    return {
        "cell": name,
        "metric": "gridpoint-steps/s",
        "value": s["Rt"].size / (ms / 1e3),
        "ms_per_step": ms,
        "steps": steps,
        "finite": finite,
        "device_busy_ms_per_step": tr["busy_ms"],
        "device_idle_share": 1.0 - tr["busy_ms"] / tr["window_ms"],
        "kernels_per_step": tr["n_kernels"],
        "top_kernels_ms": dict(sorted(tr["kernels_ms"].items(),
                                      key=lambda kv: -kv[1])[:8]),
        "phases_ms": {k: v["busy_ms"] for k, v in phases.items()},
        "phases_kernels": {k: v["n_kernels"] for k, v in phases.items()},
        "gbytes_lb_per_step": bytes_lb / 1e9,
        "sol_ms_per_step": bytes_lb / peak_bw * 1e3,
        "banded_solver": backend.banded_solver(),
        "ms_per_step_scan": ms_scan,
        "device_busy_ms_per_step_scan": tr_scan["busy_ms"],
        "kernels_per_step_scan": tr_scan["n_kernels"],
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "gpu_name_power_limit": power_limit(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default="umjs,dcmip_moist,schar_xz")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()

    set_compile_flags()
    import jax
    import tempestmodel_tpu  # noqa: F401  (precision pin, compile cache)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{dev.platform!r}")
    if dev.device_kind not in PEAKS:
        raise SystemExit(f"no published peaks for {dev.device_kind!r}; "
                         f"add a row to PEAKS with its source")
    for name in args.cells.split(","):
        print(json.dumps(run_cell(name, args.steps)), flush=True)


if __name__ == "__main__":
    main()
