"""HPC scaling config (BASELINE.json config 5): nonhydro sphere ne120
p4 L60.

Two modes:
  - on one GPU (default backend): single-device throughput measurement
    of the flagship Strang-HEVI step at the full ne120 L60 resolution,
    f32.
  - with TM_NE120_MESH=1: sharded dry-run on the virtual 8-device CPU
    mesh (reduced nz so the host fits it) through the explicit
    shard_map distribution layer — validates that the ne120 geometry
    builds, shards, compiles and executes multi-device.

Run from the repo root:  python scripts/ne120_scaling.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

MESH_MODE = os.environ.get("TM_NE120_MESH", "0") == "1"

if MESH_MODE:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import jax          # noqa: E402

if MESH_MODE:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp          # noqa: E402
from tempestmodel_tpu.config import ModelConfig, GridKind   # noqa: E402
from tempestmodel_tpu.models import nh_model                # noqa: E402
from tempestmodel_tpu.testcases.nonhydro_sphere import (    # noqa: E402
    BaroclinicWaveUMJS)


def main():
    ne = 120
    nz = 8 if MESH_MODE else 60
    steps = int(os.environ.get("TM_NE120_STEPS", "1" if MESH_MODE else "5"))

    tc = BaroclinicWaveUMJS(pert="exp")
    cfg = ModelConfig(grid_kind=GridKind.CUBED_SPHERE, ne=ne, order=4,
                      nz=nz, ztop=tc.ztop, dt=100.0, hyperdiffusion=True,
                      nu_scalar=1e14, nu_div=1e14, nu_vort=1e14,
                      dtype=jnp.float32)
    t0 = time.time()
    geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
    state = tc.initial_state(geom, cfg.constants, dtype=jnp.float32)
    print(f"geometry+state built in {time.time()-t0:.1f}s", flush=True)

    npts = 6 * (ne * 4) ** 2 * nz
    state_mb = sum(v.size * v.dtype.itemsize for v in state.values()) / 1e6
    print(f"ne{ne} L{nz}: {npts/1e6:.1f}M gridpoints, state {state_mb:.0f} MB",
          flush=True)

    if MESH_MODE:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        import numpy as np
        devs = np.array(jax.devices()[:8]).reshape(2, 4)
        mesh = Mesh(devs, ("x", "y"))
        sh = NamedSharding(mesh, P(None, "x", "y"))
        state = {k: jax.device_put(v, sh) for k, v in state.items()}
        first_step, step = nh_model.make_nh_step(cfg, geom, mesh=mesh)
        t0 = time.time()
        s, c = first_step(state)
        jax.block_until_ready(s["Rho"])
        print(f"sharded first step (compile+run) {time.time()-t0:.1f}s",
              flush=True)
        t0 = time.time()
        for _ in range(steps):
            s, c = step(s, c)
        jax.block_until_ready(s["Rho"])
        dt_step = (time.time() - t0) / steps
        assert bool(jnp.isfinite(s["Rho"]).all())
        print(json.dumps({
            "mode": "mesh8_cpu_dryrun", "ne": ne, "nz": nz,
            "s_per_step": dt_step,
            "gps_per_device": npts / dt_step / 8,
            "sharding": str(s["Rho"].sharding)}))
        return

    first_step, multi = nh_model.make_nh_multistep(cfg, geom, steps)
    t0 = time.time()
    state, carry = first_step(state)
    jax.block_until_ready(state["Rho"])
    print(f"first step (compile+run) {time.time()-t0:.1f}s", flush=True)
    s, c = multi(state, carry)
    jax.block_until_ready(s["Rho"])
    t0 = time.time()
    s, c = multi(s, c)
    jax.block_until_ready(s["Rho"])
    dt_step = (time.time() - t0) / steps
    assert bool(jnp.isfinite(s["Rho"]).all())
    print(json.dumps({
        "mode": "single_device", "ne": ne, "nz": nz,
        "platform": jax.devices()[0].platform,
        "device": jax.devices()[0].device_kind,
        "ms_per_step": dt_step * 1e3,
        "gridpoint_steps_per_sec": npts / dt_step}))


if __name__ == "__main__":
    main()
