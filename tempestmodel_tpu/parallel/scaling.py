"""Weak/strong scaling harness over a virtual or real device mesh.

The reference's only scaling axis is the 2-D horizontal domain
decomposition (``GridCSGLL.cpp:92-148``, one patch per MPI rank); the
north-star metric is grid-point-steps/sec/device and weak-scaling
efficiency (BASELINE.json).  This harness runs the flagship nonhydrostatic
Strang-HEVI step over 1/2/4/8-device meshes and reports both:

- **strong scaling**: fixed global problem, growing mesh;
- **weak scaling**: per-device block held ~constant (A scales with
  sqrt(n_devices); exact at n in {1, 4} on the cubed sphere since A = B).

Run: ``python -m tempestmodel_tpu.parallel.scaling`` (override the device
platform with JAX_PLATFORMS / XLA_FLAGS as in tests/conftest.py).
On virtual CPU devices the numbers measure partitioning overhead, not
device throughput — the harness is the same code path that runs on real
devices (``TM_SCALING_DEVICES=1``).
"""

from __future__ import annotations

import json
import time

import numpy as np


def _mesh_shape(n: int):
    mx = 1
    for cand in range(int(np.sqrt(n)), 0, -1):
        if n % cand == 0:
            mx = cand
            break
    return mx, n // mx


def _build(ne: int, nz: int, dtype):
    from tempestmodel_tpu.config import ModelConfig, GridKind
    from tempestmodel_tpu.models import nh_model
    from tempestmodel_tpu.testcases.nonhydro_sphere import BaroclinicWaveUMJS
    tc = BaroclinicWaveUMJS(pert="exp")
    cfg = ModelConfig(grid_kind=GridKind.CUBED_SPHERE, ne=ne, order=4,
                      nz=nz, ztop=tc.ztop, dt=100.0, hyperdiffusion=True,
                      nu_scalar=1e15, nu_div=1e15, nu_vort=1e15,
                      dtype=dtype)
    geom = nh_model.build_nh_sphere_geometry(cfg, ztop=tc.ztop)
    state = tc.initial_state(geom, cfg.constants, dtype=dtype)
    return cfg, geom, state


def measure(n_devices: int, ne: int, nz: int = 10, steps: int = 5,
            dtype=None, reps: int = 3, explicit: bool = True,
            engine: str = "reference") -> dict:
    """Gridpoint-steps/s of the flagship step on an n-device mesh.

    ``explicit``: route DSS + the vertical implicit solve through the
    shard_map layer (``parallel/dss_shardmap``); False = GSPMD only.
    ``engine``: "reference" = the reference-layout engine;
    "fast" = the z-first Pallas engine via its own shard_map +
    routed-ppermute distribution (``fast/mesh_dss``) — the SAME code
    path the single-chip bench runs.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P, NamedSharding
    from tempestmodel_tpu.models import nh_model

    if dtype is None:
        dtype = jnp.float32
    cfg, geom, state = _build(ne, nz, dtype)

    mx, my = _mesh_shape(n_devices)
    mesh = Mesh(np.array(jax.devices()[:n_devices]).reshape(mx, my),
                ("x", "y"))
    if engine == "fast":
        from tempestmodel_tpu import fast
        # the overlap schedule is the shipping default for mesh runs
        # (bitwise-equal to the inline schedule; round-5 VERDICT item 5)
        if n_devices > 1:
            cfg = cfg.with_(halo_overlap=True)
        first_step, multi = fast.engine.make_fast_multistep(
            cfg, geom, steps, mesh=mesh if n_devices > 1 else None)
        state = fast.pack_state(state)
        spec = NamedSharding(mesh, P(None, None, "x", "y"))
    else:
        first_step, multi = nh_model.make_nh_multistep(
            cfg, geom, steps,
            mesh=mesh if (explicit and n_devices > 1) else None)
        spec = NamedSharding(mesh, P(None, "x", "y"))
    state = jax.tree.map(lambda a: jax.device_put(a, spec), state)
    with mesh:
        state, carry = first_step(state)
        s, c = multi(state, carry)          # compile
        jax.block_until_ready(s)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            s, c = multi(state, carry)
            jax.block_until_ready(s)
            best = min(best, (time.perf_counter() - t0) / steps)
    npts = 6 * (ne * 4) ** 2 * nz
    return {"n_devices": n_devices, "mesh": [mx, my], "ne": ne, "nz": nz,
            "engine": engine,
            "gridpoints": npts, "sec_per_step": best,
            "gps_total": npts / best,
            "gps_per_device": npts / best / n_devices}


def scaling_report(device_counts=(1, 2, 4, 8), ne_strong: int = 8,
                   weak_pairs=((1, 6), (4, 12)), nz: int = 10,
                   steps: int = 5) -> dict:
    """Strong sweep at fixed ne + weak pairs with per-device work fixed."""
    import jax
    avail = len(jax.devices())
    out = {"strong": [], "weak": [], "platform": jax.default_backend()}
    for n in device_counts:
        if n > avail:
            continue
        out["strong"].append(measure(n, ne_strong, nz, steps))
    for n, ne in weak_pairs:
        if n > avail:
            continue
        out["weak"].append(measure(n, ne, nz, steps))
    out["strong_fast"] = []
    for n in device_counts:
        if n > avail:
            continue
        out["strong_fast"].append(
            measure(n, ne_strong, nz, steps, engine="fast"))
    # weak sweep of the engine that actually runs at scale (round-4
    # VERDICT missing #4): per-device block ~constant, overlap on
    out["weak_fast"] = []
    for n, ne in weak_pairs:
        if n > avail:
            continue
        out["weak_fast"].append(measure(n, ne, nz, steps, engine="fast"))
    for key in ("strong", "strong_fast"):
        if out[key]:
            s0 = out[key][0]["gps_per_device"]
            for r in out[key]:
                r["efficiency"] = r["gps_per_device"] / s0
    for key in ("weak", "weak_fast"):
        if out[key]:
            w0 = out[key][0]["gps_per_device"]
            for r in out[key]:
                r["efficiency"] = r["gps_per_device"] / w0
    return out


def main():
    # the sweep needs a mesh: default to the virtual 8-device CPU
    # platform unless TM_SCALING_DEVICES is set (run on the real devices
    # JAX finds, e.g. four GPUs).
    import os
    if not os.environ.get("TM_SCALING_DEVICES"):
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        import jax
        jax.config.update("jax_platforms", "cpu")
        if len(jax.devices()) < 8:
            raise RuntimeError(
                "virtual 8-device mesh unavailable (the XLA backend was "
                "initialized before XLA_FLAGS took effect); run with "
                "XLA_FLAGS=--xla_force_host_platform_device_count=8")
    rep = scaling_report()
    print(json.dumps(rep, indent=1))


if __name__ == "__main__":
    main()
