"""Post-processing utilities over lat-lon model output (.npz).

JAX analogs of the reference ``util/`` CLI tools:
- ``extract_surface``: 2-D slices at a level / height from 3-D output
  (ref ``util/ExtractSurface/ExtractSurface.cpp``).
- ``zonal_temporal_average``: zonal + time mean across a series of output
  files, for Held-Suarez climatology (ref
  ``util/ZonalTemporalAverage/ZonalTemporalAverage.cpp``).
- ``to_cf_dataset``: convert to a CF-style xarray Dataset / NetCDF when
  xarray is available (ref ``util/CFConverter/CFConverter.cpp``).

Each is usable as a library function and via ``python -m
tempestmodel_tpu.utils.postprocess <cmd> ...``.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

_COORD_KEYS = ("lat", "lon", "time")


def load_output(path):
    d = np.load(path)
    return {k: d[k] for k in d.files}


def extract_surface(data: dict, level: int = 0):
    """Extract one vertical level from every 3-D field."""
    out = {k: v for k, v in data.items() if k in _COORD_KEYS}
    for k, v in data.items():
        if k in _COORD_KEYS:
            continue
        if v.ndim >= 3:
            out[k] = v[..., level]
        else:
            out[k] = v
    return out


def zonal_temporal_average(paths):
    """Zonal + temporal mean of every field across output files.

    Returns dict of (nlat[, nz]) arrays plus 'lat'.
    """
    if not paths:
        raise ValueError("no input files")
    acc = {}
    count = 0
    lat = None
    for p in sorted(paths):
        d = load_output(p)
        lat = d["lat"]
        for k, v in d.items():
            if k in _COORD_KEYS or np.ndim(v) < 2:
                continue
            zmean = v.mean(axis=1)          # average over lon axis
            acc[k] = acc.get(k, 0.0) + zmean
        count += 1
    out = {k: v / count for k, v in acc.items()}
    out["lat"] = lat
    out["nfiles"] = count
    return out


def to_cf_dataset(data: dict):
    """Convert one output dict to a CF-style xarray Dataset (needs the
    optional ``xarray`` package; nothing else in the package imports it)."""
    try:
        import xarray as xr
    except ImportError as e:
        raise ImportError("to_cf_dataset needs the optional xarray "
                          "package, which is not installed") from e
    coords = {"lat": ("lat", np.rad2deg(data["lat"]),
                      {"units": "degrees_north", "standard_name": "latitude"}),
              "lon": ("lon", np.rad2deg(data["lon"]),
                      {"units": "degrees_east", "standard_name": "longitude"})}
    cf_names = {"U": ("eastward_wind", "m s-1"),
                "V": ("northward_wind", "m s-1"),
                "W": ("upward_air_velocity", "m s-1"),
                "T": ("air_temperature", "K"),
                "P": ("air_pressure", "Pa"),
                "Rho": ("air_density", "kg m-3"),
                "Theta": ("air_potential_temperature", "K"),
                "H": ("surface_height_above_reference", "m")}
    data_vars = {}
    for k, v in data.items():
        if k in _COORD_KEYS or np.ndim(v) < 2:
            continue
        dims = ("lat", "lon") if v.ndim == 2 else ("lat", "lon", "lev")
        std, units = cf_names.get(k, (k, "1"))
        data_vars[k] = (dims, v, {"standard_name": std, "units": units})
    return xr.Dataset(data_vars, coords=coords,
                      attrs={"Conventions": "CF-1.8",
                             "source": "tempestmodel_tpu"})


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tempestmodel_tpu.postprocess")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("extract_surface")
    p1.add_argument("input")
    p1.add_argument("output")
    p1.add_argument("--level", type=int, default=0)

    p2 = sub.add_parser("zonal_temporal_average")
    p2.add_argument("pattern")
    p2.add_argument("output")

    p3 = sub.add_parser("cfconvert")
    p3.add_argument("input")
    p3.add_argument("output")

    args = ap.parse_args(argv)
    if args.cmd == "extract_surface":
        np.savez_compressed(
            args.output, **extract_surface(load_output(args.input),
                                           args.level))
    elif args.cmd == "zonal_temporal_average":
        np.savez_compressed(
            args.output, **zonal_temporal_average(glob.glob(args.pattern)))
    elif args.cmd == "cfconvert":
        try:
            ds = to_cf_dataset(load_output(args.input))
            ds.to_netcdf(args.output)
        except ImportError:
            # xarray/netCDF unavailable: write CF-attributed npz instead
            d = load_output(args.input)
            d["Conventions"] = np.array("CF-1.8-npz")
            d["lat_degrees"] = np.rad2deg(d["lat"])
            d["lon_degrees"] = np.rad2deg(d["lon"])
            np.savez_compressed(args.output, **d)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
