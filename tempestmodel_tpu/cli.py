"""Command-line front end: the Tempest CLI analog.

The reference builds one binary per test case with a shared flag set
(``src/atm/TempestInitialize.h:112-144``, ``src/base/CommandLine.h``).
Here one entry point selects the case by name and exposes the same
standard flags::

    python -m tempestmodel_tpu --case thermal_bubble --dt 0.01s \
        --endtime 700s --resolution 36 --levels 72 --order 4 \
        --output_dir out --output_dt 10s

Cases: sw_tc2, sw_tc5, sw_rh4, sw_galewsky, thermal_bubble,
density_current, schar, inertia_gravity, umjs, umjs_pert, held_suarez.
"""

from __future__ import annotations

import argparse
import sys

import jax.numpy as jnp

from .config import (ModelConfig, EquationSet, GridKind, TimestepSchemeType,
                     ExplicitSubScheme)
from .model import Model
from .io.output import (ChecksumOutput, EnergyOutput, ReferenceOutput,
                        CompositeCheckpoint)
from .utils.timeobj import parse_duration_seconds


def _build_case(name: str, args):
    """(testcase, cfg overrides dict, workflow list)."""
    from .testcases import shallow_water as sw
    from .testcases import nonhydro_xz as nxz
    from .testcases import nonhydro_sphere as nsp

    wps = []
    if name == "sw_tc2":
        return sw.Williamson2(), dict(
            equation_set=EquationSet.SHALLOW_WATER), wps
    if name == "sw_tc5":
        return sw.Williamson5(), dict(
            equation_set=EquationSet.SHALLOW_WATER), wps
    if name == "sw_rh4":
        return sw.RossbyHaurwitz(), dict(
            equation_set=EquationSet.SHALLOW_WATER), wps
    if name == "sw_galewsky":
        return sw.BarotropicInstability(), dict(
            equation_set=EquationSet.SHALLOW_WATER), wps
    if name == "thermal_bubble":
        tc = nxz.ThermalBubble()
    elif name == "density_current":
        tc = nxz.DensityCurrent()
    elif name == "schar":
        tc = nxz.ScharMountain()
    elif name == "inertia_gravity":
        tc = nxz.InertiaGravityWave()
    elif name in ("umjs", "umjs_pert", "held_suarez"):
        tc = nsp.BaroclinicWaveUMJS(
            pert="exp" if name == "umjs_pert" else "none",
            rayleigh=(name != "held_suarez"))
        over = dict(equation_set=EquationSet.PRIMITIVE_NONHYDRO,
                    grid_kind=GridKind.CUBED_SPHERE,
                    rayleigh_damping=tc.rayleigh)
        if name == "held_suarez":
            from .physics.held_suarez import HeldSuarezPhysics
            wps.append(HeldSuarezPhysics(interval=0.0))
        return tc, over, wps
    else:
        raise SystemExit(f"unknown case {name!r}")
    return tc, dict(
        equation_set=EquationSet.PRIMITIVE_NONHYDRO,
        grid_kind=GridKind.CARTESIAN_XZ,
        x_extent=tc.x_extent, y_extent=tc.y_extent, ztop=tc.ztop,
        rayleigh_damping=getattr(tc, "rayleigh", False)), wps


def make_parser():
    ap = argparse.ArgumentParser(prog="tempestmodel_tpu")
    ap.add_argument("--case", required=True)
    # standard model flags (TempestInitialize.h:112-144)
    ap.add_argument("--resolution", type=int, default=None,
                    help="elements per cube edge / x elements")
    ap.add_argument("--resolution_y", type=int, default=None)
    ap.add_argument("--levels", type=int, default=None)
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--vertorder", type=int, default=1)
    ap.add_argument("--dt", default=None)
    ap.add_argument("--endtime", default=None)
    ap.add_argument("--nsteps", type=int, default=None)
    ap.add_argument("--timescheme", default="strang")
    ap.add_argument("--explicitscheme", default="kgu35")
    ap.add_argument("--explicitvertical", action="store_true",
                    help="no implicit vertical solve (pure explicit RK)")
    # dynamics variants (TempestInitialize.h:143-144)
    ap.add_argument("--hmethod", default="V1",
                    help="horizontal dynamics: V1 | SPEX | HS")
    ap.add_argument("--vmethod", default="V1",
                    help="vertical solver: V1 or V2 (banded) | SCHUR | JFNK "
                         "| DENSE")
    ap.add_argument("--vstagger", default="LOR",
                    help="vertical staggering: LEV | INT | LOR | CPH")
    ap.add_argument("--vdisc", default="FE",
                    help="vertical discretization: FE | FV (FV needs an "
                         "even --vertorder >= 2)")
    ap.add_argument("--vstretch", default="uniform",
                    help="vertical stretch: uniform | cubic | pwlinear")
    ap.add_argument("--newtoniter", type=int, default=1,
                    help="Newton iterations per implicit vertical solve")
    ap.add_argument("--vertupwind", type=float, default=0.0,
                    help="vertical flux upwinding coefficient")
    ap.add_argument("--nu", type=float, default=1.0e15)
    ap.add_argument("--nud", type=float, default=1.0e15)
    ap.add_argument("--nuv", type=float, default=1.0e15)
    ap.add_argument("--hypervisorder", type=int, default=4)
    ap.add_argument("--nohypervis", action="store_true")
    ap.add_argument("--norayleigh", action="store_true")
    ap.add_argument("--norefstate", action="store_true",
                    help="skip error norms vs the reference state")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--output_prefix", default="out")
    ap.add_argument("--output_dt", default=None)
    ap.add_argument("--output_format", default="npz",
                    help="scientific output format: npz | nc (NetCDF)")
    ap.add_argument("--output_x", type=int, default=180,
                    help="lat-lon output grid: longitudes")
    ap.add_argument("--output_y", type=int, default=91,
                    help="lat-lon output grid: latitudes")
    ap.add_argument("--output_vort", action="store_true")
    ap.add_argument("--output_div", action="store_true")
    ap.add_argument("--output_ps", action="store_true")
    ap.add_argument("--output_Ri", action="store_true")
    ap.add_argument("--output_restart_dt", default=None)
    ap.add_argument("--restart_file", default=None)
    ap.add_argument("--perturb_restart", action="store_true",
                    help="re-apply the test case perturbation on restart")
    ap.add_argument("--checksum_dt", default=None)
    ap.add_argument("--verbose", action="store_true")
    return ap


_VMETHOD = {"v1": "banded", "v2": "banded", "schur": "schur",
            "jfnk": "jfnk", "dense": "dense", "banded": "banded",
            "pallas": "banded"}


def main(argv=None):
    from .utils.announce import (announce, announce_banner, block,
                                 announce_set_verbosity,
                                 announce_only_rank_zero)
    args = make_parser().parse_args(argv)
    announce_only_rank_zero()
    if getattr(args, "verbose", False):
        announce_set_verbosity(2)
    if not args.fp32:
        import jax
        jax.config.update("jax_enable_x64", True)
    tc, over, wps = _build_case(args.case, args)

    kw = dict(over)
    if args.resolution is not None:
        if kw.get("grid_kind") == GridKind.CARTESIAN_XZ:
            kw["nex"] = args.resolution
        else:
            kw["ne"] = args.resolution
    if args.resolution_y is not None:
        kw["ney"] = args.resolution_y
    if args.levels is not None:
        kw["nz"] = args.levels
    kw["order"] = args.order
    kw["vertical_order"] = args.vertorder
    if args.dt is not None:
        kw["dt"] = parse_duration_seconds(args.dt)
    hm = args.hmethod.lower()
    if hm == "spex":
        args.timescheme = "spex"
    elif hm == "hs":
        args.timescheme = "hs"
    elif hm != "v1":
        raise SystemExit(f"unknown --hmethod {args.hmethod!r}")
    kw["timescheme"] = TimestepSchemeType(args.timescheme)
    kw["explicit_scheme"] = ExplicitSubScheme(args.explicitscheme)
    kw["explicit_vertical"] = args.explicitvertical
    vm = args.vmethod.lower()
    if vm == "none":
        kw["explicit_vertical"] = True
    elif vm in _VMETHOD:
        kw["vertical_solver"] = _VMETHOD[vm]
    else:
        raise SystemExit(f"unknown --vmethod {args.vmethod!r}")
    from .config import VerticalStaggering
    kw["vertical_staggering"] = VerticalStaggering(args.vstagger.upper())
    kw["vertical_discretization"] = args.vdisc.upper()
    kw["vertical_stretch"] = args.vstretch
    kw["newton_iterations"] = args.newtoniter
    kw["vertical_upwinding"] = args.vertupwind
    kw["nu_scalar"], kw["nu_div"], kw["nu_vort"] = args.nu, args.nud, args.nuv
    kw["hypervis_order"] = args.hypervisorder
    if args.nohypervis:
        kw["hyperdiffusion"] = False
    if args.norayleigh:
        kw["rayleigh_damping"] = False
    if args.fp32:
        kw["dtype"] = jnp.float32

    cfg = ModelConfig(**kw)
    oms = []
    if args.checksum_dt:
        oms.append(ChecksumOutput(parse_duration_seconds(args.checksum_dt),
                                  printer=print))
        oms.append(EnergyOutput(parse_duration_seconds(args.checksum_dt),
                                printer=print))
    if args.output_dir and args.output_dt and \
            kw.get("grid_kind") == GridKind.CUBED_SPHERE:
        oms.append(ReferenceOutput(
            parse_duration_seconds(args.output_dt), args.output_dir,
            nlat=args.output_y, nlon=args.output_x,
            prefix=args.output_prefix, fmt=args.output_format,
            output_vorticity=args.output_vort,
            output_divergence=args.output_div,
            output_surface_pressure=args.output_ps,
            output_richardson=args.output_Ri))
    if args.output_dir and args.output_restart_dt:
        oms.append(CompositeCheckpoint(
            parse_duration_seconds(args.output_restart_dt), args.output_dir))

    announce_banner("MODEL SETUP")
    with block("Initializing model"):
        announce(f"case: {args.case}")
        announce(f"grid: {cfg.grid_kind.value} resolution="
                 f"{getattr(cfg, 'ne', cfg.nex)} levels={cfg.nz} "
                 f"order={cfg.order}")
        announce(f"timescheme: {cfg.timescheme.value} dt={cfg.dt}s "
                 f"vstagger={cfg.vertical_staggering.value}")
        m = Model(cfg, tc, output_managers=oms, workflow_processes=wps,
                  verbose=args.verbose)
    if args.restart_file:
        with block("Restoring from restart file"):
            m.restart_from(args.restart_file, perturb=args.perturb_restart)

    announce_banner("EXECUTION")
    with block("Time integration"):
        m.go(end_time=args.endtime, nsteps=args.nsteps)

    if m.reference is not None and not args.norefstate:
        norms = m.compute_error_norms()
        print("Error norms vs reference state (L1/L2/Linf relative):")
        for comp, n in norms.items():
            print(f"  {comp:8s} {float(n['l1_rel']):.6e} "
                  f"{float(n['l2_rel']):.6e} {float(n['linf_rel']):.6e}")
    m.timers.report()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
