"""Top-level model driver: component registry + main time loop.

JAX analog of the reference ``Model`` class (``src/atm/Model.{h,cpp}``):
owns the grid/geometry, timestep scheme, test case, output managers and
workflow (physics) processes; ``go()`` is the ``Model::Go()`` main loop
(``Model.cpp:316-518``) with per-phase timers and output scheduling;
``compute_error_norms()`` is ``Model::ComputeErrorNorms`` (``:695-782``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from .config import (ModelConfig, EquationSet, GridKind,
                     TimestepSchemeType)
from .models import nh_model, sw_model
from .io.diagnostics import error_norms
from .utils.timers import Timers
from .utils.timeobj import parse_duration_seconds


class WorkflowProcess:
    """Periodic in-loop hook (reference ``WorkflowProcess.h:30-70``).

    Subclass and override ``perform(model, t) -> new_state`` (pure update of
    the state dict).  ``interval`` seconds of model time between firings
    (0 = every step).
    """

    def __init__(self, interval: float = 0.0):
        self.interval = float(interval)
        self._last = None

    def is_ready(self, t: float) -> bool:
        if self.interval <= 0.0:
            return True
        if self._last is None:
            self._last = t
            return False
        return t - self._last >= self.interval - 1e-9

    def fire(self, model, t: float):
        self._last = t
        return self.perform(model, t)

    def perform(self, model, t: float):
        raise NotImplementedError


class Model:
    """One configured model run."""

    def __init__(self, cfg: ModelConfig, testcase=None, topography=None,
                 rayleigh=None, output_managers: Sequence = (),
                 workflow_processes: Sequence[WorkflowProcess] = (),
                 verbose: bool = False, mesh=None):
        """``mesh``: optional ``jax.sharding.Mesh`` with axes ("x", "y")
        — the driver builds the distributed step (the fast engine's
        shard_map path when supported, else the reference-layout
        shard_map path) and shards the state over the horizontal axes,
        the analog of the reference's MPI patch decomposition
        (``Grid::DistributePatches``, ``Grid.h:503``)."""
        # test-case physical-constants override (the reference's
        # TestCase::EvaluatePhysicalConstants hook, TestCase.h:103-110,
        # e.g. ShallowWaterEddyTest sets omega = 0)
        if testcase is not None and hasattr(testcase, "physical_constants"):
            import dataclasses as _dc
            cfg = _dc.replace(
                cfg, constants=testcase.physical_constants(cfg.constants))
        from .config import VerticalStaggering
        self.cfg = cfg
        self.mesh = mesh
        self.testcase = testcase
        self.output_managers = list(output_managers)
        self.workflow_processes = list(workflow_processes)
        self.timers = Timers()
        self.verbose = verbose
        self.step_count = 0
        self.time = 0.0
        self.carry = None
        # registry of named user 2-D diagnostic fields (P, A, B), written
        # by workflow processes and emitted by ReferenceOutput (analog of
        # UserDataMeta, ``UserDataMeta.h:35+``)
        self.user_data = {}

        if topography is None and testcase is not None:
            topography = getattr(testcase, "topography", None)
        if rayleigh is None and testcase is not None:
            rayleigh = getattr(testcase, "rayleigh_strength", None)
            if rayleigh is not None and not getattr(
                    testcase, "rayleigh", False):
                rayleigh = None
        ztop = getattr(testcase, "ztop", None)

        if cfg.equation_set == EquationSet.SHALLOW_WATER:
            if cfg.nz > 1:
                raise ValueError(
                    "equation_set=SHALLOW_WATER with nz > 1: set "
                    "equation_set=PRIMITIVE_NONHYDRO for 3-D runs")
            self.geom = sw_model.build_sw_geometry(cfg, topography)
            self._sw_step = sw_model.make_sw_step(cfg, self.geom)
        elif cfg.grid_kind == GridKind.CUBED_SPHERE:
            self.geom = nh_model.build_nh_sphere_geometry(
                cfg, topography=topography, ztop=ztop, rayleigh=rayleigh)
        else:
            self.geom = nh_model.build_nh_cartesian_geometry(
                cfg, topography=topography, ztop=ztop, rayleigh=rayleigh,
                bc_x=getattr(testcase, "bc_x", "periodic"),
                bc_y=getattr(testcase, "bc_y", "periodic"),
                reference_latitude=getattr(
                    testcase, "reference_latitude", 0.0))

        self.state = None
        self.reference = None
        if testcase is not None:
            import inspect as _inspect
            ikw = {}
            convert = None
            if cfg.vertical_staggering != VerticalStaggering.LORENZ and \
                    cfg.equation_set != EquationSet.SHALLOW_WATER:
                sig = _inspect.signature(testcase.initial_state)
                if "stagger" in sig.parameters:
                    ikw["stagger"] = cfg.vertical_staggering.value
                else:
                    # generic shape conversion (nonhydro.convert_stagger)
                    convert = cfg.vertical_staggering.value
            self.state = testcase.initial_state(
                self.geom, cfg.constants, dtype=cfg.dtype, **ikw)
            if convert is not None:
                from .models.nonhydro import convert_stagger
                self.state = convert_stagger(self.state, self.geom,
                                             convert)
            if hasattr(testcase, "reference_state"):
                self.reference = testcase.reference_state(
                    self.geom, cfg.constants, dtype=cfg.dtype)

        self._fast = False
        if cfg.equation_set != EquationSet.SHALLOW_WATER:
            if cfg.timescheme in (TimestepSchemeType.STRANG,
                                  TimestepSchemeType.ERK,
                                  TimestepSchemeType.SPEX):
                from .fast.engine import fast_engine_supported
                has_tr = (self.state is not None
                          and "Tracers" in self.state)
                use_fast = (cfg.fuse_pallas
                            and fast_engine_supported(cfg,
                                                      has_tracers=has_tr,
                                                      mesh=mesh,
                                                      geom=self.geom))
                if use_fast:
                    # z-first engine (fast/): same step semantics as the
                    # reference-layout engine; with a mesh, the same
                    # engine under shard_map
                    from . import fast
                    ntr = (self.state["Tracers"].shape[0]
                           if has_tr else 0)
                    self._first_step, self._step = fast.make_fast_step(
                        cfg, self.geom, ref_state=self.reference,
                        mesh=mesh, ntracers=ntr)
                    self._fast = True
                    self._fast_carry = None
                    self._state_mirror = None
                else:
                    self._first_step, self._step = nh_model.make_nh_step(
                        cfg, self.geom, ref_state=self.reference,
                        mesh=mesh)
                self._imex_step = None
            else:
                from .fast.engine import fast_imex_supported
                has_tr = (self.state is not None
                          and "Tracers" in self.state)
                if (cfg.fuse_pallas and mesh is None
                        and fast_imex_supported(cfg, has_tracers=has_tr,
                                                geom=self.geom)):
                    # IMEX-ARK family on the z-first engine (round 5)
                    from .fast.engine import make_fast_imex_step
                    self._imex_step = make_fast_imex_step(
                        cfg, self.geom, ref_state=self.reference)
                else:
                    self._imex_step = nh_model.make_nh_imex_step(
                        cfg, self.geom, ref_state=self.reference,
                        mesh=mesh)

        if mesh is not None and self.state is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            sh = NamedSharding(mesh, P(None, "x", "y"))
            sh_tr = NamedSharding(mesh, P(None, None, "x", "y"))
            self.state = {
                k: jax.device_put(v, sh_tr if k == "Tracers" else sh)
                for k, v in self.state.items()}

    # ------------------------------------------------------------------
    def set_state(self, state, carry=None, time=0.0, step=0):
        self.state = state
        self.carry = carry
        self.time = time
        self.step_count = step

    def restart_from(self, path, perturb: bool = False):
        """Resume from a ``CompositeCheckpoint`` file.

        ``perturb``: re-apply the test case's perturbation to the restored
        state (the reference's ``--perturb_restart``, ``Model.cpp:250-257``
        -> ``Grid::EvaluateTestCase_Perturbation``).
        """
        from .io.output import CompositeCheckpoint
        state, carry, t, step = CompositeCheckpoint.load(path)
        if perturb:
            if not hasattr(self.testcase, "apply_perturbation"):
                raise ValueError(
                    f"test case {type(self.testcase).__name__} has no "
                    "perturbation (apply_perturbation method)")
            state = self.testcase.apply_perturbation(
                state, self.geom, self.cfg.constants)
            carry = None      # carryover combination is stale after a kick
        self.set_state(state, carry, t, step)

    # ------------------------------------------------------------------
    def _advance_one(self):
        cfg = self.cfg
        if cfg.equation_set == EquationSet.SHALLOW_WATER:
            self.state = self._sw_step(self.state)
        elif self._imex_step is not None:
            self.state = self._imex_step(self.state)
        elif self._fast:
            from . import fast
            # keep the z-first state resident; re-pack only if something
            # (restart, workflow process) replaced self.state or any of
            # its arrays.  The mirror check is PER-KEY array identity,
            # not dict identity: a workflow process that mutates the
            # state dict in place (state["Rho"] = new_array; return the
            # same dict) must also invalidate the resident z-first copy.
            mirror = getattr(self, "_state_mirror", None)
            mirror_fresh = (
                mirror is not None
                and set(mirror) == set(self.state)
                and all(self.state[k] is mirror[k] for k in mirror))
            if not mirror_fresh or self.carry is None:
                self._fast_state = fast.pack_state(self.state)
                if self.carry is None:
                    self._fast_carry = None
                elif self.carry is not self._fast_carry:
                    # carry loaded externally (restart); it has state
                    # structure — detect its layout by the W axis
                    if self.carry["W"].shape[-1] == cfg.nz + 1:
                        self._fast_carry = fast.pack_state(self.carry)
                    else:                      # already z-first
                        self._fast_carry = self.carry
            if self._fast_carry is None:
                self._fast_state, self._fast_carry = self._first_step(
                    self._fast_state)
            else:
                self._fast_state, self._fast_carry = self._step(
                    self._fast_state, self._fast_carry)
            self.carry = self._fast_carry
            self.state = fast.unpack_state(self._fast_state)
            # snapshot the dict CONTENTS (shallow copy): in-place key
            # replacement on self.state then fails the per-key check
            self._state_mirror = dict(self.state)
        elif self.carry is None:
            self.state, self.carry = self._first_step(self.state)
        else:
            self.state, self.carry = self._step(self.state, self.carry)
        self.step_count += 1
        self.time += cfg.dt

    def go(self, end_time=None, nsteps: Optional[int] = None):
        """Main loop: step + workflow hooks + scheduled output.

        ``end_time``: duration string or seconds; or pass ``nsteps``.
        """
        if nsteps is None:
            if end_time is None:
                raise ValueError("need end_time or nsteps")
            nsteps = int(round(parse_duration_seconds(end_time)
                               / self.cfg.dt))

        for om in self.output_managers:
            if om.is_output_needed(self.time):
                om.manage_output(self, self.time)

        with self.timers.time("Loop"):
            for _ in range(nsteps):
                with self.timers.time("Step"):
                    self._advance_one()
                for wp in self.workflow_processes:
                    if wp.is_ready(self.time):
                        with self.timers.time("WorkflowProcess"):
                            self.state = wp.fire(self, self.time)
                for om in self.output_managers:
                    if om.is_output_needed(self.time):
                        with self.timers.time("Output"):
                            om.manage_output(self, self.time)
        if self.verbose:
            self.timers.report()
        return self.state

    # ------------------------------------------------------------------
    def profile_phases(self, reps: int = 5):
        """Per-phase timing in the reference FunctionTimer taxonomy.

        The reference accumulates ``FunctionTimer("HorizontalStep")`` etc.
        inside the step (``Model.cpp:520-689``); under ``jit`` the step is
        ONE fused XLA program, so the JAX analog compiles each
        phase standalone and times it.  Standalone timings over-count
        fusion boundaries relative to the fused step — use them to RANK
        phases, not as absolute accounting.  Returns {phase: ms}.
        """
        import time as _time
        import jax as _jax
        from .models import nonhydro, hyperdiff, nh_model
        cfg = self.cfg
        geom = self.geom
        if cfg.equation_set == EquationSet.SHALLOW_WATER:
            raise ValueError("phase profile targets the nonhydro step")
        constants = cfg.constants
        if cfg.grid_kind == GridKind.CUBED_SPHERE:
            dss_state = nh_model.make_sphere_dss(geom)
        else:
            dss_state = nh_model.make_cartesian_dss(geom)
        solver = cfg.vertical_solver
        from .config import VerticalStaggering
        if (solver == "banded"
                and cfg.vertical_staggering == VerticalStaggering.LORENZ):
            q = nonhydro.estimate_bandwidth(geom, constants)
            statics = nonhydro.band_assembly_statics(geom, q)
        else:
            q, statics = 0, None
        phases = {
            "HorizontalStep": _jax.jit(
                lambda s: nonhydro.horizontal_tendency(s, geom, constants)),
            "VerticalStepExplicit": _jax.jit(
                lambda s: nonhydro.vertical_explicit_increment(
                    s, geom, cfg.dt)),
            "VerticalStepImplicit": _jax.jit(
                lambda s: nonhydro.vertical_implicit(
                    s, geom, constants, 0.5 * cfg.dt,
                    newton_iters=cfg.newton_iterations, solver=solver,
                    q=q, band_statics=statics)),
            "Communicate": _jax.jit(dss_state),
            "StepAfterSubCycle": _jax.jit(
                lambda s: hyperdiff.step_after_subcycle_nh(
                    s, cfg.dt, cfg, geom, dss_state, self.reference)),
        }
        out = {}
        for name, fn in phases.items():
            r = fn(self.state)
            _jax.block_until_ready(r)
            t0 = _time.perf_counter()
            for _ in range(reps):
                r = fn(self.state)
            _jax.block_until_ready(r)
            out[name] = (_time.perf_counter() - t0) / reps * 1e3
        return out

    # ------------------------------------------------------------------
    def compute_error_norms(self, reference=None):
        """L1/L2/Linf error vs the test case reference state."""
        ref = reference if reference is not None else self.reference
        if ref is None:
            raise ValueError("no reference state available")
        if "Rho" in self.state:
            return error_norms(self.state, ref, self.geom.area3d,
                               self.geom.area3d_int)
        return error_norms(self.state, ref, self.geom.area2d)
