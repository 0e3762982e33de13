"""Physical constants and thermodynamic conversions.

JAX analog of the reference Tempest ``PhysicalConstants``
(``src/atm/PhysicalConstants.h:121-132`` for the default values,
``:375-428`` for the thermodynamic conversion helpers).  Implemented as a
frozen dataclass usable both host-side (numpy, fp64 precompute) and inside
jitted JAX code (all methods are pure elementwise math).
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class PhysicalConstants:
    """Earth + dry-air thermodynamic constants.

    Defaults match the reference (``PhysicalConstants.h:121-132``).
    """

    earth_radius: float = 6.37122e6   # m
    g: float = 9.80616                # m s^-2
    omega: float = 7.29212e-5         # s^-1
    alpha: float = 0.0                # grid inclination (rad)
    Rd: float = 287.0                 # J kg^-1 K^-1
    Cp: float = 1004.5                # J kg^-1 K^-1
    T0: float = 300.0                 # K reference temperature
    P0: float = 1.0e5                 # Pa reference pressure
    rho_water: float = 1000.0         # kg m^-3
    Rvap: float = 461.5               # J kg^-1 K^-1
    Mvap: float = 0.608               # vapor mass ratio (dimensionless)
    Lvap: float = 2.5e6               # J kg^-1

    # ------------------------------------------------------------------
    # Derived quantities (reference: RecalculateKappa/Gamma/PressureScaling)
    @property
    def kappa(self) -> float:
        """R/Cp."""
        return self.Rd / self.Cp

    @property
    def gamma(self) -> float:
        """Polytropic exponent Cp/Cv = Cp/(Cp-R)."""
        return self.Cp / (self.Cp - self.Rd)

    @property
    def Cv(self) -> float:
        return self.Cp - self.Rd

    @property
    def pressure_scaling(self) -> float:
        """P0 * (Rd/P0)**gamma; P = pressure_scaling * (rho*theta)**gamma."""
        return self.P0 * math.pow(self.Rd / self.P0, self.gamma)

    # ------------------------------------------------------------------
    # Thermodynamic conversions (jnp-friendly; work on scalars or arrays).
    # Reference: PhysicalConstants.h:382-427.
    def pressure_from_rhotheta(self, rhotheta):
        return self.pressure_scaling * jnp.exp(jnp.log(rhotheta) * self.gamma)

    def rhotheta_from_pressure(self, p):
        return jnp.exp(jnp.log(p / self.pressure_scaling) / self.gamma)

    def exner_from_rhotheta(self, rhotheta):
        return self.Cp * jnp.exp(
            self.Rd / (self.Cp - self.Rd) * jnp.log(self.Rd / self.P0 * rhotheta))

    def rhotheta_from_exner(self, pi):
        return self.P0 / self.Rd * jnp.exp(
            (self.Cp - self.Rd) / self.Rd * jnp.log(pi / self.Cp))

    def exner_from_pressure(self, p):
        return self.Cp * jnp.exp(self.Rd / self.Cp * jnp.log(p / self.P0))

    def pressure_from_exner(self, pi):
        return self.P0 * jnp.exp(self.Cp / self.Rd * jnp.log(pi / self.Cp))


DEFAULT_CONSTANTS = PhysicalConstants()
