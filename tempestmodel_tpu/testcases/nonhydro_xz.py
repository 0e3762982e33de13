"""Cartesian x-z slice nonhydrostatic test cases.

JAX ports of the reference ``test/nonhydro_xz/`` battery: pointwise
initial/reference state evaluators over (x, z) converted to the prognostic
state dict (U, V, Rt, W, Rho) with Lorenz staggering.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from ..constants import PhysicalConstants
from ..grid.cartesian import CartesianGeometry


def _state_dict(geom: CartesianGeometry, theta_lev, rho_lev, u_lev=None,
                dtype=jnp.float64, rt_int=None, w_on_levels=False):
    """Assemble the staggered state from level fields (W = 0).

    ``rt_int``: Charney-Phillips initialization — RhoTheta evaluated on
    interfaces replaces the level Rt (``--vstagger CPH``).
    ``w_on_levels``: LEV staggering — W lives on the nz model levels.
    """
    shape = np.asarray(geom.z_lev).shape
    zeros = np.zeros(shape)
    u = zeros if u_lev is None else np.broadcast_to(u_lev, shape)
    rt = rho_lev * theta_lev if rt_int is None else rt_int
    nw = geom.nz if w_on_levels else geom.nz + 1
    w = np.zeros(shape[:3] + (nw,))
    return {
        "U": jnp.asarray(np.broadcast_to(u, shape).copy(), dtype),
        "V": jnp.asarray(zeros, dtype),
        "Rt": jnp.asarray(rt, dtype),
        "W": jnp.asarray(w, dtype),
        "Rho": jnp.asarray(rho_lev, dtype),
    }


@dataclasses.dataclass(frozen=True)
class ThermalBubble:
    """Giraldo et al. (2007) rising thermal bubble.

    Reference: ``test/nonhydro_xz/ThermalBubbleCartesianTest.cpp`` (defaults
    ThetaBar=300, ThetaC=0.5, rC=250, xC=500, zC=350; domain [0,1000]^2 m,
    36x1 elements, 72 levels).
    """
    theta_bar: float = 300.0
    theta_c: float = 0.5
    r_c: float = 250.0
    x_c: float = 500.0
    z_c: float = 350.0

    x_extent = (0.0, 1000.0)
    y_extent = (-500.0, 500.0)
    ztop = 1000.0

    def theta_perturbation(self, x, z):
        r = np.sqrt((x - self.x_c) ** 2 + (z - self.z_c) ** 2)
        return np.where(
            r <= self.r_c,
            0.5 * self.theta_c * (1.0 + np.cos(np.pi * r / self.r_c)),
            0.0)

    def _background(self, z, constants: PhysicalConstants):
        c = constants
        exner = 1.0 - c.g / (c.Cp * self.theta_bar) * z
        rho = c.P0 / (c.Rd * self.theta_bar) * exner ** (c.Cv / c.Rd)
        return rho

    def initial_state(self, geom: CartesianGeometry,
                      constants: PhysicalConstants, dtype=jnp.float64):
        z = np.asarray(geom.z_lev)
        x = np.asarray(geom.x)[None, :, None, None]
        theta = self.theta_bar + self.theta_perturbation(
            np.broadcast_to(x, z.shape), z)
        rho = self._background(z, constants)
        return _state_dict(geom, theta, rho, dtype=dtype)

    def reference_state(self, geom, constants, dtype=jnp.float64):
        z = np.asarray(geom.z_lev)
        theta = np.full(z.shape, self.theta_bar)
        rho = self._background(z, constants)
        return _state_dict(geom, theta, rho, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class DensityCurrent:
    """Straka et al. (1993) density current.

    Reference: ``test/nonhydro_xz/DensityCurrentCartesianTest.cpp``
    (ThetaBar=300, ThetaC=-15, rC=1, xC=0, zC=3000; domain [0, 25.6 km] x
    [0, 6.4 km]).
    """
    theta_bar: float = 300.0
    theta_c: float = -15.0
    r_c: float = 1.0
    x_c: float = 0.0
    z_c: float = 3000.0
    rayleigh: bool = True

    x_extent = (0.0, 25600.0)
    y_extent = (-100.0, 100.0)
    ztop = 6400.0
    bc_x = "noflux"          # reference: BoundaryCondition_NoFlux in X

    def theta_perturbation(self, x, z, exner):
        r = np.sqrt(((x - self.x_c) / 4000.0) ** 2
                    + ((z - self.z_c) / 2000.0) ** 2)
        return np.where(
            r <= self.r_c,
            0.5 * self.theta_c * (1.0 + np.cos(np.pi * r)) / exner, 0.0)

    def _background(self, z, constants: PhysicalConstants):
        c = constants
        exner = 1.0 - c.g / (c.Cp * self.theta_bar) * z
        rho = c.P0 / (c.Rd * self.theta_bar) * exner ** (c.Cv / c.Rd)
        return exner, rho

    def rayleigh_strength(self, z, x=None, y=None):
        """Sponge at the top and both lateral ends (reference ``:173-204``:
        strength 8e-3, depth 1400 m, width 1000 m)."""
        strength = 8.0e-3
        depth, width = 1400.0, 1000.0
        nu = np.where(z > self.ztop - depth,
                      0.5 * strength * (1.0 + np.cos(
                          np.pi * (self.ztop - z) / depth)), 0.0)
        if x is not None:
            x0, x1 = self.x_extent
            nu_r = np.where(x > x1 - width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (x1 - x) / width)), 0.0)
            nu_l = np.where(x < x0 + width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (x - x0) / width)), 0.0)
            nu = np.maximum(nu, np.maximum(nu_r, nu_l))
        return nu

    def initial_state(self, geom, constants, dtype=jnp.float64):
        z = np.asarray(geom.z_lev)
        x = np.broadcast_to(np.asarray(geom.x)[None, :, None, None], z.shape)
        exner, rho = self._background(z, constants)
        theta = self.theta_bar + self.theta_perturbation(x, z, exner)
        return _state_dict(geom, theta, rho, dtype=dtype)

    def reference_state(self, geom, constants, dtype=jnp.float64):
        z = np.asarray(geom.z_lev)
        exner, rho = self._background(z, constants)
        theta = np.full(z.shape, self.theta_bar)
        return _state_dict(geom, theta, rho, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class ScharMountain:
    """Schar et al. (2002) mountain waves over terrain.

    Reference: ``test/nonhydro_xz/ScharMountainCartesianTest.cpp``
    (u0=10, Nbar=0.01, Theta0=280, hC=250, aC=5000, lC=4000; domain
    [-25 km, 25 km] x [0, 21 km]).  Exercises the terrain-following metric.
    """
    u0: float = 10.0
    n_bar: float = 0.01
    theta_0: float = 280.0
    h_c: float = 250.0
    a_c: float = 5000.0
    l_c: float = 4000.0
    rayleigh: bool = True

    x_extent = (-25000.0, 25000.0)
    y_extent = (-200.0, 200.0)
    ztop = 21000.0

    def topography(self, x, y):
        return (self.h_c * np.exp(-(x / self.a_c) ** 2)
                * np.cos(np.pi * x / self.l_c) ** 2)

    def rayleigh_strength(self, z, x=None, y=None):
        strength = 5.0e-3
        depth, width = 5000.0, 5000.0
        nu = np.where(z > self.ztop - depth,
                      0.5 * strength * (1.0 + np.cos(
                          np.pi * (self.ztop - z) / depth)), 0.0)
        if x is not None:
            x0, x1 = self.x_extent
            nu_r = np.where(x > x1 - width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (x1 - x) / width)), 0.0)
            nu_l = np.where(x < x0 + width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (x - x0) / width)), 0.0)
            nu = np.maximum(nu, np.maximum(nu_r, nu_l))
        return nu

    def _background(self, z, constants: PhysicalConstants):
        c = constants
        n2 = self.n_bar ** 2
        theta = self.theta_0 * np.exp(n2 / c.g * z)
        exner = 1.0 + c.g * c.g / (c.Cp * self.theta_0 * n2) * (
            np.exp(-n2 / c.g * z) - 1.0)
        rho = c.P0 / (c.Rd * theta) * exner ** (c.Cv / c.Rd)
        return theta, rho

    def initial_state(self, geom, constants, dtype=jnp.float64):
        z = np.asarray(geom.z_lev)
        theta, rho = self._background(z, constants)
        return _state_dict(geom, theta, rho, u_lev=self.u0, dtype=dtype)

    reference_state = initial_state


@dataclasses.dataclass(frozen=True)
class InertiaGravityWave:
    """Skamarock-Klemp (1994) inertia-gravity waves in a channel.

    Reference: ``test/nonhydro_xz/InertiaGravityCartesianXZTest.cpp``:
    isothermal-N background (N = 0.01 1/s), theta perturbation of width a,
    uniform U0 = 20 m/s; domain 300 km x 10 km.
    """
    n_bar: float = 0.01
    theta_0: float = 300.0
    theta_c: float = 1.0        # reference CLI default (ThetaC)
    h_c: float = 10000.0
    a_c: float = 5000.0
    x_c: float = 100000.0
    u0: float = 20.0

    x_extent = (0.0, 300000.0)
    y_extent = (-100000.0, 100000.0)
    ztop = 10000.0

    def _background(self, z, constants: PhysicalConstants):
        c = constants
        n2 = self.n_bar ** 2
        theta = self.theta_0 * np.exp(n2 / c.g * z)
        exner = 1.0 + c.g * c.g / (c.Cp * self.theta_0 * n2) * (
            np.exp(-n2 / c.g * z) - 1.0)
        rho = c.P0 / (c.Rd * theta) * exner ** (c.Cv / c.Rd)
        return theta, rho

    def theta_perturbation(self, x, z):
        return self.theta_c * np.sin(np.pi * z / self.h_c) / (
            1.0 + ((x - self.x_c) / self.a_c) ** 2)

    def initial_state(self, geom, constants, dtype=jnp.float64,
                      stagger="LOR"):
        z = np.asarray(geom.z_lev)
        x = np.broadcast_to(np.asarray(geom.x)[None, :, None, None], z.shape)
        theta_b, rho = self._background(z, constants)
        theta = theta_b + self.theta_perturbation(x, z)
        rt_int = None
        if stagger == "CPH":
            zi = np.asarray(geom.z_int)
            xi = np.broadcast_to(
                np.asarray(geom.x)[None, :, None, None], zi.shape)
            theta_bi, rho_i = self._background(zi, constants)
            rt_int = rho_i * (theta_bi + self.theta_perturbation(xi, zi))
        return _state_dict(geom, theta, rho, u_lev=self.u0, dtype=dtype,
                           rt_int=rt_int,
                           w_on_levels=(stagger in ("LEV", "INT")))

    def reference_state(self, geom, constants, dtype=jnp.float64):
        z = np.asarray(geom.z_lev)
        theta_b, rho = self._background(z, constants)
        return _state_dict(geom, theta_b, rho, u_lev=self.u0, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class RobertBubble:
    """Robert (1993) rising thermal bubble.

    Reference: ``test/nonhydro_xz/RobertBubbleCartesianTest.cpp`` (defaults
    ThetaBar=300, ThetaC=0.5, rC=250, xC=500, zC=260; domain
    [0,1000] x [0,1500] m, all-periodic lateral BCs).
    """
    theta_bar: float = 300.0
    theta_c: float = 0.5
    r_c: float = 250.0
    x_c: float = 500.0
    z_c: float = 260.0

    x_extent = (0.0, 1000.0)
    y_extent = (-5.0, 5.0)
    ztop = 1500.0

    def theta_perturbation(self, x, z):
        r = np.sqrt((x - self.x_c) ** 2 + (z - self.z_c) ** 2)
        return np.where(
            r <= self.r_c,
            0.5 * self.theta_c * (1.0 + np.cos(np.pi * r / self.r_c)), 0.0)

    def _background(self, z, constants: PhysicalConstants):
        c = constants
        exner = 1.0 - c.g / (c.Cp * self.theta_bar) * z
        return c.P0 / (c.Rd * self.theta_bar) * exner ** (c.Cv / c.Rd)

    def initial_state(self, geom, constants, dtype=jnp.float64):
        z = np.asarray(geom.z_lev)
        x = np.broadcast_to(np.asarray(geom.x)[None, :, None, None], z.shape)
        theta = self.theta_bar + self.theta_perturbation(x, z)
        rho = self._background(z, constants)
        return _state_dict(geom, theta, rho, dtype=dtype)

    def reference_state(self, geom, constants, dtype=jnp.float64):
        z = np.asarray(geom.z_lev)
        theta = np.full(z.shape, self.theta_bar)
        rho = self._background(z, constants)
        return _state_dict(geom, theta, rho, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class ThermalBubble3D:
    """3-D rising thermal bubble (spherical perturbation).

    Reference: ``test/nonhydro_xz/ThermalBubbleCartesian3DTest.cpp``
    (ThetaBar=300, ThetaC=0.5, rC=250, center (500,500,350); domain
    [0,1000]^3 m, all-periodic lateral BCs).
    """
    theta_bar: float = 300.0
    theta_c: float = 0.5
    r_c: float = 250.0
    x_c: float = 500.0
    y_c: float = 500.0
    z_c: float = 350.0

    x_extent = (0.0, 1000.0)
    y_extent = (0.0, 1000.0)
    ztop = 1000.0

    def theta_perturbation(self, x, y, z):
        r = np.sqrt((x - self.x_c) ** 2 + (y - self.y_c) ** 2
                    + (z - self.z_c) ** 2)
        return np.where(
            r <= self.r_c,
            0.5 * self.theta_c * (1.0 + np.cos(np.pi * r / self.r_c)), 0.0)

    def _background(self, z, constants: PhysicalConstants):
        c = constants
        exner = 1.0 - c.g / (c.Cp * self.theta_bar) * z
        return c.P0 / (c.Rd * self.theta_bar) * exner ** (c.Cv / c.Rd)

    def initial_state(self, geom, constants, dtype=jnp.float64):
        z = np.asarray(geom.z_lev)
        x = np.broadcast_to(np.asarray(geom.x)[None, :, None, None], z.shape)
        y = np.broadcast_to(np.asarray(geom.y)[None, None, :, None], z.shape)
        theta = self.theta_bar + self.theta_perturbation(x, y, z)
        rho = self._background(z, constants)
        return _state_dict(geom, theta, rho, dtype=dtype)

    def reference_state(self, geom, constants, dtype=jnp.float64):
        z = np.asarray(geom.z_lev)
        theta = np.full(z.shape, self.theta_bar)
        rho = self._background(z, constants)
        return _state_dict(geom, theta, rho, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class HydrostaticMountain:
    """Hydrostatic mountain waves over an Agnesi profile (Giraldo case 6).

    Reference: ``test/nonhydro_xz/HydrostaticMountainCartesianTest.cpp``
    (u0=20, T0=250 isothermal, hC=1, aC=10000, xC=1.2e5; domain
    [0, 240 km] x [0, 30 km]; Rayleigh 8e-3 over 10 km depth / 20 km width).
    """
    u0: float = 20.0
    t0: float = 250.0
    h_c: float = 1.0
    a_c: float = 10000.0
    x_c: float = 1.2e5
    rayleigh: bool = True

    x_extent = (0.0, 240000.0)
    y_extent = (-1000.0, 1000.0)
    ztop = 30000.0

    def topography(self, x, y):
        return self.h_c / (1.0 + ((x - self.x_c) / self.a_c) ** 2)

    def rayleigh_strength(self, z, x=None, y=None):
        """Replicates the reference exactly, including its inverted left
        sponge (``HydrostaticMountainCartesianTest.cpp:194``: dNormX =
        1 - (x-x0)/width, i.e. zero at the left boundary and maximal at
        the inner sponge edge — kept verbatim for bit-level parity)."""
        strength = 8.0e-3
        depth, width = 10000.0, 20000.0
        nu = np.where(z > self.ztop - depth,
                      0.5 * strength * (1.0 + np.cos(
                          np.pi * (self.ztop - z) / depth)), 0.0)
        if x is not None:
            x0, x1 = self.x_extent
            nu_r = np.where(x > x1 - width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (x1 - x) / width)), 0.0)
            nu_l = np.where(x < x0 + width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (1.0 - (x - x0) / width))), 0.0)
            nu = np.maximum(nu, np.maximum(nu_r, nu_l))
        return nu

    def _background(self, z, constants: PhysicalConstants):
        """Isothermal T0 background: N = g / sqrt(Cp T0)."""
        c = constants
        # Nbar^2 / g = g / (Cp T0) for the isothermal background
        theta = self.t0 * np.exp(c.g / (c.Cp * self.t0) * z)
        exner = np.exp(-c.g / (c.Cp * self.t0) * z)
        rho = c.P0 / (c.Rd * theta) * exner ** (c.Cv / c.Rd)
        return theta, rho

    def initial_state(self, geom, constants, dtype=jnp.float64):
        z = np.asarray(geom.z_lev)
        theta, rho = self._background(z, constants)
        return _state_dict(geom, theta, rho, u_lev=self.u0, dtype=dtype)

    reference_state = initial_state


@dataclasses.dataclass(frozen=True)
class NonHydroMountain:
    """Non-hydrostatic mountain waves over a quartic witch profile.

    Reference: ``test/nonhydro_xz/NonHydroMountainCartesianTest.cpp``
    (u0=10, Nbar=0.01, Theta0=280, hC=1, aC=1000, xC=5e4; domain
    [0, 120 km] x [0, 30 km]; Rayleigh 1e-2 over 5 km depth / 5 km width;
    topography hC / (1 + ((x-xC)/aC)^4), :112-124 active overload).
    """
    u0: float = 10.0
    n_bar: float = 0.01
    theta_0: float = 280.0
    h_c: float = 1.0
    a_c: float = 1000.0
    x_c: float = 5.0e4
    rayleigh: bool = True

    x_extent = (0.0, 120000.0)
    y_extent = (-100.0, 100.0)
    ztop = 30000.0

    def topography(self, x, y):
        t = ((x - self.x_c) / self.a_c) ** 2
        return self.h_c / (1.0 + t * t)

    def rayleigh_strength(self, z, x=None, y=None):
        strength = 1.0e-2
        depth, width = 5000.0, 5000.0
        nu = np.where(z > self.ztop - depth,
                      0.5 * strength * (1.0 + np.cos(
                          np.pi * (self.ztop - z) / depth)), 0.0)
        if x is not None:
            x0, x1 = self.x_extent
            nu_r = np.where(x > x1 - width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (x1 - x) / width)), 0.0)
            nu_l = np.where(x < x0 + width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (x - x0) / width)), 0.0)
            nu = np.maximum(nu, np.maximum(nu_r, nu_l))
        return nu

    def _background(self, z, constants: PhysicalConstants):
        c = constants
        n2 = self.n_bar ** 2
        theta = self.theta_0 * np.exp(n2 / c.g * z)
        exner = 1.0 + c.g * c.g / (c.Cp * self.theta_0 * n2) * (
            np.exp(-n2 / c.g * z) - 1.0)
        rho = c.P0 / (c.Rd * theta) * exner ** (c.Cv / c.Rd)
        return theta, rho

    def initial_state(self, geom, constants, dtype=jnp.float64):
        z = np.asarray(geom.z_lev)
        theta, rho = self._background(z, constants)
        return _state_dict(geom, theta, rho, u_lev=self.u0, dtype=dtype)

    reference_state = initial_state


@dataclasses.dataclass(frozen=True)
class Baroclinic3DChannel:
    """Ullrich-Jablonowski 3-D baroclinic wave in a beta-plane channel.

    Reference: ``test/nonhydro_xz/Baroclinic3DCartesianTest.cpp`` (b=2,
    u0=35, up=1, gamma=0.005, T0=288, Lp=6e5, Xc=2e6, Yc=2.5e6; domain
    [0, 3e7] x [0, 6e6] x [0, 3e4] m; periodic in X, no-flux in Y;
    f/beta-plane at refLat=45N) and the ``...RidgeTest.cpp`` variant
    (``ridge=True``: adds topography hC/(1+exp(((x-2Xc)/aC)^2)) with
    hC=400, aC=1e6, Yc=3e6).  The state is hydrostatically balanced in
    pressure coordinate eta found by pointwise Newton (``EtaFromRLL``).
    """
    b_c: float = 2.0
    u0: float = 35.0
    u_p: float = 1.0
    gamma: float = 0.005
    t0: float = 288.0
    l_p: float = 600000.0
    x_c: float = 2000000.0
    # perturbation center: reference defaults Yc=2.5e6 (non-ridge,
    # Baroclinic3DCartesianTest.cpp) but Yc=3e6 for the ridge variant
    # (Baroclinic3DCartesianRidgeTest.cpp:523); None = variant default.
    y_c: float = None
    ridge: bool = False
    ridge_h: float = 400.0
    ridge_a: float = 1000000.0
    reference_latitude: float = np.pi / 4.0
    rayleigh: bool = True

    x_extent = (0.0, 30000000.0)
    y_extent = (0.0, 6000000.0)
    ztop = 30000.0
    bc_y = "noflux"

    def __post_init__(self):
        if self.y_c is None:
            object.__setattr__(self, "y_c",
                               3000000.0 if self.ridge else 2500000.0)

    @property
    def y0(self):
        return 0.5 * (self.y_extent[1] - self.y_extent[0])

    def topography(self, x, y):
        if not self.ridge:
            return np.zeros_like(np.broadcast_arrays(x, y)[0])
        xloc = 2.0 * self.x_c
        t = ((x - xloc) / self.ridge_a) ** 2
        return self.ridge_h / (1.0 + np.exp(t)) * np.ones_like(
            np.broadcast_arrays(x, y)[0])

    def rayleigh_strength(self, z, x=None, y=None):
        """Top sponge + lateral sponges, replicated exactly from the
        reference (both variants use dRayleighDepth=5000).

        Non-ridge (``Baroclinic3DCartesianTest.cpp:213-249``): the lateral
        terms gate on ``dXp`` against the *y* extent minus width 5e7 —
        always true — and evaluate ``dNormY`` over width 5e7, so the
        reference applies a near-uniform ~full-strength damping toward the
        reference state over the whole channel.  We replicate this quirk
        verbatim for parity (pass ``rayleigh=False`` for the physically
        intended top-sponge-only behavior).

        Ridge (``Baroclinic3DCartesianRidgeTest.cpp:235-270``): proper
        lateral-x sponges of width 2e6, maximal at the x boundaries.
        """
        strength = 1.0e-3 if self.ridge else 5.0e-3
        depth = 5000.0
        nu = np.where(z > self.ztop - depth,
                      0.5 * strength * (1.0 + np.cos(
                          np.pi * (self.ztop - z) / depth)), 0.0)
        if self.ridge and x is not None:
            width = 2.0e6
            x0, x1 = self.x_extent
            nu_r = np.where(x > x1 - width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (x1 - x) / width)), 0.0)
            nu_l = np.where(x < x0 + width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (x - x0) / width)), 0.0)
            nu = np.maximum(nu, np.maximum(nu_r, nu_l))
        elif not self.ridge and x is not None and y is not None:
            width = 5.0e7
            y0, y1 = self.y_extent
            # reference gates on dXp but norms on dYp; both gates are
            # always true for this domain, so the terms are always on
            nu_r = 0.5 * strength * (1.0 + np.cos(np.pi * (y1 - y) / width))
            nu_l = 0.5 * strength * (1.0 + np.cos(np.pi * (y - y0) / width))
            nu = np.maximum(nu, np.maximum(nu_r, nu_l))
        return nu

    def _geo_temp(self, eta, y, c: PhysicalConstants):
        """Geopotential + temperature at (eta, y)
        (``CalculateGeopotentialTemperature``, :270-321)."""
        g, Rd = c.g, c.Rd
        f0 = 2.0 * c.omega * np.sin(self.reference_latitude)
        beta0 = 2.0 * c.omega * np.cos(self.reference_latitude) \
            / c.earth_radius
        Ly = self.y_extent[1] - self.y_extent[0]
        y0 = self.y0
        pi = np.pi
        avg_T = self.t0 * eta ** (Rd * self.gamma / g)
        avg_phi = self.t0 * g / self.gamma * (
            1.0 - eta ** (Rd * self.gamma / g))
        xy_phi = 0.5 * self.u0 * (
            (f0 - beta0 * y0) * (y - y0
                                 - y0 / pi * np.sin(2 * pi * y / Ly))
            + 0.5 * beta0 * (
                y * y - Ly * y / pi * np.sin(2 * pi * y / Ly)
                - 0.5 * Ly * Ly / (pi * pi) * np.cos(2 * pi * y / Ly)
                - Ly * Ly / 3.0 - 0.5 * Ly * Ly / (pi * pi)))
        lg = np.log(eta)
        decay = np.exp(-(lg / self.b_c) ** 2)
        phi = avg_phi + xy_phi * lg * decay
        T = avg_T + xy_phi / Rd * (
            2.0 / (self.b_c ** 2) * lg * lg - 1.0) * decay
        return phi, T

    def _eta_from_z(self, z, y, c: PhysicalConstants):
        """Vectorized Newton for eta(z, y) (``EtaFromRLL``, :223-268)."""
        eta = np.full(np.broadcast_arrays(z, y)[0].shape, 1.0e-5)
        T = None
        for _ in range(100):
            phi, T = self._geo_temp(eta, y, c)
            f = -c.g * z + phi
            df = -c.Rd / eta * T
            new = eta - f / df
            if np.max(np.abs(new - eta)) < 1e-13:
                eta = new
                break
            eta = new
        phi, T = self._geo_temp(eta, y, c)
        return eta, T

    def _u_base(self, eta, y):
        Ly = self.y_extent[1] - self.y_extent[0]
        lg = np.log(eta)
        decay = np.exp(-(lg / self.b_c) ** 2)
        return (-self.u0 * np.sin(np.pi * y / Ly) ** 2 * lg * decay)

    def u_perturbation(self, x, y):
        return self.u_p * np.exp(
            -((x - self.x_c) ** 2 + (y - self.y_c) ** 2)
            / (self.l_p ** 2))

    def _state(self, geom, c, perturb):
        z = np.asarray(geom.z_lev)
        x = np.broadcast_to(np.asarray(geom.x)[None, :, None, None], z.shape)
        y = np.broadcast_to(np.asarray(geom.y)[None, None, :, None], z.shape)
        eta, T = self._eta_from_z(z, y, c)
        u = self._u_base(eta, y)
        if perturb:
            u = u + self.u_perturbation(x, y)
        p = c.P0 * eta
        rho = p / (c.Rd * T)
        theta = np.asarray(c.rhotheta_from_pressure(p)) / rho
        return theta, rho, u

    def initial_state(self, geom, constants, dtype=jnp.float64):
        theta, rho, u = self._state(geom, constants, perturb=True)
        return _state_dict(geom, theta, rho, u_lev=u, dtype=dtype)

    def reference_state(self, geom, constants, dtype=jnp.float64):
        theta, rho, u = self._state(geom, constants, perturb=False)
        return _state_dict(geom, theta, rho, u_lev=u, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class ShearJetMountainWave:
    """Shear jet over a Schar-profile mountain with a tropopause.

    Reference: ``test/nonhydro_xz/ShearJetMtnWave2DCartesianTest.cpp``
    (b=2, u0=10, uj=5, gamma=0.0065, gamma_str=-0.002, T0=280, hC=250,
    aC=5000, lC=4000; domain [-40 km, 40 km] x [0, 30 km], periodic,
    tropopause at 12 km with a 3 km isothermal mixed layer).  The state
    is hydrostatically balanced in the pressure coordinate eta solved
    pointwise by Newton iteration (``EtaFromRLL``), with zonal wind
    u(eta) = u0 - uj/2 ln(eta) exp(-(ln eta / b)^2).  Exercises the
    terrain-following metric with a realistic stratification.
    """
    b_c: float = 2.0
    u0: float = 10.0
    u_j: float = 5.0
    gamma: float = 0.0065
    gamma_str: float = -0.002
    t0: float = 280.0
    h_c: float = 250.0
    a_c: float = 5000.0
    l_c: float = 4000.0
    tp_height: float = 12000.0
    tp_mixed: float = 3000.0
    rayleigh: bool = True

    x_extent = (-40000.0, 40000.0)
    y_extent = (-500.0, 500.0)
    ztop = 30000.0

    def topography(self, x, y):
        return (self.h_c * np.exp(-(x / self.a_c) ** 2)
                * np.cos(np.pi * x / self.l_c) ** 2)

    def rayleigh_strength(self, z, x=None, y=None):
        strength = 1.0e-2
        depth, width = 5000.0, 5000.0
        nu = np.where(z > self.ztop - depth,
                      0.5 * strength * (1.0 + np.cos(
                          np.pi * (self.ztop - z) / depth)), 0.0)
        if x is not None:
            x0, x1 = self.x_extent
            nu_r = np.where(x > x1 - width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (x1 - x) / width)), 0.0)
            nu_l = np.where(x < x0 + width,
                            0.5 * strength * (1.0 + np.cos(
                                np.pi * (x - x0) / width)), 0.0)
            nu = np.maximum(nu, np.maximum(nu_r, nu_l))
        return nu

    def _tp_constants(self, c):
        """Bootstrap tropopause constants (reference constructor
        ``:198-218``): Newton for eta at the tropopause (branch 1) and at
        the top of the mixed layer (branch 2)."""
        g, Rd = c.g, c.Rd

        def newton_b1(z):
            eta = 1.0e-5
            for _ in range(200):
                T = self.t0 * eta ** (Rd * self.gamma / g)
                phi = self.t0 * g / self.gamma * (
                    1.0 - eta ** (Rd * self.gamma / g))
                f = -g * z + phi
                df = -Rd / eta * T
                new = eta - f / df
                if abs(new - eta) < 1e-13:
                    return new, T, phi
                eta = new
            return eta, T, phi

        eta1, T1, phi1 = newton_b1(self.tp_height)

        def newton_b2(z):
            eta = 1.0e-5
            for _ in range(200):
                phi = (-Rd * T1 * np.log(eta) + Rd * T1 * np.log(eta1)
                       + phi1)
                f = -g * z + phi
                df = -Rd / eta * T1
                new = eta - f / df
                if abs(new - eta) < 1e-13:
                    return new, phi
                eta = new
            return eta, phi

        eta2, phi2 = newton_b2(self.tp_height + self.tp_mixed)
        return eta1, T1, phi1, eta2, phi2

    def _profiles(self, z, c):
        """(T, eta) at heights z via vectorized Newton (``EtaFromRLL``)."""
        g, Rd = c.g, c.Rd
        eta1, T1, phi1, eta2, phi2 = self._tp_constants(c)
        z = np.asarray(z, dtype=np.float64)
        b1 = z <= self.tp_height
        b2 = (z > self.tp_height) & (z <= self.tp_height + self.tp_mixed)
        b3 = z > self.tp_height + self.tp_mixed

        eta = np.full(z.shape, 1.0e-5)
        for _ in range(200):
            T = np.where(
                b1, self.t0 * eta ** (Rd * self.gamma / g),
                np.where(b2, T1,
                         T1 * (eta / eta2) ** (Rd * self.gamma_str / g)))
            phi = np.where(
                b1, self.t0 * g / self.gamma * (
                    1.0 - eta ** (Rd * self.gamma / g)),
                np.where(
                    b2, -Rd * T1 * np.log(eta) + Rd * T1 * np.log(eta1)
                    + phi1,
                    T1 * g / self.gamma_str * (
                        1.0 - (eta / eta2) ** (Rd * self.gamma_str / g))
                    + phi2))
            f = -g * z + phi
            df = -Rd / eta * T
            new = eta - f / df
            if np.max(np.abs(new - eta)) < 1e-14:
                eta = new
                break
            eta = new
        T = np.where(
            b1, self.t0 * eta ** (Rd * self.gamma / g),
            np.where(b2, T1,
                     T1 * (eta / eta2) ** (Rd * self.gamma_str / g)))
        return T, eta

    def _state(self, z, c):
        T, eta = self._profiles(z, c)
        lg = np.log(eta)
        u = self.u0 - self.u_j * 0.5 * lg * np.exp(-(lg / self.b_c) ** 2)
        p = c.P0 * eta
        rho = p / (c.Rd * T)
        theta = np.asarray(c.rhotheta_from_pressure(p)) / rho
        return theta, rho, u

    def initial_state(self, geom, constants, dtype=jnp.float64):
        z = np.asarray(geom.z_lev)
        theta, rho, u = self._state(z, constants)
        return _state_dict(geom, theta, rho, u_lev=u, dtype=dtype)

    def reference_state(self, geom, constants, dtype=jnp.float64):
        return self.initial_state(geom, constants, dtype=dtype)
