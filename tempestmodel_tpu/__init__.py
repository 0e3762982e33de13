"""tempestmodel_tpu: a nonhydrostatic atmospheric dynamical core in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
paullric/tempestmodel: cubed-sphere spectral-element horizontal
discretization, HEVI (horizontally-explicit vertically-implicit) IMEX
timestepping, shallow-water and compressible nonhydrostatic equation sets,
distributed via jax.sharding over device meshes.  It runs on NVIDIA GPUs
and, for tests, on the CPU (``backend.py`` makes the platform choices).
"""

import os as _os

import jax as _jax

# On an NVIDIA GPU, XLA's DEFAULT precision may run f32 matmuls in TF32
# (10-bit mantissa, about three decimal digits).  For a spectral-element
# dynamical core the horizontal derivative/stiffness GEMMs would then
# carry that error into every application, and the trajectory would
# leave the true-f32 one.  Pin every dot/einsum in the package (including
# Pallas in-kernel dots, which read this config at trace time) to
# true-f32 multiply-accumulate.
# Override with TM_MATMUL_PRECISION=default|high|highest|float32.
_prec = _os.environ.get("TM_MATMUL_PRECISION", "float32")
if _prec and _prec != "default":
    _jax.config.update("jax_default_matmul_precision", _prec)

from .backend import configure_compile_cache as _configure_compile_cache

_configure_compile_cache()

from .config import (ModelConfig, EquationSet, GridKind, TimestepSchemeType,
                     ExplicitSubScheme, VerticalStaggering)
from .constants import PhysicalConstants, DEFAULT_CONSTANTS

__version__ = "0.1.0"
