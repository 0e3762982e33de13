"""Fast (z-first) execution engine for the nonhydrostatic core.

The z-first re-expression of the Strang-HEVI step
(``timestep/strang.py`` + ``models/nonhydro.py`` + ``models/hyperdiff.py``
+ ``parallel/dss.py``).  The state is a DICT of per-field z-first arrays

    {U, V, Rt, Rho: (nz, P, A, B), W: (nz+1, P, A, B)
     [, Tracers: (ntr*nz, P, A, B) species-major]}

with P = 6 cubed-sphere panels or 1 Cartesian panel.  Execution shape:

- **vertical column operators** contract the LEADING level axis — clean
  ``(K, nz) @ (nz, P*A*B)`` GEMMs, no layout churn;
- **horizontal operators** are dense block-diagonal (A, A) GEMMs over
  whole fields, and each RK stage's tendency algebra and base
  combination fuse into full-field elementwise passes;
- **DSS** (``fast/dss``): masked-roll pair sums + static panel-edge
  links with covariant U/V rotation (or periodic wrap-sums on Cartesian
  grids), plain JAX;
- **implicit solve** (``fast/implicit``): column aux -> residual ->
  analytic banded Jacobian in XLA, then the batched no-pivot banded LU
  chosen by ``backend.banded_solve`` (a Triton-route Pallas kernel on
  the GPU); tracers solve all species against one factorization
  (multi-RHS);
- **device-mesh distribution** (``mesh_dss``): the SAME per-shard
  engine under one shard_map with statically-routed point-to-point
  ppermute edge exchange (zero all-reduces) and an optional
  halo-overlap schedule, bitwise-equal to the inline one.

Engine output is numerically equivalent to the reference-layout engine
(same operations, different association order; validated at 1e-11 fp64
in ``tests/test_fast_engine.py`` / ``test_fast_xz.py`` /
``test_fast_mesh.py``), but it is NOT the bit-parity path —
golden-parity tests keep using ``models/nonhydro.py``.  The supported
configuration envelope is ``engine.fast_engine_supported``.
"""

from .engine import (FastGeometry, build_fast_geometry,
                     build_fast_geometry_cartesian, pack_state,
                     unpack_state, make_fast_step)
from . import engine
