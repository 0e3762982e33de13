"""``jax.jit`` that passes the arrays a function closes over as arguments.

A step function closes over its geometry: metric terms, operators and
DSS tables, about 90 MB at ne30 L30.  Under plain ``jax.jit`` those
arrays are compiled into the executable as constants, and XLA's GPU
compiler spends minutes emitting them.  ``hoisted_jit`` traces the
function once per argument signature, takes the closed-over arrays out
of the jaxpr, and gives them to the compiled program as ordinary
device-resident arguments.  The program computes the same thing.

Called inside another trace, a ``hoisted_jit`` function inlines, so an
enclosing ``hoisted_jit`` hoists its constants too.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _place(const, mesh):
    """A closed-over value as a device array: replicated over ``mesh``
    when the arguments are sharded over one, unless it is already
    committed to a placement of its own."""
    if isinstance(const, jax.Array) and (mesh is None or const.committed):
        return const
    if mesh is None:
        return jnp.asarray(const)
    from jax.sharding import NamedSharding, PartitionSpec
    return jax.device_put(const, NamedSharding(mesh, PartitionSpec()))


def _arg_mesh(flat):
    from jax.sharding import NamedSharding
    for x in flat:
        sh = getattr(x, "sharding", None)
        if isinstance(sh, NamedSharding):
            return sh.mesh
    return None


class hoisted_jit:
    """``hoisted_jit(fn)(*args)`` computes ``fn(*args)`` like
    ``jax.jit(fn)``.  ``.compile(*args)`` compiles ahead of time for
    these arguments' signature and returns the ``jax.stages.Compiled``
    (for ``memory_analysis()``); later calls with that signature run it.
    """

    def __init__(self, fn):
        self._fn = fn
        self._entries = {}
        functools.update_wrapper(self, fn)

    def _entry(self, args):
        flat, tree = jax.tree.flatten(args)
        key = (tree, tuple(jax.typeof(x) for x in flat))
        entry = self._entries.get(key)
        if entry is None:
            closed, out_shape = jax.make_jaxpr(
                self._fn, return_shape=True)(*args)
            out_tree = jax.tree.structure(out_shape)
            jaxpr = closed.jaxpr
            mesh = _arg_mesh(flat)
            consts = [_place(c, mesh) for c in closed.consts]

            @jax.jit
            def run(consts, flat_args):
                return jax.tree.unflatten(
                    out_tree, jax.core.eval_jaxpr(jaxpr, consts, *flat_args))

            entry = self._entries[key] = [run, consts]
        return entry, flat

    def __call__(self, *args):
        if any(isinstance(x, jax.core.Tracer)
               for x in jax.tree.leaves(args)):
            return self._fn(*args)
        (run, consts), flat = self._entry(args)
        return run(consts, flat)

    def compile(self, *args):
        entry, flat = self._entry(args)
        run, consts = entry
        if not isinstance(run, jax.stages.Compiled):
            entry[0] = run.lower(consts, flat).compile()
        return entry[0]
