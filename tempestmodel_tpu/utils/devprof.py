"""Device time of a jitted call, read from a JAX profiler trace.

The host clock around a call measures dispatch as well as the device, so
phase ranking uses the trace instead: run the call once to compile,
then trace it ``reps`` times (one trace each) and reduce every trace to

- ``busy_ms``: the union of the intervals in which an operation ran on
  the device's stream lines.  On a GPU trace the same kernel also shows
  on XLA's derived lines ("XLA Ops", "XLA Modules", ...), so only the
  ``Stream`` lines are read and overlapping events count once;
- ``n_kernels``: the events on those lines;
- ``window_ms``: first start to last end, so ``1 - busy/window`` is the
  device's idle share inside the call.

The median over the traces is returned.
"""

from __future__ import annotations

import glob
import shutil
import statistics
import tempfile


def _stream_events(path):
    """(name, start_ns, end_ns) of every event on a device stream line."""
    from jax.profiler import ProfileData
    out = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("Stream"):
                out.extend((e.name, e.start_ns, e.end_ns)
                           for e in line.events)
    return out


def reduce_events(events):
    """Busy time (union of intervals), kernel count, window and the
    per-kernel-name device time (ms) of a list of stream events."""
    busy = 0.0
    cur_s = cur_e = None
    per_name = {}
    for name, s, e in sorted(events, key=lambda ev: ev[1]):
        per_name[name] = per_name.get(name, 0.0) + (e - s) / 1e6
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (max(e for _, _, e in events) - min(s for _, s, _ in events)
              if events else 0.0)
    return {"busy_ms": busy / 1e6, "n_kernels": len(events),
            "window_ms": window / 1e6, "kernels_ms": per_name}


def trace_call(fn, *args, reps: int = 5):
    """Median reduction (see module docstring) over ``reps`` traced calls
    of ``fn(*args)``, after one untraced warm-up call.  Raises when the
    trace holds no device stream events (no GPU, or nothing ran)."""
    import jax

    jax.block_until_ready(fn(*args))
    runs = []
    for _ in range(reps):
        d = tempfile.mkdtemp(prefix="tm_devprof_")
        try:
            with jax.profiler.trace(d):
                jax.block_until_ready(fn(*args))
            files = glob.glob(d + "/plugins/profile/*/*.xplane.pb")
            events = _stream_events(files[0]) if files else []
        finally:
            shutil.rmtree(d, ignore_errors=True)
        if not events:
            raise RuntimeError("profiler trace holds no GPU stream events")
        runs.append(reduce_events(events))
    med = {k: statistics.median(r[k] for r in runs)
           for k in ("busy_ms", "n_kernels", "window_ms")}
    names = set().union(*(r["kernels_ms"] for r in runs))
    med["kernels_ms"] = {n: statistics.median(r["kernels_ms"].get(n, 0.0)
                                              for r in runs)
                         for n in names}
    return med
