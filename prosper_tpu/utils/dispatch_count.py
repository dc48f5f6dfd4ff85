"""Count device dispatches (XLA module executions) over a code region.

The per-frame dispatch count is a first-class performance invariant: a
steady-state frame must be a handful of fused jit dispatches, the way
the reference submits ONE command buffer per frame (App.cpp:1178-1181
in the reference, one vkQueueSubmit). A past ReSTIR regression was ~50
eager tone-map/accumulation dispatches silently riding outside the jit
— nothing failed, every pixel was right, the frame just serialized
through the host. The budget test (tests/test_dispatch_budget.py) turns
that into a test failure.

Counting mechanism: JAX 0.9's C++ pjit fastpath bypasses every Python
hook for cached calls, so dispatches are counted from a
jax.profiler.trace xplane instead — exact, version-stable, and works
for eager ops too (eager jnp ops are themselves tiny jitted modules):
  - CPU backend: "PjRtCpuExecutable::Execute" events on the /host:CPU
    python line (verified 1:1 with dispatches).
  - device backends: events on a device plane's "XLA Modules" line.
"""

from __future__ import annotations

import glob
import os
import shutil
import tempfile
from contextlib import contextmanager


def _count_xplane(outdir: str) -> int:
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(outdir, "**", "*.xplane.pb"), recursive=True)
    assert paths, f"no xplane under {outdir}"
    n_cpu = 0
    n_dev = 0
    data = ProfileData.from_file(paths[0])
    for plane in data.planes:
        for line in plane.lines:
            if plane.name == "/host:CPU" and line.name == "python":
                for e in line.events:
                    if e.name == "PjRtCpuExecutable::Execute":
                        n_cpu += 1
            elif line.name == "XLA Modules":
                n_dev += sum(1 for _ in line.events)
    # device planes are authoritative when present (a device run also
    # has host python events for the dispatch calls)
    return n_dev if n_dev else n_cpu


@contextmanager
def count_dispatches(result: dict):
    """`with count_dispatches(out): ...` -> out["n"] = executions.

    Callers must force (e.g. float(x.mean())) INSIDE the block so the
    async dispatches actually execute within the traced window; the
    forcing reduction itself counts as one dispatch — budgets include
    it, exactly like the frame loop's per-frame forcing mean.
    """
    import jax

    outdir = tempfile.mkdtemp(prefix="dispatch_count_")
    try:
        with jax.profiler.trace(outdir):
            yield result
        result["n"] = _count_xplane(outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
