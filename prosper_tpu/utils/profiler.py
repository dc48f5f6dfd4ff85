"""Frame profiler: matched CPU + device timing scopes with a per-frame
report.

The analog of the reference's utils::Profiler (Profiler.hpp:19-327):
GPU timestamp scopes 1:1 matched with CPU chrono scopes, read back a
frame later, <=512 scopes, displayed as a per-scope table. Here:
- CPU scope: perf_counter around the host-side section
- device scope: the same section's dispatched work is fenced with
  block_until_ready at scope exit when `sync` is requested (profiling
  mode), otherwise async dispatch time is attributed like the
  polled-later GPU queries (report reflects the previous frame)
- optional deep tracing via jax.profiler.trace into a directory
  (PROFILER_CPU_GPU_SCOPE's heavyweight sibling)

Usage:
    gprofiler.start_frame()
    with gprofiler.scope("GBuffer", device_arrays=gbuf):
        gbuf = render_gbuffer(...)
    report = gprofiler.end_frame()
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

MAX_SCOPES = 512


@dataclass
class ScopeData:
    name: str
    cpu_ms: float = 0.0
    device_ms: float = 0.0
    count: int = 0


@dataclass
class FrameReport:
    scopes: list[ScopeData] = field(default_factory=list)
    frame_cpu_ms: float = 0.0

    def table(self) -> str:
        lines = [f"{'scope':<28}{'cpu ms':>10}{'device ms':>12}"]
        for s in self.scopes:
            lines.append(f"{s.name:<28}{s.cpu_ms:>10.2f}{s.device_ms:>12.2f}")
        lines.append(f"{'frame':<28}{self.frame_cpu_ms:>10.2f}")
        return "\n".join(lines)


class Profiler:
    def __init__(self, sync_device: bool = False) -> None:
        self.sync_device = sync_device
        self._scopes: list[ScopeData] = []
        self._frame_start = 0.0
        self._previous: FrameReport | None = None
        self._trace_dir: str | None = None

    # -- frame protocol (Profiler::startCpuFrame/endFrame analog) --------

    def start_frame(self) -> None:
        self._scopes = []
        self._frame_start = time.perf_counter()

    def end_frame(self) -> FrameReport:
        report = FrameReport(
            scopes=self._scopes,
            frame_cpu_ms=(time.perf_counter() - self._frame_start) * 1e3,
        )
        self._previous = report
        return report

    def previous(self) -> FrameReport | None:
        """Like the reference's one-frame-later query readback."""
        return self._previous

    # -- scopes -----------------------------------------------------------

    @contextlib.contextmanager
    def scope(self, name: str, result=None):
        """CPU+device scope. Pass the scope's output arrays as `result`
        (or set them via .set_result) to fence device time in sync mode."""
        if len(self._scopes) >= MAX_SCOPES:
            yield lambda _res: None
            return
        data = ScopeData(name=name)
        holder = {}

        def set_result(res):
            holder["res"] = res

        t0 = time.perf_counter()
        yield set_result
        cpu_done = time.perf_counter()
        data.cpu_ms = (cpu_done - t0) * 1e3
        res = holder.get("res", result)
        if self.sync_device and res is not None:
            import jax

            jax.block_until_ready(res)
            data.device_ms = (time.perf_counter() - t0) * 1e3
        data.count = 1
        self._scopes.append(data)

    # -- deep tracing -------------------------------------------------------

    def start_trace(self, log_dir: str) -> None:
        import jax

        self._trace_dir = log_dir
        jax.profiler.start_trace(log_dir)

    def stop_trace(self) -> None:
        import jax

        jax.profiler.stop_trace()
        self._trace_dir = None


# global instance, mirroring utils::gProfiler
gprofiler = Profiler()


# -- per-pass DEVICE profiling (non-blocking) -----------------------------
#
# The reference's per-pass GPU timestamp queries (Profiler.hpp:19-327)
# wrap each pass's command recording; a frame here is ONE fused jit, so
# pass attribution instead rides jax.named_scope: every pass body is
# wrapped in a named scope (render/deferred.py etc.), the compiled HLO
# carries `metadata={op_name="jit(f)/<pass>/..."}` per instruction, and
# one jax.profiler trace of a warm frame yields per-op device self-times
# that are joined on the op name and aggregated per pass. Nothing
# blocks: the traced frames dispatch exactly like the steady-state loop.

_CAPTURE: list | None = None


def profiled_jit_call(fn, *args, **kwargs):
    """Call a frame-level jitted function, recording (fn, args, kwargs)
    when a capture is active so the profiler can AOT-lower the SAME call
    later for its scope map. Mode entries route their jit calls through
    this; overhead outside capture is one global check."""
    if _CAPTURE is not None:
        _CAPTURE.append((fn, args, kwargs))
    return fn(*args, **kwargs)


@contextlib.contextmanager
def capture_jit_calls(out: list):
    global _CAPTURE
    _CAPTURE = out
    try:
        yield out
    finally:
        _CAPTURE = None


def _scope_of_op_name(op_name: str) -> str | None:
    """'jit(f)/transpose/gbuffer/mul' -> 'gbuffer' (first path component
    that is a named scope, i.e. not jit(...)/transpose/vmap(...) glue)."""
    for part in op_name.split("/"):
        if not part or part.startswith(("jit(", "vmap(", "transpose", "pjit")):
            continue
        return part
    return None


def scope_map_from_text(hlo_text: str) -> dict:
    """Compiled-HLO text -> {instruction name: pass scope}."""
    import re

    out = {}
    pat = re.compile(r"%?([\w.\-]+) = .*op_name=\"([^\"]+)\"")
    for line in hlo_text.splitlines():
        if "op_name=" not in line:
            continue
        m = pat.search(line)
        if not m:
            continue
        scope = _scope_of_op_name(m.group(2))
        if scope:
            out[m.group(1)] = scope
    return out


def scope_map_for_calls(calls) -> dict:
    """AOT-lower each captured (jitted fn, args, kwargs) — a cache hit
    for both the local jit cache's lowering and the persistent compile
    cache — and merge the per-module scope maps."""
    merged: dict = {}
    for fn, args, kwargs in calls:
        try:
            txt = fn.lower(*args, **kwargs).compile().as_text()
        except Exception:  # noqa: BLE001 — profiling must not break a run
            continue
        merged.update(scope_map_from_text(txt))
    return merged


_NO_COMMAND_BUFFERS = "--xla_gpu_enable_command_buffer="


def expose_device_ops() -> None:
    """Turn off XLA's CUDA command buffers, so that every kernel of a
    frame is its own event in a profiler trace; a command buffer replays
    many kernels as one opaque event that no pass can claim. Takes effect
    only before JAX creates its GPU backend, and costs the launch savings
    the buffers bring, so profiled frames run somewhat slower."""
    import os

    flags = os.environ.get("XLA_FLAGS", "")
    if _NO_COMMAND_BUFFERS not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} {_NO_COMMAND_BUFFERS}".strip()


def _xplane(trace_dir: str):
    import glob as _glob
    import os as _os

    from jax.profiler import ProfileData

    paths = _glob.glob(
        _os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True
    )
    return ProfileData.from_file(paths[0]) if paths else None


def _is_gpu_plane(name: str) -> bool:
    return name.startswith("/device:GPU:")


def device_events(data):
    """Yield (start_ns, end_ns, hlo_op) for every device-side op event of
    a ProfileData: kernels on the GPU device planes' stream lines and the
    CPU client's thunk lines, both keyed by their `hlo_op` stat (the HLO
    instruction the event ran)."""
    for plane in data.planes:
        gpu = _is_gpu_plane(plane.name)
        for line in plane.lines:
            if gpu:
                if not line.name.startswith("Stream"):
                    continue  # derived module/op/step lines repeat events
            elif not line.name.startswith("tf_XLAPjRtCpuClient"):
                continue
            for ev in line.events:
                op = dict(ev.stats).get("hlo_op")
                if op:
                    yield ev.start_ns, ev.end_ns, op


def _event_rows(trace_dir: str):
    data = _xplane(trace_dir)
    if data is not None:
        yield from device_events(data)


def device_pass_table(trace_dir: str, scope_map: dict, frames: int = 1):
    """[(pass, device_ms/frame)] — per-op SELF times (nested while/cond/
    fusion events otherwise double-count their contents), joined to pass
    scopes via scope_map; unmatched ops aggregate as '(other)'."""
    from collections import defaultdict

    evs = sorted(_event_rows(trace_dir), key=lambda t: (t[0], -t[1]))
    self_ms: dict = defaultdict(float)
    stack: list = []
    child: list = []
    for s, e, name in evs:
        while stack and s >= stack[-1][0]:
            _end, nm, ci = stack.pop()
            dur = child[ci][0]
            self_ms[nm] += (dur - child[ci][1]) / 1e6
            if stack:
                child[stack[-1][2]][1] += dur
        child.append([e - s, 0.0])
        stack.append((e, name, len(child) - 1))
    while stack:
        _end, nm, ci = stack.pop()
        self_ms[nm] += (child[ci][0] - child[ci][1]) / 1e6
        if stack:
            child[stack[-1][2]][1] += child[ci][0]

    per_pass: dict = defaultdict(float)
    for name, ms in self_ms.items():
        per_pass[scope_map.get(name, "(other)")] += ms
    return sorted(
        ((p, ms / max(frames, 1)) for p, ms in per_pass.items()),
        key=lambda kv: -kv[1],
    )


def profile_passes(run_frame, force, frames: int = 2,
                   trace_dir: str | None = None):
    """Non-blocking per-pass device table for a steady-state frame.

    run_frame() dispatches one frame (returning its output arrays);
    force(out) materializes them. One warm call captures the frame's jit
    calls for the scope map, then `frames` calls run under the profiler
    exactly as the frame loop dispatches them."""
    import jax

    calls: list = []
    with capture_jit_calls(calls):
        force(run_frame())  # warm + capture
    scope_map = scope_map_for_calls(calls)
    with _trace_dir(trace_dir) as d:
        with jax.profiler.trace(d):
            for _ in range(frames):
                force(run_frame())
        return device_pass_table(d, scope_map, frames=frames)


def device_op_report(trace_dir: str, top_n: int = 20, runs: int = 1):
    """Per-op DEVICE times from a jax.profiler trace directory.

    The reference's per-pass GPU timestamp queries (Profiler.hpp:19-327)
    in xplane form: wall clock includes host dispatch, so only device
    events measure kernels truthfully. Returns [(hlo op, total_ms / runs)]
    sorted desc."""
    from collections import defaultdict

    totals: dict[str, float] = defaultdict(float)
    for s, e, op in _event_rows(trace_dir):
        totals[op] += (e - s) / 1e6
    out = sorted(totals.items(), key=lambda kv: -kv[1])[:top_n]
    return [(name, ms / max(runs, 1)) for name, ms in out]


def profile_device_ops(fn, force, top_n: int = 20, runs: int = 2,
                       trace_dir: str | None = None):
    """Trace `runs` warm calls of fn and return the top device ops."""
    import jax

    force(fn())  # warm/compile
    with _trace_dir(trace_dir) as d:
        with jax.profiler.trace(d):
            for _ in range(runs):
                force(fn())
        return device_op_report(d, top_n=top_n, runs=runs)


@contextlib.contextmanager
def _trace_dir(path: str | None):
    """The given trace directory (emptied first), or a temporary one that
    is removed afterwards."""
    import shutil
    import tempfile

    if path is not None:
        shutil.rmtree(path, ignore_errors=True)
        yield path
        return
    d = tempfile.mkdtemp(prefix="prosper_trace_")
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)
