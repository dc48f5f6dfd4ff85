"""Per-pass device profiler plumbing (utils/profiler, round 5).

The end-to-end table is validated on hardware (the round-5 --profile
run found the 567 ms transparent-pass bug); these tests lock the
pieces that must not rot: the HLO-metadata scope parser, the capture
hook, and the named scopes actually reaching compiled modules."""

import jax
import jax.numpy as jnp

from prosper_tpu.utils import profiler as prof


def test_scope_map_from_compiled_named_scopes():
    def f(x):
        with jax.named_scope("gbuffer"):
            y = x @ x + 1.0
        with jax.named_scope("shading"):
            z = jnp.sin(y) * 2.0
        return z

    jf = jax.jit(f)
    x = jnp.ones((64, 64))
    txt = jf.lower(x).compile().as_text()
    m = prof.scope_map_from_text(txt)
    assert m, "no op_name metadata parsed from compiled HLO"
    scopes = set(m.values())
    assert "gbuffer" in scopes and "shading" in scopes
    # glue like jit(...)/transpose path components must not become passes
    assert not any(s.startswith("jit(") for s in scopes)


def test_capture_hook_records_and_calls():
    calls = []
    jf = jax.jit(lambda x: x + 1)
    x = jnp.zeros((4,))
    with prof.capture_jit_calls(calls):
        out = prof.profiled_jit_call(jf, x)
    assert float(out[0]) == 1.0
    assert len(calls) == 1 and calls[0][0] is jf
    # outside a capture the hook is pass-through
    out2 = prof.profiled_jit_call(jf, x)
    assert float(out2[0]) == 1.0 and len(calls) == 1


def test_scope_map_for_calls_compiles_captured():
    def g(x):
        with jax.named_scope("taa"):
            return x * 2.0

    jg = jax.jit(g)
    x = jnp.ones((8, 8))
    m = prof.scope_map_for_calls([(jg, (x,), {})])
    assert "taa" in set(m.values())


def test_device_events_read_gpu_stream_lines():
    """GPU traces: kernel events on a device plane's stream lines, keyed
    by their hlo_op stat; derived lines and host planes are skipped."""
    from types import SimpleNamespace as NS

    def ev(name, s, e, **stats):
        return NS(name=name, start_ns=s, end_ns=e, stats=list(stats.items()))

    data = NS(planes=[
        NS(name="/device:GPU:0", lines=[
            NS(name="Stream #13(Compute)", events=[
                ev("loop_fusion_kernel", 0, 10, hlo_op="fusion.3"),
                ev("memcpy", 10, 12),
            ]),
            NS(name="XLA Ops", events=[ev("fusion.3", 0, 10,
                                          hlo_op="fusion.3")]),
        ]),
        NS(name="/host:CPU", lines=[
            NS(name="python", events=[ev("f", 0, 5, hlo_op="x")]),
        ]),
    ])
    assert list(prof.device_events(data)) == [(0, 10, "fusion.3")]


def test_expose_device_ops_turns_off_command_buffers(monkeypatch):
    """Profiling asks XLA for one trace event per kernel: the command
    buffer flag is appended once to whatever XLA_FLAGS already holds."""
    import os

    from prosper_tpu.utils.profiler import expose_device_ops

    monkeypatch.setenv("XLA_FLAGS", "--xla_dump_to=/dev/null")
    expose_device_ops()
    expose_device_ops()
    flags = os.environ["XLA_FLAGS"].split()
    assert flags == [
        "--xla_dump_to=/dev/null", "--xla_gpu_enable_command_buffer="
    ]
