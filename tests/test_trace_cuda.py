"""The CUDA tracer's Python side (ops/trace_cuda.py): input layout, ray
padding, output shapes and the build. The kernel itself runs only on a
GPU (tests/test_tracer.py's `cuda` cases, tests/test_gpu_parity.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from prosper_tpu.ops import trace_cuda


@pytest.mark.parametrize("R", [1, 127, 128, 129, 1000])
def test_pack_rays_pads_to_whole_blocks(R):
    rng = np.random.default_rng(R)
    o = rng.normal(size=(R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    tmax = rng.uniform(1, 2, R).astype(np.float32)
    rows, n = trace_cuda.pack_rays(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tmax))
    rows = np.asarray(rows)
    assert n == R
    assert rows.shape[0] % trace_cuda.RAY_ALIGN == 0
    assert rows.shape[0] - R < trace_cuda.RAY_ALIGN
    np.testing.assert_array_equal(rows[:R, 0:3], o)
    np.testing.assert_array_equal(rows[:R, 3], tmax)
    np.testing.assert_array_equal(rows[:R, 4:7], d)
    # pad rays can never hit: t_max = 0 and zero direction
    assert (rows[R:] == 0).all()


def test_pack_rays_broadcasts_scalar_tmax():
    o = jnp.zeros((5, 3))
    d = jnp.ones((5, 3))
    rows, _ = trace_cuda.pack_rays(o, d, jnp.inf)
    assert np.isinf(np.asarray(rows)[:5, 3]).all()


def test_pack_tris_layout():
    rng = np.random.default_rng(0)
    tris = {k: jnp.asarray(rng.normal(size=(256, 3)).astype(np.float32))
            for k in ("v0", "e1", "e2")}
    rows = np.asarray(trace_cuda.pack_tris(tris))
    assert rows.shape == (256, 12) and rows.dtype == np.float32
    np.testing.assert_array_equal(rows[:, 0:3], np.asarray(tris["v0"]))
    np.testing.assert_array_equal(rows[:, 3:6], np.asarray(tris["e1"]))
    np.testing.assert_array_equal(rows[:, 6:9], np.asarray(tris["e2"]))
    assert (rows[:, 9:] == 0).all()


def _stub_args(C=4, N=7):
    S = C * 128
    tris = {k: jnp.zeros((S, 3), jnp.float32) for k in ("v0", "e1", "e2")}
    return (tris, jnp.full((C,), 128, jnp.int32), jnp.zeros((N, 6)),
            jnp.zeros((N, 3), jnp.int32))


@pytest.mark.parametrize("R", [100, 4096])
def test_ffi_output_shapes(monkeypatch, R):
    monkeypatch.setattr(trace_cuda, "_register", lambda: None)
    o, d = jnp.zeros((R, 3)), jnp.ones((R, 3))
    args = _stub_args()
    hit = jax.eval_shape(
        lambda o, d: trace_cuda.trace_closest_cuda(*args, o, d, 1e-4,
                                                   jnp.inf), o, d)
    assert {k: (v.shape, v.dtype) for k, v in hit.items()} == {
        "t": ((R,), jnp.float32), "tri": ((R,), jnp.int32),
        "u": ((R,), jnp.float32), "v": ((R,), jnp.float32),
    }
    occ = jax.eval_shape(
        lambda o, d: trace_cuda.trace_any_cuda(*args, o, d, 0.1, 2.0), o, d)
    assert occ.shape == (R,) and occ.dtype == jnp.bool_


def test_operands_cluster_mask_and_tmin():
    tris, count, bounds, meta = _stub_args(C=3)
    o, d = jnp.zeros((10, 3)), jnp.ones((10, 3))
    ops, R, Rp = trace_cuda._operands(tris, count, bounds, meta, None, o, d,
                                      0.25, 1.0)
    assert (R, Rp) == (10, trace_cuda.RAY_ALIGN)
    assert ops[4].dtype == jnp.int32 and (np.asarray(ops[4]) == 1).all()
    np.testing.assert_array_equal(np.asarray(ops[6]), [0.25])
    mask = jnp.asarray([True, False, True])
    ops, _, _ = trace_cuda._operands(tris, count, bounds, meta, mask, o, d,
                                     0.0, 1.0)
    np.testing.assert_array_equal(np.asarray(ops[4]), [1, 0, 1])


def test_build_command_targets_hopper(monkeypatch):
    monkeypatch.setattr(trace_cuda, "_nvcc", lambda: "nvcc")
    cmd = trace_cuda.build_command("out.so")
    assert cmd[0] == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-fmad=false" in cmd  # rounds like the plain tracer
    assert cmd[cmd.index("-I") + 1] == jax.ffi.include_dir()
    assert cmd[cmd.index("-o") + 1] == "out.so"
    assert cmd[-1].endswith(os.path.join("cuda", "trace_bvh.cu"))


def test_library_path_keyed_by_source_hash(monkeypatch, tmp_path):
    """The library name changes with the kernel source and with the build
    flags, so neither edit can load a stale build."""
    path = trace_cuda.library_path()
    assert os.path.dirname(path) == trace_cuda._BUILD_DIR
    assert os.path.basename(path).startswith("libprosper_trace_")
    monkeypatch.setattr(trace_cuda, "_FLAGS", trace_cuda._FLAGS + ("-G",))
    assert trace_cuda.library_path() != path
    monkeypatch.undo()
    src = tmp_path / "trace_bvh.cu"
    with open(trace_cuda._SRC, "rb") as f:
        src.write_bytes(f.read() + b"// edited\n")
    monkeypatch.setattr(trace_cuda, "_SRC", str(src))
    assert trace_cuda.library_path() != path


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(trace_cuda.shutil, "which", lambda _: None)
    monkeypatch.setattr(trace_cuda.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        trace_cuda._nvcc()


def test_failed_build_raises(monkeypatch, tmp_path):
    """A build failure surfaces; the renderer never falls back silently."""
    import subprocess

    monkeypatch.setattr(trace_cuda, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(trace_cuda, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(
        trace_cuda.subprocess, "run",
        lambda *a, **k: subprocess.CompletedProcess(a, 2, "", "boom"),
    )
    with pytest.raises(RuntimeError, match="build failed") as e:
        trace_cuda._build()
    assert "boom" in str(e.value)
