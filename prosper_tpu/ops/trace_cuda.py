"""CUDA BVH tracer for NVIDIA Hopper, called through `jax.ffi`.

The kernel (cuda/trace_bvh.cu) walks the per-frame cluster BVH
(accel/bvh.pack_nodes) with one thread per ray and an ordered short
stack, and tests only the live triangles of each visited leaf. It has
the contract of the plain XLA tracer (ops/trace.trace_closest /
trace_any), which stays its reference in the tests.

The shared library is built from the committed source with `nvcc` into
`cuda/build/` the first time a trace is staged, the way scene/native.py
builds `cpp/`. A failed build or load raises: the renderer never drops
to another tracer behind the caller's back.

Input layout (`pack_tris`, `pack_rays`): triangles as (S, 12) f32 rows
v0.xyz e1.xyz e2.xyz pad, three float4 loads per slot; rays as (R, 8)
f32 rows o.xyz t_max | d.xyz pad, two float4 loads per ray, padded to a
multiple of RAY_ALIGN with t_max = 0 rays that can never hit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp

STACK_CAP = 64  # traversal stack entries; the BVH depth must stay below
RAY_ALIGN = 128  # rays per CUDA block (kBlock in trace_bvh.cu)

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC = os.path.join(_ROOT, "cuda", "trace_bvh.cu")
_BUILD_DIR = os.path.join(_ROOT, "cuda", "build")
_TARGETS = {
    "prosper_trace_closest": "ProsperTraceClosest",
    "prosper_trace_any": "ProsperTraceAny",
}
_LIB = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "CUDA tracer: nvcc not found (PATH or /usr/local/cuda/bin); it is "
        "needed to build cuda/trace_bvh.cu"
    )


# -fmad=false: no multiply-add contraction, so the kernel's
# Moller-Trumbore rounds like the plain XLA tracer's and both decide the
# same way on a shared edge (with contraction one tracer found cracks the
# other did not)
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)


def library_path() -> str:
    """Build output for the current kernel source and flags (keyed by
    their hash, so an edited source never loads a stale library)."""
    with open(_SRC, "rb") as f:
        key = f.read() + " ".join(_FLAGS).encode()
    digest = hashlib.sha256(key).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"libprosper_trace_{digest}.so")


def build_command(out: str) -> list[str]:
    return [
        _nvcc(), *_FLAGS, "-I", jax.ffi.include_dir(), "-o", out, _SRC,
    ]


def _build() -> str:
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(
        build_command(tmp), capture_output=True, text=True, timeout=600
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"CUDA tracer build failed ({proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, so)
    return so


def _register() -> None:
    """Build (once) and register the FFI targets with XLA's CUDA platform."""
    global _LIB
    if _LIB is not None:
        return
    lib = ctypes.cdll.LoadLibrary(_build())
    for name, symbol in _TARGETS.items():
        jax.ffi.register_ffi_target(
            name, jax.ffi.pycapsule(getattr(lib, symbol)), platform="CUDA"
        )
    _LIB = lib


def pack_tris(tris: dict) -> jnp.ndarray:
    """{"v0", "e1", "e2"} (S, 3) each -> (S, 12) f32 kernel rows."""
    S = tris["v0"].shape[0]
    return jnp.concatenate(
        [
            tris["v0"].astype(jnp.float32),
            tris["e1"].astype(jnp.float32),
            tris["e2"].astype(jnp.float32),
            jnp.zeros((S, 3), jnp.float32),
        ],
        axis=1,
    )


def pack_rays(ray_o, ray_d, t_max) -> tuple[jnp.ndarray, int]:
    """(R, 3) origins/directions + scalar or (R,) t_max -> ((R_pad, 8) f32
    rows, R). Pad rays carry t_max = 0: no t can satisfy t < 0 <= t_min."""
    R = ray_o.shape[0]
    tmax = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (R,))
    rows = jnp.concatenate(
        [
            ray_o.astype(jnp.float32),
            tmax[:, None],
            ray_d.astype(jnp.float32),
            jnp.zeros((R, 1), jnp.float32),
        ],
        axis=1,
    )
    pad = (-R) % RAY_ALIGN
    if pad:
        rows = jnp.concatenate([rows, jnp.zeros((pad, 8), jnp.float32)])
    return rows, R


def _operands(tris, tri_count, bounds, meta, cluster_mask, ray_o, ray_d,
              t_min, t_max):
    rows, R = pack_rays(ray_o, ray_d, t_max)
    C = tri_count.shape[0]
    mask = (
        jnp.ones((C,), jnp.int32)
        if cluster_mask is None
        else cluster_mask.astype(jnp.int32)
    )
    ops = (
        pack_tris(tris),
        tri_count.astype(jnp.int32),
        bounds.astype(jnp.float32),
        meta.astype(jnp.int32),
        mask,
        rows,
        jnp.asarray(t_min, jnp.float32).reshape(1),
    )
    return ops, R, rows.shape[0]


def trace_closest_cuda(tris, tri_count, bounds, meta, ray_o, ray_d, t_min,
                       t_max, cluster_mask=None):
    """Closest hit: dict t, tri (-1 = miss), u, v — trace.trace_closest's
    contract. cluster_mask (C,) bool: False clusters are never entered."""
    _register()
    ops, R, Rp = _operands(
        tris, tri_count, bounds, meta, cluster_mask, ray_o, ray_d, t_min,
        t_max,
    )
    f32 = jax.ShapeDtypeStruct((Rp,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((Rp,), jnp.int32)
    t, tri, u, v = jax.ffi.ffi_call(
        "prosper_trace_closest", (f32, i32, f32, f32)
    )(*ops)
    return {"t": t[:R], "tri": tri[:R], "u": u[:R], "v": v[:R]}


def trace_any_cuda(tris, tri_count, bounds, meta, ray_o, ray_d, t_min,
                   t_max, cluster_mask=None):
    """Any hit: (R,) bool occluded, exiting at the first hit found."""
    _register()
    ops, R, Rp = _operands(
        tris, tri_count, bounds, meta, cluster_mask, ray_o, ray_d, t_min,
        t_max,
    )
    (occ,) = jax.ffi.ffi_call(
        "prosper_trace_any", (jax.ShapeDtypeStruct((Rp,), jnp.int32),)
    )(*ops)
    return occ[:R] != 0
