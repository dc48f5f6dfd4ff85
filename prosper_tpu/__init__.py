"""prosper_tpu — a physically-based rendering engine in JAX.

A from-scratch rebuild of the capabilities of sndels/prosper (C++/Vulkan):
wavefront path tracing, deferred + clustered shading, ReSTIR DI, meshlet
culling, TAA/DoF/bloom post chain, glTF scene streaming — as device-
resident flat scene arrays, functional frame state and jit-compiled frame
graphs. It runs on the CPU (tests) and on NVIDIA GPUs, where the ray
tracer is a CUDA kernel (ops/trace_cuda.py).
"""

__version__ = "0.1.0"
