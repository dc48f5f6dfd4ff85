"""Asynchronous asset streaming: the DeferredLoadingContext analog.

Reference behavior (/root/reference/src/scene/DeferredLoadingContext.cpp
loadingWorker :1031-1054): a background thread loads all meshes first,
then all textures, uploading through a dedicated transfer queue; the
main thread polls once per frame and adopts finished assets
(WorldData::pollMeshWorker/pollTextureWorker), growing the bindless
arrays; unloaded meshes are skipped by the culler via meshletCount==0
(draw_list_generator.comp:38-41).

Mapping (SURVEY.md §7 stage 8): the worker thread does the CPU-side
decode/cluster/mip work and hands numpy blobs over a queue; `poll`
adopts up to a budget per frame (<=10 like the BLAS pacing) and streams
the touched arena ranges to HBM with async device_put. Un-adopted
clusters keep tri_count 0 and degenerate (zero) triangles: rays cannot
hit them and the culler skips them — the same visibility gate.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

MAX_ADOPTIONS_PER_FRAME = 10  # <=10 builds/frame pacing (World.cpp:556)


@dataclass
class LoadedMesh:
    mesh_index: int
    arrays: dict  # processed MeshData arrays (clusters, arenas slice)


@dataclass
class LoadedTexture:
    image_index: int
    offset: int  # quad-arena row offset of the texture's mip chain
    chunk: np.ndarray  # (rows, 4) u32 packed quads, all mips contiguous


class StreamingContext:
    """Background loader with per-frame adoption."""

    def __init__(self, mesh_jobs, texture_jobs) -> None:
        """mesh_jobs/texture_jobs: lists of zero-arg callables returning
        LoadedMesh/LoadedTexture (prepared by World)."""
        self._queue: queue.Queue = queue.Queue()
        self._jobs = (list(mesh_jobs), list(texture_jobs))
        self._thread: threading.Thread | None = None
        self.meshes_loaded = 0
        self.textures_loaded = 0
        self.total_meshes = len(mesh_jobs)
        self.total_textures = len(texture_jobs)
        self._interrupt = threading.Event()

    # -- worker ------------------------------------------------------------

    def start(self) -> None:
        """Launched on the first frame (World::startFrame)."""
        if self._thread is not None:
            return

        def worker():
            # meshes first, then textures (loadingWorker order)
            for job in self._jobs[0]:
                if self._interrupt.is_set():
                    return
                self._queue.put(job())
            for job in self._jobs[1]:
                if self._interrupt.is_set():
                    return
                self._queue.put(job())

        self._thread = threading.Thread(target=worker, daemon=True, name="loadingWorker")
        self._thread.start()

    def interrupt(self) -> None:
        self._interrupt.set()

    # -- main-thread polling -------------------------------------------------

    def poll(self, budget: int = MAX_ADOPTIONS_PER_FRAME):
        """Adopt up to `budget` finished assets; returns the list (may be
        empty). Never blocks (the frame must not stall on loading)."""
        adopted = []
        for _ in range(budget):
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, LoadedMesh):
                self.meshes_loaded += 1
            elif isinstance(item, LoadedTexture):
                self.textures_loaded += 1
            adopted.append(item)
        return adopted

    @property
    def done(self) -> bool:
        return (
            self.meshes_loaded >= self.total_meshes
            and self.textures_loaded >= self.total_textures
        )
