"""GPU->CPU readbacks: 1-sample texture readback + draw stats.

Parity:
- TextureReadback (src/render/TextureReadback.*, texture_readback.comp):
  one uv sample of a pooled image copied to a host-visible buffer and
  polled ~2 frames later (depth picking for DoF autofocus,
  App.cpp:583-631). Here this is an async device->host copy of one
  value; `poll` resolves it without stalling the frame that issued it.
- draw-stats readback (Renderer.cpp:371-401,851-890): drawn meshlets /
  rasterized triangles as device scalars fetched a frame later.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


class TextureReadback:
    """Issue a 1-sample read this frame, poll it later (non-stalling)."""

    def __init__(self) -> None:
        self._pending = None

    def queue(self, image: jnp.ndarray, uv: tuple[float, float]) -> None:
        h, w = image.shape[:2]
        x = min(int(uv[0] * w), w - 1)
        y = min(int(uv[1] * h), h - 1)
        # keep the 1-element DEVICE array: the slice dispatches
        # asynchronously and the D2H transfer is started eagerly below,
        # but the host never blocks here — resolution happens at poll,
        # ~2 frames later (App.cpp:607-631 copy/poll protocol)
        self._pending = image[y, x]
        try:  # start the transfer in the background where supported
            self._pending.copy_to_host_async()
        except (AttributeError, NotImplementedError):
            pass

    def poll(self):
        """Returns the sampled value or None (startFrame/poll protocol)."""
        if self._pending is None:
            return None
        v = jax.device_get(self._pending)
        self._pending = None
        return v


def focus_from_depth(d: float, cam: dict) -> float:
    """Convert a picked reverse-z depth value to focusDistance
    (linearizeDepth, scene/camera.glsl:11-22; App.cpp:607-631)."""
    c2c = cam["camera_to_clip"]
    lin = -float(c2c[2, 3]) / (d + float(c2c[2, 2]))
    return max(-lin, float(cam["near"]))


def pick_focus_distance(depth: jnp.ndarray, cam: dict, uv) -> float:
    """Depth picking -> focusDistance (App.cpp:607-631). Blocking
    convenience (tests); the CLI uses TextureReadback + focus_from_depth
    for the non-stalling 2-frame-late protocol."""
    h, w = depth.shape
    x = min(int(uv[0] * w), w - 1)
    y = min(int(uv[1] * h), h - 1)
    return focus_from_depth(float(depth[y, x]), cam)


class DrawStats:
    """Frame-later draw-stat counters (drawn meshlets, rasterized tris)."""

    def __init__(self) -> None:
        self._pending: dict | None = None

    def record(self, stats: dict) -> None:
        self._pending = dict(stats)

    def poll(self) -> dict | None:
        if self._pending is None:
            return None
        out = {k: int(v) for k, v in self._pending.items()}
        self._pending = None
        return out
