"""Frame-graph dispatch: mode name -> unified render callable.

The analog of Renderer::render's mode flags
(/root/reference/src/render/Renderer.cpp:367-670, Renderer.hpp:107-117):
each mode is a jit-compiled functional frame graph
`f(static, frame, arena, cam, lut, ...) -> (image, state)` where `state`
is the persistent FrameState pytree (accumulation buffers, TAA history —
the preserve()d resources of the reference).
"""

from __future__ import annotations

from .forward import render_forward


def _forward_entry(
    *,
    static,
    frame,
    arena,
    cam,
    lut,
    width,
    height,
    exposure=1.0,
    contrast=1.0,
    state=None,
    draw_type=0,
    use_transparent=False,
    **kw,
):
    from ..utils.profiler import profiled_jit_call

    img, hdr = profiled_jit_call(
        render_forward,
        static, frame, arena, cam, lut, width, height, exposure, contrast,
        draw_type, use_transparent,
        alpha_rounds=kw.get("alpha_rounds", 0),
        aniso_taps=kw.get("aniso_taps", 1),
        return_hdr=True,
    )
    return img, {"hdr": hdr}


def frame_hdr(state):
    """The linear HDR frame a mode entry left in its `state`: the running
    mean of pt/restir ((color, count) tuples) or the "hdr" entry of the
    forward and deferred state dicts."""
    if isinstance(state, dict):
        return state["hdr"]
    return state[0]


def render_modes() -> dict:
    from .deferred import deferred_entry
    from .pt import pt_entry
    from .restir import restir_entry

    return {
        "forward": _forward_entry,
        "pt": pt_entry,
        "deferred": deferred_entry,
        "restir": restir_entry,
    }
