"""Display transfer: ACES tone map + gamma, computed on-device.

Parity: the reference's fullscreen-quad pixel shader
(system/gui/output.hlsl:30-73): optional ACES tone mapping then optional
gamma 1/2.2 encode. Runs in jax before the device->host fetch so the
host only receives display-ready bytes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from pupiloptixlab_tpu.render.sampling import aces_tonemap, gamma_correct


@partial(jax.jit, static_argnames=("tone_mapping", "gamma"))
def aces_gamma_to_display(
    rgb: jnp.ndarray, tone_mapping: bool = True, gamma: bool = True
) -> jnp.ndarray:
    """(..., 3) linear radiance -> uint8-ready [0,1] display values."""
    out = rgb
    if tone_mapping:
        out = aces_tonemap(out)
    if gamma:
        out = gamma_correct(out, 2.2)
    return jnp.clip(out, 0.0, 1.0)


@partial(jax.jit, static_argnames=("tone_mapping", "gamma", "stride"))
def to_display_u8(
    rgb: jnp.ndarray, tone_mapping: bool = True, gamma: bool = True,
    stride: int = 1,
) -> jnp.ndarray:
    """(..., 3) linear radiance -> display uint8, quantized ON DEVICE.

    The display pump fetches this instead of the float image: the
    device->host copy moves 4x fewer bytes per frame.

    ``stride`` > 1 additionally subsamples (h, w, 3) input ON DEVICE
    before the fetch — the motion-preview path: during camera drag the
    display pump fetches a quarter-size frame (stride=2) and the browser
    scales it up; full resolution resumes on idle. (The reference's flip
    path always pays full res over PCIe, gui.cpp:358-365.)"""
    if stride > 1:
        rgb = rgb[::stride, ::stride]
    out = aces_gamma_to_display(rgb, tone_mapping, gamma)
    return (out * 255.0 + 0.5).astype(jnp.uint8)


def expand_to_rgba(arr: jnp.ndarray, width: int, height: int) -> jnp.ndarray:
    """float1/2/3/4 buffer -> (h, w, 4) like buffer_to_canvas.cu:6-34."""
    n = width * height
    if arr.ndim == 1:
        arr = arr[:, None]
    c = arr.shape[1]
    out = jnp.ones((n, 4), jnp.float32)
    if c >= 3:
        out = out.at[:, :3].set(arr[:, :3])
        if c == 4:
            out = out.at[:, 3].set(arr[:, 3])
    elif c == 2:
        out = out.at[:, 0].set(arr[:, 0]).at[:, 1].set(arr[:, 1])
    else:
        out = out.at[:, :3].set(arr[:, 0:1])
    return out.reshape(height, width, 4)
