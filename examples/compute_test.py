"""Raw-compute pass demo (the example/cuda_test analog): animate gradients
into three displayable buffers with a jitted device function each frame."""

from __future__ import annotations

import sys
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp

from pupiloptixlab_tpu.passes import ComputePass
from pupiloptixlab_tpu.system import System
from pupiloptixlab_tpu.utils.compile_cache import enable_compile_cache

W = H = 256


@partial(jax.jit, static_argnums=(1, 2))
def animate(frame, w, h):
    idx = jnp.arange(w * h)
    x = (idx % w).astype(jnp.float32) / w
    y = (idx // w).astype(jnp.float32) / h
    t = frame.astype(jnp.float32) * 0.05
    r = 0.5 + 0.5 * jnp.sin(2 * jnp.pi * (x + t))
    g = 0.5 + 0.5 * jnp.sin(2 * jnp.pi * (y + t))
    b = 0.5 + 0.5 * jnp.sin(2 * jnp.pi * (x + y + t))
    return {
        "wave rgb": jnp.stack([r, g, b], axis=-1),
        "wave x": r,
        "wave xy": jnp.stack([r, g], axis=-1),
    }


def main() -> None:
    enable_compile_cache()
    system = System(has_display=True)
    system.add_pass(
        ComputePass(lambda f, w, h: animate(jnp.int32(f), w, h), W, H)
    )
    system._render_flag.set()
    system.run(max_frames=10)
    names = system.buffers.displayable_names()
    print("displayable buffers:", names)
    assert "wave rgb" in names
    system.destroy()


if __name__ == "__main__":
    main()
