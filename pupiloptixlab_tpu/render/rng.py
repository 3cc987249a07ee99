"""Counter-seeded per-lane RNG: TEA scramble init + LCG stream.

Parity: cuda::Random (cuda/random.h) — ``Init(N=4, pixel_index, seed)``
TEA-style scramble followed by an LCG whose 24 high-entropy bits map to
[0, 1). Vectorized over lanes as uint32 ops; every lane consumes the same
number of draws per bounce so the stream is pure data-parallel state.

This exists for determinism: renders are keyed by pixel id and seed, so
golden images and BVH-vs-sweep render pairs compare sample for sample.
Other code may use jax.random instead.
"""

from __future__ import annotations

import jax.numpy as jnp

_LCG_A = jnp.uint32(1664525)
_LCG_C = jnp.uint32(1013904223)


def tea_init(val0: jnp.ndarray, val1: jnp.ndarray, rounds: int = 4) -> jnp.ndarray:
    """TEA scramble of two uint32 words -> per-lane LCG seed."""
    v0 = val0.astype(jnp.uint32)
    v1 = jnp.broadcast_to(jnp.asarray(val1, jnp.uint32), v0.shape)
    s0 = jnp.uint32(0)
    for _ in range(rounds):
        s0 = s0 + jnp.uint32(0x9E3779B9)
        v0 = v0 + (
            ((v1 << 4) + jnp.uint32(0xA341316C))
            ^ (v1 + s0)
            ^ ((v1 >> 5) + jnp.uint32(0xC8013EA4))
        )
        v1 = v1 + (
            ((v0 << 4) + jnp.uint32(0xAD90777D))
            ^ (v0 + s0)
            ^ ((v0 >> 5) + jnp.uint32(0x7E95761E))
        )
    return v0


def next_float(state: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One LCG step; returns (new_state, uniform in [0,1))."""
    state = _LCG_A * state + _LCG_C
    u = (state & jnp.uint32(0x00FFFFFF)).astype(jnp.float32) / jnp.float32(0x01000000)
    return state, u


def next_floats(state: jnp.ndarray, n: int) -> tuple[jnp.ndarray, list[jnp.ndarray]]:
    outs = []
    for _ in range(n):
        state, u = next_float(state)
        outs.append(u)
    return state, outs
