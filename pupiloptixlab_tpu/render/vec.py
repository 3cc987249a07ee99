"""Vec3: structure-of-planes vectors — the device vector layout.

``Vec3`` stores x/y/z as three dense (N,) planes instead of an (N, 3)
array: every elementwise op reads and writes contiguous arrays, XLA fuses
the per-component math, and no op pays for a narrow minor dimension (this
replaces the role of cuda/vec_math.h float3 in the reference's device
code).

Vec3 is a NamedTuple, hence automatically a jax pytree (valid in jit
args, scan carries, lax.cond branches).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Vec3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # -- geometry -------------------------------------------------------------
    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_sq(self):
        return self.dot(self)

    def length(self):
        return jnp.sqrt(jnp.maximum(self.length_sq(), 0.0))

    def normalized(self) -> "Vec3":
        inv = 1.0 / jnp.maximum(self.length(), 1e-20)
        return Vec3(self.x * inv, self.y * inv, self.z * inv)

    def max_abs(self):
        return jnp.maximum(
            jnp.abs(self.x), jnp.maximum(jnp.abs(self.y), jnp.abs(self.z))
        )

    def sum(self):
        return self.x + self.y + self.z

    # -- conversion / selection --------------------------------------------------
    @staticmethod
    def full(n: int, x: float, y: float, z: float, dtype=jnp.float32) -> "Vec3":
        return Vec3(
            jnp.full(n, x, dtype), jnp.full(n, y, dtype), jnp.full(n, z, dtype)
        )

    @staticmethod
    def zeros(n: int, dtype=jnp.float32) -> "Vec3":
        z = jnp.zeros(n, dtype)
        return Vec3(z, z, z)

    @staticmethod
    def ones(n: int, dtype=jnp.float32) -> "Vec3":
        o = jnp.ones(n, dtype)
        return Vec3(o, o, o)

    @staticmethod
    def from_array(a: jnp.ndarray) -> "Vec3":
        """(N,3) -> planes (one strided read each; use sparingly)."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def from_cols(a: jnp.ndarray, s: slice) -> "Vec3":
        """Rows a[:, s] of a packed (N, C) table -> planes."""
        return Vec3(a[:, s.start], a[:, s.start + 1], a[:, s.start + 2])

    @staticmethod
    def broadcast(v, n: int) -> "Vec3":
        """(3,) constant -> planes broadcast to length n."""
        return Vec3(
            jnp.broadcast_to(v[0], (n,)),
            jnp.broadcast_to(v[1], (n,)),
            jnp.broadcast_to(v[2], (n,)),
        )

    def to_array(self) -> jnp.ndarray:
        """planes -> (N, 3); only at output boundaries."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)


def where(mask, a, b):
    """Lane select over any NamedTuple-of-planes (Vec3, Spec4, ...);
    ``mask`` is (N,) bool."""
    return type(a)(*(jnp.where(mask, ai, bi) for ai, bi in zip(a, b)))


class Vec2(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray

    def __add__(self, o):
        if isinstance(o, Vec2):
            return Vec2(self.x + o.x, self.y + o.y)
        return Vec2(self.x + o, self.y + o)

    def __mul__(self, o):
        if isinstance(o, Vec2):
            return Vec2(self.x * o.x, self.y * o.y)
        return Vec2(self.x * o, self.y * o)

    __rmul__ = __mul__

    @staticmethod
    def zeros(n: int, dtype=jnp.float32) -> "Vec2":
        z = jnp.zeros(n, dtype)
        return Vec2(z, z)

    @staticmethod
    def from_cols(a: jnp.ndarray, s: slice) -> "Vec2":
        return Vec2(a[:, s.start], a[:, s.start + 1])

    def to_array(self) -> jnp.ndarray:
        return jnp.stack([self.x, self.y], axis=-1)


def where2(mask, a: Vec2, b: Vec2) -> Vec2:
    return Vec2(jnp.where(mask, a.x, b.x), jnp.where(mask, a.y, b.y))
