"""Device texture sampling over the dense TextureTable (plane layout).

Sampling is software gathers (no texture units are used). Descriptor
fetch is one packed-row gather (accel/gather.py); only
actual bitmap pixel fetches touch the pool. Semantics parity:
cuda::Texture::Sample (cuda/texture.h:33-57) — uv transform applied as
[u,v,0,1] through two transform rows, RGB passthrough, the reference's
exact checkerboard fract logic, and bitmap fetch with wrap/clamp/mirror
addressing and point/bilinear filtering.

``kinds`` specializes the emitted program to the texture kinds present in
the scene (RenderConfig.tex_kinds): an RGB-only scene compiles to a
single table gather with no pool traffic.
"""

from __future__ import annotations

import jax.numpy as jnp

from pupiloptixlab_tpu.accel.gather import gather_cols
from pupiloptixlab_tpu.flatten.types import (
    TEX_ADDRESS,
    TEX_FILTER,
    TEX_H,
    TEX_KIND,
    TEX_OFFSET,
    TEX_OFFSET_BI,
    TEX_PATCH2,
    TEX_RGB,
    TEX_UVT,
    TEX_W,
    TextureTable,
)
from pupiloptixlab_tpu.render.vec import Vec2, Vec3, where

ALL_KINDS = (0, 1, 2)  # rgb, checkerboard, bitmap


def _address(coord, mode):
    """Normalized-coordinate addressing: 0 wrap, 1 clamp, 2 mirror."""
    wrapped = coord - jnp.floor(coord)
    clamped = jnp.clip(coord, 0.0, 1.0)
    m = coord - 2.0 * jnp.floor(coord * 0.5)  # period-2 sawtooth in [0,2)
    mirrored = jnp.where(m > 1.0, 2.0 - m, m)
    return jnp.where(mode == 0, wrapped, jnp.where(mode == 1, clamped, mirrored))


def _fetch(pool, offset, w, h, ix, iy) -> Vec3:
    ix = jnp.clip(ix, 0, jnp.maximum(w - 1, 0))
    iy = jnp.clip(iy, 0, jnp.maximum(h - 1, 0))
    flat = offset + iy * w + ix
    cols = gather_cols(pool, flat)  # (3, N)
    return Vec3(cols[0], cols[1], cols[2])


def sample_texture_cols(
    cols: jnp.ndarray,
    pool: jnp.ndarray,
    uv: Vec2,
    kinds: tuple[int, ...] = ALL_KINDS,
    filters: tuple[int, ...] = (0, 1),
    pool_bi: jnp.ndarray | None = None,
) -> Vec3:
    """Sample from pre-gathered packed descriptor columns (TEX_COLS, N).

    ``kinds``/``filters`` specialize the emitted program to the texture
    kinds and bitmap filter modes reachable at THIS call site
    (RenderConfig.mat_tex_* / em_tex_*): each skipped filter mode saves
    pixel-pool gathers, which dominate shading cost on big pools.

    ``pool_bi``: the flattener's (Q, 12) quad pool — when present (Q > 1,
    a static shape check) a bilinear fetch is ONE gather of the packed
    2x2 footprint instead of four pool gathers (measured 27 -> ~9 ms per
    2M-lane env fetch). Texel values and blend order match the
    four-fetch path bit for bit (flatten._quad_pack)."""
    rgb = Vec3(cols[TEX_RGB.start], cols[TEX_RGB.start + 1], cols[TEX_RGB.start + 2])
    if tuple(kinds) == (0,):
        return rgb  # constant-color-only scene

    kind = cols[TEX_KIND]
    a, b, c = cols[TEX_UVT.start], cols[TEX_UVT.start + 1], cols[TEX_UVT.start + 2]
    d, e, f = cols[TEX_UVT.start + 3], cols[TEX_UVT.start + 4], cols[TEX_UVT.start + 5]
    u = a * uv.x + b * uv.y + c
    v = d * uv.x + e * uv.y + f

    out = rgb
    if 1 in kinds:
        # checkerboard (cuda/texture.h:42-50): truncate toward 0, wrap
        fu = u - jnp.where(u > 0.0, jnp.floor(u), jnp.ceil(u))
        fv = v - jnp.where(v > 0.0, jnp.floor(v), jnp.ceil(v))
        fu = jnp.where(fu < 0.0, fu + 1.0, fu)
        fv = jnp.where(fv < 0.0, fv + 1.0, fv)
        patch2 = Vec3(
            cols[TEX_PATCH2.start], cols[TEX_PATCH2.start + 1], cols[TEX_PATCH2.start + 2]
        )
        checker = where((fu > 0.5) == (fv > 0.5), rgb, patch2)
        out = where(kind == 1.0, checker, out)

    if 2 in kinds:
        w = cols[TEX_W]
        h = cols[TEX_H]
        mode = cols[TEX_ADDRESS]
        offset = cols[TEX_OFFSET].astype(jnp.int32)
        au = _address(u, mode)
        av = _address(v, mode)
        wf = jnp.maximum(w, 1.0)
        hf = jnp.maximum(h, 1.0)
        wi = wf.astype(jnp.int32)
        hi = hf.astype(jnp.int32)

        point = linear = None
        if 0 in filters:
            ix = jnp.floor(au * wf).astype(jnp.int32)
            iy = jnp.floor(av * hf).astype(jnp.int32)
            point = _fetch(pool, offset, wi, hi, ix, iy)
        if 1 in filters:
            x = au * wf - 0.5
            y = av * hf - 0.5
            x0 = jnp.floor(x)
            y0 = jnp.floor(y)
            fx = x - x0
            fy = y - y0
            x0i = x0.astype(jnp.int32)
            y0i = y0.astype(jnp.int32)
            if pool_bi is not None and pool_bi.shape[0] > 1:
                offset_bi = cols[TEX_OFFSET_BI].astype(jnp.int32)
                xq = jnp.clip(x0i, -1, wi - 1) + 1
                yq = jnp.clip(y0i, -1, hi - 1) + 1
                q = gather_cols(pool_bi, offset_bi + yq * (wi + 1) + xq)
                c00 = Vec3(q[0], q[1], q[2])
                c10 = Vec3(q[3], q[4], q[5])
                c01 = Vec3(q[6], q[7], q[8])
                c11 = Vec3(q[9], q[10], q[11])
            else:
                c00 = _fetch(pool, offset, wi, hi, x0i, y0i)
                c10 = _fetch(pool, offset, wi, hi, x0i + 1, y0i)
                c01 = _fetch(pool, offset, wi, hi, x0i, y0i + 1)
                c11 = _fetch(pool, offset, wi, hi, x0i + 1, y0i + 1)
            linear = (
                c00 * ((1 - fx) * (1 - fy))
                + c10 * (fx * (1 - fy))
                + c01 * ((1 - fx) * fy)
                + c11 * (fx * fy)
            )
        if point is None:
            bitmap = linear
        elif linear is None:
            bitmap = point
        else:
            bitmap = where(cols[TEX_FILTER] == 1.0, linear, point)
        out = where(kind == 2.0, bitmap, out)

    return out


def sample_texture(
    tex: TextureTable,
    tex_id: jnp.ndarray,
    uv: Vec2,
    kinds: tuple[int, ...] = ALL_KINDS,
    filters: tuple[int, ...] = (0, 1),
) -> Vec3:
    """Sample texture ``tex_id`` (N,) at ``uv`` -> Vec3 linear rgb."""
    cols = gather_cols(tex.packed, tex_id)
    return sample_texture_cols(cols, tex.pool, uv, kinds, filters, tex.pool_bi)
