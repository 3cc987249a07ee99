"""Device emitter sampling/eval over the flattened EmitterTable (planes).

Parity: render/emitter.h + emitter/{area,sphere,env}.h —

* selection by per-emitter probability CDF with environment fallback
  (EmitterGroup::SelectOneEmiiter, emitter.h:104-137) as a searchsorted,
* TriArea / Sphere SampleDirect & Eval with solid-angle pdf
  d^2 / (cos_theta_L * A) (area.h / sphere.h),
* env-map importance sampling over row/col CDFs (env.h:24-64) with the
  linear scans replaced by vectorized searchsorted, and ConstEnv uniform-
  hemisphere sampling (env.h:67-86) — with the const-env Eval pdf fixed
  to its true sampling density 1/2pi (the reference reports 1/4pi, which
  breaks MIS energy conservation; see eval_env).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import jax
import jax.numpy as jnp

from pupiloptixlab_tpu.accel.gather import gather_cols
from pupiloptixlab_tpu.flatten.types import (
    EM_AREA,
    EM_ETYPE,
    EM_RAD_TEX,
    EM_RADIUS,
    EM_SELECT_PROB,
    EM_V0N,
    EM_V0P,
    EM_V0T,
    EM_V1N,
    EM_V1P,
    EM_V1T,
    EM_V2N,
    EM_V2P,
    EM_V2T,
    TEX_OFFSET,
    EmitterTable,
    RenderConfig,
    TextureTable,
)
from pupiloptixlab_tpu.render.sampling import (
    MAX_DISTANCE,
    luminance,
    sphere_texcoord,
    to_world,
    uniform_hemisphere_pdf,
    uniform_sample_hemisphere,
    uniform_sample_sphere,
    uniform_sample_triangle,
)
from pupiloptixlab_tpu.render.texture import sample_texture_cols
from pupiloptixlab_tpu.render.vec import Vec2, Vec3, where, where2


def _register(cls):
    jax.tree_util.register_dataclass(
        cls, data_fields=[f.name for f in fields(cls)], meta_fields=[]
    )
    return cls


@_register
@dataclass
class EmitterSample:
    """EmitterSampleRecord analog (per-lane)."""

    wi: Vec3               # direction toward the light
    distance: jnp.ndarray  # (N,)
    radiance: Vec3
    pdf: jnp.ndarray       # (N,) solid-angle pdf (0 when invalid)
    select_prob: jnp.ndarray  # (N,)
    is_delta: jnp.ndarray  # (N,) bool
    light_normal: Vec3     # sampled light-surface normal (-wi for
                           # env/delta lights); consumed by render/restir.py


def select_emitter(em: EmitterTable, config: RenderConfig, u: jnp.ndarray):
    """CDF walk: first i with u <= cdf[i]; env if beyond all areas.

    Returns (index (N,) into areas, use_env (N,) bool). The selection
    probability is NOT gathered here — sample_direct reads it from the
    packed emitter row it fetches anyway (row[EM_SELECT_PROB]), avoiding a
    native per-ray XLA gather in the NEE hot path.
    """
    n_area = config.emitter_count
    if n_area == 0:
        idx = jnp.zeros_like(u, jnp.int32)
        use_env = jnp.ones_like(u, bool) if config.has_env else jnp.zeros_like(u, bool)
        return idx, use_env
    from pupiloptixlab_tpu.accel.gather import count_less

    cdf = em.select_cdf[:n_area]
    idx = count_less(cdf, u)
    overflow = idx >= n_area
    if config.has_env:
        use_env = overflow
    else:
        use_env = jnp.zeros_like(overflow)
    idx = jnp.minimum(idx, n_area - 1)
    return idx, use_env


def _vec(row, s: slice) -> Vec3:
    return Vec3(row[s.start], row[s.start + 1], row[s.start + 2])


def _uv(row, s: slice) -> Vec2:
    return Vec2(row[s.start], row[s.start + 1])


def sample_direct(
    em: EmitterTable,
    tex: TextureTable,
    config: RenderConfig,
    idx: jnp.ndarray,
    use_env: jnp.ndarray,
    hit_pos: Vec3,
    hit_normal: Vec3,
    u1: jnp.ndarray,
    u2: jnp.ndarray,
    allow_env: bool = True,
) -> EmitterSample:
    """``allow_env=False`` (static) promises every lane has use_env=False
    and skips the env CDF-inversion branch entirely — callers that draw
    area-only candidates (render/restir.py) otherwise pay the full
    row-CDF count + column-CDF gather per candidate for nothing."""
    n = u1.shape[0]
    has_env = config.has_env and allow_env
    row = gather_cols(em.packed, idx)  # one gather for the emitter record
    select_prob = row[EM_SELECT_PROB]
    if config.emitter_count == 0 or has_env:
        select_prob = jnp.where(use_env, em.env_select_prob, select_prob)

    # --- triangle area emitter (area.h:17-35) -------------------------------
    bary = uniform_sample_triangle(u1, u2)
    pos = _vec(row, EM_V0P) * bary.x + _vec(row, EM_V1P) * bary.y + _vec(row, EM_V2P) * bary.z
    nrm = (
        _vec(row, EM_V0N) * bary.x + _vec(row, EM_V1N) * bary.y + _vec(row, EM_V2N) * bary.z
    ).normalized()
    uv = Vec2(
        row[EM_V0T.start] * bary.x + row[EM_V1T.start] * bary.y + row[EM_V2T.start] * bary.z,
        row[EM_V0T.start + 1] * bary.x
        + row[EM_V1T.start + 1] * bary.y
        + row[EM_V2T.start + 1] * bary.z,
    )

    if config.has_sphere_emitter:
        # --- sphere emitter (sphere.h:15-33) ---------------------------------
        is_tri = row[EM_ETYPE] == 0.0
        sph_dir = uniform_sample_sphere(u1, u2)
        pos_sph = sph_dir * row[EM_RADIUS] + _vec(row, EM_V0P)
        uv_sph = sphere_texcoord(sph_dir)
        pos = where(is_tri, pos, pos_sph)
        nrm = where(is_tri, nrm, sph_dir)
        uv = where2(is_tri, uv, uv_sph)

    tex_cols = gather_cols(tex.packed, row[EM_RAD_TEX].astype(jnp.int32))
    radiance = sample_texture_cols(
        tex_cols, tex.pool, uv, config.em_tex_kinds, config.em_tex_filters,
        tex.pool_bi,
    )
    delta = pos - hit_pos
    dist = delta.length()
    wi = delta * (1.0 / jnp.maximum(dist, 1e-20))
    nol = hit_normal.dot(wi)
    lnol = nrm.dot(-wi)
    valid = (nol > 0.0) & (lnol > 0.0)
    pdf = jnp.where(
        valid, dist * dist / jnp.maximum(lnol * row[EM_AREA], 1e-20), 0.0
    )

    # --- delta lights: point (etype 2) / directional (etype 3) -------------
    # The reference declares these but never flattens them (the TODO at
    # world/emitter.cpp:314-316); here they sample with pdf 1 and MIS
    # weight 1 (no BSDF-sampling counterpart can hit a delta light).
    is_delta = jnp.zeros(n, bool)
    if config.has_point_emitter:
        isp = row[EM_ETYPE] == 2.0
        # radiance slot holds the radiant intensity (W/sr) -> I / r^2
        ppos = _vec(row, EM_V0P)
        pd = ppos - hit_pos
        pdist = pd.length()
        wi = where(isp, pd * (1.0 / jnp.maximum(pdist, 1e-20)), wi)
        dist = jnp.where(isp, pdist, dist)
        radiance = where(
            isp, radiance * (1.0 / jnp.maximum(pdist * pdist, 1e-20)), radiance
        )
        pdf = jnp.where(isp, 1.0, pdf)
        is_delta = is_delta | isp
    if config.has_directional_emitter:
        isd = row[EM_ETYPE] == 3.0
        # radiance slot holds the perpendicular irradiance; EM_V0N is the
        # light's travel direction -> wi points against it, at infinity
        wi = where(isd, -_vec(row, EM_V0N), wi)
        dist = jnp.where(isd, MAX_DISTANCE, dist)
        pdf = jnp.where(isd, 1.0, pdf)
        is_delta = is_delta | isd

    # --- environment ----------------------------------------------------------
    if has_env:
        env = _env_sample_direct(em, tex, config, hit_pos, hit_normal, u1, u2)
        wi = where(use_env, env["wi"], wi)
        dist = jnp.where(use_env, env["distance"], dist)
        radiance = where(use_env, env["radiance"], radiance)
        pdf = jnp.where(use_env, env["pdf"], pdf)
        if config.has_point_emitter or config.has_directional_emitter:
            is_delta = is_delta & ~use_env

    if has_env:
        nrm = where(use_env, -wi, nrm)
    return EmitterSample(
        wi=wi,
        distance=dist,
        radiance=radiance,
        pdf=pdf,
        select_prob=select_prob,
        is_delta=is_delta,
        light_normal=where(is_delta, -wi, nrm) if (
            config.has_point_emitter or config.has_directional_emitter
        ) else nrm,
    )


def _env_sample_direct(em, tex, config, hit_pos: Vec3, hit_normal: Vec3, u1, u2):
    w, h = config.env_size
    n = u1.shape[0]
    if w == 0:  # const env (env.h:69-79)
        local = uniform_sample_hemisphere(u1, u2)
        wi = to_world(local, hit_normal)
        return {
            "wi": wi,
            "distance": jnp.full(n, MAX_DISTANCE, jnp.float32),
            "radiance": Vec3.broadcast(em.env_color, n),
            "pdf": uniform_hemisphere_pdf(local),
        }
    # env-map importance sampling: the reference's two-step inversion
    # (env.h:24-48) — walk the sin-weighted ROW CDF with u1, then that
    # row's COLUMN CDF with u2: two searchsorted inversions over small
    # tables (h+1 entries, then the row's w+1 entries gathered as ONE
    # row of the (h, w+1) table) instead of one over the h*w joint CDF.
    from pupiloptixlab_tpu.accel.gather import count_less, gather_cols as _gc

    row = jnp.clip(count_less(em.env_row_cdf, u1) - 1, 0, h - 1)
    col_cdf_rows = _gc(em.env_col_cdf, row)  # (w+1, N)
    col = jnp.clip(
        jnp.sum((col_cdf_rows < u2[None, :]).astype(jnp.int32), axis=0) - 1,
        0,
        w - 1,
    )

    phi = col.astype(jnp.float32) * (2.0 * jnp.pi / w)
    theta = row.astype(jnp.float32) * (jnp.pi / h)
    row_c = jnp.clip(row, 0, h - 1)
    sin_t = jnp.sin(theta)
    local_wi = Vec3(sin_t * jnp.sin(jnp.pi - phi), jnp.cos(theta), sin_t * jnp.cos(jnp.pi - phi))
    m = em.env_to_world
    wi = Vec3(
        m[0, 0] * local_wi.x + m[0, 1] * local_wi.y + m[0, 2] * local_wi.z,
        m[1, 0] * local_wi.x + m[1, 1] * local_wi.y + m[1, 2] * local_wi.z,
        m[2, 0] * local_wi.x + m[2, 1] * local_wi.y + m[2, 2] * local_wi.z,
    )
    # Radiance of the CDF-chosen texel, fetched DIRECTLY from the pixel
    # pool: the inversion picks texel (row, col), and the pdf below is
    # luminance(that texel) * row_weight * norm — a filtered texture
    # sample here would (a) cost 4-5 big-pool gathers instead of 1 and
    # (b) break radiance/pdf consistency at texel boundaries. The
    # reference samples its cudaTexture at the texel's own uv (env.h),
    # where bilinear weights collapse onto the same texel.
    rad_id = jnp.broadcast_to(em.env_radiance_tex, (n,)).astype(jnp.int32)
    tex_cols = gather_cols(tex.packed, rad_id)
    texel = tex_cols[TEX_OFFSET].astype(jnp.int32) + row_c * w + col
    pool_cols = gather_cols(tex.pool, texel)
    radiance = Vec3(pool_cols[0], pool_cols[1], pool_cols[2]) * em.env_scale
    row_w = gather_cols(em.env_row_weight[:, None], row_c)[0]
    pdf = (
        luminance(radiance)
        * row_w
        * em.env_normalization
        / jnp.maximum(jnp.abs(sin_t), 1e-4)
    )
    return {
        "wi": wi,
        "distance": jnp.full(n, MAX_DISTANCE, jnp.float32),
        "radiance": radiance,
        "pdf": jnp.maximum(pdf, 0.0),
    }


def eval_hit_emitter(
    em: EmitterTable,
    tex: TextureTable,
    config: RenderConfig,
    emitter_id: jnp.ndarray,
    hit_pos: Vec3,
    hit_normal: Vec3,
    hit_uv: Vec2,
    scatter_pos: Vec3,
):
    """Area-emitter Eval at a BSDF-sampled hit (area.h:37-46 dispatch);
    returns (radiance Vec3, pdf (N,), select_prob (N,)).
    Valid only where emitter_id >= 0."""
    idx = jnp.maximum(emitter_id, 0)
    row = gather_cols(em.packed, idx)
    dir_to_scatter = (scatter_pos - hit_pos).normalized()
    lnol = hit_normal.dot(dir_to_scatter)
    dist = (scatter_pos - hit_pos).length()
    pdf = jnp.where(
        lnol > 0.0, dist * dist / jnp.maximum(lnol * row[EM_AREA], 1e-20), 0.0
    )
    tex_cols = gather_cols(tex.packed, row[EM_RAD_TEX].astype(jnp.int32))
    radiance = sample_texture_cols(
        tex_cols, tex.pool, hit_uv, config.em_tex_kinds, config.em_tex_filters,
        tex.pool_bi,
    )
    ok = emitter_id >= 0
    n = idx.shape[0]
    return (
        where(ok, radiance, Vec3.zeros(n)),
        jnp.where(ok, pdf, 0.0),
        row[EM_SELECT_PROB],
    )


def eval_env(
    em: EmitterTable,
    tex: TextureTable,
    config: RenderConfig,
    ray_dir: Vec3,
):
    """Environment Eval along escaped rays (env.h:51-64 / env.h:81-85);
    returns (radiance Vec3, pdf (N,))."""
    n = ray_dir.x.shape[0]
    if not config.has_env:
        return Vec3.zeros(n), jnp.zeros(n, jnp.float32)
    w, h = config.env_size
    if w == 0:  # const env
        # Deviation from the reference: env.h:81-85 reports 1/4pi here while
        # SampleDirect draws uniform-hemisphere (1/2pi, env.h:69-79). The
        # mismatch makes balance-MIS weights sum to >1 (white furnace
        # converges to ~1.15). We report the true sampling density so the
        # estimator is energy-conserving.
        return Vec3.broadcast(em.env_color, n), jnp.full(n, 0.5 / jnp.pi, jnp.float32)
    m = em.env_to_local
    d = Vec3(
        m[0, 0] * ray_dir.x + m[0, 1] * ray_dir.y + m[0, 2] * ray_dir.z,
        m[1, 0] * ray_dir.x + m[1, 1] * ray_dir.y + m[1, 2] * ray_dir.z,
        m[2, 0] * ray_dir.x + m[2, 1] * ray_dir.y + m[2, 2] * ray_dir.z,
    )
    phi = jnp.pi - jnp.arctan2(d.x, d.z)
    theta = jnp.arccos(jnp.clip(d.y, -1.0, 1.0))
    uv = Vec2(phi * 0.5 / jnp.pi, theta / jnp.pi)
    rad_id = jnp.broadcast_to(em.env_radiance_tex, (n,)).astype(jnp.int32)
    tex_cols = gather_cols(tex.packed, rad_id)
    radiance = (
        sample_texture_cols(
            tex_cols, tex.pool, uv, (2,), (config.env_filter,), tex.pool_bi
        )
        * em.env_scale
    )
    rowf = uv.y * h
    row = jnp.clip(rowf.astype(jnp.int32), 0, h - 2)
    frac = rowf - row.astype(jnp.float32)
    w_pair = gather_cols(
        jnp.stack([em.env_row_weight[:-1], em.env_row_weight[1:]], axis=1), row
    ) if h > 1 else jnp.zeros((2, n))
    weight = (
        w_pair[0] * (1.0 - frac) + w_pair[1] * frac
        if h > 1
        else jnp.broadcast_to(em.env_row_weight[0], rowf.shape)
    )
    pdf = (
        luminance(radiance)
        * weight
        * em.env_normalization
        / jnp.maximum(jnp.abs(jnp.sin(theta)), 1e-4)
    )
    return radiance, pdf
