"""ReSTIR direct illumination (reservoir spatio-temporal resampling).

The reference ships ``restir_test.xml`` (18 shapes, 6 small sphere
lights) as the scene for a ReSTIR-style pass but no implementation; this
module goes beyond parity with a data-parallel ReSTIR-DI estimator
(Bitterli et al. 2020, "Spatiotemporal reservoir resampling for
real-time ray tracing with dynamic direct lighting" — public algorithm,
re-derived here over plane arrays).

Design:

* a Reservoir is six dense (N,) planes (light position / normal /
  radiance ride Vec3 planes) — no AoS, no per-lane control flow;
* candidate generation streams M light samples per pixel through the
  reservoir with pure elementwise updates (lax.fori over static M);
  only the ONE winning sample traces a shadow ray (the whole point of
  ReSTIR: M-candidate quality at 1-ray cost);
* spatial reuse gathers K neighbor reservoirs at per-pixel random
  offsets (one native gather each — coherent access, small K) with the
  standard geometric similarity test to bound bias;
* temporal reuse merges the previous frame's reservoir (M clamped to
  CAP x current M) — reservoir buffers are part of the pass state and
  survive across frames like the accumulation buffer.

Domain: area-type emitters resampled in the AREA measure (p_area = the
per-triangle/sphere 1/(A * select_prob)), where merges need no Jacobian.
An environment light, when present, is handled by one ordinary NEE
sample added on top (ReSTIR reuse across pixels is exact only for
position-parameterized samples).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from functools import partial

import jax
import jax.numpy as jnp

from pupiloptixlab_tpu.flatten.types import RenderConfig, SceneData
from pupiloptixlab_tpu.render import bsdf as bsdf_mod
from pupiloptixlab_tpu.render import emitter as emitter_mod
from pupiloptixlab_tpu.render.sampling import RAY_OFFSET, luminance, to_local
from pupiloptixlab_tpu.render.vec import Vec3, where

_TINY = 1e-12


def _register(cls):
    jax.tree_util.register_dataclass(
        cls, data_fields=[f.name for f in fields(cls)], meta_fields=[]
    )
    return cls


@_register
@dataclass
class Reservoir:
    """Per-pixel weighted reservoir (all (N,) planes)."""

    y_pos: Vec3      # winning light sample position
    y_nrm: Vec3      # its stored surface normal
    y_rad: Vec3      # its radiance toward the receiver
    y_parea: jnp.ndarray  # its source pdf in area measure (incl. select prob)
    w_sum: jnp.ndarray    # running sum of resampling weights
    m: jnp.ndarray        # candidate count seen
    phat: jnp.ndarray     # target value of y at the OWNING pixel

    @staticmethod
    def zeros(n: int) -> "Reservoir":
        z = jnp.zeros(n, jnp.float32)
        return Reservoir(
            y_pos=Vec3.zeros(n), y_nrm=Vec3.zeros(n), y_rad=Vec3.zeros(n),
            y_parea=z, w_sum=z, m=z, phat=z,
        )

    def update(self, u, pos, nrm, rad, parea, w, phat, count):
        """Stream one candidate (weight w, target phat) into the
        reservoir; ``count`` is how many effective candidates it
        represents (1 for fresh samples, r.m for merges)."""
        w_sum = self.w_sum + w
        take = (u * jnp.maximum(w_sum, _TINY)) < w
        return Reservoir(
            y_pos=where(take, pos, self.y_pos),
            y_nrm=where(take, nrm, self.y_nrm),
            y_rad=where(take, rad, self.y_rad),
            y_parea=jnp.where(take, parea, self.y_parea),
            w_sum=w_sum,
            m=self.m + count,
            phat=jnp.where(take, phat, self.phat),
        )

    @property
    def ucw(self) -> jnp.ndarray:
        """Unbiased contribution weight W = w_sum / (m * phat(y))."""
        return self.w_sum / jnp.maximum(self.m * self.phat, _TINY)


def _eval_target(geo, local, mat_types, y_pos: Vec3, y_nrm: Vec3, y_rad: Vec3):
    """p_hat(x, y) = lum(f * L * cos_x * cos_L / d^2) in area measure,
    plus the pieces shading needs. Unshadowed (visibility is applied to
    the winner only)."""
    delta = y_pos - geo.position
    d2 = jnp.maximum(delta.dot(delta), _TINY)
    dist = jnp.sqrt(d2)
    wi = delta * (1.0 / dist)
    wo_local = to_local(geo.wo_world, geo.normal)
    wi_local = to_local(wi, geo.normal)
    f, _ = bsdf_mod.evaluate(local, wo_local, wi_local, mat_types)
    cos_x = jnp.maximum(geo.normal.dot(wi), 0.0)
    cos_l = jnp.maximum(y_nrm.dot(-wi), 0.0)
    g = cos_x * cos_l / d2
    contrib = f * y_rad * g
    return luminance(contrib), contrib, wi, dist


@dataclass
class _GBuf:
    position: Vec3
    normal: Vec3
    wo_world: Vec3


def initial_candidates(
    scene: SceneData,
    config: RenderConfig,
    geo,
    local,
    wo_world: Vec3,
    state,
    m_candidates: int,
):
    """Generate M area-light candidates per pixel and stream them into a
    fresh reservoir. Returns (state', reservoir, gbuf)."""
    em, tex = scene.emitters, scene.textures
    n = geo.position.x.shape[0]
    gb = _GBuf(position=geo.position, normal=geo.normal, wo_world=wo_world)
    r = Reservoir.zeros(n)

    # Candidates are AREA lights only (env light handled separately, see
    # module doc), so the selection distribution must be the CONDITIONAL
    # area distribution: squeeze u_sel into the area CDF range (which
    # spans [0, 1 - env_select_prob)) and divide the nominal per-emitter
    # select_prob by the area mass. Without this, u_sel values past the
    # area CDF clamp onto the last area emitter while parea still uses
    # its nominal select_prob — a pdf that doesn't match the draw.
    area_mass = (
        jnp.maximum(1.0 - em.env_select_prob, _TINY)
        if config.has_env else 1.0
    )
    for _ in range(m_candidates):
        state, (u_sel, u1, u2, u_res) = _draw4(state)
        idx, _use_env = emitter_mod.select_emitter(em, config, u_sel * area_mass)
        es = emitter_mod.sample_direct(
            em, tex, config, idx, jnp.zeros(n, bool),
            geo.position, geo.normal, u1, u2, allow_env=False,
        )
        # solid-angle -> area measure: p_area = p_solid * cos_L / d^2
        delta_l = es.wi * es.distance
        y_pos = geo.position + delta_l
        # recover the light normal from the sample: sample_direct's pdf
        # is d^2/(cos_L * A); steal cos_L via stored planes
        y_nrm = es.light_normal
        cos_l = jnp.maximum(y_nrm.dot(-es.wi), 0.0)
        sel_prob = es.select_prob / area_mass  # conditional area prob
        parea = es.pdf * sel_prob * cos_l / jnp.maximum(
            es.distance * es.distance, _TINY
        )
        phat, _, _, _ = _eval_target(gb, local, config.mat_types, y_pos, y_nrm, es.radiance)
        valid = (es.pdf > 0.0) & (parea > _TINY)
        w = jnp.where(valid, phat / jnp.maximum(parea, _TINY), 0.0)
        r = r.update(u_res, y_pos, y_nrm, es.radiance, parea, w, phat,
                     jnp.ones(n, jnp.float32))
    return state, r, gb


def _draw4(state):
    from pupiloptixlab_tpu.render import rng

    state, us = rng.next_floats(state, 4)
    return state, us


def merge(
    r: Reservoir,
    other: Reservoir,
    gb: _GBuf,
    local,
    mat_types,
    u: jnp.ndarray,
    ok: jnp.ndarray,
    m_cap: jnp.ndarray | float,
) -> Reservoir:
    """Merge ``other`` (a neighbor's or last frame's reservoir) into
    ``r``, re-evaluating the target at r's pixel (Bitterli alg. 4).
    ``ok`` masks geometrically dissimilar neighbors; ``m_cap`` clamps
    the history length (temporal M-capping)."""
    m_o = jnp.minimum(other.m, m_cap) * ok.astype(jnp.float32)
    phat_here, _, _, _ = _eval_target(
        gb, local, mat_types, other.y_pos, other.y_nrm, other.y_rad
    )
    w = phat_here * other.ucw * m_o
    return r.update(u, other.y_pos, other.y_nrm, other.y_rad,
                    other.y_parea, w, phat_here, m_o)


def shade(
    scene: SceneData,
    config: RenderConfig,
    r: Reservoir,
    gb: _GBuf,
    local,
    hit_mask: jnp.ndarray,
    oprim: jnp.ndarray | None = None,
) -> Vec3:
    """Shade the reservoir winner with ONE shadow ray per pixel."""
    from pupiloptixlab_tpu.accel.intersect import intersect_any

    n = r.w_sum.shape[0]
    phat, contrib, wi, dist = _eval_target(
        gb, local, config.mat_types, r.y_pos, r.y_nrm, r.y_rad
    )
    live = hit_mask & (r.w_sum > 0.0) & (phat > _TINY)
    tmin = jnp.full(n, RAY_OFFSET, jnp.float32)
    occluded = intersect_any(
        gb.position, wi, tmin, dist - RAY_OFFSET, scene, config,
        coherent=False, origin_prim=oprim, mask=live,
    )
    take = live & ~occluded
    return where(take, contrib * r.ucw, Vec3.zeros(n))


def similarity(gb: _GBuf, n_pos: Vec3, n_nrm: Vec3) -> jnp.ndarray:
    """Geometric similarity gate for spatial/temporal reuse: normals
    within ~25 degrees and depth-ish distance within 10% of the scene
    scale proxy (|x|)."""
    ndot = gb.normal.dot(n_nrm)
    dp = gb.position - n_pos
    d2 = dp.dot(dp)
    scale = jnp.maximum(gb.position.dot(gb.position), 1.0)
    return (ndot > 0.906) & (d2 < 0.01 * scale)


# -- full-frame ReSTIR-DI estimator ------------------------------------------

N_PACK = 19  # packed reservoir row: 13 reservoir + 3 gb pos + 3 gb normal


def _pack(r: Reservoir, gb: _GBuf) -> jnp.ndarray:
    """Reservoir + G-buffer as one (N, 19) row table so a spatial /
    temporal tap is ONE native gather instead of 19."""
    return jnp.stack(
        [
            r.y_pos.x, r.y_pos.y, r.y_pos.z,
            r.y_nrm.x, r.y_nrm.y, r.y_nrm.z,
            r.y_rad.x, r.y_rad.y, r.y_rad.z,
            r.y_parea, r.w_sum, r.m, r.phat,
            gb.position.x, gb.position.y, gb.position.z,
            gb.normal.x, gb.normal.y, gb.normal.z,
        ],
        axis=1,
    )


def _unpack(rows: jnp.ndarray):
    c = [rows[:, i] for i in range(N_PACK)]
    r = Reservoir(
        y_pos=Vec3(c[0], c[1], c[2]),
        y_nrm=Vec3(c[3], c[4], c[5]),
        y_rad=Vec3(c[6], c[7], c[8]),
        y_parea=c[9], w_sum=c[10], m=c[11], phat=c[12],
    )
    pos = Vec3(c[13], c[14], c[15])
    nrm = Vec3(c[16], c[17], c[18])
    return r, pos, nrm


@partial(
    jax.jit,
    static_argnames=(
        "config", "m_candidates", "spatial_taps", "spatial_radius", "m_cap",
    ),
    donate_argnames=("prev_packed", "accum"),
)
def restir_frame(
    scene: SceneData,
    camera,
    seed: jnp.ndarray,
    prev_packed: jnp.ndarray,   # (N, 19) last frame's packed reservoirs
    accum: jnp.ndarray,         # (N, 3) progressive accumulation
    sample_cnt: jnp.ndarray,
    config: RenderConfig,
    m_candidates: int = 8,
    spatial_taps: int = 3,
    spatial_radius: int = 16,
    m_cap: float = 20.0,
):
    """One ReSTIR-DI frame: primary hit -> M candidates -> temporal merge
    -> K spatial merges -> 1 winner shadow ray -> shade + accumulate.

    Returns (accum', packed_reservoirs, frame_rgb). Temporal reuse is
    identity-warped (static camera); the pass resets prev on camera or
    scene edits, matching the accumulation-reset lifecycle."""
    from pupiloptixlab_tpu.accel.intersect import intersect_closest, origin_sort_prim
    from pupiloptixlab_tpu.render import rng
    from pupiloptixlab_tpu.render.camera import generate_rays
    from pupiloptixlab_tpu.render.geometry import get_local_geometry
    from pupiloptixlab_tpu.render.integrator import _first_hit_emission
    from pupiloptixlab_tpu.render.sampling import MAX_DISTANCE

    em, tex = scene.emitters, scene.textures
    w, h = config.width, config.height
    n = w * h
    state = rng.tea_init(jnp.arange(n, dtype=jnp.uint32), seed)
    state, (jx, jy) = rng.next_floats(state, 2)
    ro, rd = generate_rays(camera, w, h, jx, jy)
    tmin = jnp.full(n, RAY_OFFSET, jnp.float32)
    tmax = jnp.full(n, MAX_DISTANCE, jnp.float32)
    hit = intersect_closest(ro, rd, tmin, tmax, scene, config, coherent=False)
    geo = get_local_geometry(scene, hit, ro, rd, config.sphere_count,
                             config.instanced, config.curve_count)
    local = bsdf_mod.get_local_bsdf(
        scene.materials, tex, geo.mat_id, geo.uv, config.mat_types,
        config.mat_tex_kinds, config.mat_tex_filters,
    )
    active = hit.hit_mask
    radiance = Vec3.zeros(n)

    # directly visible lights / environment (same as the PT first hit)
    if config.has_env:
        env_rad0, _ = emitter_mod.eval_env(em, tex, config, rd)
        radiance = radiance + where(~active, env_rad0, Vec3.zeros(n))
    is_emitter = active & (geo.emitter_id >= 0) & geo.front
    radiance = radiance + where(
        is_emitter, _first_hit_emission(scene, config, geo), Vec3.zeros(n)
    )

    if config.emitter_count > 0:
        state, r, gb = initial_candidates(
            scene, config, geo, local, -rd, state, m_candidates
        )

        # temporal merge (identity warp; similarity-gated, M-capped)
        state, (u_t,) = rng.next_floats(state, 1)
        r_prev, p_pos, p_nrm = _unpack(prev_packed)
        ok_t = similarity(gb, p_pos, p_nrm) & active & (r_prev.m > 0.0)
        r = merge(r, r_prev, gb, local, config.mat_types, u_t, ok_t,
                  m_cap * float(m_candidates))

        # spatial merges: per-pixel random neighbor taps
        packed0 = _pack(r, gb)
        px = jnp.arange(n, dtype=jnp.int32) % w
        py = jnp.arange(n, dtype=jnp.int32) // w
        for _ in range(spatial_taps):
            state, (u1, u2, u3) = rng.next_floats(state, 3)
            dx = jnp.floor((u1 * 2.0 - 1.0) * spatial_radius).astype(jnp.int32)
            dy = jnp.floor((u2 * 2.0 - 1.0) * spatial_radius).astype(jnp.int32)
            nx = jnp.clip(px + dx, 0, w - 1)
            ny = jnp.clip(py + dy, 0, h - 1)
            rows = packed0[ny * w + nx]
            r_n, n_pos, n_nrm = _unpack(rows)
            ok_s = similarity(gb, n_pos, n_nrm) & active & (r_n.m > 0.0)
            r = merge(r, r_n, gb, local, config.mat_types, u3, ok_s,
                      m_cap * float(m_candidates))

        oprim = origin_sort_prim(hit, scene, config)
        radiance = radiance + shade(scene, config, r, gb, local, active, oprim)
        out_packed = _pack(r, gb)
    else:
        gb = _GBuf(position=geo.position, normal=geo.normal, wo_world=-rd)
        out_packed = prev_packed

    # environment light: one plain NEE sample on top (see module doc)
    if config.has_env:
        state, (u1, u2) = rng.next_floats(state, 2)
        es = emitter_mod._env_sample_direct(
            em, tex, config, geo.position, geo.normal, u1, u2
        )
        wi, pdf = es["wi"], es["pdf"]
        wo_local = to_local(-rd, geo.normal)
        wi_local = to_local(wi, geo.normal)
        f, _ = bsdf_mod.evaluate(local, wo_local, wi_local, config.mat_types)
        nol = geo.normal.dot(wi)
        from pupiloptixlab_tpu.accel.intersect import intersect_any

        need = active & (pdf > 0.0) & (nol > 0.0)
        oprim = origin_sort_prim(hit, scene, config)
        occ = intersect_any(
            geo.position, wi, tmin, jnp.full(n, MAX_DISTANCE, jnp.float32),
            scene, config, coherent=False, origin_prim=oprim, mask=need,
        )
        # The env sample is drawn deterministically every pixel (not
        # probabilistically selected), so the estimator divides by the
        # RAW env pdf only — dividing by env_select_prob too would
        # over-count the environment by 1/env_select_prob.
        scale = nol / jnp.maximum(pdf, _TINY)
        radiance = radiance + where(
            need & ~occ, es["radiance"] * f * scale, Vec3.zeros(n)
        )

    rad = radiance.to_array()
    if config.accumulate:
        t = 1.0 / (sample_cnt.astype(jnp.float32) + 1.0)
        blended = accum + (rad - accum) * t
        new_accum = jnp.where(sample_cnt > 0, blended, rad)
    else:
        new_accum = rad
    return new_accum, out_packed, rad
