"""Wavefront path tracer: persistent ray pool with continuous refill.

A redesign of the reference README's 3x-faster WavefrontPathTracer
(README.md:16; the shipped framework only provides the DynamicArray queue
primitive for it, cuda/util.h:68-139). Instead of one megakernel
iteration per pixel per frame — where lanes whose paths died idle through
the remaining bounces — a fixed-size pool of live paths is traced one
bounce per iteration, and lanes whose paths terminate are *refilled* with
fresh camera samples in the same iteration. Occupancy stays ~100%
regardless of path-length variance, which is where the wavefront design
earns its speedup on open scenes (escaped rays) and deep max_depth.

Estimator semantics match render/integrator.py exactly (same NEE + MIS +
RR as main.cu); contributions scatter-add into the film keyed by pixel.
Total work is spp * width * height paths per call.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from pupiloptixlab_tpu.accel.intersect import intersect_any, intersect_closest
from pupiloptixlab_tpu.flatten.types import CameraBlock, RenderConfig, SceneData
from pupiloptixlab_tpu.render import bsdf as bsdf_mod
from pupiloptixlab_tpu.render import emitter as emitter_mod
from pupiloptixlab_tpu.render import rng
from pupiloptixlab_tpu.render.camera import generate_rays_for
from pupiloptixlab_tpu.render.sampling import (
    MAX_DISTANCE,
    RAY_OFFSET,
    is_zero,
    mis_weight,
    to_local,
    to_world,
)
from pupiloptixlab_tpu.render.vec import Vec3, where

_TINY = 1e-12


def _scatter_rgb(film, pixel, value: Vec3, mask):
    """film (N,3) += value where mask (duplicate pixels accumulate)."""
    idx = jnp.where(mask, pixel, film.shape[0])  # OOB drops masked lanes
    return (
        film.at[idx, 0].add(value.x, mode="drop")
        .at[idx, 1].add(value.y, mode="drop")
        .at[idx, 2].add(value.z, mode="drop")
    )


@partial(jax.jit, static_argnames=("config", "spp"))
def render_wavefront(
    scene: SceneData,
    camera: CameraBlock,
    seed: jnp.ndarray,
    config: RenderConfig,
    spp: int = 1,
):
    """Render spp samples/pixel with a persistent pool. Returns dict with
    film (N,3) mean radiance + albedo/normal AOV means."""
    w, h = config.width, config.height
    n = w * h
    pool = n  # pool size = one film's worth of lanes
    total_paths = n * spp
    em, tex = scene.emitters, scene.textures
    tmin_c = jnp.full(pool, RAY_OFFSET, jnp.float32)
    tmax_c = jnp.full(pool, MAX_DISTANCE, jnp.float32)
    zero3 = Vec3.zeros(pool)

    film = jnp.zeros((n, 3), jnp.float32)
    albedo = jnp.zeros((n, 3), jnp.float32)
    normal = jnp.zeros((n, 3), jnp.float32)

    # Pool state: a path between two surface events ("in flight" ray).
    state = dict(
        ro=zero3,
        rd=Vec3.full(pool, 0.0, 0.0, 1.0),
        radiance=zero3,  # per-lane accumulator; scattered once at death
        throughput=Vec3.ones(pool),
        rng=jnp.zeros(pool, jnp.uint32),
        pixel=jnp.zeros(pool, jnp.int32),
        depth=jnp.zeros(pool, jnp.int32),  # bounces completed
        pdf_prev=jnp.zeros(pool, jnp.float32),
        delta_prev=jnp.zeros(pool, bool),
        alive=jnp.zeros(pool, bool),
        next_path=jnp.zeros((), jnp.int32),
        film=film,
        albedo=albedo,
        normal=normal,
    )

    def refill(s):
        """Assign fresh camera paths to dead lanes (the queue-append
        analog: positions come from a cumsum over dead lanes)."""
        dead = ~s["alive"]
        order = jnp.cumsum(dead.astype(jnp.int32)) - 1  # rank among dead
        path_idx = s["next_path"] + order
        can_spawn = dead & (path_idx < total_paths)
        spawned = jnp.sum(can_spawn.astype(jnp.int32))

        pixel_new = (path_idx % n).astype(jnp.int32)
        st_new = rng.tea_init(path_idx.astype(jnp.uint32), seed)
        st_new, (jx, jy) = rng.next_floats(st_new, 2)
        ro_new, rd_new = generate_rays_for(camera, w, h, pixel_new, jx, jy)

        s = dict(s)
        s["ro"] = where(can_spawn, ro_new, s["ro"])
        s["rd"] = where(can_spawn, rd_new, s["rd"])
        s["radiance"] = where(can_spawn, Vec3.zeros(pool), s["radiance"])
        s["throughput"] = where(can_spawn, Vec3.ones(pool), s["throughput"])
        s["rng"] = jnp.where(can_spawn, st_new, s["rng"])
        s["pixel"] = jnp.where(can_spawn, pixel_new, s["pixel"])
        s["depth"] = jnp.where(can_spawn, 0, s["depth"])
        s["pdf_prev"] = jnp.where(can_spawn, 0.0, s["pdf_prev"])
        s["delta_prev"] = jnp.where(can_spawn, False, s["delta_prev"])
        s["alive"] = s["alive"] | can_spawn
        s["next_path"] = s["next_path"] + spawned
        s["fresh"] = can_spawn
        return s

    def body(s):
        # flush lanes that died last iteration into the film, then refill
        dead_now = ~s["alive"]
        s["film"] = _scatter_rgb(s["film"], s["pixel"], s["radiance"], dead_now)
        s["radiance"] = where(dead_now, Vec3.zeros(pool), s["radiance"])
        s = refill(s)
        alive = s["alive"]
        fresh = s["fresh"]
        ro, rd = s["ro"], s["rd"]
        throughput = s["throughput"]
        radiance = s["radiance"]

        # ---- trace the in-flight ray ------------------------------------
        # (refill keeps the pool pixel-ordered; per-iteration ray sorting
        # costs more than its culling gain here)
        hit = intersect_closest(ro, rd, tmin_c, tmax_c, scene, config)
        from pupiloptixlab_tpu.render.geometry import get_local_geometry

        geo = get_local_geometry(scene, hit, ro, rd, config.sphere_count,
                             config.instanced, config.curve_count)
        local = bsdf_mod.get_local_bsdf(
            scene.materials, tex, geo.mat_id, geo.uv,
            config.mat_types, config.mat_tex_kinds, config.mat_tex_filters,
        )

        # ---- escaped -> environment -------------------------------------
        env_rad, env_pdf = emitter_mod.eval_env(em, tex, config, rd)
        escaped = alive & ~hit.hit_mask
        # primary rays add env unweighted (main.cu:84); bounced rays MIS
        # against the previous BSDF pdf (main.cu:166-169; the reference
        # applies the balance weight even to delta bounces).
        mis_env = jnp.where(
            fresh, 1.0, mis_weight(s["pdf_prev"], env_pdf * em.env_select_prob)
        )
        radiance = radiance + where(
            escaped, throughput * env_rad * mis_env, Vec3.zeros(pool)
        )
        alive = alive & hit.hit_mask

        # ---- emission at the hit -----------------------------------------
        emit_rad, emit_pdf, hit_sel_prob = emitter_mod.eval_hit_emitter(
            em, tex, config, geo.emitter_id,
            geo.position, geo.normal, geo.uv, ro,
        )
        is_emissive = alive & (geo.emitter_id >= 0) & geo.front
        # fresh hit: GetRadiance (main.cu:87-92); bounced: MIS (171-183)
        direct_emit = _first_emit_radiance(scene, config, geo)
        mis_hit = jnp.where(
            s["delta_prev"],
            1.0,
            mis_weight(s["pdf_prev"], emit_pdf * hit_sel_prob),
        )
        bounced_ok = is_emissive & ~fresh & ~is_zero(emit_pdf)
        radiance = radiance + where(
            bounced_ok, throughput * emit_rad * mis_hit, Vec3.zeros(pool)
        )
        radiance = radiance + where(
            is_emissive & fresh, direct_emit, Vec3.zeros(pool)
        )

        # ---- AOVs on primary hits ------------------------------------------
        s["albedo"] = _scatter_rgb(
            s["albedo"], s["pixel"], bsdf_mod.albedo(local), alive & fresh
        )
        s["normal"] = _scatter_rgb(
            s["normal"], s["pixel"], geo.normal, alive & fresh
        )

        # ---- bounce: RR + NEE + BSDF sample -------------------------------
        st = s["rng"]
        st, us = rng.next_floats(st, 7)
        u_rr, u_sel, u_l1, u_l2, u_b0, u_b1, u_b2 = us
        s["rng"] = st

        depth = s["depth"] + 1  # entering bounce #depth (main.cu:104)
        within = depth < config.max_depth
        rr = jnp.where(depth > 2, 0.95, 1.0)
        alive = alive & within & (u_rr <= rr)
        throughput = where(alive, throughput * (1.0 / rr), throughput)

        idx, use_env = emitter_mod.select_emitter(em, config, u_sel)
        es = emitter_mod.sample_direct(
            em, tex, config, idx, use_env,
            geo.position, geo.normal, u_l1, u_l2,
        )
        occluded = intersect_any(
            geo.position, es.wi, tmin_c, es.distance - RAY_OFFSET, scene, config,
            coherent=False,
        )
        wo_local = to_local(-rd, geo.normal)
        wi_local = to_local(es.wi, geo.normal)
        f_nee, pdf_bsdf = bsdf_mod.evaluate(
            local, wo_local, wi_local, config.mat_types
        )
        nol = geo.normal.dot(es.wi)
        # selection probability folded into the NEE density on BOTH MIS
        # sides (see render/integrator.py's documented deviation)
        pdf_light = es.pdf * es.select_prob
        mis = jnp.where(es.is_delta, 1.0, mis_weight(pdf_light, pdf_bsdf))
        contrib = throughput * es.radiance * f_nee * (
            nol * mis / jnp.maximum(pdf_light, _TINY)
        )
        take = (
            alive & ~occluded & ~is_zero(f_nee * es.pdf) & (nol > 0.0)
        )
        radiance = radiance + where(take, contrib, Vec3.zeros(pool))

        wi_s, f_s, pdf_s, lobe = bsdf_mod.sample(
            local, wo_local, u_b0, u_b1, u_b2, config.mat_types
        )
        cos_term = jnp.abs(wi_s.z)
        alive = alive & ~(is_zero(f_s * cos_term) | is_zero(pdf_s))
        throughput = where(
            alive, throughput * f_s * (cos_term / jnp.maximum(pdf_s, _TINY)),
            throughput,
        )

        s["ro"] = geo.position
        s["rd"] = to_world(wi_s, geo.normal)
        s["radiance"] = radiance
        s["throughput"] = throughput
        s["depth"] = depth
        s["pdf_prev"] = pdf_s
        s["delta_prev"] = (lobe & bsdf_mod.LOBE_DELTA) != 0
        s["alive"] = alive
        del s["fresh"]
        return s

    def cond(s):
        return (s["next_path"] < total_paths) | jnp.any(s["alive"])

    final = jax.lax.while_loop(cond, body, state)
    # flush radiance of the last generation of paths
    film = _scatter_rgb(
        final["film"], final["pixel"], final["radiance"],
        jnp.ones(pool, bool),
    )
    inv = 1.0 / spp
    return {
        "film": film * inv,
        "albedo": final["albedo"] * inv,
        "normal": final["normal"] * inv,
    }


def _first_emit_radiance(scene, config, geo) -> Vec3:
    from pupiloptixlab_tpu.accel.gather import gather_cols
    from pupiloptixlab_tpu.flatten.types import EM_RAD_TEX
    from pupiloptixlab_tpu.render.texture import sample_texture_cols

    em, tex = scene.emitters, scene.textures
    erow = gather_cols(em.packed, jnp.maximum(geo.emitter_id, 0))
    trow = gather_cols(tex.packed, erow[EM_RAD_TEX].astype(jnp.int32))
    return sample_texture_cols(
        trow, tex.pool, geo.uv, config.em_tex_kinds, config.em_tex_filters,
        tex.pool_bi,
    )
