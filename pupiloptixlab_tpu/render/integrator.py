"""Progressive path tracer with NEE + balance-heuristic MIS.

Parity target: the flagship PT integrator of the reference
(example/path_tracer/main.cu), re-architected from a divergent per-pixel
megakernel into a masked fixed-stage wavefront program under one jit:

generate -> intersect -> [shade + NEE shadow + bounce] x depth -> accumulate

Semantics preserved exactly:

* depth loop: first hit traced outside; each iteration does RR
  (p=0.95 after depth 2, main.cu:108-111), NEE with balance MIS weighted
  *before* multiplying in the selection probability (main.cu:113-141),
  BSDF sampling with throughput *= f |wi.z| / pdf (main.cu:142-160),
  env-escape MIS (main.cu:166-169) and hit-emitter MIS with delta-lobe
  override (main.cu:171-183).
* primary-ray env hits add un-weighted env radiance (main.cu:84, 186).
* first-hit emission + albedo/normal AOVs (main.cu:87-99).
* progressive accumulation lerp 1/(n+1) (main.cu:187-193).
* per-pixel RNG: TEA(4)-scrambled LCG streams (cuda/random.h), a fixed
  7-draw budget per bounce so lanes advance in lockstep.

Design: all vectors are Vec3 planes (render/vec.py), one dense array per
component; every lane carries an ``active`` mask instead of branching;
the bounce loop is a ``lax.scan`` so device memory and compile time stay
bounded at one bounce regardless of max_depth (the reference allows 128).
"""

from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp

from pupiloptixlab_tpu.accel.gather import gather_cols
from pupiloptixlab_tpu.accel.intersect import (
    intersect_any,
    intersect_closest,
    origin_sort_prim,
)
from pupiloptixlab_tpu.flatten.types import (
    EM_RAD_TEX,
    CameraBlock,
    RenderConfig,
    SceneData,
)
from pupiloptixlab_tpu.render import bsdf as bsdf_mod
from pupiloptixlab_tpu.render import emitter as emitter_mod
from pupiloptixlab_tpu.render import rng
from pupiloptixlab_tpu.render.camera import generate_rays
from pupiloptixlab_tpu.render.geometry import get_local_geometry
from pupiloptixlab_tpu.render.sampling import (
    MAX_DISTANCE,
    RAY_OFFSET,
    is_zero,
    mis_weight,
    to_local,
    to_world,
)
from pupiloptixlab_tpu.render.texture import sample_texture_cols
from pupiloptixlab_tpu.render.vec import Vec3, where

_TINY = 1e-12

# Primary rays are generated in (8 x 128)-pixel BLOCK order: neighbouring
# lanes are then one compact pixel block (a tight direction cone) instead
# of half an image row crossing the whole scene, so the primary traversal
# runs coherent=True with NO ray sort and NO unpermute. Encode AND decode
# are pure reshape+transpose. Per-pixel RNG streams are keyed by PIXEL ID,
# so the rendered image matches row-major order. Applied only on BVH
# scenes with block-divisible films. The block shape was sized for an
# earlier tiled traversal and has not been re-measured for the per-ray
# GPU kernel (ROADMAP S4). Set False only for layout debugging.
BLOCK_PRIMARIES = True
_BLOCK_H, _BLOCK_W = 8, 128


def _use_blocks(config) -> bool:
    return (
        BLOCK_PRIMARIES
        and config.bvh_nodes > 0
        and config.width % _BLOCK_W == 0
        and config.height % _BLOCK_H == 0
    )


@functools.lru_cache(maxsize=8)
def _block_pix(width: int, height: int):
    """(n,) pixel ids in block order (host-side constant)."""
    import numpy as np

    hb, wb = height // _BLOCK_H, width // _BLOCK_W
    ids = np.arange(height * width, dtype=np.int32).reshape(
        hb, _BLOCK_H, wb, _BLOCK_W
    )
    return ids.transpose(0, 2, 1, 3).reshape(-1)


def _block_decode(v: jnp.ndarray, width: int, height: int) -> jnp.ndarray:
    """Lane order -> row-major pixel order (reshape+transpose only)."""
    hb, wb = height // _BLOCK_H, width // _BLOCK_W
    rest = v.shape[1:]
    v4 = v.reshape(hb, wb, _BLOCK_H, _BLOCK_W, *rest)
    return v4.transpose(0, 2, 1, 3, *range(4, 4 + len(rest))).reshape(
        height * width, *rest
    )


def _first_hit_emission(scene, config, geo) -> Vec3:
    """GetRadiance at the hit uv (main.cu:87-92)."""
    em, tex = scene.emitters, scene.textures
    erow = gather_cols(em.packed, jnp.maximum(geo.emitter_id, 0))
    trow = gather_cols(tex.packed, erow[EM_RAD_TEX].astype(jnp.int32))
    return sample_texture_cols(
        trow, tex.pool, geo.uv, config.em_tex_kinds, config.em_tex_filters,
        tex.pool_bi,
    )


def _apply_dispersion(local, lams):
    """Spectral mode: Cauchy-shift the dielectric ior ratio to the HERO
    wavelength (render/spectral.py; path geometry follows the hero)."""
    import dataclasses

    from pupiloptixlab_tpu.render import spectral as sp

    return dataclasses.replace(
        local, eta=sp.eta_at(local.eta, local.dispersion, lams.s0)
    )


def _bounce(scene, config, n, carry, depth, lams=None):
    """One NEE + BSDF-bounce iteration (the body of main.cu:103-184).

    ``lams`` (spectral mode only, closed over — constant through the
    scan): the path's Spec4 wavelengths. radiance / throughput /
    esc_tp are then Spec4 planes; every RGB quantity lifts through
    spectral.lift at its use site, and the carry ends with the ``mono``
    mask (hero-collapsed lanes after a dispersive transmission)."""
    spectral = config.spectral
    if spectral:
        from pupiloptixlab_tpu.render import spectral as sp

        (state, active, radiance, throughput, wo_world, geo, local, oprim,
         esc, mono) = carry
        zero_l = sp.Spec4.zeros(n)
        lift = functools.partial(sp.lift, lams=lams)
    else:
        (state, active, radiance, throughput, wo_world, geo, local, oprim,
         esc) = carry
        zero_l = Vec3.zeros(n)
        lift = lambda v: v  # noqa: E731
    em, tex = scene.emitters, scene.textures
    zero3 = Vec3.zeros(n)

    state, us = rng.next_floats(state, 7)
    u_rr, u_sel, u_l1, u_l2, u_b0, u_b1, u_b2 = us

    # Russian roulette (main.cu:108-111).
    rr = jnp.where(depth > 2, 0.95, 1.0)
    active = active & (u_rr <= rr)
    throughput = where(active, throughput * (1.0 / rr), throughput)

    # --- next-event estimation (main.cu:113-141) ----------------------------
    idx, use_env = emitter_mod.select_emitter(em, config, u_sel)
    es = emitter_mod.sample_direct(
        em, tex, config, idx, use_env,
        geo.position, geo.normal, u_l1, u_l2,
    )
    wo_local = to_local(wo_world, geo.normal)
    wi_local = to_local(es.wi, geo.normal)
    f_nee, pdf_bsdf = bsdf_mod.evaluate(local, wo_local, wi_local, config.mat_types)
    nol = geo.normal.dot(es.wi)
    nonzero = ~is_zero(f_nee * es.pdf)
    # A shadow ray only matters where the NEE contribution can be
    # nonzero — the BSDF eval runs BEFORE the sweep so delta-lobe lanes
    # (f_nee = 0), below-horizon light samples and dead lanes are culled
    # from the traversal entirely (the reference simply doesn't trace
    # them, main.cu:130-134). Shadow directions are importance-sampled
    # (env/emitter surface) -> incoherent on large scenes; the traversal
    # sorts them by (origin leaf, direction), culled lanes last. Shadow
    # and bounce rays share origins but each keeps its own sort: the
    # direction bits of the key differ.
    shadow_mask = active & nonzero & (nol > 0.0)
    tmin = jnp.full(n, RAY_OFFSET, jnp.float32)
    occluded = intersect_any(
        geo.position, es.wi, tmin, es.distance - RAY_OFFSET, scene, config,
        coherent=False, origin_prim=oprim, mask=shadow_mask,
        const_tmin=RAY_OFFSET,
    )
    # DELIBERATE DEVIATION from main.cu:135-137: the reference computes
    # the balance weight from the emitter pdf WITHOUT the selection
    # probability while the BSDF-hit side (main.cu:180) includes it, so
    # its MIS weights sum past 1 whenever select_prob < 1 (measured
    # +11% energy on the 2-emitter cornell box vs the independent
    # brute-force oracle, tools/oracle_pt.py). The true NEE sampling
    # density is select_prob * es.pdf; using it restores w1 + w2 = 1.
    pdf_light = es.pdf * es.select_prob
    mis = jnp.where(es.is_delta, 1.0, mis_weight(pdf_light, pdf_bsdf))
    scale = nol * mis / jnp.maximum(pdf_light, _TINY)
    contrib = throughput * lift(es.radiance) * lift(f_nee) * scale
    take = shadow_mask & ~occluded
    radiance = radiance + where(take, contrib, zero_l)

    # --- BSDF sampling + bounce (main.cu:142-183) ----------------------------
    wi_s, f_s, pdf_s, lobe = bsdf_mod.sample(
        local, wo_local, u_b0, u_b1, u_b2, config.mat_types
    )
    cos_term = jnp.abs(wi_s.z)
    bad = is_zero(f_s * cos_term) | is_zero(pdf_s)
    active = active & ~bad
    weight = lift(f_s) * (cos_term / jnp.maximum(pdf_s, _TINY))
    throughput = where(active, throughput * weight, throughput)
    if spectral:
        # Hero collapse (Wilkie et al. 2014): a TRANSMISSION through a
        # dispersive dielectric bends each wavelength differently; the
        # path geometry follows the hero, so the 3 secondary
        # wavelengths terminate — their throughput zeroes and the hero
        # picks up the 4x MIS compensation, exactly once per path.
        newly = (
            active & (wi_s.z * wo_local.z < 0.0)
            & (local.dispersion > 0.0) & ~mono
        )
        throughput = sp.Spec4(
            jnp.where(newly, throughput.s0 * sp.SPECTRAL_SAMPLES,
                      throughput.s0),
            jnp.where(newly, 0.0, throughput.s1),
            jnp.where(newly, 0.0, throughput.s2),
            jnp.where(newly, 0.0, throughput.s3),
        )
        mono = mono | newly

    new_rd = to_world(wi_s, geo.normal)
    new_ro = geo.position
    # bounce directions are incoherent -> the sweep sorts them
    # internally; dead lanes (absorbed / escaped / RR-killed) are culled
    hit = intersect_closest(
        new_ro, new_rd, tmin, jnp.full(n, MAX_DISTANCE, jnp.float32),
        scene, config, coherent=False, origin_prim=oprim, mask=active,
        const_tmin=RAY_OFFSET, const_tmax=MAX_DISTANCE,
    )

    # escape -> environment MIS (main.cu:166-169). A lane escapes at
    # most ONCE (it goes inactive forever after), so instead of paying
    # eval_env's pool gathers EVERY bounce the escape is recorded
    # (direction, throughput, bsdf pdf) and resolved by a single
    # deferred eval_env after the scan (render_sample). Equivalent
    # term-for-term; only the float accumulation order changes.
    # Directions NEE can never produce take MIS weight 1 on the BSDF
    # side: delta lobes (discrete probability, not a density) and
    # BELOW-SHADING-NORMAL continuations (the shadow pass culls
    # nol <= 0, main.cu:130-134, so the effective NEE density there is
    # 0 — without this, glossy transmission through glass loses energy;
    # caught by the extended brute-force oracle: furnace mirror/glass
    # spheres rendered 3-17% dark).
    nee_blind = ((lobe & bsdf_mod.LOBE_DELTA) != 0) | (
        geo.normal.dot(new_rd) <= 0.0
    )
    if config.has_env:
        esc_mask, esc_dir, esc_tp, esc_pdf = esc
        escaped = active & ~hit.hit_mask
        esc_mask = esc_mask | escaped
        esc_dir = where(escaped, new_rd, esc_dir)
        esc_tp = where(escaped, throughput, esc_tp)
        # -1 = the same "un-weighted" sentinel as primary misses
        esc_pdf = jnp.where(
            escaped, jnp.where(nee_blind, -1.0, pdf_s), esc_pdf
        )
        esc = (esc_mask, esc_dir, esc_tp, esc_pdf)
    active = active & hit.hit_mask

    geo = get_local_geometry(scene, hit, new_ro, new_rd, config.sphere_count,
                             config.instanced, config.curve_count)
    local = bsdf_mod.get_local_bsdf(
        scene.materials, tex, geo.mat_id, geo.uv, config.mat_types,
        config.mat_tex_kinds, config.mat_tex_filters,
    )
    if spectral:
        local = _apply_dispersion(local, lams)
    wo_world = -new_rd

    # hit an emitter -> MIS-weighted emission (main.cu:171-183)
    emit_rad, emit_pdf, hit_sel_prob = emitter_mod.eval_hit_emitter(
        em, tex, config, geo.emitter_id, geo.position, geo.normal, geo.uv, new_ro
    )
    # nee_blind (computed above, against the ORIGIN vertex's shading
    # normal): an emitter reached through a delta lobe or below the
    # horizon could never be NEE-sampled -> weight 1
    mis_hit = jnp.where(
        nee_blind, 1.0, mis_weight(pdf_s, emit_pdf * hit_sel_prob)
    )
    # geo.front: emission is one-sided on the STORED normal — a twosided
    # light material flips the shading normal for backside hits, which
    # must not re-enable emission (see LocalGeometry.front)
    take_e = active & (geo.emitter_id >= 0) & ~is_zero(emit_pdf) & geo.front
    radiance = radiance + where(
        take_e, throughput * lift(emit_rad) * mis_hit, zero_l
    )

    oprim = origin_sort_prim(hit, scene, config)
    out = (state, active, radiance, throughput, wo_world, geo, local, oprim,
           esc)
    return out + (mono,) if spectral else out


def render_sample(
    scene: SceneData,
    camera: CameraBlock,
    seed: jnp.ndarray,
    config: RenderConfig,
):
    """Trace one sample per pixel; returns dict of flat (N,*) buffers:
    radiance, albedo, normal, test."""
    w, h = config.width, config.height
    n = w * h
    em, tex = scene.emitters, scene.textures

    if _use_blocks(config):
        # lanes ARE (8x128)-block pixels (see the module constant):
        # coherent primaries with zero sort cost; decoded once at return
        pix = jnp.asarray(_block_pix(w, h))
        state = rng.tea_init(pix.astype(jnp.uint32), seed)
        state, (jx, jy) = rng.next_floats(state, 2)
        from pupiloptixlab_tpu.render.camera import generate_rays_for

        ro, rd = generate_rays_for(camera, w, h, pix, jx, jy)
        primary_coherent = True
    else:
        state = rng.tea_init(jnp.arange(n, dtype=jnp.uint32), seed)
        state, (jx, jy) = rng.next_floats(state, 2)
        ro, rd = generate_rays(camera, w, h, jx, jy)
        # Row-major order makes a run of lanes half an image row — a
        # long thin frustum; incoherent routes it through the ray sort.
        primary_coherent = False

    spectral = config.spectral
    if spectral:
        # 4 stratified path wavelengths from ONE draw (hero + 3
        # rotations); radiance/throughput become Spec4 planes and the
        # sensor integrates against the CMFs at the end
        # (render/spectral.py — beyond the RGB-only reference).
        from pupiloptixlab_tpu.render import spectral as sp

        state, (u_lam,) = rng.next_floats(state, 1)
        lams = sp.sample_wavelengths(u_lam)
        lift = functools.partial(sp.lift, lams=lams)
    else:
        lams = None
        lift = lambda v: v  # noqa: E731

    tmin = jnp.full(n, RAY_OFFSET, jnp.float32)
    tmax = jnp.full(n, MAX_DISTANCE, jnp.float32)
    hit = intersect_closest(
        ro, rd, tmin, tmax, scene, config, coherent=primary_coherent,
        const_tmin=RAY_OFFSET, const_tmax=MAX_DISTANCE,
    )
    geo = get_local_geometry(scene, hit, ro, rd, config.sphere_count,
                             config.instanced, config.curve_count)
    local = bsdf_mod.get_local_bsdf(
        scene.materials, tex, geo.mat_id, geo.uv, config.mat_types,
        config.mat_tex_kinds, config.mat_tex_filters,
    )
    if spectral:
        local = _apply_dispersion(local, lams)

    active = hit.hit_mask
    radiance = sp.Spec4.zeros(n) if spectral else Vec3.zeros(n)
    throughput = sp.Spec4.ones(n) if spectral else Vec3.ones(n)
    zero3 = Vec3.zeros(n)
    zero_l = sp.Spec4.zeros(n) if spectral else zero3

    # Primary miss -> un-weighted environment radiance (main.cu:84,
    # 196-212), deferred to the single post-scan eval_env below
    # (esc_pdf = -1 encodes "no MIS weight"). Env-less scenes carry no
    # escape state at all (config is static).
    esc = (
        (
            ~active, rd,
            sp.Spec4.ones(n) if spectral else Vec3.ones(n),
            jnp.full(n, -1.0, jnp.float32),
        )
        if config.has_env
        else None
    )

    # First-hit emission (main.cu:87-92; one-sided on the stored normal,
    # consistent with every other emission term — see LocalGeometry.front).
    is_emitter = active & (geo.emitter_id >= 0) & geo.front
    emit0 = _first_hit_emission(scene, config, geo)
    radiance = radiance + where(is_emitter, lift(emit0), zero_l)

    # AOVs from the first hit (main.cu:94-99).
    albedo_aov = where(active, bsdf_mod.albedo(local), zero3)
    normal_aov = where(active, geo.normal, zero3)

    # The reference writes one RNG draw to the debug AOV (main.cu:101).
    state, test_aov = rng.next_float(state)

    oprim = origin_sort_prim(hit, scene, config)
    carry = (state, active, radiance, throughput, -rd, geo, local, oprim, esc)
    if spectral:
        carry = carry + (jnp.zeros(n, bool),)  # mono: hero-collapsed
    if config.max_depth > 1:
        depths = jnp.arange(1, config.max_depth, dtype=jnp.int32)
        carry, _ = jax.lax.scan(
            lambda c, d: (_bounce(scene, config, n, c, d, lams=lams), None),
            carry, depths,
        )
    radiance = carry[2]

    # Deferred environment resolve: ONE eval_env per sample instead of
    # one per bounce (each lane escapes at most once). Primary misses
    # (esc_pdf < 0) take the radiance un-weighted; bounce escapes apply
    # the balance MIS weight with the env's selection probability in its
    # sampling density (same deviation as the NEE weight in _bounce).
    if config.has_env:
        esc_mask, esc_dir, esc_tp, esc_pdf = carry[8]
        env_rad, env_pdf = emitter_mod.eval_env(em, tex, config, esc_dir)
        mis_env = jnp.where(
            esc_pdf < 0.0,
            1.0,
            mis_weight(esc_pdf, env_pdf * em.env_select_prob),
        )
        radiance = radiance + where(
            esc_mask, esc_tp * lift(env_rad) * mis_env, zero_l
        )

    if spectral:
        # sensor: Monte-Carlo CMF integration over the path wavelengths
        radiance = sp.to_rgb(radiance, lams)

    out = {
        "radiance": radiance.to_array(),
        "albedo": albedo_aov.to_array(),
        "normal": normal_aov.to_array(),
        "test": test_aov,
    }
    if _use_blocks(config):
        # decode lanes back to row-major pixels: pure reshape+transpose
        out = {k: _block_decode(v, w, h) for k, v in out.items()}
    if config.debug_checks:
        # sanitizer stage counts compiled into the frame (utils/debug.py
        # — the OptiX debug-exception-flags analog). Radiance must be
        # finite AND non-negative; throughput non-negative catches bad
        # BSDF weights even when they never reach the image.
        from pupiloptixlab_tpu.utils.debug import finite_report

        tp = carry[3]  # Vec3 planes, or Spec4 in spectral mode
        out["sanitizer"] = finite_report({
            "radiance": (out["radiance"], 0.0),
            "albedo": (out["albedo"], 0.0),
            "normal": (out["normal"], None),
            "primary_t": (jnp.where(hit.hit_mask, hit.t, 0.0), 0.0),
            "throughput": (jnp.stack(list(tp), -1), 0.0),
        })
    return out


@partial(jax.jit, static_argnames=("config",), donate_argnames=("accum",))
def render_frame(
    scene: SceneData,
    camera: CameraBlock,
    seed: jnp.ndarray,
    sample_cnt: jnp.ndarray,
    accum: jnp.ndarray,
    config: RenderConfig,
):
    """One progressive frame: trace + accumulate (main.cu:187-193).

    Returns (accum', buffers) where buffers holds the displayable AOVs.
    """
    out = render_sample(scene, camera, seed, config)
    radiance = out["radiance"]
    if config.accumulate:
        t = 1.0 / (sample_cnt.astype(jnp.float32) + 1.0)
        blended = accum + (radiance - accum) * t
        new_accum = jnp.where(sample_cnt > 0, blended, radiance)
    else:
        new_accum = radiance
    buffers = {
        "frame": new_accum,
        "albedo": out["albedo"],
        "normal": out["normal"],
        "test": out["test"],
    }
    if config.debug_checks:
        buffers["sanitizer"] = out["sanitizer"]
    return new_accum, buffers


def render(
    scene: SceneData,
    camera: CameraBlock,
    config: RenderConfig,
    spp: int,
    seed0: int = 0,
):
    """Render ``spp`` progressive samples; returns (h, w, 3) radiance.

    All samples run in ONE dispatch (render_frame_batch's fori_loop):
    per-sample seeds and the progressive blend are identical to a host
    loop of render_frame calls, but a 512-spp offline render costs one
    launch instead of 512."""
    n = config.width * config.height
    accum = jnp.zeros((n, 3), jnp.float32)
    accum, _ = render_frame_batch(
        scene, camera, jnp.uint32(seed0), jnp.int32(0), accum, config, spp
    )
    return accum.reshape(config.height, config.width, 3)


@partial(jax.jit, static_argnames=("config", "spp"), donate_argnames=("accum",))
def render_frame_batch(
    scene: SceneData,
    camera: CameraBlock,
    seed0: jnp.ndarray,
    sample_cnt: jnp.ndarray,
    accum: jnp.ndarray,
    config: RenderConfig,
    spp: int,
):
    """``spp`` progressive samples in ONE dispatch (amortizes host/launch
    overhead for offline rendering; the per-sample accumulation matches
    main.cu:187-193 exactly). Returns (accum', buffers-of-last-sample)."""

    def body(i, carry):
        acc, _ = carry
        out = render_sample(scene, camera, seed0 + i.astype(jnp.uint32), config)
        radiance = out["radiance"]
        if config.accumulate:
            t = 1.0 / ((sample_cnt + i).astype(jnp.float32) + 1.0)
            blended = acc + (radiance - acc) * t
            acc = jnp.where(sample_cnt + i > 0, blended, radiance)
        else:
            acc = radiance
        return acc, out

    dummy = {
        "radiance": accum,
        "albedo": jnp.zeros_like(accum),
        "normal": jnp.zeros_like(accum),
        "test": jnp.zeros(accum.shape[0], jnp.float32),
    }
    accum, last = jax.lax.fori_loop(0, spp, body, (accum, dummy))
    buffers = {
        "frame": accum,
        "albedo": last["albedo"],
        "normal": last["normal"],
        "test": last["test"],
    }
    return accum, buffers
