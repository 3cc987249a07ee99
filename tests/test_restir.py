"""ReSTIR-DI estimator tests.

1. Reservoir streaming statistics: selection frequencies converge to
   w_i / sum(w) (the weighted-reservoir-sampling invariant).
2. End-to-end unbiasedness: the ReSTIR-DI image of a many-light scene
   converges to the brute NEE+MIS PT image restricted to direct light
   (depth 2) within statistical tolerance.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from pupiloptixlab_tpu.flatten import camera_block_from_scene, flatten_scene
from pupiloptixlab_tpu.render.integrator import render
from pupiloptixlab_tpu.render.restir import N_PACK, Reservoir, restir_frame
from pupiloptixlab_tpu.render.vec import Vec3
from pupiloptixlab_tpu.scene import load_scene

RESTIR_XML = "restir_test.xml"  # under PUPIL_REFERENCE_SCENES


def test_reservoir_selection_frequencies():
    rng = np.random.RandomState(7)
    n = 4096
    weights = np.array([0.1, 1.0, 2.5, 0.4], np.float32)
    r = Reservoir.zeros(n)
    for i, w in enumerate(weights):
        u = jnp.asarray(rng.rand(n), jnp.float32)
        tag = float(i)
        r = r.update(
            u,
            Vec3.broadcast(jnp.asarray([tag, 0.0, 0.0]), n),
            Vec3.zeros(n),
            Vec3.zeros(n),
            jnp.ones(n),
            jnp.full(n, w),
            jnp.full(n, w),
            jnp.ones(n),
        )
    sel = np.asarray(r.y_pos.x)
    freq = np.array([(sel == i).mean() for i in range(len(weights))])
    expect = weights / weights.sum()
    assert np.abs(freq - expect).max() < 0.03, (freq, expect)
    # w_sum accumulates every candidate; m counts them
    assert np.allclose(np.asarray(r.w_sum), weights.sum())
    assert np.allclose(np.asarray(r.m), len(weights))


@pytest.fixture(scope="module")
def restir_scene(reference_scene_dir):
    scene = load_scene(reference_scene_dir / RESTIR_XML)
    scene.sensor.film.w, scene.sensor.film.h = 96, 54
    data, config = flatten_scene(scene)
    camera = camera_block_from_scene(scene)
    return data, config, camera


def _downsample(img, f=8):
    h, w = img.shape[:2]
    return img[: h // f * f, : w // f * f].reshape(
        h // f, f, w // f, f, 3
    ).mean(axis=(1, 3))


@pytest.mark.heavy
def test_restir_di_matches_pt_direct(restir_scene):
    data, config, camera = restir_scene
    n = config.width * config.height

    # reference: PT at depth 2 = emission + direct light (NEE + MIS)
    cfg2 = dataclasses.replace(config, max_depth=2, accumulate=True)
    ref = np.asarray(render(data, camera, cfg2, spp=48))

    accum = jnp.zeros((n, 3), jnp.float32)
    packed = jnp.zeros((n, N_PACK), jnp.float32)
    for s in range(24):
        accum, packed, _ = restir_frame(
            data, camera, jnp.uint32(1000 + s), packed, accum,
            jnp.int32(s), cfg2, m_candidates=4, spatial_taps=2,
            spatial_radius=8,
        )
    img = np.asarray(accum).reshape(config.height, config.width, 3)

    # global unbiasedness: measured ratio 1.0006 at 48 frames (spatio-
    # temporal reuse on) and 1.00007 with RIS only
    ratio = img.mean() / ref.mean()
    assert abs(ratio - 1.0) < 0.02, ratio

    a = _downsample(img)
    b = _downsample(ref)
    mask = b.mean(axis=-1) > 1e-3
    rel = np.abs(a - b).sum(axis=-1)[mask] / (b.sum(axis=-1)[mask] + 1e-3)
    # bucket means track the reference (loose: both images carry MC
    # noise at these sample counts)
    assert np.median(rel) < 0.25, np.median(rel)


@pytest.mark.heavy
def test_restir_di_matches_pt_direct_with_env(reference_scene_dir):
    """Energy parity on a scene with BOTH area lights and an environment
    light — the case where round 2's estimator was 1.61x over-bright
    (env NEE divided by env_select_prob, and candidate u_sel clamped
    past the area CDF onto the last area emitter)."""
    from pupiloptixlab_tpu.scene.emitters import Emitter, EmitterType

    scene = load_scene(reference_scene_dir / RESTIR_XML)
    scene.sensor.film.w, scene.sensor.film.h = 96, 54
    scene.emitters.append(
        Emitter(
            type=EmitterType.CONST_ENV,
            color=np.array([0.3, 0.3, 0.3], np.float32),
        )
    )
    data, config = flatten_scene(scene)
    camera = camera_block_from_scene(scene)
    n = config.width * config.height

    cfg2 = dataclasses.replace(config, max_depth=2, accumulate=True)
    ref = np.asarray(render(data, camera, cfg2, spp=48))

    accum = jnp.zeros((n, 3), jnp.float32)
    packed = jnp.zeros((n, N_PACK), jnp.float32)
    for s in range(24):
        accum, packed, _ = restir_frame(
            data, camera, jnp.uint32(1000 + s), packed, accum,
            jnp.int32(s), cfg2, m_candidates=4, spatial_taps=2,
            spatial_radius=8,
        )
    img = np.asarray(accum).reshape(config.height, config.width, 3)
    ratio = img.mean() / ref.mean()
    assert abs(ratio - 1.0) < 0.03, ratio


def test_restir_variance_beats_single_nee(restir_scene):
    """One ReSTIR frame (M=8 candidates, 1 shadow ray) should have far
    lower direct-light variance than one NEE sample — the whole point.
    Proxy: per-pixel luminance deviation from the converged reference."""
    data, config, camera = restir_scene
    n = config.width * config.height
    cfg2 = dataclasses.replace(config, max_depth=2, accumulate=True)
    ref = np.asarray(render(data, camera, cfg2, spp=48)).reshape(-1, 3)

    accum = jnp.zeros((n, 3), jnp.float32)
    packed = jnp.zeros((n, N_PACK), jnp.float32)
    accum, packed, frame = restir_frame(
        data, camera, jnp.uint32(5), packed, accum, jnp.int32(0), cfg2,
        m_candidates=8, spatial_taps=0,
    )
    one_pt = np.asarray(
        render(data, camera, dataclasses.replace(cfg2, accumulate=False),
               spp=1, seed0=5)
    ).reshape(-1, 3)

    lum = np.array([0.2126, 0.7152, 0.0722])
    err_restir = np.abs((np.asarray(frame) - ref) @ lum)
    err_pt = np.abs((one_pt - ref) @ lum)
    # compare robust (median) error: the 8-candidate reservoir must
    # clearly beat one NEE draw (measured 0.0082 vs 0.0120; the PT side
    # also carries indirect-light variance, so the gap understates the
    # direct-light win)
    assert np.median(err_restir) < 0.8 * np.median(err_pt), (
        np.median(err_restir), np.median(err_pt)
    )


@pytest.mark.heavy
def test_restir_gi_matches_pt_indirect(restir_scene):
    """ReSTIR-GI (emission + 1-NEE direct + reservoir one-bounce
    indirect) converges to brute PT at depth 3 on the all-diffuse
    restir_test scene (no delta lobes, no env — the estimator's exact
    transport domain)."""
    from pupiloptixlab_tpu.render.restir_gi import restir_gi_frame

    data, config, camera = restir_scene
    n = config.width * config.height
    cfg3 = dataclasses.replace(config, max_depth=3, accumulate=True)
    ref = np.asarray(render(data, camera, cfg3, spp=64))

    accum = jnp.zeros((n, 3), jnp.float32)
    packed = jnp.zeros((n, N_PACK), jnp.float32)
    for s in range(32):
        accum, packed, _ = restir_gi_frame(
            data, camera, jnp.uint32(2000 + s), packed, accum,
            jnp.int32(s), cfg3, spatial_taps=2, spatial_radius=8,
        )
    img = np.asarray(accum).reshape(config.height, config.width, 3)
    ratio = img.mean() / ref.mean()
    assert abs(ratio - 1.0) < 0.03, ratio

    a = _downsample(img)
    b = _downsample(ref)
    mask = b.mean(axis=-1) > 1e-3
    rel = np.abs(a - b).sum(axis=-1)[mask] / (b.sum(axis=-1)[mask] + 1e-3)
    assert np.median(rel) < 0.25, np.median(rel)


@pytest.mark.heavy
def test_restir_gi_motion_warp_reuses_history(reference_scene_dir):
    """With a moving camera, motion-warped temporal reuse must keep
    more reservoir history alive than identity reuse (which fails the
    similarity gate wherever the reprojection offset crosses edges)."""
    from pupiloptixlab_tpu.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu.flatten.flatten import camera_block
    from pupiloptixlab_tpu.render.restir_gi import restir_gi_frame
    from pupiloptixlab_tpu.scene import load_scene
    from pupiloptixlab_tpu.utils.camera import Camera, CameraDesc
    from pupiloptixlab_tpu.utils.math import Transform

    scene = load_scene(reference_scene_dir / RESTIR_XML)
    scene.sensor.film.w, scene.sensor.film.h = 96, 54
    data, config = flatten_scene(scene)
    config = dataclasses.replace(config, max_depth=3, accumulate=False)
    n = config.width * config.height
    base_m = scene.sensor.transform.matrix.copy()

    def cam_at(dx):
        m = base_m.copy()
        m[:3, 3] += m[:3, 0] * dx  # truck along camera right axis
        cam = Camera(CameraDesc(
            fov_y=scene.sensor.fov, aspect_ratio=config.width / config.height,
            near_clip=scene.sensor.near_clip, far_clip=scene.sensor.far_clip,
            to_world=Transform(m.astype(np.float32)),
        ))
        return camera_block(cam)

    def run(warp):
        accum = jnp.zeros((n, 3), jnp.float32)
        packed = jnp.zeros((n, N_PACK), jnp.float32)
        prev_cam = None
        for s in range(6):
            cam = cam_at(0.15 * s)
            accum, packed, _ = restir_gi_frame(
                data, cam, jnp.uint32(77 + s), packed, accum, jnp.int32(0),
                config, spatial_taps=0,
                prev_camera=prev_cam if warp else None,
            )
            prev_cam = cam
        m_col = np.asarray(packed[:, 11])
        return float(m_col[m_col > 0].mean())

    m_warp = run(True)
    m_ident = run(False)
    # warped reuse keeps clearly more history than identity reuse under
    # camera motion
    assert m_warp > 1.2 * m_ident, (m_warp, m_ident)


@pytest.mark.heavy
def test_restir_gi_mirror_sees_emitter_and_indirect():
    """Delta continuations can't ride reservoirs; their one-bounce
    contribution (emission at y + NEE at y, BSDF-weighted) must flow
    through the per-frame extra term instead of being dropped — a
    mirror must converge to PT in the GI pass (ROADMAP #6)."""
    from pupiloptixlab_tpu.render.restir_gi import restir_gi_frame
    from pupiloptixlab_tpu.scene import Scene
    from pupiloptixlab_tpu.scene.emitters import Emitter, EmitterType
    from pupiloptixlab_tpu.scene.materials import Material, MatType
    from pupiloptixlab_tpu.scene.shapes import ShapeInstance
    from pupiloptixlab_tpu.scene.textures import rgb_texture
    from pupiloptixlab_tpu.utils.math import (
        Transform,
        look_at_matrix,
        mitsuba_handedness_fix,
    )

    scene = Scene()
    mirror = Material(type=MatType.CONDUCTOR)  # delta lobe
    scene.shape_instances = [
        # mirror floor seen by the camera
        ShapeInstance(
            shape=scene.shape_manager.load_rectangle(),
            material=mirror,
            transform=Transform().scale(4, 4, 1).rotate(1, 0, 0, -90),
        ),
        # diffuse wall the mirror reflects (lit by the area light)
        ShapeInstance(
            shape=scene.shape_manager.load_rectangle(),
            material=Material(
                type=MatType.DIFFUSE, reflectance=rgb_texture(0.8)
            ),
            transform=Transform().scale(4, 4, 1).translate(0, 2, -3.5),
        ),
        # area light facing the wall (one-sided: normal must point -z)
        ShapeInstance(
            shape=scene.shape_manager.load_rectangle(),
            material=Material(type=MatType.DIFFUSE),
            transform=Transform().scale(0.6, 0.6, 1)
            .rotate(1, 0, 0, 145).translate(0, 3.4, 2.5),
            emitter=Emitter(
                type=EmitterType.AREA, radiance=rgb_texture(12, 12, 12)
            ),
            is_emitter=True,
        ),
    ]
    scene.sensor.film.w, scene.sensor.film.h = 64, 64
    scene.integrator.max_depth = 3
    m = mitsuba_handedness_fix(mitsuba_handedness_fix(
        look_at_matrix([0, 2.5, 3.5], [0, 1.2, -1], [0, 1, 0])
    ))
    scene.sensor.transform = Transform(m)
    scene.sensor.fov = 45.0
    data, config = flatten_scene(scene)
    config = dataclasses.replace(config, max_depth=3, accumulate=True)
    camera = camera_block_from_scene(scene)

    ref = np.asarray(render(data, camera, config, spp=64))
    n = config.width * config.height
    accum = jnp.zeros((n, 3), jnp.float32)
    packed = jnp.zeros((n, N_PACK), jnp.float32)
    for s in range(32):
        accum, packed, _ = restir_gi_frame(
            data, camera, jnp.uint32(4000 + s), packed, accum,
            jnp.int32(s), config, spatial_taps=2, spatial_radius=8,
        )
    img = np.asarray(accum).reshape(config.height, config.width, 3)
    # the mirror region is a large fraction of the frame; global energy
    # must match PT (before the fix the GI pass rendered mirrors BLACK
    # except direct emitter hits: ratio ~0.2)
    ratio = img.mean() / ref.mean()
    assert abs(ratio - 1.0) < 0.06, ratio
    a, b = _downsample(img), _downsample(ref)
    mask = b.mean(axis=-1) > 1e-3
    rel = np.abs(a - b).sum(axis=-1)[mask] / (b.sum(axis=-1)[mask] + 1e-3)
    assert np.median(rel) < 0.25, np.median(rel)


@pytest.mark.heavy
def test_restir_gi_variance_beats_one_pt_sample(restir_scene):
    """The GI reservoir's reuse (temporal M growth + spatial taps) must
    make a single frame's indirect estimate clearly less noisy than one
    PT sample at the same depth — the estimator's reason to exist.
    Proxy: median per-pixel luminance deviation from a converged PT
    reference, measured on the frame AFTER temporal history warmed up."""
    from pupiloptixlab_tpu.render.restir_gi import restir_gi_frame

    data, config, camera = restir_scene
    n = config.width * config.height
    cfg3 = dataclasses.replace(config, max_depth=3, accumulate=False)
    ref3 = np.asarray(
        render(data, camera, dataclasses.replace(cfg3, accumulate=True),
               spp=64)
    ).reshape(-1, 3)
    ref2 = np.asarray(
        render(data, camera,
               dataclasses.replace(config, max_depth=2, accumulate=True),
               spp=64)
    ).reshape(-1, 3)

    accum = jnp.zeros((n, 3), jnp.float32)
    packed = jnp.zeros((n, N_PACK), jnp.float32)
    frame = None
    for s in range(6):  # 5 warmup frames fill temporal reservoirs
        accum, packed, frame = restir_gi_frame(
            data, camera, jnp.uint32(9000 + s), packed, accum,
            jnp.int32(s), cfg3, spatial_taps=2, spatial_radius=8,
        )
    one_pt = np.asarray(
        render(data, camera, cfg3, spp=1, seed0=9005)
    ).reshape(-1, 3)

    # both estimators share the SAME one-draw direct path, so the win
    # only shows where the one-bounce term carries the energy: gate on
    # pixels whose indirect fraction (depth-3 minus depth-2 reference)
    # exceeds 20% (measured ratio there: 0.76-0.85 across film sizes)
    lum = np.array([0.2126, 0.7152, 0.0722])
    ind = np.maximum((ref3 - ref2) @ lum, 0.0)
    mask = ind > 0.2 * np.maximum(ref3 @ lum, 1e-6)
    assert mask.sum() > 100, mask.sum()
    err_gi = np.abs((np.asarray(frame).reshape(-1, 3) - ref3) @ lum)
    err_pt = np.abs((one_pt - ref3) @ lum)
    assert np.median(err_gi[mask]) < 0.9 * np.median(err_pt[mask]), (
        np.median(err_gi[mask]), np.median(err_pt[mask])
    )
