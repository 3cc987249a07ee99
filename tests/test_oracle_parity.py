"""End-to-end accuracy vs the independent brute-force oracle.

tests/data/oracle_cornell_64.exr is a 4096-spp render from
tools/oracle_pt.py — a standalone numpy path tracer (pure BSDF
sampling, no NEE/MIS, its own flatten + intersector) that shares only
the scene loader with the production renderer. Agreement here validates
the FULL estimator (NEE + MIS + RR + emission sidedness), which
self-goldens cannot (BASELINE.md accuracy row; mitsuba3 is not
installable in this image).

This caught two real energy bugs in round 2: the reference's own MIS
selection-probability asymmetry (main.cu:135-137 vs 180; +5% direct
with 2 emitters) and twosided backside emission through the flipped
shading normal (+60% on light-adjacent pixels).
"""

from pathlib import Path

import numpy as np
import pytest

ORACLE = Path(__file__).parent / "data" / "oracle_cornell_64.exr"


@pytest.mark.slow
def test_cornell_matches_brute_force_oracle(reference_scene_dir):
    from pupiloptixlab_tpu.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu.render.integrator import render
    from pupiloptixlab_tpu.scene import load_scene
    from pupiloptixlab_tpu.utils.image import read_exr

    scene = load_scene(reference_scene_dir / "cornellbox.xml")
    scene.sensor.film.w = scene.sensor.film.h = 64
    data, config = flatten_scene(scene)
    cam = camera_block_from_scene(scene)
    img = np.asarray(render(data, cam, config, spp=512))
    oracle = read_exr(ORACLE)[::-1][..., :3]

    rel_mse = float(np.mean((img - oracle) ** 2) / np.mean(oracle**2))
    mean_ratio = float(img.mean() / oracle.mean())

    # global energy must agree within a fraction of a percent
    assert abs(mean_ratio - 1.0) < 0.01, mean_ratio
    # pixelwise rel MSE at equal-ish variance budgets (oracle 4096 spp
    # pure-BSDF ~ ours 512 spp NEE+MIS); BASELINE target is 1e-3
    assert rel_mse < 2e-3, rel_mse
    # and with a 4x4 box filter (cuts both noise floors) much tighter
    def box(a):
        return a.reshape(16, 4, 16, 4, 3).mean((1, 3))

    box_rel = float(np.mean((box(img) - box(oracle)) ** 2) / np.mean(box(oracle) ** 2))
    assert box_rel < 3e-4, box_rel


ORACLE_VEACH = Path(__file__).parent / "data" / "oracle_veach_96.exr"


@pytest.mark.slow
def test_veach_matches_brute_force_oracle(reference_scene_dir):
    """mis.xml (veach): rough-conductor strips + sphere lights — the
    scene MIS exists for. The oracle is pure BSDF sampling at 8192 spp,
    so its noise floor is high on the small bright lights; gates are
    energy ratio + box-filtered MSE."""
    from pupiloptixlab_tpu.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu.render.integrator import render
    from pupiloptixlab_tpu.scene import load_scene
    from pupiloptixlab_tpu.utils.image import read_exr
    import dataclasses

    scene = load_scene(reference_scene_dir / "mis.xml")
    scene.sensor.film.w = scene.sensor.film.h = 96  # oracle is square
    data, config = flatten_scene(scene)
    config = dataclasses.replace(config, max_depth=4)  # oracle default
    cam = camera_block_from_scene(scene)
    img = np.asarray(render(data, cam, config, spp=384))
    oracle = read_exr(ORACLE_VEACH)[::-1][..., :3]

    mean_ratio = float(img.mean() / oracle.mean())
    assert abs(mean_ratio - 1.0) < 0.02, mean_ratio

    def box(a):
        return a.reshape(12, 8, 12, 8, 3).mean((1, 3))

    box_rel = float(
        np.mean((box(img) - box(oracle)) ** 2) / np.mean(box(oracle) ** 2)
    )
    assert box_rel < 2e-3, box_rel


@pytest.mark.slow
def test_mesh_env_matches_brute_force_oracle():
    """data/mesh_env.xml (BASELINE config 4's scene): 20k-triangle
    icosphere under an equirect environment map — exercises the BVH
    traversal and the env joint-CDF NEE/MIS path end-to-end against
    brute force. Oracle: 4096 spp pure-BSDF sampling at 64x64,
    tools/oracle_pt.py; gate: validate.ORACLE_GATES["mesh_env"].

    The gates are loose: a PUPIL_NO_BVH brute-force-sweep render at
    identical seeds matched the BVH render at 1024 spp in an earlier
    build, so the residual (sphere
    darker / its env-shadow zone brighter by up to ~10%) is not
    traversal. It traces to the oracle's shading normals: the committed
    oracle image was rendered with FACE-AVERAGED vertex normals while
    production interpolates barycentrically (the reference's behavior,
    optix_util.h closesthit geometry). Tighten to the 1e-3 BASELINE row
    after regenerating the oracle (ROADMAP R7)."""
    from pupiloptixlab_tpu.validate import oracle_gate

    oracle_gate("mesh_env")


@pytest.mark.slow
@pytest.mark.heavy
def test_big_env_matches_brute_force_oracle():
    """The 405k-triangle generated scene (displaced grid under a
    2.5x-scaled sky, tools/make_big_scene.py, written into
    data/generated/) against a 1168-spp pure-BSDF oracle at 48x48 —
    oracle coverage of a large BVH AND of a scaled envmap.

    This gate exists because its calibration run caught a real
    estimator bug: the env NEE/MIS pdf used the SCALED radiance
    luminance against a normalization built from unscaled pixels, so
    every surface lit by a scale!=1 envmap under-collected by exactly
    `scale` (production read 0.73x the oracle terrain-wide while the
    escape path matched 1.000). Fixed in flatten's env_norm; scale=1
    scenes were never affected. Gates reflect the oracle's noise floor
    (pure BSDF under an HDR sun at 1168 spp)."""
    from pupiloptixlab_tpu.validate import oracle_gate

    oracle_gate("big_env")


@pytest.mark.slow
def test_all_bsdfs_match_brute_force_oracle():
    """data/oracle_mat.xml: all SEVEN BSDF types (diffuse, conductor,
    rough conductor, dielectric, rough dielectric, plastic, rough
    plastic) under an area light AND a constant environment — validates
    the full estimator including env NEE/MIS and the delta/horizon MIS
    overrides this oracle caught in round 3 (furnace mirror/glass
    spheres rendered 14-17% dark before the fix). Oracle: 16384 spp
    pure-BSDF sampling, tools/oracle_pt.py."""
    from pupiloptixlab_tpu.validate import oracle_gate

    oracle_gate("oracle_mat")
