"""Config-4 coverage: OBJ mesh + env-map light + denoiser + progressive."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

DATA = Path(__file__).parent.parent / "data"


@pytest.fixture(scope="module")
def mesh_scene():
    from pupiloptixlab_tpu.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu.scene import load_scene

    if not (DATA / "mesh_env.xml").exists():
        pytest.skip("mesh_env fixture missing")
    scene = load_scene(DATA / "mesh_env.xml")
    scene.sensor.film.w, scene.sensor.film.h = 64, 36
    data, config = flatten_scene(scene)
    camera = camera_block_from_scene(scene)
    return scene, data, config, camera


def test_obj_loader_counts(mesh_scene):
    scene, data, config, camera = mesh_scene
    assert config.tri_count == 20480 + 2  # icosphere + floor rect
    assert config.has_env and config.env_size == (128, 64)
    # normals came from the file, normalized
    n0 = np.asarray(data.tris.attrs[:100, 0:3])
    norms = np.linalg.norm(n0, axis=1)
    assert np.all((norms > 0.99) & (norms < 1.01))


@pytest.mark.heavy
def test_mesh_env_render_and_denoise(mesh_scene):
    from pupiloptixlab_tpu.denoise import Denoiser, DenoiserMode
    from pupiloptixlab_tpu.render.integrator import render_frame

    scene, data, config, camera = mesh_scene
    n = config.width * config.height
    accum = jnp.zeros((n, 3), jnp.float32)
    for s in range(3):  # progressive accumulation
        accum, bufs = render_frame(
            data, camera, jnp.uint32(s), jnp.int32(s), accum, config
        )
    img = np.asarray(accum).reshape(config.height, config.width, 3)
    assert np.isfinite(img).all()
    assert img.mean() > 0.05  # env-lit

    albedo = np.asarray(bufs["albedo"]).reshape(config.height, config.width, 3)
    normal = np.asarray(bufs["normal"]).reshape(config.height, config.width, 3)
    d = Denoiser(DenoiserMode.USE_ALBEDO | DenoiserMode.USE_NORMAL)
    d.setup(config.width, config.height)
    out = d.execute(
        {"input": jnp.asarray(img), "albedo": jnp.asarray(albedo),
         "normal": jnp.asarray(normal)}
    )
    out = np.asarray(out)
    assert out.shape == img.shape and np.isfinite(out).all()
    # denoising reduces pixel variance
    assert out.std() < img.std()


def test_envmap_importance_sampling_prefers_sun(mesh_scene):
    """The sky EXR has a bright sun; joint-CDF samples concentrate there."""
    from pupiloptixlab_tpu.render.emitter import _env_sample_direct
    from pupiloptixlab_tpu.render.vec import Vec3

    scene, data, config, camera = mesh_scene
    n = 8192
    rng = np.random.RandomState(0)
    u1 = jnp.asarray(rng.rand(n).astype(np.float32))
    u2 = jnp.asarray(rng.rand(n).astype(np.float32))
    pos = Vec3.zeros(n)
    nrm = Vec3.full(n, 0.0, 1.0, 0.0)
    env = _env_sample_direct(
        data.emitters, data.textures, config, pos, nrm, u1, u2
    )
    wi_y = np.asarray(env["wi"].y)
    # sun is at y-component ~0.8; most samples should be above the horizon
    assert (wi_y > 0.5).mean() > 0.5
    # estimator sanity: E[L/pdf] = integral of L over the sphere (finite)
    lum = 0.2126 * np.asarray(env["radiance"].x) + 0.7152 * np.asarray(
        env["radiance"].y
    ) + 0.0722 * np.asarray(env["radiance"].z)
    pdf = np.asarray(env["pdf"])
    est = (lum / np.maximum(pdf, 1e-9)).mean()
    assert 0 < est < 1e3


def test_sorted_pallas_sweeps_match_xla_fallback(mesh_scene):
    """The full BVH traversal path — coherence sort, per-ray walk,
    un-permute, masking, const-bound trimming — agrees with the
    brute-force sweep over the same triangle rows on a real BVH scene."""
    from pupiloptixlab_tpu.accel import intersect as I
    from pupiloptixlab_tpu.render.sampling import MAX_DISTANCE
    from pupiloptixlab_tpu.render.vec import Vec3

    scene, data, config, camera = mesh_scene
    assert config.bvh_nodes > 0

    rng = np.random.RandomState(5)
    n = 2048
    ro_np = rng.randn(n, 3).astype(np.float32) * 2.0 + [0, 1.5, 0]

    def unit(m):
        m = m.astype(np.float32)
        return m / np.linalg.norm(m, axis=1, keepdims=True)

    sd_np = unit(rng.randn(n, 3))
    bd_np = unit(rng.randn(n, 3))
    ro = Vec3(*(jnp.asarray(ro_np[:, i]) for i in range(3)))
    sdir = Vec3(*(jnp.asarray(sd_np[:, i]) for i in range(3)))
    bdir = Vec3(*(jnp.asarray(bd_np[:, i]) for i in range(3)))
    stmax = jnp.asarray(
        np.where(rng.rand(n) < 0.5, 3.0, MAX_DISTANCE).astype(np.float32)
    )
    smask = jnp.asarray(rng.rand(n) < 0.8)
    bmask = jnp.asarray(rng.rand(n) < 0.8)
    oprim = jnp.asarray(
        rng.randint(-1, config.tri_count, n).astype(np.int32)
    )
    tmin = jnp.full(n, 1e-3, jnp.float32)
    btmax = jnp.full(n, MAX_DISTANCE, jnp.float32)

    def run_both():
        occ = I.intersect_any(
            ro, sdir, tmin, stmax, data, config, coherent=False,
            origin_prim=oprim, mask=smask, const_tmin=1e-3,
        )
        hit = I.intersect_closest(
            ro, bdir, tmin, btmax, data, config, coherent=False,
            origin_prim=oprim, mask=bmask,
            const_tmin=1e-3, const_tmax=MAX_DISTANCE,
        )
        return occ, hit

    occ_p, hit_p = run_both()  # sorted BVH traversal
    # reference: brute-force sweep of the same (BVH-ordered) rows
    rays_s = (ro, sdir, tmin, jnp.where(smask, stmax, -1.0))
    t_s, _, k_s = I._sweep_tris_xla(*rays_s, data)
    occ_ref = np.asarray(k_s) == 0
    t_b, p_b, k_b = I._sweep_tris_xla(
        ro, bdir, tmin, jnp.where(bmask, btmax, -1.0), data
    )
    hit_ref = I.Hit(t=t_b, prim=p_b, kind=k_b, inst=jnp.zeros_like(p_b))

    np.testing.assert_array_equal(np.asarray(occ_p), np.asarray(occ_ref))
    hm_ref = np.asarray(hit_ref.hit_mask)
    hm_p = np.asarray(hit_p.hit_mask)
    assert (hm_ref == hm_p).mean() > 0.999
    both = hm_ref & hm_p
    np.testing.assert_allclose(
        np.asarray(hit_p.t)[both], np.asarray(hit_ref.t)[both],
        rtol=2e-4, atol=2e-4,
    )
    assert (np.asarray(hit_p.prim)[both] == np.asarray(hit_ref.prim)[both]).mean() > 0.999
    # masked-off lanes never report results
    assert not np.asarray(occ_p)[~np.asarray(smask)].any()
    assert not hm_p[~np.asarray(bmask)].any()
