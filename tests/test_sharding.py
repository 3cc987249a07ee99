"""Multi-chip pixel sharding on the virtual 8-device CPU mesh."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from pupiloptixlab_tpu.flatten import camera_block_from_scene, flatten_scene
from pupiloptixlab_tpu.parallel import make_mesh, render_frame_sharded, shard_scene
from pupiloptixlab_tpu.render.integrator import render_frame
from pupiloptixlab_tpu.scene import load_scene

MESH_ENV = Path(__file__).resolve().parent.parent / "data" / "mesh_env.xml"


@pytest.fixture(scope="module")
def tiny_cornell(reference_scene_dir):
    scene = load_scene(reference_scene_dir / "cornellbox.xml")
    scene.sensor.film.w, scene.sensor.film.h = 16, 16
    data, config = flatten_scene(scene)
    camera = camera_block_from_scene(scene)
    return data, config, camera


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_matches_single_device(tiny_cornell):
    data, config, camera = tiny_cornell
    n = config.width * config.height
    accum0 = jnp.zeros((n, 3), jnp.float32)

    ref_accum, ref_bufs = render_frame(
        data, camera, jnp.uint32(7), jnp.int32(0), accum0, config
    )

    mesh = make_mesh(8)
    sharded_scene = shard_scene(data, mesh)
    accum_sharded = jax.device_put(
        jnp.zeros((n, 3), jnp.float32), NamedSharding(mesh, P("pixels"))
    )
    out_accum, out_bufs = render_frame_sharded(
        mesh, sharded_scene, camera, seed=7, sample_cnt=0,
        accum=accum_sharded, config=config,
    )
    np.testing.assert_allclose(
        np.asarray(ref_accum), np.asarray(out_accum), rtol=1e-4, atol=1e-5
    )
    # the output really is sharded over the mesh
    assert len(out_accum.sharding.device_set) == 8


def test_sharded_bvh_scene_matches_single_device():
    """Pixel sharding of a BVH scene (per-ray traversal + ray sort under
    GSPMD) reproduces the single-device frame."""
    scene = load_scene(MESH_ENV)
    scene.sensor.film.w, scene.sensor.film.h = 32, 16
    data, config = flatten_scene(scene)
    camera = camera_block_from_scene(scene)
    n = config.width * config.height
    ref, _ = render_frame(data, camera, jnp.uint32(3), jnp.int32(0),
                          jnp.zeros((n, 3), jnp.float32), config)
    mesh = make_mesh(8)
    out, _ = render_frame_sharded(
        mesh, shard_scene(data, mesh), camera, seed=3, sample_cnt=0,
        accum=jnp.zeros((n, 3), jnp.float32), config=config,
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)
    assert len(out.sharding.device_set) == 8
    # the next progressive frame reuses the traced and compiled step
    from pupiloptixlab_tpu.parallel.sharding import _sharded_frame

    step = _sharded_frame(mesh, config)
    out = render_frame_sharded(mesh, sdata := shard_scene(data, mesh), camera,
                               seed=4, sample_cnt=1, accum=out,
                               config=config)[0]
    compiled = step._cache_size()
    out = render_frame_sharded(mesh, sdata, camera, seed=5, sample_cnt=2,
                               accum=out, config=config)[0]
    assert step._cache_size() == compiled
    assert np.isfinite(np.asarray(out)).all()


def test_ring_sharded_sweep_matches_single_device():
    """Ring-sharded traversal (tri table sharded over the 8-dev mesh,
    rotated by ppermute) returns the same closest hits as the
    single-device sweep; per-chip table residency is T/8."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pupiloptixlab_tpu.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu.parallel.ring_sweep import (
        ring_closest, shard_tris,
    )
    from pupiloptixlab_tpu.parallel.sharding import make_mesh
    from pupiloptixlab_tpu.render.camera import generate_rays
    from pupiloptixlab_tpu.scene import load_scene

    scene = load_scene(MESH_ENV)
    scene.sensor.film.w, scene.sensor.film.h = 128, 64
    data, config = flatten_scene(scene)
    camera = camera_block_from_scene(scene)
    n = config.width * config.height
    jx = jnp.zeros(n)
    ro, rd = generate_rays(camera, config.width, config.height, jx, jx)
    tmin = jnp.full(n, 1e-3, jnp.float32)
    tmax = jnp.full(n, 1e16, jnp.float32)

    mesh = make_mesh(8, axis="shards")
    tris_sh, shard_rows = shard_tris(data.tris.packed, mesh)
    # per-chip residency really is 1/8 of the table
    db = tris_sh.sharding.shard_shape(tris_sh.shape)
    assert db[0] == tris_sh.shape[0] // 8

    ro_flat = jnp.stack([ro.x, ro.y, ro.z])
    rd_flat = jnp.stack([rd.x, rd.y, rd.z])
    t_ring, p_ring = ring_closest(
        mesh, ro_flat, rd_flat, tmin, tmax, tris_sh, shard_rows
    )

    from pupiloptixlab_tpu.accel.intersect import intersect_closest

    hit = intersect_closest(ro, rd, tmin, tmax, data, config)
    t_ref = np.where(np.asarray(hit.hit_mask), np.asarray(hit.t), 1e16)
    got_hit = np.asarray(p_ring) >= 0
    assert (got_hit == np.asarray(hit.hit_mask)).mean() > 0.999
    both = got_hit & np.asarray(hit.hit_mask)
    np.testing.assert_allclose(
        np.asarray(t_ring)[both], t_ref[both], rtol=1e-5, atol=1e-5
    )


def test_ring_bvh_matches_single_device():
    """The ring-sharded mode with a PER-SHARD BVH (rotated together with
    its shard by ppermute) matches the single-device traversal;
    per-device residency is 1/8 of rows + its own tree tables."""
    import jax.numpy as jnp
    import numpy as np

    from pupiloptixlab_tpu.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu.parallel.ring_sweep import (
        build_ring_bvh, ring_closest_bvh,
    )
    from pupiloptixlab_tpu.parallel.sharding import make_mesh
    from pupiloptixlab_tpu.render.camera import generate_rays
    from pupiloptixlab_tpu.scene import load_scene

    scene = load_scene(MESH_ENV)
    scene.sensor.film.w, scene.sensor.film.h = 64, 32
    data, config = flatten_scene(scene)
    camera = camera_block_from_scene(scene)
    n = config.width * config.height
    jx = jnp.zeros(n)
    ro, rd = generate_rays(camera, config.width, config.height, jx, jx)
    tmin = jnp.full(n, 1e-3, jnp.float32)
    tmax = jnp.full(n, 1e16, jnp.float32)

    mesh = make_mesh(8, axis="shards")
    ring = build_ring_bvh(data.tris.packed, mesh)
    # per-chip residency really is 1/8 of the rows
    db = ring.rows.sharding.shard_shape(ring.rows.shape)
    assert db[0] == 1

    ro_flat = jnp.stack([ro.x, ro.y, ro.z])
    rd_flat = jnp.stack([rd.x, rd.y, rd.z])
    t_ring, p_ring = ring_closest_bvh(
        mesh, ro_flat, rd_flat, tmin, tmax, ring
    )

    from pupiloptixlab_tpu.accel.intersect import intersect_closest

    hit = intersect_closest(ro, rd, tmin, tmax, data, config)
    t_ref = np.where(np.asarray(hit.hit_mask), np.asarray(hit.t), 1e16)
    got_hit = np.asarray(p_ring) >= 0
    assert (got_hit == np.asarray(hit.hit_mask)).mean() > 0.999
    both = got_hit & np.asarray(hit.hit_mask)
    np.testing.assert_allclose(
        np.asarray(t_ring)[both], t_ref[both], rtol=1e-4, atol=1e-4
    )
    # the winning GLOBAL rows agree on ~all mutual hits (fp near-ties
    # between equal-t triangles may legitimately differ)
    assert (np.asarray(p_ring)[both] == np.asarray(hit.prim)[both]).mean() > 0.99
