"""Device-side instancing: O(unique) tri-table memory + identical
renders vs the baked world-space path.

The GAS-reuse half of the reference's two-level accel
(world/gas_manager.cpp:10-27 caches one BLAS per shape id;
world/ias_manager.cpp:165-185 instances carry only 3x4 transforms)."""

from __future__ import annotations

import numpy as np
import pytest


def _make_scene(tmp_path, n_inst=50, grid=8, res=64):
    """tools/make_instanced_scene.py: n_inst instances of one
    displaced-grid OBJ plus a floor and an area light."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).parent.parent / "tools" / "make_instanced_scene.py"
    spec = importlib.util.spec_from_file_location("make_instanced_scene", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make(tmp_path, n_inst, grid, res)


@pytest.fixture(scope="module")
def instanced_pair(tmp_path_factory):
    from pupiloptixlab_tpu.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu.scene import load_scene

    tmp = tmp_path_factory.mktemp("inst")
    path = _make_scene(tmp)
    s1 = load_scene(path)
    data_i, cfg_i = flatten_scene(s1)
    s2 = load_scene(path)
    data_b, cfg_b = flatten_scene(s2, allow_instanced=False)
    cam = camera_block_from_scene(s1)
    return data_i, cfg_i, data_b, cfg_b, cam


def test_instanced_memory_is_o_unique(instanced_pair):
    data_i, cfg_i, data_b, cfg_b, cam = instanced_pair
    assert cfg_i.instanced and not cfg_b.instanced
    # 50 instances of a 128-tri shape: unique table ~= 1 shape (+ two
    # anon rects), baked table ~= 50x
    assert data_i.tris.packed.shape[0] < data_b.tris.packed.shape[0] / 10
    assert data_i.tris.attrs.shape[0] == data_i.tris.packed.shape[0]
    # per-instance cost: leaf tables + one 3x4 + one shading row
    n_inst = data_i.tris.inst_w2o.shape[0]
    assert n_inst == 52  # 50 bumps + floor + light rect
    assert data_i.tris.leaf_inst.shape == data_i.tris.leaf_start.shape


@pytest.mark.heavy
def test_instanced_render_matches_baked(instanced_pair):
    from pupiloptixlab_tpu.render.integrator import render

    data_i, cfg_i, data_b, cfg_b, cam = instanced_pair
    img_i = np.asarray(render(data_i, cam, cfg_i, spp=4))
    img_b = np.asarray(render(data_b, cam, cfg_b, spp=4))
    # same RNG streams, same estimator: images differ only by fp-level
    # intersection differences at silhouette pixels
    diff = np.abs(img_i - img_b).max(axis=-1)
    assert float(np.quantile(diff, 0.995)) < 2e-3, float(
        np.quantile(diff, 0.995)
    )
    assert abs(img_i.mean() / img_b.mean() - 1.0) < 2e-3


def test_instanced_emitter_ids(instanced_pair):
    """Emissive instanced geometry maps hits back to per-instance
    emitter rows (emitter_id = instance base + original face index)."""
    import jax.numpy as jnp

    from pupiloptixlab_tpu.accel.intersect import intersect_closest
    from pupiloptixlab_tpu.render.geometry import get_local_geometry
    from pupiloptixlab_tpu.render.sampling import MAX_DISTANCE
    from pupiloptixlab_tpu.render.vec import Vec3

    data_i, cfg_i, data_b, cfg_b, cam = instanced_pair
    n = 64
    # rays straight down at the light rect -> should hit non-emissive
    # floor after passing beside it; aim at a bump instead (no emitter)
    ro = Vec3(jnp.zeros(n), jnp.full(n, 5.0), jnp.zeros(n))
    rd = Vec3(jnp.zeros(n), jnp.full(n, -1.0), jnp.zeros(n))
    tmin = jnp.full(n, 1e-3)
    tmax = jnp.full(n, MAX_DISTANCE)
    hit = intersect_closest(ro, rd, tmin, tmax, data_i, cfg_i)
    geo = get_local_geometry(
        data_i, hit, ro, rd, cfg_i.sphere_count, cfg_i.instanced
    )
    assert bool(jnp.all(hit.hit_mask))
    # bump instances are diffuse, not emissive
    assert bool(jnp.all(geo.emitter_id == -1))
    # normals point up-ish after the instance transform
    assert float(geo.normal.y.min()) > 0.3


def test_instanced_pallas_kernel_matches_xla(instanced_pair):
    """The instanced traversal (the plain walk: the CPU route and the
    CUDA kernel's reference) agrees with the instanced brute-force leaf
    scan on closest and any-hit, and through intersect_closest."""
    import jax.numpy as jnp

    from pupiloptixlab_tpu.accel.intersect import (
        _sweep_tris_xla_instanced,
        intersect_closest,
    )
    from pupiloptixlab_tpu.accel.traverse import walk
    from pupiloptixlab_tpu.render.sampling import MAX_DISTANCE
    from pupiloptixlab_tpu.render.vec import Vec3

    data_i, cfg_i, data_b, cfg_b, cam = instanced_pair
    rng = np.random.RandomState(11)
    n = 2048
    ro_np = rng.randn(n, 3).astype(np.float32) * 3.0 + [0, 3, 0]
    rd_np = rng.randn(n, 3).astype(np.float32)
    rd_np /= np.linalg.norm(rd_np, axis=1, keepdims=True)
    ro = Vec3(*(jnp.asarray(ro_np[:, i]) for i in range(3)))
    rd = Vec3(*(jnp.asarray(rd_np[:, i]) for i in range(3)))
    tmin = jnp.full(n, 1e-3)
    tmax = jnp.full(n, MAX_DISTANCE, jnp.float32)

    t_ref, p_ref, k_ref, i_ref = _sweep_tris_xla_instanced(
        ro, rd, tmin, tmax, data_i, cfg_i
    )
    tris = data_i.tris
    kw = dict(instanced=True, leaf_start=tris.leaf_start,
              leaf_inst=tris.leaf_inst, inst_w2o=tris.inst_w2o)
    args = (ro, rd, tmin, tmax, tris.packed, tris.bvh_child, tris.bvh_boxes,
            cfg_i.bvh_tcl)
    t_k, p_k, l_k = walk(*args, **kw)
    hit_ref = np.asarray(k_ref) == 0
    hit_k = np.asarray(p_k) >= 0
    np.testing.assert_array_equal(hit_k, hit_ref)
    np.testing.assert_allclose(
        np.asarray(t_k)[hit_ref], np.asarray(t_ref)[hit_ref], rtol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(p_k)[hit_ref],
                                  np.asarray(p_ref)[hit_ref])
    inst_k = np.asarray(tris.leaf_inst)[np.maximum(np.asarray(l_k), 0)]
    np.testing.assert_array_equal(inst_k[hit_ref], np.asarray(i_ref)[hit_ref])

    occ = np.asarray(walk(*args, anyhit=True, **kw))
    np.testing.assert_array_equal(occ, hit_ref)

    # the production entry point resolves the instance id from the leaf
    hit = intersect_closest(ro, rd, tmin, tmax, data_i, cfg_i)
    np.testing.assert_array_equal(np.asarray(hit.kind) == 0, hit_ref)
    np.testing.assert_array_equal(np.asarray(hit.inst)[hit_ref],
                                  np.asarray(i_ref)[hit_ref])
