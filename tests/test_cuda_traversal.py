"""The CUDA traversal kernel (native/bvh_traverse.cu) against the plain
walk and the brute-force sweep. Needs an NVIDIA GPU: every test here is
marked ``gpu`` and skips elsewhere (see tests/conftest.py for the
command that runs them on a card). chip_smoke.py runs the same
comparisons at 1080p."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from test_traverse import _flat_scene, _instanced_scene, _rays

pytestmark = pytest.mark.gpu

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("mode", ["flat", "instanced"])
def test_cuda_matches_walk(gpu_device, mode):
    from pupiloptixlab_tpu.accel.traverse import traverse

    instanced = mode == "instanced"
    make = _instanced_scene if instanced else _flat_scene
    scene, config = make(5000, seed=21)
    rays = _rays(1 << 16, seed=22, center=(0.0, 0.5 * instanced, 0.0))
    t = scene.tris
    kw = {}
    if instanced:
        kw = dict(instanced=True, leaf_start=t.leaf_start,
                  leaf_inst=t.leaf_inst, inst_w2o=t.inst_w2o)
    args = (*rays, t.packed, t.bvh_child, t.bvh_boxes, config.bvh_tcl)
    got = traverse("cuda", *args, **kw)
    want = traverse("walk", *args, **kw)
    gi, wi = np.asarray(got[1]), np.asarray(want[1])
    hit = wi >= 0
    assert 0.05 < hit.mean() < 0.95
    assert (gi == wi).mean() > 0.9999
    # float32 rounding differences scale with the coordinates involved
    # (origins within ~6 of the origin, see validate.PARITY_RTOL)
    same = hit & (gi == wi)
    np.testing.assert_allclose(np.asarray(got[0])[same],
                               np.asarray(want[0])[same], rtol=1e-5,
                               atol=1e-5 * 6.0)
    occ = np.asarray(traverse("cuda", *args, anyhit=True, **kw))
    assert (occ == hit).mean() > 0.9999


@pytest.mark.parametrize("scene_name", ["mesh_env", "instanced"])
def test_cuda_traversal_parity(gpu_device, scene_name):
    from pupiloptixlab_tpu.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu.scene import load_scene
    from pupiloptixlab_tpu.validate import generated_scene, traversal_parity

    path = (REPO / "data" / "mesh_env.xml" if scene_name == "mesh_env"
            else generated_scene("instanced", 50, 8, 64))
    scene = load_scene(path)
    scene.sensor.film.w, scene.sensor.film.h = 256, 144
    data, config = flatten_scene(scene)
    res = traversal_parity(data, config, camera_block_from_scene(scene))
    assert res["primary"]["hits"] > 0


def test_cuda_rejects_bad_tables(gpu_device):
    """A box table whose size does not match the child table is refused
    by the kernel's shape check instead of being read out of bounds."""
    from pupiloptixlab_tpu.accel.traverse import traverse

    scene, config = _flat_scene(900, seed=23)
    rays = _rays(64, seed=24)
    t = scene.tris
    with pytest.raises(Exception):
        out = traverse("cuda", *rays, t.packed, t.bvh_child,
                       jnp.concatenate([t.bvh_boxes, t.bvh_boxes]),
                       config.bvh_tcl)
        np.asarray(out[0])
