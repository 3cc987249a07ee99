"""Device refit (flatten/refit.py) vs full host re-flatten.

The refit is the IAS::Update analog (world/ias_manager.cpp:116-151):
transform + visibility edits regenerate world-space rows, BVH/chunk
boxes and emitter CDFs on device with identical array shapes. For small
scenes (no BVH reorder on rebuild... the BVH path keeps its topology,
which a rebuild would not) we validate against the host flatten at the
RENDER level, and field-by-field where orders coincide.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest

from pupiloptixlab_tpu.flatten import camera_block, flatten_scene
from pupiloptixlab_tpu.render.integrator import render
from pupiloptixlab_tpu.scene import load_scene
from pupiloptixlab_tpu.utils.math import Transform
from pupiloptixlab_tpu.world import World


@pytest.fixture()
def cornell_world(reference_scene_dir):
    w = World()
    scene = load_scene(reference_scene_dir / "cornellbox.xml")
    scene.sensor.film.w = scene.sensor.film.h = 24
    w.set_scene(scene)
    return w


def _tree_allclose(a, b, atol=1e-5):
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(
            np.asarray(x), np.asarray(y), atol=atol, rtol=1e-4
        )


def test_identity_refit_matches_flatten(cornell_world):
    w = cornell_world
    data0, config0 = w.get_scene_data()
    assert w._refit is not None
    from pupiloptixlab_tpu.flatten.refit import refit_scene

    data1 = refit_scene(data0, w._refit, w.scene)
    _tree_allclose(data0, data1)


def test_transform_refit_matches_host_reflatten(cornell_world):
    w = cornell_world
    data0, config0 = w.get_scene_data()
    ro = w.get_render_object("ShortBox")
    ro.apply_transform(Transform().translate(0.15, 0.05, -0.1))
    data1, config1 = w.get_scene_data()  # device refit path
    assert config1 == config0
    host, _ = flatten_scene(w.scene)  # independent full host flatten
    # cornell (36 tris) has no BVH reorder -> rows comparable directly
    _tree_allclose(data1.tris, host.tris)
    _tree_allclose(data1.emitters, host.emitters)
    _tree_allclose(data1.spheres, host.spheres)


def test_emitter_transform_refit(cornell_world):
    """Moving the LIGHT must rebuild emitter rows, areas and the CDF."""
    w = cornell_world
    w.get_scene_data()
    ro = w.get_render_object("Light")
    ro.apply_transform(Transform().translate(0.1, -0.05, 0.0))
    data1, _ = w.get_scene_data()
    host, _ = flatten_scene(w.scene)
    _tree_allclose(data1.emitters, host.emitters)


def test_visibility_refit_matches_host(cornell_world):
    w = cornell_world
    w.get_scene_data()
    ro = w.get_render_object("TallBox")
    ro.set_visible(False)
    data1, config1 = w.get_scene_data()
    # refit degenerates edges instead of collapsing to the centroid, so
    # compare at the render level against the host flatten
    host, hconfig = flatten_scene(w.scene)
    cam = camera_block(w.camera)
    img_refit = np.asarray(render(data1, cam, config1, spp=4))
    img_host = np.asarray(render(host, cam, hconfig, spp=4))
    np.testing.assert_allclose(img_refit, img_host, atol=1e-5, rtol=1e-4)
    ro.set_visible(True)
    data2, _ = w.get_scene_data()
    host2, _ = flatten_scene(w.scene)
    _tree_allclose(data2.tris, host2.tris)


@pytest.mark.heavy
def test_refit_render_matches_host_render_with_bvh(tmp_path):
    """Mesh scene (BVH path): refit must render the moved scene right.
    The BVH keeps its topology (refit semantics) so arrays are NOT
    comparable to a host rebuild — images are."""
    w = World()
    scene = load_scene(Path(__file__).resolve().parent.parent / "data" / "mesh_env.xml")
    scene.sensor.film.w, scene.sensor.film.h = 32, 32
    w.set_scene(scene)
    data0, config0 = w.get_scene_data()
    assert config0.bvh_nodes > 0
    ro = w.render_objects[0]
    ro.apply_transform(Transform().translate(0.3, 0.1, 0.0))
    data1, config1 = w.get_scene_data()
    assert config1 == config0
    host, hconfig = flatten_scene(w.scene)
    cam = camera_block(w.camera)
    img_refit = np.asarray(render(data1, cam, config1, spp=2))
    img_host = np.asarray(render(host, cam, hconfig, spp=2))
    assert np.isfinite(img_refit).all()
    np.testing.assert_allclose(img_refit, img_host, atol=1e-4, rtol=1e-3)


def test_refit_no_retrace(cornell_world):
    """Consecutive edits reuse ONE cached refit executable and ONE frame
    executable (the whole point of the instance layer)."""
    import jax.numpy as jnp
    from pupiloptixlab_tpu.flatten.refit import _refit_device
    from pupiloptixlab_tpu.render.integrator import render_frame

    w = cornell_world
    data, config = w.get_scene_data()
    n = config.width * config.height
    cam = camera_block(w.camera)
    accum = jnp.zeros((n, 3), jnp.float32)
    render_frame(data, cam, jnp.uint32(0), jnp.int32(0), accum, config)

    misses0 = _refit_device._cache_size()
    ro = w.get_render_object("ShortBox")
    for i in range(3):
        ro.apply_transform(Transform().translate(0.01 * i, 0.0, 0.0))
        data, config = w.get_scene_data()
        accum = jnp.zeros((n, 3), jnp.float32)
        render_frame(data, cam, jnp.uint32(i), jnp.int32(0), accum, config)
    assert _refit_device._cache_size() - misses0 <= 1


def _instanced_env_scene(tmp_path, n_inst=16):
    """Instanced, mesh-only, non-emissive (const-env lit): the
    InstRefitData fast-path scope."""
    g = 8  # 16 instances x 128 tris = 2048 > the 1024-tri BVH cutoff
    xs = np.linspace(-0.5, 0.5, g + 1)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = 0.2 * np.sin(5.0 * X) * np.cos(4.0 * Z) + 0.2
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    i = np.arange(g * (g + 1)).reshape(g, g + 1)[:, :g]
    v00 = i.ravel()
    v10 = v00 + (g + 1)
    v01 = v00 + 1
    v11 = v10 + 1
    faces = np.concatenate(
        [np.stack([v00, v11, v10], 1), np.stack([v00, v01, v11], 1)], 0
    )
    obj = tmp_path / "bump.obj"
    with open(obj, "w") as f:
        np.savetxt(f, verts, fmt="v %.6f %.6f %.6f")
        np.savetxt(f, faces + 1, fmt="f %d %d %d")
    shapes = []
    for k in range(n_inst):
        x = (k % 4 - 1.5) * 1.5
        z = (k // 4 - 1.5) * 1.5
        shapes.append(f"""
  <shape type="obj">
    <string name="filename" value="bump.obj"/>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.6, 0.5, 0.4"/></bsdf>
    <transform name="to_world">
      <rotate y="1" angle="{k * 37.0:.1f}"/>
      <translate value="{x:.2f}, 0, {z:.2f}"/>
    </transform>
  </shape>""")
    xml = f"""<scene version="3.0.0">
  <integrator type="path"><integer name="max_depth" value="3"/></integrator>
  <sensor type="perspective"><float name="fov" value="55"/>
    <transform name="to_world">
      <lookat origin="0, 5, 6" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm"><integer name="width" value="32"/>
      <integer name="height" value="32"/></film>
  </sensor>
  <emitter type="constant"><rgb name="radiance" value="0.8, 0.8, 0.9"/></emitter>
  {''.join(shapes)}
</scene>"""
    p = tmp_path / "instanced_env.xml"
    p.write_text(xml)
    return p


def test_instanced_refit_matches_reflatten(tmp_path):
    """Instanced scenes take the InstRefitData fast path: a transform
    edit refits matrices + world boxes in place (object tables static),
    and the moved render matches a fresh instanced flatten. Reference:
    world/ias_manager.cpp:116-151 (IAS update over cached BLASes)."""
    from pupiloptixlab_tpu.flatten.refit import InstRefitData

    w = World()
    scene = load_scene(_instanced_env_scene(tmp_path))
    w.set_scene(scene)
    data0, config0 = w.get_scene_data()
    assert config0.instanced
    assert isinstance(w._refit, InstRefitData)
    u_rows = data0.tris.packed.shape[0]

    ro = w.render_objects[3]
    ro.apply_transform(Transform().translate(0.4, 0.25, -0.3))
    data1, config1 = w.get_scene_data()
    assert config1 == config0
    # object-space tables untouched; only matrices + boxes moved
    assert data1.tris.packed.shape[0] == u_rows
    assert data1.tris.packed is data0.tris.packed
    assert not np.allclose(
        np.asarray(data1.tris.inst_w2o), np.asarray(data0.tris.inst_w2o)
    )

    host, hconfig = flatten_scene(w.scene)
    cam = camera_block(w.camera)
    img_refit = np.asarray(render(data1, cam, config1, spp=2))
    img_host = np.asarray(render(host, cam, hconfig, spp=2))
    assert np.isfinite(img_refit).all()
    np.testing.assert_allclose(img_refit, img_host, atol=1e-4, rtol=1e-3)


def test_instanced_refit_visibility(tmp_path):
    """Hiding an instance through the refit path removes it from the
    render without any shape change (visibility-mask semantics)."""
    w = World()
    scene = load_scene(_instanced_env_scene(tmp_path))
    w.set_scene(scene)
    data0, config0 = w.get_scene_data()
    cam = camera_block(w.camera)
    img0 = np.asarray(render(data0, cam, config0, spp=1))

    ro = w.render_objects[5]  # a center-ish bump
    ro.set_visible(False)
    data1, config1 = w.get_scene_data()
    assert config1 == config0
    img1 = np.asarray(render(data1, cam, config1, spp=1))
    assert not np.allclose(img0, img1)  # something vanished

    host, hconfig = flatten_scene(w.scene)
    img_host = np.asarray(render(host, cam, hconfig, spp=1))
    np.testing.assert_allclose(img1, img_host, atol=1e-4, rtol=1e-3)
