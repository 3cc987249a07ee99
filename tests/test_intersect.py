import jax.numpy as jnp
import numpy as np

from pupiloptixlab_tpu.accel.intersect import intersect_any, intersect_closest
from pupiloptixlab_tpu.flatten import flatten_scene
from pupiloptixlab_tpu.render.vec import Vec3
from pupiloptixlab_tpu.scene import Scene
from pupiloptixlab_tpu.scene.shapes import ShapeInstance
from pupiloptixlab_tpu.scene.materials import Material, MatType
from pupiloptixlab_tpu.utils.math import Transform


def _v3(rows):
    a = jnp.asarray(rows, jnp.float32)
    return Vec3(a[:, 0], a[:, 1], a[:, 2])


def _scene_with(instances):
    scene = Scene()
    scene.shape_instances = instances
    return flatten_scene(scene)


def _inst(scene_mgr_method, transform=None, **kw):
    scene = Scene()
    ins = ShapeInstance(
        shape=getattr(scene.shape_manager, scene_mgr_method)(),
        material=Material(type=MatType.DIFFUSE),
        transform=transform or Transform(),
        **kw,
    )
    return ins


def test_rectangle_hit_miss():
    data, config = _scene_with([_inst("load_rectangle")])  # z=0 plane [-1,1]^2
    ro = _v3([[0.5, 0.5, 3.0], [2.0, 2.0, 3.0]])
    rd = _v3([[0, 0, -1], [0, 0, -1]])
    hit = intersect_closest(
        ro, rd, jnp.full(2, 1e-3), jnp.full(2, 1e9), data, config
    )
    assert bool(hit.hit_mask[0]) and not bool(hit.hit_mask[1])
    np.testing.assert_allclose(float(hit.t[0]), 3.0, rtol=1e-5)


def test_cube_front_face():
    data, config = _scene_with([_inst("load_cube")])
    ro = _v3([[0.0, 0.0, 5.0]])
    rd = _v3([[0.0, 0.0, -1.0]])
    hit = intersect_closest(ro, rd, jnp.full(1, 1e-3), jnp.full(1, 1e9), data, config)
    np.testing.assert_allclose(float(hit.t[0]), 4.0, rtol=1e-5)  # hits z=+1


def test_sphere_hit_and_normal_frame():
    t = Transform().scale(2.0, 2.0, 2.0).translate(1.0, 0.0, 0.0)  # r=2 at x=1
    data, config = _scene_with([_inst("load_sphere", transform=t)])
    ro = _v3([[1.0, 0.0, 10.0]])
    rd = _v3([[0.0, 0.0, -1.0]])
    hit = intersect_closest(ro, rd, jnp.full(1, 1e-3), jnp.full(1, 1e9), data, config)
    assert bool(hit.hit_mask[0]) and int(hit.kind[0]) == 1
    np.testing.assert_allclose(float(hit.t[0]), 8.0, rtol=1e-5)

    from pupiloptixlab_tpu.render.geometry import get_local_geometry

    geo = get_local_geometry(data, hit, ro, rd)
    pos = [float(geo.position.x[0]), float(geo.position.y[0]), float(geo.position.z[0])]
    nrm = [float(geo.normal.x[0]), float(geo.normal.y[0]), float(geo.normal.z[0])]
    np.testing.assert_allclose(pos, [1, 0, 2], atol=1e-4)
    np.testing.assert_allclose(nrm, [0, 0, 1], atol=1e-4)


def test_ellipsoid_from_nonuniform_scale():
    t = Transform().scale(3.0, 1.0, 1.0)  # ellipsoid rx=3
    data, config = _scene_with([_inst("load_sphere", transform=t)])
    ro = _v3([[10.0, 0.0, 0.0], [0.0, 10.0, 0.0]])
    rd = _v3([[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    hit = intersect_closest(ro, rd, jnp.full(2, 1e-3), jnp.full(2, 1e9), data, config)
    np.testing.assert_allclose(float(hit.t[0]), 7.0, rtol=1e-5)  # 10 - 3
    np.testing.assert_allclose(float(hit.t[1]), 9.0, rtol=1e-5)  # 10 - 1


def test_closest_of_two():
    near = _inst("load_rectangle", transform=Transform().translate(0, 0, 1.0))
    far = _inst("load_rectangle", transform=Transform())
    data, config = _scene_with([far, near])
    ro = _v3([[0.0, 0.0, 5.0]])
    rd = _v3([[0.0, 0.0, -1.0]])
    hit = intersect_closest(ro, rd, jnp.full(1, 1e-3), jnp.full(1, 1e9), data, config)
    np.testing.assert_allclose(float(hit.t[0]), 4.0, rtol=1e-5)
    # the hit must belong to the 'near' instance (tris 2..3)
    assert int(hit.prim[0]) >= 2


def test_shadow_any_hit_tmax():
    data, config = _scene_with([_inst("load_rectangle")])
    ro = _v3([[0.0, 0.0, 5.0]])
    rd = _v3([[0.0, 0.0, -1.0]])
    occ_far = intersect_any(ro, rd, jnp.full(1, 1e-3), jnp.full(1, 10.0), data, config)
    occ_near = intersect_any(ro, rd, jnp.full(1, 1e-3), jnp.full(1, 4.0), data, config)
    assert bool(occ_far[0])
    assert not bool(occ_near[0])  # plane at t=5 is beyond tmax=4


def test_barycentric_interpolation():
    data, config = _scene_with([_inst("load_rectangle")])
    ro = _v3([[0.25, -0.5, 2.0]])
    rd = _v3([[0.0, 0.0, -1.0]])
    hit = intersect_closest(ro, rd, jnp.full(1, 1e-3), jnp.full(1, 1e9), data, config)
    from pupiloptixlab_tpu.render.geometry import get_local_geometry

    geo = get_local_geometry(data, hit, ro, rd)
    pos = [float(geo.position.x[0]), float(geo.position.y[0]), float(geo.position.z[0])]
    np.testing.assert_allclose(pos, [0.25, -0.5, 0], atol=1e-5)
    # rect uv: (0,0) at (-1,-1), (1,1) at (1,1)
    np.testing.assert_allclose([float(geo.uv.x[0]), float(geo.uv.y[0])], [0.625, 0.25], atol=1e-5)


def test_chunk_sweep_anyhit_matches_closest():
    """Small (sweep-route) scenes answer occlusion with the closest-hit
    sweep: intersect_any agrees with intersect_closest's hit mask,
    including tmax clipping (a hit beyond the light distance is not
    occlusion)."""
    import jax.numpy as jnp

    from pupiloptixlab_tpu.accel.intersect import _sweep_tris_xla

    r = np.random.RandomState(4)
    t = 128
    p0 = (r.rand(t, 3).astype(np.float32) * 4 - 2)
    e1 = (r.rand(t, 3).astype(np.float32) - 0.5) * 0.6
    e2 = (r.rand(t, 3).astype(np.float32) - 0.5) * 0.6
    packed = np.concatenate([p0, e1, e2, np.zeros((t, 3), np.float32)], 1)
    from types import SimpleNamespace

    from pupiloptixlab_tpu.flatten.types import RenderConfig

    scene = SimpleNamespace(tris=SimpleNamespace(packed=jnp.asarray(packed)))
    config = RenderConfig(width=32, height=32, tri_count=t)
    n = 1024
    ro = np.zeros((n, 3), np.float32)
    ro[:, 2] = -4.0
    rd = r.rand(n, 3).astype(np.float32) - 0.5
    rd[:, 2] += 1.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    o = Vec3(*(jnp.asarray(ro[:, k]) for k in range(3)))
    d = Vec3(*(jnp.asarray(rd[:, k]) for k in range(3)))
    tmin = jnp.full(n, 1e-3, jnp.float32)
    far = jnp.full(n, 1e16, jnp.float32)
    tb, ib, kb = _sweep_tris_xla(o, d, tmin, far, scene)
    hit = intersect_closest(o, d, tmin, far, scene, config)
    np.testing.assert_array_equal(np.asarray(hit.kind), np.asarray(kb))
    occ = intersect_any(o, d, tmin, far, scene, config)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(kb) == 0)
    assert np.asarray(occ).any() and not np.asarray(occ).all()

    # clipped tmax: hits beyond 2.0 are not occlusion
    occ2 = intersect_any(o, d, tmin, jnp.full(n, 2.0, jnp.float32), scene,
                         config)
    want = (np.asarray(kb) == 0) & (np.asarray(tb) < 2.0)
    np.testing.assert_array_equal(np.asarray(occ2), want)
