"""Per-ray BVH traversal (accel/traverse.py) against the brute-force
sweep, plus the Python side of the CUDA route (accel/cuda_bvh.py): its
operand packing, its build command, which route runs on which backend,
and its custom partitioning over a device mesh."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pupiloptixlab_tpu.accel import cuda_bvh
from pupiloptixlab_tpu.accel.bvh import LEAF_SIZE, build_bvh, max_stack_depth
from pupiloptixlab_tpu.accel.intersect import (
    _sweep_tris_xla,
    _sweep_tris_xla_instanced,
)
from pupiloptixlab_tpu.accel.traverse import (
    MAX_DISTANCE,
    traversal_route,
    traverse,
    walk,
)
from pupiloptixlab_tpu.render.vec import Vec3


def _vec(a):
    return Vec3(*(jnp.asarray(a[:, k]) for k in range(3)))


def _soup(t, seed):
    """t random small triangles in [-2, 2]^3, padded to LEAF_SIZE."""
    r = np.random.RandomState(seed)
    t_pad = -(-t // LEAF_SIZE) * LEAF_SIZE
    p0 = np.zeros((t_pad, 3), np.float32)
    p0[:t] = r.rand(t, 3) * 4 - 2
    size = 0.4 * (900.0 / t) ** (1 / 3)  # keep the soup's density similar
    p1, p2 = p0.copy(), p0.copy()
    p1[:t] += (r.rand(t, 3) - 0.5) * size
    p2[:t] += (r.rand(t, 3) - 0.5) * size
    return p0, p1, p2


def _rays(n, seed, center=(0.0, 0.0, 0.0)):
    r = np.random.RandomState(seed)
    ro = (r.randn(n, 3) * 1.5 + center).astype(np.float32)
    rd = r.randn(n, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    # half unbounded, half short segments (exercises the tmax clip)
    tmax = np.where(r.rand(n) < 0.5, MAX_DISTANCE, r.rand(n) * 3.0)
    return _vec(ro), _vec(rd), jnp.asarray(tmin), jnp.asarray(tmax, jnp.float32)


def _flat_scene(t, seed):
    p0, p1, p2 = _soup(t, seed)
    bvh = build_bvh(p0, p1, p2, t, LEAF_SIZE)
    o = bvh.order
    packed = np.concatenate(
        [p0[o], (p1 - p0)[o], (p2 - p0)[o],
         np.zeros((p0.shape[0], 3), np.float32)], 1
    )
    tris = SimpleNamespace(
        packed=jnp.asarray(packed), bvh_child=jnp.asarray(bvh.child),
        bvh_boxes=jnp.asarray(bvh.boxes),
    )
    return SimpleNamespace(tris=tris), SimpleNamespace(bvh_tcl=LEAF_SIZE)


def _instanced_scene(t, seed):
    from pupiloptixlab_tpu.flatten.instanced import build_instanced_tables

    p0, p1, p2 = _soup(t, seed)
    z2 = np.zeros((t, 2), np.float32)
    nrm = np.tile(np.array([0, 1, 0], np.float32), (t, 1))
    shape = dict(p0=p0[:t], e1=(p1 - p0)[:t], e2=(p2 - p0)[:t],
                 n0=nrm, n1=nrm, n2=nrm, uv0=z2, uv1=z2, uv2=z2)
    metas = []
    for k in range(4):
        m = np.eye(4)
        ang = 0.9 * k
        m[:3, :3] = (0.5 + 0.25 * k) * np.array(
            [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
             [-np.sin(ang), 0, np.cos(ang)]])
        m[:3, 3] = (2.0 * k - 3.0, 0.3 * k, 0.0)
        metas.append(dict(key="soup", matrix=m, mat_id=0, emitter_base=-1,
                          flip=False, uv_flip=False, hidden=False))
    it = build_instanced_tables({"soup": shape}, metas, tcl0=32)
    tris = SimpleNamespace(**{
        k: jnp.asarray(it[v]) for k, v in (
            ("packed", "packed"), ("bvh_child", "bvh_child"),
            ("bvh_boxes", "bvh_boxes"), ("leaf_start", "leaf_start"),
            ("leaf_inst", "leaf_inst"), ("inst_w2o", "inst_w2o"))
    })
    return SimpleNamespace(tris=tris), SimpleNamespace(bvh_tcl=it["tcl"])


def _run_walk(scene, config, rays, anyhit=False, instanced=False):
    tris = scene.tris
    kw = {}
    if instanced:
        kw = dict(instanced=True, leaf_start=tris.leaf_start,
                  leaf_inst=tris.leaf_inst, inst_w2o=tris.inst_w2o)
    return walk(*rays, tris.packed, tris.bvh_child, tris.bvh_boxes,
                config.bvh_tcl, anyhit=anyhit, **kw)


@pytest.mark.parametrize("t_tris", [900, 5000, 20480])
@pytest.mark.parametrize("mode", ["flat", "instanced"])
def test_walk_matches_sweep(t_tris, mode):
    instanced = mode == "instanced"
    make = _instanced_scene if instanced else _flat_scene
    scene, config = make(t_tris, seed=t_tris)
    center = (0.0, 0.0, 0.0) if not instanced else (0.0, 0.5, 0.0)
    rays = _rays(2048, seed=1 + t_tris, center=center)
    if instanced:
        rt, rp, rk, _ = _sweep_tris_xla_instanced(*rays, scene, config)
    else:
        rt, rp, rk = _sweep_tris_xla(*rays, scene)
    rt, rp, rh = np.asarray(rt), np.asarray(rp), np.asarray(rk) == 0
    got = _run_walk(scene, config, rays, instanced=instanced)
    gt, gi = np.asarray(got[0]), np.asarray(got[1])
    assert 0.05 < rh.mean() < 0.95, rh.mean()
    np.testing.assert_array_equal(gi >= 0, rh)
    np.testing.assert_array_equal(gi[rh], rp[rh])
    np.testing.assert_allclose(gt[rh], rt[rh], rtol=1e-5)
    assert (gt[~rh] == MAX_DISTANCE).all()
    occ = np.asarray(_run_walk(scene, config, rays, anyhit=True,
                               instanced=instanced))
    np.testing.assert_array_equal(occ, rh)


@pytest.mark.parametrize("anyhit", [False, True])
def test_walk_masked_lanes_miss(anyhit):
    """Empty intervals (tmax <= tmin: culled lanes) never hit and never
    keep the loop alive; live lanes are unaffected by them."""
    scene, config = _flat_scene(900, seed=3)
    ro, rd, tmin, tmax = _rays(1024, seed=4)
    dead = jnp.arange(1024) % 3 == 0
    masked = jnp.where(dead, -1.0, tmax)
    full = _run_walk(scene, config, (ro, rd, tmin, tmax), anyhit=anyhit)
    part = _run_walk(scene, config, (ro, rd, tmin, masked), anyhit=anyhit)
    d = np.asarray(dead)
    if anyhit:
        assert not np.asarray(part)[d].any()
        np.testing.assert_array_equal(np.asarray(part)[~d],
                                      np.asarray(full)[~d])
    else:
        assert (np.asarray(part[1])[d] == -1).all()
        assert (np.asarray(part[0])[d] == MAX_DISTANCE).all()
        np.testing.assert_array_equal(np.asarray(part[1])[~d],
                                      np.asarray(full[1])[~d])


def test_max_stack_depth_matches_depth_first_pushes():
    """max_stack_depth (the bound accel/bvh.py checks against STACK_SIZE
    at build time) equals the peak of a depth-first walk that pushes
    every live child of every node."""
    p0, p1, p2 = _soup(5000, seed=9)
    bvh = build_bvh(p0, p1, p2, 5000, LEAF_SIZE)
    ids = bvh.child.reshape(-1, 8)
    peak, stack = 0, [(0, 0)]
    while stack:
        node, base = stack.pop()
        kids = [c for c in ids[node] if c != 0]
        peak = max(peak, base + len(kids))
        for c in kids:
            if c > 0:
                stack.append((c, base + len(kids) - 1))
    assert peak == max_stack_depth(bvh.child)


def test_traversal_route_by_backend():
    assert traversal_route("gpu") == "cuda"
    assert traversal_route("cpu") == "walk"
    assert traversal_route(jax.default_backend()) == "walk"


def test_traverse_rejects_unknown_route():
    scene, config = _flat_scene(900, seed=2)
    rays = _rays(8, seed=2)
    with pytest.raises(ValueError):
        traverse("tiles", *rays, scene.tris.packed, scene.tris.bvh_child,
                 scene.tris.bvh_boxes, config.bvh_tcl)


def test_cuda_operands_layout():
    """Operand order, dtypes and the 1-row instancing placeholders that
    flat scenes pass (native/bvh_traverse.cu binding order)."""
    scene, config = _flat_scene(900, seed=5)
    ro, rd, tmin, tmax = _rays(16, seed=5)
    ops = cuda_bvh.operands(ro, rd, tmin, tmax, scene.tris.packed,
                            scene.tris.bvh_child, scene.tris.bvh_boxes)
    assert len(ops) == 14
    assert [o.dtype for o in ops] == [jnp.float32] * 9 + [
        jnp.int32, jnp.float32, jnp.int32, jnp.int32, jnp.float32]
    assert all(o.shape == (16,) for o in ops[:8])
    assert ops[8].shape[1] == 12 and ops[10].shape[1] == 8
    assert ops[9].shape[0] == ops[10].shape[0]  # one id per child box
    assert ops[11].shape == (1,) and ops[13].shape == (1, 12)


def test_cuda_build_command_and_cache_key(tmp_path, monkeypatch):
    cmd = cuda_bvh.nvcc_command(tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert str(cuda_bvh.SOURCE) in cmd and "-shared" in cmd
    assert jax.ffi.include_dir() in cmd
    # the library name follows the source text, so an edit rebuilds
    src = tmp_path / "k.cu"
    src.write_text("// a")
    monkeypatch.setattr(cuda_bvh, "SOURCE", src)
    a = cuda_bvh.library_path()
    src.write_text("// b")
    assert cuda_bvh.library_path() != a
    assert a.parent == cuda_bvh.BUILD_DIR


def test_cuda_partitioning_keeps_rays_sharded(monkeypatch):
    """The custom partitioning around the FFI call runs one call per
    device on that device's rays. Checked on the CPU mesh with the walk
    standing in for the FFI call."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    scene, config = _flat_scene(900, seed=6)
    tcl = config.bvh_tcl

    def fake_ffi(tcl_, anyhit, instanced):
        def call(*args):
            ro, rd = Vec3(*args[0:3]), Vec3(*args[3:6])
            out = walk(ro, rd, args[6], args[7], args[8], args[9],
                       args[10], tcl_, anyhit=anyhit)
            if anyhit:
                return out.astype(jnp.int32)
            return out[0], out[1], jnp.full_like(out[1], -1)
        return call

    monkeypatch.setattr(cuda_bvh, "_ffi_call", fake_ffi)
    monkeypatch.setattr(cuda_bvh, "register", lambda: None)
    cuda_bvh._partitioned_op.cache_clear()
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("pixels",))
    rays = _rays(1024, seed=7)
    tabs = (scene.tris.packed, scene.tris.bvh_child, scene.tris.bvh_boxes)
    pix = NamedSharding(mesh, P("pixels"))
    rep = NamedSharding(mesh, P())
    try:
        def f(ro, rd, tmin, tmax, *tabs_):
            return cuda_bvh.traverse(ro, rd, tmin, tmax, *tabs_, tcl)

        jf = jax.jit(f, in_shardings=(pix, pix, pix, pix, rep, rep, rep))
        t, idx = jf(*rays, *tabs)
        hlo = jf.lower(*rays, *tabs).compile().as_text()
    finally:
        cuda_bvh._partitioned_op.cache_clear()
    want_t, want_i = walk(*rays, *tabs, tcl)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(want_i))
    np.testing.assert_array_equal(np.asarray(t), np.asarray(want_t))
    assert t.sharding.spec == P("pixels")
    assert "all-gather" not in hlo


@pytest.mark.parametrize("scene_name", ["mesh_env", "instanced"])
def test_traversal_parity_on_cpu(scene_name):
    """validate.traversal_parity (what chip_smoke.py runs at 1080p on the
    card) holds for the CPU route at a small film."""
    from pathlib import Path

    from pupiloptixlab_tpu.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu.scene import load_scene
    from pupiloptixlab_tpu.validate import generated_scene, traversal_parity

    path = (Path(__file__).resolve().parent.parent / "data" / "mesh_env.xml"
            if scene_name == "mesh_env"
            else generated_scene("instanced", 50, 8, 64))
    scene = load_scene(path)
    scene.sensor.film.w, scene.sensor.film.h = 48, 32
    data, config = flatten_scene(scene)
    res = traversal_parity(data, config, camera_block_from_scene(scene))
    assert res["primary"]["hits"] > 0 and res["bounce"]["hits"] > 0
    assert all(r["violations"] == 0 for r in res.values())


def test_parity_explains_only_edge_and_grazing_hits():
    """The parity check forgives a disagreement only where float32 can
    cause it: a hit on a triangle's edge, or a distance within the
    grazing-angle error bound — never an interior hit."""
    from pupiloptixlab_tpu.validate import PARITY_RTOL, _explained

    # one unit right triangle in the z = 0 plane, rays straight down -z
    packed = np.zeros((1, 12), np.float32)
    packed[0, 3:6] = (1, 0, 0)
    packed[0, 6:9] = (0, 1, 0)
    scene = SimpleNamespace(tris=SimpleNamespace(packed=packed))
    config = SimpleNamespace(instanced=False)
    xy = np.array([[0.25, 0.25],      # interior
                   [0.5, 0.5],        # on the hypotenuse
                   [0.3, 0.0],        # on the x-axis edge
                   [0.25, 0.25]],     # interior, distance just off by 1e-7
                  np.float32)
    n = len(xy)
    ro = Vec3(jnp.asarray(xy[:, 0]), jnp.asarray(xy[:, 1]),
              jnp.full(n, 2.0, jnp.float32))
    rd = Vec3(jnp.zeros(n), jnp.zeros(n), -jnp.ones(n))
    lanes = np.arange(n)
    t32 = np.array([2.0, 2.0, 2.0, 2.0], np.float32)
    tmin, tmax = np.full(n, 1e-3), np.full(n, 1e16)
    ok = _explained(scene, config, ro, rd, lanes, np.zeros(n, int),
                    np.zeros(n, int), t32, tmin, tmax)
    np.testing.assert_array_equal(ok, [False, True, True, False])
    # the same interior hit, reported at two distances closer than the
    # rounding bound, is explained; farther apart it is not
    other = np.array([np.inf, np.inf, np.inf, 2.0 + 0.1 * PARITY_RTOL])
    ok = _explained(scene, config, ro, rd, lanes, np.zeros(n, int),
                    np.zeros(n, int), t32, tmin, tmax, other=other)
    assert ok[3] and not ok[0]
