"""Wide-BVH builder invariants + traversal parity.

The BVH is the GAS/optixTrace analog (reference world/gas_manager.cpp +
example/path_tracer/main.cu:77-82): accel/bvh.py builds 8-wide SAH node
tables at flatten time and accel/traverse.py walks them per ray. The
CPU tests run the plain-JAX walk (the CPU route and the CUDA kernel's
reference) against a numpy brute-force oracle.
"""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest

from pupiloptixlab_tpu.accel.bvh import LEAF_SIZE, build_bvh, max_stack_depth
from pupiloptixlab_tpu.accel.traverse import MAX_DISTANCE, STACK_SIZE, walk
from pupiloptixlab_tpu.render.vec import Vec3

REPO = Path(__file__).resolve().parent.parent


def _random_soup(r, t, tcl):
    t_pad = ((t + tcl - 1) // tcl) * tcl
    p0 = np.zeros((t_pad, 3), np.float32)
    p1 = np.zeros_like(p0)
    p2 = np.zeros_like(p0)
    p0[:t] = r.rand(t, 3).astype(np.float32) * 4 - 2
    p1[:t] = p0[:t] + (r.rand(t, 3).astype(np.float32) - 0.5) * 0.4
    p2[:t] = p0[:t] + (r.rand(t, 3).astype(np.float32) - 0.5) * 0.4
    return p0, p1, p2, t_pad


def _rays(r, n):
    ro = np.zeros((n, 3), np.float32)
    ro[:, 2] = -4.0
    ro += (r.rand(n, 3).astype(np.float32) - 0.5)
    rd = r.rand(n, 3).astype(np.float32) - 0.5
    rd[:, 2] += 1.2
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, MAX_DISTANCE, np.float32)
    return ro, rd, tmin, tmax


def _brute(p0, e1, e2, vmask, ro, rd, tmin, tmax):
    pv = np.cross(rd[:, None, :], e2[None, :, :])
    det = np.einsum("tj,ntj->nt", e1, pv)
    inv = 1.0 / np.where(np.abs(det) < 1e-12, 1e-12, det)
    tv = ro[:, None, :] - p0[None, :, :]
    u = np.einsum("ntj,ntj->nt", tv, pv) * inv
    qv = np.cross(tv, e1[None, :, :])
    v = np.einsum("nj,ntj->nt", rd, qv) * inv
    t = np.einsum("tj,ntj->nt", e2, qv) * inv
    ok = (
        (np.abs(det) >= 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
        & (t > tmin[:, None]) & (t < tmax[:, None]) & vmask[None, :]
    )
    t = np.where(ok, t, MAX_DISTANCE)
    i = t.argmin(1).astype(np.int32)
    tb = t.min(1)
    return tb, np.where(tb < MAX_DISTANCE, i, -1)


def test_builder_invariants():
    r = np.random.RandomState(11)
    tcl = 16
    p0, p1, p2, t_pad = _random_soup(r, 3000, tcl)
    bvh = build_bvh(p0, p1, p2, 3000, tcl)

    # the order is a permutation of all padded rows
    assert np.array_equal(np.sort(bvh.order), np.arange(t_pad))
    ids = bvh.child.reshape(-1, 8)
    boxes = bvh.boxes.reshape(-1, 8, 8)
    assert ids.shape[0] == bvh.n_nodes and boxes.shape[0] == bvh.n_nodes
    # every leaf start is TCL-aligned and leaves tile the row range once
    empty = boxes[..., 0] >= 1e30  # never-hit point boxes
    leaf_starts = -(ids[(ids < 0) & ~empty]) - 1
    assert np.array_equal(np.sort(leaf_starts), np.arange(0, t_pad, tcl))
    # internal child ids point forward (root = node 0)
    internal = (ids > 0) & ~empty
    rows = np.broadcast_to(np.arange(ids.shape[0])[:, None], ids.shape)
    assert (ids[internal] > rows[internal]).all()
    # node boxes contain their leaf triangles
    lo = np.minimum(np.minimum(p0, p1), p2)[bvh.order]
    hi = np.maximum(np.maximum(p0, p1), p2)[bvh.order]
    valid = bvh.order < 3000
    picks = np.random.RandomState(0).choice(bvh.n_nodes, 10)
    for ni in picks:
        for k in range(8):
            cid = ids[ni, k]
            if cid >= 0 or empty[ni, k]:
                continue
            s = -cid - 1
            m = valid[s:s + tcl]
            if m.any():
                assert (boxes[ni, k, 0:3] <= lo[s:s + tcl][m].min(0) + 1e-6).all()
                assert (boxes[ni, k, 3:6] >= hi[s:s + tcl][m].max(0) - 1e-6).all()
    # traversal stack bound
    assert max_stack_depth(bvh.child) < STACK_SIZE


def _vec(a):
    return Vec3(*(jnp.asarray(a[:, k]) for k in range(3)))


def _instance_tables(p0, p1, p2, t_tris, tcl):
    """Three rotated/scaled instances of the soup through the device-
    instancing builder (flatten/instanced.py)."""
    from pupiloptixlab_tpu.flatten.instanced import build_instanced_tables

    n = t_tris
    z2 = np.zeros((n, 2), np.float32)
    nrm = np.tile(np.array([0, 0, 1], np.float32), (n, 1))
    shape = dict(p0=p0[:n], e1=(p1 - p0)[:n], e2=(p2 - p0)[:n],
                 n0=nrm, n1=nrm, n2=nrm, uv0=z2, uv1=z2, uv2=z2)
    metas = []
    for k, (ang, sc, off) in enumerate(
        [(0.0, 1.0, (0, 0, 0)), (0.7, 0.6, (1.5, -0.5, 2.0)),
         (-1.1, 1.3, (-1.0, 1.0, 4.0))]
    ):
        c, s = np.cos(ang), np.sin(ang)
        m = np.eye(4)
        m[:3, :3] = sc * np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        m[:3, 3] = off
        metas.append(dict(key="soup", matrix=m, mat_id=0, emitter_base=-1,
                          flip=False, uv_flip=False, hidden=False))
    return build_instanced_tables({"soup": shape}, metas, tcl0=tcl)


@pytest.mark.parametrize("t_tris", [900, 5000])
@pytest.mark.parametrize("mode", ["flat", "instanced"])
def test_bvh_closest_matches_brute_force(t_tris, mode):
    from types import SimpleNamespace

    from pupiloptixlab_tpu.accel.intersect import _sweep_tris_xla_instanced

    r = np.random.RandomState(5 + t_tris)
    tcl = 16
    p0, p1, p2, t_pad = _random_soup(r, t_tris, tcl)
    n = 1024
    ro, rd, tmin, tmax = _rays(r, n)
    args = (_vec(ro), _vec(rd), jnp.asarray(tmin), jnp.asarray(tmax))
    if mode == "flat":
        bvh = build_bvh(p0, p1, p2, t_tris, tcl)
        o = bvh.order
        p0o, p1o, p2o = p0[o], p1[o], p2[o]
        packed = np.concatenate(
            [p0o, p1o - p0o, p2o - p0o, np.zeros((t_pad, 3), np.float32)], 1
        )
        want_t, want_i = _brute(p0o, p1o - p0o, p2o - p0o, o < t_tris,
                                ro, rd, tmin, tmax)
        tabs = (jnp.asarray(packed), jnp.asarray(bvh.child),
                jnp.asarray(bvh.boxes))
        kw = {}
    else:
        it = _instance_tables(p0, p1, p2, t_tris, tcl)
        tcl = it["tcl"]
        tabs = (jnp.asarray(it["packed"]), jnp.asarray(it["bvh_child"]),
                jnp.asarray(it["bvh_boxes"]))
        kw = dict(instanced=True,
                  leaf_start=jnp.asarray(it["leaf_start"]),
                  leaf_inst=jnp.asarray(it["leaf_inst"]),
                  inst_w2o=jnp.asarray(it["inst_w2o"]))
        scene = SimpleNamespace(tris=SimpleNamespace(packed=tabs[0], **{
            k: kw[k] for k in ("leaf_start", "leaf_inst", "inst_w2o")}))
        t_ref, p_ref, k_ref, _ = _sweep_tris_xla_instanced(
            *args, scene, SimpleNamespace(bvh_tcl=tcl))
        want_t = np.asarray(t_ref)
        want_i = np.where(np.asarray(k_ref) == 0, np.asarray(p_ref), -1)
    got = walk(*args, *tabs, tcl, **kw)
    got_t, got_i = np.asarray(got[0]), np.asarray(got[1])
    hit = want_i >= 0
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_t[hit], want_t[hit], rtol=3e-5, atol=1e-5)

    occ = np.asarray(walk(*args, *tabs, tcl, anyhit=True, **kw))
    np.testing.assert_array_equal(occ, hit)


def test_anyhit_respects_tmax():
    """Occlusion must test only (tmin, tmax) — a hit beyond the light
    distance is NOT occlusion (render/emitter.h:91-100 semantics)."""
    r = np.random.RandomState(2)
    tcl = 16
    # a 2k-tri wall at z=2 (big enough that flatten would use the BVH)
    t = 2048
    p0 = np.zeros((t, 3), np.float32)
    g = np.stack(np.meshgrid(np.arange(64), np.arange(32)), -1).reshape(-1, 2)
    p0[:, 0] = g[:, 0] * 0.25 - 8.0
    p0[:, 1] = g[:, 1] * 0.25 - 4.0
    p0[:, 2] = 2.0
    p1 = p0 + np.array([0.3, 0, 0], np.float32)
    p2 = p0 + np.array([0, 0.3, 0], np.float32)
    bvh = build_bvh(p0, p1, p2, t, tcl)
    o = bvh.order
    packed = np.concatenate(
        [p0[o], (p1 - p0)[o], (p2 - p0)[o], np.zeros((t, 3), np.float32)], 1
    )
    n = 1024
    ro = np.zeros((n, 3), np.float32)
    rd = np.zeros((n, 3), np.float32)
    rd[:, 2] = 1.0
    tmin = np.full(n, 1e-3, np.float32)
    near = np.full(n, 1.0, np.float32)   # light closer than the wall
    far = np.full(n, 10.0, np.float32)   # light beyond the wall
    tabs = (jnp.asarray(packed), jnp.asarray(bvh.child),
            jnp.asarray(bvh.boxes))

    def occ(tmx):
        return np.asarray(walk(_vec(ro), _vec(rd), jnp.asarray(tmin),
                               jnp.asarray(tmx), *tabs, tcl, anyhit=True))

    occ_near = occ(near)
    occ_far = occ(far)
    assert not occ_near.any()
    assert occ_far.all()


def test_flatten_builds_bvh_for_mesh_scene():
    from pupiloptixlab_tpu.flatten import flatten_scene
    from pupiloptixlab_tpu.scene import load_scene

    scene = load_scene(REPO / "data" / "mesh_env.xml")
    scene.sensor.film.w, scene.sensor.film.h = 64, 64
    data, config = flatten_scene(scene)
    assert config.bvh_nodes > 0 and config.bvh_tcl == LEAF_SIZE
    assert data.tris.bvh_child.shape[0] == config.bvh_nodes * 8
    assert data.tris.bvh_boxes.shape == (config.bvh_nodes * 8, 8)
    # the root's children boxes must jointly contain the whole soup
    boxes = np.asarray(data.tris.bvh_boxes).reshape(-1, 8, 8)
    root_lo = boxes[0, :, 0:3].min(0)
    root_hi = boxes[0, :, 3:6].max(0)
    packed = np.asarray(data.tris.packed)
    p0 = packed[:, 0:3]
    e1 = packed[:, 3:6]
    e2 = packed[:, 6:9]
    nz = (np.abs(e1).sum(1) + np.abs(e2).sum(1)) > 0
    pts = np.concatenate([p0[nz], (p0 + e1)[nz], (p0 + e2)[nz]], 0)
    assert (root_lo <= pts.min(0) + 1e-4).all()
    assert (root_hi >= pts.max(0) - 1e-4).all()
