"""Native (C++) host runtime vs the numpy specification.

native/pupil_native.cpp implements the SAH BVH builder and OBJ parser
behind ctypes (the reference's host runtime is C++; ours keeps these
host hot paths native with the numpy code as the spec + fallback).
"""

import os
from pathlib import Path

import numpy as np
import pytest

from pupiloptixlab_tpu import native
from pupiloptixlab_tpu.accel.bvh import build_bvh, max_stack_depth
from pupiloptixlab_tpu.accel.traverse import STACK_SIZE

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def _soup(r, t, tcl):
    t_pad = ((t + tcl - 1) // tcl) * tcl
    p0 = np.zeros((t_pad, 3), np.float32)
    p1 = np.zeros_like(p0)
    p2 = np.zeros_like(p0)
    p0[:t] = r.rand(t, 3).astype(np.float32) * 4 - 2
    p1[:t] = p0[:t] + (r.rand(t, 3).astype(np.float32) - 0.5) * 0.4
    p2[:t] = p0[:t] + (r.rand(t, 3).astype(np.float32) - 0.5) * 0.4
    return p0, p1, p2, t_pad


def test_native_bvh_invariants_and_traversal():
    r = np.random.RandomState(4)
    tcl = 16
    p0, p1, p2, t_pad = _soup(r, 3000, tcl)
    bvh = native.build_bvh8_native(p0, p1, p2, 3000, tcl)
    assert bvh is not None

    # same invariants as the numpy builder
    assert np.array_equal(np.sort(bvh.order), np.arange(t_pad))
    ids = bvh.child.reshape(-1, 8)
    boxes = bvh.boxes.reshape(-1, 8, 8)
    empty = boxes[..., 0] >= 1e30
    leaf_starts = -(ids[(ids < 0) & ~empty]) - 1
    assert np.array_equal(np.sort(leaf_starts), np.arange(0, t_pad, tcl))
    assert max_stack_depth(bvh.child) < STACK_SIZE

    # traversal parity: native tree and numpy tree must yield identical
    # closest hits on the same rays (trees may differ in layout)
    os.environ["PUPIL_NO_NATIVE"] = "1"
    try:
        native._tried = False
        native._lib = None
        ref = build_bvh(p0, p1, p2, 3000, tcl)
    finally:
        del os.environ["PUPIL_NO_NATIVE"]
        native._tried = False
        native._lib = None

    import jax.numpy as jnp
    from pupiloptixlab_tpu.accel.traverse import MAX_DISTANCE, walk
    from pupiloptixlab_tpu.render.vec import Vec3

    n = 1024
    ro = np.zeros((n, 3), np.float32)
    ro[:, 2] = -4.0
    rd = r.rand(n, 3).astype(np.float32) - 0.5
    rd[:, 2] += 1.2
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, MAX_DISTANCE, np.float32)
    args = (Vec3(*(jnp.asarray(ro[:, k]) for k in range(3))),
            Vec3(*(jnp.asarray(rd[:, k]) for k in range(3))),
            jnp.asarray(tmin), jnp.asarray(tmax))

    hits = {}
    for name, b in (("native", bvh), ("numpy", ref)):
        packed = np.concatenate(
            [p0[b.order], (p1 - p0)[b.order], (p2 - p0)[b.order],
             np.zeros((t_pad, 3), np.float32)], 1)
        t, i = walk(
            *args, jnp.asarray(packed), jnp.asarray(b.child),
            jnp.asarray(b.boxes), tcl,
        )
        i = np.asarray(i)
        # map permuted winner index back to the original row id
        orig = np.where(i >= 0, b.order[np.maximum(i, 0)], -1)
        hits[name] = (np.asarray(t), orig)

    np.testing.assert_array_equal(hits["native"][1], hits["numpy"][1])
    hm = hits["numpy"][1] >= 0
    assert hm.any()
    np.testing.assert_allclose(
        hits["native"][0][hm], hits["numpy"][0][hm], rtol=3e-5, atol=1e-5
    )


def test_native_obj_matches_python(tmp_path):
    obj = tmp_path / "mesh.obj"
    obj.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "vn 0 0 1\n"
        "f 1/1/1 2/2/1 3/3/1 4/4/1\n"   # quad -> fan
        "f -4/-4/-1 -2/-2/-1 -1/-1/-1\n"  # negative indices
    )
    from pupiloptixlab_tpu.scene.shapes import load_obj

    mesh_native = load_obj(obj)

    os.environ["PUPIL_NO_NATIVE"] = "1"
    try:
        native._tried = False
        native._lib = None
        mesh_py = load_obj(obj)
    finally:
        del os.environ["PUPIL_NO_NATIVE"]
        native._tried = False
        native._lib = None

    np.testing.assert_allclose(mesh_native.positions, mesh_py.positions)
    np.testing.assert_allclose(mesh_native.texcoords, mesh_py.texcoords)
    np.testing.assert_allclose(mesh_native.normals, mesh_py.normals)
    np.testing.assert_array_equal(mesh_native.indices, mesh_py.indices)


def test_native_obj_on_real_mesh():
    from pupiloptixlab_tpu.scene.shapes import load_obj

    path = str(Path(__file__).resolve().parent.parent / "data" / "meshes" / "icosphere.obj")
    mesh_native = load_obj(path)
    os.environ["PUPIL_NO_NATIVE"] = "1"
    try:
        native._tried = False
        native._lib = None
        mesh_py = load_obj(path)
    finally:
        del os.environ["PUPIL_NO_NATIVE"]
        native._tried = False
        native._lib = None
    np.testing.assert_allclose(mesh_native.positions, mesh_py.positions)
    np.testing.assert_array_equal(mesh_native.indices, mesh_py.indices)
    if mesh_py.normals is not None:
        np.testing.assert_allclose(mesh_native.normals, mesh_py.normals)
