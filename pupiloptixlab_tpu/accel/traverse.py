"""Per-ray BVH traversal of the 8-wide tree (accel/bvh.py layout).

The optixTrace analog (reference: example/path_tracer/main.cu:77-82).
Every ray walks the tree on its own short stack, nearest child first:

* ``route="cuda"`` — one GPU thread per ray (native/bvh_traverse.cu,
  called through ``jax.ffi``; accel/cuda_bvh.py builds and binds it);
* ``route="walk"`` — the same walk in plain JAX: a ``lax.while_loop``
  in which every live lane pops one stack entry per iteration, tests
  the 8 child boxes of a node or the ``tcl`` triangles of a leaf, and
  pushes its hit children far-to-near. It is the CPU path and the
  reference the CUDA kernel is tested against.

Both routes return the same thing for the same tables:
``closest`` -> (t, idx) or, instanced, (t, idx, leaf) with idx = -1 on
a miss; ``anyhit`` -> (N,) bool. Instanced trees (flatten/instanced.py)
carry world leaves whose rows ``[leaf_start[l], +tcl)`` are tested in
the object space of instance ``leaf_inst[l]`` (the ray is transformed
by ``inst_w2o`` and not renormalized, so t stays the world parameter).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pupiloptixlab_tpu.render.sampling import MAX_DISTANCE
from pupiloptixlab_tpu.render.vec import Vec3

_DET_EPS = 1e-12
# Per-ray stack entries. Nearest-first pushing of an 8-wide tree keeps
# at most 7 * depth + 1 entries live; accel/bvh.py refuses trees whose
# bound exceeds this (see bvh.max_stack_depth).
STACK_SIZE = 64


def traversal_route(backend: str) -> str:
    """The traversal that runs on ``backend``: the CUDA kernel on GPUs,
    the plain-JAX walk everywhere else."""
    return "cuda" if backend == "gpu" else "walk"


def _safe_inv(d):
    return jnp.where(d < 0, -1.0, 1.0) / jnp.maximum(jnp.abs(d), 1e-12)


def _instance_ray(ro: Vec3, rd: Vec3, w):
    """World ray -> object space of the (N, 12) row-major 3x4 ``w``."""
    def row(k, v, translate):
        out = w[:, k] * v.x + w[:, k + 1] * v.y + w[:, k + 2] * v.z
        return out + w[:, k + 3] if translate else out

    return (
        Vec3(row(0, ro, True), row(4, ro, True), row(8, ro, True)),
        Vec3(row(0, rd, False), row(4, rd, False), row(8, rd, False)),
    )


def _leaf_t(rows, o: Vec3, d: Vec3, tmin, tmax):
    """Moller-Trumbore of (N, tcl, 12) rows against (N,) rays; misses
    at MAX_DISTANCE, shape (N, tcl)."""
    def col(i):
        return rows[:, :, i]

    p0 = Vec3(col(0), col(1), col(2))
    e1 = Vec3(col(3), col(4), col(5))
    e2 = Vec3(col(6), col(7), col(8))
    ob = Vec3(o.x[:, None], o.y[:, None], o.z[:, None])
    db = Vec3(d.x[:, None], d.y[:, None], d.z[:, None])
    pvec = db.cross(e2)
    det = e1.dot(pvec)
    inv = 1.0 / jnp.where(jnp.abs(det) < _DET_EPS, _DET_EPS, det)
    tvec = ob - p0
    u = tvec.dot(pvec) * inv
    qvec = tvec.cross(e1)
    v = db.dot(qvec) * inv
    t = e2.dot(qvec) * inv
    ok = (
        (jnp.abs(det) >= _DET_EPS)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > tmin[:, None]) & (t < tmax[:, None])
    )
    return jnp.where(ok, t, MAX_DISTANCE)


def walk(
    ro: Vec3, rd: Vec3, tmin, tmax, tri, child, boxes, tcl: int,
    anyhit: bool = False, instanced: bool = False,
    leaf_start=None, leaf_inst=None, inst_w2o=None,
):
    """Plain-JAX per-lane stack walk (see the module docstring)."""
    n = ro.x.shape[0]
    ids8 = child.reshape(-1, 8)
    box8 = boxes.reshape(-1, 8, 8)
    inv = Vec3(_safe_inv(rd.x), _safe_inv(rd.y), _safe_inv(rd.z))
    lane = jnp.arange(n)
    slots = jnp.arange(8, dtype=jnp.int32)[None, :]
    rows_k = jnp.arange(tcl, dtype=jnp.int32)[None, :]

    live = tmax > tmin
    stack = jnp.zeros((n, STACK_SIZE), jnp.int32)        # root = node 0
    stack_t = jnp.zeros((n, STACK_SIZE), jnp.float32).at[:, 0].set(tmin)
    init = (
        stack, stack_t, live.astype(jnp.int32),
        tmax,                                # best t (clips the walk)
        jnp.full(n, -1, jnp.int32),          # best row
        jnp.full(n, -1, jnp.int32),          # best world leaf
        jnp.zeros(n, bool),                  # occluded (any-hit)
    )

    def cond(c):
        return jnp.any(c[2] > 0)

    def body(c):
        stack, stack_t, sp, best_t, best_i, best_l, occ = c
        has = sp > 0
        top = jnp.maximum(sp - 1, 0)
        entry = stack[lane, top]
        entry_t = stack_t[lane, top]
        sp = sp - has.astype(jnp.int32)
        go = has & (entry_t < best_t)
        is_node = go & (entry >= 0)
        is_leaf = go & (entry < 0)

        # internal node: slab-test the 8 children, push hits far-to-near
        node = jnp.where(is_node, entry, 0)
        b = box8[node]
        ox, oy, oz = ro.x[:, None], ro.y[:, None], ro.z[:, None]
        tx0 = (b[:, :, 0] - ox) * inv.x[:, None]
        ty0 = (b[:, :, 1] - oy) * inv.y[:, None]
        tz0 = (b[:, :, 2] - oz) * inv.z[:, None]
        tx1 = (b[:, :, 3] - ox) * inv.x[:, None]
        ty1 = (b[:, :, 4] - oy) * inv.y[:, None]
        tz1 = (b[:, :, 5] - oz) * inv.z[:, None]
        tn = jnp.maximum(
            jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
            jnp.maximum(jnp.minimum(tz0, tz1), tmin[:, None]),
        )
        tf = jnp.minimum(
            jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
            jnp.minimum(jnp.maximum(tz0, tz1), best_t[:, None]),
        )
        hit = (tn <= tf) & is_node[:, None]
        order = jnp.argsort(jnp.where(hit, -tn, jnp.inf), axis=1)
        kid = jnp.take_along_axis(ids8[node], order, axis=1)
        kid_t = jnp.take_along_axis(tn, order, axis=1)
        k = hit.sum(axis=1, dtype=jnp.int32)
        dst = jnp.where(slots < k[:, None], sp[:, None] + slots, STACK_SIZE)
        stack = stack.at[lane[:, None], dst].set(kid, mode="drop")
        stack_t = stack_t.at[lane[:, None], dst].set(kid_t, mode="drop")
        sp = sp + k

        # leaf: Moller-Trumbore over its tcl rows
        leaf = jnp.where(is_leaf, -entry - 1, 0)
        o, d = ro, rd
        if instanced:
            start = leaf_start[leaf]
            o, d = _instance_ray(ro, rd, inst_w2o[leaf_inst[leaf]])
        else:
            start = leaf
        t = _leaf_t(tri[start[:, None] + rows_k], o, d, tmin, best_t)
        if anyhit:
            hit_l = is_leaf & jnp.any(t < MAX_DISTANCE, axis=1)
            occ = occ | hit_l
            sp = jnp.where(hit_l, 0, sp)
        else:
            j = jnp.argmin(t, axis=1)
            tj = t[lane, j]
            better = is_leaf & (tj < best_t)
            best_t = jnp.where(better, tj, best_t)
            best_i = jnp.where(better, start + j.astype(jnp.int32), best_i)
            best_l = jnp.where(better, leaf, best_l)
        return stack, stack_t, sp, best_t, best_i, best_l, occ

    _, _, _, best_t, best_i, best_l, occ = jax.lax.while_loop(cond, body, init)
    if anyhit:
        return occ
    best_t = jnp.where(best_i >= 0, best_t, MAX_DISTANCE)
    return (best_t, best_i, best_l) if instanced else (best_t, best_i)


def traverse(
    route: str, ro: Vec3, rd: Vec3, tmin, tmax, tri, child, boxes, tcl: int,
    anyhit: bool = False, instanced: bool = False,
    leaf_start=None, leaf_inst=None, inst_w2o=None,
):
    """Run the traversal on ``route`` ("cuda" or "walk")."""
    if route == "walk":
        return walk(
            ro, rd, tmin, tmax, tri, child, boxes, tcl, anyhit, instanced,
            leaf_start, leaf_inst, inst_w2o,
        )
    if route != "cuda":
        raise ValueError(f"unknown traversal route {route!r}")
    from pupiloptixlab_tpu.accel import cuda_bvh

    return cuda_bvh.traverse(
        ro, rd, tmin, tmax, tri, child, boxes, tcl, anyhit, instanced,
        leaf_start, leaf_inst, inst_w2o,
    )
