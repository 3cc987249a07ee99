"""Device-side scene refit: the IAS-refit / instance layer analog.

Reference behavior: a transform edit refits the TLAS in place
(world/ias_manager.cpp:116-151, OPTIX_BUILD_OPERATION_UPDATE) and
resets the touched area emitters (world/emitter.cpp ResetAreaEmitter) —
O(instance) work. Round 1 instead re-flattened the whole scene on the
host (O(scene), ~100 ms at 20k tris, plus a full re-upload).

This module makes edits device-resident:

* ``build_refit_data`` (called once per scene load inside flatten)
  captures UNIQUE object-space triangle rows (instanced geometry is
  stored once), the per-row (unique_row, instance) mapping in final
  BVH order, and the static emitter/topology metadata;
* ``refit_scene`` is a jitted pure function from (per-instance 3x4
  transforms, normal matrices, visibility) to a fresh SceneData with
  the same array shapes: world-space rows are regenerated by batched
  matmuls, leaf/internal BVH boxes are refit bottom-up through a fixed
  number of passes (topology is static — exactly OptiX refit
  semantics, including the degraded box quality after large moves),
  and area-emitter rows + selection CDFs
  are rebuilt from the moved geometry.

A transform edit therefore uploads O(instances) bytes (the transforms)
and runs one cached executable; RenderConfig and every array shape stay
identical, so the frame program never retraces.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pupiloptixlab_tpu.flatten.types import (
    EM_AREA,
    EM_COLS,
    EM_ETYPE,
    EM_RAD_TEX,
    EM_RADIUS,
    EM_SELECT_PROB,
    EM_V0N,
    EM_V0P,
    EM_V0T,
    EM_V1N,
    EM_V1P,
    EM_V1T,
    EM_V2N,
    EM_V2P,
    EM_V2T,
    TRI_N0,
    TRI_N1,
    TRI_N2,
    SceneData,
)


@dataclass
class RefitData:
    """Static (per-scene-topology) refit inputs. Host-side container."""

    # unique object-space geometry: (U, 18) [p0 e1 e2 n0 n1 n2]
    unique_rows: np.ndarray
    u_row: np.ndarray       # (T,) i32 row into unique_rows (BVH order)
    tri_inst: np.ndarray    # (T,) i32 instance id per row (BVH order)
    tri_valid: np.ndarray   # (T,) bool
    flip_sign: np.ndarray   # (I,) f32 +-1 (flip_normals per instance)
    # BVH slot topology (static): kind 0=empty 1=leaf 2=internal
    slot_kind: np.ndarray   # (M*8,) i32
    slot_ref: np.ndarray    # (M*8,) i32 leaf index or child node id
    depth: int              # bottom-up refit passes needed
    tcl: int
    # emitters
    em_tri_row: np.ndarray     # (E,) i32 tri row for tri-area emitters, -1 else
    em_sphere_inst: np.ndarray  # (E,) i32 instance id for sphere emitters, -1
    em_base_weight: np.ndarray  # (E,) f32 max-channel(radiance) factors
    n_area: int
    emitter_num: int           # n_area + (1 if env)
    # spheres
    sphere_inst: np.ndarray    # (S,) i32 instance id per sphere row, -1 pad
    # instance bookkeeping
    n_instances: int
    instance_names: list


@dataclass
class InstRefitData:
    """Static refit inputs for INSTANCED scenes (flatten/instanced.py).

    Object-space geometry never moves under a transform edit, so the
    refit is exactly the OptiX IAS-update shape
    (world/ias_manager.cpp:116-151): recompute per-instance matrices,
    re-derive world leaf AABBs from the static object leaf AABBs, and
    refit the world box tree bottom-up with frozen topology. O(leaves)
    host work (leaf count is capped at ~12k), O(instances) upload.
    Scope: mesh-only non-emissive scenes — flatten keeps the baked
    RefitData path otherwise (it must rebuild emitter rows too)."""

    obj_leaf_lo: np.ndarray   # (L, 3) object-space leaf boxes, BVH order
    obj_leaf_hi: np.ndarray   # (L, 3)
    leaf_inst: np.ndarray     # (L,) i32 instance id per leaf
    child: np.ndarray         # (M*8,) i32 world-tree topology (frozen)
    inst_packed: np.ndarray   # (I, INST_COLS) f32 baseline shading rows
    mesh_scene_idx: np.ndarray  # (I,) i32 scene.shape_instances index
    n_instances: int
    instance_names: list

_NEVER = np.float32(1e30)


def refit_instanced(scene_data: SceneData, refit: InstRefitData, scene):
    """Instanced-scene transform/visibility refit; returns a SceneData
    with identical shapes (no retrace). See InstRefitData."""
    from pupiloptixlab_tpu.flatten.types import INST_NRM

    n_inst = refit.mesh_scene_idx.shape[0]
    o2w = np.zeros((n_inst, 3, 4), np.float64)
    w2o = np.zeros((n_inst, 12), np.float32)
    inst_packed = refit.inst_packed.copy()
    hidden = np.zeros(n_inst, bool)
    for i, si in enumerate(refit.mesh_scene_idx):
        ins = scene.shape_instances[int(si)]
        m = np.asarray(ins.transform.matrix, np.float64)
        o2w[i] = m[:3, :4]
        hidden[i] = getattr(ins, "visibility_mask", 255) == 0
        flip = -1.0 if getattr(ins, "flip_normals", False) else 1.0
        try:
            w2o[i] = np.linalg.inv(m)[:3, :4].reshape(-1).astype(np.float32)
            nrm = (np.linalg.inv(m[:3, :3]).T * flip).astype(np.float32)
        except np.linalg.LinAlgError:
            # singular transform: zero-volume instance -> treat as hidden
            # (rays cannot be mapped into its object space)
            hidden[i] = True
            nrm = np.zeros((3, 3), np.float32)
        if hidden[i]:
            w2o[i] = 0.0  # degenerate ray transform: see instanced.py
        inst_packed[i, INST_NRM] = nrm.reshape(-1)

    # world leaf boxes: 8 object corners through each leaf's instance
    lo, hi = refit.obj_leaf_lo, refit.obj_leaf_hi
    L = lo.shape[0]
    sel = np.array(
        [[(k >> a) & 1 for a in range(3)] for k in range(8)], bool
    )  # (8, 3)
    corners = np.where(sel[None], hi[:, None, :], lo[:, None, :])  # (L,8,3)
    mats = o2w[refit.leaf_inst]  # (L, 3, 4)
    wc = np.einsum("lkj,lij->lki", corners, mats[:, :, :3]) + mats[:, None, :, 3]
    lo_w = wc.min(axis=1).astype(np.float32)
    hi_w = wc.max(axis=1).astype(np.float32)
    dead = (lo[:, 0] > hi[:, 0]) | hidden[refit.leaf_inst]
    lo_w[dead] = _NEVER
    hi_w[dead] = _NEVER  # matches the builder's never-box convention

    # bottom-up box refit: children were emitted after their parents
    # (accel/bvh.py make_node), so a reverse pass sees every child first
    child = refit.child.reshape(-1, 8)
    m_nodes = child.shape[0]
    boxes = np.asarray(scene_data.tris.bvh_boxes).copy()
    node_lo = np.zeros((m_nodes, 3), np.float32)
    node_hi = np.zeros((m_nodes, 3), np.float32)
    for nid in range(m_nodes - 1, -1, -1):
        t_lo = np.full(3, 1e30, np.float32)
        t_hi = np.full(3, -1e30, np.float32)
        for k in range(8):
            cid = child[nid, k]
            if cid < 0:
                b_lo, b_hi = lo_w[-cid - 1], hi_w[-cid - 1]
            elif cid == 0:  # empty slot (the root is never a child)
                continue
            else:
                b_lo, b_hi = node_lo[cid], node_hi[cid]
            boxes[nid * 8 + k, 0:3] = b_lo
            boxes[nid * 8 + k, 3:6] = b_hi
            if b_hi[0] < 1e30:
                t_lo = np.minimum(t_lo, b_lo)
                t_hi = np.maximum(t_hi, b_hi)
        if t_lo[0] > t_hi[0]:
            t_lo = np.full(3, _NEVER, np.float32)
            t_hi = np.full(3, _NEVER, np.float32)
        node_lo[nid] = t_lo
        node_hi[nid] = t_hi

    tris = replace(
        scene_data.tris,
        inst_w2o=jnp.asarray(w2o),
        inst_packed=jnp.asarray(inst_packed),
        bvh_boxes=jnp.asarray(boxes),
    )
    return replace(scene_data, tris=tris)


def _world_transforms(scene) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(I,3,4) transforms, (I,3,3) normal matrices, (I,) visibility."""
    xs, ns, vis = [], [], []
    for ins in scene.shape_instances:
        m = np.asarray(ins.transform.matrix, np.float32)
        xs.append(m[:3, :4])
        ns.append(np.linalg.inv(m[:3, :3]).T.astype(np.float32))
        vis.append(0.0 if getattr(ins, "visibility_mask", 255) == 0 else 1.0)
    if not xs:
        return (
            np.zeros((1, 3, 4), np.float32),
            np.zeros((1, 3, 3), np.float32),
            np.zeros(1, np.float32),
        )
    return np.stack(xs), np.stack(ns), np.asarray(vis, np.float32)


@partial(
    jax.jit,
    static_argnames=("tcl", "depth", "n_area", "emitter_num"),
)
def _refit_device(
    scene_data: SceneData,
    unique_rows: jnp.ndarray,
    u_row: jnp.ndarray,
    tri_inst: jnp.ndarray,
    tri_valid: jnp.ndarray,
    slot_kind: jnp.ndarray,
    slot_ref: jnp.ndarray,
    em_tri_row: jnp.ndarray,
    em_base_weight: jnp.ndarray,
    em_sphere_rows: jnp.ndarray,   # (E, 6) center(3), radius, area, weight
    flip_sign: jnp.ndarray,        # (I,) +-1
    xf: jnp.ndarray,               # (I, 3, 4)
    nxf: jnp.ndarray,              # (I, 3, 3)
    visible: jnp.ndarray,          # (I,)
    sph_attrs: jnp.ndarray,        # (S, SPH_COLS) host-recomputed
    sph_o2w: jnp.ndarray,
    sph_w2o: jnp.ndarray,
    tcl: int,
    depth: int,
    n_area: int,
    emitter_num: int,
) -> SceneData:
    tris = scene_data.tris
    t_pad = tris.packed.shape[0]

    rows = unique_rows[u_row]            # (T, 18) native gather
    a = xf[tri_inst]                     # (T, 3, 4)
    nmat = nxf[tri_inst]                 # (T, 3, 3)
    vis = visible[tri_inst][:, None]     # (T, 1)
    # batched mat-vecs lower to dot_general, which may run in TF32 on a
    # GPU at default precision; the refit must match a host re-flatten
    def matvec(m, v):
        return jnp.einsum("tij,tj->ti", m, v,
                          precision=jax.lax.Precision.HIGHEST)

    p0 = matvec(a[:, :, :3], rows[:, 0:3]) + a[:, :, 3]
    e1 = matvec(a[:, :, :3], rows[:, 3:6]) * vis
    e2 = matvec(a[:, :, :3], rows[:, 6:9]) * vis

    def xnorm(n):
        w = matvec(nmat, n)
        return w / jnp.maximum(
            jnp.linalg.norm(w, axis=1, keepdims=True), 1e-20
        )

    fs = flip_sign[tri_inst][:, None]
    n0 = xnorm(rows[:, 9:12]) * fs
    n1 = xnorm(rows[:, 12:15]) * fs
    n2 = xnorm(rows[:, 15:18]) * fs

    # padding rows map to (instance 0, unique row 0): zero them so they
    # stay degenerate exactly like the host flatten's padding
    vmask = tri_valid[:, None]
    p0 = jnp.where(vmask, p0, 0.0)
    e1 = jnp.where(vmask, e1, 0.0)
    e2 = jnp.where(vmask, e2, 0.0)
    n0 = jnp.where(vmask, n0, 0.0)
    n1 = jnp.where(vmask, n1, 0.0)
    n2 = jnp.where(vmask, n2, 0.0)

    packed = jnp.concatenate(
        [p0, e1, e2, jnp.zeros((t_pad, 3), jnp.float32)], axis=1
    )
    attrs = tris.attrs
    attrs = attrs.at[:, TRI_N0].set(n0)
    attrs = attrs.at[:, TRI_N1].set(n1)
    attrs = attrs.at[:, TRI_N2].set(n2)
    # keep the barycentric mirror in sync (flatten/types.py TRI_P0)
    attrs = attrs.at[:, 17:26].set(packed[:, 0:9])

    # --- boxes -------------------------------------------------------------
    p1w = p0 + e1
    p2w = p0 + e2
    lo = jnp.minimum(jnp.minimum(p0, p1w), p2w)
    hi = jnp.maximum(jnp.maximum(p0, p1w), p2w)
    lo = jnp.where(tri_valid[:, None], lo, 1e30)
    hi = jnp.where(tri_valid[:, None], hi, -1e30)

    if tris.bvh_child.shape[0] > 8 or depth > 0:
        n_leaves = t_pad // tcl
        leaf_lo = lo.reshape(n_leaves, tcl, 3).min(axis=1)
        leaf_hi = hi.reshape(n_leaves, tcl, 3).max(axis=1)
        # never-boxes for all-padding leaves (see accel/bvh.py)
        empty_leaf = leaf_lo[:, 0] > leaf_hi[:, 0]
        leaf_lo = jnp.where(empty_leaf[:, None], 1e30, leaf_lo)
        leaf_hi = jnp.where(empty_leaf[:, None], 1e30, leaf_hi)

        m8 = slot_kind.shape[0]
        node_lo = jnp.full((m8 // 8, 3), 1e30, jnp.float32)
        node_hi = jnp.full((m8 // 8, 3), 1e30, jnp.float32)
        ref = jnp.maximum(slot_ref, 0)
        for _ in range(depth):
            s_lo = jnp.where(
                (slot_kind == 1)[:, None],
                leaf_lo[ref],
                jnp.where((slot_kind == 2)[:, None], node_lo[ref], 1e30),
            )
            s_hi = jnp.where(
                (slot_kind == 1)[:, None],
                leaf_hi[ref],
                jnp.where((slot_kind == 2)[:, None], node_hi[ref], -1e30),
            )
            grp_lo = s_lo.reshape(-1, 8, 3)
            grp_hi = s_hi.reshape(-1, 8, 3)
            any_real = (grp_lo[:, :, 0] <= grp_hi[:, :, 0]).any(axis=1)
            node_lo = jnp.where(
                any_real[:, None], grp_lo.min(axis=1), 1e30
            )
            node_hi = jnp.where(
                any_real[:, None], grp_hi.max(axis=1), 1e30
            )
        s_lo = jnp.where(
            (slot_kind == 1)[:, None],
            leaf_lo[ref],
            jnp.where((slot_kind == 2)[:, None], node_lo[ref], 1e30),
        )
        s_hi = jnp.where(
            (slot_kind == 1)[:, None],
            leaf_hi[ref],
            jnp.where((slot_kind == 2)[:, None], node_hi[ref], 1e30),
        )
        # degenerate slots become never-hit point boxes at 1e30
        bad = s_lo[:, 0] > s_hi[:, 0]
        s_hi = jnp.where(bad[:, None], 1e30, s_hi)
        s_lo = jnp.where(bad[:, None], 1e30, s_lo)
        bvh_boxes = jnp.concatenate(
            [s_lo, s_hi, jnp.zeros((m8, 2), jnp.float32)], axis=1
        )
    else:
        bvh_boxes = tris.bvh_boxes

    new_tris = replace(
        tris,
        packed=packed,
        attrs=attrs,
        bvh_boxes=bvh_boxes,
    )

    # --- emitters ------------------------------------------------------------
    em = scene_data.emitters
    new_em = em
    if n_area > 0:
        t_e = jnp.maximum(em_tri_row, 0)
        is_tri = em_tri_row >= 0
        v0 = p0[t_e]
        v1 = p1w[t_e]
        v2 = p2w[t_e]
        cr = jnp.cross(v1 - v0, v2 - v0)
        tri_area = 0.5 * jnp.linalg.norm(cr, axis=1)
        tn0 = n0[t_e]
        tn1 = n1[t_e]
        tn2 = n2[t_e]
        tri_w = em_base_weight * tri_area * visible[tri_inst[t_e]]

        area = jnp.where(is_tri, tri_area, em_sphere_rows[:, 4])
        weight = jnp.where(is_tri, tri_w, em_sphere_rows[:, 5])
        radius = jnp.where(is_tri, 0.0, em_sphere_rows[:, 3])
        v0p = jnp.where(is_tri[:, None], v0, em_sphere_rows[:, 0:3])
        keep = em.etype >= 2  # delta lights: static rows
        v0p = jnp.where(keep[:, None], em.v0p, v0p)
        area = jnp.where(keep, em.area, area)
        radius = jnp.where(keep, em.radius, radius)
        weight = jnp.where(keep, em_base_weight, weight)

        wsum = jnp.maximum(weight[:n_area].sum(), 1e-30)
        probs = weight / wsum * (n_area / max(emitter_num, 1))
        probs = jnp.where(keep, probs, probs)  # same formula for all
        select_prob = probs
        select_cdf = jnp.cumsum(select_prob)

        packed_em = em.packed
        packed_em = packed_em.at[:, EM_V0P].set(v0p)
        packed_em = packed_em.at[:, EM_V1P].set(
            jnp.where((is_tri & ~keep)[:, None], v1, em.packed[:, EM_V1P])
        )
        packed_em = packed_em.at[:, EM_V2P].set(
            jnp.where((is_tri & ~keep)[:, None], v2, em.packed[:, EM_V2P])
        )
        packed_em = packed_em.at[:, EM_V0N].set(
            jnp.where((is_tri & ~keep)[:, None], tn0, em.packed[:, EM_V0N])
        )
        packed_em = packed_em.at[:, EM_V1N].set(
            jnp.where((is_tri & ~keep)[:, None], tn1, em.packed[:, EM_V1N])
        )
        packed_em = packed_em.at[:, EM_V2N].set(
            jnp.where((is_tri & ~keep)[:, None], tn2, em.packed[:, EM_V2N])
        )
        packed_em = packed_em.at[:, EM_RADIUS].set(radius)
        packed_em = packed_em.at[:, EM_AREA].set(area)
        packed_em = packed_em.at[:, EM_SELECT_PROB].set(select_prob)

        new_em = replace(
            em,
            packed=packed_em,
            v0p=v0p,
            v1p=jnp.where((is_tri & ~keep)[:, None], v1, em.v1p),
            v2p=jnp.where((is_tri & ~keep)[:, None], v2, em.v2p),
            v0n=jnp.where((is_tri & ~keep)[:, None], tn0, em.v0n),
            v1n=jnp.where((is_tri & ~keep)[:, None], tn1, em.v1n),
            v2n=jnp.where((is_tri & ~keep)[:, None], tn2, em.v2n),
            radius=radius,
            area=area,
            select_prob=select_prob,
            select_cdf=select_cdf,
        )

    new_spheres = replace(
        scene_data.spheres, attrs=sph_attrs, o2w=sph_o2w, w2o=sph_w2o
    )
    return replace(
        scene_data, tris=new_tris, emitters=new_em, spheres=new_spheres
    )


def refit_scene(
    scene_data: SceneData, refit, scene
) -> SceneData:
    """Host entry: recompute per-instance transforms (O(I)), upload them
    and run the cached device refit. Instanced scenes dispatch to
    refit_instanced (object-space tables are static; only matrices and
    boxes move)."""
    if isinstance(refit, InstRefitData):
        return refit_instanced(scene_data, refit, scene)
    xf, nxf, visible = _world_transforms(scene)

    # spheres + sphere emitters are few: recompute their rows on host
    from pupiloptixlab_tpu.flatten.types import SPH_COLS, SPH_EMITTER, SPH_FLIP, SPH_MAT

    s_count = refit.sphere_inst.shape[0]
    sph_attrs = np.asarray(scene_data.spheres.attrs).copy()
    sph_o2w = np.asarray(scene_data.spheres.o2w).copy()
    sph_w2o = np.asarray(scene_data.spheres.w2o).copy()
    e_count = refit.em_tri_row.shape[0]
    em_sphere_rows = np.zeros((max(e_count, 1), 6), np.float32)
    for si in range(s_count):
        inst = int(refit.sphere_inst[si])
        if inst < 0:
            continue
        ins = scene.shape_instances[inst]
        m = np.asarray(ins.transform.matrix, np.float32)
        hidden = getattr(ins, "visibility_mask", 255) == 0
        if hidden:
            sph_o2w[si] = 0.0
            sph_w2o[si] = 0.0
        else:
            sph_o2w[si] = m[:3, :4]
            sph_w2o[si] = np.linalg.inv(m)[:3, :4]
        sph_attrs[si, 0:12] = sph_w2o[si].reshape(12)
        eid = int(np.asarray(scene_data.spheres.emitter_id)[si])
        if eid >= 0:
            c = m[:3, 3]
            p = (m @ np.array([1.0, 0, 0, 1.0], np.float32))[:3]
            radius = float(np.linalg.norm(c - p))
            area = 4.0 * np.pi * radius * radius
            w = 0.0 if hidden else float(refit.em_base_weight[eid]) * area
            em_sphere_rows[eid] = [*c, radius, area, w]

    return _refit_device(
        scene_data,
        jnp.asarray(refit.unique_rows),
        jnp.asarray(refit.u_row),
        jnp.asarray(refit.tri_inst),
        jnp.asarray(refit.tri_valid),
        jnp.asarray(refit.slot_kind),
        jnp.asarray(refit.slot_ref),
        jnp.asarray(refit.em_tri_row),
        jnp.asarray(refit.em_base_weight),
        jnp.asarray(em_sphere_rows),
        jnp.asarray(refit.flip_sign),
        jnp.asarray(xf),
        jnp.asarray(nxf),
        jnp.asarray(visible),
        jnp.asarray(sph_attrs),
        jnp.asarray(sph_o2w),
        jnp.asarray(sph_w2o),
        tcl=refit.tcl,
        depth=refit.depth,
        n_area=refit.n_area,
        emitter_num=refit.emitter_num,
    )
