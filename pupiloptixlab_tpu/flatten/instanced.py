"""Device-side instancing: deduplicated object-space geometry + a world
BVH whose leaves carry (unique-row start, instance id).

The GAS-reuse half of the reference's two-level accel: BLASes are cached
per shape and shared by every instance (world/gas_manager.cpp:10-27)
while the TLAS carries per-instance 3x4 transforms
(world/ias_manager.cpp:165-185). This design avoids a two-phase
TLAS/BLAS traversal (a second nested stack): ONE 8-wide world tree is
built over every instance's shape-leaf AABBs, and the traversal
transforms the ray into object space per leaf (rays are NOT
renormalized, so the hit parameter t stays in world units). Device
memory: triangle/attr tables are O(unique rows); per-instance cost is
leaf boxes + one 3x4 matrix.

Scaling limits: the world tree is built by the numpy builder at one
box per leaf, so the world leaf count is capped (~12k) by growing the
leaf size. The binding cap is world LEAVES, not unique rows: e.g. a
handful of instances of a 100k+-tri mesh keeps only the unique rows in
device memory.
"""

from __future__ import annotations

import numpy as np

_MAX_LEAVES = 12000
_NEVER = 1e30


def morton_order_faces(c: np.ndarray) -> np.ndarray:
    """Centroid Morton order (same 10-bit spread as the world flatten)."""
    lo = c.min(axis=0)
    hi = c.max(axis=0)
    q = ((c - lo) / np.maximum(hi - lo, 1e-12) * 1023.0).astype(np.uint32)
    q = np.clip(q, 0, 1023)

    def expand(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    code = (expand(q[:, 0]) << 2) | (expand(q[:, 1]) << 1) | expand(q[:, 2])
    return np.argsort(code, kind="stable")


def build_instanced_tables(shape_store: dict, inst_meta: list, tcl0: int = 32):
    """shape_store: key -> dict(p0, e1, e2 (nf,3), n0, n1, n2 (nf,3),
    uv0, uv1, uv2 (nf,2)); inst_meta: per mesh instance dicts with
    (key, matrix (4,4), mat_id, emitter_base, flip, uv_flip, hidden).

    Returns dict(packed, attrs, leaf_start, leaf_inst, inst_w2o,
    inst_packed, bvh_child, bvh_boxes, bvh_nodes, tcl,
    tri_count_padded) with numpy arrays, or None when the scene exceeds
    the instanced-mode limits."""
    from pupiloptixlab_tpu.accel.bvh import build_bvh
    from pupiloptixlab_tpu.flatten.types import (
        INST_COLS, INST_EMIT_BASE, INST_MAT, INST_NRM, INST_W2O0,
        TRI_ATTR_COLS, TRI_EMITTER, TRI_N0, TRI_N1, TRI_N2,
        TRI_UV0, TRI_UV1, TRI_UV2,
    )

    total_rows = sum(shape_store[m["key"]]["p0"].shape[0] for m in inst_meta)
    tcl = tcl0
    while True:
        n_leaves = sum(
            -(-shape_store[m["key"]]["p0"].shape[0] // tcl) for m in inst_meta
        )
        if n_leaves <= _MAX_LEAVES:
            break
        tcl *= 2
        if tcl > 512:
            return None  # too many world leaves: keep the baked path

    # -- unique object-space blocks (Morton-ordered, tcl-padded) ----------
    shape_base: dict[str, int] = {}
    shape_leaf_boxes: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    packed_rows, attr_rows = [], []
    base = 0
    for key, s in shape_store.items():
        nf = s["p0"].shape[0]
        cent = s["p0"] + (s["e1"] + s["e2"]) / 3.0
        order = morton_order_faces(cent)
        nf_pad = -(-nf // tcl) * tcl
        pk = np.zeros((nf_pad, 12), np.float32)
        pk[:nf, 0:3] = s["p0"][order]
        pk[:nf, 3:6] = s["e1"][order]
        pk[:nf, 6:9] = s["e2"][order]
        at = np.zeros((nf_pad, TRI_ATTR_COLS), np.float32)
        at[:nf, TRI_N0] = s["n0"][order]
        at[:nf, TRI_N1] = s["n1"][order]
        at[:nf, TRI_N2] = s["n2"][order]
        at[:nf, TRI_UV0] = s["uv0"][order]
        at[:nf, TRI_UV1] = s["uv1"][order]
        at[:nf, TRI_UV2] = s["uv2"][order]
        # shape-local ORIGINAL face index -> per-instance emitter rows
        at[:nf, TRI_EMITTER] = order.astype(np.float32)
        at[nf:, TRI_EMITTER] = -1.0
        # barycentric mirror (OBJECT space; flatten/types.py TRI_P0)
        at[:, 17:26] = pk[:, 0:9]
        packed_rows.append(pk)
        attr_rows.append(at)
        # object-space leaf AABBs (padding rows excluded)
        p0 = pk[:, 0:3]
        p1 = p0 + pk[:, 3:6]
        p2 = p0 + pk[:, 6:9]
        lo = np.minimum(np.minimum(p0, p1), p2)
        hi = np.maximum(np.maximum(p0, p1), p2)
        valid = np.zeros(nf_pad, bool)
        valid[:nf] = True
        lo = np.where(valid[:, None], lo, _NEVER)
        hi = np.where(valid[:, None], hi, -_NEVER)
        nl = nf_pad // tcl
        llo = lo.reshape(nl, tcl, 3).min(axis=1)
        lhi = hi.reshape(nl, tcl, 3).max(axis=1)
        shape_leaf_boxes[key] = (llo, lhi)
        shape_base[key] = base
        base += nf_pad
    packed = np.concatenate(packed_rows, axis=0)
    attrs = np.concatenate(attr_rows, axis=0)
    u_pad = packed.shape[0]

    # -- per-instance world leaf boxes + payload tables -------------------
    leaf_start, leaf_inst = [], []
    wlo, whi = [], []
    inst_w2o = np.zeros((len(inst_meta), 12), np.float32)
    inst_packed = np.zeros((len(inst_meta), INST_COLS), np.float32)
    for i, m in enumerate(inst_meta):
        key = m["key"]
        llo, lhi = shape_leaf_boxes[key]
        sb = shape_base[key]
        mm = m["matrix"].astype(np.float64)
        try:
            w2o = np.linalg.inv(mm)[:3, :4]
            nrm = np.linalg.inv(mm[:3, :3]).T * (-1.0 if m["flip"] else 1.0)
        except np.linalg.LinAlgError:
            if not m["hidden"]:
                raise  # visible singular transform: bail to baked mode
            w2o = np.zeros((3, 4))
            nrm = np.zeros((3, 3))
        if m["hidden"]:
            # zero w2o: the object-space ray degenerates (dir = 0 -> MT
            # det ~ 0), so hidden instances miss on EVERY backend — the
            # XLA leaf-scan fallback never sees the never-boxes below
            w2o = np.zeros((3, 4))
        inst_w2o[i] = w2o.reshape(-1).astype(np.float32)
        inst_packed[i, INST_NRM] = nrm.reshape(-1).astype(np.float32)
        inst_packed[i, INST_MAT] = m["mat_id"]
        inst_packed[i, INST_EMIT_BASE] = m["emitter_base"]
        inst_packed[i, INST_W2O0] = 1.0 if m.get("uv_flip") else 0.0
        nl = llo.shape[0]
        leaf_start.extend(sb + np.arange(nl) * tcl)
        leaf_inst.extend([i] * nl)
        if m["hidden"]:
            wlo.append(np.full((nl, 3), _NEVER, np.float32))
            whi.append(np.full((nl, 3), _NEVER, np.float32))
            continue
        # transform the 8 corners of each object box
        corners = np.stack(
            [np.where(np.array([(k >> a) & 1 for a in range(3)], bool),
                      lhi, llo) for k in range(8)],
            axis=1,
        )  # (nl, 8, 3)
        empty = llo[:, 0] > lhi[:, 0]
        wc = corners @ mm[:3, :3].T + mm[:3, 3]
        lo_w = wc.min(axis=1).astype(np.float32)
        hi_w = wc.max(axis=1).astype(np.float32)
        lo_w[empty] = _NEVER
        hi_w[empty] = _NEVER
        wlo.append(lo_w)
        whi.append(hi_w)
    leaf_start = np.asarray(leaf_start, np.int32)
    leaf_inst = np.asarray(leaf_inst, np.int32)
    lo_all = np.concatenate(wlo, axis=0)
    hi_all = np.concatenate(whi, axis=0)
    L = lo_all.shape[0]
    if L < 2:
        return None

    # -- world tree over leaf boxes: reuse the triangle builder with each
    # leaf box expressed as a degenerate "triangle" (p0=lo, p1=hi,
    # p2=center reproduces the box AND its centroid) at tcl=1, so leaf
    # child ids encode -(position+1) into the returned order ------------
    never = lo_all[:, 0] >= _NEVER
    mid = np.where(never[:, None], _NEVER, 0.5 * (lo_all + hi_all))
    bvh = build_bvh(lo_all.copy(), hi_all.copy(), mid.astype(np.float32),
                    L, 1, allow_native=False)
    leaf_start = leaf_start[bvh.order]
    leaf_inst = leaf_inst[bvh.order]

    return dict(
        packed=packed,
        attrs=attrs,
        leaf_start=leaf_start,
        leaf_inst=leaf_inst,
        inst_w2o=inst_w2o,
        inst_packed=inst_packed,
        bvh_child=bvh.child,
        bvh_boxes=bvh.boxes,
        bvh_nodes=bvh.n_nodes,
        tcl=tcl,
        # logical key space for origin-leaf sort keys: every instance
        # spans the whole unique table (see intersect.origin_sort_prim)
        tri_count_padded=len(inst_meta) * u_pad,
        u_pad=u_pad,
    )
