"""Host-side wide-BVH builder over the flattened triangle soup.

The GAS-build analog (reference: world/gas_manager.cpp:61-185 builds
compacted BLASes that optixTrace walks per ray). The traversal
(accel/traverse.py: the CUDA kernel on the GPU, the plain-JAX walk
elsewhere) walks the tree per RAY on a short stack, testing all 8
children of a node in one step.

Builder design:

* top-down binned-SAH split over triangle centroids; three split levels
  are collapsed into one 8-ary node (the CWBVH construction);
* triangles are REORDERED so every leaf is one contiguous, TCL-aligned
  row range of the packed table (a leaf is rows ``[start, start+tcl)``);
* per node: 8 child boxes as an (8, 8)-row block of a flat f32 array
  (``box[node*8 : node*8+8]``), 8 child ids, and the dominant split
  axis. Children are sorted ascending along that axis.

Child-id encoding: ``id >= 0`` is an internal node; ``id < 0`` is a
leaf whose triangle rows start at ``-(id + 1)`` (a multiple of TCL).
Empty slots carry a never-hit box, so traversal never visits them.
Node 0 is the root.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

# Triangles per leaf of flat scenes, chosen from end-to-end 1080p frame
# times of the CUDA traversal on an H100 (leaf 4 < 8 < 16 on both the
# 20k- and the 405k-triangle scene; CHANGES.md).
LEAF_SIZE = 4


@dataclass
class BvhArrays:
    order: np.ndarray   # (T,) permutation of padded triangle rows
    child: np.ndarray   # (M*8,) i32 child ids (see encoding above)
    axis: np.ndarray    # (M,) i32 dominant split axis per node
    boxes: np.ndarray   # (M*8, 8) f32 [lox loy loz hix hiy hiz 0 0]
    tcl: int            # leaf size (tri rows per leaf)
    n_nodes: int


# "Never hit" box for empty child slots and all-padding leaves: a POINT
# at 1e30. An inverted box (lo > hi) does NOT work with the kernel's
# direction-robust min/max slab test — swapped slabs test as the
# interval [-inf, +inf] and match every ray (an empty slot carries child
# id 0 == the root, so a false pass would loop the traversal forever).
# The point box at 1e30 yields |t| ~ 1e30 > every tmax (<= 1e16 =
# MAX_DISTANCE) on at least one axis, so tn > tf for every real ray.
_NEVER_LO = np.full(3, 1e30, np.float32)
_NEVER_HI = np.full(3, 1e30, np.float32)


def build_bvh(
    p0: np.ndarray,
    p1: np.ndarray,
    p2: np.ndarray,
    valid_count: int,
    tcl: int,
    allow_native: bool = True,
) -> BvhArrays:
    """Build the 8-wide BVH over padded world-space triangle vertices
    ((T,3) each; rows >= valid_count are degenerate padding). T must be
    a multiple of tcl and > tcl.

    Prefers the C++ builder (native/pupil_native.cpp via
    pupiloptixlab_tpu/native.py — the GAS-build analog of the
    reference's C++ host runtime); this numpy implementation is the
    behavioral specification and the fallback. ``allow_native=False``
    forces numpy (the instanced leaf-box build uses tcl=1, which the
    native builder does not support)."""
    if allow_native:
        from pupiloptixlab_tpu.native import build_bvh8_native

        native = build_bvh8_native(p0, p1, p2, valid_count, tcl)
        if native is not None:
            return _check_stack(native)

    t_pad = p0.shape[0]
    assert t_pad % tcl == 0 and t_pad > tcl
    lo_tri = np.minimum(np.minimum(p0, p1), p2).astype(np.float32)
    hi_tri = np.maximum(np.maximum(p0, p1), p2).astype(np.float32)
    # padding must never contribute to boxes (inverted "empty" interval)
    if valid_count < t_pad:
        lo_tri[valid_count:] = 1e30
        hi_tri[valid_count:] = -1e30
    centroid = 0.5 * (lo_tri + hi_tri)
    if valid_count < t_pad:
        # cluster padding with the last valid triangle so it stays in the
        # final leaf instead of spreading empty rows across the tree
        anchor = centroid[valid_count - 1] if valid_count else np.zeros(3)
        centroid[valid_count:] = anchor

    order = np.arange(t_pad, dtype=np.int64)
    child: list[list[int]] = []   # 8 ids per node
    axis_l: list[int] = []
    boxes_l: list[np.ndarray] = []  # (8, 8) per node

    _N_BINS = 16

    def sah_split(lo: int, hi: int) -> tuple[int, int]:
        """Binned-SAH partition of order[lo:hi] at a TCL-aligned cut;
        returns (mid, axis). Falls back to the TCL-aligned median when
        SAH degenerates (all centroids coincident)."""
        idx = order[lo:hi]
        c = centroid[idx]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        ext = cmax - cmin
        n_leaves = (hi - lo) // tcl
        best = None  # (cost, axis, n_left_rows)
        for ax in range(3):
            if ext[ax] < 1e-12:
                continue
            bins = np.minimum(
                ((c[:, ax] - cmin[ax]) / ext[ax] * _N_BINS).astype(np.int32),
                _N_BINS - 1,
            )
            counts = np.bincount(bins, minlength=_N_BINS)
            # per-bin bounds over triangle boxes
            blo = np.full((_N_BINS, 3), 1e30, np.float32)
            bhi = np.full((_N_BINS, 3), -1e30, np.float32)
            np.minimum.at(blo, bins, lo_tri[idx])
            np.maximum.at(bhi, bins, hi_tri[idx])
            # prefix/suffix surface areas
            def areas(lo_b, hi_b):
                # f64: sentinel boxes (hidden/degenerate rows, +-1e30)
                # square past f32 range and the inf can poison the SAH
                # compare via inf*0
                d = np.maximum((hi_b - lo_b).astype(np.float64), 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 0] * d[:, 2]
            plo = np.minimum.accumulate(blo, axis=0)
            phi = np.maximum.accumulate(bhi, axis=0)
            slo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
            shi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
            nl = np.cumsum(counts)[:-1]
            nr = (hi - lo) - nl
            cost = areas(plo, phi)[:-1] * nl + areas(slo, shi)[1:] * nr
            valid = (nl > 0) & (nr > 0)
            if not valid.any():
                continue
            cost = np.where(valid, cost, np.inf)
            b = int(np.argmin(cost))
            # align the cut to whole leaves
            n_left = int(round(nl[b] / tcl)) * tcl
            n_left = min(max(n_left, tcl), (n_leaves - 1) * tcl)
            if best is None or cost[b] < best[0]:
                best = (cost[b], ax, n_left)
        if best is None:  # degenerate: median split on the widest axis
            ax = int(np.argmax(ext))
            best = (0.0, ax, (n_leaves // 2) * tcl)
        _, ax, half = best
        part = np.argpartition(c[:, ax], half - 1)
        order[lo:hi] = idx[part]
        return lo + half, ax

    def make_node(lo: int, hi: int) -> tuple[int, np.ndarray, np.ndarray]:
        """Create the 8-ary node for range [lo, hi) (> tcl rows).
        Returns (node_id, box_lo, box_hi)."""
        nid = len(child)
        child.append([0] * 8)
        axis_l.append(0)
        boxes_l.append(np.zeros((8, 8), np.float32))

        # collapse 3 binary split levels into <= 8 subranges
        subranges = [(lo, hi)]
        first_axis = None
        for _ in range(3):
            nxt = []
            for a, b in subranges:
                if b - a <= tcl:
                    nxt.append((a, b))
                    continue
                mid, ax = sah_split(a, b)
                if first_axis is None:
                    first_axis = ax
                nxt.append((a, mid))
                nxt.append((mid, b))
            subranges = nxt

        entries = []  # (child_id, lo3, hi3)
        for a, b in subranges:
            if b - a <= tcl:
                rows = order[a:b]
                blo = lo_tri[rows].min(axis=0)
                bhi = hi_tri[rows].max(axis=0)
                if blo[0] > bhi[0]:  # all-padding leaf -> never visit
                    blo, bhi = _NEVER_LO, _NEVER_HI
                entries.append((-(a + 1), blo, bhi))
            else:
                entries.append(make_node(a, b))

        ax = first_axis or 0
        # sort children ascending along the dominant axis so the kernel's
        # far-to-near push order follows the tile's direction sign
        entries.sort(key=lambda e: 0.5 * float(e[1][ax] + e[2][ax]))
        box = boxes_l[nid]
        total_lo = np.full(3, 1e30, np.float32)
        total_hi = np.full(3, -1e30, np.float32)
        for k, (cid, blo, bhi) in enumerate(entries):
            child[nid][k] = cid
            box[k, 0:3] = blo
            box[k, 3:6] = bhi
            if bhi[0] < 1e30:  # skip never-boxes in the union
                total_lo = np.minimum(total_lo, blo)
                total_hi = np.maximum(total_hi, bhi)
        for k in range(len(entries), 8):  # empty slots: never-hit boxes
            box[k, 0:3] = _NEVER_LO
            box[k, 3:6] = _NEVER_HI
        if total_lo[0] > total_hi[0]:  # node entirely padding
            total_lo, total_hi = _NEVER_LO, _NEVER_HI
        axis_l[nid] = ax
        return nid, total_lo, total_hi

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        make_node(0, t_pad)
    finally:
        sys.setrecursionlimit(old_limit)

    m = len(child)
    return _check_stack(BvhArrays(
        order=order,
        child=np.asarray(child, np.int32).reshape(-1),
        axis=np.asarray(axis_l, np.int32),
        boxes=np.concatenate(boxes_l, axis=0),
        tcl=tcl,
        n_nodes=m,
    ))


def max_stack_depth(child: np.ndarray) -> int:
    """Most entries a nearest-first walk can hold on its stack: a node
    popped with ``base`` entries below it pushes its live children, and
    each internal child is later popped with its farther siblings still
    below it."""
    ids = child.reshape(-1, 8)
    live = (ids != 0).sum(axis=1)
    base = np.zeros(ids.shape[0], np.int64)
    peak = 1
    for i in range(ids.shape[0]):  # parents precede their children
        peak = max(peak, int(base[i] + live[i]))
        kids = ids[i][ids[i] > 0]
        base[kids] = base[i] + live[i] - 1
    return peak


def _check_stack(bvh: BvhArrays) -> BvhArrays:
    from pupiloptixlab_tpu.accel.traverse import STACK_SIZE

    need = max_stack_depth(bvh.child)
    if need > STACK_SIZE:
        raise ValueError(
            f"BVH needs a {need}-entry traversal stack (> {STACK_SIZE})"
        )
    return bvh
