"""Ring-sharded scene traversal: triangle tables sharded over the mesh,
rotated device-to-device by ``ppermute`` while rays stay resident.

parallel/sharding.py replicates scene tables on every device — fine for
small scenes, wasteful for very large ones. This module is the other
regime: each device holds 1/D of the triangle rows; a sweep runs D
rounds, each testing the device's (pixel-sharded) rays against the
CURRENT table shard and then rotating the shard one hop around the ring
(``jax.lax.ppermute``). After D rounds every ray has seen the whole
scene with per-device memory O(T/D) and total link traffic of one full
table per sweep (a ring all-gather fused into compute).

Two inner tests: ``ring_closest`` sweeps every row of the held shard
(a chunked jnp scan), ``ring_closest_bvh`` walks the held shard's own
8-wide BVH with this backend's traversal route (accel/traverse.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

MAX_DISTANCE = 1e16
_DET_EPS = 1e-12


@dataclass(frozen=True)
class RingBvh:
    """Per-shard 8-wide BVHs for ring-rotated traversal (stacked over a
    leading shard dim, device-put with that dim sharded over the mesh).

    Every shard has IDENTICAL array shapes (rows padded to the max,
    node tables padded to the max node count — padding nodes are never
    reachable from the root), so the whole tuple rotates through ONE
    ppermute per round."""

    rows: jnp.ndarray     # (D, S, 12) shard triangle rows (BVH order)
    child: jnp.ndarray    # (D, M*8) i32
    boxes: jnp.ndarray    # (D, M*8, 8) f32
    remap: jnp.ndarray    # (D*S,) i32 local (shard, row) -> GLOBAL row
                          # (replicated: 4 B/tri vs 48 B/tri for rows)
    shard_rows: int
    tcl: int


def build_ring_bvh(tris_packed, mesh: Mesh, tcl: int | None = None) -> RingBvh:
    """Partition the GLOBAL BVH-ordered triangle table into D contiguous
    row ranges (contiguous ranges of a BVH-ordered table are spatially
    compact) and build one 8-wide BVH per shard (accel/bvh.py — the
    same builder the single-device path uses, so each round costs
    ~log(T/D) node visits per ray instead of O(T/D) triangle tests)."""
    import numpy as np

    from pupiloptixlab_tpu.accel.bvh import LEAF_SIZE, build_bvh

    rows = np.asarray(tris_packed, np.float32)
    t, cols = rows.shape
    d = mesh.devices.size
    if tcl is None:
        tcl = LEAF_SIZE
    shard_rows = -(-t // d)
    shard_rows = ((shard_rows + tcl - 1) // tcl) * tcl
    shard_rows = max(shard_rows, 2 * tcl)  # build_bvh needs T > tcl
    pad = d * shard_rows - t
    if pad:
        rows = np.concatenate([rows, np.zeros((pad, cols), np.float32)], 0)

    shard_rows_l, childs, boxes_l, remap = [], [], [], []
    for s in range(d):
        rs = rows[s * shard_rows : (s + 1) * shard_rows]
        valid = int(np.clip(t - s * shard_rows, 0, shard_rows))
        p0 = rs[:, 0:3]
        p1 = p0 + rs[:, 3:6]
        p2 = p0 + rs[:, 6:9]
        if valid == 0:
            # fully dead shard (tiny scene on a big mesh): a one-node
            # tree whose children are all empty leaves
            from pupiloptixlab_tpu.accel.bvh import BvhArrays

            bv = BvhArrays(
                order=np.arange(shard_rows),
                child=np.full(8, -1, np.int32),
                axis=np.zeros(1, np.int32),
                boxes=np.tile(
                    np.array([[1e30, 1e30, 1e30, -1e30, -1e30, -1e30,
                               0, 0]], np.float32), (8, 1)),
                tcl=tcl, n_nodes=1,
            )
        else:
            bv = build_bvh(p0, p1, p2, valid, tcl)
        shard_rows_l.append(rs[bv.order])
        childs.append(bv.child)
        boxes_l.append(bv.boxes)
        remap.append(s * shard_rows + bv.order.astype(np.int64))

    m_max = max(c.shape[0] // 8 for c in childs)

    def pad_nodes(c, b):
        m = c.shape[0] // 8
        if m == m_max:
            return c, b
        return (
            np.concatenate([c, np.full((m_max - m) * 8, -1, np.int32)]),
            np.concatenate(
                [b, np.zeros(((m_max - m) * 8, 8), np.float32)], 0
            ),
        )

    padded = [pad_nodes(c, b) for c, b in zip(childs, boxes_l)]
    spec = P(mesh.axis_names[0])

    def put(x, sharded=True):
        return jax.device_put(
            x, NamedSharding(mesh, spec if sharded else P())
        )

    return RingBvh(
        rows=put(np.stack(shard_rows_l)),
        child=put(np.stack([p[0] for p in padded])),
        boxes=put(np.stack([p[1] for p in padded])),
        remap=put(np.concatenate(remap).astype(np.int32), sharded=False),
        shard_rows=shard_rows,
        tcl=tcl,
    )


def ring_closest_bvh(
    mesh: Mesh,
    ro_flat: jnp.ndarray,    # (3, N) ray origin component rows
    rd_flat: jnp.ndarray,    # (3, N)
    tmin: jnp.ndarray,       # (N,)
    tmax: jnp.ndarray,       # (N,)
    ring: RingBvh,
):
    """Closest hit with per-shard BVH TRAVERSAL under rotation: D rounds,
    each walking the currently-held shard's own 8-wide tree over the
    device's resident rays (accel/traverse.py, this backend's route),
    then rotating the (rows, child, boxes) tuple one hop. Returns
    (t, idx) pixel-sharded, idx in GLOBAL rows (one replicated remap
    take at the end; -1 = miss)."""
    from jax import shard_map

    from pupiloptixlab_tpu.accel.traverse import traversal_route, traverse
    from pupiloptixlab_tpu.render.vec import Vec3

    axis_name = mesh.axis_names[0]
    d = mesh.devices.size
    s_rows = ring.shard_rows
    tcl = ring.tcl
    route = traversal_route(mesh.devices.flat[0].platform)

    def per_device(ro, rd, tmn, tmx, rows, child, boxes):
        my = jax.lax.axis_index(axis_name)
        n = tmn.shape[0]
        o = Vec3(ro[0], ro[1], ro[2])
        dv = Vec3(rd[0], rd[1], rd[2])

        def round_body(k, carry):
            bt, bs, bl, rows_c, child_c, boxes_c = carry
            t, i = traverse(route, o, dv, tmn, tmx, rows_c, child_c,
                            boxes_c, tcl)
            better = (i >= 0) & (t < bt)
            bt = jnp.where(better, t, bt)
            # the shard held at round k started life on device (my+k)%d
            bs = jnp.where(better, (my + k) % d, bs)
            bl = jnp.where(better, i, bl)
            perm = [(i_, (i_ - 1) % d) for i_ in range(d)]
            rows_c, child_c, boxes_c = jax.lax.ppermute(
                (rows_c, child_c, boxes_c), axis_name, perm
            )
            return bt, bs, bl, rows_c, child_c, boxes_c

        init = (
            jnp.full(n, MAX_DISTANCE, jnp.float32),
            jnp.zeros(n, jnp.int32),
            jnp.full(n, -1, jnp.int32),
            rows[0], child[0], boxes[0],
        )
        bt, bs, bl, *_ = jax.lax.fori_loop(0, d, round_body, init)
        return bt, bs, bl

    vec = P(None, axis_name)
    spec = P(axis_name)
    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(vec, vec, spec, spec, spec, spec, spec),
        out_specs=(spec, spec, spec),
        check_vma=False,
    )
    bt, bs, bl = jax.jit(fn)(
        ro_flat, rd_flat, tmin, tmax, ring.rows, ring.child, ring.boxes,
    )
    # resolve (winning shard, local row) -> global row through the
    # replicated 4-byte remap (one native take per sweep)
    idx = jnp.where(
        bl >= 0,
        jnp.take(ring.remap, bs * s_rows + jnp.maximum(bl, 0), axis=0),
        -1,
    )
    return bt, idx


def shard_tris(tris_packed: jnp.ndarray, mesh: Mesh):
    """Pad the (T, 12) packed rows to a multiple of the mesh size and
    shard them over its first axis. Returns (sharded rows, shard_rows)."""
    d = mesh.devices.size
    t = tris_packed.shape[0]
    pad = (-t) % d
    if pad:
        tris_packed = jnp.concatenate(
            [tris_packed, jnp.zeros((pad, tris_packed.shape[1]),
                                    tris_packed.dtype)], 0
        )
    sharded = jax.device_put(
        tris_packed, NamedSharding(mesh, P(mesh.axis_names[0]))
    )
    return sharded, tris_packed.shape[0] // d


def _local_closest(ro, rd, tmin, tmax, rows, base, chunk=1024):
    """Chunked closest-hit of local rays vs local rows (global indices
    offset by ``base``). ro/rd are (3, n) component rows; returns
    (t, idx) with idx<0 = miss."""
    rox, roy, roz = ro[0], ro[1], ro[2]
    rdx, rdy, rdz = rd[0], rd[1], rd[2]
    n = rox.shape[0]
    t_rows = rows.shape[0]
    pad = (-t_rows) % chunk
    if pad:
        rows = jnp.concatenate(
            [rows, jnp.zeros((pad, rows.shape[1]), rows.dtype)], 0
        )
    chunks = rows.reshape(-1, chunk, rows.shape[1])

    def body(carry, args):
        bt, bp = carry
        crows, cbase = args
        p0x = crows[:, 0][None]
        p0y = crows[:, 1][None]
        p0z = crows[:, 2][None]
        e1x = crows[:, 3][None]
        e1y = crows[:, 4][None]
        e1z = crows[:, 5][None]
        e2x = crows[:, 6][None]
        e2y = crows[:, 7][None]
        e2z = crows[:, 8][None]
        dx, dy, dz = rdx[:, None], rdy[:, None], rdz[:, None]
        ox, oy, oz = rox[:, None], roy[:, None], roz[:, None]
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        inv = 1.0 / jnp.where(jnp.abs(det) < _DET_EPS, _DET_EPS, det)
        tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
        ok = (
            (jnp.abs(det) >= _DET_EPS)
            & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > tmin[:, None]) & (t < tmax[:, None])
        )
        t = jnp.where(ok, t, MAX_DISTANCE)
        j = jnp.argmin(t, axis=1)
        ridx = jnp.arange(t.shape[0])
        tj = t[ridx, j]
        better = tj < bt
        bt = jnp.where(better, tj, bt)
        bp = jnp.where(better, cbase + j.astype(jnp.int32), bp)
        return (bt, bp), None

    init = (
        jnp.full(n, MAX_DISTANCE, jnp.float32),
        jnp.full(n, -1, jnp.int32),
    )
    bases = base + (jnp.arange(chunks.shape[0]) * chunk).astype(jnp.int32)
    (bt, bp), _ = jax.lax.scan(body, init, (chunks, bases))
    return bt, bp


def ring_closest(
    mesh: Mesh,
    ro_flat: jnp.ndarray,    # (3, N) ray origin component rows
    rd_flat: jnp.ndarray,    # (3, N)
    tmin: jnp.ndarray,       # (N,)
    tmax: jnp.ndarray,       # (N,)
    tris_sharded: jnp.ndarray,  # (T_pad, 12) row-sharded over the mesh
    shard_rows: int,
):
    """Closest hit of all rays vs the full (sharded) table: D rounds of
    local sweep + one ppermute table rotation each. Returns (t, idx)
    pixel-sharded like the inputs."""
    from jax import shard_map

    axis = mesh.axis_names[0]
    d = mesh.devices.size

    def per_device(ro, rd, tmn, tmx, shard):
        my = jax.lax.axis_index(axis)
        n = tmn.shape[0]

        def round_body(k, carry):
            bt, bp, rows = carry
            # the shard currently held started life on device (my + k) % d
            base = ((my + k) % d) * shard_rows
            t, p = _local_closest(ro, rd, tmn, tmx, rows, 0)
            p = jnp.where(p >= 0, p + base, p)
            better = t < bt
            bt = jnp.where(better, t, bt)
            bp = jnp.where(better, p, bp)
            # rotate the TABLE one hop (rays stay resident)
            rows = jax.lax.ppermute(
                rows, axis, [(i, (i - 1) % d) for i in range(d)]
            )
            return bt, bp, rows

        init = (
            jnp.full(n, MAX_DISTANCE, jnp.float32),
            jnp.full(n, -1, jnp.int32),
            shard,
        )
        bt, bp, _ = jax.lax.fori_loop(0, d, round_body, init)
        return bt, bp

    vec = P(None, axis)   # component rows, pixels sharded
    spec = P(axis)
    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(vec, vec, spec, spec, spec),
        out_specs=(spec, spec),
        check_vma=False,
    )
    return jax.jit(fn)(ro_flat, rd_flat, tmin, tmax, tris_sharded)
