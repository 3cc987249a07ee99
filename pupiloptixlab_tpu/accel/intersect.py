"""Ray/scene intersection — the OptiX accel-build/traverse replacement.

The reference offloads traversal to RT cores via GAS/IAS handles
(world/gas_manager.cpp, world/ias_manager.cpp) and `optixTrace`. Here
triangle scenes walk the 8-wide BVH per ray (accel/traverse.py: a CUDA
kernel on the GPU, a plain-JAX walk on other backends). The chunked
brute-force sweep (Moller-Trumbore against every triangle) is the
traversal's test reference and the PUPIL_NO_BVH debug route. The
analytic unit-sphere primitives are tested in their instance frames
(supporting ellipsoids, like OptiX sphere primitives under instance
transforms).

Rays are Vec3 planes (render/vec.py) end to end — no (N, 3) relayouts.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import jax
import jax.numpy as jnp

from pupiloptixlab_tpu.accel.traverse import traversal_route, traverse
from pupiloptixlab_tpu.flatten.types import RenderConfig, SceneData
from pupiloptixlab_tpu.render.sampling import MAX_DISTANCE
from pupiloptixlab_tpu.render.vec import Vec3

_DET_EPS = 1e-12


def _register(cls):
    jax.tree_util.register_dataclass(
        cls, data_fields=[f.name for f in fields(cls)], meta_fields=[]
    )
    return cls


@_register
@dataclass
class Hit:
    t: jnp.ndarray        # (N,) hit distance; MAX_DISTANCE on miss
    prim: jnp.ndarray     # (N,) i32 primitive index (tri or sphere).
                          # Instanced scenes (config.instanced): the
                          # UNIQUE object-space tri row.
    kind: jnp.ndarray     # (N,) i32: 0 tri, 1 sphere, -1 miss
    inst: jnp.ndarray     # (N,) i32 instance id (instanced scenes only;
                          # zeros otherwise)
    # Barycentrics are NOT carried: get_local_geometry recomputes them
    # with one Moller-Trumbore on the p0/e1/e2 mirror columns of the
    # SAME attrs gather it already does (flatten/types.py TRI_P0) —
    # measured cheaper than a second 9-col gather per closest sweep.

    @property
    def hit_mask(self) -> jnp.ndarray:
        return self.kind >= 0


def _mt_planes(ro: Vec3, rd: Vec3, p0: Vec3, e1: Vec3, e2: Vec3):
    """Moller-Trumbore on planes; broadcast-compatible shapes."""
    pvec = rd.cross(e2)
    det = e1.dot(pvec)
    inv = 1.0 / jnp.where(jnp.abs(det) < _DET_EPS, _DET_EPS, det)
    tvec = ro - p0
    u = tvec.dot(pvec) * inv
    qvec = tvec.cross(e1)
    v = rd.dot(qvec) * inv
    t = e2.dot(qvec) * inv
    return det, t, u, v


def _ray_sort_key(ro: Vec3, rd: Vec3) -> jnp.ndarray:
    """Coherence key for secondary rays without a known origin
    primitive: direction OCTANT (3 bits, major), then interleaved
    quantized origin (5 bits/axis), then quantized direction (4
    bits/axis). Rays from nearby surface points heading the same way
    then sit in neighbouring lanes, so a warp walks similar paths
    through the tree (the classic GPU ray-reordering key)."""
    def q(v, lo, inv_ext, bits):
        top = jnp.float32((1 << bits) - 1)
        return jnp.clip(((v - lo) * inv_ext * top).astype(jnp.uint32), 0, (1 << bits) - 1)

    lo = Vec3(ro.x.min(), ro.y.min(), ro.z.min())
    hi = Vec3(ro.x.max(), ro.y.max(), ro.z.max())
    inv = Vec3(
        1.0 / jnp.maximum(hi.x - lo.x, 1e-12),
        1.0 / jnp.maximum(hi.y - lo.y, 1e-12),
        1.0 / jnp.maximum(hi.z - lo.z, 1e-12),
    )

    def expand7(v):  # spread 7 bits to every 3rd position
        v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
        v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
        v = (v | (v << 2)) & jnp.uint32(0x09249249)
        return v

    def morton(ax, ay, az):
        return (expand7(ax) << 2) | (expand7(ay) << 1) | expand7(az)

    octant = (
        ((rd.x >= 0).astype(jnp.uint32) << 2)
        | ((rd.y >= 0).astype(jnp.uint32) << 1)
        | (rd.z >= 0).astype(jnp.uint32)
    )
    oqx = q(ro.x, lo.x, inv.x, 5)
    oqy = q(ro.y, lo.y, inv.y, 5)
    oqz = q(ro.z, lo.z, inv.z, 5)
    half = jnp.float32(0.5)
    dqx = q(rd.x, -1.0, half, 4)
    dqy = q(rd.y, -1.0, half, 4)
    dqz = q(rd.z, -1.0, half, 4)
    # low bits: 12-bit direction morton, so coincident-origin batches
    # (primary rays) still sort into direction cones = pixel blocks
    return (
        (octant << 27)
        | (morton(oqx, oqy, oqz) << 12)
        | (morton(dqx, dqy, dqz))
    )


def _ray_sort_key_leaf(origin_prim, rd: Vec3, config: RenderConfig, mask=None):
    """Coherence keys for secondary rays WITH a known origin primitive:
    (coarse origin-leaf group, 18-bit direction Morton).

    Bounce and NEE shadow rays originate ON a primitive whose row index
    is already BVH-ordered (accel/bvh.py reorders triangle rows), so
    ``prim // tcl`` is a spatial cell id for free — finer and cheaper
    than re-quantizing origins. The coarse group keeps nearby surfaces
    together and the direction bits make each run of lanes a cone.
    Returns a 1-tuple of u32 keys for lax.sort."""
    tcl = max(config.bvh_tcl, 1)
    n_leaves = max(config.tri_count // tcl, 1)
    # sphere-origin / miss lanes -> one-past-the-end leaf group
    leaf = jnp.where(
        (origin_prim >= 0) & (origin_prim < config.tri_count),
        origin_prim // tcl,
        n_leaves,
    ).astype(jnp.uint32)

    def q6(v):
        return jnp.clip(((v + 1.0) * 32.0).astype(jnp.uint32), 0, 63)

    def expand6(v):  # spread 6 bits to every 3rd position
        v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
        v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
        v = (v | (v << 2)) & jnp.uint32(0x09249249)
        return v

    md6 = (
        (expand6(q6(rd.x)) << 2) | (expand6(q6(rd.y)) << 1) | expand6(q6(rd.z))
    )
    # clamp the coarse group to 14 bits: past 2^14 groups the shift
    # would wrap the u32, scrambling sort coherence and colliding with
    # the 0xFFFFFFFF masked-lane sentinel
    k1 = (jnp.minimum(leaf >> 2, jnp.uint32((1 << 14) - 1)) << 18) | md6
    # live keys never reach the dead sentinel (a max-coarse, max-Morton
    # lane would otherwise alias it and get culled by the tmax-from-key
    # reconstruction in _sorted_ray_sweep)
    k1 = jnp.minimum(k1, jnp.uint32(0xFFFFFFFE))
    if mask is not None:
        # culled lanes sort LAST, so they fill whole warps that exit at
        # the root
        k1 = jnp.where(mask, k1, jnp.uint32(0xFFFFFFFF))
    return (k1,)


def _sorted_ray_sweep(
    ro: Vec3, rd: Vec3, tmin, tmax, coherent, run,
    sort_keys=None, const_tmin=None, const_tmax=None,
):
    """Coherence-sort + un-permute wrapper around a traversal callable
    ``run(arrays) -> outputs`` (arrays: ro xyz, rd xyz, tmin, tmax).

    ``const_tmin`` / ``const_tmax`` (floats) promise the respective
    interval bound is constant over LIVE lanes, so it rides through the
    sort as a rebuilt constant instead of a carried operand. A
    const_tmax with masked lanes is reconstructed from the dead-lane
    sort-key sentinel (0xFFFFFFFF -> empty interval)."""
    n = ro.x.shape[0]
    # Incoherent (secondary) rays are sorted so neighbouring lanes share
    # traversal paths. A multi-operand lax.sort carries all ray planes +
    # the original lane id through (no big-table gathers): by
    # (origin-leaf, direction) when the caller knows the origin primitive
    # (_ray_sort_key_leaf), else by direction+origin Morton code.
    do_sort = not coherent
    trim_tmin = do_sort and const_tmin is not None
    trim_tmax = do_sort and const_tmax is not None and sort_keys is not None
    arrays = [ro.x, ro.y, ro.z, rd.x, rd.y, rd.z]
    if not trim_tmin:
        arrays.append(tmin)
    if not trim_tmax:
        arrays.append(tmax)
    if do_sort:
        keys = list(sort_keys) if sort_keys is not None else [_ray_sort_key(ro, rd)]
        lane = jnp.arange(n, dtype=jnp.int32)
        sorted_ops = jax.lax.sort(
            [*keys, lane, *arrays],
            dimension=0, num_keys=len(keys), is_stable=False,
        )
        lane = sorted_ops[len(keys)]
        arrays = list(sorted_ops[len(keys) + 1:])
        if trim_tmax:
            dead = sorted_ops[0] == jnp.uint32(0xFFFFFFFF)
            arrays.append(jnp.where(dead, -1.0, const_tmax))
        if trim_tmin:
            arrays.insert(6, jnp.full(n, const_tmin, jnp.float32))
    outs = list(run(arrays))
    if do_sort:
        # un-permute by sorting back on the carried lane ids
        unsorted = jax.lax.sort(
            [lane, *outs], dimension=0, num_keys=1, is_stable=False
        )
        outs = list(unsorted[1:])
    return outs


def origin_sort_prim(hit: "Hit", scene: SceneData, config: RenderConfig):
    """Per-lane origin value for secondary-ray sort keys
    (_ray_sort_key_leaf groups rays by ``value // tcl``): the BVH-
    ordered world tri row for baked scenes, or an (instance, shape-leaf)
    -unique value for instanced scenes (two instances of one shape are
    far apart in world space — sharing their key would scramble ray
    locality). -1 for sphere hits / misses."""
    base = jnp.where(hit.kind == 0, hit.prim, -1)
    if not config.instanced:
        return base
    tcl = max(config.bvh_tcl, 1)
    shape_leaves = scene.tris.packed.shape[0] // tcl
    leafed = (hit.inst * shape_leaves + hit.prim // tcl) * tcl
    return jnp.where(hit.kind == 0, leafed, -1)


def _bvh_tris(
    ro: Vec3, rd: Vec3, tmin, tmax, scene: SceneData, config: RenderConfig,
    anyhit: bool, coherent: bool = True, origin_prim=None, mask=None,
    const_tmin=None, const_tmax=None,
):
    """BVH traversal of the triangle tables on this backend's route.
    Closest: (t, prim, kind, inst) in Hit layout; any-hit: (N,) bool."""
    tris = scene.tris
    route = traversal_route(jax.default_backend())
    sort_keys = (
        _ray_sort_key_leaf(origin_prim, rd, config, mask)
        if origin_prim is not None
        else None
    )
    inst = dict(
        instanced=config.instanced,
        leaf_start=tris.leaf_start,
        leaf_inst=tris.leaf_inst,
        inst_w2o=tris.inst_w2o,
    )

    def run(arrays):
        out = traverse(
            route, Vec3(*arrays[0:3]), Vec3(*arrays[3:6]), arrays[6],
            arrays[7], tris.packed, tris.bvh_child, tris.bvh_boxes,
            config.bvh_tcl, anyhit=anyhit, **inst,
        )
        return (out.astype(jnp.int32),) if anyhit else out

    outs = _sorted_ray_sweep(
        ro, rd, tmin, tmax, coherent, run, sort_keys=sort_keys,
        const_tmin=const_tmin, const_tmax=const_tmax,
    )
    if anyhit:
        return outs[0] != 0
    t, idx = outs[0], outs[1]
    hit = idx >= 0
    if config.instanced:
        inst_id = jnp.take(tris.leaf_inst, jnp.maximum(outs[2], 0), axis=0)
        inst_id = jnp.where(hit, inst_id.astype(jnp.int32), 0)
    else:
        inst_id = jnp.zeros(ro.x.shape[0], jnp.int32)
    return (
        jnp.where(hit, t, MAX_DISTANCE),
        jnp.where(hit, idx, 0),
        jnp.where(hit, 0, -1),
        inst_id,
    )


def _pick_chunk(n_rays: int, n_tris: int, budget: int = 1 << 22) -> int:
    c = max(budget // max(n_rays, 1), 8)
    return min(c, n_tris)


def _sweep_tris_xla(ro: Vec3, rd: Vec3, tmin, tmax, scene: SceneData):
    """Brute-force closest hit: a chunked scan over every triangle.
    The reference the BVH traversal is tested against, and the route of
    scenes flattened without a BVH (PUPIL_NO_BVH)."""
    n_tris = scene.tris.packed.shape[0]
    n = ro.x.shape[0]
    chunk = _pick_chunk(n, n_tris)
    pad = (-n_tris) % chunk
    packed = scene.tris.packed
    if pad:
        packed = jnp.concatenate(
            [packed, jnp.zeros((pad, packed.shape[1]), packed.dtype)], 0
        )
    tri_chunks = packed.reshape(-1, chunk, packed.shape[1])

    def body(carry, args):
        bt, bp, bk = carry
        rows, base = args  # (chunk, 12)
        p0 = Vec3(rows[:, 0][None], rows[:, 1][None], rows[:, 2][None])
        e1 = Vec3(rows[:, 3][None], rows[:, 4][None], rows[:, 5][None])
        e2 = Vec3(rows[:, 6][None], rows[:, 7][None], rows[:, 8][None])
        ro_b = Vec3(ro.x[:, None], ro.y[:, None], ro.z[:, None])
        rd_b = Vec3(rd.x[:, None], rd.y[:, None], rd.z[:, None])
        det, t, u, v = _mt_planes(ro_b, rd_b, p0, e1, e2)
        ok = (
            (jnp.abs(det) >= _DET_EPS)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > tmin[:, None])
            & (t < tmax[:, None])
        )
        t = jnp.where(ok, t, MAX_DISTANCE)
        j = jnp.argmin(t, axis=1)
        rows_idx = jnp.arange(t.shape[0])
        tj = t[rows_idx, j]
        better = tj < bt
        bt = jnp.where(better, tj, bt)
        bp = jnp.where(better, base + j.astype(jnp.int32), bp)
        bk = jnp.where(better, 0, bk)
        return (bt, bp, bk), None

    init = (
        jnp.full(n, MAX_DISTANCE, jnp.float32),
        jnp.zeros(n, jnp.int32),
        jnp.full(n, -1, jnp.int32),
    )
    bases = (jnp.arange(tri_chunks.shape[0]) * chunk).astype(jnp.int32)
    carry, _ = jax.lax.scan(body, init, (tri_chunks, bases))
    return carry


def _sweep_tris_xla_instanced(ro: Vec3, rd: Vec3, tmin, tmax,
                              scene: SceneData, config: RenderConfig):
    """Brute-force closest hit for INSTANCED scenes: scan over world
    leaves, transforming rays into each leaf's instance object space
    (the same semantics as the instanced traversal, and its test
    reference)."""
    tris = scene.tris
    tcl = max(config.bvh_tcl, 1)
    n = ro.x.shape[0]
    packed = tris.packed

    def body(carry, leaf):
        bt, bp, bk, bi = carry
        start, inst = leaf
        rows = jax.lax.dynamic_slice(
            packed, (start, jnp.int32(0)), (tcl, packed.shape[1])
        )
        w = tris.inst_w2o[inst]
        rox = w[0] * ro.x + w[1] * ro.y + w[2] * ro.z + w[3]
        roy = w[4] * ro.x + w[5] * ro.y + w[6] * ro.z + w[7]
        roz = w[8] * ro.x + w[9] * ro.y + w[10] * ro.z + w[11]
        rdx = w[0] * rd.x + w[1] * rd.y + w[2] * rd.z
        rdy = w[4] * rd.x + w[5] * rd.y + w[6] * rd.z
        rdz = w[8] * rd.x + w[9] * rd.y + w[10] * rd.z
        p0 = Vec3(rows[:, 0][None], rows[:, 1][None], rows[:, 2][None])
        e1 = Vec3(rows[:, 3][None], rows[:, 4][None], rows[:, 5][None])
        e2 = Vec3(rows[:, 6][None], rows[:, 7][None], rows[:, 8][None])
        ro_b = Vec3(rox[:, None], roy[:, None], roz[:, None])
        rd_b = Vec3(rdx[:, None], rdy[:, None], rdz[:, None])
        det, t, u, v = _mt_planes(ro_b, rd_b, p0, e1, e2)
        ok = (
            (jnp.abs(det) >= _DET_EPS)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > tmin[:, None])
            & (t < tmax[:, None])
        )
        t = jnp.where(ok, t, MAX_DISTANCE)
        j = jnp.argmin(t, axis=1)
        rows_idx = jnp.arange(t.shape[0])
        tj = t[rows_idx, j]
        better = tj < bt
        bt = jnp.where(better, tj, bt)
        bp = jnp.where(better, start + j.astype(jnp.int32), bp)
        bk = jnp.where(better, 0, bk)
        bi = jnp.where(better, inst, bi)
        return (bt, bp, bk, bi), None

    init = (
        jnp.full(n, MAX_DISTANCE, jnp.float32),
        jnp.zeros(n, jnp.int32),
        jnp.full(n, -1, jnp.int32),
        jnp.zeros(n, jnp.int32),
    )
    carry, _ = jax.lax.scan(
        body, init, (tris.leaf_start, tris.leaf_inst)
    )
    return carry


def _sphere_tests(ro: Vec3, rd: Vec3, scene: SceneData, tmin, tmax):
    """Analytic unit-sphere hits in each sphere's object frame.

    Returns (t (S,N), hit (S,N)) in sphere-major layout: the ray axis
    stays the contiguous minor dimension.
    """
    w2o = scene.spheres.w2o  # (S,3,4)

    def xform(vx, vy, vz, translate):
        # (S,1) x (1,N) -> (S,N) per output component
        outs = []
        for i in range(3):
            o = (
                w2o[:, i, 0][:, None] * vx[None, :]
                + w2o[:, i, 1][:, None] * vy[None, :]
                + w2o[:, i, 2][:, None] * vz[None, :]
            )
            if translate:
                o = o + w2o[:, i, 3][:, None]
            outs.append(o)
        return outs

    ox, oy, oz = xform(ro.x, ro.y, ro.z, True)
    dx, dy, dz = xform(rd.x, rd.y, rd.z, False)
    a = dx * dx + dy * dy + dz * dz
    b = ox * dx + oy * dy + oz * dz
    c = ox * ox + oy * oy + oz * oz - 1.0
    disc = b * b - a * c
    valid = (disc >= 0.0) & (a > _DET_EPS)
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv_a = 1.0 / jnp.maximum(a, _DET_EPS)
    t0 = (-b - sq) * inv_a
    t1 = (-b + sq) * inv_a
    in0 = (t0 > tmin[None, :]) & (t0 < tmax[None, :])
    in1 = (t1 > tmin[None, :]) & (t1 < tmax[None, :])
    t = jnp.where(in0, t0, t1)
    hit = valid & (in0 | in1)
    return jnp.where(hit, t, MAX_DISTANCE), hit


def _curve_tests(ro: Vec3, rd: Vec3, scene: SceneData, tmin, tmax):
    """Analytic ROUNDED-CONE hits for round-curve segments, curve-major
    (C, N) layout like _sphere_tests. Standard closed-form intersector
    (cone body + two sphere caps); rays must be unit-length. Returns
    (t (C,N), hit (C,N))."""
    from pupiloptixlab_tpu.flatten.types import (
        CRV_P0, CRV_P1, CRV_R0, CRV_R1,
    )

    rows = scene.curves.packed  # (C, 12)
    ax = rows[:, CRV_P0.start][:, None]
    ay = rows[:, CRV_P0.start + 1][:, None]
    az = rows[:, CRV_P0.start + 2][:, None]
    bx = rows[:, CRV_P1.start][:, None]
    by = rows[:, CRV_P1.start + 1][:, None]
    bz = rows[:, CRV_P1.start + 2][:, None]
    ra = rows[:, CRV_R0][:, None]
    rb = rows[:, CRV_R1][:, None]

    bax, bay, baz = bx - ax, by - ay, bz - az
    oax = ro.x[None, :] - ax
    oay = ro.y[None, :] - ay
    oaz = ro.z[None, :] - az
    obx = ro.x[None, :] - bx
    oby = ro.y[None, :] - by
    obz = ro.z[None, :] - bz
    dx, dy, dz = rd.x[None, :], rd.y[None, :], rd.z[None, :]

    rr = ra - rb
    m0 = bax * bax + bay * bay + baz * baz
    m1 = bax * oax + bay * oay + baz * oaz
    m2 = bax * dx + bay * dy + baz * dz
    m3 = dx * oax + dy * oay + dz * oaz
    m5 = oax * oax + oay * oay + oaz * oaz
    m6 = obx * dx + oby * dy + obz * dz
    m7 = obx * obx + oby * oby + obz * obz

    d2 = m0 - rr * rr
    k2 = d2 - m2 * m2
    k1 = d2 * m3 - m1 * m2 + m2 * rr * ra
    k0 = d2 * m5 - m1 * m1 + 2.0 * m1 * rr * ra - m0 * ra * ra
    h = k1 * k1 - k0 * k2
    k2s = jnp.where(jnp.abs(k2) < 1e-12, 1e-12, k2)
    t_cone = (-jnp.sqrt(jnp.maximum(h, 0.0)) - k1) / k2s
    y = m1 - ra * rr + t_cone * m2
    cone_ok = (h >= 0.0) & (y > 0.0) & (y < d2)

    h1 = m3 * m3 - m5 + ra * ra
    t_a = -m3 - jnp.sqrt(jnp.maximum(h1, 0.0))
    h2 = m6 * m6 - m7 + rb * rb
    t_b = -m6 - jnp.sqrt(jnp.maximum(h2, 0.0))

    big = MAX_DISTANCE
    degen = (ra <= 0.0) & (rb <= 0.0)  # hidden / padding rows never hit
    in_rng = lambda t: (t > tmin[None, :]) & (t < tmax[None, :])
    tc = jnp.where(cone_ok & in_rng(t_cone) & ~degen, t_cone, big)
    ta = jnp.where((h1 >= 0.0) & in_rng(t_a) & (ra > 0.0), t_a, big)
    tb = jnp.where((h2 >= 0.0) & in_rng(t_b) & (rb > 0.0), t_b, big)
    t = jnp.minimum(tc, jnp.minimum(ta, tb))
    return t, t < big


def intersect_closest(
    ro: Vec3,
    rd: Vec3,
    tmin: jnp.ndarray,
    tmax: jnp.ndarray,
    scene: SceneData,
    config: RenderConfig,
    coherent: bool = True,
    origin_prim: jnp.ndarray | None = None,
    mask: jnp.ndarray | None = None,
    const_tmin: float | None = None,
    const_tmax: float | None = None,
) -> Hit:
    """``origin_prim``: per-lane primitive index the ray originates on
    (tri row in BVH order; anything out of [0, tri_count) groups as
    'other'). Selects the origin-leaf secondary-ray sort key — see
    _ray_sort_key_leaf.

    ``mask``: lanes whose result the caller will actually use. Culled
    lanes get an EMPTY ray interval (tmax = -1, guaranteed miss on every
    backend) and sort to the end, so they exit at the BVH root.

    ``const_tmin`` / ``const_tmax``: static promises that the bound is
    that constant on live lanes, letting the ray sort drop the operand
    (see _sorted_ray_sweep)."""
    if mask is not None:
        tmax = jnp.where(mask, tmax, -1.0)
    n = ro.x.shape[0]
    best = (
        jnp.full(n, MAX_DISTANCE, jnp.float32),
        jnp.zeros(n, jnp.int32),
        jnp.full(n, -1, jnp.int32),
        jnp.zeros(n, jnp.int32),
    )
    if config.tri_count > 0:
        if config.bvh_nodes > 0:
            best = _bvh_tris(
                ro, rd, tmin, tmax, scene, config, anyhit=False,
                coherent=coherent, origin_prim=origin_prim, mask=mask,
                const_tmin=const_tmin, const_tmax=const_tmax,
            )
        else:
            best = _sweep_tris_xla(ro, rd, tmin, tmax, scene) + (
                jnp.zeros(n, jnp.int32),
            )
    best_t, best_prim, best_kind, best_inst = best

    if config.sphere_count > 0:
        t_s, hit_s = _sphere_tests(ro, rd, scene, tmin, tmax)  # (S, N)
        j = jnp.argmin(t_s, axis=0)  # (N,)
        tj = jnp.min(t_s, axis=0)
        better = (tj < MAX_DISTANCE) & (tj < best_t)
        best_t = jnp.where(better, tj, best_t)
        best_prim = jnp.where(better, j.astype(jnp.int32), best_prim)
        best_kind = jnp.where(better, 1, best_kind)
    if config.curve_count > 0:
        t_c, hit_c = _curve_tests(ro, rd, scene, tmin, tmax)  # (C, N)
        j = jnp.argmin(t_c, axis=0)
        tj = jnp.min(t_c, axis=0)
        better = (tj < MAX_DISTANCE) & (tj < best_t)
        best_t = jnp.where(better, tj, best_t)
        best_prim = jnp.where(better, j.astype(jnp.int32), best_prim)
        best_kind = jnp.where(better, 2, best_kind)
    return Hit(t=best_t, prim=best_prim, kind=best_kind, inst=best_inst)


def intersect_any(
    ro: Vec3,
    rd: Vec3,
    tmin: jnp.ndarray,
    tmax: jnp.ndarray,
    scene: SceneData,
    config: RenderConfig,
    coherent: bool = True,
    origin_prim: jnp.ndarray | None = None,
    mask: jnp.ndarray | None = None,
    const_tmin: float | None = None,
) -> jnp.ndarray:
    """Occlusion test (shadow rays): any hit in (tmin, tmax) -> True.

    On BVH scenes this runs a dedicated terminate-on-first-hit traversal
    (the reference's shadow rays, render/emitter.h:91-100) — no
    closest-hit bookkeeping, a ray stops at its first occluder.
    Elsewhere the closest-hit sweep doubles as the occlusion test.

    ``mask``: see intersect_closest — culled lanes return un-occluded.
    """
    if mask is not None:
        tmax = jnp.where(mask, tmax, -1.0)
    if config.tri_count > 0 and config.bvh_nodes > 0:
        occluded = _bvh_tris(
            ro, rd, tmin, tmax, scene, config, anyhit=True,
            coherent=coherent, origin_prim=origin_prim, mask=mask,
            const_tmin=const_tmin,
        )
        if config.sphere_count > 0:
            t_s, hit_s = _sphere_tests(ro, rd, scene, tmin, tmax)
            occluded = occluded | jnp.any(hit_s, axis=0)
        if config.curve_count > 0:
            t_c, hit_c = _curve_tests(ro, rd, scene, tmin, tmax)
            occluded = occluded | jnp.any(hit_c, axis=0)
        return occluded
    hit = intersect_closest(ro, rd, tmin, tmax, scene, config)
    return hit.hit_mask
