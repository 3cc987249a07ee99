"""Checks shared by the test suite and chip_smoke.py.

* ``traversal_parity``: the production closest-hit and any-hit
  (accel/intersect.py, this backend's traversal route) against the
  brute-force sweep on the primary, bounce and shadow rays of one frame;
* ``oracle_gate``: a render against its committed oracle image
  (tools/oracle_pt.py, an independent numpy path tracer);
* ``denoise_parity``: the a-trous filter on the default device against
  the same function on the CPU;
* ``generated_scene``: seeded scenes written by tools/ into
  ``data/generated/`` (listed in .gitignore).

Each check returns its numbers and raises ``AssertionError`` on failure.
"""

from __future__ import annotations

import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

REPO_ROOT = Path(__file__).resolve().parent.parent
GENERATED = REPO_ROOT / "data" / "generated"
ORACLE_DIR = REPO_ROOT / "tests" / "data"

# Relative tolerance of the traversal comparison. Float32 Moller-Trumbore
# evaluated with another contraction (FMA) and operation order differs
# by rounding errors that scale with the coordinates involved: the ray
# origin's magnitude plus the distance travelled. Hit distances, ties,
# interval ends and edge distances are compared at PARITY_RTOL times
# that scale (see _scale).
PARITY_RTOL = 1e-5


def generated_scene(kind: str, *params: int) -> Path:
    """Write (once) and return a seeded generated scene:
    ``big_env`` (tools/make_big_scene.py, param: grid) or ``instanced``
    (tools/make_instanced_scene.py, params: n_inst, grid, res)."""
    tool, xml = {
        "big_env": ("make_big_scene.py", "big_env.xml"),
        "instanced": ("make_instanced_scene.py", "instanced.xml"),
    }[kind]
    out = GENERATED / "_".join([kind, *map(str, params)])
    path = out / xml
    if not path.exists():
        subprocess.run(
            [sys.executable, str(REPO_ROOT / "tools" / tool), str(out),
             *map(str, params)],
            check=True, capture_output=True, timeout=600,
        )
    return path


# -- traversal ---------------------------------------------------------------

def parity_rays(scene, config, camera, seed: int = 0):
    """Primary rays of the film (pixel centres), then from their hits one
    cosine-distributed bounce ray and one shadow ray (uniform hemisphere
    direction, tmax uniform in [0.05, 4)) per hit pixel. Returns
    ``{"primary"|"bounce"|"shadow": (ro, rd, tmin, tmax)}`` plus the
    primary Hit and origin primitives."""
    from pupiloptixlab_tpu.accel.intersect import (
        intersect_closest,
        origin_sort_prim,
    )
    from pupiloptixlab_tpu.render.camera import generate_rays
    from pupiloptixlab_tpu.render.geometry import get_local_geometry
    from pupiloptixlab_tpu.render.sampling import (
        MAX_DISTANCE,
        RAY_OFFSET,
        cosine_sample_hemisphere,
        to_world,
        uniform_sample_hemisphere,
    )

    w, h = config.width, config.height
    n = w * h
    half = jnp.full(n, 0.5, jnp.float32)
    ro, rd = generate_rays(camera, w, h, half, half)
    tmin = jnp.full(n, RAY_OFFSET, jnp.float32)
    tmax = jnp.full(n, MAX_DISTANCE, jnp.float32)
    hit = intersect_closest(ro, rd, tmin, tmax, scene, config)
    geo = get_local_geometry(scene, hit, ro, rd, config.sphere_count,
                             config.instanced, config.curve_count)
    u = jax.random.uniform(jax.random.PRNGKey(seed), (5, n), jnp.float32)
    live = hit.hit_mask
    dead = jnp.where(live, tmax, -1.0)
    bounce_d = to_world(cosine_sample_hemisphere(u[0], u[1]), geo.normal)
    shadow_d = to_world(uniform_sample_hemisphere(u[2], u[3]), geo.normal)
    shadow_tmax = jnp.where(live, 0.05 + 3.95 * u[4], -1.0)
    rays = {
        "primary": (ro, rd, tmin, tmax),
        "bounce": (geo.position, bounce_d, tmin, dead),
        "shadow": (geo.position, shadow_d, tmin, shadow_tmax),
    }
    return rays, hit, origin_sort_prim(hit, scene, config)


def _reference_closest(ro, rd, tmin, tmax, scene, config):
    """Brute-force sweep -> numpy (t, prim, hit, inst)."""
    from pupiloptixlab_tpu.accel.intersect import (
        _sweep_tris_xla,
        _sweep_tris_xla_instanced,
    )

    if config.instanced:
        t, prim, kind, inst = _sweep_tris_xla_instanced(
            ro, rd, tmin, tmax, scene, config
        )
    else:
        t, prim, kind = _sweep_tris_xla(ro, rd, tmin, tmax, scene)
        inst = jnp.zeros_like(prim)
    return (np.asarray(t), np.asarray(prim), np.asarray(kind) == 0,
            np.asarray(inst))


def _scale(ro, t):
    """Per-lane magnitude of the coordinates a hit at ``t`` involves."""
    o = np.max(np.abs(np.stack([np.asarray(c) for c in (ro.x, ro.y, ro.z)])),
               axis=0)
    return o + np.abs(np.where(np.abs(t) < 1e15, t, 0.0))


def _edge_geometry(scene, config, ro, rd, lanes, prim, inst):
    """Float64 Moller-Trumbore of each ray of ``lanes`` against triangle
    ``prim`` (of instance ``inst``): (t, distance of the plane hit point
    to the nearest edge, coordinate scale, |cos| of the ray-plane
    angle)."""
    rows = np.asarray(scene.tris.packed, np.float64)[prim]
    o = np.stack([np.asarray(c, np.float64)[lanes] for c in (ro.x, ro.y, ro.z)], 1)
    d = np.stack([np.asarray(c, np.float64)[lanes] for c in (rd.x, rd.y, rd.z)], 1)
    if config.instanced:
        w = np.asarray(scene.tris.inst_w2o, np.float64)[inst].reshape(-1, 3, 4)
        o = np.einsum("kij,kj->ki", w[:, :, :3], o) + w[:, :, 3]
        d = np.einsum("kij,kj->ki", w[:, :, :3], d)
    p0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    pv = np.cross(d, e2)
    det = np.einsum("ki,ki->k", e1, pv)
    area2 = np.linalg.norm(np.cross(e1, e2), axis=1)
    cos = np.abs(det) / np.maximum(area2 * np.linalg.norm(d, axis=1), 1e-300)
    inv = 1.0 / np.where(det == 0.0, 1e-300, det)
    tv = o - p0
    qv = np.cross(tv, e1)
    u = np.einsum("ki,ki->k", tv, pv) * inv
    v = np.einsum("ki,ki->k", d, qv) * inv
    t = np.einsum("ki,ki->k", e2, qv) * inv

    # barycentric weight times the height over that edge
    def height(edge):
        return area2 / np.maximum(np.linalg.norm(edge, axis=1), 1e-300)

    dist = np.minimum(
        np.minimum(np.abs(u) * height(e2), np.abs(v) * height(e1)),
        np.abs(1.0 - u - v) * height(e2 - e1),
    )
    scale = (np.max(np.abs(o), axis=1)
             + np.abs(t) * np.linalg.norm(d, axis=1))
    return t, dist, scale, cos


def _explained(scene, config, ro, rd, lanes, prim, inst, t32, tmin, tmax,
               other=None):
    """Which disagreements on ``lanes`` float32 rounding explains, judged
    in float64 on the deciding triangle ``prim`` (the nearer reported
    hit; instance ``inst``) whose float32 distance is ``t32``:

    * the hit point lies within PARITY_RTOL of the coordinate scale of a
      triangle edge — non-watertight Moller-Trumbore lets one evaluation
      fall through the crack between two triangles;
    * ``t32`` lies within tol_t of ``tmin`` or ``tmax``, or (``other``:
      the other side's distance to the same triangle) within tol_t of
      it, where tol_t = PARITY_RTOL * scale / cos: the distance's float32
      error grows as 1/cos of the ray-plane angle."""
    if lanes.size == 0:
        return np.zeros(0, bool)
    _, dist, scale, cos = _edge_geometry(scene, config, ro, rd, lanes, prim,
                                         inst)
    tol_t = PARITY_RTOL * scale / np.maximum(cos, 1e-30)
    t32 = t32.astype(np.float64)
    ok = dist <= PARITY_RTOL * scale
    ok |= (np.abs(t32 - tmin[lanes]) <= tol_t)
    ok |= (np.abs(tmax[lanes] - t32) <= tol_t)
    if other is not None:
        ok |= np.abs(t32 - other.astype(np.float64)) <= tol_t
    return ok


def _explain(scene, config, ro, rd, lanes, got, ref):
    """Float64 view of up to 8 disagreeing lanes, for the failure text."""
    rows = []
    for k in lanes[:8]:
        one = np.array([k])
        row = [int(k)]
        for prim, t32, inst in (got, ref):
            t, dist, scale, cos = _edge_geometry(
                scene, config, ro, rd, one, prim[one], inst[one])
            row.append(dict(prim=int(prim[k]), t32=float(t32[k]),
                            t64=float(t[0]), edge=float(dist[0] / scale[0]),
                            cos=float(cos[0])))
        rows.append(row)
    return rows


def traversal_parity(scene, config, camera, seed: int = 0) -> dict:
    """Production closest-hit (primary + bounce rays) and any-hit
    (shadow rays) against the brute-force sweep on the same device.

    Closest: hit/miss agree, and where both hit, ``t`` agrees to
    PARITY_RTOL of the coordinate scale (_scale); ``prim`` may differ only
    where the two hits lie within that tolerance of each other (a tie).
    Any-hit: the occlusion masks agree. Every disagreement left over
    must be one float32 rounding explains (_explained): a hit on a
    triangle edge, or a grazing hit whose distance error reaches an
    interval end or the other side's distance. Returns per-set counts."""
    from pupiloptixlab_tpu.accel.intersect import (
        intersect_any,
        intersect_closest,
    )
    from pupiloptixlab_tpu.render.sampling import MAX_DISTANCE, RAY_OFFSET

    assert config.tri_count > 0 and config.bvh_nodes > 0, "needs a BVH scene"
    rays, hit0, oprim = parity_rays(scene, config, camera, seed)
    live = np.asarray(hit0.hit_mask)
    out = {}
    for name in ("primary", "bounce"):
        ro, rd, tmin, tmax = rays[name]
        if name == "primary":
            got = hit0
        else:
            got = intersect_closest(
                ro, rd, tmin, tmax, scene, config, coherent=False,
                origin_prim=oprim, mask=hit0.hit_mask,
                const_tmin=RAY_OFFSET, const_tmax=MAX_DISTANCE,
            )
        rt, rp, rh, ri = _reference_closest(ro, rd, tmin, tmax, scene, config)
        gt, gp, gi = (np.asarray(got.t), np.asarray(got.prim),
                      np.asarray(got.inst))
        gh = np.asarray(got.kind) == 0
        tmn, tmx = np.asarray(tmin), np.asarray(tmax)
        one = gh != rh
        both = gh & rh
        dt = np.abs(gt - rt)
        tol = PARITY_RTOL * _scale(ro, np.where(rh, rt, gt))
        ties = both & (gp != rp) & (dt <= tol)
        lanes = np.flatnonzero(one | (both & (dt > tol)))
        # the deciding triangle is the nearer reported hit: the other
        # side missed it
        g_near = gh[lanes] & (~rh[lanes] | (gt[lanes] < rt[lanes]))
        same = both[lanes] & (gp[lanes] == rp[lanes])
        ok = _explained(
            scene, config, ro, rd, lanes,
            np.where(g_near, gp[lanes], rp[lanes]),
            np.where(g_near, gi[lanes], ri[lanes]),
            np.where(g_near, gt[lanes], rt[lanes]), tmn, tmx,
            other=np.where(same, np.where(g_near, rt[lanes], gt[lanes]),
                           np.inf),
        )
        violations = lanes[~ok]
        out[name] = dict(
            rays=int(live.size if name == "primary" else live.sum()),
            hits=int(rh.sum()),
            hit_mismatch=int(one.sum()),
            t_mismatch=int((both & (dt > tol)).sum()),
            explained=int(ok.sum()),
            prim_ties=int(ties.sum()),
            violations=int(violations.size),
        )
        assert violations.size == 0, (name, out[name], _explain(
            scene, config, ro, rd, violations, (gp, gt, gi), (rp, rt, ri)))

    ro, rd, tmin, tmax = rays["shadow"]
    occ = np.asarray(intersect_any(
        ro, rd, tmin, tmax, scene, config, coherent=False,
        origin_prim=oprim, mask=hit0.hit_mask, const_tmin=RAY_OFFSET,
    ))
    big = jnp.where(tmax > tmin, MAX_DISTANCE, -1.0)
    rt, rp, rh, ri = _reference_closest(ro, rd, tmin, big, scene, config)
    tmn, tmx = np.asarray(tmin), np.asarray(tmax)
    ref_occ = rh & (rt < tmx)
    lanes = np.flatnonzero(occ != ref_occ)
    # the deciding triangle: the sweep's nearest hit where it reports the
    # occlusion, else the production closest hit over the same interval
    got = intersect_closest(ro, rd, tmin, tmax, scene, config)
    gp, gi = np.asarray(got.prim), np.asarray(got.inst)
    gt = np.asarray(got.t)
    g_occ = np.asarray(got.kind) == 0
    r_dec = ref_occ[lanes]
    ok = _explained(
        scene, config, ro, rd, lanes,
        np.where(r_dec, rp[lanes], gp[lanes]),
        np.where(r_dec, ri[lanes], gi[lanes]),
        np.where(r_dec, rt[lanes], gt[lanes]), tmn, tmx,
    ) & (r_dec | g_occ[lanes])
    out["shadow"] = dict(
        rays=int(live.sum()),
        occluded=int(ref_occ.sum()),
        occ_mismatch=int(lanes.size),
        explained=int(ok.sum()),
        violations=int((~ok).sum()),
    )
    assert ok.all(), ("shadow", out["shadow"], [
        dict(lane=int(k), occ=bool(occ[k]), ref_t=float(rt[k]),
             tmax=float(tmx[k]), closest_t=float(gt[k]))
        for k in lanes[~ok][:8]
    ], _explain(scene, config, ro, rd, lanes[~ok], (gp, gt, gi),
                (rp, rt, ri)))
    return out


# -- accuracy against the independent oracle ---------------------------------

@dataclass(frozen=True)
class OracleGate:
    scene: str            # path relative to the repo, or "generated:<kind>:<params>"
    oracle: str           # EXR under tests/data
    res: int
    spp: int
    box: int              # box-filter width for the filtered metric
    max_ratio_err: float  # |mean(img) / mean(oracle) - 1|
    max_box_rel: float    # box-filtered relative MSE
    max_rel_mse: float | None = None


# Thresholds and spp as committed with each oracle image
# (tests/test_oracle_parity.py documents their calibration).
ORACLE_GATES = {
    "mesh_env": OracleGate(
        "data/mesh_env.xml", "oracle_mesh_env_64.exr", 64, 512, 4,
        max_ratio_err=0.02, max_box_rel=5e-3, max_rel_mse=1.5e-2,
    ),
    "oracle_mat": OracleGate(
        "data/oracle_mat.xml", "oracle_mat_64.exr", 64, 512, 4,
        max_ratio_err=0.01, max_box_rel=1e-3, max_rel_mse=4e-3,
    ),
    "big_env": OracleGate(
        "generated:big_env:450", "oracle_big_env_48.exr", 48, 128, 4,
        max_ratio_err=0.03, max_box_rel=2e-2,
    ),
}


def gate_scene_path(gate: OracleGate) -> Path:
    if gate.scene.startswith("generated:"):
        _, kind, *params = gate.scene.split(":")
        return generated_scene(kind, *map(int, params))
    return REPO_ROOT / gate.scene


def oracle_gate(name: str) -> dict:
    """Render the gate's scene at its committed size and spp and compare
    with its oracle image."""
    from pupiloptixlab_tpu.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu.render.integrator import render
    from pupiloptixlab_tpu.scene import load_scene
    from pupiloptixlab_tpu.utils.image import read_exr

    gate = ORACLE_GATES[name]
    scene = load_scene(gate_scene_path(gate))
    scene.sensor.film.w = scene.sensor.film.h = gate.res
    data, config = flatten_scene(scene)
    cam = camera_block_from_scene(scene)
    img = np.asarray(render(data, cam, config, spp=gate.spp))
    oracle = read_exr(ORACLE_DIR / gate.oracle)[::-1][..., :3]

    k = gate.res // gate.box

    def box(a):
        return a.reshape(k, gate.box, k, gate.box, 3).mean((1, 3))

    res = dict(
        mean_ratio=float(img.mean() / oracle.mean()),
        rel_mse=float(np.mean((img - oracle) ** 2) / np.mean(oracle ** 2)),
        box_rel=float(
            np.mean((box(img) - box(oracle)) ** 2) / np.mean(box(oracle) ** 2)
        ),
    )
    assert abs(res["mean_ratio"] - 1.0) < gate.max_ratio_err, (name, res)
    if gate.max_rel_mse is not None:
        assert res["rel_mse"] < gate.max_rel_mse, (name, res)
    assert res["box_rel"] < gate.max_box_rel, (name, res)
    return res


# -- denoise -----------------------------------------------------------------

# float32 filters on two backends differ by exp/reciprocal rounding and
# summation order; 1e-4 relative L2 is ~1000x that noise and far below
# any visible change.
DENOISE_RTOL = 1e-4


def denoise_parity(color, albedo, normal) -> dict:
    """Denoise (h, w, 3) planes on the default device and on the CPU."""
    from pupiloptixlab_tpu.denoise.atrous import atrous_denoise

    dev = np.asarray(atrous_denoise(color, albedo, normal))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ref = np.asarray(atrous_denoise(
            *(jax.device_put(np.asarray(a), cpu) for a in (color, albedo, normal))
        ))
    rel_l2 = float(np.linalg.norm(dev - ref) / max(np.linalg.norm(ref), 1e-30))
    res = dict(rel_l2=rel_l2, finite=bool(np.isfinite(dev).all()))
    assert res["finite"] and rel_l2 < DENOISE_RTOL, res
    return res
