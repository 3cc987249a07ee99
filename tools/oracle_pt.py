"""Independent numpy oracle renderer for end-to-end accuracy parity.

This is deliberately NOT the framework's integrator: a separate
brute-force path tracer (pure BSDF sampling, no NEE, no MIS, no shared
flatten/intersect/BSDF code) whose only commonality with the production
renderer is the XML scene loader. Both estimators converge to the same
integral, so a high-spp render from this file is an external oracle for
the production NEE+MIS estimator — the role BASELINE.md assigns to
"reference PT-with-MIS renders" (mitsuba3 is not installable in this
image; an independent in-repo implementation is the next-best oracle).

Scope (round 3): ALL SEVEN BSDFs — diffuse, dielectric, rough
dielectric, conductor, rough conductor, plastic, rough plastic — plus
triangle/sphere area lights and const/equirect environment emitters
(evaluated on ray escape; the production env NEE/MIS path must converge
to the same image). Usage:

    python tools/oracle_pt.py [scene.xml] --size 64 --spp 8192 \
        --out tests/data/oracle_cornell_64.exr
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


# material type codes (independent of the framework's enum VALUES but
# matching its taxonomy): see scene/materials.py MatType
DIFFUSE, DIELECTRIC, ROUGH_DIELECTRIC = 1, 2, 3
CONDUCTOR, ROUGH_CONDUCTOR, PLASTIC, ROUGH_PLASTIC = 4, 5, 6, 7


def _fdr(eta: float) -> float:
    """Hemispherical diffuse Fresnel reflectance (Egan-Hilgeman /
    d'Eon-Irving published fits; fresnel.h:58-85)."""
    if eta < 1.0:
        return -1.4399 * eta * eta + 0.7099 * eta + 0.6681 + 0.0636 / eta
    ie = 1.0 / eta
    return (0.919317 - 3.4793 * ie + 6.75335 * ie**2 - 7.80989 * ie**3
            + 4.98554 * ie**4 - 1.36881 * ie**5)


def _lum(rgb) -> float:
    return float(0.2126 * rgb[0] + 0.7152 * rgb[1] + 0.0722 * rgb[2])


def _mat_record(ins):
    """Material record dict (everything a bounce needs, numpy scalars)."""
    from pupiloptixlab_tpu.scene.materials import MatType

    mat = ins.material
    rec = dict(
        type=DIFFUSE,
        diff=np.zeros(3, np.float32),   # diffuse / plastic diffuse
        spec=np.ones(3, np.float32),    # specular reflectance
        trans=np.ones(3, np.float32),   # specular transmittance
        alpha=0.0,
        eta3=np.zeros(3, np.float32),   # conductor eta
        k3=np.ones(3, np.float32),      # conductor k
        ior=1.5,                        # int_ior / ext_ior
        int_fdr=0.0,
        ssw=0.0,
        nonlinear=False,
        twosided=bool(mat.twosided),
    )
    t = mat.type
    if t == MatType.DIFFUSE or t == MatType.UNKNOWN:
        rec["type"] = DIFFUSE
        rec["diff"] = np.asarray(mat.reflectance.rgb, np.float32)
    elif t in (MatType.DIELECTRIC, MatType.ROUGH_DIELECTRIC):
        rec["type"] = DIELECTRIC if t == MatType.DIELECTRIC else ROUGH_DIELECTRIC
        rec["ior"] = float(mat.int_ior / mat.ext_ior)
        rec["spec"] = np.asarray(mat.specular_reflectance.rgb, np.float32)
        rec["trans"] = np.asarray(mat.specular_transmittance.rgb, np.float32)
        rec["alpha"] = float(np.asarray(mat.alpha.rgb).reshape(-1)[0])
    elif t in (MatType.CONDUCTOR, MatType.ROUGH_CONDUCTOR):
        rec["type"] = CONDUCTOR if t == MatType.CONDUCTOR else ROUGH_CONDUCTOR
        rec["spec"] = np.asarray(mat.specular_reflectance.rgb, np.float32)
        rec["alpha"] = float(np.asarray(mat.alpha.rgb).reshape(-1)[0])
        rec["eta3"] = np.asarray(mat.eta.rgb, np.float32)
        rec["k3"] = np.asarray(mat.k.rgb, np.float32)
    elif t in (MatType.PLASTIC, MatType.ROUGH_PLASTIC):
        rec["type"] = PLASTIC if t == MatType.PLASTIC else ROUGH_PLASTIC
        rec["ior"] = float(mat.int_ior / mat.ext_ior)
        rec["diff"] = np.asarray(mat.diffuse_reflectance.rgb, np.float32)
        rec["spec"] = np.asarray(mat.specular_reflectance.rgb, np.float32)
        rec["alpha"] = float(np.asarray(mat.alpha.rgb).reshape(-1)[0])
        rec["nonlinear"] = bool(mat.nonlinear)
        dl, sl = _lum(rec["diff"]), _lum(rec["spec"])
        rec["ssw"] = sl / (sl + dl) if (sl + dl) > 0 else 0.0
        rec["int_fdr"] = _fdr(1.0 / rec["ior"])
    return rec


_FIELDS = ("type", "diff", "spec", "trans", "alpha", "eta3", "k3", "ior",
           "int_fdr", "ssw", "nonlinear", "twosided")


def _mat_record_default():
    return dict(
        type=DIFFUSE, diff=np.zeros(3, np.float32),
        spec=np.ones(3, np.float32), trans=np.ones(3, np.float32),
        alpha=0.0, eta3=np.zeros(3, np.float32), k3=np.ones(3, np.float32),
        ior=1.5, int_fdr=0.0, ssw=0.0, nonlinear=False, twosided=False,
    )


def _mat_arrays(recs):
    """List of record dicts -> dict of parallel numpy arrays."""
    out = {}
    for f in _FIELDS:
        vals = [r[f] for r in recs]
        if isinstance(vals[0], np.ndarray):
            out[f] = np.stack(vals).astype(np.float32)
        elif isinstance(vals[0], bool):
            out[f] = np.asarray(vals, bool)
        elif f == "type":
            out[f] = np.asarray(vals, np.int32)
        else:
            out[f] = np.asarray(vals, np.float32)
    return out


def flatten_numpy(scene):
    """Independent world-space flatten (no framework code). Returns
    triangle arrays + material arrays; spheres via flatten_spheres."""
    from pupiloptixlab_tpu.scene.shapes import ShapeType

    tris, recs, emis = [], [], []
    for ins in scene.shape_instances:
        if ins.shape.type == ShapeType.SPHERE:
            continue
        mesh = ins.shape.mesh
        m = ins.transform.matrix
        p = mesh.positions @ m[:3, :3].T + m[:3, 3]
        rec = _mat_record(ins)
        emission = np.zeros(3, np.float32)
        if ins.is_emitter:
            emission = np.asarray(ins.emitter.radiance.rgb, np.float32)
        sign = -1.0 if getattr(ins, "flip_normals", False) else 1.0
        # shading/emission orientation follows the VERTEX normals when the
        # mesh has them (builtin rect/cube windings oppose their stored
        # normals), falling back to the winding normal
        vn = None
        if mesh.normals is not None and len(mesh.normals):
            inv_t = np.linalg.inv(m[:3, :3]).T
            vn = mesh.normals @ inv_t.T
            vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-20)
        for f in mesh.indices:
            p0, p1, p2 = p[f[0]], p[f[1]], p[f[2]]
            n = np.cross(p1 - p0, p2 - p0)
            ln = np.linalg.norm(n)
            if ln < 1e-12:
                continue
            n = n / ln
            if vn is not None:
                # per-vertex normals kept for BARYCENTRIC interpolation
                # at the hit point (production behavior; a face-averaged
                # normal faceted smooth meshes and cost mesh_env ~1%
                # energy / +-10% regional vs the production estimator)
                v0, v1, v2 = vn[f[0]], vn[f[1]], vn[f[2]]
                n = v0 + v1 + v2
                n = n / max(np.linalg.norm(n), 1e-20)
            else:
                v0 = v1 = v2 = n
            tris.append((p0, p1 - p0, p2 - p0, sign * n,
                         sign * v0, sign * v1, sign * v2))
            recs.append(rec)
            emis.append(emission)
    if not tris:
        # one degenerate never-hit row keeps downstream indexing simple
        z = np.zeros((1, 3), np.float32)
        return z, z, z, z, (z, z, z), z, _mat_arrays([_mat_record_default()])
    p0 = np.stack([t[0] for t in tris]).astype(np.float32)
    e1 = np.stack([t[1] for t in tris]).astype(np.float32)
    e2 = np.stack([t[2] for t in tris]).astype(np.float32)
    nrm = np.stack([t[3] for t in tris]).astype(np.float32)
    vns = tuple(
        np.stack([t[k] for t in tris]).astype(np.float32) for k in (4, 5, 6)
    )
    emi = np.stack(emis).astype(np.float32)
    return p0, e1, e2, nrm, vns, emi, _mat_arrays(recs)


def flatten_spheres(scene):
    """(center (S,3), radius (S,), emission (S,3), material arrays)."""
    from pupiloptixlab_tpu.scene.shapes import ShapeType

    cs, rs, emis, recs = [], [], [], []
    for ins in scene.shape_instances:
        if ins.shape.type != ShapeType.SPHERE:
            continue
        m = ins.transform.matrix
        c = m[:3, 3]
        p = (m @ np.array([1.0, 0, 0, 1.0], np.float32))[:3]
        cs.append(c)
        rs.append(float(np.linalg.norm(p - c)))
        emis.append(
            np.asarray(ins.emitter.radiance.rgb, np.float32)
            if ins.is_emitter
            else np.zeros(3, np.float32)
        )
        recs.append(_mat_record(ins))
    if not cs:
        return (np.zeros((0, 3), np.float32), np.zeros(0, np.float32),
                np.zeros((0, 3), np.float32), None)
    return (np.stack(cs).astype(np.float32), np.asarray(rs, np.float32),
            np.stack(emis).astype(np.float32), _mat_arrays(recs))


def build_env(scene):
    """Environment radiance closure rd (N,3) -> rgb (N,3), or None.
    Implements const color and equirect envmap eval (env.h:51-64)
    independently: to-local rotation, phi = pi - atan2(x, z),
    theta = acos(y), half-texel-aligned bilinear, wrap-u / clamp-v."""
    from pupiloptixlab_tpu.scene.emitters import EmitterType

    env = next(
        (e for e in scene.emitters
         if e.type in (EmitterType.CONST_ENV, EmitterType.ENV_MAP)),
        None,
    )
    if env is None:
        return None
    if env.type == EmitterType.CONST_ENV:
        color = np.asarray(env.color, np.float32)

        def const_env(rd):
            return np.broadcast_to(color, (rd.shape[0], 3)).copy()

        return const_env

    img = env.radiance.data[..., :3].astype(np.float32)
    h, w = img.shape[:2]
    scale = float(env.scale)
    to_local = np.linalg.inv(env.transform.matrix[:3, :3]).astype(np.float64)

    def envmap(rd):
        d = rd @ to_local.T
        d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-20)
        phi = np.pi - np.arctan2(d[:, 0], d[:, 2])
        theta = np.arccos(np.clip(d[:, 1], -1.0, 1.0))
        u = phi * 0.5 / np.pi
        v = theta / np.pi
        x = u * w - 0.5
        y = v * h - 0.5
        x0 = np.floor(x).astype(np.int64)
        y0 = np.floor(y).astype(np.int64)
        fx = (x - x0)[:, None]
        fy = (y - y0)[:, None]
        x1 = (x0 + 1) % w
        x0 = x0 % w
        y1 = np.clip(y0 + 1, 0, h - 1)
        y0 = np.clip(y0, 0, h - 1)
        c = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
             + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)
        return c * scale

    return envmap


def intersect_spheres(ro, rd, centers, radii):
    """Closest sphere hit: returns (t, idx) with idx -1 on miss."""
    n = ro.shape[0]
    if len(radii) == 0:
        return np.full(n, 1e16, np.float32), np.full(n, -1, np.int32)
    oc = ro[:, None, :] - centers[None, :, :]
    b = np.einsum("nsj,nj->ns", oc, rd)
    c = np.einsum("nsj,nsj->ns", oc, oc) - radii[None, :] ** 2
    disc = b * b - c
    ok = disc >= 0
    sq = np.sqrt(np.maximum(disc, 0))
    t0 = -b - sq
    t1 = -b + sq
    t = np.where(t0 > 1e-3, t0, t1)
    t = np.where(ok & (t > 1e-3), t, 1e16)
    idx = t.argmin(axis=1).astype(np.int32)
    tb = t[np.arange(n), idx]
    return tb, np.where(tb < 1e16, idx, -1)


def _mt_block(ro, rd, cp0, ce1, ce2):
    """Moller-Trumbore of every (ray, tri) pair: (n,3) x (c,3) ->
    per-pair t with misses at 1e16, shape (n, c)."""
    pv = np.cross(rd[:, None, :], ce2[None, :, :])
    det = np.einsum("tj,ntj->nt", ce1, pv)
    inv = 1.0 / np.where(np.abs(det) < 1e-12, 1e-12, det)
    tv = ro[:, None, :] - cp0[None, :, :]
    u = np.einsum("ntj,ntj->nt", tv, pv) * inv
    qv = np.cross(tv, ce1[None, :, :])
    v = np.einsum("nj,ntj->nt", rd, qv) * inv
    t = np.einsum("tj,ntj->nt", ce2, qv) * inv
    ok = (
        (np.abs(det) >= 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
        & (t > 1e-3) & (t < 1e16)
    )
    return np.where(ok, t, 1e16)


def _expand10(v):
    """Spread 10 bits to every 3rd position (u64)."""
    v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
    return v


_ACCEL_CACHE: dict = {}


def _tri_accel(p0, e1, e2, chunk):
    """Morton-sorted triangle chunks with per-chunk AABBs — the oracle's
    own (independent) coarse culling structure. Brute-force MT still
    tests every triangle of every SURVIVING chunk, so results are
    identical to the flat sweep; chunks whose AABB the ray misses (or
    lies past the running closest hit) are skipped. ~10-30x on the 20k-
    tri mesh scenes that made the flat oracle infeasible (measured:
    15.8 s -> ~1 s per 4096-ray bounce)."""
    key = (id(p0), chunk)
    hit = _ACCEL_CACHE.get(key)
    if hit is not None and hit[0] is p0:
        return hit[1]
    cen = p0 + (e1 + e2) / 3.0
    lo, hi = cen.min(0), cen.max(0)
    q = np.clip(
        (cen - lo) / np.maximum(hi - lo, 1e-12) * 1023.0, 0, 1023
    ).astype(np.uint64)
    morton = (
        (_expand10(q[:, 0]) << np.uint64(2))
        | (_expand10(q[:, 1]) << np.uint64(1))
        | _expand10(q[:, 2])
    )
    perm = np.argsort(morton, kind="stable").astype(np.int64)
    sp0, se1, se2 = p0[perm], e1[perm], e2[perm]
    t = len(perm)
    nk = (t + chunk - 1) // chunk
    blo = np.empty((nk, 3), np.float32)
    bhi = np.empty((nk, 3), np.float32)
    for k in range(nk):
        s = k * chunk
        vs = np.concatenate(
            [sp0[s:s + chunk], sp0[s:s + chunk] + se1[s:s + chunk],
             sp0[s:s + chunk] + se2[s:s + chunk]], 0
        )
        blo[k] = vs.min(0)
        bhi[k] = vs.max(0)
    accel = (perm, sp0, se1, se2, blo, bhi)
    _ACCEL_CACHE[key] = (p0, accel)
    return accel


def intersect(ro, rd, p0, e1, e2, chunk=256):
    """Chunk-culled brute-force Moller-Trumbore; returns (t, tri_index)
    with the ORIGINAL triangle ids (the Morton reorder is internal)."""
    n = ro.shape[0]
    best_t = np.full(n, 1e16, np.float32)
    best_i = np.full(n, -1, np.int64)
    if p0.shape[0] <= chunk:  # tiny scene: one flat block
        t = _mt_block(ro, rd, p0, e1, e2)
        idx = t.argmin(axis=1)
        best_t = t[np.arange(n), idx]
        return best_t, np.where(best_t < 1e16, idx, -1)
    perm, sp0, se1, se2, blo, bhi = _tri_accel(p0, e1, e2, chunk)
    safe = np.where(np.abs(rd) < 1e-12, 1e-12, rd)
    inv = (1.0 / safe).astype(np.float32)
    t0 = (blo[:, None, :] - ro[None, :, :]) * inv[None]  # (K, n, 3)
    t1 = (bhi[:, None, :] - ro[None, :, :]) * inv[None]
    tn = np.minimum(t0, t1).max(axis=2)
    tf = np.maximum(t0, t1).min(axis=2)
    slab = (tn <= tf) & (tf > 1e-3)
    for k in range(blo.shape[0]):
        sel = np.flatnonzero(slab[k] & (tn[k] < best_t))
        if sel.size == 0:
            continue
        s = k * chunk
        t = _mt_block(ro[sel], rd[sel], sp0[s:s + chunk],
                      se1[s:s + chunk], se2[s:s + chunk])
        idx = t.argmin(axis=1)
        tb = t[np.arange(sel.size), idx]
        take = tb < best_t[sel]
        upd = sel[take]
        best_t[upd] = tb[take]
        best_i[upd] = perm[s + idx[take]]
    return best_t, np.where(best_t < 1e16, best_i, -1)


# -- independent BSDF math (local frame, z = shading normal) ----------------

def ggx_sample_vndf_u(wo, alpha, u1, u2):
    """Heitz 2018 VNDF sampling of the half vector in the local frame.
    wo: (N,3) with z up; alpha (N,). Returns m (N,3)."""
    al = np.stack([alpha, alpha, np.ones_like(alpha)], 1)
    v = wo * al
    v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    lensq = v[:, 0] ** 2 + v[:, 1] ** 2
    inv = 1.0 / np.sqrt(np.maximum(lensq, 1e-20))
    t1 = np.where(
        (lensq > 1e-12)[:, None],
        np.stack([-v[:, 1] * inv, v[:, 0] * inv, np.zeros_like(inv)], 1),
        np.array([1.0, 0, 0]),
    )
    t2 = np.cross(v, t1)
    r = np.sqrt(u1)
    phi = 2 * np.pi * u2
    p1 = r * np.cos(phi)
    p2 = r * np.sin(phi)
    ss = 0.5 * (1 + v[:, 2])
    p2 = (1 - ss) * np.sqrt(np.maximum(1 - p1 * p1, 0)) + ss * p2
    p3 = np.sqrt(np.maximum(1 - p1 * p1 - p2 * p2, 0))
    nh = p1[:, None] * t1 + p2[:, None] * t2 + p3[:, None] * v
    m = nh * al
    m[:, 2] = np.maximum(m[:, 2], 1e-6)
    m /= np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-12)
    return m


def ggx_g1(w, alpha):
    """Smith G1 for isotropic GGX, local frame (alpha per lane)."""
    cos2 = np.clip(w[:, 2] ** 2, 1e-12, 1.0)
    tan2 = (1.0 - cos2) / cos2
    return 2.0 / (1.0 + np.sqrt(1.0 + alpha * alpha * tan2))


def ggx_d(m, alpha):
    a2 = np.maximum(alpha * alpha, 1e-12)
    t = (m[:, 0] ** 2 + m[:, 1] ** 2) / a2 + m[:, 2] ** 2
    return 1.0 / np.maximum(np.pi * a2 * t * t, 1e-20)


def ggx_pdf_vndf(wo, m, alpha):
    """D G1(wo) <wo,m> / wo.z (half-vector density)."""
    wom = np.einsum("nj,nj->n", wo, m)
    return ggx_d(m, alpha) * ggx_g1(wo, alpha) * np.maximum(wom, 0.0) \
        / np.maximum(np.abs(wo[:, 2]), 1e-12)


def fresnel_conductor_rgb(cos_i, eta, k):
    """RGB conductor Fresnel (cos_i (N,), eta/k (N,3))."""
    c2 = (cos_i ** 2)[:, None]
    s2 = 1.0 - c2
    e2 = eta ** 2
    k2 = k ** 2
    t0 = e2 - k2 - s2
    a2b2 = np.sqrt(np.maximum(t0 ** 2 + 4 * e2 * k2, 0.0))
    t1 = a2b2 + c2
    a = np.sqrt(np.maximum(0.5 * (a2b2 + t0), 0.0))
    t2 = 2 * a * np.sqrt(c2)
    rs = (t1 - t2) / np.maximum(t1 + t2, 1e-12)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / np.maximum(t3 + t4, 1e-12)
    return 0.5 * (np.clip(rs, 0.0, 1.0) + np.clip(rp, 0.0, 1.0))


def fresnel_dielectric(eta, cos_i):
    """Exact dielectric Fresnel with signed cosines; returns (F, cos_t)
    where cos_t carries the opposite sign to cos_i (0 on TIR)."""
    scale = np.where(cos_i > 0.0, 1.0 / eta, eta)
    cos_t2 = 1.0 - (1.0 - cos_i * cos_i) * scale * scale
    tir = cos_t2 <= 0.0
    ci = np.abs(cos_i)
    ct = np.sqrt(np.maximum(cos_t2, 0.0))
    rs = (ci - eta * ct) / np.maximum(ci + eta * ct, 1e-20)
    rp = (eta * ci - ct) / np.maximum(eta * ci + ct, 1e-20)
    f = 0.5 * (rs * rs + rp * rp)
    cos_t = np.where(cos_i > 0.0, -ct, ct)
    return np.where(tir, 1.0, f), np.where(tir, 0.0, cos_t)


def _onb(n):
    s = np.where(n[:, 2] >= 0, 1.0, -1.0)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t0 = np.stack([1 + s * n[:, 0] ** 2 * a, s * b, -s * n[:, 0]], 1)
    t1 = np.stack([b, s + n[:, 1] ** 2 * a, -n[:, 1]], 1)
    return t0, t1


def _reflect_z(wo):
    return np.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], 1)


def _reflect_m(wo, m):
    d = 2.0 * np.einsum("nj,nj->n", wo, m)
    return d[:, None] * m - wo


def _refract_z(wo, cos_t, eta):
    scale = -np.where(cos_t < 0.0, 1.0 / eta, eta)
    wi = np.stack([scale * wo[:, 0], scale * wo[:, 1], cos_t], 1)
    return wi / np.maximum(np.linalg.norm(wi, axis=1, keepdims=True), 1e-12)


def _refract_m(wo, m, cos_t, eta):
    e = np.where(cos_t < 0.0, 1.0 / eta, eta)
    k = np.einsum("nj,nj->n", wo, m) * e + cos_t
    return k[:, None] * m - e[:, None] * wo


def _cosine_local(u1, u2):
    r = np.sqrt(u1)
    phi = 2 * np.pi * u2
    return np.stack(
        [r * np.cos(phi), r * np.sin(phi), np.sqrt(np.maximum(1 - u1, 0.0))], 1
    )


def sample_bsdf(mats, sel, wo, u1, u2, u3):
    """Pure BSDF sampling over all 7 types: returns (wi (N,3) local,
    weight (N,3) = f cos / pdf). ``sel`` indexes the material arrays,
    ``wo`` is local (z = shading normal, already twosided-flipped for
    everything except dielectrics, which use the true-normal frame)."""
    n = wo.shape[0]
    typ = mats["type"][sel]
    alpha = mats["alpha"][sel]
    ior = mats["ior"][sel]
    spec = mats["spec"][sel]
    trans = mats["trans"][sel]
    diff = mats["diff"][sel]
    wi = np.zeros((n, 3), np.float64)
    weight = np.zeros((n, 3), np.float64)

    # --- diffuse: cosine; weight = albedo --------------------------------
    d_mask = typ == DIFFUSE
    if d_mask.any():
        wi_d = _cosine_local(u1, u2)
        w_d = np.where((wo[:, 2] > 0)[:, None], diff, 0.0)
        wi = np.where(d_mask[:, None], wi_d, wi)
        weight = np.where(d_mask[:, None], w_d, weight)

    # --- smooth conductor: mirror; weight = spec * F ---------------------
    c_mask = typ == CONDUCTOR
    if c_mask.any():
        f = fresnel_conductor_rgb(
            np.maximum(wo[:, 2], 0.0), mats["eta3"][sel], mats["k3"][sel]
        )
        wi_c = _reflect_z(wo)
        w_c = np.where((wo[:, 2] > 0)[:, None], spec * f, 0.0)
        wi = np.where(c_mask[:, None], wi_c, wi)
        weight = np.where(c_mask[:, None], w_c, weight)

    # --- rough conductor: VNDF; weight = spec * F(wo.m) * G1(wi) --------
    rc_mask = typ == ROUGH_CONDUCTOR
    if rc_mask.any():
        m = ggx_sample_vndf_u(wo, alpha, u1, u2)
        wom = np.einsum("nj,nj->n", wo, m)
        wi_rc = _reflect_m(wo, m)
        f = fresnel_conductor_rgb(
            np.maximum(wom, 0.0), mats["eta3"][sel], mats["k3"][sel]
        )
        ok = (wi_rc[:, 2] > 1e-6) & (wo[:, 2] > 1e-6) & (wom > 0)
        w_rc = np.where(
            ok[:, None], spec * f * ggx_g1(wi_rc, alpha)[:, None], 0.0
        )
        wi = np.where(rc_mask[:, None], wi_rc, wi)
        weight = np.where(rc_mask[:, None], w_rc, weight)

    # --- smooth dielectric: Fresnel lobe choice --------------------------
    sd_mask = typ == DIELECTRIC
    if sd_mask.any():
        f, cos_t = fresnel_dielectric(ior, wo[:, 2])
        refl = u3 < f
        factor = np.where(cos_t < 0.0, 1.0 / np.maximum(ior, 1e-12), ior)
        wi_sd = np.where(
            refl[:, None], _reflect_z(wo), _refract_z(wo, cos_t, ior)
        )
        w_sd = np.where(refl[:, None], spec, trans * (factor ** 2)[:, None])
        wi = np.where(sd_mask[:, None], wi_sd, wi)
        weight = np.where(sd_mask[:, None], w_sd, weight)

    # --- rough dielectric: VNDF m + Fresnel lobe choice ------------------
    rd_mask = typ == ROUGH_DIELECTRIC
    if rd_mask.any():
        sgn = np.where(wo[:, 2] > 0.0, 1.0, -1.0)
        wo_up = wo * sgn[:, None]
        # the half vector stays in the UPPER hemisphere even for
        # inside-out rays (Walter convention; rough_dielectric.h:74-97
        # samples around the flipped wo but never flips wh back)
        m = ggx_sample_vndf_u(wo_up, alpha, u1, u2)
        wom = np.einsum("nj,nj->n", wo, m)
        f, cos_t = fresnel_dielectric(ior, wom)
        refl = u3 < f
        wi_r = _reflect_m(wo, m)
        wi_t = _refract_m(wo, m, cos_t, ior)
        wi_rd = np.where(refl[:, None], wi_r, wi_t)
        # Walter MC weight for separable Smith: G(wi,wo)/G1(wo) = G1(wi)
        # (G1 is z-sign symmetric); transmission adds the
        # radiance-transport 1/eta_w^2 (the framework's refract factor^2
        # with factor = 1/eta_w)
        g1wi = ggx_g1(wi_rd, alpha)
        eta_w = np.where(cos_t < 0.0, ior, 1.0 / np.maximum(ior, 1e-12))
        ok_r = wi_rd[:, 2] * wo[:, 2] > 0
        ok_t = (np.abs(cos_t) > 1e-6) & (wi_rd[:, 2] * wo[:, 2] < 0)
        w_rd = np.where(
            refl[:, None],
            np.where(ok_r[:, None], spec * g1wi[:, None], 0.0),
            np.where(
                ok_t[:, None],
                trans * (g1wi / eta_w**2)[:, None],
                0.0,
            ),
        )
        wi = np.where(rd_mask[:, None], wi_rd, wi)
        weight = np.where(rd_mask[:, None], w_rd, weight)

    # --- plastic family --------------------------------------------------
    for tcode, rough in ((PLASTIC, False), (ROUGH_PLASTIC, True)):
        p_mask = typ == tcode
        if not p_mask.any():
            continue
        ssw = mats["ssw"][sel]
        int_fdr = mats["int_fdr"][sel]
        nonlinear = mats["nonlinear"][sel]
        f_o, _ = fresnel_dielectric(ior, wo[:, 2])
        num = f_o * ssw
        sp = num / np.maximum(num + (1.0 - f_o) * (1.0 - ssw), 1e-12)
        take_spec = u3 < sp
        wi_diff = _cosine_local(u1, u2)
        if rough:
            m = ggx_sample_vndf_u(wo, alpha, u1, u2)
            wi_spec = _reflect_m(wo, m)
        else:
            wi_spec = _reflect_z(wo)
        wi_p = np.where(take_spec[:, None], wi_spec, wi_diff)
        f_i, _ = fresnel_dielectric(ior, wi_p[:, 2])
        base = np.where(
            nonlinear[:, None],
            diff / np.maximum(1.0 - diff * int_fdr[:, None], 1e-12),
            diff / np.maximum(1.0 - int_fdr, 1e-12)[:, None],
        )
        diff_f = base * ((1.0 - f_i) * (1.0 - f_o) / np.pi
                         / np.maximum(ior**2, 1e-12))[:, None]
        cos_pdf = np.maximum(wi_p[:, 2], 0.0) / np.pi
        if rough:
            # mixture pdf: f and pdf both carry spec + diffuse terms
            wh = wi_p + wo
            wh /= np.maximum(np.linalg.norm(wh, axis=1, keepdims=True), 1e-12)
            f_h, _ = fresnel_dielectric(
                ior, np.einsum("nj,nj->n", wh, wo)
            )
            spec_f = spec * (f_h * ggx_d(wh, alpha)
                             * ggx_g1(wi_p, alpha) * ggx_g1(wo, alpha)
                             / np.maximum(4.0 * wo[:, 2] * wi_p[:, 2], 1e-12)
                             )[:, None]
            pdf_spec = ggx_pdf_vndf(wo, wh, alpha) / np.maximum(
                4.0 * np.einsum("nj,nj->n", wi_p, wh), 1e-12
            )
            f_all = spec_f + diff_f
            pdf = sp * pdf_spec + (1.0 - sp) * cos_pdf
            w_p = f_all * (wi_p[:, 2] / np.maximum(pdf, 1e-12))[:, None]
        else:
            w_spec = spec * (f_o / np.maximum(sp, 1e-12))[:, None]
            w_diff = diff_f * (np.pi / np.maximum(1.0 - sp, 1e-12))[:, None]
            w_p = np.where(take_spec[:, None], w_spec, w_diff)
        ok = (wo[:, 2] > 0) & (wi_p[:, 2] > 0)
        w_p = np.where(ok[:, None], w_p, 0.0)
        wi = np.where(p_mask[:, None], wi_p, wi)
        weight = np.where(p_mask[:, None], w_p, weight)

    return wi, np.maximum(weight, 0.0)


def render_oracle(scene, size, spp, max_depth, seed=0, batch=16,
                  progress=True, ckpt=None):
    p0, e1, e2, nrm, (vn0, vn1, vn2), emi, tmats = flatten_numpy(scene)
    s_c, s_r, s_emi, smats = flatten_spheres(scene)
    env_fn = build_env(scene)
    w = h = size
    cam_to_world = scene.sensor.transform.matrix.astype(np.float64)

    # camera rays exactly like util/camera.cpp: sample->camera->world
    from pupiloptixlab_tpu.utils.camera import Camera, CameraDesc
    from pupiloptixlab_tpu.utils.math import Transform

    cam = Camera(
        CameraDesc(
            fov_y=scene.sensor.fov,
            aspect_ratio=1.0,
            near_clip=scene.sensor.near_clip,
            far_clip=scene.sensor.far_clip,
            to_world=Transform(cam_to_world.astype(np.float32)),
        )
    )
    s2c = cam.sample_to_camera.astype(np.float64)
    c2w = cam.to_world.astype(np.float64)

    rng = np.random.default_rng(seed)
    accum = np.zeros((h * w, 3), np.float64)
    done = 0
    # Multi-hour renders on this 1-core host survive session restarts
    # through an accumulation checkpoint: (accum, done, RNG state)
    # saved per batch, restored on relaunch. Restoring the Generator's
    # bit state makes the resumed render bit-identical to an
    # uninterrupted one.
    if ckpt is not None:
        import json as _json

        p = Path(ckpt)
        if p.exists():
            d = np.load(p, allow_pickle=False)
            if int(d["size"]) == size and int(d["seed"]) == seed:
                accum = d["accum"].astype(np.float64)
                done = int(d["done"])
                rng.bit_generator.state = _json.loads(str(d["rng_state"]))
                if progress:
                    print(f"  resumed at {done}/{spp} spp", flush=True)
    while done < spp:
        cur = min(batch, spp - done)
        for _ in range(cur):
            px = np.arange(w * h) % w
            py = np.arange(w * h) // w
            jx = rng.random(w * h)
            jy = rng.random(w * h)
            sx = (px + jx) / w
            sy = (py + jy) / h
            ndc = np.stack([sx, sy, np.zeros_like(sx), np.ones_like(sx)], 1)
            pc = ndc @ s2c.T
            pc = pc[:, :3] / pc[:, 3:4]
            d = pc / np.linalg.norm(pc, axis=1, keepdims=True)
            rd = (np.concatenate([d, np.zeros((len(d), 1))], 1) @ c2w.T)[:, :3]
            rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
            ro = np.broadcast_to(
                c2w[:3, 3].astype(np.float32), rd.shape
            ).copy()

            radiance = np.zeros((h * w, 3), np.float64)
            throughput = np.ones((h * w, 3), np.float64)
            alive = np.ones(h * w, bool)
            for depth in range(max_depth):
                # trace only ALIVE rays (env scenes kill most lanes by
                # escape after bounce 1); dead lanes report a miss,
                # which every consumer below already gates on ``alive``
                live = np.flatnonzero(alive)
                t = np.full(h * w, 1e16, np.float32)
                idx = np.full(h * w, -1, np.int64)
                ts = np.full(h * w, 1e16, np.float32)
                isx = np.full(h * w, -1, np.int32)
                t[live], idx[live] = intersect(ro[live], rd[live], p0, e1, e2)
                ts[live], isx[live] = intersect_spheres(
                    ro[live], rd[live], s_c, s_r
                )
                use_s = (isx >= 0) & (ts < t)
                hit = (idx >= 0) | use_s
                # escaped rays collect the environment once and die
                if env_fn is not None:
                    esc = alive & ~hit
                    if esc.any():
                        radiance[esc] += throughput[esc] * env_fn(rd[esc])
                alive = alive & hit
                if not alive.any():
                    break
                i = np.maximum(idx, 0)
                si = np.maximum(isx, 0)
                t = np.where(use_s, ts, t)
                pos = ro + t[:, None] * rd

                def pick(field):
                    tv = tmats[field][i]
                    if smats is None:
                        return tv
                    sv = smats[field][si]
                    cond = use_s
                    if tv.ndim == 2:
                        cond = use_s[:, None]
                    return np.where(cond, sv, tv)

                # barycentric shading normal (matches production;
                # face-constant meshes are unchanged). (u, v) recovered
                # from the hit point via the edge Gram system.
                dvec = pos - p0[i]
                a11 = np.einsum("nj,nj->n", e1[i], e1[i])
                a12 = np.einsum("nj,nj->n", e1[i], e2[i])
                a22 = np.einsum("nj,nj->n", e2[i], e2[i])
                b1 = np.einsum("nj,nj->n", dvec, e1[i])
                b2 = np.einsum("nj,nj->n", dvec, e2[i])
                det = np.maximum(a11 * a22 - a12 * a12, 1e-20)
                bu = np.clip((b1 * a22 - b2 * a12) / det, 0.0, 1.0)
                bv = np.clip((b2 * a11 - b1 * a12) / det, 0.0, 1.0)
                n_t = ((1.0 - bu - bv)[:, None] * vn0[i]
                       + bu[:, None] * vn1[i] + bv[:, None] * vn2[i])
                n_t = n_t / np.maximum(
                    np.linalg.norm(n_t, axis=1, keepdims=True), 1e-20
                )
                if len(s_r):
                    n_s = (pos - s_c[si]) / np.maximum(s_r[si][:, None], 1e-12)
                    n = np.where(use_s[:, None], n_s, n_t)
                    cur_emi = np.where(use_s[:, None], s_emi[si], emi[i])
                else:
                    n = n_t
                    cur_emi = emi[i]
                typ = pick("type")
                twosided = pick("twosided")

                # twosided flip; dielectrics always use the true normal
                # (signed cosines drive Fresnel + refraction)
                backside = np.einsum("nj,nj->n", n, rd) > 0
                is_diel = (typ == DIELECTRIC) | (typ == ROUGH_DIELECTRIC)
                flip = backside & twosided & ~is_diel
                n_sh = np.where(flip[:, None], -n, n)
                # one-sided emission: only when the stored normal faces
                # the ray (render/emitter.h Eval: lnol > 0)
                front = ~backside
                radiance += np.where(
                    (alive & front)[:, None], throughput * cur_emi, 0.0
                )

                u1 = rng.random(h * w, dtype=np.float64)
                u2 = rng.random(h * w, dtype=np.float64)
                u3 = rng.random(h * w, dtype=np.float64)
                t0, t1 = _onb(n_sh)
                wo_world = -rd
                wo = np.stack([
                    np.einsum("nj,nj->n", wo_world, t0),
                    np.einsum("nj,nj->n", wo_world, t1),
                    np.einsum("nj,nj->n", wo_world, n_sh),
                ], 1)

                sel_t = np.maximum(idx, 0)
                sel_s = np.maximum(isx, 0)
                # merge material arrays by hit kind
                merged = {}
                for fld in _FIELDS:
                    tv = tmats[fld][sel_t]
                    if smats is not None:
                        sv = smats[fld][sel_s]
                        cond = use_s[:, None] if tv.ndim == 2 else use_s
                        tv = np.where(cond, sv, tv)
                    merged[fld] = tv
                wi, weight = sample_bsdf(
                    merged, np.arange(h * w), wo, u1, u2, u3
                )
                throughput = throughput * np.where(alive[:, None], weight, 1.0)
                rd = (
                    wi[:, 0:1] * t0 + wi[:, 1:2] * t1 + wi[:, 2:3] * n_sh
                ).astype(np.float32)
                rd /= np.maximum(np.linalg.norm(rd, axis=1, keepdims=True), 1e-12)
                # offset along the travel side (transmission goes below)
                side = np.where(
                    np.einsum("nj,nj->n", rd, n) >= 0, 1.0, -1.0
                )
                ro = pos + n * side[:, None] * 1e-3
                alive = alive & (throughput.max(axis=1) > 1e-6)
            accum += radiance
        done += cur
        if ckpt is not None:
            import json as _json

            tmp = Path(str(ckpt) + ".tmp")
            np.savez(
                tmp, accum=accum, done=np.int64(done),
                size=np.int64(size), seed=np.int64(seed),
                rng_state=_json.dumps(rng.bit_generator.state),
            )
            # np.savez appends .npz to paths without it
            src = tmp if tmp.exists() else Path(str(tmp) + ".npz")
            src.replace(ckpt)
        if progress:
            print(f"  {done}/{spp} spp", flush=True)
    img = (accum / spp).reshape(h, w, 3).astype(np.float32)
    return img


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--spp", type=int, default=8192)
    ap.add_argument("--max-depth", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="tests/data/oracle_cornell_64.exr")
    ap.add_argument(
        "--ckpt", default=None,
        help="accumulation-checkpoint path (default: <out>.ckpt.npz); "
             "'none' disables",
    )
    args = ap.parse_args()

    from pupiloptixlab_tpu.scene import load_scene
    from pupiloptixlab_tpu.utils.image import save_image

    ckpt = args.ckpt
    if ckpt is None:
        ckpt = args.out + ".ckpt.npz"
    elif ckpt.lower() == "none":
        ckpt = None

    scene = load_scene(args.scene)
    img = render_oracle(scene, args.size, args.spp, args.max_depth,
                        seed=args.seed, ckpt=ckpt)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    save_image(args.out, img[::-1])
    print(f"saved {args.out} mean={img.mean():.5f}")


if __name__ == "__main__":
    main()
