"""Device-side scene data model: static-shape structure-of-arrays pytrees.

These arrays replace the reference's GPU-resident objects:

* ``TextureTable``  <- cuda::Texture / CudaTextureManager (cuda/texture.h):
  a dense descriptor table + one flat pixel pool (software sampling
  replaces hardware texture units).
* ``MaterialTable`` <- optix::material::Material + the SBT direct-callable
  dispatch (render/material/optix_material.h): dense per-material params
  with texture-slot ids; shading dispatches branchlessly on ``mtype``.
* ``TriSoup`` / ``Spheres`` <- GAS/IAS + per-RenderObject HitGroupData:
  world-space flattened primitives with per-primitive material/emitter ids
  (instead of instance transforms + SBT record offsets).
* ``EmitterTable`` <- optix::EmitterGroup (render/emitter.h) with the same
  per-triangle area-light flattening and selection CDF.
* ``CameraBlock``  <- optix::Camera (render/camera.h).

All leaves are jnp arrays with shapes fixed per scene (padded), so one jit
trace serves every frame. Static metadata lives in ``RenderConfig``.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import jax
import jax.numpy as jnp


def _register(cls):
    data = [f.name for f in fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=[])
    return cls


# --- packed-row column layouts (one row gather fetches every column) ------
# TriSoup.attrs (T, 26): per-hit attributes fetched in one gather.
# Cols 17:26 mirror packed[:, 0:9] (p0, e1, e2) so barycentrics are
# recomputed INSIDE get_local_geometry from the same gather instead of
# a second 9-col gather per closest sweep (~6-8 ms each at 1080p).
TRI_N0, TRI_N1, TRI_N2 = slice(0, 3), slice(3, 6), slice(6, 9)
TRI_UV0, TRI_UV1, TRI_UV2 = slice(9, 11), slice(11, 13), slice(13, 15)
TRI_MAT, TRI_EMITTER = 15, 16
TRI_P0, TRI_E1, TRI_E2 = slice(17, 20), slice(20, 23), slice(23, 26)
TRI_ATTR_COLS = 26

# MaterialTable.packed (M, 16)
MAT_TYPE, MAT_TWOSIDED, MAT_ETA, MAT_INT_FDR, MAT_SSW, MAT_NONLINEAR = range(6)
MAT_TEX0 = 6  # 6 texture-slot ids follow
MAT_ANISO = 12  # 1.0 = the alpha texture's r/g hold (alpha_u, alpha_v)
MAT_DISPERSION = 13  # Cauchy B (um^2) for spectral dielectrics; 0 = none
MAT_COLS = 16

# TextureTable.packed (K, 24)
TEX_KIND = 0
TEX_RGB, TEX_PATCH2 = slice(1, 4), slice(4, 7)
TEX_UVT = slice(7, 13)  # row-major (2,3)
TEX_OFFSET, TEX_W, TEX_H, TEX_FILTER, TEX_ADDRESS = 13, 14, 15, 16, 17
TEX_OFFSET_BI = 18  # row offset into pool_bi (2x2 quad rows, see texture.py)
TEX_COLS = 24

# EmitterTable.packed (E, 32)
EM_V0P, EM_V1P, EM_V2P = slice(0, 3), slice(3, 6), slice(6, 9)
EM_V0N, EM_V1N, EM_V2N = slice(9, 12), slice(12, 15), slice(15, 18)
EM_V0T, EM_V1T, EM_V2T = slice(18, 20), slice(20, 22), slice(22, 24)
EM_RADIUS, EM_AREA, EM_SELECT_PROB, EM_RAD_TEX, EM_ETYPE = 24, 25, 26, 27, 28
EM_COLS = 32

# Texture slot assignments within MaterialTable.tex (column index):
SLOT_REFLECTANCE = 0        # diffuse reflectance / plastic diffuse
SLOT_SPECULAR = 1           # specular reflectance
SLOT_TRANSMITTANCE = 2      # specular transmittance
SLOT_ETA = 3                # conductor eta (rgb)
SLOT_K = 4                  # conductor k (rgb)
SLOT_ALPHA = 5              # roughness
N_SLOTS = 6


@_register
@dataclass
class TextureTable:
    packed: jnp.ndarray        # (K, TEX_COLS) f32 packed descriptors
    kind: jnp.ndarray          # (K,) i32: 0 rgb, 1 checkerboard, 2 bitmap
    rgb: jnp.ndarray           # (K,3) f32: rgb color / checker patch1
    patch2: jnp.ndarray        # (K,3) f32: checker patch2
    uv_transform: jnp.ndarray  # (K,2,3) f32: [u';v'] = M @ [u,v,1]
    offset: jnp.ndarray        # (K,) i32 into pool
    width: jnp.ndarray         # (K,) i32
    height: jnp.ndarray        # (K,) i32
    filter_mode: jnp.ndarray   # (K,) i32: 0 point, 1 linear
    address_mode: jnp.ndarray  # (K,) i32: 0 wrap, 1 clamp, 2 mirror
    pool: jnp.ndarray          # (P,3) f32 pixel pool (row-major per image)
    pool_bi: jnp.ndarray       # (Q,12) f32 2x2 quad pool: row (yq,xq) of a
                               # (w+1,h+1) grid holds the clamped bilinear
                               # footprint [c00 c10 c01 c11] for origin
                               # (xq-1, yq-1); (1,12) dummy when disabled


@_register
@dataclass
class MaterialTable:
    packed: jnp.ndarray     # (M, MAT_COLS) f32 packed params
    mtype: jnp.ndarray      # (M,) i32 (MatType)
    twosided: jnp.ndarray   # (M,) bool
    tex: jnp.ndarray        # (M, N_SLOTS) i32 texture ids
    eta: jnp.ndarray        # (M,) f32 int_ior/ext_ior
    int_fdr: jnp.ndarray    # (M,) f32 internal diffuse fresnel reflectance
    ssw: jnp.ndarray        # (M,) f32 specular sampling weight
    nonlinear: jnp.ndarray  # (M,) bool


@_register
@dataclass
class TriSoup:
    """World-space triangle table. Geometry lives ONCE in ``packed``
    (the sweep/BVH kernels' input; barycentrics re-derive positions) and
    hit attributes once in ``attrs`` — no redundant per-plane copies.

    The BVH arrays are the GAS analog (world/gas_manager.cpp:61-185):
    8-wide node tables built (and triangle rows reordered) by
    accel/bvh.py. Empty (minimal shapes) when the scene has no BVH
    (config.bvh_nodes == 0: no triangles, or PUPIL_NO_BVH).
    """

    packed: jnp.ndarray  # (T,12) [p0, e1, e2, pad] rows (sweep/traversal)
    attrs: jnp.ndarray   # (T, TRI_ATTR_COLS) hit attributes (see layout above)
    mat_id: jnp.ndarray      # (T,) i32
    emitter_id: jnp.ndarray  # (T,) i32; -1 = not an emitter
    bvh_child: jnp.ndarray   # (M*8,) i32; >=0 child node, <0 leaf start
    bvh_boxes: jnp.ndarray   # (M*8, 8) f32 child AABB rows
    # --- device-side instancing (config.instanced; the GAS-reuse half
    # of the two-level accel, world/gas_manager.cpp:10-27): ``packed`` /
    # ``attrs`` hold UNIQUE OBJECT-space rows (one copy per shape, HBM
    # O(unique)), the world BVH's leaves index (leaf_start, leaf_inst),
    # and the traversal transforms rays into object space per leaf
    # (t stays the world parameter: directions are NOT renormalized).
    # Minimal (1-row) placeholders when instanced is off.
    leaf_start: jnp.ndarray  # (L,) i32 tcl-aligned row start per world leaf
    leaf_inst: jnp.ndarray   # (L,) i32 instance per world leaf
    inst_w2o: jnp.ndarray    # (I, 12) f32 world->object 3x4 row-major
    inst_packed: jnp.ndarray  # (I, INST_COLS) f32 shading row (see below)


# Spheres.attrs (S, 16): w2o rows flat (12), mat_id, emitter_id, flip
SPH_W2O = slice(0, 12)
SPH_MAT, SPH_EMITTER, SPH_FLIP = 12, 13, 14
SPH_COLS = 16

# TriSoup.inst_packed (I, 16): per-instance shading row (instanced mode)
INST_NRM = slice(0, 9)   # normal matrix: inverse-transpose 3x3 row-major,
                         # flip_normals sign folded in
INST_MAT = 9             # material id
INST_EMIT_BASE = 10      # emitter table base (-1 = not an emitter); the
                         # hit's emitter_id = base + attrs[TRI_EMITTER]
                         # (which holds the shape-local face index)
INST_W2O0 = 11           # unused (w2o lives in its own table)
INST_COLS = 16


@_register
@dataclass
class Spheres:
    attrs: jnp.ndarray  # (S, SPH_COLS) packed per-sphere attributes
    o2w: jnp.ndarray  # (S,3,4) object(unit sphere)->world
    w2o: jnp.ndarray  # (S,3,4)
    mat_id: jnp.ndarray
    emitter_id: jnp.ndarray
    flip_normal: jnp.ndarray  # (S,) bool


# Curves.packed (C, 12): segment endpoints + radii + ids
CRV_P0 = slice(0, 3)
CRV_R0 = 3
CRV_P1 = slice(4, 7)
CRV_R1 = 7
CRV_MAT = 8
CRV_UV0, CRV_UV1 = 9, 10  # curve-parameter interval of this segment
CRV_COLS = 12


@_register
@dataclass
class Curves:
    """Round-curve SEGMENT table (rounded cones between consecutive
    tessellated control points — the optix built-in curve IS analog,
    module.h:20-29; higher degrees tessellate at flatten time)."""

    packed: jnp.ndarray  # (C, CRV_COLS) f32


@_register
@dataclass
class EmitterTable:
    """Area emitters (triangles + spheres) + the environment emitter."""

    packed: jnp.ndarray   # (E, EM_COLS) f32 packed emitter rows
    etype: jnp.ndarray    # (E,) i32: 0 tri-area, 1 sphere
    v0p: jnp.ndarray      # (E,3); sphere: world center
    v1p: jnp.ndarray
    v2p: jnp.ndarray
    v0n: jnp.ndarray      # (E,3)
    v1n: jnp.ndarray
    v2n: jnp.ndarray
    v0t: jnp.ndarray      # (E,2)
    v1t: jnp.ndarray
    v2t: jnp.ndarray
    radius: jnp.ndarray        # (E,) sphere radius
    area: jnp.ndarray          # (E,)
    select_prob: jnp.ndarray   # (E,)
    select_cdf: jnp.ndarray    # (E,) inclusive cumsum of select_prob
    radiance_tex: jnp.ndarray  # (E,) i32

    # environment emitter (scalars / small arrays; zero-size if none)
    env_type: jnp.ndarray       # () i32: 0 none, 1 const, 2 envmap
    env_color: jnp.ndarray      # (3,)
    env_center: jnp.ndarray     # (3,) scene aabb center
    env_to_world: jnp.ndarray   # (3,3)
    env_to_local: jnp.ndarray   # (3,3)
    env_radiance_tex: jnp.ndarray  # () i32
    env_row_cdf: jnp.ndarray    # (H+1,)
    env_col_cdf: jnp.ndarray    # (H, W+1)
    env_joint_cdf: jnp.ndarray  # (H*W,) inclusive joint CDF (lum * sin row)
    env_row_weight: jnp.ndarray  # (H,)
    env_normalization: jnp.ndarray  # () f32
    env_scale: jnp.ndarray      # () f32
    env_select_prob: jnp.ndarray  # () f32


@_register
@dataclass
class CameraBlock:
    sample_to_camera: jnp.ndarray  # (4,4)
    camera_to_world: jnp.ndarray   # (4,4)


@_register
@dataclass
class SceneData:
    tris: TriSoup
    spheres: Spheres
    curves: Curves
    materials: MaterialTable
    textures: TextureTable
    emitters: EmitterTable


@dataclass(frozen=True)
class RenderConfig:
    """Static (trace-time) render settings — hashable jit companion."""

    width: int
    height: int
    max_depth: int = 2
    accumulate: bool = True
    spp_per_pass: int = 1
    tri_count: int = 0       # valid (unpadded) triangle count
    sphere_count: int = 0
    curve_count: int = 0     # round-curve segments (tessellated)
    emitter_count: int = 0
    has_env: bool = False
    env_size: tuple[int, int] = (0, 0)  # (w, h) of the env map
    # Scene-specialization sets: the integrator only emits code for the
    # material types / texture kinds that actually occur, which shrinks
    # the compiled program dramatically (the SBT-specialization analog).
    mat_types: tuple[int, ...] = tuple(range(1, 8))
    tex_kinds: tuple[int, ...] = (0, 1, 2)
    # Per-call-site texture specialization: the kinds/filter modes
    # reachable from material texture slots vs area-emitter radiance
    # textures. Without this split, one bitmap anywhere (e.g. an env
    # map) makes EVERY texture sample emit 5 pixel-pool gathers — at
    # 2M lanes each big-pool gather is ~11 ms, so a constant-RGB
    # material fetch would cost more than the BVH traversal.
    # Filters: 0 point, 1 bilinear; both present -> runtime select.
    mat_tex_kinds: tuple[int, ...] = (0, 1, 2)
    mat_tex_filters: tuple[int, ...] = (0, 1)
    em_tex_kinds: tuple[int, ...] = (0, 1, 2)
    em_tex_filters: tuple[int, ...] = (0, 1)
    env_filter: int = 1
    has_sphere_emitter: bool = True
    has_point_emitter: bool = False
    has_directional_emitter: bool = False
    # BVH traversal: node count + leaf size; 0 = no triangles, or the
    # brute-force sweep forced by PUPIL_NO_BVH.
    bvh_nodes: int = 0
    bvh_tcl: int = 0
    # Device-side instancing: the tri/attr tables hold unique object-
    # space rows, the BVH's leaves carry (row start, instance) and the
    # traversal transforms rays per leaf. Chosen by flatten when the
    # instancing duplication ratio makes it worthwhile.
    instanced: bool = False
    # Value sanitizer (utils/debug.py): compile NaN/Inf stage checks
    # into the frame — the OptiX debug-exception-flags analog
    # (optix/pipeline.cpp:19; a pipeline COMPILE option there too).
    debug_checks: bool = False
    # Hero-wavelength spectral transport (render/spectral.py; beyond
    # the RGB-only reference): 4 wavelengths/path, CMF integration at
    # the sensor, Cauchy dispersion in dielectrics.
    spectral: bool = False
