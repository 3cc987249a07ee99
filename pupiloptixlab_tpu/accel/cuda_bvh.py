"""Build and bind the CUDA traversal kernel (native/bvh_traverse.cu).

The library is compiled with ``nvcc`` from the committed source into
``build/`` at the repository root (listed in .gitignore) on first use,
keyed by a hash of the source, so an edited kernel rebuilds itself.
``python -m pupiloptixlab_tpu.accel.cuda_bvh`` builds it ahead of time.
A failed build raises: there is no fallback to another traversal.

The two FFI targets take the same operands (8 ray planes, then the tri,
child and box tables, then the instancing tables, which are 1-row
placeholders on flat scenes) and the static attributes ``tcl`` and
``instanced``:

* ``pupil_bvh_closest`` -> (t f32, idx i32, leaf i32), idx = -1 on miss;
* ``pupil_bvh_anyhit``  -> occluded i32 (0/1).

The call is wrapped in ``custom_partitioning``: when the rays are
sharded over a mesh (parallel/sharding.py) every device traverses its
own rays against replicated tables, instead of XLA gathering all rays
onto every device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.custom_partitioning import custom_partitioning
from jax.sharding import NamedSharding, PartitionSpec as P

REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = REPO_ROOT / "native" / "bvh_traverse.cu"
BUILD_DIR = REPO_ROOT / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_registered = False
build_seconds = 0.0   # wall time of the last nvcc build in this process


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libpupil_bvh_{digest}.so"


def nvcc_command(out: Path) -> list[str]:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return [
        nvcc, *NVCC_FLAGS, "-I", jax.ffi.include_dir(),
        "-o", str(out), str(SOURCE),
    ]


def build() -> Path:
    """Compile the library unless this source's build already exists."""
    global build_seconds
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        nvcc_command(tmp), capture_output=True, text=True, timeout=600
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed building {SOURCE.name}:\n{proc.stdout}{proc.stderr}"
        )
    tmp.replace(lib)
    build_seconds = time.perf_counter() - t0
    return lib


def register() -> None:
    """Build (if needed), load and register both FFI targets once."""
    global _registered
    if _registered:
        return
    lib = ctypes.cdll.LoadLibrary(str(build()))
    for name, symbol in (
        ("pupil_bvh_closest", lib.PupilBvhClosest),
        ("pupil_bvh_anyhit", lib.PupilBvhAnyhit),
    ):
        jax.ffi.register_ffi_target(
            name, jax.ffi.pycapsule(symbol), platform="CUDA"
        )
    _registered = True


def operands(ro, rd, tmin, tmax, tri, child, boxes,
             leaf_start=None, leaf_inst=None, inst_w2o=None):
    """The kernel's operand list, in its binding order; absent
    instancing tables become 1-row placeholders."""
    f32, i32 = jnp.float32, jnp.int32
    if leaf_start is None:
        leaf_start = jnp.zeros(1, i32)
        leaf_inst = jnp.zeros(1, i32)
        inst_w2o = jnp.zeros((1, 12), f32)
    return [
        ro.x.astype(f32), ro.y.astype(f32), ro.z.astype(f32),
        rd.x.astype(f32), rd.y.astype(f32), rd.z.astype(f32),
        tmin.astype(f32), tmax.astype(f32),
        tri.astype(f32), child.astype(i32), boxes.astype(f32),
        leaf_start.astype(i32), leaf_inst.astype(i32), inst_w2o.astype(f32),
    ]


def _ffi_call(tcl: int, anyhit: bool, instanced: bool):
    """The raw FFI call on one device's rays."""
    def call(*args):
        n = args[0].shape[0]
        attrs = dict(tcl=np.int32(tcl), instanced=np.int32(instanced))
        if anyhit:
            return jax.ffi.ffi_call(
                "pupil_bvh_anyhit", jax.ShapeDtypeStruct((n,), jnp.int32)
            )(*args, **attrs)
        return jax.ffi.ffi_call(
            "pupil_bvh_closest",
            (
                jax.ShapeDtypeStruct((n,), jnp.float32),
                jax.ShapeDtypeStruct((n,), jnp.int32),
                jax.ShapeDtypeStruct((n,), jnp.int32),
            ),
        )(*args, **attrs)

    return call


# operand factors: 8 ray planes share the ray axis "n"; every table
# factor must stay replicated
_TABLE_FACTORS = ("t", "c", "m", "b", "d", "l", "k", "i", "j")
_OPERAND_RULE = "n, n, n, n, n, n, n, n, t c, m, b d, l, k, i j"


def _ray_axis(arg_shapes):
    sharding = arg_shapes[0].sharding
    spec = getattr(sharding, "spec", ())
    return spec[0] if len(spec) else None


@functools.lru_cache(maxsize=None)
def _partitioned_op(tcl: int, anyhit: bool, instanced: bool):
    call = _ffi_call(tcl, anyhit, instanced)
    n_out = 1 if anyhit else 3

    @custom_partitioning
    def op(*args):
        return call(*args)

    def shardings(mesh, arg_shapes):
        rays = NamedSharding(mesh, P(_ray_axis(arg_shapes)))
        rep = NamedSharding(mesh, P())
        outs = rays if anyhit else (rays,) * n_out
        return rays, rep, outs

    def infer(mesh, arg_shapes, result_shape):
        return shardings(mesh, arg_shapes)[2]

    def partition(mesh, arg_shapes, result_shape):
        rays, rep, outs = shardings(mesh, arg_shapes)
        return mesh, call, outs, (rays,) * 8 + (rep,) * 6

    op.def_partition(
        infer_sharding_from_operands=infer,
        partition=partition,
        sharding_rule=_OPERAND_RULE + " -> " + ", ".join(["n"] * n_out),
        need_replication_factors=_TABLE_FACTORS,
    )
    return op


def traverse(ro, rd, tmin, tmax, tri, child, boxes, tcl: int,
             anyhit: bool = False, instanced: bool = False,
             leaf_start=None, leaf_inst=None, inst_w2o=None):
    """Same contract as accel/traverse.py::walk, on the GPU kernel."""
    register()
    args = operands(ro, rd, tmin, tmax, tri, child, boxes,
                    leaf_start if instanced else None,
                    leaf_inst if instanced else None,
                    inst_w2o if instanced else None)
    out = _partitioned_op(int(tcl), bool(anyhit), bool(instanced))(*args)
    if anyhit:
        return out != 0
    t, idx, leaf = out
    return (t, idx, leaf) if instanced else (t, idx)


if __name__ == "__main__":
    path = build()
    print(f"{path} ({build_seconds:.1f} s)")
