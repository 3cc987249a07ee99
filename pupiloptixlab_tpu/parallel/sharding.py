"""Multi-device scaling: pixel/tile sharding over a jax.sharding.Mesh.

The reference is a single-GPU program (SURVEY.md §2.10); this is the axis
it never had. Design:

* **Pixel (tile) sharding** — the film's flat pixel axis is sharded over
  the ``pixels`` mesh axis; the scene tables are replicated (scenes are
  small relative to device memory). The integrator is elementwise over
  pixels with gathers from replicated tables; the CUDA traversal call
  partitions per device (accel/cuda_bvh.py). The secondary-ray sort is a
  global sort, which GSPMD partitions with collectives.
* **Sample sharding** (for interactive low-res, many-spp) — each device
  renders the full film with a different seed; a ``psum``-mean merges.

Both compose: mesh ("samples", "pixels").
"""

from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pupiloptixlab_tpu.flatten.types import CameraBlock, RenderConfig, SceneData
from pupiloptixlab_tpu.render.integrator import render_frame


def make_mesh(n_devices: int | None = None, axis: str = "pixels") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_scene(scene: SceneData, mesh: Mesh) -> SceneData:
    """Replicate the scene tables on every device."""
    rep = NamedSharding(mesh, P())
    return jax.device_put(scene, rep)


def render_frame_sharded(
    mesh: Mesh,
    scene: SceneData,
    camera: CameraBlock,
    seed,
    sample_cnt,
    accum,
    config: RenderConfig,
):
    """One progressive frame with the pixel axis sharded over the mesh.

    ``accum`` must be (N, 3) with N divisible by the mesh size; the result
    keeps the same sharding so progressive accumulation never leaves the
    devices.
    """
    fn = _sharded_frame(mesh, config)
    return fn(scene, camera, jnp.uint32(seed), jnp.int32(sample_cnt), accum)


@functools.lru_cache(maxsize=16)
def _sharded_frame(mesh: Mesh, config: RenderConfig):
    """The jitted sharded frame step, built once per (mesh, config) so
    progressive frames reuse one traced and compiled program."""
    pix = NamedSharding(mesh, P("pixels"))
    rep = NamedSharding(mesh, P())
    return jax.jit(
        partial(render_frame, config=config),
        in_shardings=(rep, rep, rep, rep, pix),
        out_shardings=(pix, {"frame": pix, "albedo": pix, "normal": pix, "test": pix}),
        donate_argnums=(4,),
    )


def render_samples_sharded(
    mesh: Mesh,
    scene: SceneData,
    camera: CameraBlock,
    seed0: int,
    config: RenderConfig,
):
    """Sample-parallel rendering: every device traces the full film with
    its own seed; a psum-mean over the ``samples`` axis merges (one
    collective per call). Effective spp = mesh size. Returns (h*w, 3)."""
    from jax import shard_map

    axis = mesh.axis_names[0]

    def per_chip(scene, camera):
        idx = jax.lax.axis_index(axis)
        out = render_sample(
            scene, camera, jnp.uint32(seed0) + idx.astype(jnp.uint32), config
        )
        return jax.lax.pmean(out["radiance"], axis)

    from pupiloptixlab_tpu.render.integrator import render_sample

    fn = shard_map(
        per_chip,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)(scene, camera)
