"""Benchmark harness: progressive PT frame times on one NVIDIA GPU.

    python bench.py

Prints the card (``nvidia-smi`` name and power limit) and then ONE JSON
line. Every scene is read from the repository (``data/``) or generated
from a seed into ``data/generated/``:

* ``mesh_env``   — data/mesh_env.xml: 20k-triangle mesh + HDR envmap,
                   1080p 1 spp, max_depth from the scene (4);
* ``big_env``    — tools/make_big_scene.py grid 450: 405k triangles under
                   a scaled envmap, 1080p 1 spp depth 4;
* ``oracle_mat`` — data/oracle_mat.xml: all seven BSDFs, 4 triangles +
                   7 spheres, at 1080p 1 spp depth 4;
* ``spectral``   — data/dispersion.xml at its film size, spectral vs RGB;
* ``denoise``    — the 5-iteration a-trous filter at 1080p.

Ray counting matches the reference's notion of traced rays: one primary
ray per pixel plus, per bounce iteration, one NEE shadow ray and one
BSDF continuation ray per lane. Every time is host wall clock around
work that ends in ``block_until_ready``, after one warm-up call.
Fails when JAX finds no GPU.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

REPO = Path(__file__).resolve().parent


def _frames(data, config, camera, iters):
    from pupiloptixlab_tpu.render.integrator import render_frame

    n = config.width * config.height
    accum = jnp.zeros((n, 3), jnp.float32)
    accum, bufs = render_frame(
        data, camera, jnp.uint32(0), jnp.int32(0), accum, config
    )
    jax.block_until_ready(bufs["frame"])
    t0 = time.perf_counter()
    for i in range(iters):
        accum, bufs = render_frame(
            data, camera, jnp.uint32(i + 1), jnp.int32(i + 1), accum, config
        )
    jax.block_until_ready(bufs["frame"])
    return (time.perf_counter() - t0) / iters


def _bench_scene(path, width=1920, height=1080, iters=8, max_depth=None):
    from pupiloptixlab_tpu.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu.scene import load_scene

    scene = load_scene(path)
    scene.sensor.film.w, scene.sensor.film.h = width, height
    data, config = flatten_scene(scene)
    if max_depth is not None:
        config = dataclasses.replace(config, max_depth=max_depth)
    dt = _frames(data, config, camera_block_from_scene(scene), iters)
    n = config.width * config.height
    rays_per_frame = n * (1 + 2 * (config.max_depth - 1))
    return {
        "mrays": round(rays_per_frame / dt / 1e6, 2),
        "ms": round(dt * 1e3, 2),
        "tris": config.tri_count,
        "bvh_nodes": config.bvh_nodes,
        "max_depth": config.max_depth,
    }


def _bench_spectral(iters=8):
    """Hero-wavelength spectral transport vs the same scene forced to
    RGB (render/spectral.py). Returns (spectral_ms, rgb_ms)."""
    from pupiloptixlab_tpu.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu.scene import load_scene

    scene = load_scene(REPO / "data" / "dispersion.xml")
    data, config = flatten_scene(scene)
    camera = camera_block_from_scene(scene)
    return tuple(
        round(_frames(data, cfg, camera, iters) * 1e3, 2)
        for cfg in (config, dataclasses.replace(config, spectral=False))
    )


def _bench_denoise(width=1920, height=1080, iters=20):
    """A-trous denoiser (5 iterations, albedo+normal guides) at 1080p."""
    from pupiloptixlab_tpu.denoise.atrous import atrous_denoise

    rs = np.random.RandomState(3)
    color = jnp.asarray(rs.rand(height, width, 3).astype(np.float32))
    albedo = jnp.asarray(rs.rand(height, width, 3).astype(np.float32))
    nr = rs.randn(height, width, 3).astype(np.float32)
    nr /= np.maximum(np.linalg.norm(nr, axis=-1, keepdims=True), 1e-9)
    normal = jnp.asarray(nr)
    jax.block_until_ready(atrous_denoise(color, albedo, normal))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(atrous_denoise(color, albedo, normal))
        times.append(time.perf_counter() - t0)
    return round(float(np.median(times)) * 1e3, 3)


def main() -> None:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX platform {dev.platform!r})")
    from pupiloptixlab_tpu.utils.compile_cache import enable_compile_cache
    from pupiloptixlab_tpu.validate import generated_scene

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    result = {
        "mesh_env": _bench_scene(REPO / "data" / "mesh_env.xml"),
        "big_env": _bench_scene(generated_scene("big_env", 450), max_depth=4),
        "oracle_mat": _bench_scene(REPO / "data" / "oracle_mat.xml",
                                   max_depth=4),
    }
    sp_ms, rgb_ms = _bench_spectral()
    result["spectral_ms"] = sp_ms
    result["spectral_rgb_ms"] = rgb_ms
    result["denoise_ms"] = _bench_denoise()
    result["device"] = {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()), "card": card,
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
