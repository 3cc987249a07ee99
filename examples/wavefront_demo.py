"""Config-5 demo: wavefront PT at 1920x1080 with a persistent ray pool.

Renders N frames with the wavefront engine (continuous lane refill +
queue compaction primitives) and reports per-frame timing, then saves
the result. An interactive camera drives re-render via World events.

    python examples/wavefront_demo.py [scene.xml] [--frames 8] [--spp 1]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp
import numpy as np

from pupiloptixlab_tpu.flatten import flatten_scene
from pupiloptixlab_tpu.scene import load_scene
from pupiloptixlab_tpu.utils.compile_cache import enable_compile_cache
from pupiloptixlab_tpu.utils.image import save_image
from pupiloptixlab_tpu.wavefront import render_wavefront
from pupiloptixlab_tpu.world import World

DEFAULT_SCENE = str(Path(__file__).resolve().parent.parent / "data" / "mesh_env.xml")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default=DEFAULT_SCENE)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--out", default="wavefront_out.exr")
    args = ap.parse_args()
    enable_compile_cache()

    world = World()
    scene = load_scene(args.scene)
    scene.sensor.film.w, scene.sensor.film.h = args.width, args.height
    world.set_scene(scene)
    data, config = world.get_scene_data()

    film_sum = None
    t0 = time.perf_counter()
    for f in range(args.frames):
        camera = world.get_camera_block()  # interactive edits picked up here
        out = render_wavefront(
            data, camera, jnp.uint32(f * 7919), config, spp=args.spp
        )
        film = out["film"]
        film_sum = film if film_sum is None else film_sum + film
        if f == 0:
            np.asarray(film[:1])  # sync to exclude compile from timing
            t0 = time.perf_counter()
    img = np.asarray(film_sum / args.frames)
    dt = (time.perf_counter() - t0) / max(args.frames - 1, 1)
    print(
        f"wavefront {args.width}x{args.height} spp={args.spp}: "
        f"{dt * 1e3:.0f} ms/frame ({1.0 / dt:.1f} fps)"
    )
    save_image(args.out, img.reshape(args.height, args.width, 3)[::-1])
    print("saved", args.out)


if __name__ == "__main__":
    main()
