#!/usr/bin/env python3
"""Smoke test of the path tracer on an NVIDIA GPU.

    python chip_smoke.py               # one card: all phases below
    python chip_smoke.py --four-cards  # four cards: the multi-card phase

One card, in one process:

1. traversal parity at 1080p: the production closest-hit and any-hit
   (CUDA kernel) against the brute-force sweep on the same card, on the
   primary, bounce and shadow rays of data/mesh_env.xml and of a
   generated instanced scene (pupiloptixlab_tpu/validate.py);
2. four progressive 1080p frames of data/mesh_env.xml through
   System + PTPass + DenoisePass (finite, non-black; ms/frame);
3. the three in-repo oracle gates (mesh_env, oracle_mat, big_env) at
   their committed spp and thresholds;
4. the 1080p denoise on the card against the same function on the CPU.

Four cards: render_frame_sharded over a 4-device mesh against a
single-card render_frame with the same seed, and ring_closest_bvh with
the triangles split 1/4 per card against single-card closest-hit.

Any failure raises; the last line of a passing run is one JSON object
``{"ok": true, "device": {...}}``. Without a GPU the script exits
non-zero before printing it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
MESH_ENV = REPO / "data" / "mesh_env.xml"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def load(path, width=None, height=None):
    from pupiloptixlab_tpu.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu.scene import load_scene

    scene = load_scene(path)
    if width is not None:
        scene.sensor.film.w, scene.sensor.film.h = width, height
    data, config = flatten_scene(scene)
    return data, config, camera_block_from_scene(scene)


def phase_parity() -> None:
    from pupiloptixlab_tpu.validate import generated_scene, traversal_parity

    for name, path in (
        ("mesh_env", MESH_ENV),
        ("instanced", generated_scene("instanced", 50, 8, 64)),
    ):
        data, config, cam = load(path, 1920, 1080)
        t0 = time.perf_counter()
        res = traversal_parity(data, config, cam)
        log(f"[parity] {name} tris={config.tri_count} "
            f"instanced={config.instanced} tcl={config.bvh_tcl} "
            f"({time.perf_counter() - t0:.1f} s): {json.dumps(res)}")


def phase_frames(card: str, frames: int = 4):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pupiloptixlab_tpu.passes import PTPass
    from pupiloptixlab_tpu.passes.denoise import DenoisePass
    from pupiloptixlab_tpu.render.integrator import render_frame
    from pupiloptixlab_tpu.system import System

    system = System()
    pt = PTPass()
    system.add_pass(pt)
    system.add_pass(DenoisePass())
    assert system.set_scene(MESH_ENV)
    data, config = pt._scene_data, pt._config
    cam = system.world.get_camera_block()

    t0 = time.perf_counter()
    lowered = render_frame.lower(
        data, cam, jnp.uint32(0), jnp.int32(0),
        jnp.zeros((config.width * config.height, 3), jnp.float32),
        config=config,
    )
    compiled = lowered.compile()
    log(f"[frames] frame step compile {time.perf_counter() - t0:.1f} s")
    log(f"[frames] memory_analysis: {compiled.memory_analysis()}")

    bm = system.buffers
    system.run(max_frames=1)   # first dispatch (executable cache lookup)
    jax.block_until_ready(bm["pt denoised"].array)
    t0 = time.perf_counter()
    system.run(max_frames=frames)
    jax.block_until_ready(bm["pt denoised"].array)
    ms = (time.perf_counter() - t0) * 1e3 / frames
    frame = np.asarray(bm["pt frame"].array)
    den = np.asarray(bm["pt denoised"].array)
    for name, img in (("frame", frame), ("denoised", den)):
        assert np.isfinite(img).all(), f"{name} has non-finite values"
        assert img.mean() > 1e-3, f"{name} is black ({img.mean()})"
    log(f"[frames] mesh_env {config.width}x{config.height} depth "
        f"{config.max_depth}: {frames + 1} frames, "
        f"{ms:.2f} ms/frame (PT + denoise, steady) on {card}; "
        f"mean {frame[:, :3].mean():.4f}, denoised mean {den.mean():.4f}")
    h, w = config.height, config.width
    return (
        frame[:, :3].reshape(h, w, 3),
        np.asarray(bm["pt albedo"].array).reshape(h, w, 3),
        np.asarray(bm["pt normal"].array).reshape(h, w, 3),
    )


def phase_oracle() -> None:
    from pupiloptixlab_tpu.validate import ORACLE_GATES, oracle_gate

    for name in ORACLE_GATES:
        t0 = time.perf_counter()
        res = oracle_gate(name)
        log(f"[oracle] {name} ({time.perf_counter() - t0:.1f} s): "
            f"{json.dumps(res)}")


def phase_denoise(color, albedo, normal) -> None:
    from pupiloptixlab_tpu.validate import DENOISE_RTOL, denoise_parity

    res = denoise_parity(color, albedo, normal)
    log(f"[denoise] 1080p card vs cpu: {json.dumps(res)} "
        f"(limit rel_l2 < {DENOISE_RTOL})")


def phase_four_cards(card: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pupiloptixlab_tpu.accel.intersect import intersect_closest
    from pupiloptixlab_tpu.parallel import (
        make_mesh,
        render_frame_sharded,
        shard_scene,
    )
    from pupiloptixlab_tpu.parallel.ring_sweep import (
        build_ring_bvh,
        ring_closest_bvh,
    )
    from pupiloptixlab_tpu.render.integrator import render_frame
    from pupiloptixlab_tpu.validate import PARITY_RTOL, parity_rays

    assert len(jax.devices()) >= 4, "--four-cards needs four devices"
    mesh = make_mesh(4)
    data, config, cam = load(MESH_ENV)
    n = config.width * config.height

    # 1. pixel-sharded frame vs one card, same seed
    seed = 7
    single, _ = render_frame(data, cam, jnp.uint32(seed), jnp.int32(0),
                             jnp.zeros((n, 3), jnp.float32), config)
    single = np.asarray(single)
    sdata = shard_scene(data, mesh)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        sharded, _ = render_frame_sharded(
            mesh, sdata, cam, seed, 0, jnp.zeros((n, 3), jnp.float32), config
        )
        jax.block_until_ready(sharded)
        times.append(time.perf_counter() - t0)
    sharded = np.asarray(sharded)
    rel_l2 = float(np.linalg.norm(sharded - single) / np.linalg.norm(single))
    px_diff = float((np.abs(sharded - single).max(axis=1)
                     > 1e-3 * (np.abs(single).max(axis=1) + 1e-3)).mean())
    log(f"[four] render_frame_sharded 1080p over 4 cards vs 1: rel_l2 "
        f"{rel_l2:.3e}, pixels differing {px_diff:.2e}, "
        f"{min(times[1:]) * 1e3:.1f} ms/frame sharded on 4x {card}")
    assert np.isfinite(sharded).all()
    # pixel-keyed RNG: the two programs trace identical paths except
    # where float contraction differences flip a rare path decision
    assert rel_l2 < 1e-3 and px_diff < 1e-3, (rel_l2, px_diff)

    # 2. ring-sharded traversal (tris 1/4 per card) vs one card
    rays, hit0, _ = parity_rays(data, config, cam)
    for name in ("primary", "bounce"):
        ro, rd, tmin, tmax = rays[name]
        ref = intersect_closest(ro, rd, tmin, tmax, data, config)
        ring = build_ring_bvh(np.asarray(data.tris.packed), mesh)
        ro_f = jnp.stack([ro.x, ro.y, ro.z])
        rd_f = jnp.stack([rd.x, rd.y, rd.z])
        t, idx = ring_closest_bvh(mesh, ro_f, rd_f, tmin, tmax, ring)
        t, idx = np.asarray(t), np.asarray(idx)
        rt, rp = np.asarray(ref.t), np.asarray(ref.prim)
        rh = np.asarray(ref.kind) == 0
        gh = idx >= 0
        both = gh & rh
        dt = np.abs(t - rt)
        bad_t = both & (dt > PARITY_RTOL * np.abs(rt))
        res = dict(rays=int(n), hits=int(rh.sum()),
                   hit_mismatch=int((gh != rh).sum()),
                   t_violations=int(bad_t.sum()),
                   prim_ties=int((both & (idx != rp) & ~bad_t).sum()))
        log(f"[four] ring_closest_bvh {name}: {json.dumps(res)}")
        assert res["hit_mismatch"] == 0 and res["t_violations"] == 0, res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 1

    from pupiloptixlab_tpu.accel import cuda_bvh
    from pupiloptixlab_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    card = card_info()
    log(f"card: {card}")
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    t0 = time.perf_counter()
    cuda_bvh.register()
    log(f"[setup] CUDA traversal library {cuda_bvh.library_path().name}: "
        f"nvcc {cuda_bvh.build_seconds:.1f} s, ready in "
        f"{time.perf_counter() - t0:.1f} s")

    if args.four_cards:
        phase_four_cards(card)
    else:
        phase_parity()
        planes = phase_frames(card)
        phase_oracle()
        phase_denoise(*planes)

    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
