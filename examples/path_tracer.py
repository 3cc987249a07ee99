"""Flagship example: progressive path tracer over a mitsuba3 XML scene.

The example/path_tracer analog: boot the System, add a PTPass, load a
scene, render, save the result. Run:

    python examples/path_tracer.py [scene.xml] [--spp N] [--out out.exr]
                                   (default scene: data/mesh_env.xml)
    python examples/path_tracer.py --interactive   # live window if available
    python examples/path_tracer.py --web [--port 8090]  # browser GUI
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pupiloptixlab_tpu.passes import PTPass
from pupiloptixlab_tpu.system import System
from pupiloptixlab_tpu.utils.compile_cache import enable_compile_cache

DEFAULT_SCENE = str(Path(__file__).resolve().parent.parent / "data" / "mesh_env.xml")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default=DEFAULT_SCENE)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--out", default="pt_out.exr")
    ap.add_argument("--interactive", action="store_true")
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--spectral", action="store_true",
                    help="hero-wavelength spectral transport "
                         "(render/spectral.py; dispersion-capable)")
    ap.add_argument("--web", action="store_true",
                    help="serve the interactive GUI over HTTP (remote hosts)")
    ap.add_argument("--port", type=int, default=8090)
    args = ap.parse_args()
    enable_compile_cache()

    system = System(display="web" if args.web else "window")
    system.add_pass(PTPass(max_depth=args.max_depth, spectral=args.spectral or None))
    if not system.set_scene(args.scene):
        raise SystemExit(1)

    if args.interactive or args.web:
        if args.web:
            system.display.port = args.port
        system.run(threaded=True)  # render thread + display client
    else:
        system.run(max_frames=args.spp)
        system.display.save_screenshot(args.out)
        print(f"saved {args.out} ({args.spp} spp, "
              f"{system.passes[0].last_exec_time_ms:.1f} ms/frame last)")
    system.destroy()


if __name__ == "__main__":
    main()
