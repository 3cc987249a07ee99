"""ReSTIR example (DI, or GI with --gi) over a many-light scene (the
reference's restir_test.xml class; see render/restir.py). The repository
ships no such scene yet, so the scene argument is required.

    python examples/restir.py scene.xml [--frames N] [--out out.exr]
    python examples/restir.py --web [--port 8090]   # browser GUI
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pupiloptixlab_tpu.passes import ReSTIRPass
from pupiloptixlab_tpu.system import System

from pupiloptixlab_tpu.utils.compile_cache import enable_compile_cache


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--out", default="restir_out.exr")
    ap.add_argument("--candidates", type=int, default=8)
    ap.add_argument("--taps", type=int, default=3)
    ap.add_argument("--gi", action="store_true",
                    help="ReSTIR GI (one-bounce indirect reservoirs)")
    ap.add_argument("--web", action="store_true")
    ap.add_argument("--port", type=int, default=8090)
    args = ap.parse_args()
    enable_compile_cache()

    system = System(display="web" if args.web else "window")
    system.add_pass(
        ReSTIRPass(m_candidates=args.candidates, spatial_taps=args.taps,
                   gi=args.gi)
    )
    if not system.set_scene(args.scene):
        raise SystemExit(1)

    if args.web:
        system.display.port = args.port
        system.run(threaded=True)
    else:
        system.run(max_frames=args.frames)
        system.display.save_screenshot(args.out)
        print(f"saved {args.out} ({args.frames} frames, "
              f"{system.passes[0].last_exec_time_ms:.1f} ms/frame last)")
    system.destroy()


if __name__ == "__main__":
    main()
