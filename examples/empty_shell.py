"""Framework shell with no passes (the empty_gui analog)."""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pupiloptixlab_tpu.system import System
from pupiloptixlab_tpu.utils.compile_cache import enable_compile_cache

SCENE = Path(__file__).resolve().parent.parent / "data" / "mesh_env.xml"


def main() -> None:
    enable_compile_cache()
    system = System(has_display=True)
    system.set_scene(SCENE)
    system.run(max_frames=3)
    system.destroy()
    print("shell ran 3 empty frames")


if __name__ == "__main__":
    main()
