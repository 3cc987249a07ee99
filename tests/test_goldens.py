"""Golden regression renders.

The reference ships no automated tests; its scene XMLs are the fixtures
(SURVEY.md §4). These tests render each scene small on CPU with fixed
seeds and compare against stored goldens — any behavioral change in the
loader, flattener, sampler, BSDFs, emitters or integrator shows up as an
MSE drift. Regenerate with:  python tests/test_goldens.py --regen
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest

GOLDEN_DIR = Path(__file__).parent / "goldens"

CASES = {
    # name: (film_w, film_h, spp, max_depth or None for scene default)
    "cornellbox": (64, 64, 16, None),
    "mis": (96, 54, 16, None),
    "default": (64, 64, 8, None),
    "material_test": (96, 54, 16, None),
    "denoised_scene": (64, 64, 8, None),
    "restir_test": (96, 54, 8, None),
    "big_env": (96, 54, 2, 3),
}


def _big_env_xml(tmpdir):
    """Small instance of the big_env generator (same displacement field,
    grid 120 -> 28.8k tris): pins the LOOK of the streamed-scene class;
    streaming itself is pinned by test_bvh_streaming_matches_resident."""
    import subprocess
    import sys as _sys

    xml = Path(tmpdir) / "big_env.xml"
    if not xml.exists():
        subprocess.run(
            [_sys.executable,
             str(Path(__file__).parent.parent / "tools" / "make_big_scene.py"),
             str(tmpdir), "120"],
            check=True, capture_output=True, timeout=120,
        )
    return xml


def _render_case(name, reference_scene_dir):
    from pupiloptixlab_tpu.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu.render import render
    from pupiloptixlab_tpu.scene import load_scene

    w, h, spp, depth = CASES[name]
    if name == "big_env":
        import tempfile

        reference_scene_dir = Path(tempfile.gettempdir()) / "pupil_golden_big"
        reference_scene_dir.mkdir(exist_ok=True)
        _big_env_xml(reference_scene_dir)
    scene = load_scene(reference_scene_dir / f"{name}.xml")
    scene.sensor.film.w, scene.sensor.film.h = w, h
    if depth is not None:
        scene.integrator.max_depth = depth
    data, config = flatten_scene(scene)
    camera = camera_block_from_scene(scene)
    return np.asarray(render(data, camera, config, spp=spp, seed0=0))


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden(name, reference_scene_dir):
    path = GOLDEN_DIR / f"{name}.npz"
    if not path.exists():
        pytest.skip(f"golden {path} missing; run --regen")
    img = _render_case(name, reference_scene_dir)
    golden = np.load(path)["img"].astype(np.float32)
    assert img.shape == golden.shape
    # identical seeds -> only fp reordering noise should differ
    denom = np.mean(golden**2) + 1e-4
    rel_mse = float(np.mean((img - golden) ** 2) / denom)
    assert rel_mse < 1e-4, f"golden drift: rel MSE {rel_mse}"


if __name__ == "__main__":
    if "--regen" in sys.argv:
        GOLDEN_DIR.mkdir(exist_ok=True)
        ref = Path(os.environ["PUPIL_REFERENCE_SCENES"])
        for name in CASES:
            img = _render_case(name, ref)
            np.savez_compressed(
                GOLDEN_DIR / f"{name}.npz", img=img.astype(np.float16)
            )
            print(f"wrote {name}: mean={img.mean():.4f}")
