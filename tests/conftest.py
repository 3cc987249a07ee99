"""Test configuration: pin the CPU backend with 8 virtual devices.

Unless JAX_PLATFORMS is already set, the suite runs on the CPU, where
XLA_FLAGS gives 8 virtual devices for the sharding tests. Both must be
set before the (lazy) backend is created. Tests marked ``gpu`` need an
NVIDIA GPU and skip elsewhere; on a machine with one, run them with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""

import os
import sys
from pathlib import Path

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

# Scenes of the upstream project (cornellbox.xml, mis.xml, ...) are not
# part of this repository; tests that need them skip unless this points
# at a directory holding them.
REFERENCE_SCENES = os.environ.get("PUPIL_REFERENCE_SCENES")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def reference_scene_dir():
    if not REFERENCE_SCENES or not Path(REFERENCE_SCENES).is_dir():
        pytest.skip("upstream scene directory (PUPIL_REFERENCE_SCENES) unset")
    return Path(REFERENCE_SCENES)


@pytest.fixture(scope="session")
def gpu_device():
    """The GPU the ``gpu``-marked tests run on; skips without one."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda,cpu pytest -m gpu)")
    return jax.devices()[0]
