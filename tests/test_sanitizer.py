"""Frame value sanitizer (utils/debug.py + RenderConfig.debug_checks).

The analog of the reference's OptiX debug exception flags
(optix/pipeline.cpp:19) and CUDA_SYNC_CHECK after passes
(system/system.cpp:51): NaN/Inf/negative-value checks compiled into the
frame program, surfaced as per-stage counts, raised host-side as a
structured SanitizerError.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from pupiloptixlab_tpu.flatten import camera_block_from_scene, flatten_scene
from pupiloptixlab_tpu.render.integrator import render_frame
from pupiloptixlab_tpu.scene import load_scene
from pupiloptixlab_tpu.utils.debug import (
    SanitizerError,
    assert_all_finite,
    finite_report,
)


def _render(data, config, camera):
    n = config.width * config.height
    accum = jnp.zeros((n, 3), jnp.float32)
    _, bufs = render_frame(
        data, camera, jnp.uint32(0), jnp.int32(0), accum, config
    )
    return bufs


def test_clean_scene_reports_zero(reference_scene_dir):
    scene = load_scene(reference_scene_dir / "cornellbox.xml")
    scene.sensor.film.w = scene.sensor.film.h = 32
    data, config = flatten_scene(scene)
    config = dataclasses.replace(config, debug_checks=True, max_depth=3)
    bufs = _render(data, config, camera_block_from_scene(scene))
    assert "sanitizer" in bufs
    report = {k: int(v) for k, v in bufs["sanitizer"].items()}
    assert set(report) == {
        "radiance", "albedo", "normal", "primary_t", "throughput"
    }
    assert all(c == 0 for c in report.values()), report
    assert_all_finite(bufs["sanitizer"])  # must not raise


def test_default_config_has_no_sanitizer():
    scene = load_scene(
        Path(__file__).resolve().parent.parent / "data" / "oracle_mat.xml"
    )
    scene.sensor.film.w = scene.sensor.film.h = 16
    data, config = flatten_scene(scene)
    bufs = _render(data, config, camera_block_from_scene(scene))
    assert "sanitizer" not in bufs


def test_corrupt_scene_is_caught(reference_scene_dir):
    """Poison the texture pixel pool with NaNs (every fetched
    reflectance / emitter radiance): the sanitizer must count the
    resulting bad radiance and assert_all_finite must raise naming the
    stage."""
    scene = load_scene(reference_scene_dir / "cornellbox.xml")
    scene.sensor.film.w = scene.sensor.film.h = 32
    data, config = flatten_scene(scene)
    config = dataclasses.replace(config, debug_checks=True, max_depth=3)
    from pupiloptixlab_tpu.flatten.types import TEX_RGB

    tex = data.textures
    packed = np.asarray(tex.packed).copy()
    packed[:, TEX_RGB] = np.nan  # constant-color values only; kind/id
    data = dataclasses.replace(   # columns stay intact
        data,
        textures=dataclasses.replace(tex, packed=jnp.asarray(packed)),
    )
    bufs = _render(data, config, camera_block_from_scene(scene))
    assert int(bufs["sanitizer"]["radiance"]) > 0
    with pytest.raises(SanitizerError) as e:
        assert_all_finite(bufs["sanitizer"], context="pt")
    assert "radiance" in str(e.value) and "[pt]" in str(e.value)


def test_finite_report_counts_and_bounds():
    arr = jnp.asarray([1.0, jnp.nan, -2.0, jnp.inf])
    rep = finite_report({"a": (arr, None), "b": (arr, 0.0)})
    assert int(rep["a"]) == 2  # nan + inf
    assert int(rep["b"]) == 3  # nan + inf + negative
