"""Profiling / observability.

The reference's instrumentation is a per-pass Timer surfaced in the ImGui
inspector plus a GUI FPS readout (system/pass.cpp:6-18, gui.cpp:535) and
NVCC line info for Nsight. The analogs here:

* ``FrameStats`` — rolling frame/pass timing statistics (the console
  readout, headless),
* ``trace(logdir)`` — context manager around jax.profiler producing a
  chrome-trace / xplane capture of device execution (the Nsight analog),
* ``annotate(name)`` — TraceAnnotation for host-side phases.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from collections import deque


class FrameStats:
    """Rolling window of frame times + per-pass breakdowns."""

    def __init__(self, window: int = 120):
        self.window = window
        self._frames: deque[float] = deque(maxlen=window)
        self._passes: dict[str, deque] = {}
        self._last_t = None

    def record_frame(self, ms: float) -> None:
        self._frames.append(float(ms))

    def record_pass(self, name: str, ms: float) -> None:
        self._passes.setdefault(name, deque(maxlen=self.window)).append(float(ms))

    def bind(self, system) -> None:
        """Attach to a System: frame times from FRAME_FINISHED, pass times
        from each pass's timer after every frame."""
        from pupiloptixlab_tpu.utils.event import FRAME_FINISHED

        def on_frame(ms):
            self.record_frame(ms)
            for p in system.passes:
                self.record_pass(p.name, p.last_exec_time_ms)

        system.events.bind(FRAME_FINISHED, on_frame)

    @property
    def fps(self) -> float:
        if not self._frames:
            return 0.0
        mean = statistics.fmean(self._frames)
        return 1000.0 / mean if mean > 0 else 0.0

    def summary(self) -> dict:
        out = {"frames": len(self._frames), "fps": round(self.fps, 2)}
        if self._frames:
            out["frame_ms"] = {
                "mean": round(statistics.fmean(self._frames), 3),
                "min": round(min(self._frames), 3),
                "max": round(max(self._frames), 3),
            }
        out["passes"] = {
            name: round(statistics.fmean(v), 3) for name, v in self._passes.items() if v
        }
        return out


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device profile into ``logdir`` (viewable in TensorBoard /
    Perfetto)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named host-side phase, visible in captured traces."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


class Stopwatch:
    """Inline micro-timer for host phases (scene load, flatten, ...)."""

    def __init__(self):
        self.laps: dict[str, float] = {}

    @contextlib.contextmanager
    def lap(self, name: str):
        t0 = time.perf_counter()
        yield
        self.laps[name] = self.laps.get(name, 0.0) + (time.perf_counter() - t0)
