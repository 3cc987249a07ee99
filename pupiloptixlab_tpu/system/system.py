"""System: application lifecycle and the render loop.

Parity: system/system.{h,cpp} — Init/Run/Destroy/AddPass/SetScene, the
event bindings (Quit/Start/Stop/Precompute), pre-pass vs per-frame pass
split, and the render loop on a worker thread with FRAME_FINISHED
dispatch per frame (system.cpp:93-106). The GUI thread becomes an
optional display client pumping frames from the FRAME_FINISHED events.
"""

from __future__ import annotations

import threading
from pathlib import Path

from pupiloptixlab_tpu.system.buffers import (
    DEFAULT_FINAL_RESULT_BUFFER_NAME,
    BufferDesc,
    BufferFlag,
    BufferManager,
)
from pupiloptixlab_tpu.system.pass_base import Pass, PassTag
from pupiloptixlab_tpu.utils.event import (
    FRAME_FINISHED,
    PRECOMPUTE,
    QUIT,
    SCENE_LOAD,
    START_RENDERING,
    STOP_RENDERING,
    EventBus,
)
from pupiloptixlab_tpu.utils.log import get_logger
from pupiloptixlab_tpu.utils.timer import Timer
from pupiloptixlab_tpu.world import World

log = get_logger(__name__)


class System:
    def __init__(
        self,
        has_display: bool = False,
        display: str | None = None,
        web_host: str = "127.0.0.1",
        web_port: int = 8090,
    ):
        """``display``: None (headless), "window" (matplotlib, needs a
        local display) or "web" (HTTP/MJPEG client, the remote-host GUI).
        ``has_display=True`` keeps the old behavior ("window")."""
        self.events = EventBus()
        self.world = World(self.events)
        self.buffers = BufferManager()
        self.passes: list[Pass] = []
        self.pre_passes: list[Pass] = []
        self.display = None

        self._render_flag = threading.Event()
        self._quit_flag = threading.Event()
        self._render_mutex = threading.Lock()
        self._render_thread: threading.Thread | None = None

        self.events.bind(QUIT, lambda _: self._quit_flag.set())
        self.events.bind(START_RENDERING, lambda _: self._render_flag.set())
        self.events.bind(STOP_RENDERING, lambda _: self._render_flag.clear())
        self.events.bind(PRECOMPUTE, lambda _: self._run_pre_passes())

        if display is None and has_display:
            display = "window"
        if display == "web":
            from pupiloptixlab_tpu.display.web import WebDisplay

            self.display = WebDisplay(self, host=web_host, port=web_port)
        elif display == "window":
            from pupiloptixlab_tpu.display.client import DisplayClient

            self.display = DisplayClient(self)

    # -- passes ---------------------------------------------------------------
    def add_pass(self, p: Pass) -> None:
        """Pre passes run once per PRECOMPUTE; others every frame
        (system.cpp:129-134)."""
        if p.tag & PassTag.PRE:
            self.pre_passes.append(p)
        else:
            self.passes.append(p)
        if hasattr(p, "bind"):
            p.bind(self)

    def _run_pre_passes(self) -> None:
        for p in self.pre_passes:
            p.run()

    # -- scene ------------------------------------------------------------------
    def set_scene(self, path: str | Path) -> bool:
        with self._render_mutex:
            if not self.world.load_scene(path):
                log.warning("scene load failed; keeping current scene")
                return False
            film = self.world.scene.sensor.film
            self.buffers.alloc(
                BufferDesc(
                    name=DEFAULT_FINAL_RESULT_BUFFER_NAME,
                    flag=BufferFlag.ALLOW_DISPLAY,
                    width=film.w,
                    height=film.h,
                    channels=4,
                )
            )
            self.events.dispatch(SCENE_LOAD, self.world)
        self.events.dispatch(PRECOMPUTE)
        self.events.dispatch(START_RENDERING)
        return True

    # -- run loop -----------------------------------------------------------------
    def _render_loop(self, max_frames: int | None) -> None:
        frames = 0
        while not self._quit_flag.is_set():
            if not self._render_flag.is_set():
                if self._quit_flag.wait(0.005):
                    break
                continue
            timer = Timer()
            timer.start()
            with self._render_mutex:
                for p in self.passes:
                    p.run()
            timer.stop()
            self.events.dispatch(FRAME_FINISHED, timer.elapsed_ms)
            frames += 1
            if max_frames is not None and frames >= max_frames:
                break
        self._render_flag.clear()

    def run(self, max_frames: int | None = None, threaded: bool = False) -> None:
        """Run the render loop (worker thread if ``threaded``, matching the
        reference's ThreadPool render loop + main-thread GUI split)."""
        self._quit_flag.clear()
        self._render_flag.set()
        if threaded:
            self._render_thread = threading.Thread(
                target=self._render_loop, args=(max_frames,), daemon=True
            )
            self._render_thread.start()
            if self.display is not None:
                self.display.run()  # blocks on the "GUI thread"
        else:
            self._render_loop(max_frames)

    def stop(self) -> None:
        self.events.dispatch(STOP_RENDERING)

    def quit(self) -> None:
        self.events.dispatch(QUIT)

    def destroy(self) -> None:
        self.quit()
        if self._render_thread is not None:
            self._render_thread.join(timeout=5)
            self._render_thread = None
