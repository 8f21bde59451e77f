"""Live viewer loop (port of splslam_tpu/viz/viewer.py) — the reference
Viewer thread re-created headless-first.

The reference runs a Pangolin render thread (src/Viewer.cc:54-250:
`Run`/`RunBoth` loop at `mT = 1e3/fps` ms cadence, drawing the map GL
scene + a cv::imshow of the FrameDrawer overlay, with the
RequestStop/Release/RequestFinish handshake used by System::Shutdown and
loop closing). Without a display the viewer renders the same content
(frame overlay via `render_current_frame`, map figure via `plot_map`) on
a daemon thread at the same cadence and either shows it with cv2.imshow
(when a display exists) or writes numbered PNGs to an output directory —
a "flight recorder" a user can scrub or ffmpeg into a video.

There is no mutex web: the tracker publishes the caller's host image of
each tracked frame (`System.last_image` / `System.frame_id`), and each
tick copies the tables it draws from the card once (`draw._host`).
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from .draw import plot_map, render_current_frame


def _has_display() -> bool:
    return bool(os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"))


class Viewer:
    """Background render loop over a running `System`.

    Parameters mirror the reference's Viewer config (Viewer.* YAML keys,
    src/Viewer.cc:33-52): `fps` is the redraw cadence; `out_dir` (an
    addition) receives `frame_%06d.png` overlays and a periodically
    refreshed `map.png` when no display is available (or always, if
    given); `show` forces/suppresses cv2.imshow (default: auto-detect a
    display). `map_every` controls how often the (matplotlib, ~100 ms)
    map figure is refreshed, in viewer ticks.
    """

    def __init__(self, system, fps: float = 10.0,
                 out_dir: str | None = None, show: bool | None = None,
                 map_every: int = 10):
        self.system = system
        self.period = 1.0 / max(fps, 1e-3)
        self.out_dir = out_dir
        self.show = _has_display() if show is None else show
        self.map_every = max(int(map_every), 1)
        self._thread: threading.Thread | None = None
        # reference handshake flags (include/Viewer.h:61-76), as Events
        self._finish_requested = threading.Event()
        self._finished = threading.Event()
        self._stop_requested = threading.Event()
        self._stopped = threading.Event()
        self.n_rendered = 0
        self._warned = False
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    # -- reference API (System.cc:319-335 shutdown, LoopClosing stop) --
    def start(self) -> "Viewer":
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="splslam-viewer")
        self._thread.start()
        return self

    def request_stop(self):
        self._stop_requested.set()

    def is_stopped(self) -> bool:
        return self._stopped.is_set()

    def release(self):
        self._stop_requested.clear()
        self._stopped.clear()

    def request_finish(self):
        self._finish_requested.set()

    def is_finished(self) -> bool:
        return self._finished.is_set()

    def join(self, timeout: float = 5.0):
        if self._thread is not None:
            self._thread.join(timeout)

    # ------------------------------------------------------------------
    def run(self):
        """Render loop (reference Viewer::Run/RunBoth, src/Viewer.cc:54).

        Each tick: if the tracker has published a new frame since the
        last tick, draw the overlay; every `map_every` ticks refresh the
        map figure. Honors the stop/finish handshake exactly like the
        reference (stopped viewers idle without rendering until
        released)."""
        last_frame_id = -1
        tick = 0
        while not self._finish_requested.is_set():
            t0 = time.perf_counter()
            if self._stop_requested.is_set():
                self._stopped.set()
            else:
                self._stopped.clear()
                snap = getattr(self.system, "last_image", None)
                fid = self.system.frame_id
                if snap is not None and fid != last_frame_id:
                    last_frame_id = fid
                    try:
                        self._render_tick(snap, fid, tick)
                        tick += 1
                    except Exception as exc:
                        # Rendering must never kill tracking, but a 100%
                        # failure rate (cv2 missing, out_dir unwritable)
                        # should not be silent either: warn once.
                        if not self._warned:
                            self._warned = True
                            import warnings
                            warnings.warn(
                                f"viewer render tick failed ({exc!r}); "
                                "further failures suppressed")
            dt = time.perf_counter() - t0
            time.sleep(max(self.period - dt, 1e-3))
        self._finished.set()

    def _render_tick(self, image: np.ndarray, fid: int, tick: int):
        overlay = render_current_frame(self.system, image)
        if self.show:
            import cv2
            cv2.imshow("SPL-SLAM: current frame", overlay)
            cv2.waitKey(1)
        if self.out_dir:
            import cv2
            cv2.imwrite(os.path.join(self.out_dir,
                                     f"frame_{fid:06d}.png"), overlay)
        # counted only after the sinks succeeded, so n_rendered reflects
        # frames actually delivered, not attempts
        self.n_rendered += 1
        if tick % self.map_every == 0 and self.system.n_kfs > 0 \
                and self.out_dir:
            plot_map(self.system, os.path.join(self.out_dir, "map.png"))
