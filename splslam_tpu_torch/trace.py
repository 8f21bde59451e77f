"""Spans and counters inside the port, on the clock of the device trace.

`RECORDER` is process-wide, like the kernels' launch counters: a reader
can look at it after the System that wrote it is gone. It keeps the last
`RING_SPANS` spans in a ring, each as one tuple

    (seq, name, start_ns, end_ns, parent_seq, request)

with `seq` the span's number in the order spans were opened, the times
from `time.time_ns()` (Unix nanoseconds, the clock torch.profiler's
events carry, so a span can be laid over a device trace taken at the
same time), `parent_seq` the enclosing span (-1 at the top) and
`request` the frame index the enclosing public call was handed
(`System.frame_id` on entry; -1 outside any call). A call opened inside
another call is its child and keeps its request. A span costs two clock
reads and one store; nothing is written to disk, and nothing is sent to
the profiler (a profiler range costs ~8x as much, and under a CUDA
profiler each gets a device twin that reads as device activity).

Names are `<layer>.<stage>`: `call.<entry>` for the System's public
entries, then `frame.*`, `track.*`, `host.read`, `kf.*`, `map.*`,
`loop.*`, `reloc.attempt`. `host.read` is the one door of blocking
device-to-host reads (`HostRead`, `read`); it also counts them in
`RECORDER.host_reads`.

`StageTimer` keeps the reference's per-stage host rows (System.timers);
each row is timed by a span. `device_trace` writes a TensorBoard trace
with the block's spans in it. One thread records; the System is driven
from one.
"""

from __future__ import annotations

import functools
import glob
import json
import os
import threading
import time
from contextlib import contextmanager

import numpy as np
import torch

RING_SPANS = 1 << 16       # ~2,000 tracked frames at ~30 spans a frame


class Recorder:
    """A fixed ring of span records and the `host_reads` counter."""

    def __init__(self, capacity: int = RING_SPANS):
        self.capacity = capacity
        self.ring: list = [None] * capacity
        self.opened = 0           # spans opened so far: the next span's seq
        self.host_reads = 0       # blocking device-to-host reads so far
        self._seqs: list[int] = []    # the open spans, innermost last
        self._t0s: list[int] = []
        self._request = -1

    def open(self, request: int = -1) -> None:
        """Open a span inside the innermost open one; `request` is taken
        only by a span opened at the top."""
        if not self._seqs:
            self._request = request
        self._seqs.append(self.opened)
        self.opened += 1
        self._t0s.append(time.time_ns())

    def close(self, name: str) -> int:
        """Close the innermost open span as `name`; its length in ns."""
        t1 = time.time_ns()
        seq = self._seqs.pop()
        t0 = self._t0s.pop()
        seqs = self._seqs
        self.ring[seq % self.capacity] = (seq, name, t0, t1, seqs[-1] if seqs else -1,
                                          self._request)
        return t1 - t0

    @property
    def wrapped(self) -> bool:
        """Whether spans have been overwritten."""
        return self.opened > self.capacity

    def records(self, since: int = 0) -> list[tuple]:
        """The closed spans still held, opened at `since` or later, in the
        order they were opened."""
        lo = max(since, self.opened - self.capacity, 0)
        out = []
        for seq in range(lo, self.opened):
            r = self.ring[seq % self.capacity]
            if r is not None and r[0] == seq:
                out.append(r)
        return out


RECORDER = Recorder()


def summary(records: list[tuple]) -> dict[str, dict]:
    """Count, total and self milliseconds of each span name in `records`
    (self: less the spans opened directly inside it)."""
    inner: dict[int, int] = {}
    for _, _, t0, t1, parent, _ in records:
        if parent >= 0:
            inner[parent] = inner.get(parent, 0) + (t1 - t0)
    out: dict[str, dict] = {}
    for seq, name, t0, t1, _, _ in records:
        d = out.setdefault(name, {"n": 0, "total_ms": 0.0, "self_ms": 0.0})
        d["n"] += 1
        d["total_ms"] += (t1 - t0) / 1e6
        d["self_ms"] += (t1 - t0 - inner.get(seq, 0)) / 1e6
    return out


class Span:
    """`with Span(name):` records the block as a span. The object keeps
    no state between uses, so a module may hold one per site."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        RECORDER.open()
        return self

    def __exit__(self, *exc):
        RECORDER.close(self.name)
        return False


def span(name: str):
    """Decorator: every call of the function is a span named `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            RECORDER.open()
            try:
                return fn(*args, **kwargs)
            finally:
                RECORDER.close(name)
        return spanned
    return wrap


class HostRead:
    """A device tensor on its way to the host: on a GPU an asynchronous
    copy into pinned memory and an event behind it, on the CPU a copy.
    `get` waits for it as a `host.read` span and counts the read."""

    __slots__ = ("_host", "_event")

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t.detach().clone()

    def get(self) -> np.ndarray:
        RECORDER.open()
        try:
            return self._wait()
        finally:
            RECORDER.close("host.read")

    def _wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        RECORDER.host_reads += 1
        return self._host.numpy()


def read(t: torch.Tensor) -> np.ndarray:
    """`t` on the host now: a copy started and waited for in one
    `host.read` span."""
    RECORDER.open()
    try:
        return HostRead(t)._wait()
    finally:
        RECORDER.close("host.read")


# the StageTimer rows (the reference's PL_SLAM::Timer) and their spans;
# "Tracking total / frame" takes the entry's own `call.<entry>`
ROW_SPANS = {"KeyFrame insertion": "kf.insert",
             "Mapping total / keyframe": "map.step",
             "Loop detection / keyframe": "loop.detect"}


class _TimedRow:
    """A span that also adds its length to a StageTimer row: divided by
    `per` (a batch's frames), and not at all after `skip()`."""

    __slots__ = ("timer", "row", "name", "request", "per", "keep")

    def __init__(self, timer, row: str, name: str, request: int):
        self.timer, self.row, self.name, self.request = timer, row, name, request
        self.per, self.keep = 1, True

    def skip(self) -> None:
        self.keep = False

    def __enter__(self):
        RECORDER.open(self.request)
        return self

    def __exit__(self, *exc):
        ns = RECORDER.close(self.name)
        if self.keep:
            self.timer.add(self.row, ns / 1e6 / self.per)
        return False


class StageTimer:
    """Per-stage host wall-clock accumulator (the reference's PL_SLAM::Timer
    rows, src/Tracking.cc:381-413, src/LocalMapping.cc:139-235). On a GPU a
    row times the host's side: what it enqueues, and the stats it waits for
    one frame late. Each timed row is a span of `RECORDER`, and its sample
    comes from the span's two clock reads."""

    def __init__(self):
        self.samples: dict[str, list[float]] = {}

    def add(self, stage: str, ms: float):
        self.samples.setdefault(stage, []).append(ms)

    def time(self, stage: str, span: str | None = None, request: int = -1) -> _TimedRow:
        """`with timer.time(row):` times the block into `row`, as the span
        `span` (default: the row's in ROW_SPANS); `request` names the
        public call a top-level span belongs to."""
        return _TimedRow(self, stage, span or ROW_SPANS.get(stage, stage), request)

    def report(self) -> dict:
        out = {}
        for k, v in self.samples.items():
            arr = np.array(v)
            out[k] = {"mean_ms": float(arr.mean()),
                      "median_ms": float(np.median(arr)), "n": len(v)}
        return out

    def pretty(self) -> str:
        lines = ["stage                         mean ms   median ms      n"]
        for k, s in self.report().items():
            lines.append(f"{k:<28}{s['mean_ms']:>10.2f}{s['median_ms']:>12.2f}"
                         f"{s['n']:>7d}")
        return "\n".join(lines)


def _add_spans_to_chrome_trace(path: str, records: list[tuple]) -> None:
    """Append `records` to a chrome trace file written by torch.profiler,
    as complete host events (category `program_span`) of this process
    and thread, on the file's clock (microseconds after its
    `baseTimeNanoseconds`)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid, tid = os.getpid(), threading.get_native_id()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": name, "pid": pid, "tid": tid,
         "ts": (t0 - base) / 1e3, "dur": (t1 - t0) / 1e3,
         "args": {"seq": seq, "parent": parent, "request": request}}
        for seq, name, t0, t1, parent, request in records)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextmanager
def device_trace(log_dir: str):
    """Record a torch.profiler trace (host and, on a CUDA build, device
    activities) around a block of SLAM calls, written for TensorBoard
    (`tensorboard --logdir log_dir`), with the program's spans of the
    block added as host events:

        with device_trace("slam_trace"):
            for i, (l, r) in enumerate(frames):
                slam.track_stereo(l, r, i * 0.1)
    """
    from torch.profiler import profile, supported_activities, tensorboard_trace_handler

    first = RECORDER.opened
    write = tensorboard_trace_handler(log_dir)

    def on_trace_ready(prof):
        pattern = os.path.join(log_dir, "*.pt.trace.json")
        before = set(glob.glob(pattern))
        write(prof)
        for path in sorted(set(glob.glob(pattern)) - before):
            _add_spans_to_chrome_trace(path, RECORDER.records(first))

    with profile(activities=supported_activities(), on_trace_ready=on_trace_ready):
        yield
