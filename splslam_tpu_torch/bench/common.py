"""The protocol the four benches share: the device and how it is named,
synced timing, the statistics of a timing, the traced window and the
JSON row.

Timing. A timed call is `sync(); t0; call; sync(); t1`: the host clock
around work that ends in `torch.cuda.synchronize()` (a no-op on the
CPU). Deferred batch stats stay deferred: the synchronize waits for the
device, not for the host's stats queue. Device-only columns come from
CUDA events around back-to-back calls.

Statistics. Every timing is reported as its median, p90 and sample
count, the highest percentile with at least ten samples beyond it
(`tail`), each repeat's median, the interquartile range of the pooled
samples and the spread of the repeat medians (largest minus smallest).

Trace. After the untraced repeats one separate window runs under
`torch.profiler` (CPU and, on a GPU, CUDA activity): the device's busy
and idle share of the window's wall, the five kernels with the most
device time, the ORB kernel's launches, and the traced wall beside the
untraced one. No end-to-end number comes from a traced window.
"""

from __future__ import annotations

import dataclasses
import gc
import subprocess
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from splslam_tpu_torch.ops import orb_kernel

# The reference C++ system on a CPU (BASELINE.md, its timing table and
# component experiments): the denominators of `vs_baseline`.
BASELINE_MS = {
    "kitti_tracking_total": 72.99,
    "kitti_feature_extraction": 64.50,
    "kitti_initial_pose_tracking": 2.18,
    "kitti_track_local_map": 6.31,
    "kitti_keyframe_insertion": 13.38,
    "kitti_map_feature_culling": 0.24,
    "kitti_map_features_creation": 51.81,
    "kitti_local_ba": 117.22,
    "kitti_keyframe_culling": 2.68,
    "kitti_mapping_total": 185.34,
    "tum_mono_line_tracking_total": 41.54,
    "epnp_solve": 0.52,
    "epnl_solve": 0.20,
}


class NoCardError(RuntimeError):
    """The bench was asked for the card and there is none."""


def resolve_device(name: str) -> torch.device:
    """The device to measure on. "cuda" without a card raises: a
    measurement never falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCardError("no CUDA device (torch.cuda.is_available() is False); "
                          "pass --device cpu for a CPU run")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def device_info(dev: torch.device):
    """What every row says about where it ran: "cpu", or the card's name,
    the device count and nvidia-smi's name and power limit."""
    if dev.type != "cuda":
        return "cpu"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": card_line()}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tail_quantile(n: int) -> float | None:
    """The highest of the usual percentiles with at least ten of `n`
    samples beyond it (None below 20 samples)."""
    for q in (99.9, 99.0, 95.0, 90.0, 75.0, 50.0):
        if n * (1.0 - q / 100.0) >= 10.0:
            return q
    return None


def summary(per_repeat: list[list[float]]) -> dict:
    """The statistics of one timing (ms) over R repeats, pooled."""
    xs = np.asarray([x for r in per_repeat for x in r], np.float64)
    meds = [float(np.median(r)) for r in per_repeat if len(r)]
    q = tail_quantile(len(xs))
    q25, q75 = (np.percentile(xs, [25, 75]) if len(xs) else (np.nan, np.nan))
    return {
        "median_ms": float(np.median(xs)) if len(xs) else None,
        "p90_ms": float(np.percentile(xs, 90)) if len(xs) else None,
        "n": int(len(xs)),
        "tail": None if q is None else {"q": q, "ms": float(np.percentile(xs, q))},
        "repeat_medians_ms": meds,
        "iqr_ms": float(q75 - q25) if len(xs) else None,
        "repeat_spread_ms": float(max(meds) - min(meds)) if meds else None,
    }


def cuts(size, full) -> list[str]:
    """The fields of a bench's `Size` cut from its full configuration."""
    return [f"{f.name}={getattr(size, f.name)} (full {getattr(full, f.name)})"
            for f in dataclasses.fields(size) if getattr(size, f.name) != getattr(full, f.name)]


def launches() -> int:
    """The ORB kernel's launch count (the benches read differences: a
    caller may count a whole run)."""
    return orb_kernel.orb_describe.launches


def watched(sysm):
    """`sysm`, counting from now its lost-batch replays
    (`_recover_batch_suffix`) in `sysm.replays` and the frames they build
    again (the lost batch's suffix and every batch in flight behind it)
    in `sysm.replayed_frames`; `launch_check` counts its ORB launches
    from now."""
    sysm.replays = 0
    sysm.replayed_frames = 0
    sysm.launches0 = launches()
    replay = sysm._recover_batch_suffix

    def counted(imgs, timestamps, b0):
        sysm.replays += 1
        sysm.replayed_frames += len(timestamps) - b0 + sum(
            len(p[1]) for p in sysm._pending_batches)
        return replay(imgs, timestamps, b0)

    sysm._recover_batch_suffix = counted
    return sysm


def launch_check(b: "Bench", sysm, built: int) -> tuple[int, int]:
    """(ORB kernel launches since `watched(sysm)`, launches expected): one
    a frame built on the card (replays build frames again), none on the
    CPU, where the plain version runs."""
    return launches() - sysm.launches0, (built + sysm.replayed_frames) if b.cuda else 0


def _merged_busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (us)."""
    busy, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


@dataclass
class Bench:
    """One bench's run: its device, seed, repeat count, set-up times and
    cuts, and the rows it makes."""

    name: str
    device: torch.device
    seed: int = 0
    repeats: int = 3
    info: object = "cpu"
    setup_s: dict = field(default_factory=dict)
    reduced: list = field(default_factory=list)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        sync(self.device)

    def timed(self, fn, *args, **kw):
        """(fn's result, its synced wall in ms)."""
        self.sync()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.sync()
        return out, (time.perf_counter() - t0) * 1e3

    def setup(self, what: str, fn, *args, **kw):
        """Run set-up work (kernel build, vocabulary, scene or map build,
        warm-up), adding its synced wall to `setup_s[what]`."""
        out, ms = self.timed(fn, *args, **kw)
        self.setup_s[what] = round(self.setup_s.get(what, 0.0) + ms / 1e3, 3)
        return out

    def settle(self) -> None:
        """Set-up before a timed region: collect the garbage of earlier
        repeats here, not inside timed calls."""
        t0 = time.perf_counter()
        gc.collect()
        self.setup_s["gc"] = round(self.setup_s.get("gc", 0.0)
                                   + time.perf_counter() - t0, 3)

    def events_ms(self, fn, inputs: list) -> float | None:
        """Device time of one call: CUDA events around `fn(x)` for every
        x in `inputs`, back to back, over their count (None on the CPU)."""
        if not self.cuda or not inputs:
            return None
        self.sync()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for x in inputs:
            fn(x)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / len(inputs)

    def trace(self, window: str, fn, untraced_ms: float | None, per: int = 1) -> dict:
        """Run `fn()` once under torch.profiler. `per` divides the traced
        wall for comparison with `untraced_ms` (e.g. frames a batch)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        n0 = launches()
        self.sync()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            self.sync()
            wall_us = (time.perf_counter() - t0) * 1e6
        counted = launches() - n0
        out = {"window": window, "traced_ms": wall_us / 1e3 / per,
               "untraced_ms": untraced_ms, "orb_counter": counted}
        if not self.cuda:
            out.update(device_busy_share=None, device_idle_share=None,
                       device_activities=None, top_kernels=None, orb_launches=None,
                       note="device activity not measured on the CPU")
            return out
        t0 = time.perf_counter()
        # the profiler's raw activities: building its FunctionEvents takes
        # minutes for a window of ~10^6 activities
        dev = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        busy = _merged_busy_us([(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
                                for e in dev])
        by_name: dict[str, list] = {}
        for e in dev:
            s = by_name.setdefault(e.name(), [0.0, 0])
            s[0] += e.duration_ns() / 1e3
            s[1] += 1
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
        out.update(
            device_activities=len(dev),
            device_busy_ms=busy / 1e3,
            device_busy_share=busy / wall_us,
            device_idle_share=1.0 - busy / wall_us,
            top_kernels=[{"name": k[:120], "ms": v[0] / 1e3, "count": v[1]}
                         for k, v in top],
            orb_launches=sum(n for k, (_, n) in by_name.items() if "orb_describe" in k),
            processing_s=time.perf_counter() - t0,
        )
        return out

    def row(self, metric: str, value, unit: str, checks: dict, *,
            baseline: str | None = None, ms: float | None = None, **fields) -> dict:
        """One JSON row. `vs_baseline` is the reference's ms over this
        row's `ms` (for a rate, this rate over the reference's)."""
        vs = (BASELINE_MS[baseline] / ms
              if baseline is not None and ms is not None and ms > 0 else None)
        checks = {k: bool(v) for k, v in checks.items()}
        return {"metric": metric, "value": value, "unit": unit, "vs_baseline": vs,
                "bench": self.name, "device": self.info, "ok": all(checks.values()),
                "checks": checks, **fields, "setup_s": dict(self.setup_s),
                "reduced": self.reduced + ([f"repeats={self.repeats} (default 3)"]
                                           if self.repeats < 3 else []),
                "repeats": self.repeats,
                "seed": self.seed}


def failed_row(bench: str, info, exc: BaseException) -> dict:
    """The row of a bench that raised: ok false, with the exception."""
    return {"metric": f"{bench}_bench", "value": None, "unit": None,
            "vs_baseline": None, "bench": bench, "device": info, "ok": False,
            "error": "".join(traceback.format_exception_only(type(exc), exc)).strip(),
            "traceback": traceback.format_exc()[-4000:]}
