"""The port's bench, `bench_torch.py`, on the CPU at its test size
(`--small`: 320x240, 600 features, 4 levels, short sequences; one torch
thread): every row of the four benches by name and unit, on "cpu", ok;
the command's refusal to run without a card; the components bench's
low-texture scene against bench_components.py's; and a check that fails
as it should (an ATE gate of 0)."""

import contextlib
import dataclasses
import importlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402
from splslam_tpu_torch.bench import common, components, mono  # noqa: E402

ROWS = {
    "kitti_stereo_tracking_fps_per_chip": ("stereo", "frames/s"),
    "kitti_stereo_tracking_ms_per_frame": ("stereo", "ms"),
    "kitti_stereo_fps_realistic_kf_cadence": ("stereo", "frames/s"),
    "kitti_local_ba_ms_per_keyframe": ("mapping", "ms"),
    "kitti_mapping_total_ms_per_keyframe": ("mapping", "ms"),
    "kitti_feature_extraction_ms_per_frame": ("mapping", "ms"),
    "kitti_initial_pose_tracking_ms_per_frame": ("mapping", "ms"),
    "kitti_track_local_map_ms_per_frame": ("mapping", "ms"),
    "kitti_tracking_total_ms_per_frame_sum_of_stages": ("mapping", "ms"),
    "kitti_keyframe_insertion_ms_per_keyframe": ("mapping", "ms"),
    "kitti_map_feature_culling_ms_per_keyframe": ("mapping", "ms"),
    "kitti_map_features_creation_ms_per_keyframe": ("mapping", "ms"),
    "kitti_keyframe_culling_ms_per_keyframe": ("mapping", "ms"),
    "kitti_tracking_mapping_one_stream_ms_per_frame": ("mapping", "ms"),
    "tum_mono_line_tracking_ms_per_frame": ("mono", "ms"),
    "tum_mono_points_only_ms_per_frame": ("mono", "ms"),
    "mono_init_success_low_texture": ("components", "successes/1"),
    "reloc_solver_success_and_latency": ("components", "line-solver successes/2"),
}


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _run(argv):
    """(exit code, rows) of bench_torch.main in this process."""
    out = io.StringIO()
    with _one_thread(), contextlib.redirect_stdout(out):
        rc = bench_torch.main(argv)
    return rc, [json.loads(line) for line in out.getvalue().splitlines()]


@pytest.fixture(scope="module")
def small_run():
    return _run(["--bench", "all", "--device", "cpu", "--small", "--repeats", "1"])


def test_all_benches_exit_zero(small_run):
    rc, rows = small_run
    assert rc == 0, [r for r in rows if not r["ok"]]
    assert [r["metric"] for r in rows] == list(ROWS)


@pytest.mark.parametrize("metric", list(ROWS))
def test_row(small_run, metric):
    _, rows = small_run
    (row,) = [r for r in rows if r["metric"] == metric]
    bench, unit = ROWS[metric]
    assert row["bench"] == bench and row["unit"] == unit
    assert row["device"] == "cpu"
    assert row["ok"] is True and all(row["checks"].values()), row["checks"]
    assert {"value", "vs_baseline", "setup_s", "reduced", "bench_wall_s"} <= set(row)
    if "median_ms" in row:     # a timing: its statistics and its traced window
        assert row["n"] >= 1 and row["median_ms"] <= row["p90_ms"] + 1e-9
        assert len(row["repeat_medians_ms"]) == 1 and row["repeat_spread_ms"] == 0.0
        assert row["trace"]["device_idle_share"] is None   # not measured on the CPU


def test_without_a_card_the_bench_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "bench_torch.py", "--bench", "components"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "cuda" in r.stderr.lower()


def test_low_texture_grid_equals_bench_components():
    env = dict(os.environ)
    ref = importlib.import_module("bench_components")
    # bench_components sets JAX cache variables at import: leave none behind
    for k in set(os.environ) - set(env):
        del os.environ[k]
    for seed in (100, 101, 109):
        a, b = components._low_texture_grid(seed), ref._low_texture_grid(seed)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_a_failed_check_is_reported_and_exits_nonzero(monkeypatch):
    monkeypatch.setattr(mono, "ATE_GATE", 0.0)
    monkeypatch.setattr(mono, "SMALL", dataclasses.replace(mono.SMALL, n_frames=6))
    rc, rows = _run(["--bench", "mono", "--device", "cpu", "--small", "--repeats", "1"])
    assert rc != 0
    lines, points = rows
    assert lines["ok"] is False and lines["checks"]["Sim3-aligned ATE < 0.0"] is False
    assert points["ok"] is True


def test_summary_statistics():
    s = common.summary([list(range(1, 21)), [30.0] * 20])
    assert s["n"] == 40 and s["median_ms"] == 25.0
    assert s["repeat_medians_ms"] == [10.5, 30.0] and s["repeat_spread_ms"] == 19.5
    assert s["tail"]["q"] == 75.0          # 10 samples beyond p75 of 40
    assert common.tail_quantile(19) is None and common.tail_quantile(1000) == 99.0
