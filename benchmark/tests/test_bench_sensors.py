"""The harness takes each of the port's sensors and public entries, and each
check, as files: monocular and RGB-D configurations written from the repo's
copies of the reference's TUM1 YAMLs, every entry driven through `Loop` on
the CPU; the distorted render against the port's distortion model; the
published keys the port does not read; the exit of a warm-up that never
initializes; and the stereo cells' compared numbers against those the
harness gave before its checks were files."""

import json
import shutil
import time
import types

import numpy as np
import pytest
import torch
from conftest import BENCH, YAMLS, published, small_cell

import run as R
from harness import cell as C
from harness import compare, drive
from harness import scene as S

SEED = 2 ** 31 + 777
DIST = ("k1", "k2", "p1", "p2", "k3")


def config(yaml_file: str, sensor: str) -> dict:
    return {"source": f"https://github.com/Hero941215/spl-slam Examples/{yaml_file}",
            "sensor": sensor, "yaml": published(YAMLS / yaml_file),
            "system": {"max_points": 65536, "max_keyframes": 1024, "local_window": 2048},
            "precision": "float32", "guarantees": [], "reduced": [], "assumed": {}}


SCENE = {"motion": "oscillate", "texture": "grid", "frames": 24, "loop": "shuttle"}
CONFIGS = {"tum1_mono_lines": config("Monocular/TUM1.yaml", "monocular"),
           "tum1_rgbd": config("RGB-D/TUM1.yaml", "rgbd")}
MIXES = {  # workload: (configuration, traffic)
    "tum1_mono_lines.mono": ("tum1_mono_lines", {
        "entry": "track_mono", "scene": SCENE, "settings": {"enable_local_mapping": True},
        "warmup_frames": 4, "trace_calls": 2, "sample_frames": 2, "checks": ["orb"]}),
    "tum1_mono_lines.mono_batch": ("tum1_mono_lines", {
        "entry": "track_mono_batch", "batch": 32, "scene": SCENE,
        "settings": {"enable_local_mapping": False, "batch_defer_stats": True},
        "warmup_batches": 1, "trace_calls": 1, "sample_frames": 2, "checks": ["orb"]}),
    "tum1_rgbd.rgbd": ("tum1_rgbd", {
        "entry": "track_rgbd", "scene": SCENE, "settings": {"enable_local_mapping": True},
        "warmup_frames": 3, "trace_calls": 2, "sample_frames": 2, "checks": ["orb", "pose"]}),
}
ENTRY_CELLS = ["kitti_stereo.live_mapping", "kitti_stereo.batch32_tracking", *MIXES]


@pytest.fixture
def files(tmp_path, monkeypatch):
    """The benchmark's folders copied under `tmp_path`, with the TUM1
    configurations, their traffic mixes and BENCHMARK.json entries added
    as new files and entries."""
    root = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits", "checks", "metrics"):
        shutil.copytree(BENCH / sub, root / sub)
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for name, c in CONFIGS.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps(dict(c, name=name)))
    for workload, (cfg, traffic) in MIXES.items():
        mix = workload.split(".")[1]
        (root / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
        bench["workloads"].append({"name": workload, "config": cfg, "traffic": mix,
                                   "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(C, "HERE", root)
    monkeypatch.setattr(C, "ROOT", tmp_path)
    return root


@pytest.mark.parametrize("workload", ENTRY_CELLS)
def test_each_entry_runs_through_the_loop(files, workload):
    cell = small_cell(workload)
    scene = drive.build_scene(cell, SEED)
    kind = drive.SENSORS[cell.sensor]
    assert scene.images.shape[1] == len(kind.views(np.eye(4), cell.yaml))
    assert (scene.depth is not None) == kind.depth
    if kind.depth:
        # the camera-frame depth (z 5 or 12 on the two planes) in the sensor's units
        assert scene.depth.dtype == np.float32 and scene.depth.shape == scene.images[:, 0].shape
        metres = scene.depth / cell.yaml["DepthMapFactor"]
        assert metres.min() > 4.0 and metres.max() < 13.0
    loop = drive.Loop(cell, scene, "cpu", SEED)
    assert loop.sys.sensor.name == kind.member
    loop.warm_up()
    assert loop.initialized
    views = scene.images.shape[1:] if scene.images.shape[1] > 1 else scene.images.shape[2:]
    for staged in loop.staged.values():
        assert staged.dtype == torch.uint8 and staged.shape == (loop.batch, *views)
    calls = [loop._call() for _ in range(2)]
    loop.sys.drain()
    answered = {scene.frame_of(e.ts) for e in loop.sys.trajectory}
    assert {f for f, _ in calls} <= answered
    assert loop.next == calls[-1][0] + 1


@pytest.mark.parametrize("workload", ["tum1_mono_lines.mono", "tum1_rgbd.rgbd"])
def test_mono_and_rgbd_cells_reach_a_result_line(files, workload):
    """A short run of a monocular and an RGB-D cell, each added as files
    only, ends with a result line that carries its checks' numbers."""
    cell = small_cell(workload)
    res = R.run_cell(cell, SEED, 1.0, False, "cpu", time.perf_counter())
    want = {"orb_keypoints_off", "orb_bits_off"} | (
        {"pose_err_m"} if "pose" in cell.traffic["checks"] else set())
    assert set(res["compared"]) == want
    assert res["attempted"] >= 1 and list(res)[-1] == "compared"


def test_check_files_are_found_by_name(files):
    (files / "checks" / "new.check.py").write_text(
        'def read(cell, scene, out, control):\n'
        '    return {"new_number": 2.0 if control else 1.0}\n')
    cell = C.load("kitti_stereo.live_mapping")
    cell.traffic["checks"] = ["new.check"]
    assert compare.numbers(cell, None, None) == {"new_number": 1.0}
    assert compare.numbers(cell, None, None, control=True) == {"new_number": 2.0}
    cell.traffic["checks"] = ["new.check", "no_such_check"]
    with pytest.raises(FileNotFoundError, match="no_such_check"):
        compare.numbers(cell, None, None)


@pytest.mark.parametrize("yaml_file", ["Monocular/TUM1.yaml", "RGB-D/TUM1.yaml",
                                       "Stereo/KITTI00-02.yaml"])
def test_published_yaml_reads_as_the_port_reads_it(yaml_file):
    """Every key the reference publishes is read as the port's own YAML
    loader reads it, or listed as unread."""
    from splslam_tpu_torch.io.config import load_settings
    from splslam_tpu_torch.slam.system import Settings

    y = published(YAMLS / yaml_file)
    cell = C.Cell("t", 1, {"yaml": y, "sensor": "monocular"}, {}, {}, [], [])
    fields = cell.settings_fields()
    assert set(cell.unread) == {k for k in y if k not in C.YAML_SETTINGS}
    port, _ = load_settings(str(YAMLS / yaml_file))
    assert Settings(**fields) == Settings(**{k: getattr(port, k) for k in fields})


def test_unread_keys_pass_and_unknown_keys_raise():
    cell = C.load("kitti_stereo.live_mapping")
    y = cell.config["yaml"]
    y.update({"Lineextractor.canny_th1": 50.0, "Camera.RGB": 1, "DepthMapFactor": 5000.0})
    fields = cell.settings_fields()
    assert cell.unread == ["Lineextractor.canny_th1"]
    assert fields["rgb"] == 1 and fields["depth_map_factor"] == pytest.approx(1 / 5000)
    assert not any("canny" in k for k in fields)
    y["Lineextractor.canny_th3"] = 1.0
    with pytest.raises(KeyError, match="canny_th3"):
        cell.settings_fields()


@pytest.mark.parametrize("pixel", [(40, 450), (600, 30), (60, 60), (610, 455), (500, 100)])
def test_distorted_render_puts_a_point_where_the_port_distorts_it(pixel):
    """A blob on the scene's plane renders where the port's
    `distort_normalized` puts it, within 0.5 px, at TUM1's k1-k3 (near the
    corners, where the distortion moves a pixel most)."""
    from splslam_tpu_torch.geometry.camera import Camera, distort_normalized

    y = published(YAMLS / "Monocular/TUM1.yaml")
    fx, fy, cx, cy = (y[f"Camera.{k}"] for k in ("fx", "fy", "cx", "cy"))
    W, H = y["Camera.width"], y["Camera.height"]
    K = S.make_K(fx, fy, cx, cy)
    dist = np.array([y[f"Camera.{k}"] for k in DIST])
    # the world point the undistorted pixel sees, on whichever plane it sees
    u, v = pixel
    plane = S.PlaneScene(np.zeros((8, 8), np.float32))
    P, _ = plane.hit(K, np.eye(4), np.array([u], float), np.array([v], float))
    tex = np.zeros((S.TEXTURE_SIZE, S.TEXTURE_SIZE), np.float32)
    tx, ty = P[0, :2] * S.PX_PER_UNIT + S.TEXTURE_SIZE / 2
    gy, gx = np.mgrid[0:S.TEXTURE_SIZE, 0:S.TEXTURE_SIZE]
    tex[:] = 255.0 * np.exp(-((gy - ty) ** 2 + (gx - tx) ** 2) / (2 * 3.0 ** 2))
    img = S.PlaneScene(tex).render(K, np.eye(4), H, W, dist)
    cam = Camera.create(fx, fy, cx, cy, *dist, 0.0, W, H)
    xy = torch.tensor([[P[0, 0] / P[0, 2], P[0, 1] / P[0, 2]]], dtype=torch.float32)
    xd = distort_normalized(cam, xy)[0].numpy().astype(np.float64)
    want = np.array([xd[0] * fx + cx, xd[1] * fy + cy])
    assert np.hypot(*(want - pixel)) > 2.0          # the distortion moves it
    r0, c0 = int(round(want[1])), int(round(want[0]))
    win = img[r0 - 15:r0 + 16, c0 - 15:c0 + 16].astype(np.float64)
    rr, cc = np.mgrid[r0 - 15:r0 + 16, c0 - 15:c0 + 16]
    got = np.array([(win * cc).sum() / win.sum(), (win * rr).sum() / win.sum()])
    assert np.hypot(*(got - want)) < 0.5, (got, want)


def test_undistortion_inverts_the_model():
    y = published(YAMLS / "Monocular/TUM1.yaml")
    K = S.make_K(*(y[f"Camera.{k}"] for k in ("fx", "fy", "cx", "cy")))
    dist = np.array([y[f"Camera.{k}"] for k in DIST])
    us, vs = np.meshgrid(np.arange(0, 640, 7.0), np.arange(0, 480, 5.0))
    u, v = S.undistort_pixels(K, dist, us.ravel(), vs.ravel())
    xd, yd = S.distort(dist, (u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1])
    assert np.abs(xd * K[0, 0] + K[0, 2] - us.ravel()).max() < 1e-3
    assert np.abs(yd * K[1, 1] + K[1, 2] - vs.ravel()).max() < 1e-3


def test_monocular_warm_up_that_never_initializes_exits_6(files, monkeypatch, capsys):
    """A run whose monocular System finds nothing to initialize from (a
    texture-free scene) in warm-up has no result."""
    cut = small_cell("tum1_mono_lines.mono")
    cut.traffic["scene"]["texture"] = "flat"
    monkeypatch.setattr(C, "load", lambda workload: cut)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    real = R.run_cell
    monkeypatch.setattr(R, "run_cell", lambda cell, seed, s, t, dev, t0:
                        real(cell, seed, s, t, "cpu", t0))
    code = R.main(["--workload", "tum1_mono_lines.mono", "--seed", str(SEED), "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert code == R.NOT_INITIALIZED == 6
    assert out.out == ""
    assert "did not initialize in warm-up" in out.err


def counted_clock(monkeypatch):
    """The loop's clock made a count of its calls: a window of `seconds`
    holds exactly that many calls, on any machine."""
    made = [0]
    real = drive.Loop._call

    def call(self, *a, **k):
        made[0] += 1
        return real(self, *a, **k)

    monkeypatch.setattr(drive.Loop, "_call", call)
    monkeypatch.setattr(drive, "time", types.SimpleNamespace(
        perf_counter=lambda: float(made[0]), thread_time=time.thread_time))


@pytest.mark.parametrize("workload", ["kitti_stereo.live_mapping",
                                      "kitti_stereo.batch32_tracking"])
def test_stereo_numbers_equal_the_harness_before_checks_were_files(workload, monkeypatch):
    """The numbers each stereo cell compares, the program's and the
    control's, on seed 1234567 in a window of 12 calls on one CPU thread,
    equal to the float those the harness gave before its checks moved into
    `checks/` (`parity_1234567.json`, recorded with that harness)."""
    want = json.loads((BENCH / "tests" / "parity_1234567.json").read_text())[workload]
    counted_clock(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m = R.measure(small_cell(workload), 1234567, 12.0, False, "cpu", time.perf_counter())
    finally:
        torch.set_num_threads(threads)
    assert (len(m.window.calls), m.window.frames) == (want["calls"], want["frames"])
    assert compare.numbers(m.cell, m.scene, m.out) == want["program"]
    assert compare.numbers(m.cell, m.scene, m.out, control=True) == want["control"]
