"""The port's entry points run on the card unless the caller asks for the
CPU (checked by signature: this host has no card), and a missing card is
an error, never a quiet switch to the CPU; `System.last_image` (the
viewer's snapshot, as the JAX System publishes it) is the caller's host
image of the last tracked frame for every sensor; and the KITTI drivers
read their folders through the native prefetcher."""

import inspect

import numpy as np
import pytest
import torch

from splslam_tpu_torch import graft_entry
from splslam_tpu_torch.bow import vocabulary as TV
from splslam_tpu_torch.io import synth_map as TSM
from splslam_tpu_torch.io.synthetic import make_rgbd_sequence, make_stereo_sequence
from splslam_tpu_torch.parallel import mesh as TM
from splslam_tpu_torch.slam.system import Sensor, Settings, System


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files side by side: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fn", [
    TSM.make_synthetic_map, TV.train, graft_entry.entry,
    graft_entry.make_gba_problem, graft_entry.dryrun_multichip, TM.launch,
], ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_dryrun_multichip_raises_without_enough_cards():
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="needs"):
        graft_entry.dryrun_multichip(n + 1)


def _settings(K, bf, **kw):
    return Settings(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), bf=float(bf), width=320, height=240,
        n_features=300, n_levels=3, th_depth=40.0, fps=10, max_points=4096,
        max_keyframes=16, local_window=512, enable_local_mapping=False,
        enable_relocalization=False, enable_loop_closing=False, **kw)


@pytest.mark.parametrize("sensor", ["stereo", "mono", "rgbd"])
def test_last_image_is_the_last_left_image(sensor):
    if sensor == "rgbd":
        K, bf, frames, _ = make_rgbd_sequence(n_frames=3, motion="forward",
                                              width=320, height=240)
        sysm = System(_settings(K, bf), Sensor.RGBD, "cpu")
    else:
        K, bf, frames, _ = make_stereo_sequence(n_frames=3, motion="forward",
                                                width=320, height=240)
        sysm = System(_settings(K, bf), Sensor.STEREO if sensor == "stereo"
                      else Sensor.MONOCULAR, "cpu")
    assert sysm.last_image is None
    for i, (a, b) in enumerate(frames):
        if sensor == "stereo":
            sysm.track_stereo(a, b, i * 0.1)
        elif sensor == "rgbd":
            sysm.track_rgbd(a, b, i * 0.1)
        else:
            sysm.track_mono(a, i * 0.1)
        assert isinstance(sysm.last_image, np.ndarray)
        # the caller's host array itself: nothing is copied back
        assert sysm.last_image is a
    sysm.reset()
    assert sysm.last_image is None


def test_stereo_kitti_driver_reads_through_the_prefetcher(tmp_path, monkeypatch):
    """`examples/stereo_kitti.py` on a written KITTI folder: every image
    comes from `PrefetchLoader`, each loader is closed, and the trajectory
    is the one of `track_stereo` on the PNGs' pixels."""
    cv2 = pytest.importorskip("cv2")
    from splslam_tpu_torch.examples import stereo_kitti
    from splslam_tpu_torch.io import native

    K, bf, frames, _ = make_stereo_sequence(n_frames=5, motion="forward",
                                            width=320, height=240)
    seq = tmp_path / "seq"
    for d in ("image_0", "image_1"):
        (seq / d).mkdir(parents=True)
    (seq / "times.txt").write_text("\n".join(f"{0.1 * i!r}" for i in range(5)))
    pixels = [(l.astype(np.uint8), r.astype(np.uint8)) for l, r in frames]
    for i, (l, r) in enumerate(pixels):
        cv2.imwrite(str(seq / "image_0" / f"{i:06d}.png"), l)
        cv2.imwrite(str(seq / "image_1" / f"{i:06d}.png"), r)
    yaml_path = tmp_path / "kitti.yaml"
    yaml_path.write_text(
        "%YAML:1.0\n"
        f"Camera.fx: {float(K[0, 0])}\nCamera.fy: {float(K[1, 1])}\n"
        f"Camera.cx: {float(K[0, 2])}\nCamera.cy: {float(K[1, 2])}\n"
        f"Camera.bf: {float(bf)}\nCamera.width: 320\nCamera.height: 240\n"
        "Camera.fps: 10.0\nThDepth: 40.0\n"
        "ORBextractor.nFeatures: 300\nORBextractor.nLevels: 3\n")
    loaders, reads = [], []

    class Counting(native.PrefetchLoader):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            loaders.append(self)

        def __getitem__(self, i):
            reads.append(i)
            return super().__getitem__(i)

    monkeypatch.setattr(stereo_kitti, "PrefetchLoader", Counting)
    out = tmp_path / "traj.txt"
    assert stereo_kitti.main([str(yaml_path), str(seq), str(out),
                              "--device", "cpu"]) == 0
    assert len(loaders) == 2 and all(dl._h is None for dl in loaders)
    assert sorted(reads) == sorted(list(range(5)) * 2)

    from splslam_tpu_torch.io.config import load_settings

    st, _ = load_settings(str(yaml_path))
    direct = System(st, Sensor.STEREO, "cpu")
    for i, (l, r) in enumerate(pixels):
        direct.track_stereo(l, r, 0.1 * i)
    direct.drain()
    est = np.loadtxt(out).reshape(-1, 3, 4)
    np.testing.assert_allclose(est, direct.poses_reconstructed()[:, :3, :4],
                               atol=1e-6)
