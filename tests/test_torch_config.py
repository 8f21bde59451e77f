"""The port's entry points against the JAX package's: the reference YAML
loader (`io/config.py`, every bundled YAML, the key contract of
tests/test_config.py and the parsing cases of tests/test_examples.py),
the dataset loaders (`io/datasets.py`, on TUM, KITTI and EuRoC folders
the test writes), the ORB-SLAM2 text vocabulary (`load_orbslam_txt`, on
tests/test_reloc.py's hand-written file and a random incomplete tree),
and the drivers (`examples/rgbd_tum.py` on a TUM-layout folder of PNGs,
the KITTI, EuRoC and TUM stereo and mono drivers on folders of their
datasets' layouts, `examples/stereo_mynt.py::run_live` on the synthetic
stereo source), all on the CPU (`device="cpu"` / `--device cpu`).

Everything compared here is exact: Settings fields, raw dicts, path and
timestamp lists, vocabulary tables and weights, word ids."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.bow import vocabulary as JV
from splslam_tpu.io import config as JC
from splslam_tpu.io import datasets as JD
from splslam_tpu.io.synthetic import make_rgbd_sequence, make_stereo_sequence
from splslam_tpu.slam import system as JS
from splslam_tpu_torch.bow import vocabulary as TV
from splslam_tpu_torch.examples import CONFIGS
from splslam_tpu_torch.io import config as TC
from splslam_tpu_torch.io import datasets as TD
from splslam_tpu_torch.slam import system as TS
from test_config import CONSUMED, DRIVER_CONSUMED_PREFIXES, NA_KEYS
from test_examples import SMALL, _write_yaml

YAMLS = sorted(glob.glob(os.path.join(CONFIGS, "**", "*.yaml"), recursive=True))
SHARED = [f for f in TS.Settings.__dataclass_fields__ if f in JS.Settings.__dataclass_fields__]
W, H = 320, 240


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread beside the other test files' workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_raw(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        if isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k] and type(a[k]) is type(b[k]), k


# ---------------------------------------------------------------------
# settings
# ---------------------------------------------------------------------
def test_settings_fields_cover_the_jax_package():
    """Every JAX Settings field is the port's, with its default, the
    batch-mode knobs (`batch_defer_stats`, `batch_defer_depth`) included."""
    missing = set(JS.Settings.__dataclass_fields__) - set(SHARED)
    assert missing == set()
    for f in SHARED:
        assert getattr(TS.Settings(), f) == getattr(JS.Settings(), f), f


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: os.path.relpath(p, CONFIGS))
def test_load_settings_matches_jax(path):
    ts, traw = TC.load_settings(path)
    js, jraw = JC.load_settings(path)
    for f in SHARED:
        assert getattr(ts, f) == getattr(js, f), f
    _same_raw(traw, jraw)


def test_bundled_configs():
    """tests/test_examples.py's spot checks against the public
    calibrations, and the RGB-D depth factor."""
    assert len(YAMLS) >= 16
    st, _ = TC.load_settings(os.path.join(CONFIGS, "Stereo", "KITTI00-02.yaml"))
    assert st.fx == pytest.approx(718.856) and st.bf == pytest.approx(386.1448)
    assert (st.width, st.height) == (1241, 376)
    assert st.n_features == 2000 and not st.using_line
    st, _ = TC.load_settings(os.path.join(CONFIGS, "Monocular", "TUM1.yaml"))
    assert st.using_line and st.fx == pytest.approx(517.306408)
    assert st.line_features == 600
    st, raw = TC.load_settings(os.path.join(CONFIGS, "Stereo", "EuRoC.yaml"))
    assert raw["LEFT.R"].shape == (3, 3) and raw["RIGHT.P"].shape == (3, 4)
    assert raw["RIGHT.P"][0, 3] == pytest.approx(-47.90639384423901)
    st, _ = TC.load_settings(os.path.join(CONFIGS, "RGB-D", "TUM1.yaml"))
    assert st.depth_map_factor == pytest.approx(1.0 / 5000.0)
    assert st.th_depth == 40.0 and st.bf == pytest.approx(40.0)


def test_bundled_yaml_keys_all_consumed(monkeypatch):
    """tests/test_config.py's contract, held on the port: the keys its
    `load_settings` reads are that test's CONSUMED set, and every key of
    every bundled YAML is read, driver-consumed or on the N/A list."""
    read = set()
    parse = TC._load_cv_yaml

    class Recording(dict):
        def get(self, key, default=None):
            read.add(key)
            return super().get(key, default)

    monkeypatch.setattr(TC, "_load_cv_yaml", lambda p: Recording(parse(p)))
    keys = set()
    for p in YAMLS:
        TC.load_settings(p)
        keys |= set(parse(p))
    assert read == CONSUMED
    unknown = {k for k in keys - read - NA_KEYS
               if not k.startswith(DRIVER_CONSUMED_PREFIXES)}
    assert not unknown, unknown


def test_parses_scalars_and_matrices(tmp_path):
    K, bf, _, _ = make_stereo_sequence(n_frames=1, motion="lateral", width=W, height=H)
    path = _write_yaml(tmp_path, K, bf, with_rect=True)
    st, raw = TC.load_settings(path)
    assert st.fx == pytest.approx(float(K[0, 0])) and st.bf == pytest.approx(float(bf))
    assert (st.width, st.height) == (W, H)
    assert st.n_features == 600 and st.n_levels == 4
    assert raw["LEFT.K"].shape == (3, 3) and raw["RIGHT.P"].shape == (3, 4)
    _same_raw(raw, JC.load_settings(path)[1])
    st, _ = TC.load_settings(path, n_features=128, max_keyframes=16)
    assert st.n_features == 128 and st.max_keyframes == 16


def test_usinglsd_and_line_block_reach_settings(tmp_path):
    y = tmp_path / "fld.yaml"
    y.write_text(
        "%YAML:1.0\n"
        "Camera.fx: 200.0\nCamera.fy: 200.0\nCamera.cx: 160.0\nCamera.cy: 120.0\n"
        "Camera.width: 320\nCamera.height: 240\nCamera.fps: 10.0\n"
        "System.usingLine: 1\nSystem.usingLsdFeature: 0\n"
        "Lineextractor.nFeatures: 64\nLineextractor.nLevels: 1\n"
        "Lineextractor.min_line_length_ratio: 0.1\n")
    st, _ = TC.load_settings(str(y), max_points=2048, max_keyframes=8, local_window=256,
                             n_features=200, n_levels=2, enable_local_mapping=False,
                             enable_relocalization=False)
    assert st.using_line and not st.using_lsd and st.line_features == 64
    assert st.line_n_levels == 1 and abs(st.line_min_length_ratio - 0.1) < 1e-9
    sysm = TS.System(st, TS.Sensor.MONOCULAR, "cpu")
    assert sysm.line_cfg == ("fld", 1, 0.1 * 240)


def test_fld_backend_tracks_from_yaml(tmp_path):
    """A stereo sequence tracked with the fld backend chosen in the YAML."""
    K, bf, frames, _ = make_stereo_sequence(n_frames=8, motion="lateral", width=W,
                                            height=H, seed=3)
    y = tmp_path / "fld_stereo.yaml"
    y.write_text(
        "%YAML:1.0\n"
        f"Camera.fx: {float(K[0, 0])}\nCamera.fy: {float(K[1, 1])}\n"
        f"Camera.cx: {float(K[0, 2])}\nCamera.cy: {float(K[1, 2])}\n"
        f"Camera.bf: {float(bf)}\nCamera.width: 320\nCamera.height: 240\n"
        "Camera.fps: 10.0\nThDepth: 40\nSystem.usingLine: 1\n"
        "System.usingLsdFeature: 0\nLineextractor.nFeatures: 32\n"
        "Lineextractor.nLevels: 2\n")
    st, _ = TC.load_settings(str(y), n_features=300, n_levels=2, max_points=4096,
                             max_keyframes=16, local_window=512,
                             enable_local_mapping=False, enable_relocalization=False)
    sysm = TS.System(st, TS.Sensor.STEREO, "cpu")
    assert sysm.line_cfg[0] == "fld"
    for i, (l, r) in enumerate(frames):
        sysm.track_stereo(l, r, i * 0.1)
    assert sysm.get_tracking_state() == TS.TrackingState.OK
    assert int(sysm.step.frame.lines.valid.sum()) >= 1


# ---------------------------------------------------------------------
# dataset loaders
# ---------------------------------------------------------------------
def _tum_folder(root, n=10, depth_dt=0.011, no_depth=3):
    """rgb.txt and depth.txt of a TUM sequence (comments, and the rgb row
    `no_depth` with no depth within 0.02 s)."""
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(exist_ok=True)
    ts = [1305031102.175304 + 0.1 * i for i in range(n)]
    rgb = ["# color images", "# timestamp filename"]
    dep = ["# depth maps"]
    for i, t in enumerate(ts):
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        if i != no_depth:
            td = t + depth_dt * (1 if i % 2 else -1)
            dep.append(f"{td:.6f} depth/{td:.6f}.png")
    (root / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (root / "depth.txt").write_text("\n".join(dep) + "\n")
    return ts


def test_tum_loaders_match_jax(tmp_path):
    _tum_folder(tmp_path)
    seq = str(tmp_path)
    assert TD.load_tum_mono(seq) == JD.load_tum_mono(seq)
    got = TD.load_tum_rgbd(seq)
    assert got == JD.load_tum_rgbd(seq)
    assert len(got[2]) == 9   # the row with no depth is dropped
    assert TD.load_tum_rgbd(seq, max_dt=0.005) == JD.load_tum_rgbd(seq, max_dt=0.005)


def test_kitti_loaders_match_jax(tmp_path):
    (tmp_path / "times.txt").write_text(
        "\n".join(f"{0.103 * i:e}" for i in range(7)) + "\n")
    seq = str(tmp_path)
    assert TD.load_kitti_stereo(seq) == JD.load_kitti_stereo(seq)
    assert TD.load_kitti_mono(seq) == JD.load_kitti_mono(seq)
    assert len(TD.load_kitti_mono(seq)[0]) == 7


@pytest.mark.parametrize("stereo", [True, False])
def test_euroc_loader_matches_jax(tmp_path, stereo):
    cam0 = tmp_path / "mav0" / "cam0"
    (cam0 / "data").mkdir(parents=True)
    if stereo:
        (tmp_path / "mav0" / "cam1" / "data").mkdir(parents=True)
    rows = ["#timestamp [ns],filename"] + [
        f"{1403636579763555584 + 50000000 * i},{1403636579763555584 + 50000000 * i}.png"
        for i in range(5)] + [""]
    (cam0 / "data.csv").write_text("\n".join(rows))
    seq = str(tmp_path)
    got = TD.load_euroc(seq)
    assert got == JD.load_euroc(seq)
    assert len(got[2]) == 5 and (got[1] is not None) == stereo


def test_rectify_and_imread_match_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    raw = JC.load_settings(os.path.join(CONFIGS, "Stereo", "EuRoC.yaml"))[1]
    (tl, tr), (jl, jr) = TD.euroc_rectify_maps(raw), JD.euroc_rectify_maps(raw)
    for a, b in ((tl, jl), (tr, jr)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    img = (np.random.default_rng(0).uniform(0, 255, (480, 752))).astype(np.uint8)
    p = str(tmp_path / "img.png")
    cv2.imwrite(p, img)
    np.testing.assert_array_equal(TD.imread_gray(p), JD.imread_gray(p))
    np.testing.assert_array_equal(TD.rectify(img, tl), JD.rectify(img, jl))
    with pytest.raises(FileNotFoundError):
        TD.imread_gray(str(tmp_path / "missing.png"))


# ---------------------------------------------------------------------
# the ORB-SLAM2 text vocabulary
# ---------------------------------------------------------------------
def _node_line(parent, is_leaf, d, w):
    return f"{parent} {int(is_leaf)} " + " ".join(str(int(x)) for x in d) + f" {w}"


def _reloc_test_vocab(path):
    """tests/test_reloc.py::test_load_orbslam_txt_roundtrip's file: k 2, L 2,
    four well-separated leaf words. Returns the leaves' bytes."""
    leaf = np.zeros((4, 32), np.uint8)
    for i in range(4):
        leaf[i, 8 * i:8 * i + 8] = 255
    lvl1 = np.zeros((2, 32), np.uint8)
    lvl1[0, :16] = 128
    lvl1[1, 16:] = 128
    lines = ["2 2 0 0", _node_line(0, 0, lvl1[0], 0.0), _node_line(0, 0, lvl1[1], 0.0),
             _node_line(1, 1, leaf[0], 0.5), _node_line(1, 1, leaf[1], 0.6),
             _node_line(2, 1, leaf[2], 0.7), _node_line(2, 1, leaf[3], 0.8)]
    path.write_text("\n".join(lines) + "\n")
    return leaf


def _random_tree_vocab(path, k=3, depth=3, seed=2):
    """A random DBoW2 text tree in which some nodes have fewer than k
    children (the complete-tree layout pads them with sentinels)."""
    rng = np.random.default_rng(seed)
    lines = [f"{k} {depth} 0 0"]
    frontier, n = [0], 0
    for l in range(depth):
        nxt = []
        for parent in frontier:
            for _ in range(int(rng.integers(1, k + 1))):
                n += 1
                d = rng.integers(0, 256, 32)
                lines.append(_node_line(parent, l == depth - 1, d,
                                        round(float(rng.uniform(0.1, 3.0)), 6)))
                nxt.append(n)
        frontier = nxt
    path.write_text("\n".join(lines) + "\n")


def _same_vocab(tv, jv):
    assert (tv.k, tv.depth) == (jv.k, jv.depth)
    for a, b in zip(tv.level_desc, jv.level_desc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).view(np.int32))
    np.testing.assert_array_equal(tv.weights.numpy(), np.asarray(jv.weights))


def test_load_orbslam_txt_matches_jax(tmp_path):
    leaf = _reloc_test_vocab(tmp_path / "voc.txt")
    tv = TV.load_orbslam_txt(str(tmp_path / "voc.txt"), "cpu")
    _same_vocab(tv, JV.load_orbslam_txt(str(tmp_path / "voc.txt")))
    assert tv.n_words == 4
    np.testing.assert_allclose(tv.weights.numpy(), [0.5, 0.6, 0.7, 0.8])
    # the leaf descriptors land in their own words
    words = TV.transform_words(tv, torch.from_numpy(leaf.view("<u4").view(np.int32)),
                               torch.ones(4, dtype=torch.bool))
    assert words.tolist() == [0, 1, 2, 3]
    _random_tree_vocab(tmp_path / "rand.txt")
    tv = TV.load_orbslam_txt(str(tmp_path / "rand.txt"), "cpu")
    jv = JV.load_orbslam_txt(str(tmp_path / "rand.txt"))
    _same_vocab(tv, jv)
    desc = np.random.default_rng(3).integers(0, 2 ** 32, (64, 8), dtype=np.uint32)
    valid = np.ones(64, bool)
    np.testing.assert_array_equal(
        TV.transform_words(tv, torch.from_numpy(desc.view(np.int32)),
                           torch.from_numpy(valid)).numpy(),
        np.asarray(JV.transform_words(jv, jnp.asarray(desc), jnp.asarray(valid))))


def test_system_from_a_txt_vocabulary(tmp_path):
    """A System built from a `.txt` path tracks and registers its
    keyframes' BoW rows in that vocabulary's words."""
    _random_tree_vocab(tmp_path / "voc.txt")
    K, bf, frames, _ = make_stereo_sequence(n_frames=4, motion="forward", width=W,
                                            height=H)
    st = TS.Settings(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                     cy=float(K[1, 2]), bf=float(bf), width=W, height=H,
                     n_features=600, n_levels=4, th_depth=40.0, fps=10,
                     enable_local_mapping=False, force_kf_every=1,
                     vocabulary_path=str(tmp_path / "voc.txt"), **SMALL)
    sysm = TS.System(st, TS.Sensor.STEREO, "cpu")
    assert (sysm.vocab.k, sysm.vocab.depth, sysm.bow_n_words) == (3, 3, 27)
    for i, (l, r) in enumerate(frames):
        sysm.track_stereo(l, r, i * 0.1)
    assert sysm.get_tracking_state() == TS.TrackingState.OK and sysm.n_kfs >= 2
    ids = sysm.kf_bow.ids[:sysm.n_kfs].numpy()
    filled = ids[ids < sysm.bow_n_words]
    assert filled.size > 0 and filled.min() >= 0


# ---------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------
def test_rgbd_tum_driver(tmp_path, capsys):
    """`python -m splslam_tpu_torch.examples.rgbd_tum <yaml> <seq> <out>
    --device cpu` on a 10-frame TUM-layout folder of PNGs (depth as uint16
    in 1/1000 m, DepthMapFactor 1000): a TUM trajectory of 10 rows."""
    cv2 = pytest.importorskip("cv2")
    from splslam_tpu_torch.examples import rgbd_tum

    K, bf, frames, gt = make_rgbd_sequence(n_frames=10, motion="forward", width=W,
                                           height=H)
    seq = tmp_path / "seq"
    ts = _tum_folder(seq, depth_dt=0.004, no_depth=None)
    rgb, dep, _ = TD.load_tum_rgbd(str(seq))
    assert len(rgb) == 10
    for (img, depth), p, d in zip(frames, rgb, dep):
        cv2.imwrite(p, np.clip(np.round(img), 0, 255).astype(np.uint8))
        cv2.imwrite(d, np.round(np.asarray(depth) * 1000.0).astype(np.uint16))
    yaml_path = tmp_path / "rgbd.yaml"
    yaml_path.write_text(
        "%YAML:1.0\n"
        f"Camera.fx: {float(K[0, 0])}\nCamera.fy: {float(K[1, 1])}\n"
        f"Camera.cx: {float(K[0, 2])}\nCamera.cy: {float(K[1, 2])}\n"
        f"Camera.bf: {float(bf)}\nCamera.width: {W}\nCamera.height: {H}\n"
        "Camera.fps: 10.0\nThDepth: 40.0\nDepthMapFactor: 1000.0\n"
        "ORBextractor.nFeatures: 600\nORBextractor.nLevels: 4\n")
    out = tmp_path / "CameraTrajectory.txt"
    assert rgbd_tum.main([str(yaml_path), str(seq), str(out), "--device", "cpu"]) == 0
    rows = out.read_text().strip().split("\n")
    assert len(rows) == 10 and all(len(r.split()) == 8 for r in rows)
    assert float(rows[0].split()[0]) == pytest.approx(ts[0])
    err = capsys.readouterr().err
    assert "Tracking total / frame" in err and "health:" in err
    est = np.loadtxt(out)
    assert np.linalg.norm(est[-1, 1:4] - gt[-1][:3, 3]) < 0.05


def _u8(img):
    return np.clip(np.round(np.asarray(img)), 0, 255).astype(np.uint8)


def _write_kitti(cv2, seq, frames):
    for d in ("image_0", "image_1"):
        (seq / d).mkdir(parents=True)
    (seq / "times.txt").write_text("\n".join(f"{0.1 * i:e}" for i in range(len(frames))))
    for i, (l, r) in enumerate(frames):
        cv2.imwrite(str(seq / "image_0" / f"{i:06d}.png"), _u8(l))
        cv2.imwrite(str(seq / "image_1" / f"{i:06d}.png"), _u8(r))


def _write_euroc(cv2, seq, frames):
    rows = ["#timestamp [ns],filename"]
    for cam in ("cam0", "cam1"):
        (seq / "mav0" / cam / "data").mkdir(parents=True)
    for i, (l, r) in enumerate(frames):
        name = f"{1403636579763555584 + 50000000 * i}.png"
        rows.append(f"{name[:-4]},{name}")
        cv2.imwrite(str(seq / "mav0" / "cam0" / "data" / name), _u8(l))
        cv2.imwrite(str(seq / "mav0" / "cam1" / "data" / name), _u8(r))
    (seq / "mav0" / "cam0" / "data.csv").write_text("\n".join(rows) + "\n")


def _write_tum_mono(cv2, seq, frames):
    (seq / "rgb").mkdir(parents=True)
    rows = ["# color images"]
    for i, (l, _) in enumerate(frames):
        t = 1305031102.175304 + 0.1 * i
        rows.append(f"{t:.6f} rgb/{t:.6f}.png")
        cv2.imwrite(str(seq / "rgb" / f"{t:.6f}.png"), _u8(l))
    (seq / "rgb.txt").write_text("\n".join(rows) + "\n")


@pytest.mark.parametrize("driver,layout,stereo,cols", [
    ("stereo_kitti", _write_kitti, True, 12),
    ("stereo_euroc", _write_euroc, True, 8),
    ("mono_kitti", _write_kitti, False, 12),
    ("mono_euroc", _write_euroc, False, 8),
    ("mono_tum", _write_tum_mono, False, 8),
])
def test_dataset_drivers(tmp_path, capsys, driver, layout, stereo, cols):
    """The other drivers on dataset folders of PNGs the test writes (stereo:
    6 forward frames, every one tracked; mono: 8 frames of the grid scene,
    logged from the bootstrap's reference frame on), `--device cpu`. The
    EuRoC stereo driver rectifies with identity maps (tests/test_examples.py's
    calibration, P = K)."""
    import importlib

    cv2 = pytest.importorskip("cv2")
    if stereo:
        K, bf, frames, _ = make_stereo_sequence(n_frames=6, motion="forward",
                                                width=W, height=H)
    else:
        K, bf, frames, _ = make_stereo_sequence(n_frames=8, motion="lateral",
                                                width=W, height=H, texture="grid")
    seq = tmp_path / "seq"
    layout(cv2, seq, frames)
    out = tmp_path / "traj.txt"
    main = importlib.import_module(f"splslam_tpu_torch.examples.{driver}").main
    yaml_path = _write_yaml(tmp_path, K, bf, with_rect=driver == "stereo_euroc")
    assert main([yaml_path, str(seq), str(out), "--device", "cpu"]) == 0
    rows = [r.split() for r in out.read_text().strip().split("\n")]
    assert all(len(r) == cols for r in rows)
    assert len(rows) == len(frames) if stereo else 2 <= len(rows) <= len(frames)
    assert "health:" in capsys.readouterr().err


def test_driver_command_line():
    from splslam_tpu_torch.examples._common import driver_args

    a = driver_args("x", "T.txt", ["s.yaml", "seq"])
    assert (a.settings, a.sequence, a.out, a.device) == ("s.yaml", "seq", "T.txt", "cuda")
    a = driver_args("x", "T.txt", ["s.yaml", "seq", "o.txt", "--device", "cpu"])
    assert (a.out, a.device) == ("o.txt", "cpu")


class TestLiveDriver:
    """tests/test_examples.py's live-driver cases on the port."""

    @pytest.fixture(scope="class")
    def scene(self):
        return make_stereo_sequence(n_frames=8, motion="lateral", width=W, height=H)

    @staticmethod
    def _source(frames):
        for i, (l, r) in enumerate(frames):
            yield l, r, i * 0.04

    def test_runs_and_saves_kitti_trajectory(self, tmp_path, scene):
        from splslam_tpu_torch.examples.stereo_mynt import run_live

        K, bf, frames, _ = scene
        out = tmp_path / "CameraTrajectory.txt"
        sysm = run_live(_write_yaml(tmp_path, K, bf), self._source(frames),
                        do_rectify=False, out_path=str(out), max_frames=6,
                        device="cpu", **SMALL)
        assert sysm.device.type == "cpu"
        assert sysm.get_tracking_state() == TS.TrackingState.OK
        rows = out.read_text().strip().split("\n")
        assert len(rows) == 6 and len(rows[0].split()) == 12

    def test_rectify_path_identity_maps(self, tmp_path, scene):
        pytest.importorskip("cv2")
        from splslam_tpu_torch.examples.stereo_mynt import run_live

        K, bf, frames, _ = scene
        out = tmp_path / "traj.txt"
        sysm = run_live(_write_yaml(tmp_path, K, bf, with_rect=True),
                        self._source(frames), do_rectify=True, out_path=str(out),
                        max_frames=4, device="cpu", **SMALL)
        assert sysm.get_tracking_state() == TS.TrackingState.OK
        assert len(out.read_text().strip().split("\n")) == 4

    def test_missing_calibration_raises(self, tmp_path, scene):
        from splslam_tpu_torch.examples.stereo_mynt import run_live

        K, bf, frames, _ = scene
        with pytest.raises(ValueError, match="calibration"):
            run_live(_write_yaml(tmp_path, K, bf), self._source(frames),
                     do_rectify=True, device="cpu")
