"""The port's native prefetcher (`splslam_tpu_torch/io/native.py`, the C++
pool of native/dataloader.cpp built with g++ under the git-ignored
build/native/) on tests/test_native_loader.py's cases, and against the
JAX package's `PrefetchLoader` on the same PNG and PGM files: pixels
exactly equal. A build that fails raises with g++'s stderr."""

import numpy as np
import pytest

from splslam_tpu.io.native import PrefetchLoader as JPrefetchLoader
from splslam_tpu_torch.io import native as TN
from splslam_tpu_torch.io.native import PrefetchLoader


def _write_pngs(tmp_path, n=6, w=64, h=48):
    import cv2

    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        img = rng.integers(0, 255, (h, w), dtype=np.uint8)
        p = str(tmp_path / f"{i:06d}.png")
        cv2.imwrite(p, img)
        paths.append(p)
    return paths


def _write_pgm(tmp_path, seed=1, w=64, h=48):
    img = np.random.default_rng(seed).integers(0, 255, (h, w), dtype=np.uint8)
    p = str(tmp_path / "img.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n# comment\n64 48\n255\n")
        f.write(img.tobytes())
    return p, img


def test_native_lib_builds_under_build():
    lib = TN._load_lib()
    assert lib is TN._load_lib()                 # cached per process
    built = list(TN._BUILD_DIR.glob("splloader-*.so"))
    assert built and TN._BUILD_DIR.parts[-2:] == ("build", "native")


def test_failed_build_raises_with_stderr(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(TN, "_SOURCE", bad)
    monkeypatch.setattr(TN, "_BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(TN, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        TN._load_lib()
    assert "bad.cpp" in str(e.value)
    assert not list((tmp_path / "out").glob("*"))   # no partial library left


def test_prefetch_matches_cv2(tmp_path):
    import cv2

    paths = _write_pngs(tmp_path)
    with PrefetchLoader(paths, 64, 48, lookahead=3, n_threads=2) as dl:
        for i in range(len(paths)):
            native = dl[i]
            ref = cv2.imread(paths[i], cv2.IMREAD_GRAYSCALE)
            np.testing.assert_array_equal(native, ref)


def test_prefetch_pgm(tmp_path):
    p, img = _write_pgm(tmp_path)
    with PrefetchLoader([p], 64, 48) as dl:
        np.testing.assert_array_equal(dl[0], img)


def test_prefetch_out_of_order_and_missing(tmp_path):
    paths = _write_pngs(tmp_path, n=4)
    with PrefetchLoader(paths, 64, 48) as dl:
        a = dl[3]
        b = dl[0]
        assert a.shape == b.shape == (48, 64)
    # a missing file raises (the C decoder fails, the fallback reader too)
    with PrefetchLoader([str(tmp_path / "nope.png")], 64, 48) as dl:
        with pytest.raises(FileNotFoundError):
            dl[0]


def test_prefetch_fallback_pads_to_the_requested_size(tmp_path):
    """A format the C decoder does not cover (a 16-bit PNG) goes through
    `imread_gray` and is zero-padded or cropped to (height, width)."""
    import cv2

    img16 = (np.arange(30 * 40, dtype=np.uint16).reshape(30, 40) * 50)
    p = str(tmp_path / "deep.png")
    cv2.imwrite(p, img16)
    ref = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
    with PrefetchLoader([p, p], 64, 20) as dl, JPrefetchLoader([p, p], 64, 20) as jl:
        for i in range(2):
            got = dl[i]
            np.testing.assert_array_equal(got, jl[i])
            np.testing.assert_array_equal(got[:, :40], ref[:20])
            assert not got[:, 40:].any()


def test_pixels_equal_the_jax_loader(tmp_path):
    paths = _write_pngs(tmp_path, n=5, w=96, h=72)
    pgm, _ = _write_pgm(tmp_path)
    with PrefetchLoader(paths, 96, 72, lookahead=2) as dl, \
            JPrefetchLoader(paths, 96, 72, lookahead=2) as jl:
        for i in (0, 2, 1, 4, 3):
            np.testing.assert_array_equal(dl[i], jl[i])
    # a size mismatch is centre-cropped / padded in C by both
    with PrefetchLoader([pgm], 50, 60) as dl, JPrefetchLoader([pgm], 50, 60) as jl:
        np.testing.assert_array_equal(dl[0], jl[0])
