"""The port's twins of the JAX package's scripts, on the CPU at small
sizes: `scripts/port_train_vocab.py` (the descriptors it collects against
the JAX ORB on the same synthetic images; a vocabulary trained from them
and written by the port's `save`, read back by the JAX package's `load`)
and `scripts/port_gba_scaling.py` (edges/s of the sharded global BA at
worlds 1 and 2 over gloo, and the rows it prints). Both default to the
card, and stop with a message on a host without one.

Tolerances: ORB keypoint validity exact and descriptor bits >= 99.5%
equal (the repo's kernel tolerance, tests/test_orb_pallas.py); the
vocabulary's tables equal after the round trip."""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.bow import vocabulary as JV
from splslam_tpu.io.synthetic import make_stereo_sequence
from splslam_tpu.ops.orb import extract_orb
from splslam_tpu.ops.pyramid import PyramidSpec
from splslam_tpu_torch.bow import vocabulary as TV

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
BIT_AGREE = 0.995


def _script(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files side by side: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_vocab_collects_the_jax_descriptors_and_writes_a_vocabulary(tmp_path):
    tv = _script("port_train_vocab")
    n_seeds, n_frames, W, H, nf = 2, 2, 160, 120, 150
    D, I, n_img = tv.collect(n_seeds, n_frames, W, H, nf, "cpu")
    # scripts/train_vocab.py's loop with the JAX ORB: both eyes on even seeds
    spec = PyramidSpec.create(H, W, n_features=nf, n_levels=4, scale_factor=1.2)
    want = []
    for seed in range(n_seeds):
        _, _, frames, _ = make_stereo_sequence(
            n_frames=n_frames, width=W, height=H,
            motion=("forward", "lateral", "arc")[seed % 3], seed=seed,
            texture="grid" if seed % 4 == 3 else "blobs",
            scene="corridor" if seed % 5 == 4 else "planes")
        for l, r in frames:
            for img in (l, r) if seed % 2 == 0 else (l,):
                f = extract_orb(jnp.asarray(img, jnp.float32), spec)
                want.append(np.asarray(f.desc)[np.asarray(f.valid)])
    assert n_img == len(want) == 6
    assert D.dtype == np.uint32 and len(D) == sum(map(len, want)) == len(I)
    np.testing.assert_array_equal(np.bincount(I), [len(w) for w in want])
    bits = lambda d: np.unpackbits(d.view(np.uint8))
    assert (bits(D) == bits(np.concatenate(want))).mean() >= BIT_AGREE

    voc = TV.train(D, k=4, depth=2, seed=0, image_ids=I, device="cpu")
    path = str(tmp_path / "voc.npz")
    TV.save(voc, path)
    back = JV.load(path)
    assert (back.k, back.depth) == (4, 2)
    for tl, jl in zip(voc.level_desc, back.level_desc):
        np.testing.assert_array_equal(tl.numpy().view(np.uint32), np.asarray(jl))
    np.testing.assert_array_equal(voc.weights.numpy(), np.asarray(back.weights))


def test_gba_scaling_rows_on_gloo_ranks(capsys):
    gs = _script("port_gba_scaling")
    kw = dict(n_kfs=6, n_pts=512, obs_per_kf=128, n_lines=16, line_obs=2)
    rows = gs.measure([1, 2], device="cpu", reps=1, problem_kw=kw, timeout_s=120)
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == rows
    assert [r["n_devices"] for r in rows] == [1, 2]
    E = rows[0]["edges"]
    assert E > 6 * 128 and all(r["edges"] == E for r in rows)
    for r in rows:
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["n_guarded"] == 0 and r["solve_s"] > 0
        assert abs(r["value"] - E * 2 * 2 / r["solve_s"]) <= 1


@pytest.mark.parametrize("name,argv", [("port_gba_scaling", ["1"]),
                                       ("port_train_vocab", ["--small"])])
def test_scripts_default_to_the_card(name, argv):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(SystemExit, match="no CUDA device"):
        _script(name).main(argv)
