"""The comparison fails what it has to fail, on the CPU at a small size.

The controls (the reference in the program's place, one precision below,
or its answers one frame late) and the faults a cell can
have, each planted under a run that skips the harness's look for a card,
must come out not correct against each cell's own limits, through the
check files its traffic names. The same readings at the cells' own
sizes on the card are taken by `readings.py`.
"""

import time

import numpy as np
import pytest
import torch
from conftest import small_cell

import run as R
from harness import compare

CELLS = ["kitti_stereo.live_mapping", "kitti_stereo.batch32_tracking"]


@pytest.fixture(scope="module")
def measured():
    """One short CPU run of each cell: the program's outputs."""
    return {w: R.measure(small_cell(w), 1234567, 1.5, False, "cpu", time.perf_counter())
            for w in CELLS}


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(measured, workload):
    m = measured[workload]
    values = compare.numbers(m.cell, m.scene, m.out, control=True)
    correct, table = compare.judge(values, m.cell.limits)
    assert not correct, table
    # each number reads above its limit under its control
    assert all(t["value"] > t["limit"] for t in table.values()), table


def test_bfloat16_reference_moves_both_orb_numbers():
    from harness import cell as C
    from reference import orb as RO

    orb_gaps = C.check("orb").orb_gaps
    rng = np.random.default_rng(5)
    img = (rng.uniform(0, 255, (96, 128)).astype(np.float32))
    from scipy.ndimage import gaussian_filter

    img = np.clip(gaussian_filter(img, 1.5) * 3 - 250, 0, 255).astype(np.uint8)
    ref = RO.extract(img, 300, 3, 1.2)
    assert orb_gaps([(ref, ref)]) == (0.0, 0.0)
    kp, bits = orb_gaps([(RO.extract(img, 300, 3, 1.2, dtype=torch.bfloat16), ref)])
    assert kp > 0 and bits > 0


def _run(workload, monkeypatch, plant):
    cell = small_cell(workload)
    plant(monkeypatch)
    return R.run_cell(cell, 98765, 1.5, False, "cpu", time.perf_counter())


def _state_unchanged(monkeypatch):
    """Each tracking step hands back the state it was given: the pose and
    the frame of the step before."""
    from splslam_tpu_torch.slam import pipeline

    real = pipeline.vo_frame_step

    def step(imgs, mp, st, *a, **k):
        mp, _, stats = real(imgs, mp, st, *a, **k)
        stats = stats.clone()
        stats[pipeline.S_POSE] = st.Tcw.reshape(-1)
        return mp, st, stats

    monkeypatch.setattr(pipeline, "vo_frame_step", step)


def _descriptors_altered(monkeypatch):
    """Every fourth keypoint's first descriptor word inverted where the
    frame is built."""
    from splslam_tpu_torch.slam import pipeline

    real = pipeline.build_frame_stereo

    def build(*a, **k):
        fr = real(*a, **k)
        desc = fr.feat.desc.clone()
        desc[::4, 0] = ~desc[::4, 0]
        return fr._replace(feat=fr.feat._replace(desc=desc))

    monkeypatch.setattr(pipeline, "build_frame_stereo", build)


def _half_batch(monkeypatch):
    """A batch tracks its first half and answers the second half with the
    first half's rows."""
    from splslam_tpu_torch.slam import pipeline

    real = pipeline.vo_batch_step

    def step(imgs, *a, **k):
        half = len(imgs) // 2
        mp, st, stats = real(imgs[:half], *a, **k)
        return mp, st, torch.cat([stats, stats[: len(imgs) - half]])

    monkeypatch.setattr(pipeline, "vo_batch_step", step)


@pytest.mark.parametrize("workload,plant", [
    ("kitti_stereo.live_mapping", _state_unchanged),
    ("kitti_stereo.live_mapping", _descriptors_altered),
    ("kitti_stereo.batch32_tracking", _half_batch),
    ("kitti_stereo.batch32_tracking", _descriptors_altered),
], ids=["state_unchanged", "answer_altered", "half_batch", "batch_answer_altered"])
def test_fault_is_not_correct(workload, plant, monkeypatch):
    res = _run(workload, monkeypatch, plant)
    assert res["correct"] is False, res["compared"]
