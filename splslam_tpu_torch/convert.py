"""Carry device state between the JAX package and the port.

The system has no weights: its "parameters" are its device state. These
functions turn the reference's `FrameData` / `MapState` / `StepState` /
`LocalWindow` / `LineWindow` / `LineFeatures` / `BAProblem` /
`PoseGraphEdges` / `TwoViewResult` / `Vocab` / `BowTable` — NamedTuples
whose leaves are numpy arrays, as `jax.device_get` returns them — into the port's tensors on a device, and
back. uint32 descriptors cross as an int32 view of the same bits; the
reference's `OrbFeatures.bits` cache is dropped on the way in.

Nothing here imports jax: the inputs are read by field name.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from splslam_tpu_torch.bow.vocabulary import BowTable, Vocab
from splslam_tpu_torch.ops.lines import LineFeatures
from splslam_tpu_torch.ops.orb import OrbFeatures
from splslam_tpu_torch.optim.ba import BAProblem, BAResult
from splslam_tpu_torch.optim.sim3 import PoseGraphEdges
from splslam_tpu_torch.slam.frame import FrameData
from splslam_tpu_torch.slam.map import KeyFrames, MapLines, MapPoints, MapState
from splslam_tpu_torch.slam.pipeline import StepState
from splslam_tpu_torch.slam.initializer import TwoViewResult
from splslam_tpu_torch.slam.tracking import LineWindow, LocalWindow

# Fields that hold uint32 descriptor words on the JAX side.
_U32_FIELDS = frozenset({"desc", "ldesc"})


def _tensor(x, device) -> torch.Tensor | None:
    """A fresh copy: the port updates its tables in place."""
    if x is None:
        return None
    a = np.array(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def _array(name: str, t: torch.Tensor | None) -> np.ndarray | None:
    if t is None:
        return None
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if name in _U32_FIELDS else a


def _from(cls, src, device):
    return cls(*[_tensor(getattr(src, f), device) for f in cls._fields])


def _tree_to(tup: NamedTuple):
    """Port NamedTuple -> the same NamedTuple with numpy leaves."""
    return type(tup)(*[
        _tree_to(v) if isinstance(v, tuple) else _array(f, v)
        for f, v in zip(tup._fields, tup)
    ])


def orb_features_from_numpy(f, device) -> OrbFeatures:
    return _from(OrbFeatures, f, device)


def line_features_from_numpy(f, device) -> LineFeatures:
    return _from(LineFeatures, f, device)


def line_features_to_numpy(f: LineFeatures) -> LineFeatures:
    return _tree_to(f)


def frame_from_numpy(f, device) -> FrameData:
    return FrameData(
        feat=orb_features_from_numpy(f.feat, device),
        u_right=_tensor(f.u_right, device),
        depth=_tensor(f.depth, device),
        lines=_from(LineFeatures, f.lines, device),
    )


def map_state_from_numpy(m, device) -> MapState:
    return MapState(
        pts=_from(MapPoints, m.pts, device),
        lns=_from(MapLines, m.lns, device),
        kfs=_from(KeyFrames, m.kfs, device),
        n_pts=_tensor(m.n_pts, device),
        n_lns=_tensor(m.n_lns, device),
        n_kfs=_tensor(m.n_kfs, device),
    )


def step_state_from_numpy(s, device) -> StepState:
    return StepState(
        frame=frame_from_numpy(s.frame, device),
        **{f: _tensor(getattr(s, f), device) for f in StepState._fields[1:]},
    )


def local_window_from_numpy(w, device) -> LocalWindow:
    return _from(LocalWindow, w, device)


def line_window_from_numpy(w, device) -> LineWindow:
    return _from(LineWindow, w, device)


def line_window_to_numpy(w: LineWindow) -> LineWindow:
    return _tree_to(w)


def two_view_result_from_numpy(r, device) -> TwoViewResult:
    return _from(TwoViewResult, r, device)


def two_view_result_to_numpy(r: TwoViewResult) -> TwoViewResult:
    return _tree_to(r)


def frame_to_numpy(f: FrameData) -> FrameData:
    return _tree_to(f)


def map_state_to_numpy(m: MapState) -> MapState:
    return _tree_to(m)


def step_state_to_numpy(s: StepState) -> StepState:
    return _tree_to(s)


def local_window_to_numpy(w: LocalWindow) -> LocalWindow:
    return _tree_to(w)


def ba_problem_from_numpy(p, device) -> BAProblem:
    return _from(BAProblem, p, device)


def ba_problem_to_numpy(p: BAProblem) -> BAProblem:
    return _tree_to(p)


def ba_result_to_numpy(r: BAResult) -> BAResult:
    return _tree_to(r)


def pose_graph_edges_from_numpy(e, device) -> PoseGraphEdges:
    return _from(PoseGraphEdges, e, device)


def pose_graph_edges_to_numpy(e: PoseGraphEdges) -> PoseGraphEdges:
    return _tree_to(e)


def vocab_from_numpy(v, device) -> Vocab:
    """The reference's `Vocab` (uint32 level tables) -> the port's."""
    return Vocab(tuple(_tensor(d, device) for d in v.level_desc),
                 _tensor(v.weights, device), int(v.k), int(v.depth))


def bow_table_from_numpy(t, device) -> BowTable:
    return _from(BowTable, t, device)


def bow_table_to_numpy(t: BowTable) -> BowTable:
    return _tree_to(t)
