"""Shared set-up of the benchmark's own tests: the harness on sys.path, and
cells cut to a size the CPU runs in seconds."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import cell as C  # noqa: E402

# the repo's copies of the reference's published YAMLs
YAMLS = BENCH.parent / "splslam_tpu" / "examples" / "configs"


def published(path) -> dict:
    """A reference YAML's flat `key: value` lines, as published."""
    out = {}
    for line in path.read_text().splitlines():
        line = line.split("#")[0].strip()
        if line and not line.startswith("%"):
            key, value = (x.strip() for x in line.split(":", 1))
            out[key] = int(value) if value.lstrip("-").isdigit() else float(value)
    return out



def small_cell(workload: str, frames: int = 24):
    """`workload` at 320 pixels wide with its intrinsics scaled, 600 ORB
    features over 4 levels, short scenes and warm-ups."""
    c = C.load(workload)
    y = c.config["yaml"]
    s = 320.0 / y["Camera.width"]
    y.update({"Camera.width": 320, "Camera.height": int(round(y["Camera.height"] * s)),
              "ORBextractor.nFeatures": 600, "ORBextractor.nLevels": 4})
    for k in ("Camera.fx", "Camera.fy", "Camera.cx", "Camera.cy", "Camera.bf"):
        if k in y:
            y[k] *= s
    c.config["system"].update(max_points=8192, max_keyframes=64, local_window=1024)
    t = c.traffic
    t["scene"]["frames"] = frames
    if "batch" in t:
        t["batch"] = 4
        t["scene"]["frames"] = 13            # a replay of 24 frames, six batches
    t["warmup_frames"] = min(t.get("warmup_frames", 0), 3)
    t["warmup_batches"] = min(t.get("warmup_batches", 0), 1)
    t["sample_frames"] = 2
    t["trace_calls"] = min(t["trace_calls"], 3)
    return c


@pytest.fixture
def cuda_card():
    """Skips a test that needs a CUDA card where there is none; decided
    here, when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
