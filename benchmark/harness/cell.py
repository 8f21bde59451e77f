"""A benchmark cell, found by its name: its entry in `BENCHMARK.json`, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), the limits of its comparison
(`limits/<workload>.json`), the checks its traffic names
(`checks/<check>.py`) and its per-layer metrics (`metrics/<metric>.py`).
Adding a cell, a configuration, a mix, a check or a metric adds files and
entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]      # the benchmark's folder
ROOT = HERE.parent                              # the checkout

# The reference's YAML keys and the port's `Settings` fields they set.
YAML_SETTINGS = {
    "Camera.fx": "fx", "Camera.fy": "fy", "Camera.cx": "cx", "Camera.cy": "cy",
    "Camera.k1": "k1", "Camera.k2": "k2", "Camera.p1": "p1", "Camera.p2": "p2",
    "Camera.k3": "k3", "Camera.bf": "bf", "Camera.fps": "fps",
    "Camera.width": "width", "Camera.height": "height", "ThDepth": "th_depth",
    "ORBextractor.nFeatures": "n_features", "ORBextractor.scaleFactor": "scale_factor",
    "ORBextractor.nLevels": "n_levels", "ORBextractor.iniThFAST": "ini_th_fast",
    "ORBextractor.minThFAST": "min_th_fast", "System.usingLine": "using_line",
    "System.usingLsdFeature": "using_lsd", "Lineextractor.nFeatures": "line_features",
    "Lineextractor.nLevels": "line_n_levels",
    "Lineextractor.min_line_length_ratio": "line_min_length_ratio",
    "Camera.RGB": "rgb", "DepthMapFactor": "depth_map_factor",
}
BOOL_FIELDS = {"using_line", "using_lsd"}
INT_FIELDS = {"width", "height", "rgb", "n_features", "n_levels", "line_features",
              "line_n_levels"}
# Published keys of the line detector that the port's `Settings` has no
# field for: a configuration carries them as published, and they set nothing.
UNREAD = frozenset("Lineextractor." + k for k in (
    "refine", "scale", "sigma_scale", "quant", "ang_th", "log_eps", "density_th", "n_bins",
    "threshold_length", "threshold_dist", "canny_th1", "canny_th2", "canny_aperture_size",
    "do_merge"))


def _setting(field: str, value):
    if field in BOOL_FIELDS:
        return bool(value)
    if field in INT_FIELDS:
        return int(value)
    if field == "depth_map_factor":
        # depth units -> metres: the reference's mDepthMapFactor = 1 / DepthMapFactor
        # (Tracking.cc:259), as splslam_tpu_torch/io/config.py reads it
        return 1.0 / value if abs(value) > 1e-5 else 1.0
    return float(value)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def sensor(self) -> str:
        return self.config["sensor"]

    @property
    def yaml(self) -> dict:
        return self.config["yaml"]

    @property
    def unread(self) -> list[str]:
        """The configuration's published keys that the port does not read."""
        return [k for k in self.yaml if k in UNREAD]

    def settings_fields(self) -> dict:
        """Keyword arguments of the port's `Settings`: the configuration's
        published keys (but the unread ones), its system switches and
        capacities, then the traffic mix's run switches. A key neither
        read nor unread raises."""
        out = {}
        for key, value in self.yaml.items():
            if key not in UNREAD:
                field = YAML_SETTINGS[key]
                out[field] = _setting(field, value)
        out.update(self.config.get("system", {}))
        out.update(self.traffic.get("settings", {}))
        return out


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _read(ROOT / "BENCHMARK.json")


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load(workload: str, bench: dict | None = None) -> Cell:
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    limits_path = HERE / "limits" / f"{workload}.json"
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=_read(HERE / "configs" / f"{w['config']}.json"),
        traffic=_read(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_read(limits_path) if limits_path.exists() else {},
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def _module(folder: str, name: str):
    """`<folder>/<name>.py`, loaded by path (a name may hold dots)."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} file for {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """`metrics/<name>.py`: `read(ctx)`, a per-layer metric's value or None."""
    return _module("metrics", name)


def check(name: str):
    """`checks/<name>.py`: `read(cell, scene, out, control)`, the numbers a
    check compares, the program's or its control's in the program's place."""
    return _module("checks", name)
