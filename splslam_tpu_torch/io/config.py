"""Reference-compatible YAML settings loader (port of
splslam_tpu/io/config.py).

Reads the reference's config files (Examples/*/ *.yaml, written for
cv::FileStorage: a `%YAML:1.0` directive, flat dotted keys, optional
`!!opencv-matrix` nodes) into the port's `Settings`. The same keys are
consumed as by the JAX package (its io/config.py docstring lists them,
and the N/A line-detector knobs); LEFT.*/RIGHT.* stay in the raw dict for
the EuRoC stereo rectification. PyYAML is imported only when a file is
read, so importing the port does not need it.
"""

from __future__ import annotations

import re

import numpy as np


def _load_cv_yaml(path: str) -> dict:
    """Parse a cv::FileStorage YAML file into a plain dict."""
    import yaml

    with open(path) as f:
        text = f.read()
    # strip the %YAML directive and the opencv-matrix tags PyYAML rejects
    text = re.sub(r"^%YAML:.*$", "", text, flags=re.M)
    text = text.replace("!!opencv-matrix", "")
    data = yaml.safe_load(text) or {}
    out = {}
    for k, v in data.items():
        if isinstance(v, dict) and {"rows", "cols", "data"} <= set(v):
            out[k] = np.array(v["data"], np.float64).reshape(
                int(v["rows"]), int(v["cols"]))
        else:
            out[k] = v
    return out


def load_settings(path: str, **overrides):
    """Reference YAML -> Settings, with `overrides` (Settings fields)
    applied last. Returns (settings, raw_dict); keys Settings does not take
    stay in the raw dict for driver-specific use."""
    from splslam_tpu_torch.slam.system import Settings

    raw = _load_cv_yaml(path)
    g = raw.get

    def num(key, default):
        v = g(key)
        return default if v is None else float(v)

    width = int(num("Camera.width", overrides.pop("width", 640)))
    height = int(num("Camera.height", overrides.pop("height", 480)))
    dmf = num("DepthMapFactor", 1.0)
    st = Settings(
        fx=num("Camera.fx", 500.0),
        fy=num("Camera.fy", 500.0),
        cx=num("Camera.cx", width / 2),
        cy=num("Camera.cy", height / 2),
        k1=num("Camera.k1", 0.0),
        k2=num("Camera.k2", 0.0),
        p1=num("Camera.p1", 0.0),
        p2=num("Camera.p2", 0.0),
        k3=num("Camera.k3", 0.0),
        bf=num("Camera.bf", 0.0),
        fps=num("Camera.fps", 30.0),
        width=width,
        height=height,
        rgb=int(num("Camera.RGB", 1)),
        th_depth=num("ThDepth", 35.0),
        # reference: mDepthMapFactor = 1/DepthMapFactor (Tracking.cc:259)
        depth_map_factor=1.0 / dmf if abs(dmf) > 1e-5 else 1.0,
        n_features=int(num("ORBextractor.nFeatures", 1000)),
        scale_factor=num("ORBextractor.scaleFactor", 1.2),
        n_levels=int(num("ORBextractor.nLevels", 8)),
        ini_th_fast=num("ORBextractor.iniThFAST", 20.0),
        min_th_fast=num("ORBextractor.minThFAST", 7.0),
        using_line=bool(int(num("System.usingLine", 0))),
        line_features=int(num("Lineextractor.nFeatures", 128)),
        # System.usingLsdFeature: the LSD-analog "grow" backend (1) or the
        # FLD-analog "fld" one (0), reference src/Tracking.cc:143-157
        using_lsd=bool(int(num("System.usingLsdFeature", 1))),
        line_n_levels=int(num("Lineextractor.nLevels", 2)),
        line_min_length_ratio=num("Lineextractor.min_line_length_ratio", 0.0),
    )
    for k, v in overrides.items():
        setattr(st, k, v)
    return st, raw
