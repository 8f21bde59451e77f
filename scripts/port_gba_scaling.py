"""Scaling of the PyTorch port's edge-sharded global BA
(`parallel/gba_sharded.py`) across world sizes: edges/s at each world of
ranks started by `parallel.mesh.launch`.

    python3 scripts/port_gba_scaling.py [world ...] [--device cpu]

Worlds default to 1, 2 and 4. On the card (the default) each world runs
over NCCL, one card a rank, where there are that many cards; a world
with more ranks than cards does not run and its line says so. With
`--device cpu` the ranks are gloo processes with one torch thread each.
The problem is `graft_entry.make_gba_problem()` (the reference's size:
64 keyframes, 16,384 points, 1,024 lines, 139,264 edges) with the
schedule of the JAX package's scripts/bench_gba_scaling.py: 2 rounds of
2 GN steps of 8 CG iterations. Prints one JSON line per world in that
script's shape (metric, n_devices, edges, value in edges/s, solve_s),
with the median of 3 solves after a first one, the backend and the
device's name.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
KW = dict(rounds=2, gn_iters=2, cg_iters=8)


def measure(worlds, device="cuda", reps: int = 3, problem_kw=None,
            timeout_s: float = 900.0) -> list[dict]:
    """One row a world size: the median solve time of `reps` solves after
    a first one (which sets up), and edges/s = edges x rounds x GN steps
    over it. Worlds that need more cards than there are come back with
    `value` None and the reason."""
    import torch

    from splslam_tpu_torch.convert import ba_problem_to_numpy
    from splslam_tpu_torch.graft_entry import make_gba_problem
    from splslam_tpu_torch.parallel.gba_sharded import solve_on_rank
    from splslam_tpu_torch.parallel.mesh import launch

    on_card = torch.device(device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("port_gba_scaling: no CUDA device (pass --device cpu)")
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    cam, prob = make_gba_problem(**(problem_kw or {}), device="cpu")
    pn = ba_problem_to_numpy(prob)
    E = int(pn.e_cam.shape[0])
    work = E * KW["rounds"] * KW["gn_iters"]
    rows = []
    for n in worlds:
        row = {"metric": "gba_sharded_edge_linearizations_per_s", "n_devices": n,
               "edges": E, "value": None, "unit": "edges/s", "solve_s": None,
               "backend": "nccl" if on_card else "gloo", "device": name}
        if on_card and n > torch.cuda.device_count():
            row["skipped"] = f"{n} ranks need {n} cards; {torch.cuda.device_count()} here"
        else:
            outs = launch(solve_on_rank, n, device, timeout_s=timeout_s,
                          args=(cam, pn, KW, reps + 1))
            ms = float(np.median(outs[0]["ms"][1:]))
            row.update(value=round(work / ms * 1e3), solve_s=ms / 1e3,
                       first_s=outs[0]["ms"][0] / 1e3,
                       n_guarded=outs[0]["n_guarded"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("worlds", type=int, nargs="*", default=[1, 2, 4])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    try:
        measure(args.worlds, args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None


if __name__ == "__main__":
    main()
