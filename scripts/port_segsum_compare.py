"""The `segment_sum` kernel of two checkouts on the same tables, on the card.

    python3 scripts/port_segsum_compare.py record FILE
    python3 scripts/port_segsum_compare.py time FILE [--root DIR]

`record` runs this checkout's port over chip_smoke.py's sizes and saves
(torch.save, to FILE) every table its solvers sum: one local BA on the
final keyframe of phase 5's map (40 KITTI-size frames with mapping, a
keyframe every 4 frames), one `run_global_ba(rounds=1)` over that map
(phase 8), and `_correct` on phase 7's circuit map with phase 8's
injected drift (its `pose_graph_sim3` and the global BA it runs). A
table is its rows' cells, its cell count and its rows, once per (solve,
cells, width).

`time` imports `splslam_tpu_torch` from DIR (default: the checkout that
holds this script), so that a parent and a change can be run in turns
on one card, and for every `tests/test_torch_gpu.py::SEGSUM_SHAPES`
shape (made from its seed) and every table in FILE prints, and appends
as a JSON line to chiprun_out/segsum_compare.jsonl, chip_smoke.py's
`segsum_numbers` (the kernel equal to its plain version, the launches a
sum, the kernel's device ms in a CUDA graph, the host's enqueue
microseconds a call over 200 calls, the plain version's and
`index_add_`'s ms, and the bound) beside the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _module(name: str, path: Path):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


def chip_smoke():
    """This checkout's chip_smoke.py (DIR may hold another), as a module."""
    return _module("chip_smoke", HERE / "chip_smoke.py")


def record(path: str) -> None:
    import dataclasses

    import torch

    from splslam_tpu_torch.io.synthetic import make_stereo_sequence
    from splslam_tpu_torch.slam import mapping_ops as MO
    from splslam_tpu_torch.slam import system as TS
    from splslam_tpu_torch.slam.map import KeyFrames

    CS = chip_smoke()
    card = CS.card_line()
    K, bf, leg, _ = make_stereo_sequence(
        n_frames=CS.BATCH_FRAMES, width=CS.KITTI_W, height=CS.KITTI_H, fx=718.0,
        baseline=0.54, motion="forward", seed=3)
    st = dataclasses.replace(CS.kitti_settings(TS.Settings, K, bf),
                             enable_local_mapping=True, force_kf_every=4)
    sysm = TS.System(st, TS.Sensor.STEREO, "cuda")
    for i, (l, r) in enumerate(leg[:CS.N_FRAMES]):
        sysm.track_stereo(l, r, i * 0.1)
    sysm.get_tracking_state()
    tables: dict = {}
    kf = sysm.n_kfs - 1
    kb = max(32, 1 << (sysm.n_kfs - 1).bit_length())
    m = sysm.map.to("cuda")
    m = m._replace(kfs=KeyFrames(*[x[:kb] for x in m.kfs]))
    m, _ = MO.map_upkeep(m, kf, sysm.cam, sysm.scales, st.scale_factor, st.n_levels)
    with CS.seg_recording(tables, "local BA (phase 5)"):
        MO.local_ba(m, kf, sysm.cam, st.scale_factor, st.n_levels)
    with CS.seg_recording(tables, "global BA (phase 8)"):
        sysm.loop_closer.run_global_ba(rounds=1)
    _, base, scene = CS.loop_phase(card)
    S12 = CS.inject_drift(base, scene[0], "cuda")
    kf, cand = base.loop_closer.verified_loops[0]
    with CS.seg_recording(tables, "_correct (phase 8)"):
        base.loop_closer._correct(kf, cand, S12)
    torch.save({key: (seg.cell.cpu(), rows.cpu()) for key, (seg, rows) in tables.items()},
               path)
    for (solve, n, w), (seg, rows) in tables.items():
        print(f"recorded {solve}: {rows.shape[0]} rows into {n} cells x {w}")


def time_tables(path: str, root: str) -> None:
    import torch

    from splslam_tpu_torch.ops import segsum as SS

    CS = chip_smoke()
    card = CS.card_line()
    SS.build()
    gpu = _module("test_torch_gpu", HERE / "tests" / "test_torch_gpu.py")
    dev = torch.device("cuda")
    tables = [((f"SEGSUM_SHAPES {name}", gpu.SEGSUM_SHAPES[name][1]),
               gpu.segsum_table(name, dev)) for name in gpu.SEGSUM_SHAPES]
    tables += [((solve, n), (cell.to(dev), rows.to(dev)))
               for (solve, n, _), (cell, rows) in torch.load(path).items()]
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    for (name, n), (cell, rows) in tables:
        line = dict(root=root, table=name,
                    **CS.segsum_numbers(SS.Segments(cell, n), rows, calls=200),
                    card=card)
        line["share"] = line["bound_ms"] / line["ms"]
        print(json.dumps(line), flush=True)
        with open(out / "segsum_compare.jsonl", "a") as f:
            f.write(json.dumps(line) + "\n")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["record", "time"])
    ap.add_argument("file")
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("port_segsum_compare: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.mode == "record":
        record(args.file)
    else:
        time_tables(args.file, args.root)


if __name__ == "__main__":
    main()
