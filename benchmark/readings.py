"""The readings the limits of a cell's comparison are set from.

    python3 benchmark/readings.py --workload <name> --seeds 11,12,13 --seconds 20

For each seed, in one process: the cell's set-up and a window at its own
load, then the numbers the cell compares, for the program and for the
control put in its place (`checks/<name>.py` names both). One JSON line
a seed on standard output. The benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import run as R
    from harness import cell as C
    from harness import compare, stats

    cell = C.load(args.workload)
    t_start = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        m = R.measure(cell, seed, args.seconds, False, args.device, t_start)
        w = m.window
        row = {"workload": cell.name, "seed": seed, "setup_s": m.setup_s, "split": m.split,
               "window_s": w.seconds, "calls": len(w.calls), "frames": w.frames,
               "frames_per_s": stats.frames_per_s(w.frames, w.seconds),
               "frame_ms_p95": stats.p95_ms([c.ms for c in w.calls]),
               "call_ms_median": stats.median_ms([c.ms for c in w.calls]),
               "failed": m.out.failed, "fill": m.out.fill,
               "memory_peak_bytes": m.memory_peak_bytes,
               "program": compare.numbers(cell, m.scene, m.out),
               "control": compare.numbers(cell, m.scene, m.out, control=True)}
        print(json.dumps(row), flush=True)
        t_start = time.perf_counter()
    held = R.forbidden_modules(sys.modules)
    if held:
        print(f"error: the process holds {', '.join(held)}", file=sys.stderr)
        return R.HOLDS_JAX
    return 0


if __name__ == "__main__":
    sys.exit(main())
