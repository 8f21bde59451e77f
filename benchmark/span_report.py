"""Where a cell's time goes by the program's own spans.

    python3 benchmark/span_report.py --workload <name> --seed <n> --seconds <s>

One traced run of the cell as `run.py --trace 1` makes it (set-up, the
window, the traced calls), without the comparison, then one JSON line:
the cell's per-layer metrics; the traced window's device idle seconds by
the innermost program span open on the host meanwhile
(`harness/program_spans.py`); the untraced window calls' spans by name
(count, total and self ms a frame); and the recorder's own cost, the host
us of an empty span against an empty call. The benchmark's own runs do
not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import timeit  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def span_cost_us(n: int = 200_000) -> dict:
    """Host us of one empty span (the decorator's) and of an empty call."""
    from splslam_tpu_torch import trace

    def plain():
        pass

    spanned = trace.span("bench.empty")(plain)
    out = {}
    for name, fn in (("call", plain), ("span", spanned)):
        out[name] = min(timeit.repeat(fn, number=n, repeat=5)) / n * 1e6
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import run as R
    from harness import cell as C
    from harness import program_spans as P
    from splslam_tpu_torch import trace

    cell = C.load(args.workload)
    m = R.measure(cell, args.seed, args.seconds, True, args.device, T_START)
    metrics = {e["name"]: C.metric_reader(e["name"]).read(m) for e in cell.per_layer}
    idle = P.idle_by_leaf_us(m)
    calls = P.window_calls(m, traced=False) or []
    frames = sum(c.n_frames for c, _ in calls) or 1
    stages = {k: {"n_per_frame": v["n"] / frames, "ms_per_frame": v["total_ms"] / frames,
                  "self_ms_per_frame": v["self_ms"] / frames}
              for k, v in trace.summary([r for _, s in calls for r in s]).items()}
    t = m.window.trace
    row = {"workload": cell.name, "seed": args.seed, "card": R.card_line(),
           "window_s": m.window.seconds, "frames": m.window.frames,
           "untraced_frames": frames, "metrics": metrics,
           "traced_window_s": t.window_s if t else None,
           "busy_s": t.busy_s() if t else None,
           "idle_s_by_leaf_span": ({k: v / 1e6 for k, v in
                                    sorted(idle.items(), key=lambda kv: -kv[1])}
                                   if idle else None),
           "spans_per_frame": stages, "spans_opened": trace.RECORDER.opened,
           "ring_wrapped": trace.RECORDER.wrapped, "span_cost_us": span_cost_us()}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
