"""Run one cell of the benchmark of splslam_tpu_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. Set-up (imports, CUDA, the kernels, the scene rendered from the
seed, the System, the warm-up the traffic needs) is timed as `setup_s`;
then the cell's closed loop runs for `--seconds`; then the program's
answers are compared with the references (`harness/compare.py` and the
checks under `checks/`). The last line of standard output is the result
as one JSON object: with `--trace 0` the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics and the breakdown of the traced window.
The numbers compared, each beside its limit, end both standard error and
the result.

Exits 2 without a result where there is no CUDA card or fewer than the
cell asks for, 3 where the process holds JAX or the JAX package, 4
where the map reached a capacity inside the window, 5 where
`BENCHMARK.json` names no such workload, and 6 where the map did not
initialize in warm-up (a monocular System without its two-view
initialization), so that an uninitialized System is never timed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "splslam_tpu")
NO_CARD, HOLDS_JAX, AT_CAPACITY, NO_WORKLOAD, NOT_INITIALIZED = 2, 3, 4, 5, 6


class RunError(RuntimeError):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def forbidden_modules(names) -> list[str]:
    """The top-level names (before the first dot, compared whole) among
    `names` that are JAX or the JAX package."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def setup(cell, seed: int, device, t_start: float):
    """Everything before the window, timed part by part: (loop, split)."""
    split, t = {}, t_start

    def mark(name):
        nonlocal t
        now = time.perf_counter()
        split[name] = now - t
        t = now

    import torch

    from harness import drive
    from splslam_tpu_torch.ops import orb_kernel, segsum
    mark("imports")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
        mark("cuda_init")
        orb_kernel.build()
        segsum.build()
        mark("kernel_load")
    scene = drive.build_scene(cell, seed)
    mark("render")
    loop = drive.Loop(cell, scene, device, seed)
    mark("system")
    loop.warm_up()
    mark("warm_up")
    if not loop.initialized:
        raise RunError(NOT_INITIALIZED, "the map did not initialize in warm-up "
                       f"(System state {loop.sys.state.name})")
    return loop, split


def measure(cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """Set-up, window and the program's answers on the host, with the
    System freed. Returns a namespace of what a result is made from."""
    import torch

    from harness import compare

    loop, split = setup(cell, seed, device, t_start)
    setup_s = time.perf_counter() - t_start
    t = cell.traffic
    w = loop.window(seconds, int(t["trace_calls"]) if trace else 0)
    cuda = loop.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(loop.device) if cuda else 0
    traced = [int(v.sum()) for v in loop.traced_valid]
    out = compare.collect(loop, w)
    scene = loop.scene
    loop.sys = loop.sample = loop.traced_valid = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return types.SimpleNamespace(
        cell=cell, seed=seed, window=w, out=out, scene=scene, split=split, setup_s=setup_s,
        memory_peak_bytes=int(peak), device=loop.device,
        keypoints_per_image=(sum(traced) / len(traced)) if traced else None)


def capacity_error(fill: dict) -> str | None:
    if fill["keyframes"] >= fill["max_keyframes"] - 1:
        return f"the map reached its keyframe capacity ({fill['keyframes']} of {fill['max_keyframes']})"
    if fill["points"] >= fill["max_points"]:
        return f"the map reached its point capacity ({fill['points']} of {fill['max_points']})"
    if fill["map_lines"] >= fill["max_map_lines"]:
        return f"the map reached its line capacity ({fill['map_lines']} of {fill['max_map_lines']})"
    return None


def result(m, trace: bool, correct: bool, table: dict) -> dict:
    """The result line of a run measured into `m`."""
    from harness import cell as C
    from harness import stats

    w = m.window
    metrics = {}
    if not trace:
        values = {"frames_per_s": stats.frames_per_s(w.frames, w.seconds),
                  "frame_ms_p95": stats.p95_ms([c.ms for c in w.calls]),
                  "setup_s": m.setup_s}
        for e in m.cell.end_to_end:
            if values.get(e["name"]) is not None:
                metrics[e["name"]] = {"value": values[e["name"]], "unit": e["unit"]}
    else:
        for e in m.cell.per_layer:
            v = C.metric_reader(e["name"]).read(m)
            if v is not None:
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
    device = {"platform": "gpu" if m.device.type == "cuda" else m.device.type,
              "kind": _device_kind(m.device), "count": m.cell.chips,
              "memory_peak_bytes": m.memory_peak_bytes}
    res = {"correct": correct, "attempted": m.out.attempted, "failed": m.out.failed,
           "metrics": metrics, "device": device}
    if trace and w.trace is not None:
        device["busy_s"] = w.trace.busy_s()
        device["window_s"] = w.trace.window_s
        res["breakdown"] = {"device_ops": w.trace.top_ops(10), "idle_gaps": w.trace.idle_gaps(10)}
    res["compared"] = table
    return res


def _device_kind(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of `cell` on `device`, judged; raises RunError where a run
    has no result."""
    from harness import compare

    m = measure(cell, seed, seconds, trace, device, t_start)
    w = m.window
    say(f"setup_s {m.setup_s:.3f}: " + ", ".join(f"{k} {v:.3f}" for k, v in m.split.items()))
    say(f"window {w.seconds:.3f} s: {len(w.calls)} calls, {w.frames} frames from frame "
        f"{w.first_frame()}; keyframes {w.n_kfs0} -> {m.out.fill['keyframes']}")
    say("map fill: " + json.dumps(m.out.fill))
    say("host over the window: " + ", ".join(f"{k} {v:.4f}" for k, v in w.host.items())
        + " (steal and idle: shares of the machine's CPU time; caller_cpu: the calling "
        "thread's CPU seconds over the window's)")
    if w.trace is not None:
        from harness import trace as T

        traced = [c for c in w.calls if c.traced]
        say(T.spans(w.trace) + f"; traced calls {len(traced)}, of them keyframe calls "
            f"{sum(c.kf_grew for c in traced)}")
    err = capacity_error(m.out.fill)
    if err:
        raise RunError(AT_CAPACITY, err + " inside the window: the cell no longer measures the "
                       "same work; resize it in a benchmark change")
    t0 = time.perf_counter()
    values = compare.numbers(cell, m.scene, m.out)
    correct, table = compare.judge(values, cell.limits)
    say(f"reference {time.perf_counter() - t0:.3f} s")
    res = result(m, trace, correct, table)
    held = forbidden_modules(sys.modules)
    if held:
        raise RunError(HOLDS_JAX, f"the process holds {', '.join(held)} after the window")
    for k, v in table.items():
        say(f"{k} {v['value']!r} limit {v['limit']!r}")
    return res


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    from harness import cell as C

    try:
        try:
            cell = C.load(args.workload)
        except KeyError as e:
            raise RunError(NO_WORKLOAD, str(e.args[0])) from None
        import torch

        if not torch.cuda.is_available():
            raise RunError(NO_CARD, "no CUDA device: torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell.chips:
            raise RunError(NO_CARD, f"{torch.cuda.device_count()} CUDA devices, the cell "
                                    f"asks for {cell.chips}")
        say(f"card: {card_line()}")
        res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    except RunError as e:
        say(f"error: {e}")
        return e.code
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
