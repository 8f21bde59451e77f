"""The PyTorch/CUDA port's bench: the four JAX benches (bench.py,
bench_mapping.py, bench_mono.py, bench_components.py) on one GPU.

    python3 bench_torch.py [--bench stereo|mapping|mono|components|all]
                           [--repeats R] [--seed S] [--device cuda|cpu] [--small]

Prints one JSON line a metric on stdout, in bench.py's shape (`metric`,
`value`, `unit`, `vs_baseline` against BASELINE.md's C++ CPU rows) with
the device, the checks and `ok`, the median, p90, sample count, tail
percentile and spread over R repeats of fresh Systems, the set-up times
and a traced window (see `splslam_tpu_torch/bench/common.py`); progress
goes to stderr. The device is the card unless `--device cpu` is given;
without a card the command fails, it never falls back to the CPU.
`--small` is the CPU test size (320x240, 600 features, 4 levels, short
sequences). Scene seeds are the JAX benches' plus S. Exits 0 when every
row is ok, 1 when a check failed or a bench raised (after printing every
row), 2 without the device asked for.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

BENCHES = ("stereo", "mapping", "mono", "components")


def _rows_of(name: str, b, small: bool) -> list[dict]:
    from splslam_tpu_torch.bench import components, mapping, mono, stereo

    mod = {"stereo": stereo, "mapping": mapping, "mono": mono,
           "components": components}[name]
    return mod.run(b, mod.SMALL if small else mod.FULL)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bench", choices=BENCHES + ("all",), default="all")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    if args.repeats < 1:
        ap.error("--repeats must be >= 1")

    import torch

    from splslam_tpu_torch.bench.common import (Bench, NoCardError, device_info, failed_row,
                                                launches, resolve_device)

    try:
        dev = resolve_device(args.device)
    except NoCardError as e:
        print(f"bench_torch: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = device_info(dev)
    print(f"bench_torch: device {json.dumps(info)}, repeats {args.repeats}, seed "
          f"{args.seed}, {'small' if args.small else 'full'} size", file=sys.stderr)
    ok = True
    for name in (BENCHES if args.bench == "all" else (args.bench,)):
        t0, n0 = time.perf_counter(), launches()
        b = Bench(name, dev, seed=args.seed, repeats=args.repeats, info=info)
        try:
            rows = _rows_of(name, b, args.small)
        except Exception as e:     # one bench's failure must not hide the others' rows
            rows = [failed_row(name, info, e)]
        wall = time.perf_counter() - t0
        for row in rows:
            row["bench_wall_s"] = wall
            ok &= bool(row["ok"])
            print(json.dumps(row), flush=True)
        print(f"bench_torch: {name} {wall:.1f} s, {sum(r['ok'] for r in rows)}/{len(rows)} "
              f"rows ok, {launches() - n0} ORB kernel launches", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
