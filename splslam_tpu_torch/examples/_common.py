"""Shared driver plumbing."""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def driver_args(prog: str, default_out: str, argv=None) -> argparse.Namespace:
    """The reference drivers' command line (`<settings.yaml> <sequence_dir>
    [out.txt]`) and the port's `--device`."""
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("settings", help="reference settings YAML")
    p.add_argument("sequence", help="sequence directory")
    p.add_argument("out", nargs="?", default=default_out, help="trajectory file")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def run_sequence(sysm, feed, n_total: int):
    """Drive the system over `feed` (an iterable of callables each running
    one Track* step) and print the reference drivers' closing stats."""
    times = []
    for i, step in enumerate(feed):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
        if i % 50 == 0:
            print(f"frame {i}/{n_total}  state={sysm.state.name}", file=sys.stderr)
    sysm.shutdown()
    tt = np.array(sorted(times))
    print("-------", file=sys.stderr)
    print(f"median tracking time: {np.median(tt)*1e3:.2f} ms", file=sys.stderr)
    print(f"mean tracking time:   {tt.mean()*1e3:.2f} ms", file=sys.stderr)
    print(sysm.timers.pretty(), file=sys.stderr)
    # solver-guard health: mapping_state_revert and loop_guarded are 0 on a
    # healthy run
    print(f"health: {sysm.health()}", file=sys.stderr)
