"""Which PyTorch linear-algebra calls read a value back to the host on a
GPU, as `torch.cuda.set_sync_debug_mode("error")` reports it.

    python3 scripts/port_sync_probe.py

Runs each call once to warm it up, then once more in the "error" mode,
and prints one line a call: "no sync", or "SYNC" when the mode raised
(the mode is a prototype and may miss some synchronizations). The
shapes are relocalization's: 192 hypotheses of 12x12 (PnP DLT) and of
3x3 (polar factor, Horn).

`sync_sites(fn)` lists the port's source lines that make a call wait
for the card (scripts/port_mono_profile.py uses it for a tracked frame).
"""

from __future__ import annotations

import os
import traceback
import warnings


def sync_sites(fn) -> dict[str, int]:
    """Run `fn()` once under `torch.cuda.set_sync_debug_mode("warn")` and
    count its host syncs by where they come from: the innermost three
    `splslam_tpu_torch` frames on the Python stack of each warning
    ("file:line <- caller <- caller"), or the warning's own line when
    the port is not on the stack."""
    import torch

    found: dict[str, int] = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if "splslam_tpu_torch" in f.filename]
        key = " <- ".join(f"{os.path.relpath(f.filename)}:{f.lineno}"
                          for f in reversed(frames[-3:])) or f"{filename}:{lineno}"
        found[key] = found.get(key, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return found


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("port_sync_probe: no CUDA device")
    A = torch.randn(192, 12, 12, device="cuda")
    S = A @ A.transpose(-1, -2)
    B = torch.randn(192, 3, 3, device="cuda")
    ops = {
        "linalg.svd": lambda: torch.linalg.svd(A),
        "linalg.svd gesvd": lambda: torch.linalg.svd(A, driver="gesvd"),
        "linalg.svd gesvdj": lambda: torch.linalg.svd(A, driver="gesvdj"),
        "linalg.svd gesvda": lambda: torch.linalg.svd(A, driver="gesvda"),
        "linalg.svd 3x3": lambda: torch.linalg.svd(B),
        "linalg.svdvals": lambda: torch.linalg.svdvals(A),
        "linalg.eigh": lambda: torch.linalg.eigh(S),
        "linalg.det 3x3": lambda: torch.linalg.det(B),
        "linalg.solve_ex": lambda: torch.linalg.solve_ex(S, A[..., :1]),
        "linalg.lu_factor_ex + lu_solve": lambda: torch.linalg.lu_solve(
            *torch.linalg.lu_factor_ex(S)[:2], A[..., :1]),
        "linalg.cholesky_ex": lambda: torch.linalg.cholesky_ex(S),
        "linalg.inv_ex": lambda: torch.linalg.inv_ex(S),
        "linalg.qr": lambda: torch.linalg.qr(A),
        "index with a 0-dim tensor": lambda: A[torch.argmax(A[:, 0, 0])],
        "index with a 1-d tensor": lambda: A[torch.argmax(A[:, 0, 0])[None]],
        "write a Python float": lambda: B.__setitem__((0, 0, 0), 1.0),
    }
    for name, fn in ops.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            res = "no sync"
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            res = "SYNC"
        finally:
            torch.cuda.set_sync_debug_mode(0)
        print(f"{name}: {res}", flush=True)


if __name__ == "__main__":
    main()
