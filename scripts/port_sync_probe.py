"""Which PyTorch linear-algebra calls read a value back to the host on a
GPU, as `torch.cuda.set_sync_debug_mode("error")` reports it.

    python3 scripts/port_sync_probe.py

Runs each call once to warm it up, then once more in the "error" mode,
and prints one line a call: "no sync", or "SYNC" when the mode raised
(the mode is a prototype and may miss some synchronizations). The
shapes are relocalization's: 192 hypotheses of 12x12 (PnP DLT) and of
3x3 (polar factor, Horn).
"""

from __future__ import annotations


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
