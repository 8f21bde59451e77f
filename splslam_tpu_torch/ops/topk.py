"""Top-k selection with the reference's tie order (port of
splslam_tpu/ops/topk.py): `lax.top_k` breaks ties toward the lower index,
and `torch.topk` promises no order on CUDA, so the port selects by a
stable sort (`stable_top`) or by repeated first-index argmax
(`grid_topk`'s per-cell top-k)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def stable_top(values: torch.Tensor, k: int, largest: bool = True):
    """top-k of a 1-d tensor with ties to the lower index (lax.top_k's
    order): a stable sort, then a slice. Returns (values, indices)."""
    order = torch.sort(values, descending=largest, stable=True).indices[:k]
    return values[order], order


def argmax_topk(rows: torch.Tensor, k: int):
    """Per-row top-k of a [R, C] tensor whose entries are >= 0, by k rounds
    of first-index argmax (lax.top_k's tie order). Returns (values [R,k],
    column indices [R,k])."""
    work = rows.clone()
    r = torch.arange(rows.shape[0], device=rows.device)
    vs, ids = [], []
    for _ in range(k):
        i = torch.argmax(work, dim=1)
        vs.append(work[r, i])
        ids.append(i)
        work.scatter_(1, i[:, None], -1.0)   # no host sync, unlike work[r, i] = -1.0
    return torch.stack(vs, dim=1), torch.stack(ids, dim=1)


def grid_topk(
    score: torch.Tensor,
    k_total: int,
    cell: int = 16,
    cell_k: int = 4,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Select up to k_total corners from a sparse (H,W) score map.

    Returns (xy (k_total,2) f32 [x,y], response (k_total,), valid (k_total,)).
    Invalid slots have response 0.
    """
    H, W = score.shape
    Hp = -(-H // cell) * cell
    Wp = -(-W // cell) * cell
    padded = F.pad(score, (0, Wp - W, 0, Hp - H))
    ncy, ncx = Hp // cell, Wp // cell
    cells = padded.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3)
    vals, idx = argmax_topk(cells.reshape(ncy * ncx, cell * cell), cell_k)
    rows = torch.arange(ncy * ncx, device=score.device)
    cy = rows // ncx
    cx = rows % ncx
    py = cy[:, None] * cell + idx // cell
    px = cx[:, None] * cell + idx % cell

    flat_vals = vals.reshape(-1)
    order = torch.sort(-flat_vals, stable=True).indices[:k_total]
    top_vals = flat_vals[order]
    xy = torch.stack(
        [px.reshape(-1)[order].float(), py.reshape(-1)[order].float()], dim=-1
    )
    return xy, top_vals, top_vals > 0.0
