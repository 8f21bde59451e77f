"""Spatially spread corner selection (port of splslam_tpu/ops/topk.py):
per-cell top-k by repeated first-index argmax, then a stable global sort
by response, so ties go to the lowest index as in the reference."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
    work = cells.reshape(ncy * ncx, cell * cell).clone()

    rows = torch.arange(work.shape[0], device=score.device)
    vs, ids = [], []
    for _ in range(cell_k):
        i = torch.argmax(work, dim=1)                   # first max per cell
        vs.append(work[rows, i])
        ids.append(i)
        work[rows, i] = -1.0
    vals = torch.stack(vs, dim=1)                       # [ncells, cell_k]
    idx = torch.stack(ids, dim=1)
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
