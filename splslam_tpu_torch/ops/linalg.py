"""Small batched decompositions that read nothing back to the host.

On a GPU, `torch.linalg.svd` and `torch.linalg.eigh` (every driver) copy
their convergence info to the host, which stalls the stream; the LU and
`*_ex` calls do not. The reference computes the minimal PnP and Sim3
solves with SVDs; these are the same quantities without them:

- `nullspace_vector`: the right singular vector of the smallest singular
  value of square matrices, by inverse iteration on A^T A through one LU
  of A (float64);
- `smallest_singular_vector`: the same vector for small matrices from a
  cyclic Jacobi eigen-decomposition of A^T A (float64), which converges
  also when the two smallest singular values lie close together (where
  inverse iteration converges slowly);
- `svd3`: a full SVD of 3x3 matrices, M = U diag(s) V^T, from a cyclic
  Jacobi eigen-decomposition of M^T M (float64): V from the
  eigenvectors, u_i = M v_i / s_i, the third column completed by a cross
  product with the sign that keeps M = U diag(s) V^T;
- `rotation_and_singular_values`: for 3x3 matrices, the rotation
  U diag(1, 1, det(U) det(V)) V^T (Horn's and Umeyama's solution; the
  orthogonal polar factor when det(M) > 0) and the singular values.
"""

from __future__ import annotations

import torch

def _jacobi_eig(S: torch.Tensor, sweeps: int = 6):
    """Symmetric [...,n,n] -> (eigenvalues [...,n] descending, eigenvectors
    as columns [...,n,n]), by `sweeps` cyclic Jacobi sweeps."""
    n = S.shape[-1]
    A = S
    V = torch.eye(n, dtype=S.dtype, device=S.device).expand(S.shape).clone()
    eye = torch.eye(n, dtype=S.dtype, device=S.device)
    pairs = [(p, q) for p in range(n) for q in range(p + 1, n)]
    for _ in range(sweeps):
        for p, q in pairs:
            apq = A[..., p, q]
            zero = apq == 0
            tau = ((A[..., q, q] - A[..., p, p])
                   / (2.0 * torch.where(zero, 1.0, apq)))
            t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(zero, 0.0, torch.where(tau == 0, 1.0, t))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            J = eye.expand(S.shape).clone()
            J[..., p, p] = c
            J[..., q, q] = c
            J[..., p, q] = s
            J[..., q, p] = -s
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    w, order = torch.sort(w, dim=-1, descending=True)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V


def _unit(x: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.where(n > 1e-30, x / torch.clamp(n, min=1e-300), fallback)


def svd3(M: torch.Tensor):
    """[...,3,3] -> (U, s descending, V), float64, with M = U diag(s) V^T
    and U, V orthogonal (rank 2 and lower included). Singular vectors of
    repeated singular values are one valid choice among many."""
    Md = M.double()
    w, V = _jacobi_eig(Md.transpose(-1, -2) @ Md)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    MV = Md @ V                                   # columns s_i u_i
    v1, v2 = V[..., :, 0], V[..., :, 1]
    u1 = _unit(MV[..., :, 0], v1)
    m2 = MV[..., :, 1]
    u2 = m2 - torch.sum(u1 * m2, -1, keepdim=True) * u1
    # a unit vector orthogonal to u1, for rank <= 1
    e = torch.eye(3, dtype=Md.dtype, device=M.device)
    axis = torch.where(torch.abs(u1[..., :1]) < 0.9, e[0], e[1])
    u2 = _unit(u2, _unit(torch.linalg.cross(u1, axis), v2))
    # u3 = +-u1 x u2: the sign of det(M) det(V) (either sign when s3 = 0)
    sgn = torch.where(torch.linalg.det(Md) * torch.linalg.det(V) < 0, -1.0, 1.0)
    U = torch.stack([u1, u2, sgn[..., None] * torch.linalg.cross(u1, u2)], dim=-1)
    return U, s, V


def rotation_and_singular_values(M: torch.Tensor):
    """[...,3,3] -> (R [...,3,3], s [...,3] descending) with M = U diag(s)
    V^T and R = U diag(1, 1, det(U) det(V)) V^T, the rotation closest to
    M (rank 2 included)."""
    U, s, V = svd3(M)
    D = torch.ones_like(s)
    D = torch.cat([D[..., :2], (torch.linalg.det(U) * torch.linalg.det(V))[..., None]],
                  dim=-1)
    R = (U * D[..., None, :]) @ V.transpose(-1, -2)
    return R.to(M.dtype), s.to(M.dtype)


def nullspace_vector(A: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """[...,n,n] -> [...,n] unit vectors: the right singular vector of the
    smallest singular value, up to sign. Inverse iteration x <- (A^T A)^-1 x
    through one LU of A, in float64, from a fixed start; a matrix whose
    LU breaks down (exactly singular) returns the start vector."""
    n = A.shape[-1]
    Ad = A.double()
    LU, piv, _ = torch.linalg.lu_factor_ex(Ad)
    x0 = torch.linspace(1.0, 2.0, n, dtype=Ad.dtype, device=A.device)
    x0 = (x0 / torch.linalg.vector_norm(x0)).expand(A.shape[:-1])[..., None]
    x = x0
    for _ in range(iters):
        y = torch.linalg.lu_solve(LU, piv, x, adjoint=True)     # A^T y = x
        x = torch.linalg.lu_solve(LU, piv, y)                   # A x = y
        x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-2, keepdim=True),
                            min=1e-300)
    ok = torch.all(torch.isfinite(x), dim=-2, keepdim=True)
    return torch.where(ok, x, x0)[..., 0].to(A.dtype)


def smallest_singular_vector(A: torch.Tensor, sweeps: int = 8) -> torch.Tensor:
    """[...,n,n] (n small) -> [...,n] unit vectors: the right singular
    vector of the smallest singular value, up to sign: the last
    eigenvector of A^T A, by `sweeps` cyclic Jacobi sweeps in float64."""
    Ad = A.double()
    _, V = _jacobi_eig(Ad.transpose(-1, -2) @ Ad, sweeps)
    return V[..., :, -1].to(A.dtype)
