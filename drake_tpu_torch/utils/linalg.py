"""Batched small dense linear algebra with the reference's failure values.

JAX's Cholesky answers a matrix that is not positive definite with NaN, and
its solves carry the NaN on; the reference's guards test for it.  PyTorch's
``torch.linalg.cholesky`` and ``torch.linalg.solve`` raise instead, and on the
card they wait for the device to tell them.  These helpers use the ``_ex``
forms, which neither raise nor wait, and turn a failure into NaN.
"""

from __future__ import annotations

import torch


def cholesky_or_nan(M):
    """Lower Cholesky factor of M (..., n, n), NaN where M is not positive
    definite."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def cho_solve(L, b):
    """Solve (L L^T) x = b for vectors b (..., n)."""
    return torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)


def solve(A, b):
    """Solve A x = b for vectors b (..., n) by LU; NaN where A is singular.

    A and b are expanded to their common batch shape first: the backward of
    a solve whose A broadcasts over b's batch fails under ``torch.func.vmap``."""
    batch = torch.broadcast_shapes(A.shape[:-2], b.shape[:-1])
    A = A.expand(batch + A.shape[-2:])
    b = b.expand(batch + b.shape[-1:])
    x, info = torch.linalg.solve_ex(A, b.unsqueeze(-1))
    return torch.where((info == 0)[..., None], x.squeeze(-1), torch.nan)


def solve_matrix(A, B):
    """Solve A X = B for matrices B (..., n, k) by LU; NaN where A is singular."""
    X, info = torch.linalg.solve_ex(A, B)
    return torch.where((info == 0)[..., None, None], X, torch.nan)


def solve_spd_2x2(m11, m12, m22, r0, r1):
    """Solve [[m11, m12], [m12, m22]] x = [r0, r1] lane by lane, the matrix
    symmetric positive definite (a 2-dof mass matrix), by elimination on
    m11: the LU factorization without a pivot, which such a matrix never
    needs.  Elementwise ops only, so that a closed-loop step stays a handful
    of small kernels that a CUDA graph can replay.  Returns (x0, x1)."""
    l = m12 / m11
    x1 = (r1 - l * r0) / (m22 - l * m12)
    return (r0 - m12 * x1) / m11, x1
