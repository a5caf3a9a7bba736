"""Algebraic Riccati and Lyapunov solvers by fixed-count iterations.

The PyTorch counterpart of ``drake_tpu/math/riccati.py``.  Drake solves
these with Schur decompositions (math/continuous_algebraic_riccati_equation.h,
discrete_algebraic_riccati_equation.h); the reference, and so the port,
iterate instead, on a batch of problems in the leading dimensions:

  - CARE and the continuous Lyapunov equation: the matrix sign function of
    the Hamiltonian by Newton's iteration with determinant scaling, a fixed
    40 iterations (the reference's ``fori_loop``: here a Python loop);
  - DARE: the structure-preserving doubling algorithm, 30 iterations, and
    the discrete Lyapunov equation by doubling.

Each sign iteration takes one LU of Z for both its inverse and its log
determinant.  The stable subspace of sign(H) gives X by least squares on a
(2n, n) system of full rank: the port asks ``lstsq`` for ``gels`` (QR),
the only method torch has on the card, on every device (the reference
takes an SVD; on a matrix of full rank the two agree within rounding).
"""

from __future__ import annotations

import torch

from drake_tpu_torch.utils.linalg import solve_matrix


def symmetrize(X):
    """(X + X') / 2."""
    return 0.5 * (X + X.mT)


def _eye_like(A):
    n = A.shape[-1]
    return torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)


def _sign(Z, iters: int):
    """The matrix sign of Z (..., 2n, 2n) by `iters` scaled Newton steps,
    Z <- (c Z + Z^-1 / c) / 2 with c = |det Z|^(-1/2n)."""
    n2 = Z.shape[-1]
    eye = _eye_like(Z)
    for _ in range(iters):
        LU, piv, _ = torch.linalg.lu_factor_ex(Z)
        Zinv = torch.linalg.lu_solve(LU, piv, eye)
        logdet = torch.log(torch.abs(torch.diagonal(LU, dim1=-2, dim2=-1))).sum(-1)
        c = torch.exp(-logdet / n2)[..., None, None]
        Z = 0.5 * (c * Z + Zinv / c)
    return Z


def _block(A11, A12, A21, A22):
    return torch.cat([torch.cat([A11, A12], dim=-1), torch.cat([A21, A22], dim=-1)], dim=-2)


def solve_care(A, B, Q, R, iters: int = 40):
    """The stabilizing X of A'X + XA - XB R^-1 B'X + Q = 0 (Drake's
    ContinuousAlgebraicRiccatiEquation), for A (..., n, n), B (..., n, m),
    Q (..., n, n) and R (..., m, m)."""
    n = A.shape[-1]
    lead = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2], Q.shape[:-2], R.shape[:-2])
    A, B, Q = A.expand(lead + A.shape[-2:]), B.expand(lead + B.shape[-2:]), Q.expand(lead + (n, n))
    G = B @ solve_matrix(R.expand(lead + R.shape[-2:]), B.mT)
    Z = _sign(_block(A, -G, -Q, -A.mT), iters)
    # The stable invariant subspace: (Z + I) [I; X] = 0.
    eye = _eye_like(A)
    M = torch.cat([Z[..., :n, n:], Z[..., n:, n:] + eye], dim=-2)
    rhs = -torch.cat([Z[..., :n, :n] + eye, Z[..., n:, :n]], dim=-2)
    return symmetrize(torch.linalg.lstsq(M, rhs, driver="gels").solution)


def solve_dare(A, B, Q, R, iters: int = 30):
    """The stabilizing X of X = A'XA - A'XB (R + B'XB)^-1 B'XA + Q (Drake's
    DiscreteAlgebraicRiccatiEquation), by the doubling algorithm."""
    lead = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2], Q.shape[:-2], R.shape[:-2])
    A = A.expand(lead + A.shape[-2:])
    B = B.expand(lead + B.shape[-2:])
    eye = _eye_like(A)
    Ak = A
    Gk = B @ solve_matrix(R.expand(lead + R.shape[-2:]), B.mT)
    Hk = Q.expand(A.shape)
    for _ in range(iters):
        W = eye + Gk @ Hk
        W_inv_A = solve_matrix(W, Ak)
        W_inv_G = solve_matrix(W, Gk)
        Ak, Gk, Hk = Ak @ W_inv_A, Gk + Ak @ W_inv_G @ Ak.mT, Hk + W_inv_A.mT @ Hk @ Ak
    return symmetrize(Hk)


def solve_lyapunov_continuous(A, Q, iters: int = 40):
    """X of A X + X A' + Q = 0 for Hurwitz A (Drake's
    RealContinuousLyapunovEquation): sign([[A, Q], [0, -A']]) =
    [[-I, 2X], [0, I]]."""
    n = A.shape[-1]
    lead = torch.broadcast_shapes(A.shape[:-2], Q.shape[:-2])
    A, Q = A.expand(lead + (n, n)), Q.expand(lead + (n, n))
    Z = _sign(_block(A, Q, torch.zeros_like(A), -A.mT), iters)
    return symmetrize(0.5 * Z[..., :n, n:])


def solve_lyapunov_discrete(A, Q, iters: int = 30):
    """X of A X A' - X + Q = 0 for Schur-stable A (Drake's
    RealDiscreteLyapunovEquation), by doubling: X = sum_k A^k Q A'^k."""
    lead = torch.broadcast_shapes(A.shape[:-2], Q.shape[:-2])
    Ak, X = A.expand(lead + A.shape[-2:]), Q.expand(lead + Q.shape[-2:])
    for _ in range(iters):
        Ak, X = Ak @ Ak, X + Ak @ X @ Ak.mT
    return symmetrize(X)
