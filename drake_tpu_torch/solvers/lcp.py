"""Linear complementarity solvers (the MobyLCPSolver role).

The PyTorch counterpart of ``drake_tpu/solvers/lcp.py`` (reference
solvers/moby_lcp_solver.h).  Two solvers, split by job as in the reference:

  - ``lemke``: the classic complementary-pivot method on the host (NumPy),
    a copy of the reference's.  Pivoting is data-dependent control flow on
    one small tableau; the reference keeps it on the host by design, and so
    does the port.

  - ``solve_lcp_fb``: semismooth Newton on the Fischer-Burmeister NCP
    function phi(z, w) = sqrt(z^2 + w^2) - z - w, w = M z + q, over lanes: a
    fixed iteration count, branch-free, the batched solver for per-step
    physics use.  Range for the profiler: ``lcp.fb``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from drake_tpu_torch.solvers.ipm import _mv
from drake_tpu_torch.utils.device import tensors_on
from drake_tpu_torch.utils.linalg import solve


class LcpResult(NamedTuple):
    z: np.ndarray
    success: bool
    iterations: int


def lemke(M, q, max_pivots: Optional[int] = None, tol: float = 1e-10):
    """Solve w = M z + q, w >= 0, z >= 0, w'z = 0 by Lemke's method.

    Returns LcpResult; success=False on ray termination (secondary ray) or
    pivot-limit, mirroring MobyLCPSolver::SolveLcpLemke's failure modes.
    """
    M = np.asarray(M, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64).ravel()
    n = q.size
    if np.all(q >= -tol):
        return LcpResult(np.zeros(n), True, 0)
    if max_pivots is None:
        max_pivots = 50 * n

    # Tableau: columns [w | z | z0 | q]; basis starts all-w.
    T = np.hstack([np.eye(n), -M, -np.ones((n, 1)), q.reshape(-1, 1)])
    basis = list(range(n))  # column indices of basic variables (w_i)
    # Entering: z0 (column 2n). Leaving: most negative q row.
    r = int(np.argmin(q))
    entering = 2 * n
    for it in range(max_pivots):
        # Pivot on (r, entering).
        piv = T[r, entering]
        if abs(piv) < tol:
            return LcpResult(np.zeros(n), False, it)
        T[r] = T[r] / piv
        for i in range(n):
            if i != r:
                T[i] = T[i] - T[i, entering] * T[r]
        leaving = basis[r]
        basis[r] = entering
        if entering == 2 * n or leaving == 2 * n:
            if leaving == 2 * n:
                break  # z0 left the basis: solution found
        # Complementary pivot rule: the complement of the leaving variable
        # enters next (w_i <-> z_i).
        entering = leaving + n if leaving < n else leaving - n
        # Minimum ratio test over rows with positive pivot column.
        col = T[:, entering]
        rhs = T[:, -1]
        mask = col > tol
        if not mask.any():
            return LcpResult(np.zeros(n), False, it + 1)  # secondary ray
        ratios = np.where(mask, rhs / np.where(mask, col, 1.0), np.inf)
        # Prefer dropping z0 when tied (standard anti-cycling choice).
        r = int(np.argmin(ratios))
        z0_row = basis.index(2 * n) if 2 * n in basis else -1
        if z0_row >= 0 and mask[z0_row] and ratios[z0_row] <= ratios[r] + tol:
            r = z0_row
    else:
        return LcpResult(np.zeros(n), False, max_pivots)

    z = np.zeros(n)
    for row, b in enumerate(basis):
        if n <= b < 2 * n:
            z[b - n] = T[row, -1]
    z = np.maximum(z, 0.0)
    w = M @ z + q
    ok = bool(np.all(w >= -1e-6) and abs(z @ w) < 1e-6 * (1 + n))
    return LcpResult(z, ok, it + 1)


# The step lengths of the backtracking on |phi|, tried at once.
_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.01)


def solve_lcp_fb(M, q, iterations: int = 30, reg: float = 1e-10, device=None):
    """LCPs of M (B, n, n) and q (B, n) by semismooth Newton on
    Fischer-Burmeister: a fixed number of damped Newton steps, each lane
    taking the first of the five candidate steps with the least merit
    |phi|^2; returns (z (B, n), max |min(z, w)| (B,)).  Requires M to be a
    P-matrix (unique solution) for convergence, the regime of the rigid
    constraint assembly (Delassus operator + regularization).  Arrays from
    the host go to `device` (the card by default)."""
    M, q = tensors_on((M, q), device=device)
    B, n = q.shape
    eps = 1e-12
    eye = torch.eye(n, dtype=q.dtype, device=q.device)
    alphas = torch.tensor(_ALPHAS, dtype=q.dtype, device=q.device)
    lanes = torch.arange(B, device=q.device)

    def fb(z, w):
        return torch.sqrt(z * z + w * w + eps) - z - w

    with torch.no_grad(), record_function("lcp.fb"):
        z = torch.clamp_min(-q, 0.0)
        for _ in range(iterations):
            w = _mv(M, z) + q
            r = torch.sqrt(z * z + w * w + eps)
            phi = r - z - w
            # dphi/dz = diag(z/r - 1) + diag(w/r - 1) M
            J = torch.diag_embed(z / r - 1.0) + (w / r - 1.0)[..., None] * M + reg * eye
            dz = -solve(J, phi)
            # The five candidates' merits in one batched evaluation.
            cands = torch.clamp_min(z[:, None] + alphas[:, None] * dz[:, None], 0.0)
            rr = fb(cands, cands @ M.mT + q[:, None])
            merits = torch.sum(rr * rr, dim=-1)
            merits = torch.where(torch.isfinite(merits), merits, torch.inf)
            z = cands[lanes, torch.argmin(merits, dim=1)]
        w = _mv(M, z) + q
        return z, torch.amax(torch.abs(torch.minimum(z, w)), dim=-1)
