"""First-order conic solver (LP / QP / SOCP / SDP over a cone product), over
lanes.

The PyTorch counterpart of ``drake_tpu/solvers/conic.py`` (the SCS /
Clarabel role, reference solvers/scs_solver.cc): ADMM on the conic standard
form of B problems with one cone

    minimize    0.5 x'Px + c'x
    subject to  A x + s = b,   s in K = {0}^z x R+^l x SOC(d_1) x ...
                                        x PSD(m_1) x ...

    x+ = argmin_x 0.5 x'Px + c'x + rho/2 ||Ax + s - b + y||^2
         -> one pre-factored Cholesky solve of (P + rho A'A + eps I)
    s+ = Pi_K(b - A x+ - y)        (over-relaxed)
    y+ = y + (A x+ + s+ - b)

with ``P`` (B, n, n) or None, ``c`` (B, n), ``A`` (B, m, n), ``b`` (B, m).
The cone dimensions are Python ints, as in the reference.  The projection
takes each cone over all lanes at once; the PSD blocks of one size go to
``torch.linalg.eigh`` as one batch.  The reference's ``while_loop`` runs
over all lanes with per-lane masks, the host asking every ``_CHECK_EVERY``
iterations whether a lane is active.  Termination mirrors SCS:
||Ax + s - b|| (primal) and ||Px + A'y + c|| (dual) below tol * (1 +
scale).  Range for the profiler: ``conic.iterate``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from drake_tpu_torch.solvers.ipm import _CHECK_EVERY, _mv
from drake_tpu_torch.utils.device import tensors_on
from drake_tpu_torch.utils.linalg import cho_solve, cholesky_or_nan


@dataclasses.dataclass(frozen=True)
class ConeDims:
    """Dimensions of the cone product, in this fixed order.

    zero: number of equality rows (s = 0).
    nonneg: number of one-sided inequality rows (s >= 0).
    socs: tuple of second-order cone dims d (s = (t, u), ||u|| <= t).
    psds: tuple of PSD matrix sizes m (s = vec of the full m*m matrix,
          row-major; the projection symmetrizes first).
    """

    zero: int = 0
    nonneg: int = 0
    socs: Tuple[int, ...] = ()
    psds: Tuple[int, ...] = ()

    @property
    def total(self) -> int:
        return self.zero + self.nonneg + sum(self.socs) + sum(m * m for m in self.psds)


@dataclasses.dataclass(frozen=True)
class ConicOptions:
    max_iters: int = 4000
    tol: float = 1e-7
    rho: float = 1.0
    # Over-relaxation factor (1.5-1.8 speeds ADMM; 1.0 = plain).
    alpha: float = 1.6
    ridge: float = 1e-9


class ConicSolution(NamedTuple):
    x: torch.Tensor  # (B, n)
    s: torch.Tensor  # (B, m)
    y: torch.Tensor  # (B, m) dual (unscaled: rho y)
    iterations: torch.Tensor  # (B,)
    primal_residual: torch.Tensor  # (B,)
    dual_residual: torch.Tensor  # (B,)
    converged: torch.Tensor  # (B,)


def _project_soc(v):
    """Projection of v (..., d) onto {(t, u): ||u|| <= t}."""
    t, u = v[..., 0], v[..., 1:]
    nu = torch.linalg.vector_norm(u, dim=-1)
    # Three zones: inside (keep), polar-inside (zero), shell (scale).
    coef = torch.clamp((t + nu) / torch.clamp_min(2.0 * nu, 1e-30), 0.0, 1.0)
    proj = torch.cat([torch.clamp_min((t + nu) / 2.0, 0.0)[..., None], coef[..., None] * u], dim=-1)
    inside = (nu <= t)[..., None]
    polar = (nu <= -t)[..., None]
    return torch.where(inside, v, torch.where(polar, torch.zeros_like(v), proj))


def _project_psd(v, m):
    """Projection of flattened m*m matrices v (..., m*m) onto the PSD cone,
    by one batched ``eigh``.  A matrix that is not finite comes out NaN, as
    the reference's ``eigh`` gives it (PyTorch's raises)."""
    S = v.unflatten(-1, (m, m))
    S = 0.5 * (S + S.mT)
    bad = ~torch.isfinite(S).all(dim=-1).all(dim=-1)
    w, V = torch.linalg.eigh(torch.where(bad[..., None, None], 0.0, S))
    P = (V * torch.clamp_min(w, 0.0)[..., None, :]) @ V.mT
    return torch.where(bad[..., None, None], torch.nan, P).flatten(-2)


def make_cone_projection(cone: ConeDims):
    """Pi_K over the stacked s vectors (B, m) (static slicing)."""
    # Offsets of the PSD blocks, by size.
    psd_at = {}
    off = cone.zero + cone.nonneg + sum(cone.socs)
    for k, m in enumerate(cone.psds):
        psd_at.setdefault(m, []).append((k, off))
        off += m * m

    def project(s):
        parts = []
        off = 0
        if cone.zero:
            parts.append(s.new_zeros(s.shape[:-1] + (cone.zero,)))
            off += cone.zero
        if cone.nonneg:
            parts.append(torch.clamp_min(s[..., off: off + cone.nonneg], 0.0))
            off += cone.nonneg
        for d in cone.socs:
            parts.append(_project_soc(s[..., off: off + d]))
            off += d
        psd_parts = [None] * len(cone.psds)
        for m, blocks in psd_at.items():
            stacked = torch.stack([s[..., o: o + m * m] for _, o in blocks], dim=-2)
            projected = _project_psd(stacked, m)
            for j, (k, _) in enumerate(blocks):
                psd_parts[k] = projected[..., j, :]
        parts.extend(psd_parts)
        if not parts:
            return s.new_zeros(s.shape[:-1] + (0,))
        return torch.cat(parts, dim=-1)

    return project


def solve_conic(P, c, A, b, cone: ConeDims, options: ConicOptions = ConicOptions(), x0=None,
                device=None) -> ConicSolution:
    """Solve the B conic programs (static cone dims).  P may be None for a
    linear objective.  Arrays from the host go to `device` (the card by
    default)."""
    c, A, b, P, x0 = tensors_on((c, A, b, P, x0), device=device)
    B, n = c.shape
    m = A.shape[-2]
    assert cone.total == m, f"cone dims {cone.total} != rows {m}"
    dtype, device = c.dtype, c.device
    P = c.new_zeros((B, n, n)) if P is None else P
    opts = options
    rho = opts.rho
    At = A.mT

    with torch.no_grad():
        # Pre-factored x-update matrix.
        M = P + rho * (At @ A) + opts.ridge * torch.eye(n, dtype=dtype, device=device)
        L = cholesky_or_nan(M)
        project = make_cone_projection(cone)
        b_tol = opts.tol * (1.0 + torch.linalg.vector_norm(b, dim=-1))
        c_tol = opts.tol * (1.0 + torch.linalg.vector_norm(c, dim=-1))

        def residuals(x, s, y):
            rp = torch.linalg.vector_norm(_mv(A, x) + s - b, dim=-1)
            rd = torch.linalg.vector_norm(_mv(P, x) + _mv(At, rho * y) + c, dim=-1)
            return rp, rd

        def body(x, s, y):
            rhs = -c - rho * _mv(At, s - b + y)
            x_new = cho_solve(L, rhs)
            Ax = _mv(A, x_new)
            # Over-relaxation on the Ax term.
            Ax_r = opts.alpha * Ax - (1.0 - opts.alpha) * (s - b)
            s_new = project(b - Ax_r - y)
            y_new = y + (Ax_r + s_new - b)
            return (x_new, s_new, y_new) + residuals(x_new, s_new, y_new)

        x = c.new_zeros((B, n)) if x0 is None else x0.expand(B, n).clone()
        s = project(b - _mv(A, x))
        y = c.new_zeros((B, m))
        rp, rd = residuals(x, s, y)
        it = torch.zeros(B, dtype=torch.long, device=device)
        for k in range(opts.max_iters):
            active = ~((rp <= b_tol) & (rd <= c_tol))
            if k % _CHECK_EVERY == 0 and not bool(active.any()):
                break
            with record_function("conic.iterate"):
                out = body(x, s, y)
                x, s, y = (torch.where(active[:, None], new, old)
                           for new, old in zip(out[:3], (x, s, y)))
                rp, rd = (torch.where(active, new, old) for new, old in zip(out[3:], (rp, rd)))
                it = it + active.long()
        converged = (rp <= b_tol) & (rd <= c_tol)
    return ConicSolution(x=x, s=s, y=rho * y, iterations=it, primal_residual=rp,
                         dual_residual=rd, converged=converged)


# ---------------------------------------------------------------------------
# Symmetric-matrix helpers (the reference's math::ToSymmetricMatrixFromLower
# role, solvers/sdpa_free_format.cc conventions), on the host.
# ---------------------------------------------------------------------------


def svec_size(m: int) -> int:
    return m * (m + 1) // 2


def svec_to_full_matrix_rows(m: int) -> np.ndarray:
    """(m*m, svec_size) scatter matrix: full row-major vec = S @ svec.

    svec order: lower-triangular column-major (diagonal included),
    matching NewSymmetricContinuousVariables block layout.
    """
    S = np.zeros((m * m, svec_size(m)))
    k = 0
    for j in range(m):
        for i in range(j, m):
            S[i * m + j, k] = 1.0
            S[j * m + i, k] = 1.0
            k += 1
    return S
