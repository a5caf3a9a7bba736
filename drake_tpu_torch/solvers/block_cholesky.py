"""Block-sparse (supernodal) Cholesky for SAP-shaped Hessians, over a batch of
scenarios.

The PyTorch counterpart of ``drake_tpu/solvers/block_cholesky.py``
(reference multibody/contact_solvers' SuperNodalSolver and
BlockSparseCholeskySolver).  The SAP Hessian H = A + J' G J is block-sparse
over cliques; a scene of B free bodies is block-banded with B 6x6 diagonal
blocks, where the dense factorization is O((6B)^3) and the supernodal one
O(B) in the chain case.

The sparsity pattern is static: the symbolic analysis (elimination order and
fill-in) runs in Python when the solver is built, as in the reference.  The
numeric factorization is a Python-unrolled right-looking blocked Cholesky
whose block operations (b x b potrf, trsm, syrk) take every leading batch
dimension of their blocks at once, so that one call factors a batch of
scenarios.  The factor is lower-triangular, as the reference's.

Ordering: blocks are eliminated in the given order; callers with tree
structure should pass leaves-first (exact, no fill beyond parent paths).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from drake_tpu_torch.utils.device import tensors_on
from drake_tpu_torch.utils.linalg import cholesky_or_nan


class BlockSparseCholesky:
    """Symbolic-then-numeric Cholesky over a fixed block pattern.

    Pattern: ``n_blocks`` square diagonal blocks of size ``block_size`` and a
    set of LOWER-triangle off-diagonal coupling blocks ``(i, j)`` with i > j.
    Symmetry is implied.  Fill-in is computed once at construction.
    """

    def __init__(self, n_blocks: int, block_size: int,
                 couplings: Sequence[Tuple[int, int]]):
        self.n = n_blocks
        self.b = block_size
        # Symbolic elimination: track the lower-triangle structure as a set
        # of (i, j), i > j; eliminating column k adds fill (i, j) for every
        # pair i > j of neighbors of k below k (standard chordal completion).
        struct = {(max(i, j), min(i, j)) for i, j in couplings if i != j}
        below: List[set] = [set() for _ in range(n_blocks)]
        for i, j in struct:
            below[j].add(i)
        fill = set(struct)
        for k in range(n_blocks):
            nb = sorted(below[k])
            for a_i in range(len(nb)):
                for b_i in range(a_i + 1, len(nb)):
                    i, j = nb[b_i], nb[a_i]
                    if (i, j) not in fill:
                        fill.add((i, j))
                        below[j].add(i)
        self.pattern = sorted(fill)  # all (i>j) blocks present in L
        self._idx = {ij: t for t, ij in enumerate(self.pattern)}
        # Per-column row lists for the factorization loop.
        self._cols: List[List[int]] = [[] for _ in range(n_blocks)]
        for i, j in self.pattern:
            self._cols[j].append(i)
        for c in self._cols:
            c.sort()

    def factor(self, diag, off: Dict[Tuple[int, int], torch.Tensor], device=None):
        """Factor H = L L'.

        diag: (..., n_blocks, b, b) symmetric diagonal blocks.
        off: {(i, j) i > j: (..., b, b) block H[i, j]}, a subset of the
        constructed coupling pattern.  Blocks from the host go to `device`
        (the card by default).

        Returns (Ldiag (..., n, b, b) lower-triangular, Loff {(i, j): (..., b,
        b)}); a diagonal block that is not positive definite gives NaN.
        """
        for ij in off:
            if ij not in self._idx:
                raise KeyError(f"block {ij} not in the symbolic pattern")
        diag, *blocks = tensors_on((diag, *off.values()), device=device)
        off = dict(zip(off, blocks))
        zero = diag.new_zeros(diag.shape[:-3] + (self.b, self.b))
        D = [diag[..., k, :, :] for k in range(self.n)]
        O = {ij: off.get(ij, zero) for ij in self.pattern}

        Ld: List[torch.Tensor] = [None] * self.n
        Lo: Dict[Tuple[int, int], torch.Tensor] = {}
        for k in range(self.n):
            Lk = cholesky_or_nan(D[k])
            Ld[k] = Lk
            rows = self._cols[k]
            if not rows:
                continue
            # L[i,k] = O[i,k] Lk^{-T}: X Lk' = O, for every row at once.
            S = torch.stack([O[(i, k)] for i in rows], dim=-3)
            X = torch.linalg.solve_triangular(Lk.mT.unsqueeze(-3), S, upper=True, left=False)
            for t, i in enumerate(rows):
                Lo[(i, k)] = X[..., t, :, :]
            # Schur updates: D[i] -= X_i X_i'; O[i,j] -= X_i X_j' (i > j).
            for a_i, i in enumerate(rows):
                Xa = X[..., a_i, :, :]
                D[i] = D[i] - Xa @ Xa.mT
                for b_i in range(a_i):
                    j = rows[b_i]
                    O[(i, j)] = O[(i, j)] - Xa @ X[..., b_i, :, :].mT
        return torch.stack(Ld, dim=-3), Lo

    def solve(self, Ld: torch.Tensor, Lo: Dict[Tuple[int, int], torch.Tensor],
              rhs: torch.Tensor) -> torch.Tensor:
        """Solve H x = rhs given the factor; rhs: (..., n_blocks * b)."""
        b = self.b
        y = [rhs[..., k * b:(k + 1) * b, None] for k in range(self.n)]
        # Forward: L y = rhs.
        for k in range(self.n):
            y[k] = torch.linalg.solve_triangular(Ld[..., k, :, :], y[k], upper=False)
            for i in self._cols[k]:
                y[i] = y[i] - Lo[(i, k)] @ y[k]
        # Backward: L' x = y.
        for k in reversed(range(self.n)):
            acc = y[k]
            for i in self._cols[k]:
                acc = acc - Lo[(i, k)].mT @ y[i]
            y[k] = torch.linalg.solve_triangular(Ld[..., k, :, :].mT, acc, upper=True)
        return torch.cat(y, dim=-2).squeeze(-1)

    def to_dense(self, diag, off) -> torch.Tensor:
        """Assemble the dense symmetric H (..., n * b, n * b) (testing,
        diagnostics, and the dense yardstick)."""
        n, b = self.n, self.b
        H = diag.new_zeros(diag.shape[:-3] + (n * b, n * b))
        for k in range(n):
            H[..., k * b:(k + 1) * b, k * b:(k + 1) * b] = diag[..., k, :, :]
        for (i, j), blk in off.items():
            H[..., i * b:(i + 1) * b, j * b:(j + 1) * b] = blk
            H[..., j * b:(j + 1) * b, i * b:(i + 1) * b] = blk.mT
        return H


def schur_complement(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor):
    """(S, A^{-1}B) with S = C - B' A^{-1} B, over any leading batch: the
    SchurComplement role (contact_solvers/schur_complement.h) used to
    condense deformable/FEM cliques into the rigid SAP problem.  The
    reference factors A as U'U (``cho_factor``'s upper default), the port
    as L L': the same solve within rounding."""
    L = cholesky_or_nan(A)
    AinvB = torch.cholesky_solve(B, L)
    return C - B.mT @ AinvB, AinvB
