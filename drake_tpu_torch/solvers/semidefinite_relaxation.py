"""Shor semidefinite relaxation of (nonconvex) quadratic programs.

The PyTorch port's copy of ``drake_tpu/solvers/semidefinite_relaxation.py``
(the MakeSemidefiniteRelaxation role, reference
solvers/semidefinite_relaxation.h): NumPy assembly over the port's
MathematicalProgram records, its SDP solved by the port's conic solver.
Given a MathematicalProgram whose
costs/constraints are linear or quadratic in x, build the SDP over the
moment matrix

    M = [[1,  x'],
         [x,  X ]]  >= 0        (X standing in for x x')

with every quadratic term lifted to a linear functional of (x, X), plus
the reference's RLT tightening — products of the linear bound rows —
without which simple box-constrained nonconvex QPs relax to -inf.
Everything binds to ONE svec(M) variable block, so the result is a plain
conic program for the in-house ADMM SDP backend.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from drake_tpu_torch.solvers import conic
from drake_tpu_torch.solvers.program import (
    MathematicalProgram,
    MathematicalProgramResult,
    Variables,
)


def _sv(i: int, j: int, m: int) -> int:
    """svec slot of symmetric entry (i, j) — lower-tri column-major."""
    if i < j:
        i, j = j, i
    return j * m - (j * (j - 1)) // 2 + (i - j)


def _lin_row(n: int, a: np.ndarray) -> np.ndarray:
    """Row over svec(M) for the linear functional a' x (x = M[1:, 0])."""
    m = n + 1
    row = np.zeros(conic.svec_size(m))
    for i in range(n):
        row[_sv(i + 1, 0, m)] += a[i]
    return row


def _quad_row(n: int, Q: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row over svec(M) for 0.5 x'Qx + b'x lifted to 0.5 <Q, X> + b'x."""
    m = n + 1
    row = _lin_row(n, b)
    for i in range(n):
        for j in range(n):
            row[_sv(i + 1, j + 1, m)] += 0.5 * Q[i, j]
    return row


def make_semidefinite_relaxation(
    prog: MathematicalProgram,
) -> Tuple[MathematicalProgram, Variables]:
    """Relax ``prog`` (linear/quadratic records only) to an SDP.

    Returns ``(sdp, Mvar)`` where ``Mvar`` holds svec(M); recover the
    x-solution with :func:`extract_x`.  Raises on generic (fn-based)
    records without quadratic structure.
    """
    n = prog.num_vars
    m = n + 1
    sdp = MathematicalProgram()
    Mvar = sdp.NewSymmetricContinuousVariables(m, "M")
    sdp.AddPositiveSemidefiniteConstraint(Mvar)

    # M[0, 0] == 1.
    e00 = np.zeros(conic.svec_size(m))
    e00[_sv(0, 0, m)] = 1.0
    sdp.AddLinearEqualityConstraint(e00[None], [1.0], Mvar)

    def lift_cols(r, row_fn):
        """Map a record's block-local rows to global-x rows."""
        s = r.vars.start
        full = np.zeros(n)
        full[s : s + r.vars.size] = row_fn
        return full

    cost_row = np.zeros(conic.svec_size(m))
    cost_const = 0.0
    for r in prog._costs:
        s, sz = r.vars.start, r.vars.size
        if r.kind == "linear":
            a = np.zeros(n)
            a[s : s + sz] = r.A.reshape(-1)
            cost_row += _lin_row(n, a)
            cost_const += r.c
        elif r.kind == "quadratic":
            Q = np.zeros((n, n))
            Q[s : s + sz, s : s + sz] = r.Q
            b = np.zeros(n)
            b[s : s + sz] = r.b
            cost_row += _quad_row(n, Q, b)
            cost_const += r.c
        elif r.kind == "generic" and r.Q is not None:
            Q = np.zeros((n, n))
            Q[s : s + sz, s : s + sz] = r.Q
            b = np.zeros(n)
            if r.b is not None:
                b[s : s + sz] = r.b
            cost_row += _quad_row(n, Q, b)
        else:
            raise ValueError(
                f"cannot lift cost record kind {r.kind!r} (no quadratic "
                "structure) — the relaxation needs linear/quadratic records"
            )
    sdp.AddLinearCost(cost_row, Mvar, b=cost_const)

    # Linear rows collected for the RLT products.
    lin_rows: List[Tuple[np.ndarray, float, float]] = []  # (a, lb, ub)

    for r in prog._constraints:
        s, sz = r.vars.start, r.vars.size
        if r.kind == "linear":
            for k in range(r.A.shape[0]):
                a = np.zeros(n)
                a[s : s + sz] = r.A[k]
                lin_rows.append((a, float(r.lb[k]), float(r.ub[k])))
        elif r.kind == "generic" and r.Q is not None:
            Q = np.zeros((n, n))
            Q[s : s + sz, s : s + sz] = r.Q
            b = np.zeros(n)
            if r.b is not None:
                b[s : s + sz] = r.b
            sdp.AddLinearConstraint(
                _quad_row(n, Q, b)[None], r.lb, r.ub, Mvar
            )
        elif r.kind in ("psd", "lmi"):
            raise ValueError("cannot relax a program that already has "
                             "matrix constraints")
        else:
            raise ValueError(
                f"cannot lift constraint record kind {r.kind!r} — the "
                "relaxation needs linear/quadratic records"
            )

    for a, lb, ub in lin_rows:
        sdp.AddLinearConstraint(_lin_row(n, a)[None], [lb], [ub], Mvar)

    # RLT tightening (reference semidefinite_relaxation.cc: products of
    # linear constraints): for every pair of finite one-sided rows
    # (u - a'x) >= 0, (b'x - l) >= 0 etc., the product is a valid
    # quadratic inequality, linear in (x, X).  Quadratic pair count is
    # kept to the finite-bound rows the program actually has.
    sided: List[Tuple[np.ndarray, float]] = []  # rows with  c - a'x >= 0
    for a, lb, ub in lin_rows:
        if np.isfinite(ub):
            sided.append((a, ub))       # ub - a'x >= 0
        if np.isfinite(lb):
            sided.append((-a, -lb))     # a'x - lb >= 0  ==  -lb - (-a)'x
    for p in range(len(sided)):
        for qi in range(p, len(sided)):
            a1, c1 = sided[p]
            a2, c2 = sided[qi]
            # (c1 - a1'x)(c2 - a2'x) >= 0:
            # c1 c2 - c1 a2'x - c2 a1'x + x' a1 a2' x >= 0.
            Q = np.outer(a1, a2) + np.outer(a2, a1)  # symmetrized, 2x
            row = _quad_row(n, Q, -(c1 * a2 + c2 * a1))
            sdp.AddLinearConstraint(
                row[None], [-c1 * c2], [np.inf], Mvar
            )
    return sdp, Mvar


def extract_x(
    result: MathematicalProgramResult, Mvar: Variables, n: int
) -> np.ndarray:
    """x = M[1:, 0] from the solved relaxation."""
    sv = np.asarray(result.GetSolution(Mvar))
    m = n + 1
    return np.asarray([sv[_sv(i + 1, 0, m)] for i in range(n)])
