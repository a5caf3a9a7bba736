"""Mixed-integer branch-and-bound over the convex relaxation tier.

The PyTorch counterpart of ``drake_tpu/solvers/branch_and_bound.py`` (the
reference's MixedIntegerBranchAndBound, solvers/branch_and_bound.h): best-
first node selection and most-ambivalent branching over the binary
variables.  The tree search is a host loop (inherently sequential and
tiny), as in the reference; every node's relaxation is one solve on the
device through the program's convex dispatch (IPM QP or ADMM conic), so the
node order, the node count and the incumbent are the reference's.  Range
for the profiler: ``bb.node``.

Used by MathematicalProgram.Solve() whenever NewBinaryVariables exist.
"""

from __future__ import annotations

import heapq
import math
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function


def solve_mip(
    prog,
    dtype=torch.float64,
    device=None,
    options=None,
    integer_tol: float = 1e-4,
    gap_tol: float = 1e-6,
    max_nodes: int = 2000,
):
    """Best-first branch-and-bound on the program's binary variables, each
    node's relaxation solved on `device` (the card by default)."""
    from drake_tpu_torch.solvers.program import MathematicalProgramResult, Variables
    from drake_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    binaries = list(prog._binary_indices)
    base_constraints = list(prog._constraints)

    def solve_node(fixed):
        """Relaxation with the node's {0,1} fixings appended as bounds."""
        prog._constraints = list(base_constraints)
        try:
            for idx, val in fixed.items():
                prog.AddBoundingBoxConstraint(float(val), float(val), Variables(idx, 1, f"_bb{idx}"))
            with record_function("bb.node"):
                return prog._solve_relaxation(dtype, device, options)
        finally:
            prog._constraints = base_constraints

    incumbent: Optional[MathematicalProgramResult] = None
    best_cost = math.inf
    counter = 0
    root = solve_node({})
    if not root.is_success():
        return root  # infeasible (or solver failure) at the root
    heap = [(root.optimal_cost, counter, {}, root)]
    nodes = 0
    while heap and nodes < max_nodes:
        bound, _, fixed, res = heapq.heappop(heap)
        if bound >= best_cost - gap_tol:
            continue  # dominated by the incumbent
        z = res._z
        frac = {
            i: abs(z[i] - round(z[i]))
            for i in binaries
            if i not in fixed and abs(z[i] - round(z[i])) > integer_tol
        }
        if not frac:
            # Integral: snap, accept as incumbent.
            if bound < best_cost:
                best_cost = bound
                zi = np.array(z)
                for i in binaries:
                    zi[i] = round(zi[i])
                incumbent = MathematicalProgramResult(
                    zi, bound, True, {**res.solver_info, "mip_nodes": nodes})
            continue
        # Branch on the most ambivalent binary.
        branch_var = max(frac, key=frac.get)
        for val in (0, 1):
            child_fixed = dict(fixed)
            child_fixed[branch_var] = val
            child = solve_node(child_fixed)
            nodes += 1
            if not child.is_success():
                continue
            if child.optimal_cost < best_cost - gap_tol:
                counter += 1
                heapq.heappush(heap, (child.optimal_cost, counter, child_fixed, child))
    if incumbent is None:
        # No integral solution found: report the root relaxation as failure.
        return MathematicalProgramResult(root._z, root.optimal_cost, False,
                                         {**root.solver_info, "mip_nodes": nodes})
    return incumbent
