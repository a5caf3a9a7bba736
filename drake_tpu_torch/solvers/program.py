"""MathematicalProgram: declarative optimization-program container.

The PyTorch counterpart of ``drake_tpu/solvers/program.py`` (the
reference's program layer: solvers/mathematical_program.h:146,
solvers/solve.h:32 Solve(), choose_best_solver.h:19 dispatch).  Decision
variables are index blocks into one flat vector z, costs and constraints
are typed records (the Binding<Cost>/Binding<Constraint> role), and Solve()
classifies the program (the GetProgramType role) and dispatches:

  - linear/quadratic costs + linear constraints  -> the dense Mehrotra IPM
    QP (``solvers.ipm``; general two-sided rows become slack variables);
  - linear constraints plus Lorentz-cone or PSD records -> the ADMM conic
    solver (``solvers.conic``);
  - anything nonlinear -> the Sl1QP SQP (``solvers.sqp``) or
    augmented-Lagrangian Newton (``solvers.al_newton``, by the type of the
    options), with inequalities slacked into equalities + boxes;
  - binary variables -> branch-and-bound over the above
    (``solvers.branch_and_bound``).

The records and their assembly are NumPy on the host, as in the reference;
only the solve runs on the device, one lane of the batched back end.
``Solve`` runs on the card unless the caller passes ``device="cpu"``, and
its result holds NumPy, as the reference's.  Generic costs and constraints
are torch functions of one lane's block (shape (size,)), differentiable by
``torch.func``; a constraint's output size is read off one call on a
``meta`` tensor (a CPU one where that fails) when it is added, since the
device is known only at ``Solve``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from drake_tpu_torch.solvers import al_newton, conic, ipm, sqp
from drake_tpu_torch.utils.device import resolve_device


class Variables(NamedTuple):
    """A named block of decision variables: indices into the flat z."""

    start: int
    size: int
    name: str

    def indices(self):
        return np.arange(self.start, self.start + self.size)

    def __len__(self):
        return self.size

    def __getitem__(self, idx) -> "Variables":
        sub = self.indices()[idx]
        sub = np.atleast_1d(sub)
        if not (np.diff(sub) == 1).all():
            raise ValueError("variable slices must be contiguous")
        return Variables(int(sub[0]), len(sub), f"{self.name}[{idx}]")


@dataclasses.dataclass
class _Record:
    kind: str  # cost: linear|quadratic|generic ; constraint: linear|soc|psd|generic
    vars: Variables
    fn: Optional[Callable] = None
    A: Optional[np.ndarray] = None  # linear rows
    Q: Optional[np.ndarray] = None
    b: Optional[np.ndarray] = None
    c: float = 0.0
    lb: Optional[np.ndarray] = None
    ub: Optional[np.ndarray] = None


class MathematicalProgramResult:
    def __init__(self, z, cost, success, info):
        self._z = z
        self.optimal_cost = float(cost)
        self._success = bool(success)
        self.solver_info = info

    def is_success(self) -> bool:
        return self._success

    def GetSolution(self, var: Variables):
        out = self._z[var.start: var.start + var.size]
        return out[0] if var.size == 1 else out


def _lane(sol):
    """The one lane of a back end's solution, as the reference's unbatched
    solution."""
    return type(sol)(*(f[0] for f in sol))


def _output_size(fn: Callable, size: int) -> int:
    """The number of entries of fn(x) for x of shape (size,), from one call
    on a ``meta`` tensor; where the function cannot take one (a constant on
    the CPU or the card, a value read on the host), on a CPU tensor, then on
    one on the card."""
    devices = ["meta", "cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    for device in devices:
        try:
            out = fn(torch.zeros(size, dtype=torch.float64, device=device))
            break
        except Exception:
            if device == devices[-1]:
                raise
    return int(math.prod(out.shape))


class _Quadratic:
    """0.5 x'Qx + b'x on one lane, its tensors made once per (dtype,
    device): the function of AddQuadraticConstraint's record."""

    def __init__(self, Q, b):
        self.Q, self.b = Q, b
        self._made = {}

    def __call__(self, x):
        key = (x.dtype, x.device)
        if key not in self._made:
            self._made[key] = (torch.as_tensor(self.Q, dtype=x.dtype, device=x.device),
                               torch.as_tensor(self.b, dtype=x.dtype, device=x.device))
        Q, b = self._made[key]
        return 0.5 * x @ (Q @ x) + b @ x


class MathematicalProgram:
    def __init__(self):
        self._num_vars = 0
        self._blocks: List[Variables] = []
        self._costs: List[_Record] = []
        self._constraints: List[_Record] = []
        self._guess: dict = {}
        self._sym_dims: dict = {}
        self._binary_indices: List[int] = []

    # ------------------------------ variables ------------------------------

    def NewContinuousVariables(self, size: int, name: str = "x") -> Variables:
        v = Variables(self._num_vars, int(size), name)
        self._num_vars += int(size)
        self._blocks.append(v)
        return v

    def NewSymmetricContinuousVariables(self, m: int, name: str = "S") -> Variables:
        """An m x m symmetric matrix variable, stored as its lower triangle
        (column-major svec, diagonal included) — the reference's
        NewSymmetricContinuousVariables.  Pair with
        AddPositiveSemidefiniteConstraint."""
        v = self.NewContinuousVariables(conic.svec_size(m), name)
        self._sym_dims[(v.start, v.size)] = m
        return v

    def NewBinaryVariables(self, size: int, name: str = "b") -> Variables:
        """Binary {0,1} decision variables (the MIP tier).  Solve() runs
        branch-and-bound over the convex relaxation when any exist."""
        v = self.NewContinuousVariables(size, name)
        self._binary_indices.extend(range(v.start, v.start + v.size))
        self.AddBoundingBoxConstraint(0.0, 1.0, v)
        return v

    @property
    def num_vars(self) -> int:
        return self._num_vars

    def SetInitialGuess(self, var: Variables, value) -> None:
        self._guess[(var.start, var.size)] = np.asarray(value, float).reshape(var.size)

    # ------------------------------- costs ---------------------------------

    def AddLinearCost(self, a, var: Variables, b: float = 0.0):
        self._costs.append(_Record("linear", var, A=np.asarray(a, float).reshape(1, -1), c=float(b)))

    def AddQuadraticCost(self, Q, b, var: Variables, c: float = 0.0):
        """0.5 x'Qx + b'x + c over the block."""
        self._costs.append(_Record("quadratic", var, Q=np.asarray(Q, float),
                                   b=np.asarray(b, float), c=float(c)))

    def AddQuadraticErrorCost(self, Q, x_desired, var: Variables):
        Q = np.asarray(Q, float)
        xd = np.asarray(x_desired, float)
        self.AddQuadraticCost(2.0 * Q, -2.0 * Q @ xd, var, c=float(xd @ Q @ xd))

    def AddCost(self, fn: Callable, var: Variables):
        """Generic cost fn(x_block) -> scalar, a torch function of one lane."""
        self._costs.append(_Record("generic", var, fn=fn))

    # ----------------------------- constraints -----------------------------

    def AddLinearEqualityConstraint(self, A, b, var: Variables):
        A = np.atleast_2d(np.asarray(A, float))
        b = np.atleast_1d(np.asarray(b, float))
        self._constraints.append(_Record("linear", var, A=A, lb=b, ub=b))

    def AddLinearConstraint(self, A, lb, ub, var: Variables):
        A = np.atleast_2d(np.asarray(A, float))
        self._constraints.append(_Record(
            "linear", var, A=A,
            lb=np.broadcast_to(np.asarray(lb, float), (A.shape[0],)),
            ub=np.broadcast_to(np.asarray(ub, float), (A.shape[0],)),
        ))

    def AddBoundingBoxConstraint(self, lb, ub, var: Variables):
        self.AddLinearConstraint(np.eye(var.size), lb, ub, var)

    def AddLorentzConeConstraint(self, A, b, var: Variables):
        """A x + b in SOC: (Ax+b)[0] >= ||(Ax+b)[1:]|| (the reference's
        LorentzConeConstraint)."""
        A = np.atleast_2d(np.asarray(A, float))
        self._constraints.append(_Record("soc", var, A=A, b=np.asarray(b, float).reshape(A.shape[0])))

    def AddRotatedLorentzConeConstraint(self, A, b, var: Variables):
        """A x + b = (w0, w1, u) with w0*w1 >= ||u||^2, w0, w1 >= 0.

        Mapped to the plain SOC via (w0+w1, w0-w1, 2u)."""
        A = np.atleast_2d(np.asarray(A, float))
        b = np.asarray(b, float).reshape(A.shape[0])
        m = A.shape[0]
        # (w0, w1, u) -> (w0+w1, w0-w1, 2u): w0*w1 >= ||u||^2 and w0,w1 >= 0
        # iff w0+w1 >= ||(w0-w1, 2u)||.
        T = np.zeros((m, m))
        T[0, 0] = T[0, 1] = 1.0
        T[1, 0], T[1, 1] = 1.0, -1.0
        for i in range(2, m):
            T[i, i] = 2.0
        self._constraints.append(_Record("soc", var, A=T @ A, b=T @ b))

    def AddPositiveSemidefiniteConstraint(self, var: Variables):
        """The symmetric matrix stored in `var` (from
        NewSymmetricContinuousVariables) must be PSD."""
        key = (var.start, var.size)
        if key not in self._sym_dims:
            raise ValueError(
                "AddPositiveSemidefiniteConstraint needs a block from "
                "NewSymmetricContinuousVariables"
            )
        m = self._sym_dims[key]
        self._constraints.append(_Record("psd", var, A=conic.svec_to_full_matrix_rows(m),
                                         b=np.zeros(m * m), c=float(m)))

    def AddLinearMatrixInequalityConstraint(self, F: Sequence, var: Variables):
        """F[0] + sum_i x_i F[i+1] >= 0 (PSD), the reference's
        LinearMatrixInequalityConstraint."""
        F = [np.asarray(Fi, float) for Fi in F]
        m = F[0].shape[0]
        if len(F) != var.size + 1:
            raise ValueError("need one matrix per variable plus the constant")
        A = np.stack([Fi.reshape(m * m) for Fi in F[1:]], axis=1)
        self._constraints.append(_Record("psd", var, A=A, b=F[0].reshape(m * m), c=float(m)))

    def AddQuadraticConstraint(self, Q, b, lb, ub, var: Variables):
        """lb <= 0.5 x'Qx + b'x <= ub (reference AddQuadraticConstraint).

        Stored as a generic (fn-based) record so every solver path (SQP,
        AL-Newton) works unchanged, with the quadratic structure stashed
        for solvers/semidefinite_relaxation.make_semidefinite_relaxation.
        """
        Qn = np.asarray(Q, float)
        bn = np.asarray(b, float).reshape(-1)
        self._constraints.append(_Record(
            "generic", var, fn=_Quadratic(Qn, bn), Q=Qn, b=bn,
            lb=np.atleast_1d(np.asarray(lb, float)),
            ub=np.atleast_1d(np.asarray(ub, float)),
        ))

    def AddConstraint(self, fn: Callable, lb, ub, var: Variables):
        """Generic constraint lb <= fn(x_block) <= ub, a torch function of
        one lane."""
        m = _output_size(fn, var.size)
        self._constraints.append(_Record(
            "generic", var, fn=fn,
            lb=np.broadcast_to(np.asarray(lb, float), (m,)).copy(),
            ub=np.broadcast_to(np.asarray(ub, float), (m,)).copy(),
        ))

    # ------------------------------- solve ---------------------------------

    def program_type(self) -> str:
        """The GetProgramType role: 'lp' | 'qp' | 'conic' | 'nlp' (+ 'mip'
        handled orthogonally by Solve when binary variables exist)."""
        if any(r.kind == "generic" for r in self._costs) or any(
            r.kind == "generic" for r in self._constraints
        ):
            return "nlp"
        if any(r.kind in ("soc", "psd") for r in self._constraints):
            return "conic"
        if any(r.kind == "quadratic" for r in self._costs):
            return "qp"
        return "lp"

    def initial_guess(self) -> np.ndarray:
        z0 = np.zeros(self._num_vars)
        for (start, size), val in self._guess.items():
            z0[start: start + size] = val
        return z0

    def _expand(self, rec: _Record, M: np.ndarray) -> np.ndarray:
        """Scatter a (m, block) matrix into (m, num_vars)."""
        out = np.zeros((M.shape[0], self._num_vars))
        out[:, rec.vars.start: rec.vars.start + rec.vars.size] = M
        return out

    def Solve(self, dtype=torch.float64, device=None, options=None) -> MathematicalProgramResult:
        """Classify and solve on `device` (the card by default)."""
        device = resolve_device(device)
        if self._binary_indices:
            from drake_tpu_torch.solvers import branch_and_bound

            return branch_and_bound.solve_mip(self, dtype=dtype, device=device, options=options)
        return self._solve_relaxation(dtype, device, options)

    def _solve_relaxation(self, dtype, device, options) -> MathematicalProgramResult:
        kind = self.program_type()
        if kind in ("lp", "qp"):
            return self._solve_qp(dtype, device, options)
        if kind == "conic":
            return self._solve_conic(dtype, device, options)
        return self._solve_nlp(dtype, device, options)

    def _solve_conic(self, dtype, device, options):
        """Assemble Ax + s = b over the cone product and run the ADMM conic
        solver (the SCS/Clarabel backend role)."""
        n = self._num_vars
        P, q, c0 = self._assemble_quadratic()
        zero_rows, zero_rhs = [], []
        pos_rows, pos_rhs = [], []
        soc_blocks = []  # (A_rows, b) per cone
        psd_blocks = []  # (A_rows, b, m)
        for r in self._constraints:
            if r.kind == "linear":
                A = self._expand(r, r.A)
                for i in range(A.shape[0]):
                    row, lo, hi = A[i], r.lb[i], r.ub[i]
                    if lo == hi:
                        zero_rows.append(row)
                        zero_rhs.append(lo)
                        continue
                    if np.isfinite(hi):  # hi - a'x >= 0: s = hi - a'x
                        pos_rows.append(row)
                        pos_rhs.append(hi)
                    if np.isfinite(lo):  # a'x - lo >= 0: s = -lo + a'x
                        pos_rows.append(-row)
                        pos_rhs.append(-lo)
            elif r.kind == "soc":
                # s = A_r x + b_r in SOC  ->  conic rows (-A_r, b_r).
                soc_blocks.append((-self._expand(r, r.A), r.b))
            elif r.kind == "psd":
                psd_blocks.append((-self._expand(r, r.A), r.b, int(r.c)))
        rows = zero_rows + pos_rows
        rhs = zero_rhs + pos_rhs
        socs = []
        for A_r, b_r in soc_blocks:
            rows.extend(A_r)
            rhs.extend(b_r)
            socs.append(A_r.shape[0])
        psds = []
        for A_r, b_r, m in psd_blocks:
            rows.extend(A_r)
            rhs.extend(b_r)
            psds.append(m)
        A = np.stack(rows) if rows else np.zeros((0, n))
        b = np.asarray(rhs, float)
        cone = conic.ConeDims(zero=len(zero_rows), nonneg=len(pos_rows), socs=tuple(socs),
                              psds=tuple(psds))
        opts = options if isinstance(options, conic.ConicOptions) else conic.ConicOptions()
        sol = _lane(conic.solve_conic(
            *(torch.as_tensor(a, dtype=dtype, device=device)[None] for a in (P, q, A, b)), cone, opts,
            x0=torch.as_tensor(self.initial_guess(), dtype=dtype, device=device)[None],
        ))
        z = sol.x.cpu().numpy()
        cost = 0.5 * z @ (P @ z) + q @ z + c0
        return MathematicalProgramResult(z, cost, bool(sol.converged), {"solver": "conic_admm",
                                                                        "conic": sol})

    def _assemble_quadratic(self):
        n = self._num_vars
        P = np.zeros((n, n))
        q = np.zeros(n)
        c0 = 0.0
        for r in self._costs:
            s = r.vars.start
            e = s + r.vars.size
            if r.kind == "quadratic":
                P[s:e, s:e] += r.Q
                q[s:e] += r.b
                c0 += r.c
            elif r.kind == "linear":
                q[s:e] += r.A[0]
                c0 += r.c
        return P, q, c0

    def _solve_qp(self, dtype, device, options):
        n = self._num_vars
        P, q, c0 = self._assemble_quadratic()
        # Split linear rows: equalities stay; two-sided rows get slacks
        # (rows that are pure variable bounds fold into the box).
        box_lb = np.full(n, -np.inf)
        box_ub = np.full(n, np.inf)
        eq_rows, eq_rhs = [], []
        sl_rows, sl_lb, sl_ub = [], [], []
        for r in self._constraints:
            A = self._expand(r, r.A)
            for i in range(A.shape[0]):
                row, lo, hi = A[i], r.lb[i], r.ub[i]
                nz = np.nonzero(row)[0]
                if lo == hi:
                    eq_rows.append(row)
                    eq_rhs.append(lo)
                elif len(nz) == 1 and row[nz[0]] != 0.0:
                    s = row[nz[0]]
                    l2, h2 = sorted((lo / s, hi / s))
                    box_lb[nz[0]] = max(box_lb[nz[0]], l2)
                    box_ub[nz[0]] = min(box_ub[nz[0]], h2)
                else:
                    sl_rows.append(row)
                    sl_lb.append(lo)
                    sl_ub.append(hi)
        ns = len(sl_rows)
        ntot = n + ns
        Pt = np.zeros((ntot, ntot))
        Pt[:n, :n] = P
        qt = np.concatenate([q, np.zeros(ns)])
        G_rows = [np.concatenate([row, np.zeros(ns)]) for row in eq_rows]
        b_rhs = list(eq_rhs)
        for k, row in enumerate(sl_rows):
            s_row = np.zeros(ns)
            s_row[k] = -1.0
            G_rows.append(np.concatenate([row, s_row]))
            b_rhs.append(0.0)
        G = np.stack(G_rows) if G_rows else np.zeros((0, ntot))
        b = np.asarray(b_rhs, float)
        lb = np.concatenate([box_lb, np.asarray(sl_lb, float)])
        ub = np.concatenate([box_ub, np.asarray(sl_ub, float)])
        # Symmetrize (AddQuadraticCost convention is 0.5 x'Qx with Q sym).
        Pt = 0.5 * (Pt + Pt.T)
        # Ignore NLP solver options when the program dispatches to the QP
        # backend (mirrors SolverOptions being per-solver in the reference).
        opts = options if isinstance(options, ipm.IpmOptions) else ipm.IpmOptions()
        sol = _lane(ipm.solve_qp_ipm(
            *(torch.as_tensor(a, dtype=dtype, device=device)[None] for a in (Pt, qt, G, b, lb, ub)),
            opts,
        ))
        z = sol.w.cpu().numpy()[:n]
        cost = 0.5 * z @ (P @ z) + q @ z + c0
        return MathematicalProgramResult(z, cost, bool(sol.converged), {"solver": "ipm", "qp": sol})

    def _solve_nlp(self, dtype, device, options):
        n = self._num_vars
        # Inequalities become equalities with slack variables; slacks carry
        # the bounds (the standard Sl1QP/AL transformation).
        slacked = []  # (spec, slack_start, m, lo, hi)
        ns = 0
        box_lb = np.full(n, -np.inf)
        box_ub = np.full(n, np.inf)
        eq_linear = []  # expanded rows with rhs
        for r in self._constraints:
            if r.kind == "linear":
                A = self._expand(r, r.A)
                for i in range(A.shape[0]):
                    row, lo, hi = A[i], r.lb[i], r.ub[i]
                    nz = np.nonzero(row)[0]
                    if lo == hi:
                        eq_linear.append((row, lo))
                    elif len(nz) == 1:
                        s = row[nz[0]]
                        l2, h2 = sorted((lo / s, hi / s))
                        box_lb[nz[0]] = max(box_lb[nz[0]], l2)
                        box_ub[nz[0]] = min(box_ub[nz[0]], h2)
                    else:
                        slacked.append((("row", row), ns, 1, lo, hi))
                        ns += 1
            else:
                # Slack every generic row (equality rows pin the slack via
                # its box, lb == ub).
                m = len(r.lb)
                slacked.append((("fn", r), ns, m, r.lb, r.ub))
                ns += m
        z0 = np.concatenate([self.initial_guess(), np.zeros(ns)])
        lb = np.concatenate([box_lb, np.zeros(ns)])
        ub = np.concatenate([box_ub, np.zeros(ns)])
        # Fill slack bounds.
        for _, s0, m, lo, hi in slacked:
            lb[n + s0: n + s0 + m] = lo
            ub[n + s0: n + s0 + m] = hi
        cost_fn = self._nlp_cost(dtype, device)
        constraint_fn = self._nlp_constraints(n, eq_linear, slacked, dtype, device)

        def T(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        opts = options or sqp.SqpOptions()
        backend = al_newton if isinstance(opts, al_newton.AlNewtonOptions) else sqp
        res = _lane(backend.solve(cost_fn, constraint_fn, T(z0)[None], T(lb), T(ub), options=opts))
        zsol = res.z.cpu().numpy()
        return MathematicalProgramResult(zsol[:n], float(cost_fn(res.z)), bool(res.success),
                                         {"solver": "sqp/al", "result": res})

    def _nlp_cost(self, dtype, device):
        """The program's cost on one lane of z, its records' tensors made
        once on `device`."""
        def T(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        terms = []
        for r in self._costs:
            span = slice(r.vars.start, r.vars.start + r.vars.size)
            if r.kind == "generic":
                terms.append((span, r.fn))
            elif r.kind == "quadratic":
                Q, bq, c = T(r.Q), T(r.b), r.c
                terms.append((span, lambda xb, Q=Q, bq=bq, c=c: 0.5 * xb @ (Q @ xb) + bq @ xb + c))
            else:
                a, c = T(r.A[0]), r.c
                terms.append((span, lambda xb, a=a, c=c: a @ xb + c))

        def cost_fn(z):
            total = z.new_zeros(())
            for span, term in terms:
                total = total + term(z[span])
            return total

        return cost_fn

    @staticmethod
    def _nlp_constraints(n, eq_linear, slacked, dtype, device):
        """The program's equality residuals on one lane of z: the linear
        equality rows, then each slacked row or function less its slacks, in
        the reference's order; a run of slacked linear rows is one
        matrix-vector product."""
        def T(a):
            return torch.as_tensor(np.asarray(a, float), dtype=dtype, device=device)

        pieces = []  # functions of z, each giving a block of rows
        if eq_linear:
            E, e = T([row for row, _ in eq_linear]), T([rhs for _, rhs in eq_linear])
            pieces.append(lambda z: E @ z[:n] - e)
        run = []  # consecutive slacked linear rows: (row, slack index)

        def flush():
            if run:
                R, s = T([row for row, _ in run]), slice(n + run[0][1], n + run[0][1] + len(run))
                pieces.append(lambda z: R @ z[:n] - z[s])
                run.clear()

        for spec, s0, m, _, _ in slacked:
            if spec[0] == "row":
                run.append((spec[1], s0))
                continue
            flush()
            r = spec[1]
            x, s = slice(r.vars.start, r.vars.start + r.vars.size), slice(n + s0, n + s0 + m)
            pieces.append(lambda z, fn=r.fn, x=x, s=s: fn(z[x]).reshape(-1) - z[s])
        flush()

        def constraint_fn(z):
            if not pieces:
                return z[:0]
            return torch.cat([piece(z) for piece in pieces])

        return constraint_fn


def Solve(prog: MathematicalProgram, **kw) -> MathematicalProgramResult:
    """Free-function entry mirroring drake::solvers::Solve (solve.h:32)."""
    return prog.Solve(**kw)
