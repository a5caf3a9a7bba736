"""Seeded inputs of the optimization layer's cases (solvers/ and
systems/optimization), shared by the port's CPU parity tests
(tests/test_torch_solvers.py, tests/test_torch_program.py) and chip_smoke.py
phase 20, which holds the port on the card against the port on the CPU on
the same inputs.

The cases are those of the JAX package's tests (tests/test_solvers.py
TestAdmmQp, test_conic.py, test_lcp.py, test_block_cholesky.py,
test_program.py, test_semidefinite_relaxation.py, test_debug.py) and of
tutorials/03_optimization.py, plus batches whose lanes finish at different
iterations.  Generic costs and constraints are written so that the same
lambda runs on a JAX array and on a torch tensor of one lane: indexing,
``**``, ``@``, ``.sum()`` and slices, never ``jnp`` or ``torch`` calls.

NumPy only at import: no JAX and no torch.
"""

from __future__ import annotations

import numpy as np

# ---- the ADMM QP (tests/test_solvers.py) ------------------------------------------------


def random_qp(seed, n=10, m=3):
    """tests/test_solvers.py's random QP: P = L L' + I, q, G, b."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    return L @ L.T + np.eye(n), rng.normal(size=n), rng.normal(size=(m, n)), rng.normal(size=m)


def admm_qps(seeds=(3,), n=10, m=3, box=1.5):
    """TestAdmmQp's problems over lanes: the ADMM form (P, q, A = [G; I],
    l = [b; -box], u = [b; box]) and the IPM form (P, q, G, b, lb, ub), each
    array with a leading lane axis."""
    lanes = [random_qp(s, n, m) for s in seeds]
    P, q, G, b = (np.stack(a) for a in zip(*lanes))
    B = len(seeds)
    eye = np.broadcast_to(np.eye(n), (B, n, n))
    lb, ub = np.full((B, n), -box), np.full((B, n), box)
    admm = (P, q, np.concatenate([G, eye], axis=1), np.concatenate([b, lb], axis=1),
            np.concatenate([b, ub], axis=1))
    return admm, (P, q, G, b, lb, ub)


def admm_qps_free(seeds=(3, 4, 5)):
    """The same P and q with no constraint row (A of shape (0, n)): m = 0."""
    (P, q, _, _, _), _ = admm_qps(seeds)
    B, n = q.shape
    return P, q, np.zeros((B, 0, n)), np.zeros((B, 0)), np.zeros((B, 0))


# ---- the conic solver (tests/test_conic.py) ----------------------------------------------


def conic_lp():
    """test_conic_lp: min -x0 - x1 on the simplex edge; cone nonneg = 3."""
    c = np.array([[-1.0, -1.0]])
    A = np.array([[[1.0, 1.0], [-1.0, 0.0], [0.0, -1.0]]])
    b = np.array([[1.0, 0.0, 0.0]])
    return None, c, A, b, dict(nonneg=3)


def pinned_socps(ps):
    """test_conic_solver_vmappable's SOCP over targets ps (B, 2): min t s.t.
    ||x - p|| <= t with x pinned to 0 by two zero-cone rows, so t* = |p|;
    z = (t, x0, x1), cone zero = 2, socs = (3,)."""
    ps = np.asarray(ps, float)
    B = ps.shape[0]
    A = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
                  [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]])
    b = np.concatenate([np.zeros((B, 3)), -ps], axis=1)
    c = np.broadcast_to([1.0, 0.0, 0.0], (B, 3))
    return None, c, np.broadcast_to(A, (B, 5, 3)), b, dict(zero=2, socs=(3,))


def seeded_targets(lanes, seed=1):
    """Targets for ``pinned_socps``: test_conic.py's three, then seeded
    ones."""
    fixed = np.array([[0.0, 0.0], [3.0, 4.0], [1.0, 1.0]])
    rng = np.random.default_rng(seed)
    return np.concatenate([fixed, 3.0 * rng.normal(size=(max(lanes - 3, 0), 2))])[:lanes]


def max_eig_sdps(mats):
    """test_sdp_max_eigenvalue's SDP over symmetric matrices mats (B, k, k),
    in the conic form the program assembles for min t s.t. t I - M >= 0:
    rows -vec(I) t + s = vec(-M), cone psds = (k,); t* = lambda_max(M)."""
    mats = np.asarray(mats, float)
    B, k, _ = mats.shape
    A = np.broadcast_to(-np.eye(k).reshape(k * k, 1), (B, k * k, 1))
    return None, np.ones((B, 1)), A, (-mats).reshape(B, k * k), dict(psds=(k,))


def seeded_symmetric(lanes, k=2, seed=2):
    """test_sdp_max_eigenvalue's [[2, 1], [1, 3]] first, then seeded
    symmetric matrices of its size."""
    rng = np.random.default_rng(seed)
    R = rng.normal(size=(lanes, k, k))
    mats = 0.5 * (R + R.transpose(0, 2, 1))
    if k == 2:
        mats[0] = [[2.0, 1.0], [1.0, 3.0]]
    return mats


def conic_qp_free(seeds=(0, 1, 2), n=4):
    """Strictly convex QPs with no cone row (m = 0): P = L L' + I, c."""
    P, c = [], []
    for s in seeds:
        rng = np.random.default_rng(s)
        L = rng.normal(size=(n, n))
        P.append(L @ L.T + np.eye(n))
        c.append(rng.normal(size=n))
    B = len(seeds)
    return np.stack(P), np.stack(c), np.zeros((B, 0, n)), np.zeros((B, 0)), {}


def mixed_cones(lanes=3, seed=4):
    """A QP over two SOCs of one size, one of another, and two 3 x 3 PSD
    blocks beside a 2 x 2 one, so that the projection takes cones of one
    size together: min 0.5 x'Dx + c'x s.t. x_block - d in each cone, D a
    seeded positive diagonal."""
    rng = np.random.default_rng(seed)
    socs, psds = (3, 3, 4), (3, 2, 3)
    m = sum(socs) + sum(k * k for k in psds)
    n = m
    c = rng.normal(size=(lanes, n))
    A = np.broadcast_to(-np.eye(m), (lanes, m, n))
    b = -rng.normal(size=(lanes, m))
    P = np.eye(n) * rng.uniform(0.2, 5.0, size=(lanes, 1, n))
    return P, c, A, b, dict(socs=socs, psds=psds)


def soc_zone_vectors():
    """One vector in each zone of the SOC projection, and the boundaries:
    inside, polar-inside, shell, on the cone, on the polar cone, the apex."""
    return np.array([
        [2.0, 1.0, 0.5],  # inside
        [-2.0, 1.0, 0.0],  # polar-inside: zero
        [0.0, 2.0, 0.0],  # shell: (1, 1, 0)
        [1.0, 0.6, 0.8],  # on the cone
        [-1.0, 0.6, 0.8],  # on the polar cone
        [0.0, 0.0, 0.0],  # the apex
        [0.5, -3.0, 4.0],  # shell, t > 0
    ])


def repeated_eig_matrices():
    """Symmetric 3 x 3 matrices with a repeated eigenvalue: V diag(w) V'
    with w = (2, 2, -1), (-1, -1, 3) and (0, 0, -2), V seeded orthogonal."""
    rng = np.random.default_rng(5)
    V, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return np.stack([V @ np.diag(w) @ V.T for w in ((2.0, 2.0, -1.0), (-1.0, -1.0, 3.0),
                                                   (0.0, 0.0, -2.0))])


# ---- AL-Newton (tests/test_solvers.py's Rosenbrock) --------------------------------------


def rosenbrock_cost(z):
    return (1 - z[0]) ** 2 + 100 * (z[1] - z[0] ** 2) ** 2


def line_constraint(z):
    """x + y = 1, as a (1,) vector on either package's arrays."""
    return z[:1] + z[1:2] - 1.0


def rosenbrock_starts(lanes, seed=4, spread=0.3):
    """Starts about (-1, 2): tests/test_solvers.py's start first, then
    seeded ones."""
    rng = np.random.default_rng(seed)
    z0 = np.array([-1.0, 2.0]) + spread * rng.normal(size=(lanes, 2))
    z0[0] = [-1.0, 2.0]
    return z0


def box_quadratic_cost(z):
    """|z - 2|^2 on [-1, 1]^3 with no constraint (m = 0)."""
    return ((z - 2.0) ** 2).sum()


def no_constraint(z):
    return z[:0]


def double_well_cost(z):
    """z0^4 - 2 z0^2 + z1^2: negative curvature in z0 near 0, where the
    damped Newton step is no descent direction and AL-Newton falls back to
    its steeper solve."""
    return z[0] ** 4 - 2 * z[0] ** 2 + z[1] ** 2


def sum_constraint(z):
    return z[:1] + z[1:2] - 0.5


DOUBLE_WELL_STARTS = np.array([[0.1, 0.2], [-0.05, 0.3], [0.2, -0.1]])


# ---- the LCP solvers (tests/test_lcp.py) -------------------------------------------------


def spd_lcps(lanes, n, seed=1, ridge=0.5):
    """M = A A' + ridge I and q ~ N(0, 1) over lanes, as test_lcp.py's
    TestFbNewton."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(lanes, n, n))
    return A @ A.transpose(0, 2, 1) + ridge * np.eye(n), rng.normal(size=(lanes, n))


def lemke_problems():
    """(M, q) pairs for the host Lemke: test_lcp.py's fixed cases, seeded
    SPD ones of sizes 2-7 as its random batch, and matrices that are no
    P-matrix (ray termination, pivot limits)."""
    out = [(np.eye(3), np.array([1.0, 0.5, 2.0])),
           (np.array([[2.0, 1.0], [1.0, 2.0]]), np.array([-5.0, -6.0])),
           (np.array([[1.0, 0.0], [2.0, 1.0]]), np.array([1.0, -1.0]))]
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(2, 8))
        A = rng.normal(size=(n, n))
        out.append((A @ A.T + 0.1 * np.eye(n), rng.normal(size=n)))
    rng = np.random.default_rng(7)
    for _ in range(6):
        n = int(rng.integers(2, 6))
        out.append((rng.normal(size=(n, n)), rng.normal(size=n)))
    out.append((-np.eye(2), np.array([-1.0, -1.0])))
    return out


# ---- the block Cholesky (tests/test_block_cholesky.py) -----------------------------------

COUPLINGS = {
    "block diagonal": [],
    "chain": [(1, 0), (2, 1), (3, 2)],
    "arrow": [(3, 0), (3, 1), (3, 2)],
    "cycle": [(1, 0), (2, 0), (3, 1), (3, 2)],
}


def random_block_spd(rng, n, b, couplings, batch=()):
    """test_block_cholesky.py's SPD blocks (diagonally dominant) with a
    leading `batch`: diag (*batch, n, b, b) and {(i, j): (*batch, b, b)}."""
    diag = rng.normal(size=batch + (n, b, b))
    diag = diag @ np.swapaxes(diag, -1, -2) + (b * (len(couplings) + 2)) * np.eye(b)
    off = {(i, j): rng.normal(size=batch + (b, b)) * 0.5 for i, j in couplings}
    return diag, off


def chain_scenarios(scenarios, blocks=64, b=6, seed=6):
    """chip_smoke.py 20c's case: B free bodies in a chain ("B free bodies"
    of block_cholesky.py), `blocks` blocks of b x b over `scenarios`, and a
    right-hand side each."""
    rng = np.random.default_rng(seed)
    couplings = [(i + 1, i) for i in range(blocks - 1)]
    diag, off = random_block_spd(rng, blocks, b, couplings, (scenarios,))
    return couplings, diag, off, rng.normal(size=(scenarios, blocks * b))


# ---- MathematicalProgram (tests/test_program.py, test_conic.py, ...) ----------------------


PROGRAM_NAMES = (
    "unconstrained_quadratic", "equality_constrained_qp", "box_and_two_sided_rows", "lp",
    "tutorial_qp", "tutorial_nlp_sqp", "tutorial_nlp_al", "tutorial_nlp_al_mu1",
    "rosenbrock_with_constraint", "nonlinear_equality", "nonlinear_inequality_slack",
    "mixed_linear_and_generic", "slacked_rows_and_al", "variable_slicing", "socp_min_norm",
    "rotated_lorentz_cone", "sdp_max_eigenvalue", "sdp_matrix_variable", "conic_qp",
    "mip_knapsack", "mip_quadratic", "shor_convex_qp", "shor_nonconvex_box",
    "shor_binary_quadratic", "quadratic_constraint_nlp",
)


def programs(mods):
    """name -> (program, {name: Variables}, options) for each case, built
    with `mods`, a namespace of one package's ``program``,
    ``semidefinite_relaxation``, ``al_newton`` and ``stack`` (``jnp.stack``
    or ``torch.stack``).  The programs of tests/test_program.py,
    test_conic.py, test_semidefinite_relaxation.py and the tutorial's
    sections 2 and 3; a Shor relaxation's variables hold "M" and its "n"."""
    MP = mods.program.MathematicalProgram
    out = {}

    def case(fn):
        prog, var = MP(), {}
        options = fn(prog, var)
        out[fn.__name__] = (prog, var, options)
        return fn

    @case
    def unconstrained_quadratic(p, v):
        v["x"] = x = p.NewContinuousVariables(2)
        p.AddQuadraticErrorCost(np.eye(2), [1.0, -2.0], x)

    @case
    def equality_constrained_qp(p, v):
        v["x"] = x = p.NewContinuousVariables(2)
        p.AddQuadraticCost(np.eye(2), np.zeros(2), x)
        p.AddLinearEqualityConstraint([[1.0, 1.0]], [1.0], x)

    @case
    def box_and_two_sided_rows(p, v):
        v["x"] = x = p.NewContinuousVariables(2)
        p.AddQuadraticErrorCost(np.eye(2), [2.0, 2.0], x)
        p.AddBoundingBoxConstraint([0.0, 0.0], [1.0, 5.0], x)
        p.AddLinearConstraint([[1.0, 1.0]], 0.0, 2.5, x)

    @case
    def lp(p, v):
        v["x"] = x = p.NewContinuousVariables(2)
        p.AddLinearCost([-1.0, -1.0], x)
        p.AddBoundingBoxConstraint(0.0, 1.0, x)

    @case
    def tutorial_qp(p, v):
        v["v"] = x = p.NewContinuousVariables(2, "v")
        p.AddQuadraticCost(np.eye(2) * 2.0, np.zeros(2), x)
        p.AddLinearConstraint(np.array([[1.0, 1.0]]), [1.0], [np.inf], x)

    def tutorial_nlp(p, v):
        v["p"] = x = p.NewContinuousVariables(2, "p")
        p.AddCost(lambda z: (z[0] - 2.0) ** 2 + (z[1] - 1.0) ** 2, x)
        p.AddConstraint(lambda z: (z * z).sum(), 1.0, 1.0, x)
        p.SetInitialGuess(x, np.array([1.0, 0.0]))

    @case
    def tutorial_nlp_sqp(p, v):
        tutorial_nlp(p, v)

    @case
    def tutorial_nlp_al(p, v):
        tutorial_nlp(p, v)
        return mods.al_newton.AlNewtonOptions()

    @case
    def tutorial_nlp_al_mu1(p, v):
        tutorial_nlp(p, v)
        return mods.al_newton.AlNewtonOptions(mu0=1.0)

    @case
    def rosenbrock_with_constraint(p, v):
        v["x"] = x = p.NewContinuousVariables(2)
        p.AddCost(rosenbrock_cost, x)
        p.SetInitialGuess(x, [-1.0, 1.0])

    @case
    def nonlinear_equality(p, v):
        v["x"] = x = p.NewContinuousVariables(2)
        p.AddLinearCost([1.0, 1.0], x)
        p.AddConstraint(lambda z: (z ** 2).sum(), 1.0, 1.0, x)
        p.AddBoundingBoxConstraint(0.0, np.inf, x)
        p.SetInitialGuess(x, [0.9, 0.4])

    @case
    def nonlinear_inequality_slack(p, v):
        v["x"] = x = p.NewContinuousVariables(1)
        p.AddCost(lambda z: (z[0] - 3.0) ** 2, x)
        p.AddConstraint(lambda z: z[0] ** 2, -np.inf, 4.0, x)
        p.SetInitialGuess(x, [0.5])

    @case
    def mixed_linear_and_generic(p, v):
        v["x"] = x = p.NewContinuousVariables(2)
        p.AddQuadraticCost(2.0 * np.eye(2), np.zeros(2), x)
        p.AddLinearEqualityConstraint([[1.0, 1.0]], [2.0], x)
        p.AddConstraint(lambda z: z[0] * z[1], 0.75, np.inf, x)
        p.SetInitialGuess(x, [1.5, 0.5])

    @case
    def slacked_rows_and_al(p, v):
        """Two slacked linear rows around a generic one, so that the rows'
        order is the reference's, through AL-Newton."""
        v["x"] = x = p.NewContinuousVariables(3)
        p.AddQuadraticErrorCost(np.eye(3), [1.0, -1.0, 0.5], x)
        p.AddLinearConstraint([[1.0, 1.0, 0.0]], -0.5, 0.5, x)
        p.AddConstraint(lambda z: z[:2] * z[1:], -np.inf, 0.2, x)
        p.AddLinearConstraint([[0.0, 1.0, 1.0], [1.0, 0.0, -1.0]], [-1.0, -2.0], [1.0, 0.3], x)
        p.SetInitialGuess(x, [0.1, -0.1, 0.2])
        # From the default mu0 = 10 (and from 1) both packages stall at
        # violation 0.2 with a slack on its bound; from 100 they succeed.
        return mods.al_newton.AlNewtonOptions(mu0=100.0)

    @case
    def variable_slicing(p, v):
        v["xy"] = xy = p.NewContinuousVariables(4, "xy")
        p.AddQuadraticErrorCost(np.eye(2), [1.0, 1.0], xy[:2])
        p.AddQuadraticErrorCost(np.eye(2), [-1.0, -1.0], xy[2:])

    @case
    def socp_min_norm(p, v):
        v["z"] = z = p.NewContinuousVariables(3, "z")
        p.AddLinearCost([1.0, 0.0, 0.0], z)
        p.AddLinearEqualityConstraint([[0.0, 1.0, 1.0]], [1.0], z)
        p.AddLorentzConeConstraint(np.eye(3), np.array([0.0, -1.0, -1.0]), z)

    @case
    def rotated_lorentz_cone(p, v):
        v["z"] = z = p.NewContinuousVariables(3, "z")
        p.AddLinearCost([1.0, 1.0, 0.0], z)
        p.AddLinearEqualityConstraint([[0.0, 0.0, 1.0]], [1.0], z)
        p.AddRotatedLorentzConeConstraint(np.eye(3), np.zeros(3), z)

    @case
    def sdp_max_eigenvalue(p, v):
        v["t"] = t = p.NewContinuousVariables(1, "t")
        p.AddLinearCost([1.0], t)
        p.AddLinearMatrixInequalityConstraint([-np.array([[2.0, 1.0], [1.0, 3.0]]), np.eye(2)], t)

    @case
    def sdp_matrix_variable(p, v):
        v["X"] = X = p.NewSymmetricContinuousVariables(2, "X")
        p.AddPositiveSemidefiniteConstraint(X)
        p.AddLinearCost([1.0, 0.0, 1.0], X)
        p.AddLinearConstraint([[1.0, 0.0, 1.0]], 2.0, np.inf, X)
        p.AddLinearEqualityConstraint([[0.0, 1.0, 0.0]], [0.3], X)

    @case
    def conic_qp(p, v):
        rng = np.random.default_rng(0)
        L = rng.normal(size=(4, 4))
        v["x"] = x = p.NewContinuousVariables(4, "x")
        p.AddQuadraticCost(L @ L.T + np.eye(4), rng.normal(size=4), x)
        p.AddBoundingBoxConstraint(-0.1, 0.1, x)
        t = p.NewContinuousVariables(1, "t")
        p.AddLinearEqualityConstraint([[1.0]], [1.0], t)
        p.AddLorentzConeConstraint([[1.0]], [0.0], t)

    @case
    def mip_knapsack(p, v):
        v["b"] = b = p.NewBinaryVariables(3, "b")
        p.AddLinearCost([-3.0, -4.0, -2.0], b)
        p.AddLinearConstraint([[2.0, 3.0, 1.0]], -np.inf, 4.0, b)

    @case
    def mip_quadratic(p, v):
        v["b"] = b = p.NewBinaryVariables(2, "b")
        p.AddQuadraticCost(2.0 * np.eye(2), -2.0 * np.array([0.4, 0.7]), b, c=0.4**2 + 0.7**2)

    def shor(build):
        def fn(p, v):
            src = MP()
            build(src)
            sdp, M = mods.semidefinite_relaxation.make_semidefinite_relaxation(src)
            out[fn.__name__] = (sdp, {"M": M, "n": src.num_vars}, None)
        fn.__name__ = "shor_" + build.__name__
        fn(None, None)

    @shor
    def convex_qp(src):
        x = src.NewContinuousVariables(2)
        src.AddQuadraticCost(np.eye(2) * 2, np.array([-2.0, -4.0]), x)
        src.AddBoundingBoxConstraint(-1.0, 1.0, x)

    @shor
    def nonconvex_box(src):
        x = src.NewContinuousVariables(2)
        src.AddQuadraticCost(-2.0 * np.eye(2), np.zeros(2), x)
        src.AddBoundingBoxConstraint(-1.0, 1.0, x)

    @shor
    def binary_quadratic(src):
        x = src.NewContinuousVariables(2)
        src.AddQuadraticCost(2 * np.array([[0.0, 1.0], [1.0, 0.0]]), np.zeros(2), x)
        for i in range(2):
            Q = np.zeros((2, 2))
            Q[i, i] = 2.0
            src.AddQuadraticConstraint(Q, np.zeros(2), 1.0, 1.0, x)

    @case
    def quadratic_constraint_nlp(p, v):
        v["x"] = x = p.NewContinuousVariables(2)
        p.AddQuadraticCost(np.eye(2) * 2, np.array([-2.0, 0.0]), x)
        p.AddQuadraticConstraint(2 * np.eye(2), np.zeros(2), 1.0, 1.0, x)
        p.SetInitialGuess(x, np.array([0.5, 0.5]))

    assert tuple(out) == PROGRAM_NAMES
    return out


def pendulum_f(stack, sin):
    """tests/test_debug.py's torque-driven pendulum, with `stack` and `sin`
    of one package."""
    def f(params, x, u, t):
        th, w = x[0], x[1]
        return stack([w, -9.81 * sin(th) - 0.1 * w + u[0]])

    return f


PENDULUM_GUESS = (np.array([3.0, 0.1]), np.array([0.0]))
