"""Parity of drake_tpu_torch's ADMM QP, conic ADMM, AL-Newton, LCP and block
Cholesky solvers against drake_tpu's, on the CPU in float64.

The cases mirror tests/test_solvers.py (TestAdmmQp), test_conic.py,
test_lcp.py and test_block_cholesky.py, on the seeded inputs of
tests/solver_cases.py, which chip_smoke.py phase 20 also runs on the card.
The JAX function runs on each lane under ``vmap``, compiled once a case;
the port on all lanes at once, one lane and a batch whose lanes finish at
different iterations.

Tolerances (of max(1, the reference's largest magnitude)):
- 1e-10 on the iterates of the QP, the conic solver, AL-Newton and the
  Fischer-Burmeister LCP: the same iterations, their sums taken in another
  order (a lower Cholesky factor where the reference's is upper, batched
  matrix products) over up to thousands of iterations;
- 1e-12 on one cone projection and on the block Cholesky's factor, solve
  and Schur complement, a few dozen operations;
- exact on every iteration count, convergence flag and success flag, and on
  the host Lemke, which is a copy of the reference's.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import solver_cases as sc
from test_torch_multibody import close, run_jitted

ITER_TOL = 1e-10
OP_TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    import torch

    return None if a is None else torch.tensor(np.asarray(a))


def scaled(got, ref, tol):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    close(got, ref, tol * scale)


def exact(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def lanes_of(data, lanes):
    return tuple(None if a is None else np.asarray(a)[lanes] for a in data)


BATCHES = {"one lane": slice(0, 1), "batch": slice(None)}


# ---- the ADMM QP -------------------------------------------------------------------------

QP_SEEDS = (3, 4, 5, 6, 7)


@pytest.fixture(scope="module")
def admm_ref():
    """The reference's ADMM on QP_SEEDS' problems (default options, and
    without polish at 120 iterations, where lanes stop at the limit), and
    its IPM on the same problems."""
    from drake_tpu.solvers import ipm as jipm
    from drake_tpu.solvers import qp as jqp

    admm, ipm_form = sc.admm_qps(QP_SEEDS)
    out = {"ipm": run_jitted(jax.vmap(jipm.solve_qp_ipm), *ipm_form), "data": admm}
    for name, opts in QP_OPTIONS.items():
        options = jqp.QpOptions(**opts)
        out[name] = run_jitted(jax.vmap(lambda *a, o=options: jqp.solve_qp(*a, options=o)), *admm)
    return out


# The defaults; rho adapted every 10 steps from rho = 10, so that the lanes
# refactor several times; and polish off with 30 iterations in chunks of 8,
# so that every lane stops at the limit (after 32), unconverged.
QP_OPTIONS = {
    "default": {},
    "rho updates": dict(rho=10.0, rho_update_interval=10),
    "cut": dict(polish=False, max_iters=30, rho_update_interval=8),
}


@pytest.mark.parametrize("options", list(QP_OPTIONS))
@pytest.mark.parametrize("lanes", list(BATCHES))
def test_admm_qp_matches_jax(admm_ref, options, lanes):
    """x, y, the residuals, the iterations and the flags of each lane are
    the reference's; the lanes of the batch finish at different iterations,
    or stop at the limit unconverged."""
    from drake_tpu_torch.solvers import qp as tqp

    sl = BATCHES[lanes]
    ref = jax.tree_util.tree_map(lambda a: np.asarray(a)[sl], admm_ref[options])
    opts = tqp.QpOptions(**QP_OPTIONS[options])
    got = tqp.solve_qp(*(t(a) for a in lanes_of(admm_ref["data"], sl)), options=opts)
    scaled(got.x, ref.x, ITER_TOL)
    scaled(got.y, ref.y, ITER_TOL)
    scaled(got.primal_residual, ref.primal_residual, ITER_TOL)
    scaled(got.dual_residual, ref.dual_residual, ITER_TOL)
    exact(got.iterations, ref.iterations)
    exact(got.converged, ref.converged)
    if options == "cut":
        assert not ref.converged.any() and (ref.iterations == 32).all()
    elif lanes == "batch":
        assert len(set(ref.iterations.tolist())) > 1, "the lanes finish together"


def test_admm_qp_matches_the_ipm(admm_ref):
    """The JAX test's own check, on the port: the ADMM's x within 1e-5 of
    the IPM's on the same problems."""
    from drake_tpu_torch.solvers import qp as tqp

    got = tqp.solve_qp(*(t(a) for a in admm_ref["data"]))
    close(got.x, np.asarray(admm_ref["ipm"].w), 1e-5)


def test_admm_qp_without_rows_matches_jax():
    """m = 0: A of shape (0, n); every norm over the rows is 0, as the
    reference's, and the answer is -P^{-1} q."""
    from drake_tpu.solvers import qp as jqp
    from drake_tpu_torch.solvers import qp as tqp

    data = sc.admm_qps_free()
    ref = jax.tree_util.tree_map(np.asarray, run_jitted(jax.vmap(jqp.solve_qp), *data))
    for sl in BATCHES.values():
        got = tqp.solve_qp(*(t(a) for a in lanes_of(data, sl)))
        scaled(got.x, ref.x[sl], ITER_TOL)
        assert got.y.shape == ref.y[sl].shape
        exact(got.iterations, ref.iterations[sl])
        exact(got.converged, ref.converged[sl])
    P, q = data[0], data[1]
    close(got.x, -np.linalg.solve(P, q[..., None])[..., 0], 1e-8)


def test_admm_qp_warm_start_matches_jax(admm_ref):
    """Warm started from the solution of a perturbed problem."""
    from drake_tpu.solvers import qp as jqp
    from drake_tpu_torch.solvers import qp as tqp

    P, q, A, l, u = admm_ref["data"]
    x0 = np.asarray(admm_ref["default"].x) + 0.1
    y0 = np.asarray(admm_ref["default"].y) * 0.9
    ref = run_jitted(jax.vmap(lambda *a: jqp.solve_qp(*a[:5], x0=a[5], y0=a[6])),
                     P, q + 0.05, A, l, u, x0, y0)
    got = tqp.solve_qp(t(P), t(q + 0.05), t(A), t(l), t(u), x0=t(x0), y0=t(y0))
    scaled(got.x, ref.x, ITER_TOL)
    exact(got.iterations, ref.iterations)


# ---- the conic solver --------------------------------------------------------------------


def test_soc_projection_matches_jax_in_every_zone():
    from drake_tpu.solvers import conic as jc
    from drake_tpu_torch.solvers import conic as tc

    v = sc.soc_zone_vectors()
    ref = np.stack([np.asarray(jc._project_soc(jnp.asarray(row))) for row in v])
    got = tc._project_soc(t(v))
    scaled(got, ref, OP_TOL)
    close(got[:3], [[2.0, 1.0, 0.5], [0.0, 0.0, 0.0], [1.0, 1.0, 0.0]], 1e-15)


def test_psd_projection_with_a_repeated_eigenvalue():
    """The projected matrices (not the eigenvectors, which a repeated
    eigenvalue leaves free) are the reference's, for each block alone and
    for the blocks as one batch."""
    from drake_tpu.solvers import conic as jc
    from drake_tpu_torch.solvers import conic as tc

    mats = sc.repeated_eig_matrices()
    ref = np.stack([np.asarray(jc._project_psd(jnp.asarray(M.reshape(9)), 3)) for M in mats])
    scaled(tc._project_psd(t(mats.reshape(3, 9)), 3), ref, OP_TOL)
    for k, M in enumerate(mats):
        scaled(tc._project_psd(t(M.reshape(9)), 3), ref[k], OP_TOL)
    # The projection keeps the nonnegative part: eigenvalues (2, 2, 0) etc.
    w = np.linalg.eigvalsh(ref.reshape(3, 3, 3))
    close(w, np.sort(np.clip([[2.0, 2.0, -1.0], [-1.0, -1.0, 3.0], [0.0, 0.0, -2.0]], 0, None)),
          1e-12)


def test_cone_projection_groups_cones_of_one_size():
    from drake_tpu.solvers import conic as jc
    from drake_tpu_torch.solvers import conic as tc

    _, _, _, b, dims = sc.mixed_cones()
    ref = jax.vmap(jc.make_cone_projection(jc.ConeDims(**dims)))(jnp.asarray(b))
    scaled(tc.make_cone_projection(tc.ConeDims(**dims))(t(b)), ref, OP_TOL)


def _conic_cases():
    return {
        "lp": sc.conic_lp(),
        "pinned socp": sc.pinned_socps(sc.seeded_targets(5)),
        "max eigenvalue sdp": sc.max_eig_sdps(sc.seeded_symmetric(4)),
        "m = 0": sc.conic_qp_free(),
        "mixed cones": sc.mixed_cones(),
    }


@pytest.fixture(scope="module")
def conic_ref():
    from drake_tpu.solvers import conic as jc

    out = {}
    for name, (P, c, A, b, dims) in _conic_cases().items():
        cone = jc.ConeDims(**dims)
        if P is None:
            fn = jax.vmap(lambda c, A, b, cone=cone: jc.solve_conic(None, c, A, b, cone))
            out[name] = run_jitted(fn, c, A, b)
        else:
            fn = jax.vmap(lambda P, c, A, b, cone=cone: jc.solve_conic(P, c, A, b, cone))
            out[name] = run_jitted(fn, P, c, A, b)
    return out


# test_conic_lp's problem is one lane; the others run as one lane and a batch.
CONIC_RUNS = [("lp", "one lane")] + [(case, lanes) for case in list(_conic_cases())[1:]
                                     for lanes in BATCHES]


@pytest.mark.parametrize("case,lanes", CONIC_RUNS)
def test_conic_matches_jax(conic_ref, case, lanes):
    from drake_tpu_torch.solvers import conic as tc

    P, c, A, b, dims = _conic_cases()[case]
    sl = BATCHES[lanes]
    ref = jax.tree_util.tree_map(lambda a: np.asarray(a)[sl], conic_ref[case])
    got = tc.solve_conic(*(t(a) for a in lanes_of((P, c, A, b), sl)), tc.ConeDims(**dims))
    for field in ("x", "s", "y", "primal_residual", "dual_residual"):
        scaled(getattr(got, field), getattr(ref, field), ITER_TOL)
    exact(got.iterations, ref.iterations)
    exact(got.converged, ref.converged)
    assert got.converged.all()
    if lanes == "batch" and case != "m = 0":  # with no row, one iteration solves
        assert len(set(ref.iterations.tolist())) > 1, "the lanes finish together"


def test_conic_answers():
    """The answers of test_conic.py: t* = |p| and lambda_max."""
    from drake_tpu_torch.solvers import conic as tc

    ps = sc.seeded_targets(5)
    P, c, A, b, dims = sc.pinned_socps(ps)
    got = tc.solve_conic(P, t(c), t(A), t(b), tc.ConeDims(**dims))
    close(got.x[:, 0], np.linalg.norm(ps, axis=1), 1e-4)
    mats = sc.seeded_symmetric(4)
    P, c, A, b, dims = sc.max_eig_sdps(mats)
    got = tc.solve_conic(P, t(c), t(A), t(b), tc.ConeDims(**dims))
    close(got.x[:, 0], np.linalg.eigvalsh(mats)[:, -1], 1e-4)


# ---- AL-Newton ---------------------------------------------------------------------------

AL_CASES = {
    "rosenbrock": (sc.rosenbrock_cost, sc.line_constraint, sc.rosenbrock_starts(4), None, None),
    "m = 0": (sc.box_quadratic_cost, sc.no_constraint,
              np.array([[0.0, 0.0, 0.0], [0.5, -0.5, 0.2], [-0.9, 0.9, 0.0]]),
              -np.ones(3), np.ones(3)),
    "descent fallback": (sc.double_well_cost, sc.sum_constraint, sc.DOUBLE_WELL_STARTS, None,
                         None),
}


@pytest.fixture(scope="module")
def al_ref():
    from drake_tpu.solvers import al_newton as jal

    out = {}
    for name, (f, c, z0, lb, ub) in AL_CASES.items():
        bounds = () if lb is None else (jnp.asarray(lb), jnp.asarray(ub))
        fn = jax.vmap(lambda z, f=f, c=c, bounds=bounds: jal.solve(f, c, z, *bounds))
        out[name] = jax.tree_util.tree_map(np.asarray, run_jitted(fn, z0))
    return out


@pytest.mark.parametrize("lanes", list(BATCHES))
@pytest.mark.parametrize("case", list(AL_CASES))
def test_al_newton_matches_jax(al_ref, case, lanes):
    """z, lam, the violation, the cost and the success flag of each lane are
    the reference's; the lanes of a batch take different outer iteration
    counts (the port reports them; the reference does not)."""
    from drake_tpu_torch.solvers import al_newton as tal

    f, c, z0, lb, ub = AL_CASES[case]
    sl = BATCHES[lanes]
    ref = jax.tree_util.tree_map(lambda a: a[sl], al_ref[case])
    got = tal.solve(f, c, t(z0[sl]), t(lb), t(ub))
    scaled(got.z, ref.z, ITER_TOL)
    scaled(got.lam, ref.lam, ITER_TOL)
    scaled(got.cost, ref.cost, ITER_TOL)
    scaled(got.constraint_violation, ref.constraint_violation, ITER_TOL)
    exact(got.success, ref.success)
    assert got.lam.shape == ref.lam.shape
    if lanes == "batch" and case == "rosenbrock":
        assert len(set(got.iterations.tolist())) > 1, "the lanes finish together"
    if case == "rosenbrock" and lanes == "one lane":
        # tests/test_solvers.py's answer: x + y = 1.
        assert bool(got.success[0])
        close(got.z.sum(-1), [1.0], 1e-6)


def test_al_newton_descent_fallback_is_taken():
    """At the double well's first start the damped Newton step is an ascent
    direction (negative curvature), so the first inner step takes the
    fallback solve: H + nu I with nu = 1e-6 gives dz'g > 0."""
    z = sc.DOUBLE_WELL_STARTS[0]
    mu, nu = 10.0, 1e-6
    C = np.array([[1.0, 1.0]])
    cz = np.array([z[0] + z[1] - 0.5])
    g = np.array([4 * z[0] ** 3 - 4 * z[0], 2 * z[1]]) + C.T @ (mu * cz)
    H = np.diag([12 * z[0] ** 2 - 4, 2.0]) + mu * C.T @ C
    dz = -np.linalg.solve(H + nu * np.eye(2), g)
    assert dz @ g > 0


# ---- the LCP solvers ---------------------------------------------------------------------


def test_lemke_copy_is_the_reference():
    """The port's host Lemke is a copy: the same z, flag and pivot count on
    every problem, those that fail included."""
    from drake_tpu.solvers import lcp as jlcp
    from drake_tpu_torch.solvers import lcp as tlcp

    outcomes = set()
    for M, q in sc.lemke_problems():
        ref, got = jlcp.lemke(M, q), tlcp.lemke(M, q)
        np.testing.assert_array_equal(got.z, ref.z)
        assert (got.success, got.iterations) == (ref.success, ref.iterations)
        outcomes.add(ref.success)
    assert outcomes == {True, False}


@pytest.mark.parametrize("lanes", list(BATCHES))
def test_lcp_fb_matches_jax(lanes):
    """z and the residual of each lane are the reference's, and z is
    Lemke's (test_lcp.py's check)."""
    from drake_tpu.solvers import lcp as jlcp
    from drake_tpu_torch.solvers import lcp as tlcp

    M, q = sc.spd_lcps(6, 7)
    sl = BATCHES[lanes]
    z_ref, r_ref = (np.asarray(a) for a in run_jitted(jax.vmap(jlcp.solve_lcp_fb), M[sl], q[sl]))
    z, resid = tlcp.solve_lcp_fb(t(M[sl]), t(q[sl]))
    scaled(z, z_ref, ITER_TOL)
    close(resid, r_ref, ITER_TOL)
    assert float(resid.max()) < 1e-8
    for k in range(z.shape[0]):
        close(z[k], jlcp.lemke(M[sl][k], q[sl][k]).z, 1e-6)


def test_lcp_fb_stalls_where_the_reference_does():
    """Of 4,096 seeded LCPs at the iiwa world's n = 27 (chip_smoke.py 20c),
    20 keep a residual above 1e-8 after the 30 iterations, up to 3.2e-7:
    a degenerate pair (z and w both ~0) meets the floor of the smoothing
    sqrt(z^2 + w^2 + 1e-12).  The reference stalls on the same lanes at the
    same residuals."""
    from drake_tpu.solvers import lcp as jlcp
    from drake_tpu_torch.solvers import lcp as tlcp

    M, q = sc.spd_lcps(4096, 27, seed=0)
    _, resid = tlcp.solve_lcp_fb(t(M), t(q))
    stalled = (resid > 1e-8).nonzero().flatten().numpy()
    assert len(stalled) == 20 and 3e-7 < float(resid.max()) < 3.3e-7
    _, r_ref = run_jitted(jax.vmap(jlcp.solve_lcp_fb), M[stalled], q[stalled])
    close(resid[stalled], r_ref, ITER_TOL)


# ---- the block Cholesky ------------------------------------------------------------------


@pytest.mark.parametrize("couplings", list(sc.COUPLINGS))
def test_block_cholesky_matches_jax(couplings):
    """The pattern, the factor, the solve and the dense matrix are the
    reference's, and H x = rhs."""
    from drake_tpu.solvers import block_cholesky as jbc
    from drake_tpu_torch.solvers import block_cholesky as tbc

    pattern = sc.COUPLINGS[couplings]
    rng = np.random.default_rng(0)
    diag, off = sc.random_block_spd(rng, 4, 3, pattern)
    rhs = rng.normal(size=12)
    jchol, tchol = jbc.BlockSparseCholesky(4, 3, pattern), tbc.BlockSparseCholesky(4, 3, pattern)
    assert tchol.pattern == jchol.pattern and tchol._cols == jchol._cols
    joff = {k: jnp.asarray(v) for k, v in off.items()}
    Ld_ref, Lo_ref = jchol.factor(jnp.asarray(diag), joff)
    toff = {k: t(v) for k, v in off.items()}
    Ld, Lo = tchol.factor(t(diag), toff)
    scaled(Ld, Ld_ref, OP_TOL)
    assert set(Lo) == set(Lo_ref)
    for k in Lo:
        scaled(Lo[k], Lo_ref[k], OP_TOL)
    x = tchol.solve(Ld, Lo, t(rhs))
    scaled(x, jchol.solve(Ld_ref, Lo_ref, jnp.asarray(rhs)), OP_TOL)
    H = tchol.to_dense(t(diag), toff)
    scaled(H, jchol.to_dense(jnp.asarray(diag), joff), 0.0)
    close(H @ x, rhs, 1e-9)


def test_block_cholesky_over_scenarios_matches_jax():
    """test_jit_and_vmap's chain of 5 blocks of 6 x 6 over 8 scenarios: the
    port's one batched call against the reference under vmap."""
    from drake_tpu.solvers import block_cholesky as jbc
    from drake_tpu_torch.solvers import block_cholesky as tbc

    couplings, diag, off, rhs = sc.chain_scenarios(8, blocks=5)
    jchol, tchol = jbc.BlockSparseCholesky(5, 6, couplings), tbc.BlockSparseCholesky(5, 6, couplings)
    offs = np.stack([off[c] for c in couplings], axis=1)

    def jsolve(diag, off_arr, rhs):
        Ld, Lo = jchol.factor(diag, {c: off_arr[k] for k, c in enumerate(couplings)})
        return jchol.solve(Ld, Lo, rhs)

    ref = run_jitted(jax.vmap(jsolve), diag, offs, rhs)
    Ld, Lo = tchol.factor(t(diag), {c: t(v) for c, v in off.items()})
    x = tchol.solve(Ld, Lo, t(rhs))
    scaled(x, ref, OP_TOL)
    H = tchol.to_dense(t(diag), {c: t(v) for c, v in off.items()})
    close((H @ x[..., None])[..., 0], rhs, 1e-8)


def test_block_cholesky_rejects_unknown_block():
    import torch

    from drake_tpu_torch.solvers import block_cholesky as tbc

    chol = tbc.BlockSparseCholesky(3, 2, [(1, 0)])
    diag = torch.eye(2, dtype=torch.float64).expand(3, 2, 2) * 10
    with pytest.raises(KeyError):
        chol.factor(diag, {(2, 0): torch.zeros((2, 2), dtype=torch.float64)})


def test_schur_complement_matches_jax():
    from drake_tpu.solvers import block_cholesky as jbc
    from drake_tpu_torch.solvers import block_cholesky as tbc

    rng = np.random.default_rng(2)
    A = rng.normal(size=(4, 4))
    A = A @ A.T + 4 * np.eye(4)
    B = rng.normal(size=(4, 3))
    C = rng.normal(size=(3, 3))
    C = C @ C.T + 4 * np.eye(3)
    S_ref, AinvB_ref = jbc.schur_complement(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C))
    S, AinvB = tbc.schur_complement(t(A), t(B), t(C))
    scaled(S, S_ref, OP_TOL)
    scaled(AinvB, AinvB_ref, OP_TOL)
    close(S, C - B.T @ np.linalg.solve(A, B), 1e-10)
