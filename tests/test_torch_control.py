"""Parity of drake_tpu_torch's Riccati and Lyapunov solvers, LQR family,
TV-LQR, estimators and energy-shaping controllers against drake_tpu's, on
the CPU in float64.

The cases are drawn from tests/test_control.py and
tests/test_energy_shaping.py, plus parity on seeded random systems.  The
JAX function runs on one problem under ``vmap``, the port on all at once.

Tolerances (of the reference's largest magnitude where that exceeds 1):
- 1e-10 on the Riccati and Lyapunov solutions and on every gain: the
  iterations are the reference's, but the sign iteration's inverse and the
  subspace's least squares are other factorizations (the port's one LU for
  the inverse and the log determinant, QR for the least squares, where the
  reference takes an SVD; ``lstsq`` runs ``gels`` in the tests as on the card),
  and 40 sign iterations amplify their rounding;
- 1e-12 on the controllers' outputs at given states and on the estimator
  update, the same arithmetic in another order;
- 1e-9 on closed loops over hundreds of steps, which carry the gains'
  rounding;
- exact on the TV-LQR knot picked at the grid points and between them.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_multibody import close, run_jitted

F64 = jnp.float64
GAIN_TOL = 1e-10
TOL = 1e-12
LOOP_TOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    import torch

    return torch.tensor(np.asarray(a))


def scaled(got, ref, tol):
    ref = np.asarray(ref)
    close(got, ref, tol * max(1.0, float(np.abs(ref).max())))


def port_params(module, jparams):
    arrays = {f.name: np.asarray(getattr(jparams, f.name)) for f in dataclasses.fields(jparams)}
    return module.params_from_numpy(arrays, device="cpu")


def acrobot_pair():
    """(JAX params, port params, port system) of the acrobot, float64."""
    from drake_tpu.models import acrobot as ja
    from drake_tpu_torch.models import acrobot as ta

    jp = ja.default_params(F64)
    tp = port_params(ta, jp)
    return jp, tp, ta.make_system(tp)


# ---- Riccati and Lyapunov ---------------------------------------------------------

def random_systems(seed, B=8, n=4, m=2):
    """B stabilizable systems: A with entries N(0, 1), B N(0, 1) of rank m,
    Q = C'C + 0.1 I and R = D'D + 0.5 I positive definite."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    Bm = rng.standard_normal((B, n, m))
    C = rng.standard_normal((B, n, n))
    D = rng.standard_normal((B, m, m))
    Q = C.transpose(0, 2, 1) @ C / n + 0.1 * np.eye(n)
    R = D.transpose(0, 2, 1) @ D / m + 0.5 * np.eye(m)
    return A, Bm, Q, R


@pytest.mark.parametrize("name", ["solve_care", "solve_dare"])
def test_riccati_matches_jax_on_random_systems(name):
    from drake_tpu.math import riccati as jr
    from drake_tpu_torch.math import riccati as tr

    A, B, Q, R = random_systems(0)
    if name == "solve_dare":
        A = 0.5 * A  # mostly stable, some not: the doubling's domain
    ref = jax.vmap(getattr(jr, name))(A, B, Q, R)
    got = getattr(tr, name)(t(A), t(B), t(Q), t(R))
    for g, r in zip(got, np.asarray(ref)):
        scaled(g, r, GAIN_TOL)
    # The solution solves its equation.
    X = got.numpy()
    At = A.transpose(0, 2, 1)
    if name == "solve_care":
        res = At @ X + X @ A - X @ B @ np.linalg.solve(R, B.transpose(0, 2, 1)) @ X + Q
    else:
        BtX = B.transpose(0, 2, 1) @ X
        res = At @ X @ A - At @ X @ B @ np.linalg.solve(R + BtX @ B, BtX @ A) + Q - X
    assert np.abs(res).max() < 1e-8 * max(1.0, np.abs(X).max())


@pytest.mark.parametrize("kind", ["continuous", "discrete"])
def test_lyapunov_matches_jax_on_random_systems(kind):
    from drake_tpu.math import riccati as jr
    from drake_tpu_torch.math import riccati as tr

    A, _, Q, _ = random_systems(1)
    n = A.shape[-1]
    # Shift A to be Hurwitz, or scale it to be Schur stable.
    radius = np.abs(np.linalg.eigvals(A)).max(axis=-1)[:, None, None]
    A = A - (radius + 0.5) * np.eye(n) if kind == "continuous" else 0.8 * A / radius
    name = f"solve_lyapunov_{kind}"
    ref = jax.vmap(getattr(jr, name))(A, Q)
    got = getattr(tr, name)(t(A), t(Q))
    for g, r in zip(got, np.asarray(ref)):
        scaled(g, r, GAIN_TOL)


def test_riccati_broadcasts_shared_weights():
    """One Q and R for a batch of (A, B), and a single unbatched problem."""
    from drake_tpu_torch.math import riccati as tr

    A, B, Q, R = random_systems(2, B=3)
    batched = tr.solve_care(t(A), t(B), t(Q[0]), t(R[0]))
    single = tr.solve_care(t(A[1]), t(B[1]), t(Q[0]), t(R[0]))
    assert batched.shape == (3, 4, 4) and single.shape == (4, 4)
    close(batched[1], single.numpy(), 1e-12)


# ---- LQR (tests/test_control.py) ---------------------------------------------------

def test_double_integrator_closed_form():
    """S = [[sqrt 3, 1], [1, sqrt 3]], K = [1, sqrt 3] for Q = I, R = I
    (test_control.py:21), and the JAX package's answer."""
    from drake_tpu.control import lqr as jl
    from drake_tpu_torch.control import lqr as tl

    A = np.array([[0.0, 1.0], [0.0, 0.0]])
    B = np.array([[0.0], [1.0]])
    res = tl.lqr(t(A), t(B), t(np.eye(2)), t(np.eye(1)))
    s3 = np.sqrt(3.0)
    close(res.S, [[s3, 1.0], [1.0, s3]], 1e-7)
    close(res.K, [[1.0, s3]], 1e-7)
    ref = jl.lqr(A, B, np.eye(2), np.eye(1))
    scaled(res.S, ref.S, GAIN_TOL)
    scaled(res.K, ref.K, GAIN_TOL)


def test_lqr_with_cross_term_matches_jax():
    from drake_tpu.control import lqr as jl
    from drake_tpu_torch.control import lqr as tl

    A, B, Q, R = random_systems(3, B=1)
    N = 0.1 * np.random.default_rng(4).standard_normal((4, 2))
    ref = jl.lqr(A[0], B[0], Q[0], R[0], N)
    got = tl.lqr(t(A[0]), t(B[0]), t(Q[0]), t(R[0]), t(N))
    scaled(got.S, ref.S, GAIN_TOL)
    scaled(got.K, ref.K, GAIN_TOL)


def test_discrete_lqr_stabilizes():
    """test_control.py:31, with the JAX package's gains."""
    from drake_tpu.control import lqr as jl
    from drake_tpu_torch.control import lqr as tl

    rng = np.random.default_rng(0)
    A = rng.normal(size=(4, 4))
    B = rng.normal(size=(4, 2))
    ref = jl.discrete_lqr(A, B, np.eye(4), np.eye(2))
    got = tl.discrete_lqr(t(A), t(B), t(np.eye(4)), t(np.eye(2)))
    scaled(got.S, ref.S, GAIN_TOL)
    scaled(got.K, ref.K, GAIN_TOL)
    assert np.all(np.abs(np.linalg.eigvals(A - B @ got.K.numpy())) < 1.0)


def test_acrobot_balancing():
    """test_control.py:39: the upright LQR of the acrobot matches the JAX
    package's, and its closed loop from 0.05 off follows the reference's
    for 200 steps at 1e-3 (the whole 8 s to within 1e-4 of upright runs in
    the slow test of tests/test_torch_acrobot.py)."""
    import torch

    from drake_tpu.control import lqr as jl
    from drake_tpu.models import acrobot as ja
    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.control import lqr as tl
    from drake_tpu_torch.models import acrobot as ta
    from drake_tpu_torch.systems import simulator as tsim

    jp, tp, system = acrobot_pair()
    Q = np.diag([10.0, 10.0, 1.0, 1.0])
    R = np.eye(1)
    xu = np.asarray(ja.upright_state(F64))
    ref = jl.lqr_for_system(ja.make_system(jp), jp, xu, jnp.zeros(1), Q, R)
    res = tl.lqr_for_system(system, tp, ta.upright_state(torch.float64, "cpu"),
                            torch.zeros(1, dtype=torch.float64), t(Q), t(R))
    scaled(res.K, ref.K, GAIN_TOL)
    scaled(res.S, ref.S, GAIN_TOL)

    x_init = xu + np.array([0.05, -0.05, 0.0, 0.0])
    jxs, _, _ = run_jitted(lambda x: jsim.simulate_controlled(
        ja.make_system(jp), jp, x, lambda _, x_, tt: -ref.K @ (x_ - xu), 200, 1e-3), x_init)
    with torch.no_grad():
        xs, _, _ = tsim.simulate_controlled(system, tp, t(x_init)[None],
                                            lambda _, x_, tt: -((x_ - t(xu)) @ res.K.mT), 200,
                                            1e-3)
    scaled(xs[0], jxs, LOOP_TOL)


def test_quadrotor_hover_lqr():
    """test_control.py:54: the hover LQR of the quadrotor matches the JAX
    package's, and its closed loop from 0.5 m and 0.1 rad off follows the
    reference's for its first 100 steps at 1e-3 (the 6,000 that settle it
    cost the eager CPU loop too much for tier 1: the slow test of
    tests/test_torch_acrobot.py runs them)."""
    import torch

    from drake_tpu.control import lqr as jl
    from drake_tpu.models import quadrotor as jq
    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.control import lqr as tl
    from drake_tpu_torch.models import quadrotor as tq
    from drake_tpu_torch.systems import simulator as tsim

    jp = jq.default_params(F64)
    tp = port_params(tq, jp)
    Q = np.diag(np.concatenate([10 * np.ones(6), np.ones(6)]))
    R = 0.1 * np.eye(4)
    u0 = jq.hover_input(jp)
    ref = jl.lqr_for_system(jq.make_system(jp), jp, jnp.zeros(12), u0, Q, R)
    res = tl.lqr_for_system(tq.make_system(tp), tp, torch.zeros(12, dtype=torch.float64),
                            tq.hover_input(tp), t(Q), t(R))
    scaled(res.K, ref.K, GAIN_TOL)
    scaled(res.S, ref.S, GAIN_TOL)

    x_init = np.zeros(12)
    x_init[0], x_init[4] = 0.5, 0.1
    steps = 100
    jxs, _, _ = run_jitted(lambda x: jsim.simulate_controlled(
        jq.make_system(jp), jp, x, lambda _, x_, tt: u0 - ref.K @ x_, steps, 1e-3), x_init)
    with torch.no_grad():
        xs, _, _ = tsim.simulate_controlled(tq.make_system(tp), tp, t(x_init)[None],
                                            lambda _, x_, tt: tq.hover_input(tp) - x_ @ res.K.mT,
                                            steps, 1e-3)
    scaled(xs[0], jxs, LOOP_TOL)


# ---- finite-horizon LQR --------------------------------------------------------------

def double_integrator_pair():
    import torch

    from drake_tpu.systems.base import ContinuousSystem as JSystem
    from drake_tpu_torch.systems.base import ContinuousSystem as TSystem

    A = np.array([[0.0, 1.0], [0.0, 0.0]])
    B = np.array([[0.0], [1.0]])
    jsys = JSystem(f=lambda p, x, u, tt: jnp.asarray(A) @ x + jnp.asarray(B) @ u,
                   num_states=2, num_inputs=1)
    tA, tB = torch.tensor(A), torch.tensor(B)
    tsys = TSystem(f=lambda p, x, u, tt: x @ tA.mT + u @ tB.mT, num_states=2, num_inputs=1)
    return A, B, jsys, tsys


def test_converges_to_infinite_horizon():
    """test_control.py:70: S(t0) and K(t0) of a 20 s horizon (2,000 steps)
    are the CARE's within 1e-3, and every knot is the JAX package's."""
    from drake_tpu.control import lqr as jl
    from drake_tpu_torch.control import lqr as tl

    A, B, jsys, tsys = double_integrator_pair()
    Q, R = np.eye(2), np.eye(1)
    inf = tl.lqr(t(A), t(B), t(Q), t(R))
    ref = jl.finite_horizon_lqr(jsys, None, Q, R, t0=0.0, tf=20.0, num_steps=2000,
                                Qf=np.zeros((2, 2)))
    got = tl.finite_horizon_lqr(tsys, None, t(Q), t(R), t0=0.0, tf=20.0, num_steps=2000,
                                Qf=t(np.zeros((2, 2))))
    close(got.S[0], inf.S.numpy(), 1e-3)
    close(got.K[0], inf.K.numpy(), 1e-3)
    for name in ("ts", "S", "K", "k0", "sx", "x0", "u0"):
        scaled(getattr(got, name), getattr(ref, name), GAIN_TOL)


def pendulum_tvlqr_case():
    """The passive pendulum swing of test_control.py:91 and both packages'
    TV-LQR about it (Q = I, R = 0.1, Qf = 10 I, 200 steps of 1e-2), with a
    desired state off the nominal so that the affine terms act."""
    import torch

    from drake_tpu.control import lqr as jl
    from drake_tpu.models import pendulum as jpend
    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.control import lqr as tl
    from drake_tpu_torch.models import pendulum as tpend

    jp = jpend.default_params(F64)
    jsys = jpend.make_system(jp)
    tp = port_params(tpend, jp)
    tsys = tpend.make_system(tp)
    dt, n = 1e-2, 200
    x0 = np.array([1.2, 0.0])
    us = np.zeros((n, 1))
    xs_nom, _ = jsim.simulate(jsys, jp, x0, us, dt)
    u_nom = np.concatenate([us, us[-1:]], axis=0)
    Q, R, Qf = np.eye(2), 0.1 * np.eye(1), 10 * np.eye(2)
    xd = np.asarray(xs_nom) + 0.05
    kw = dict(t0=0.0, tf=n * dt, num_steps=n)
    ref = jl.finite_horizon_lqr(jsys, jp, Q, R, x0_traj=xs_nom, u0_traj=u_nom, Qf=Qf, xd_traj=xd,
                                **kw)
    got = tl.finite_horizon_lqr(tsys, tp, t(Q), t(R), x0_traj=t(xs_nom), u0_traj=t(u_nom),
                                Qf=t(Qf), xd_traj=t(xd), **kw)
    plain = tl.finite_horizon_lqr(tsys, tp, t(Q), t(R), x0_traj=t(xs_nom), u0_traj=t(u_nom),
                                  Qf=t(Qf), **kw)
    jplain = jl.finite_horizon_lqr(jsys, jp, Q, R, x0_traj=xs_nom, u0_traj=u_nom, Qf=Qf, **kw)
    return dict(jsys=jsys, jp=jp, tsys=tsys, tp=tp, dt=dt, n=n, x0=x0, us=us, xs_nom=xs_nom,
                ref=ref, got=got, plain=plain, jplain=jplain, torch=torch)


@pytest.fixture(scope="module")
def pendulum_tvlqr():
    return pendulum_tvlqr_case()


def test_finite_horizon_lqr_matches_jax(pendulum_tvlqr):
    c = pendulum_tvlqr
    for res, ref in ((c["got"], c["ref"]), (c["plain"], c["jplain"])):
        for name in ("ts", "S", "K", "k0", "sx", "x0", "u0"):
            scaled(getattr(res, name), getattr(ref, name), GAIN_TOL)
    assert float(np.abs(np.asarray(c["ref"].k0)).max()) > 1e-3  # the affine terms act


def test_finite_horizon_lqr_over_lanes():
    """Two nominal trajectories as lanes give each one's gains."""
    import torch

    from drake_tpu_torch.control import lqr as tl
    from drake_tpu_torch.models import pendulum as tpend

    tsys = tpend.make_system(tpend.default_params(torch.float64, "cpu"))
    Q, R = torch.eye(2, dtype=torch.float64), 0.1 * torch.eye(1, dtype=torch.float64)
    rng = np.random.default_rng(5)
    xs = t(rng.standard_normal((2, 21, 2)))
    us = t(rng.standard_normal((2, 21, 1)))
    kw = dict(t0=0.0, tf=0.4, num_steps=20, Qf=torch.eye(2, dtype=torch.float64))
    both = tl.finite_horizon_lqr(tsys, tsys.default_params, Q, R, x0_traj=xs, u0_traj=us, **kw)
    for lane in range(2):
        one = tl.finite_horizon_lqr(tsys, tsys.default_params, Q, R, x0_traj=xs[lane],
                                    u0_traj=us[lane], **kw)
        for name in ("S", "K", "k0"):
            close(getattr(both, name)[lane], getattr(one, name).numpy(), 1e-13)


def test_tvlqr_tracks_pendulum_trajectory(pendulum_tvlqr):
    """test_control.py:91: from 0.1 rad off, the TV-LQR closed loop ends
    within 0.02 of the nominal and below 0.3 of the open loop's error, and
    follows the reference's closed loop step for step.

    Every step of this loop starts on a grid point (dt 1e-2 both), where the
    knot turns on the last bit of (t - t0) / dt: the reference here runs
    as the JAX package runs it, at XLA's default optimization: its scan
    compiled at ``run_jitted``'s lowest level picks another knot at the
    tenth step, t = 0.09999999999999999, than the default and the port."""
    from drake_tpu.control import lqr as jl
    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.control import lqr as tl
    from drake_tpu_torch.systems import simulator as tsim

    c = pendulum_tvlqr
    torch = c["torch"]
    x_pert = c["x0"] + np.array([0.1, 0.0])
    jpolicy = jl.tvlqr_policy(c["jplain"])
    jxs, _, _ = jsim.simulate_controlled(c["jsys"], c["jp"], x_pert, jpolicy, c["n"], c["dt"])
    with torch.no_grad():
        xs, _, _ = tsim.simulate_controlled(c["tsys"], c["tp"], t(x_pert)[None],
                                            tl.tvlqr_policy(c["plain"]), c["n"], c["dt"])
        xs_ol, _ = tsim.simulate(c["tsys"], c["tp"], t(x_pert)[None], t(c["us"])[None], c["dt"])
    scaled(xs[0], jxs, LOOP_TOL)
    nominal_end = np.asarray(c["xs_nom"])[-1]
    err_cl = np.linalg.norm(xs[0, -1].numpy() - nominal_end)
    err_ol = np.linalg.norm(xs_ol[0, -1].numpy() - nominal_end)
    assert err_cl < 0.3 * err_ol and err_cl < 0.02


def test_tvlqr_knot_at_grid_points_matches_jax(pendulum_tvlqr):
    """The policy's knot index, (t - t0) / dt truncated with dt = ts[1] -
    ts[0], at every grid time, at the simulator's accumulated times and
    just off the grid: the same knot as the reference's (each knot's
    gains are distinct, so the action tells the knot)."""
    from drake_tpu.control import lqr as jl
    from drake_tpu_torch.control import lqr as tl

    c = pendulum_tvlqr
    torch = c["torch"]
    ts = np.asarray(c["ref"].ts)
    dt = c["dt"]
    accumulated = np.cumsum(np.full(c["n"], dt)) - dt
    times = np.concatenate([ts, accumulated, ts[1:-1] * (1 - 1e-15), ts[1:-1] * (1 + 1e-15),
                            [-0.5, 2.5, 3.0]])
    x = np.array([0.3, -0.2])
    jpolicy = jl.tvlqr_policy(c["ref"])
    tpolicy = tl.tvlqr_policy(c["got"])
    ref = np.stack([np.asarray(jpolicy(None, x, jnp.asarray(tt))) for tt in times])
    got = np.stack([tpolicy(None, t(x), torch.tensor(tt, dtype=torch.float64)).numpy()
                    for tt in times])
    # Equal knots give the same arithmetic on gains within GAIN_TOL; a knot
    # off by one gives a difference of the gains' step, far above it.
    steps = np.abs(np.diff(np.asarray(c["ref"].K)[:, 0, 0])).min()
    assert steps > 1e3 * GAIN_TOL
    close(got, ref, 10 * GAIN_TOL)
    # The grid step of the reference's linspace: torch.linspace's can differ
    # by an ulp.
    close(c["got"].ts, ts, 0.0)


# ---- estimators ------------------------------------------------------------------------

def acrobot_linearization():
    from drake_tpu.models import acrobot as ja

    jp, tp, system = acrobot_pair()
    A, B = ja.make_system(jp).linearize(jp, ja.upright_state(F64), jnp.zeros(1))
    C = np.concatenate([np.eye(2), np.zeros((2, 2))], axis=1)
    return np.asarray(A), np.asarray(B), C, jp, tp, system


@pytest.mark.parametrize("kind", ["steady_state_kalman_filter", "discrete_kalman_filter"])
def test_kalman_gains_match_jax(kind):
    from drake_tpu.control import estimators as jest
    from drake_tpu_torch.control import estimators as test_

    A, _, C, _, _, _ = acrobot_linearization()
    if kind == "discrete_kalman_filter":
        A = np.eye(4) + 1e-2 * A  # the 10 ms Euler map of the same plant
    W, V = np.eye(4), 0.1 * np.eye(2)
    ref = getattr(jest, kind)(A, C, W, V)
    got = getattr(test_, kind)(t(A), t(C), t(W), t(V))
    scaled(got.P, ref.P, GAIN_TOL)
    scaled(got.L, ref.L, GAIN_TOL)


def test_luenberger_update_matches_jax():
    from drake_tpu.control import estimators as jest
    from drake_tpu_torch.control import estimators as test_

    A, _, C, jp, tp, system = acrobot_linearization()
    from drake_tpu.models import acrobot as ja

    L = np.asarray(jest.steady_state_kalman_filter(A, C, np.eye(4), 0.1 * np.eye(2)).L)
    rng = np.random.default_rng(6)
    xhat = rng.standard_normal((4, 4))
    u = rng.standard_normal((4, 1))
    y = rng.standard_normal((4, 2))
    jup = jest.luenberger_observer(ja.make_system(jp), jp, L, C, 1e-3)
    tup = test_.luenberger_observer(system, tp, t(L), t(C), 1e-3)
    ref = jax.vmap(jup)(xhat, u, y)
    scaled(tup(t(xhat), t(u), t(y)), ref, TOL)


# ---- energy shaping (tests/test_energy_shaping.py) --------------------------------------

def test_wrap_to_takes_the_divisor_sign():
    """math::wrap_to of negative angles, as ``jnp.mod`` (within [lo, hi],
    hi itself where x - lo is a tiny negative, in both packages)."""
    import torch

    from drake_tpu.control import energy_shaping as jes
    from drake_tpu_torch.control import energy_shaping as tes

    x = np.array([-7.5, -2 * np.pi, -np.pi, -1e-17, -0.1, 0.0, 3.0, 2 * np.pi, 9.9])
    for lo, hi in ((0.0, 2 * np.pi), (-np.pi, np.pi)):
        got = tes._wrap_to(torch.tensor(x), lo, hi)
        close(got, jes._wrap_to(jnp.asarray(x), lo, hi), 0.0)
        assert bool(((got >= lo) & (got <= hi)).all())


def test_pendulum_energy_shaping_matches_jax():
    """test_energy_shaping.py:27: the policy at seeded states, and 400
    steps of its closed loop at dt 0.005 from [0.1, 0]."""
    import torch

    from drake_tpu.control import energy_shaping as jes
    from drake_tpu.models import pendulum as jpend
    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.control import energy_shaping as tes
    from drake_tpu_torch.models import pendulum as tpend
    from drake_tpu_torch.systems import simulator as tsim

    jp = jpend.default_params(F64)
    tp = port_params(tpend, jp)
    jpol, tpol = jes.pendulum_energy_shaping(jp), tes.pendulum_energy_shaping(tp)
    x = np.random.default_rng(7).uniform(-3.0, 3.0, (6, 2))
    scaled(tpol(t(x)), jax.vmap(jpol)(x), TOL)
    x0 = np.array([0.1, 0.0])
    jxs, _, _ = run_jitted(lambda a: jsim.simulate_controlled(
        jpend.make_system(jp), jp, a, lambda ps, xx, tt: jpol(xx, tt), 400, 0.005), x0)
    with torch.no_grad():
        xs, _, _ = tsim.simulate_controlled(tpend.make_system(tp), tp, t(x0)[None],
                                            lambda ps, xx, tt: tpol(xx, tt), 400, 0.005)
    scaled(xs[0], jxs, LOOP_TOL)


def spong_states():
    """Seeded states over several turns, the two of
    test_energy_shaping.py:61 (one inside the LQR basin) and one at a
    negative theta1."""
    rng = np.random.default_rng(8)
    x = np.concatenate([rng.uniform(-8.0, 8.0, (10, 2)), rng.uniform(-3.0, 3.0, (10, 2))], axis=1)
    extra = np.array([[0.1, 0.0, 0.0, 0.0], [np.pi - 0.01, 0.005, 0.0, 0.0],
                      [-np.pi - 0.01, 2 * np.pi + 0.005, 0.0, 0.0]])
    return np.concatenate([x, extra])


def test_spong_controller_matches_jax_and_is_batchable():
    """test_energy_shaping.py:61: one call over a batch of states, with the
    reference's actions; the state inside the basin gets the balancing law
    far below saturation, and one a full turn away the same action.  Within
    GAIN_TOL: the controller's LQR gains are the CARE's, and its unclipped
    torques reach thousands of N m at these states."""
    from drake_tpu.control import energy_shaping as jes
    from drake_tpu_torch.control import energy_shaping as tes

    jp, tp, _ = acrobot_pair()
    x = spong_states()
    ref = jax.vmap(jes.acrobot_spong_controller(jp))(x)
    got = tes.acrobot_spong_controller(tp)(t(x))
    assert got.shape == (x.shape[0], 1)
    scaled(got, ref, GAIN_TOL)
    assert abs(float(got[-2, 0])) < 5.0
    close(got[-1], got[-2].numpy(), 1e-9)
    assert float(got.abs().max()) <= 20.0


def test_spong_controller_gains_per_lane():
    """Gains as tensors over the lanes, as the CEM of
    ``examples/acrobot_spong_optimize.py`` passes them, equal the controller
    built with each lane's gains."""
    import torch

    from drake_tpu_torch.control import energy_shaping as tes

    _, tp, _ = acrobot_pair()
    x = t(spong_states()[:4])
    gains = torch.tensor([[5.0, 50.0, 5.0], [3.0, 40.0, 6.0], [7.0, 60.0, 4.0],
                          [5.5, 45.0, 5.5]], dtype=torch.float64)
    both = tes.acrobot_spong_controller(tp, k_e=gains[:, 0], k_p=gains[:, 1], k_d=gains[:, 2])(x)
    for lane in range(4):
        one = tes.acrobot_spong_controller(tp, *gains[lane].tolist())(x[lane])
        close(both[lane], one.numpy(), 0.0)


def test_acrobot_spong_closed_loop_matches_jax():
    """test_energy_shaping.py:44's swing-up from [0.1, 0, 0, 0] at dt 0.002
    for its first 300 steps (its 12,000 run in the slow test of
    tests/test_torch_acrobot.py), step for step with the reference."""
    import torch

    from drake_tpu.control import energy_shaping as jes
    from drake_tpu.models import acrobot as ja
    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.control import energy_shaping as tes
    from drake_tpu_torch.systems import simulator as tsim

    jp, tp, system = acrobot_pair()
    jpol, tpol = jes.acrobot_spong_controller(jp), tes.acrobot_spong_controller(tp)
    x0 = np.array([0.1, 0.0, 0.0, 0.0])
    jxs, jus, _ = run_jitted(lambda a: jsim.simulate_controlled(
        ja.make_system(jp), jp, a, lambda ps, xx, tt: jpol(xx, tt), 300, 0.002), x0)
    with torch.no_grad():
        xs, us, _ = tsim.simulate_controlled(system, tp, t(x0)[None],
                                             lambda ps, xx, tt: tpol(xx, tt), 300, 0.002)
    scaled(xs[0], jxs, LOOP_TOL)
    scaled(us[0], jus, LOOP_TOL)


# ---- the QP solvers at m = 0 (ROADMAP Queue 3 item 1) -------------------------------------

def box_qps(lanes=3):
    """`lanes` 4-variable QPs with no equality row (G of shape (0, 4)) and
    the box [-1, 1]^4, their minimizers outside it in some coordinates."""
    rng = np.random.default_rng(9)
    A = rng.standard_normal((lanes, 4, 4))
    P = A @ A.transpose(0, 2, 1) / 4 + 0.1 * np.eye(4)
    q = 3.0 * rng.standard_normal((lanes, 4))
    return (P, q, np.zeros((lanes, 0, 4)), np.zeros((lanes, 0)), -np.ones((lanes, 4)),
            np.ones((lanes, 4)))


@pytest.mark.parametrize("equilibrate", [0, 2])
def test_ipm_without_equality_rows_matches_jax(equilibrate):
    """The port's IPM solved no problem with m = 0 (``torch.amax`` of an
    empty axis raises); it now takes the reference's iterations to the
    reference's answer, for one lane and over a batch.  Tolerance: 1e-8 of
    scale on w, as tests/test_torch_dircol.py holds the IPM."""
    from drake_tpu.solvers import ipm as jipm
    from drake_tpu_torch.solvers import ipm as tipm

    data = box_qps()
    opts = dict(equilibrate=equilibrate)
    ref = jax.vmap(lambda *a: jipm.solve_qp_ipm(*a, jipm.IpmOptions(**opts)))(*data)
    for lanes in (slice(0, 1), slice(None)):
        got = tipm.solve_qp_ipm(*(t(a[lanes]) for a in data), tipm.IpmOptions(**opts))
        scaled(got.w, np.asarray(ref.w)[lanes], 1e-8)
        assert got.y.shape == (got.w.shape[0], 0)
        np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations)[lanes])
        assert bool(got.converged.all())


def test_sqp_without_constraints_matches_jax():
    """min |z - 2|^2 on [-1, 1]^3 with an empty c, from the same starts in
    both packages (lane 0 the zeros): the port's z, cost, violation,
    iterations and success agree with the reference's lane by lane, for one
    lane and for three.  Tolerance: 1e-10 of scale on z and the cost (the
    IPM's subproblem in another order), exact on the iteration counts.  The
    reference's answer is z = 1 in 2 iterations, and so is the port's."""
    import torch

    from drake_tpu.solvers import sqp as jsqp
    from drake_tpu_torch.solvers import sqp as tsqp

    z0 = np.linspace(-0.5, 0.5, 9).reshape(3, 3)
    z0[0] = 0.0
    lb, ub = -np.ones(3), np.ones(3)
    ref = jax.vmap(lambda z: jsqp.solve(lambda v: jnp.sum((v - 2.0) ** 2),
                                        lambda v: jnp.zeros((0,), v.dtype),
                                        z, jnp.asarray(lb), jnp.asarray(ub)))(jnp.asarray(z0))
    ref = jax.tree_util.tree_map(np.asarray, ref)
    assert ref.lam.shape == (3, 0)
    for lanes in (slice(0, 1), slice(None)):
        got = tsqp.solve(lambda z: torch.sum((z - 2.0) ** 2), lambda z: z[:0],
                         t(z0[lanes]), t(lb), t(ub))
        scaled(got.z, ref.z[lanes], 1e-10)
        scaled(got.cost, ref.cost[lanes], 1e-10)
        assert got.lam.shape == ref.lam[lanes].shape
        close(got.constraint_violation, ref.constraint_violation[lanes], 0.0)
        np.testing.assert_array_equal(got.iterations.numpy(), ref.iterations[lanes])
        np.testing.assert_array_equal(got.success.numpy(), ref.success[lanes])
        close(got.z, np.ones_like(z0[lanes]), 1e-8)
        assert got.iterations.tolist() == [2] * got.z.shape[0] and bool(got.success.all())
