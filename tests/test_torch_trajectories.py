"""Parity of drake_tpu_torch's trajectories (math/trajectories.py) against
drake_tpu's, on the CPU in float64.

Every trajectory is built from the same numpy inputs, drawn from a seed, by
both packages' constructors, and carried across from the JAX object by
``multibody.convert.trajectory_from_numpy``; the port's is evaluated on a
tensor of times at once, the JAX one under ``vmap``.  The query times
include every break exactly (the segment that starts there), times past
both ends (clipped) and times drawn at random.

Tolerance: 1e-10 of the largest magnitude of the answer (and of 1), far
above float64 rounding of the same arithmetic in another order; the
natural spline's dense solve is LAPACK's in both packages.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

TOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, ref, tol=TOL):
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.max(np.abs(ref)))) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=tol * scale)


def t(a):
    import torch

    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def fields(obj):
    """The JAX trajectory's fields as numpy arrays (nested for a field that
    holds a trajectory)."""
    out = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        out[f.name] = fields(value) if dataclasses.is_dataclass(value) else np.asarray(value)
    return out


def carried(obj):
    from drake_tpu_torch.multibody import convert

    return convert.trajectory_from_numpy(type(obj).__name__, fields(obj), device="cpu")


def breaks_and_samples(seed, n=7, dim=3):
    rng = np.random.default_rng(seed)
    breaks = np.cumsum(np.concatenate([[0.3], rng.uniform(0.2, 1.0, n - 1)]))
    return breaks, rng.standard_normal((n, dim)), rng.standard_normal((n, dim))


def query_times(breaks, seed=99, n=23):
    rng = np.random.default_rng(seed)
    lo, hi = breaks[0], breaks[-1]
    return np.concatenate([breaks, [lo - 0.7, hi + 0.4], rng.uniform(lo, hi, n)])


CONSTRUCTORS = ["zero_order_hold", "first_order_hold", "cubic_hermite",
                "cubic_with_continuous_second_derivatives"]


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_piecewise_polynomial_matches_jax(name):
    """Each constructor's coefficients, values and first and second
    derivatives, at every break, past the ends and at random times."""
    from drake_tpu.math.trajectories import PiecewisePolynomial as JPP
    from drake_tpu_torch.math.trajectories import PiecewisePolynomial as TPP

    breaks, y, yd = breaks_and_samples(CONSTRUCTORS.index(name))
    args = (breaks, y, yd) if name == "cubic_hermite" else (breaks, y)
    jpp = getattr(JPP, name)(*map(jnp.asarray, args))
    tpp = getattr(TPP, name)(*args, device="cpu")
    close(tpp.coeffs, jpp.coeffs)
    ts = query_times(breaks)
    close(tpp.value(t(ts)), jax.vmap(jpp.value)(ts))
    close(tpp.vector_values(t(ts)), jpp.vector_values(ts))
    for order in (1, 2):
        close(tpp.derivative_value(t(ts), order),
              jax.vmap(lambda s: jpp.derivative_value(s, order))(ts))
    close(tpp.derivative().value(t(ts)), jax.vmap(jpp.derivative().value)(ts))
    # A scalar time, and the JAX object carried across.
    close(tpp.value(float(ts[-1])), jpp.value(ts[-1]))
    close(carried(jpp).value(t(ts)), jax.vmap(jpp.value)(ts))


def test_query_at_a_break_takes_the_next_segment():
    """At a break the zero-order hold takes the sample that starts there,
    as the reference's searchsorted(side="right") - 1."""
    from drake_tpu.math.trajectories import PiecewisePolynomial as JPP
    from drake_tpu_torch.math.trajectories import PiecewisePolynomial as TPP

    breaks = np.array([0.0, 0.1, 0.2, 0.30000000000000004, 0.4])
    y = np.arange(5.0)[:, None]
    ref = jax.vmap(JPP.zero_order_hold(jnp.asarray(breaks), jnp.asarray(y)).value)(breaks)
    got = TPP.zero_order_hold(breaks, y, device="cpu").value(t(breaks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy()[:, 0], [0.0, 1.0, 2.0, 3.0, 3.0])


@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_bspline_matches_jax(order):
    from drake_tpu.math.trajectories import BsplineTrajectory as JB
    from drake_tpu_torch.math.trajectories import BsplineTrajectory as TB

    cps = np.random.default_rng(10 + order).standard_normal((8, 2))
    jb = JB.make_clamped_uniform(jnp.asarray(cps), order=order, t0=0.5, tf=2.0)
    tb = TB.make_clamped_uniform(cps, order=order, t0=0.5, tf=2.0, device="cpu")
    close(tb.knots, jb.knots)
    ts = query_times(np.asarray(jb.knots)[order - 1 : -order + 1])
    close(tb.value(t(ts)), jax.vmap(jb.value)(ts))
    close(tb.derivative_value(t(ts)), jax.vmap(jb.derivative_value)(ts))
    if order > 2:
        close(tb.derivative_value(t(ts), 2),
              jax.vmap(lambda s: jb.derivative_value(s, 2))(ts))
    close(carried(jb).value(t(ts)), jax.vmap(jb.value)(ts))


@pytest.mark.parametrize("degree", [1, 3, 6])
def test_bezier_matches_jax(degree):
    from drake_tpu.math.trajectories import BezierCurve as JBz
    from drake_tpu_torch.math.trajectories import BezierCurve as TBz

    pts = np.random.default_rng(20 + degree).standard_normal((degree + 1, 2))
    jc = JBz(breaks=jnp.asarray([1.0, 3.0]), control_points=jnp.asarray(pts))
    tc = carried(jc)
    ts = query_times(np.array([1.0, 3.0]))
    close(tc.value(t(ts)), jax.vmap(jc.value)(ts))
    close(tc.derivative_value(t(ts)), jax.vmap(jc.derivative_value)(ts))
    close(tc.vector_values(t(ts)), jc.vector_values(ts))


def seeded_quats(seed, n=5):
    q = np.random.default_rng(seed).standard_normal((n, 4))
    q[2] *= -1.0  # a knot that points away from its neighbour
    return q


def test_quaternion_slerp_matches_jax():
    from drake_tpu.math.trajectories import PiecewiseQuaternionSlerp as JS
    from drake_tpu_torch.math.trajectories import PiecewiseQuaternionSlerp as TS

    breaks = np.array([0.0, 0.4, 1.1, 1.5, 2.6])
    quats = seeded_quats(30)
    js = JS.make(jnp.asarray(breaks), jnp.asarray(quats))
    ts_ = TS.make(breaks, quats, device="cpu")
    close(ts_.quats, js.quats)
    ts = query_times(breaks)
    close(ts_.orientation(t(ts)), jax.vmap(js.orientation)(ts))
    close(ts_.value(t(ts)), jax.vmap(js.value)(ts))
    close(ts_.angular_velocity(t(ts)), jax.vmap(js.angular_velocity)(ts))
    close(carried(js).orientation(t(ts)), jax.vmap(js.orientation)(ts))


def test_piecewise_pose_matches_jax():
    from drake_tpu.math.trajectories import PiecewisePose as JP
    from drake_tpu_torch.math.trajectories import PiecewisePose as TP

    breaks = np.array([0.0, 1.0, 2.0, 3.5])
    positions = np.random.default_rng(40).standard_normal((4, 3))
    quats = seeded_quats(41, 4)
    jp = JP.make(jnp.asarray(breaks), jnp.asarray(positions), jnp.asarray(quats))
    tp = TP.make(breaks, positions, quats, device="cpu")
    ts = query_times(breaks)
    jX = jax.vmap(jp.value)(ts)
    for traj in (tp, carried(jp)):
        X = traj.value(t(ts))
        close(X.R, jX.R)
        close(X.p, jX.p)
        close(traj.velocity(t(ts)), jax.vmap(jp.velocity)(ts))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("t0, tf, num", [(0.0, 15000 * 1e-4, 6001), (0.5, 2.0, 7), (0.0, 1.0, 2)])
def test_linspace_is_xla_bit_for_bit(dtype, t0, tf, num):
    """The port's query grid is jnp.linspace's to the bit (on the CPU), in
    float32 as in float64: the bouncing ball's 6,001 queries land on the
    same knots."""
    import torch

    from drake_tpu_torch.math.trajectories import linspace

    like = torch.zeros((), dtype=getattr(torch, dtype))
    got = linspace(t0, tf, num, like).numpy()
    ref = np.asarray(jnp.linspace(t0, tf, num, dtype=getattr(jnp, dtype)))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_trajectory_round_trip_and_device():
    """trajectory_to_numpy inverts trajectory_from_numpy; the constructors
    place host arrays on the card unless asked for the CPU."""
    import torch

    from drake_tpu_torch.math.trajectories import PiecewisePolynomial
    from drake_tpu_torch.multibody import convert

    breaks, y, _ = breaks_and_samples(50)
    pp = PiecewisePolynomial.first_order_hold(breaks, y, device="cpu")
    back = convert.trajectory_from_numpy("PiecewisePolynomial", convert.trajectory_to_numpy(pp),
                                         device="cpu")
    assert torch.equal(back.coeffs, pp.coeffs) and torch.equal(back.breaks, pp.breaks)
    # Tensors in, tensors where they were.
    pp2 = PiecewisePolynomial.first_order_hold(t(breaks), t(y))
    assert pp2.coeffs.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PiecewisePolynomial.first_order_hold(breaks, y)
