"""Trajectory types: piecewise polynomials, B-splines, Bezier curves, slerp.

The PyTorch counterpart of ``drake_tpu/math/trajectories.py`` (Drake's
common/trajectories: PiecewisePolynomial's ZeroOrderHold, FirstOrderHold,
CubicHermite and CubicWithContinuousSecondDerivatives, BsplineTrajectory,
BezierCurve, PiecewiseQuaternion and PiecewisePose).  The trajectories are
frozen tensor dataclasses; ``value`` and ``derivative_value`` take a scalar
time or a tensor of times (...), and answer (..., dim) -- the reference's
``vmap`` over query times.  A query exactly at a break takes the segment
that starts there, as the reference's ``searchsorted(side="right") - 1``.

The constructors take tensors (the trajectory follows them) or host arrays,
which go to the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import math

import torch

from drake_tpu_torch.math import rotations as rot
from drake_tpu_torch.math.transforms import RigidTransform
from drake_tpu_torch.utils.device import tensors_on
from drake_tpu_torch.utils.struct import static_field, tensor_dataclass


def linspace(t0, tf, num: int, like: torch.Tensor):
    """``jnp.linspace(t0, tf, num)`` in `like`'s dtype as XLA computes it on
    the CPU: t0 (1 - i r) + (tf r) i with r = 1/(num - 1), every factor
    rounded to the dtype, and tf itself last.  ``torch.linspace`` rounds
    another way; a query grid off by an ulp lands on other knots."""
    dtype, dev = like.dtype, like.device
    if num == 1:
        return torch.full((1,), t0, dtype=dtype, device=dev)
    i = torch.arange(num - 1, dtype=dtype, device=dev)
    a = torch.tensor(t0, dtype=dtype, device=dev)
    b = torch.tensor(tf, dtype=dtype, device=dev)
    r = torch.tensor(1.0 / (num - 1), dtype=dtype, device=dev)
    return torch.cat([a * (1 - i * r) + (b * r) * i, b[None]])


def _time(t, like):
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def _segment(breaks, t):
    """The segment of each time: ``searchsorted(side="right") - 1``, clipped
    to the segments."""
    idx = torch.searchsorted(breaks, t.contiguous(), right=True) - 1
    return idx.clamp(0, breaks.shape[0] - 2)


def _clip(t, lo, hi):
    return torch.minimum(torch.maximum(t, lo), hi)


@tensor_dataclass
class PiecewisePolynomial:
    """Piecewise cubic y(t) = sum_k c[i, k] (t - t_i)^k on segment i.

    coeffs: (num_segments, 4, dim), constant to cubic; breaks:
    (num_segments + 1,)."""

    breaks: torch.Tensor
    coeffs: torch.Tensor

    @property
    def start_time(self):
        return self.breaks[0]

    @property
    def end_time(self):
        return self.breaks[-1]

    def _local(self, t):
        t = _clip(_time(t, self.breaks), self.start_time, self.end_time)
        i = _segment(self.breaks, t)
        return t - self.breaks[i], self.coeffs[i]

    def value(self, t):
        """y at t, a scalar or a tensor of times (...): (..., dim)."""
        tau, c = self._local(t)
        tau = tau[..., None]
        return ((c[..., 3, :] * tau + c[..., 2, :]) * tau + c[..., 1, :]) * tau + c[..., 0, :]

    def derivative_value(self, t, order: int = 1):
        tau, c = self._local(t)
        tau = tau[..., None]
        if order == 1:
            return (3 * c[..., 3, :] * tau + 2 * c[..., 2, :]) * tau + c[..., 1, :]
        if order == 2:
            return 6 * c[..., 3, :] * tau + 2 * c[..., 2, :]
        raise ValueError("order must be 1 or 2")

    def vector_values(self, ts):
        return self.value(ts)

    def derivative(self) -> "PiecewisePolynomial":
        """The derivative as a trajectory (Trajectory::MakeDerivative)."""
        c = self.coeffs
        dc = torch.stack([c[:, 1], 2.0 * c[:, 2], 3.0 * c[:, 3], torch.zeros_like(c[:, 0])], dim=1)
        return PiecewisePolynomial(breaks=self.breaks, coeffs=dc)

    # ---- constructors (the reference's names) -----------------------------
    @staticmethod
    def zero_order_hold(breaks, samples, device=None):
        """Piecewise constant; samples (n, dim) held on [t_i, t_{i+1})."""
        breaks, samples = tensors_on((breaks, samples), device)
        coeffs = samples.new_zeros((breaks.shape[0] - 1, 4, samples.shape[1]))
        coeffs[:, 0] = samples[:-1]
        return PiecewisePolynomial(breaks=breaks, coeffs=coeffs)

    @staticmethod
    def first_order_hold(breaks, samples, device=None):
        """Piecewise-linear interpolation."""
        breaks, samples = tensors_on((breaks, samples), device)
        dt = torch.diff(breaks)[:, None]
        coeffs = samples.new_zeros((breaks.shape[0] - 1, 4, samples.shape[1]))
        coeffs[:, 0] = samples[:-1]
        coeffs[:, 1] = (samples[1:] - samples[:-1]) / dt
        return PiecewisePolynomial(breaks=breaks, coeffs=coeffs)

    @staticmethod
    def cubic_hermite(breaks, samples, derivatives, device=None):
        """Cubic with the given sample derivatives (CubicHermite)."""
        breaks, y, yd = tensors_on((breaks, samples, derivatives), device)
        h = torch.diff(breaks)[:, None]
        y0, y1 = y[:-1], y[1:]
        d0, d1 = yd[:-1], yd[1:]
        c2 = (3 * (y1 - y0) / h - 2 * d0 - d1) / h
        c3 = (2 * (y0 - y1) / h + d0 + d1) / (h * h)
        return PiecewisePolynomial(breaks=breaks, coeffs=torch.stack([y0, d0, c2, c3], dim=1))

    @staticmethod
    def cubic_with_continuous_second_derivatives(breaks, samples, periodic: bool = False,
                                                 device=None):
        """Natural cubic spline (C2), the reference's default cubic: the
        second derivatives at the breaks from one dense n x n solve."""
        breaks, y = tensors_on((breaks, samples), device)
        n = breaks.shape[0]
        h = torch.diff(breaks)
        A = y.new_zeros((n, n))
        rhs = y.new_zeros((n, y.shape[1]))
        A[0, 0] = 1.0
        A[n - 1, n - 1] = 1.0
        if n > 2:
            i = torch.arange(1, n - 1, device=y.device)
            A[i, i - 1] = h[:-1]
            A[i, i] = 2 * (h[:-1] + h[1:])
            A[i, i + 1] = h[1:]
            rhs[1:-1] = 6 * ((y[2:] - y[1:-1]) / h[1:, None] - (y[1:-1] - y[:-2]) / h[:-1, None])
        M = torch.linalg.solve(A, rhs)
        hcol = h[:, None]
        c1 = (y[1:] - y[:-1]) / hcol - hcol * (2 * M[:-1] + M[1:]) / 6
        c3 = (M[1:] - M[:-1]) / (6 * hcol)
        coeffs = torch.stack([y[:-1], c1, M[:-1] / 2, c3], dim=1)
        return PiecewisePolynomial(breaks=breaks, coeffs=coeffs)


@tensor_dataclass
class BsplineTrajectory:
    """Clamped B-spline of order k (degree k - 1), the
    KinematicTrajectoryOptimization representation."""

    knots: torch.Tensor  # (m,) full clamped knot vector
    control_points: torch.Tensor  # (n, dim)
    order: int = static_field(default=4)

    def value(self, t):
        """De Boor's algorithm at t, a scalar or a tensor of times (...)."""
        k = self.order
        knots = self.knots
        t = _time(t, knots)
        t = _clip(t, knots[k - 1], knots[-k] - 1e-9)
        span = (torch.searchsorted(knots, t.contiguous(), right=True) - 1).clamp(
            k - 1, self.control_points.shape[0] - 1)
        d = [self.control_points[span - k + 1 + j] for j in range(k)]
        for r in range(1, k):
            for j in range(k - 1, r - 1, -1):
                i = span - k + 1 + j
                denom = knots[i + k - r] - knots[i]
                alpha = torch.where(denom > 0, (t - knots[i]) / torch.clamp_min(denom, 1e-12),
                                    torch.zeros_like(t))[..., None]
                d[j] = (1 - alpha) * d[j - 1] + alpha * d[j]
        return d[k - 1]

    def start_time(self):
        return self.knots[0]

    def end_time(self):
        return self.knots[-1]

    def derivative(self) -> "BsplineTrajectory":
        """The exact derivative spline: order k - 1 with control points
        (k - 1) (P_{i+1} - P_i) / (t_{i+k} - t_{i+1}) over knots[1:-1]."""
        k = self.order
        P = self.control_points
        t = self.knots
        denom = t[k : k + P.shape[0] - 1] - t[1 : P.shape[0]]
        d = (k - 1) * (P[1:] - P[:-1]) / torch.clamp_min(denom, 1e-12)[:, None]
        return BsplineTrajectory(knots=self.knots[1:-1], control_points=d, order=k - 1)

    def derivative_value(self, t, order: int = 1):
        traj = self
        for _ in range(order):
            traj = traj.derivative()
        return traj.value(t)

    @staticmethod
    def make_clamped_uniform(control_points, order: int = 4, t0=0.0, tf=1.0, device=None):
        (control_points,) = tensors_on((control_points,), device)
        n = control_points.shape[0]
        k = order
        interior = linspace(t0, tf, n - k + 2, control_points)[1:-1]
        knots = torch.cat([torch.full((k,), t0, dtype=interior.dtype, device=interior.device),
                           interior,
                           torch.full((k,), tf, dtype=interior.dtype, device=interior.device)])
        return BsplineTrajectory(knots=knots, control_points=control_points, order=order)


@tensor_dataclass
class BezierCurve:
    """Bezier curve of any order on [start_time, end_time]; value by the
    Bernstein weights (log-space binomials), derivative as the order n - 1
    curve with control points n (P_{i+1} - P_i) / (tf - t0).

    control_points: (order + 1, dim)."""

    breaks: torch.Tensor  # (2,) = [t0, tf]
    control_points: torch.Tensor

    @property
    def start_time(self):
        return self.breaks[0]

    @property
    def end_time(self):
        return self.breaks[1]

    @property
    def order(self) -> int:
        return self.control_points.shape[0] - 1

    def _bernstein(self, s):
        n = self.order
        k = torch.arange(n + 1, dtype=s.dtype, device=s.device)
        log_binom = (math.lgamma(n + 1.0) - torch.lgamma(k + 1.0) - torch.lgamma(n - k + 1.0))
        s = _clip(s, s.new_zeros(()), s.new_ones(()))[..., None]
        log_s = torch.log(torch.clamp_min(s, 1e-30))
        log_1ms = torch.log(torch.clamp_min(1.0 - s, 1e-30))
        w = torch.exp(log_binom + k * log_s + (n - k) * log_1ms)
        w = torch.where(s <= 0.0, (k == 0).to(w.dtype), w)
        return torch.where(s >= 1.0, (k == n).to(w.dtype), w)

    def value(self, t):
        s = (_time(t, self.breaks) - self.start_time) / (self.end_time - self.start_time)
        return self._bernstein(s) @ self.control_points

    def derivative(self) -> "BezierCurve":
        n = self.order
        dp = n * (self.control_points[1:] - self.control_points[:-1]) / (
            self.end_time - self.start_time)
        return BezierCurve(breaks=self.breaks, control_points=dp)

    def derivative_value(self, t, order: int = 1):
        c = self
        for _ in range(order):
            c = c.derivative()
        return c.value(t)

    def vector_values(self, ts):
        return self.value(ts)


@tensor_dataclass
class PiecewiseQuaternionSlerp:
    """Piecewise spherical-linear orientation: slerp between knot
    quaternions (wxyz, sign-aligned at construction so that every segment
    takes the short way), the angular velocity constant on a segment."""

    breaks: torch.Tensor  # (n,)
    quats: torch.Tensor  # (n, 4)

    @staticmethod
    def make(breaks, quats, device=None):
        breaks, quats = tensors_on((breaks, quats), device)
        quats = rot.quat_normalize(quats)
        aligned = [quats[0]]
        for q in quats[1:]:  # sequential: q_{i+1} <- -q_{i+1} if it points away
            aligned.append(torch.where(torch.dot(aligned[-1], q) < 0.0, -q, q))
        return PiecewiseQuaternionSlerp(breaks=breaks, quats=torch.stack(aligned))

    @property
    def start_time(self):
        return self.breaks[0]

    @property
    def end_time(self):
        return self.breaks[-1]

    def _segment_log(self, i):
        """axis * angle of q_i^-1 q_{i+1} (the body-frame relative rotation)."""
        dq = rot.quat_multiply(rot.quat_conjugate(self.quats[i]), self.quats[i + 1])
        w = torch.clamp(dq[..., 0], -1.0, 1.0)
        v = dq[..., 1:]
        vn = torch.linalg.vector_norm(v, dim=-1)
        angle = 2.0 * torch.atan2(vn, w)
        return v / torch.clamp_min(vn, 1e-12)[..., None] * angle[..., None]

    def _local(self, t):
        t = _clip(_time(t, self.breaks), self.start_time, self.end_time)
        i = _segment(self.breaks, t)
        return t, i, torch.clamp_min(self.breaks[i + 1] - self.breaks[i], 1e-12)

    def orientation(self, t):
        """The quaternion (wxyz) at t: (..., 4)."""
        t, i, span = self._local(t)
        aa = self._segment_log(i) * ((t - self.breaks[i]) / span)[..., None]
        angle = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
        axis = aa / torch.clamp_min(angle, 1e-12)
        dq = torch.cat([torch.cos(angle / 2), torch.sin(angle / 2) * axis], dim=-1)
        return rot.quat_multiply(self.quats[i], dq)

    def value(self, t):
        return self.orientation(t)

    def angular_velocity(self, t):
        """The world-frame angular velocity (piecewise constant)."""
        _, i, span = self._local(t)
        return rot.quat_rotate(self.quats[i], self._segment_log(i) / span[..., None])


@tensor_dataclass
class PiecewisePose:
    """Piecewise SE(3): a natural cubic in position and slerp in orientation
    (PiecewisePose's MakeCubicLinearWithEndLinearVelocity role)."""

    position: PiecewisePolynomial
    orientation: PiecewiseQuaternionSlerp

    @staticmethod
    def make(breaks, positions, quats, device=None):
        breaks, positions, quats = tensors_on((breaks, positions, quats), device)
        return PiecewisePose(
            position=PiecewisePolynomial.cubic_with_continuous_second_derivatives(
                breaks, positions),
            orientation=PiecewiseQuaternionSlerp.make(breaks, quats),
        )

    @property
    def start_time(self):
        return self.position.start_time

    @property
    def end_time(self):
        return self.position.end_time

    def value(self, t):
        """The RigidTransform at t."""
        q = self.orientation.orientation(t)
        return RigidTransform(R=rot.quat_to_rotation(q), p=self.position.value(t))

    def velocity(self, t):
        """The spatial velocity [w; v] in the world frame: (..., 6)."""
        return torch.cat([self.orientation.angular_velocity(t),
                          self.position.derivative_value(t)], dim=-1)
