"""System primitives: LTI blocks, sources, holds, MLP, wiring blocks.

The PyTorch counterpart of ``drake_tpu/systems/primitives.py`` (Drake's
systems/primitives: LinearSystem, AffineSystem, TrajectorySource,
ZeroOrderHold, MultilayerPerceptron, RandomSource, Adder, Gain, Saturation,
PassThrough, Multiplexer, Demultiplexer, PortSwitch, WrapToSystem,
DiscreteDerivative, StateInterpolatorWithDiscreteDerivative).  The systems
map the lanes of a batch in the leading dimensions of ``x`` and ``u``.

What differs from the reference, by design:

- ``mlp_init`` and ``random_source`` draw from a ``torch.Generator`` in
  place of a JAX key (other streams; the tests feed JAX's draws to
  ``mlp_apply``).
- The builders take tensors (the system follows them) or host arrays,
  which go to the card unless ``device="cpu"`` is passed.
- ``symbolic_vector_system`` waits for ``math/symbolic`` (ROADMAP.md item
  22) and raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from drake_tpu_torch.systems.base import ContinuousSystem, DiscreteSystem
from drake_tpu_torch.utils.device import resolve_device, tensors_on


def _mv(M, x):
    return (M @ x.unsqueeze(-1)).squeeze(-1)


def _like(M, A):
    """M (a tensor or an array) as a tensor of A's dtype on A's device."""
    return torch.as_tensor(M if isinstance(M, torch.Tensor) else np.asarray(M)).to(A)


def _output_matrices(A, n, m, C, D):
    C_ = torch.eye(n, dtype=A.dtype, device=A.device) if C is None else _like(C, A)
    D_ = A.new_zeros((C_.shape[0], m)) if D is None else _like(D, A)
    return C_, D_


def linear_system(A, B, C=None, D=None, device=None) -> ContinuousSystem:
    """xdot = A x + B u, y = C x + D u (LinearSystem)."""
    A, B = tensors_on((A, B), device)
    n, m = B.shape
    C_, D_ = _output_matrices(A, n, m, C, D)

    def f(params, x, u, t=0.0):
        return _mv(A, x) + _mv(B, u)

    def output(params, x, u, t=0.0):
        return _mv(C_, x) + _mv(D_, u)

    return ContinuousSystem(f=f, num_states=n, num_inputs=m, output=output)


def affine_system(A, B, f0, C=None, D=None, y0=None, device=None) -> ContinuousSystem:
    """xdot = A x + B u + f0 (AffineSystem)."""
    A, B, f0 = tensors_on((A, B, f0), device)
    n, m = B.shape
    C_, D_ = _output_matrices(A, n, m, C, D)
    y0_ = A.new_zeros(C_.shape[0]) if y0 is None else _like(y0, A)

    def f(params, x, u, t=0.0):
        return _mv(A, x) + _mv(B, u) + f0

    def output(params, x, u, t=0.0):
        return _mv(C_, x) + _mv(D_, u) + y0_

    return ContinuousSystem(f=f, num_states=n, num_inputs=m, output=output)


def discrete_linear_system(A, B, time_step: float, device=None) -> DiscreteSystem:
    A, B = tensors_on((A, B), device)
    n, m = B.shape

    def g(params, x, u, t=0.0):
        return _mv(A, x) + _mv(B, u)

    return DiscreteSystem(g=g, num_states=n, num_inputs=m, time_step=time_step)


def linearize(system: ContinuousSystem, params, x0, u0, t0=0.0):
    """(A, B) Jacobian linearization (drake::systems::Linearize role)."""
    return system.linearize(params, x0, u0, t0)


def trajectory_source(traj) -> Callable:
    """Policy-style source: u(t) = traj.value(t) (TrajectorySource role)."""

    def source(_, x, t):
        return traj.value(t)

    return source


def zero_order_hold(values, period: float, device=None):
    """ZOH lookup u(t) = values[floor(t / period)] (ZeroOrderHold role)."""
    (values,) = tensors_on((values,), device)
    n = values.shape[0]

    def hold(t):
        t = torch.as_tensor(t, dtype=values.dtype, device=values.device)
        # The reference truncates t / period to int32, toward zero.
        return values[(t / period).to(torch.int32).clamp(0, n - 1).long()]

    return hold


# ---------------------------------------------------------------------------
# MultilayerPerceptron and RandomSource.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MlpParams:
    weights: tuple
    biases: tuple


def mlp_init(generator: torch.Generator, layer_sizes: Sequence[int], dtype=torch.float32,
             device=None) -> MlpParams:
    """Weights N(0, 1) / sqrt(fan_in), biases 0, drawn from `generator` (a
    CPU generator; the draws then go to `device`)."""
    device = resolve_device(device)
    ws, bs = [], []
    for i in range(len(layer_sizes) - 1):
        w = torch.randn((layer_sizes[i], layer_sizes[i + 1]), generator=generator, dtype=dtype)
        ws.append((w / math.sqrt(layer_sizes[i])).to(device))
        bs.append(torch.zeros(layer_sizes[i + 1], dtype=dtype, device=device))
    return MlpParams(weights=tuple(ws), biases=tuple(bs))


def mlp_apply(params: MlpParams, x, activation=torch.tanh):
    h = x
    n = len(params.weights)
    for i, (w, b) in enumerate(zip(params.weights, params.biases)):
        h = h @ w + b
        if i < n - 1:
            h = activation(h)
    return h


def random_source(generator: torch.Generator, shape, distribution: str = "gaussian",
                  dtype=torch.float32, device=None):
    """RandomSource role: a sampled signal array, drawn from `generator` (a
    CPU generator) and placed on `device`."""
    device = resolve_device(device)
    if distribution == "gaussian":
        return torch.randn(tuple(shape), generator=generator, dtype=dtype).to(device)
    if distribution == "uniform":
        return torch.rand(tuple(shape), generator=generator, dtype=dtype).to(device)
    raise ValueError(distribution)


def symbolic_vector_system(*args, **kwargs):
    raise NotImplementedError(
        "symbolic_vector_system waits for math/symbolic, which is not ported yet "
        "(ROADMAP.md item 22)")


# ---------------------------------------------------------------------------
# Wiring blocks.  The stateless ones are functions of tensors (compose them
# inside a policy or an output map); the stateful ones are DiscreteSystems.
# ---------------------------------------------------------------------------


def _t(u, like=None):
    if isinstance(u, torch.Tensor):
        return u
    if like is not None:
        return torch.as_tensor(np.asarray(u), dtype=like.dtype, device=like.device)
    return torch.as_tensor(np.asarray(u))


def constant_vector_source(value, device=None) -> Callable:
    """u(t) = value (ConstantVectorSource role)."""
    (value,) = tensors_on((value,), device)
    return lambda t=0.0: value


def sine_source(amplitude, frequency, phase=0.0, device=None) -> Callable:
    """y(t) = amplitude sin(2 pi frequency t + phase), frequency in Hz (Sine
    role)."""
    (amplitude,) = tensors_on((amplitude,), device)

    def source(t):
        t = torch.as_tensor(t, dtype=amplitude.dtype, device=amplitude.device)
        return amplitude * torch.sin(2.0 * math.pi * frequency * t + phase)

    return source


def adder(*signals):
    """Elementwise sum (Adder role)."""
    total = _t(signals[0])
    for s in signals[1:]:
        total = total + _t(s, total)
    return total


def gain(k, u):
    """y = k u, scalar or per-channel k (Gain role)."""
    u = _t(u)
    return _t(k, u) * u


def saturation(u, u_min, u_max):
    """y = clip(u, u_min, u_max) (Saturation role)."""
    u = _t(u)
    return torch.minimum(torch.maximum(u, _t(u_min, u)), _t(u_max, u))


def pass_through(u):
    """Identity (PassThrough role)."""
    return _t(u)


def multiplexer(*inputs):
    """Concatenate input vectors into one (Multiplexer role)."""
    parts = [torch.atleast_1d(_t(u)) for u in inputs]
    return torch.cat([p.to(parts[0]) for p in parts])


def demultiplexer(u, sizes: Sequence[int]):
    """Split u into vectors of the given sizes (Demultiplexer role)."""
    u = _t(u)
    out, start = [], 0
    for s in sizes:
        out.append(u[start : start + s])
        start += s
    return tuple(out)


def port_switch(index, *inputs):
    """Select inputs[index], the index a tensor or an int (PortSwitch role)."""
    first = _t(inputs[0])
    return torch.stack([_t(u, first) for u in inputs])[index]


def wrap_to_system(u, low, high, indices: Optional[Sequence[int]] = None):
    """Wrap the selected channels into [low, high) (WrapToSystem role)."""
    u = _t(u)
    wrapped = low + torch.remainder(u - low, high - low)
    if indices is None:
        return wrapped
    mask = torch.zeros(u.shape[-1], dtype=torch.bool, device=u.device)
    mask[list(indices)] = True
    return torch.where(mask, wrapped, u)


def first_order_hold(times, values, device=None):
    """FOH lookup u(t): linear interpolation through (times, values), held
    at the ends (``jnp.interp`` column by column)."""
    times, values = tensors_on((times, values), device)
    n = times.shape[0]
    np_dtype = np.float32 if times.dtype == torch.float32 else np.float64
    eps = float(np.spacing(np.finfo(np_dtype).eps))

    def hold(t):
        t = torch.as_tensor(t, dtype=times.dtype, device=times.device)
        i = torch.searchsorted(times, t.reshape(-1), right=True).clamp(1, n - 1).reshape(t.shape)
        df = values[i] - values[i - 1]
        dx = (times[i] - times[i - 1])[..., None]
        delta = (t - times[i - 1])[..., None]
        dx0 = torch.abs(dx) <= eps
        f = torch.where(dx0, values[i - 1],
                        values[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
        f = torch.where((t < times[0])[..., None], values[0], f)
        return torch.where((t > times[-1])[..., None], values[-1], f)

    return hold


def discrete_derivative(size: int, period: float, suppress_initial_transient: bool = True):
    """DiscreteDerivative: y = (x0 - x1) / h from the stored samples only
    (x0 = u[n-1], x1 = u[n-2]), so the estimate lags the input by a period;
    with the transient suppressed, a sample counter zeroes y until two
    samples are stored."""
    n_extra = 1 if suppress_initial_transient else 0

    def g(params, x, u, t=0.0):
        parts = [_t(u, x), x[..., :size]]
        if suppress_initial_transient:
            parts.append(x[..., 2 * size : 2 * size + 1] + 1.0)
        return torch.cat(parts, dim=-1)

    def output(params, x, u, t=0.0):
        deriv = (x[..., :size] - x[..., size : 2 * size]) / period
        if suppress_initial_transient:
            return torch.where(x[..., 2 * size : 2 * size + 1] >= 2.0, deriv,
                               torch.zeros_like(deriv))
        return deriv

    return DiscreteSystem(g=g, num_states=2 * size + n_extra, num_inputs=size,
                          time_step=period, output=output)


def state_interpolator_with_discrete_derivative(size: int, period: float,
                                                suppress_initial_transient: bool = True):
    """StateInterpolatorWithDiscreteDerivative: position commands in, the
    desired state [q; v] out, v by backward difference."""
    dd = discrete_derivative(size, period, suppress_initial_transient)

    def output(params, x, u, t=0.0):
        return torch.cat([_t(u, x), dd.output(params, x, u, t)], dim=-1)

    return DiscreteSystem(g=dd.g, num_states=dd.num_states, num_inputs=size,
                          time_step=period, output=output)
