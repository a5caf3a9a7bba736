"""MPPI: model-predictive path integral control (sampling-based MPC).

The PyTorch counterpart of ``drake_tpu/control/mppi.py`` (Williams et al.,
"Information Theoretic MPC", ICRA 2017), over a batch of B independent
scenarios.  Each update perturbs every scenario's nominal control sequence
with M samples, rolls out the B * M perturbed sequences as one batch of
lanes of the dynamics, and reweights them exponentially by their costs.  It
never differentiates the dynamics, so it works through
``CoupledWorld.step``.

- ``dynamics(state, u)`` takes and returns a state tree whose tensors lead
  with the lanes, and u (lanes, nu); ``running_cost(state, u)`` and
  ``final_cost(state)`` return one cost per lane.
- The perturbations are drawn apart from the update: ``sample_noise`` draws
  standard normals from an explicit ``torch.Generator``, and ``mppi_step``
  takes them as an argument, so that a caller can feed the same draws to the
  reference.  The reference draws from JAX keys; the two streams differ.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from drake_tpu_torch.utils.device import constant
from drake_tpu_torch.utils.struct import tree_map


@dataclasses.dataclass(frozen=True)
class MppiOptions:
    num_samples: int = 64  # M rollouts per scenario and solve
    temperature: float = 1.0  # lambda: lower = greedier reweighting
    noise_sigma: Any = 1.0  # control perturbation std (scalar or (nu,))
    smoothing: float = 0.0  # exponential smoothing across the horizon
    u_lower: Any = None  # optional (nu,) clamp
    u_upper: Any = None


class MppiResult(NamedTuple):
    u_traj: torch.Tensor  # (B, H, nu) updated nominal control sequences
    cost: torch.Tensor  # (B,) weighted-average rollout cost
    best_cost: torch.Tensor  # (B,) best single rollout


def _option_tensor(value, like):
    """An option (a float, a sequence or a tensor) as a tensor of `like`'s
    dtype and device; Python values come from the constant memo, so that the
    card's stream is not waited for."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype=like.dtype, device=like.device)
    a = np.asarray(value, dtype=float)
    return constant(float(a) if a.ndim == 0 else tuple(a.tolist()), like)


def sample_noise(generator: torch.Generator, u_nominal, options: MppiOptions):
    """Standard normal draws (B, M, H, nu) for one update of the nominal
    sequences u_nominal (B, H, nu), from `generator` (on their device)."""
    B, H, nu = u_nominal.shape
    return torch.randn((B, options.num_samples, H, nu), generator=generator,
                       dtype=u_nominal.dtype, device=u_nominal.device)


def _rollout_cost(dynamics, running_cost, final_cost, state0, us):
    """Total cost (lanes,) of the control sequences us (lanes, H, nu)."""
    acc = us.new_zeros(us.shape[0])
    state = state0
    for t in range(us.shape[1]):
        u = us[:, t]
        c = running_cost(state, u)
        state = dynamics(state, u)
        acc = acc + c
    return acc + final_cost(state)


def mppi_step(
    dynamics: Callable,
    running_cost: Callable,
    final_cost: Callable,
    state0,
    u_nominal,
    noise,
    options: MppiOptions = MppiOptions(),
) -> MppiResult:
    """One MPPI update of the nominal sequences u_nominal (B, H, nu) of the
    B scenarios in state0, with the standard normal draws `noise`
    (B, M, H, nu).  The M samples of scenario b are lanes b*M ... b*M+M-1 of
    the dynamics."""
    B, H, nu = u_nominal.shape
    M = options.num_samples
    if tuple(noise.shape) != (B, M, H, nu):
        raise ValueError(f"noise: expected {(B, M, H, nu)}, got {tuple(noise.shape)}")
    sigma = _option_tensor(options.noise_sigma, u_nominal).expand(nu)
    eps = noise * sigma
    if options.smoothing > 0.0:
        b = options.smoothing
        carry = torch.zeros_like(eps[:, :, 0])
        smoothed = []
        for t in range(H):
            carry = b * carry + (1.0 - b) * eps[:, :, t]
            smoothed.append(carry)
        eps = torch.stack(smoothed, dim=2)
    us = u_nominal[:, None] + eps  # (B, M, H, nu)
    if options.u_lower is not None:
        us = torch.clamp(us, _option_tensor(options.u_lower, u_nominal),
                         _option_tensor(options.u_upper, u_nominal))

    lanes0 = tree_map(lambda t: t.repeat_interleave(M, dim=0), state0)
    costs = _rollout_cost(
        dynamics, running_cost, final_cost, lanes0, us.reshape(B * M, H, nu)
    ).reshape(B, M)

    beta = torch.amin(costs, dim=1)
    w = torch.exp(-(costs - beta[:, None]) / options.temperature)
    w = w / (torch.sum(w, dim=1, keepdim=True) + 1e-12)
    u_new = torch.einsum("bk,bkhu->bhu", w, us).to(u_nominal.dtype)
    return MppiResult(u_traj=u_new, cost=torch.sum(w * costs, dim=1), best_cost=beta)


def mppi_mpc_rollout(
    dynamics: Callable,
    running_cost: Callable,
    final_cost: Callable,
    state0,
    u_init,
    num_steps: int,
    options: MppiOptions = MppiOptions(),
    iterations_per_step: int = 1,
    generator: Optional[torch.Generator] = None,
    noise=None,
):
    """Receding-horizon MPPI over B scenarios: at each step refine the
    nominal sequences, apply their first controls, shift (warm start).

    The draws come from `generator`, or, where `noise` is given, from it:
    (num_steps, iterations_per_step, B, M, H, nu).  Returns (the states
    after each step, stacked at axis 1 of every tensor: (B, num_steps,
    ...); the applied controls (B, num_steps, nu); the best rollout cost of
    each solve (B, num_steps))."""
    if noise is None and generator is None:
        raise ValueError("mppi_mpc_rollout needs a generator or the noise")
    state, u_nom = state0, u_init
    states, applied, best = [], [], []
    for step in range(num_steps):
        for it in range(iterations_per_step):
            eps = noise[step, it] if noise is not None else sample_noise(generator, u_nom, options)
            res = mppi_step(dynamics, running_cost, final_cost, state, u_nom, eps, options)
            u_nom = res.u_traj
        u0 = u_nom[:, 0]
        state = dynamics(state, u0)
        u_nom = torch.cat([u_nom[:, 1:], u_nom[:, -1:]], dim=1)
        states.append(state)
        applied.append(u0)
        best.append(res.best_cost)
    stacked = tree_map(lambda *ts: torch.stack(ts, dim=1), *states)
    return stacked, torch.stack(applied, dim=1), torch.stack(best, dim=1)
