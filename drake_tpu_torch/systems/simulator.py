"""Simulation: fixed-step rollouts in place of Simulator::AdvanceTo.

The PyTorch counterpart of the fixed-step part of
``drake_tpu/systems/simulator.py``.  The reference's ``lax.scan`` rollouts
are Python loops, the closed loop's through ``utils.scan`` (one CUDA graph
of a step, replayed, on the card); the lanes of a batch ride in the leading
dimensions of ``x0`` and of the inputs, so ``batch_simulate`` is
``simulate`` on batched tensors.  The time is carried as the reference
carries it: a tensor of the state's type to which each step adds ``dt``.

Not ported yet (ROADMAP.md item 22): the error-controlled
``simulate_adaptive``, the witness functions and hybrid resets
(``WitnessFunction``, ``simulate_hybrid``) and ``dense_output``; they raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from drake_tpu_torch.systems import integrators as _integrators
from drake_tpu_torch.systems.base import ContinuousSystem, DiscreteSystem
from drake_tpu_torch.utils.scan import scan


@dataclasses.dataclass(frozen=True)
class SimulatorConfig:
    """Mirror of drake::systems::SimulatorConfig."""

    integration_scheme: str = "rk4"
    max_step_size: float = 0.01
    accuracy: float = 1e-4
    use_error_control: bool = False


def _times(t0, dt, n, like):
    return t0 + dt * torch.arange(n + 1, dtype=like.dtype, device=like.device)


def simulate(system: ContinuousSystem, params, x0, u_sequence, dt, t0=0.0, method: str = "rk4"):
    """Roll out an input sequence with fixed steps (zero-order hold).

    ``x0`` (..., nx), ``u_sequence`` (..., N, nu): one input per step.
    Returns (xs (..., N+1, nx) including x0, ts (N+1,))."""
    step = _integrators.get(method)
    n = u_sequence.shape[-2]
    x, t = x0, torch.tensor(t0, dtype=x0.dtype, device=x0.device)
    xs = [x0]
    for k in range(n):
        x = step(system.f, params, x, u_sequence[..., k, :], t, dt)
        t = t + dt
        xs.append(x)
    return torch.stack(xs, dim=-2), _times(t0, dt, n, x0)


def simulate_controlled(system: ContinuousSystem, params, x0, policy: Callable, num_steps: int,
                        dt, t0=0.0, method: str = "rk4", policy_state=None):
    """Closed-loop rollout: u = policy(policy_state, x, t) each step.

    ``policy`` may return either ``u`` or ``(u, new_policy_state)``.  On the
    card with autograd off, the step is replayed as a CUDA graph
    (``utils.scan``): the policy must then keep to what a graph captures,
    and a policy state be a tensor.
    Returns (xs (..., N+1, nx), us (..., N, nu), ts (N+1,))."""
    step = _integrators.get(method)

    def body(carry):
        x, t, *ps = carry
        out = policy(ps[0] if ps else None, x, t)
        u, ps = (out[0], [out[1]]) if isinstance(out, tuple) else (out, ps)
        x = step(system.f, params, x, u, t, dt)
        return (x, t + dt, *ps), (x, u)

    t = torch.tensor(t0, dtype=x0.dtype, device=x0.device)
    carry = (x0, t) if policy_state is None else (x0, t, policy_state)
    _, (xs, us) = scan(body, carry, num_steps)
    return (torch.cat([x0.unsqueeze(-2), xs.movedim(0, -2)], dim=-2), us.movedim(0, -2),
            _times(t0, dt, num_steps, x0))


def simulate_discrete(system: DiscreteSystem, params, x0, u_sequence, t0=0.0):
    """Roll out a discrete system over an input sequence (..., N, nu)."""
    x, t = x0, torch.tensor(t0, dtype=x0.dtype, device=x0.device)
    xs = [x0]
    for k in range(u_sequence.shape[-2]):
        x = system.g(params, x, u_sequence[..., k, :], t)
        t = t + system.time_step
        xs.append(x)
    return torch.stack(xs, dim=-2)


def batch_simulate(system, params, x0_batch, u_batch, dt, method: str = "rk4"):
    """Batched rollouts, x0_batch (B, nx) and u_batch (B, N, nu): the
    reference's vmap of ``simulate``."""
    return simulate(system, params, x0_batch, u_batch, dt, method=method)


def _not_ported(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet (ROADMAP.md item 22)")

    fn.__name__ = name
    return fn


simulate_adaptive = _not_ported("simulate_adaptive")
simulate_hybrid = _not_ported("simulate_hybrid")
WitnessFunction = _not_ported("WitnessFunction")
dense_output = _not_ported("dense_output")
