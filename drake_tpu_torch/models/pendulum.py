"""Simple pendulum: Drake's PendulumPlant.

The PyTorch counterpart of ``drake_tpu/models/pendulum.py`` (reference
examples/pendulum/pendulum_plant.cc; defaults mass 1.0 kg, length 0.5 m,
damping 0.1, gravity 9.81).  State x = [theta, thetadot], input u = [tau],
with lanes in the leading dimensions:

    m l^2 thetaddot = tau - m g l sin(theta) - b thetadot.
"""

from __future__ import annotations

import torch

from drake_tpu_torch.systems.base import ContinuousSystem
from drake_tpu_torch.utils.device import resolve_device
from drake_tpu_torch.utils.struct import from_numpy, tensor_dataclass, to_numpy


@tensor_dataclass
class PendulumParams:
    mass: torch.Tensor
    length: torch.Tensor
    damping: torch.Tensor
    gravity: torch.Tensor


def default_params(dtype=torch.float32, device=None) -> PendulumParams:
    device = resolve_device(device)
    return PendulumParams(*(torch.tensor(v, dtype=dtype, device=device)
                            for v in (1.0, 0.5, 0.1, 9.81)))


def params_from_numpy(arrays, device=None, dtype=None) -> PendulumParams:
    """PendulumParams from numpy arrays of the JAX fields."""
    return from_numpy(PendulumParams, arrays, device, dtype)


def params_to_numpy(params: PendulumParams) -> dict:
    return to_numpy(params)


def dynamics(params: PendulumParams, x, u, t=0.0):
    theta, thetadot = x[..., 0], x[..., 1]
    ml2 = params.mass * params.length**2
    thetaddot = (
        u[..., 0]
        - params.mass * params.gravity * params.length * torch.sin(theta)
        - params.damping * thetadot
    ) / ml2
    return torch.stack([thetadot, thetaddot], dim=-1)


def total_energy(params: PendulumParams, x):
    """KE + PE, as PendulumPlant::CalcTotalEnergy (PE = -m g l cos theta)."""
    theta, thetadot = x[..., 0], x[..., 1]
    ke = 0.5 * params.mass * (params.length * thetadot) ** 2
    pe = -params.mass * params.gravity * params.length * torch.cos(theta)
    return ke + pe


def make_system(params: PendulumParams | None = None) -> ContinuousSystem:
    return ContinuousSystem(
        f=dynamics,
        num_states=2,
        num_inputs=1,
        num_q=1,
        num_v=1,
        default_params=params if params is not None else default_params(),
    )
