"""Acrobot: Drake's AcrobotPlant.

The PyTorch counterpart of ``drake_tpu/models/acrobot.py`` (reference
examples/acrobot/acrobot_plant.cc, MassMatrix:57-72, DynamicsBiasTerm:75-99,
DoCalcTimeDerivatives:102-117; defaults of gen/acrobot_params.h: m1 = m2 =
1, l1 = 1, l2 = 2, lc1 = 0.5, lc2 = 1, Ic1 = 0.083, Ic2 = 0.33, b1 = b2 =
0.1, g = 9.81).

State x = [theta1, theta2, theta1dot, theta2dot] with theta1 from straight
down (upright is [pi, 0, 0, 0]), input u = [tau] at the elbow; lanes ride in
the leading dimensions.  Manipulator form M(q) vdot + bias(q, v) = [0, 1]' u.
The JAX parameters come across with ``params_from_numpy``.
"""

from __future__ import annotations

import math

import torch

from drake_tpu_torch.systems.base import ContinuousSystem
from drake_tpu_torch.utils.device import resolve_device
from drake_tpu_torch.utils.linalg import solve_spd_2x2
from drake_tpu_torch.utils.struct import from_numpy, tensor_dataclass, to_numpy

_DEFAULTS = dict(m1=1.0, m2=1.0, l1=1.0, l2=2.0, lc1=0.5, lc2=1.0, Ic1=0.083, Ic2=0.33,
                 b1=0.1, b2=0.1, gravity=9.81)


@tensor_dataclass
class AcrobotParams:
    m1: torch.Tensor
    m2: torch.Tensor
    l1: torch.Tensor
    l2: torch.Tensor
    lc1: torch.Tensor
    lc2: torch.Tensor
    Ic1: torch.Tensor
    Ic2: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor
    gravity: torch.Tensor


def default_params(dtype=torch.float32, device=None) -> AcrobotParams:
    device = resolve_device(device)
    return AcrobotParams(**{k: torch.tensor(v, dtype=dtype, device=device)
                            for k, v in _DEFAULTS.items()})


def params_from_numpy(arrays, device=None, dtype=None) -> AcrobotParams:
    """AcrobotParams from numpy arrays of the JAX fields."""
    return from_numpy(AcrobotParams, arrays, device, dtype)


def params_to_numpy(params: AcrobotParams) -> dict:
    return to_numpy(params)


def mass_entries(p: AcrobotParams, q):
    """(m11, m12, m22) of M(q), lane by lane, as AcrobotPlant::MassMatrix."""
    c2 = torch.cos(q[..., 1])
    I1 = p.Ic1 + p.m1 * p.lc1**2
    I2 = p.Ic2 + p.m2 * p.lc2**2
    m2l1lc2 = p.m2 * p.l1 * p.lc2
    m11 = I1 + I2 + p.m2 * p.l1**2 + 2 * m2l1lc2 * c2
    m12 = I2 + m2l1lc2 * c2
    return m11, m12, I2.expand(m12.shape)


def mass_matrix(p: AcrobotParams, q):
    """M(q), (..., 2, 2)."""
    m11, m12, m22 = mass_entries(p, q)
    return torch.stack([torch.stack([m11, m12], dim=-1), torch.stack([m12, m22], dim=-1)], dim=-2)


def bias_term(p: AcrobotParams, q, v):
    """C(q, v) v - tau_g(q) + damping, as AcrobotPlant::DynamicsBiasTerm."""
    s1 = torch.sin(q[..., 0])
    s2 = torch.sin(q[..., 1])
    s12 = torch.sin(q[..., 0] + q[..., 1])
    v1, v2 = v[..., 0], v[..., 1]
    m2l1lc2 = p.m2 * p.l1 * p.lc2
    b0 = -2 * m2l1lc2 * s2 * v2 * v1 - m2l1lc2 * s2 * v2**2
    b1 = m2l1lc2 * s2 * v1**2
    # Gravity torques (theta1 from straight down), then damping.
    b0 = b0 + p.gravity * p.m1 * p.lc1 * s1 + p.gravity * p.m2 * (p.l1 * s1 + p.lc2 * s12)
    b1 = b1 + p.gravity * p.m2 * p.lc2 * s12
    b0 = b0 + p.b1 * v1
    b1 = b1 + p.b2 * v2
    return torch.stack([b0, b1], dim=-1)


def dynamics(p: AcrobotParams, x, u, t=0.0):
    q, v = x[..., :2], x[..., 2:]
    bias = bias_term(p, q, v)
    vdot = solve_spd_2x2(*mass_entries(p, q), -bias[..., 0], u[..., 0] - bias[..., 1])
    return torch.cat([v, torch.stack(vdot, dim=-1)], dim=-1)


def total_energy(p: AcrobotParams, x):
    """KE + PE (AcrobotPlant::DoCalcKineticEnergy, DoCalcPotentialEnergy)."""
    q, v = x[..., :2], x[..., 2:]
    m11, m12, m22 = mass_entries(p, q)
    v1, v2 = v[..., 0], v[..., 1]
    ke = 0.5 * (m11 * v1 * v1 + 2 * m12 * v1 * v2 + m22 * v2 * v2)
    c1 = torch.cos(q[..., 0])
    c12 = torch.cos(q[..., 0] + q[..., 1])
    pe = -p.m1 * p.gravity * p.lc1 * c1 - p.m2 * p.gravity * (p.l1 * c1 + p.lc2 * c12)
    return ke + pe


def upright_state(dtype=torch.float32, device=None):
    return torch.tensor([math.pi, 0.0, 0.0, 0.0], dtype=dtype, device=resolve_device(device))


def make_system(params: AcrobotParams | None = None) -> ContinuousSystem:
    return ContinuousSystem(
        f=dynamics,
        num_states=4,
        num_inputs=1,
        num_q=2,
        num_v=2,
        default_params=params if params is not None else default_params(),
    )
