"""Quadrotor: Drake's QuadrotorPlant.

The PyTorch counterpart of ``drake_tpu/models/quadrotor.py`` (reference
examples/quadrotor/quadrotor_plant.cc; defaults m = 0.775 kg, arm 0.15 m,
I = diag(0.0015, 0.0025, 0.0035), kF = 1.0, kM = 0.0245, g = 9.81).

State x = [xyz (3), rpy (3), xyz_dot (3), rpy_dot (3)], input u = the four
rotor forces; both carry lanes in their leading dimensions.  Rotors 0..3 sit
on the +x, +y, -x, -y arms; 0 and 2 spin opposite to 1 and 3.  The JAX
parameters come across with ``params_from_numpy``.
"""

from __future__ import annotations

import torch

from drake_tpu_torch.math import rotations as rot
from drake_tpu_torch.systems.base import ContinuousSystem
from drake_tpu_torch.utils.device import resolve_device
from drake_tpu_torch.utils.linalg import solve
from drake_tpu_torch.utils.struct import from_numpy, tensor_dataclass, to_numpy


@tensor_dataclass
class QuadrotorParams:
    mass: torch.Tensor
    arm_length: torch.Tensor
    inertia: torch.Tensor  # (3, 3)
    kF: torch.Tensor
    kM: torch.Tensor
    gravity: torch.Tensor


def default_params(dtype=torch.float32, device=None) -> QuadrotorParams:
    device = resolve_device(device)

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return QuadrotorParams(
        mass=scalar(0.775),
        arm_length=scalar(0.15),
        inertia=torch.diag(torch.tensor([0.0015, 0.0025, 0.0035], dtype=dtype, device=device)),
        kF=scalar(1.0),
        kM=scalar(0.0245),
        gravity=scalar(9.81),
    )


def params_from_numpy(arrays, device=None, dtype=None) -> QuadrotorParams:
    """QuadrotorParams from numpy arrays of the JAX fields
    (``{f.name: np.asarray(getattr(p, f.name)) for f in fields(p)}``)."""
    return from_numpy(QuadrotorParams, arrays, device, dtype)


def params_to_numpy(params: QuadrotorParams) -> dict:
    return to_numpy(params)


def dynamics(p: QuadrotorParams, x, u, t=0.0):
    rpy = x[..., 3:6]
    rpy_dot = x[..., 9:12]

    uF = p.kF * u  # per-rotor thrusts along body z
    zero = torch.zeros_like(uF[..., 0])
    Faero_B = torch.stack([zero, zero, torch.sum(uF, dim=-1)], dim=-1)
    Mx = p.arm_length * (uF[..., 1] - uF[..., 3])
    My = p.arm_length * (uF[..., 2] - uF[..., 0])
    uTau = p.kM * u
    Mz = uTau[..., 0] - uTau[..., 1] + uTau[..., 2] - uTau[..., 3]
    Tau_B = torch.stack([Mx, My, Mz], dim=-1)

    R_NB = rot.rpy_to_rotation(rpy)
    g0 = torch.zeros_like(p.mass)
    Fgravity_N = torch.stack([g0, g0, -p.mass * p.gravity], dim=-1)
    Fnet_N = Fgravity_N + (R_NB @ Faero_B.unsqueeze(-1)).squeeze(-1)
    xyz_ddot = Fnet_N / p.mass[..., None]

    w_NB_B = rot.rpy_rates_to_angular_velocity_in_child(rpy, rpy_dot)
    Iw = (p.inertia @ w_NB_B.unsqueeze(-1)).squeeze(-1)
    wIw = torch.linalg.cross(w_NB_B, Iw, dim=-1)
    alpha_NB_B = solve(p.inertia, Tau_B - wIw)
    alpha_NB_N = (R_NB @ alpha_NB_B.unsqueeze(-1)).squeeze(-1)
    rpy_ddot = rot.rpy_ddt_from_angular_accel_in_parent(rpy, rpy_dot, alpha_NB_N)

    return torch.cat([x[..., 6:12], xyz_ddot, rpy_ddot], dim=-1)


def hover_input(p: QuadrotorParams):
    """Per-rotor force balancing gravity."""
    u0 = p.mass * p.gravity / (4 * p.kF)
    return torch.stack([u0, u0, u0, u0], dim=-1)


def make_system(params: QuadrotorParams | None = None) -> ContinuousSystem:
    return ContinuousSystem(
        f=dynamics,
        num_states=12,
        num_inputs=4,
        num_q=6,
        num_v=6,
        default_params=params if params is not None else default_params(),
    )
