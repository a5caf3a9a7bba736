"""Cart-pole: the analytic counterpart of Drake's cart_pole example.

The PyTorch counterpart of ``drake_tpu/models/cart_pole.py`` (reference
examples/multibody/cart_pole/cart_pole.sdf: cart 10 kg, a 1 kg point mass
0.5 m from the pivot, g = 9.81).  State x = [pos, theta, posdot, thetadot]
with theta from straight down (upright is [0, pi, 0, 0]), input u = [force
on the cart]; lanes ride in the leading dimensions.  The JAX parameters come
across with ``params_from_numpy``.
"""

from __future__ import annotations

import math

import torch

from drake_tpu_torch.systems.base import ContinuousSystem
from drake_tpu_torch.utils.device import resolve_device
from drake_tpu_torch.utils.linalg import solve_spd_2x2
from drake_tpu_torch.utils.struct import from_numpy, tensor_dataclass, to_numpy


@tensor_dataclass
class CartPoleParams:
    mc: torch.Tensor  # cart mass
    mp: torch.Tensor  # pole point mass
    l: torch.Tensor  # pole length
    gravity: torch.Tensor


def default_params(dtype=torch.float32, device=None) -> CartPoleParams:
    device = resolve_device(device)
    return CartPoleParams(*(torch.tensor(v, dtype=dtype, device=device)
                            for v in (10.0, 1.0, 0.5, 9.81)))


def params_from_numpy(arrays, device=None, dtype=None) -> CartPoleParams:
    """CartPoleParams from numpy arrays of the JAX fields."""
    return from_numpy(CartPoleParams, arrays, device, dtype)


def params_to_numpy(params: CartPoleParams) -> dict:
    return to_numpy(params)


def mass_entries(p: CartPoleParams, q):
    """(m11, m12, m22) of M(q), lane by lane."""
    c = torch.cos(q[..., 1])
    m12 = p.mp * p.l * c
    return (p.mc + p.mp).expand(m12.shape), m12, (p.mp * p.l**2).expand(m12.shape)


def mass_matrix(p: CartPoleParams, q):
    """M(q), (..., 2, 2)."""
    m11, m12, m22 = mass_entries(p, q)
    return torch.stack([torch.stack([m11, m12], dim=-1), torch.stack([m12, m22], dim=-1)], dim=-2)


def dynamics(p: CartPoleParams, x, u, t=0.0):
    theta, thetadot = x[..., 1], x[..., 3]
    s = torch.sin(theta)
    # bias = C(q, v) v - tau_g; generalized forces [u, 0].
    b0 = -p.mp * p.l * s * thetadot**2 - u[..., 0]
    b1 = p.mp * p.gravity * p.l * s
    vdot = solve_spd_2x2(*mass_entries(p, x[..., :2]), -b0, -b1)
    return torch.cat([x[..., 2:], torch.stack(vdot, dim=-1)], dim=-1)


def upright_state(dtype=torch.float32, device=None):
    return torch.tensor([0.0, math.pi, 0.0, 0.0], dtype=dtype, device=resolve_device(device))


def make_system(params: CartPoleParams | None = None) -> ContinuousSystem:
    return ContinuousSystem(
        f=dynamics,
        num_states=4,
        num_inputs=1,
        num_q=2,
        num_v=2,
        default_params=params if params is not None else default_params(),
    )
