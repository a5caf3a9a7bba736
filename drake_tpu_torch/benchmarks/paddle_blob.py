"""The paddle-and-blob world of BASELINE config 5, shared by the coupled
benches: a rigid paddle on a prismatic joint along x pushes a soft MPM blob
(``benchmarks/bench_coupled_mpc.py:69-102`` and
``benchmarks/bench_coupled_world.py:75-131`` of the JAX package).

- Paddle: 2 kg on a prismatic joint along x at (0, 0.5, 0), damping 5.0;
  its collision box 0.02 x 0.3 x 0.3 m, 0.15 m above the body origin.
- Blob: 360 particles (8 a cell) filling [0.35, 0.45] x [0.42, 0.58] x
  [0.08, 0.18], Young's modulus 3e4.
- Grid 32^3, dx 1/32, dt 1e-3, wall 2 cells; blocked capacities A = 64,
  pmax = 512.  Penalty contact k 5e4, d 100, mu 0.3 (dt sqrt(k) = 0.22, so
  "auto" takes the penalty branch); 10 substeps per 10 ms coupled step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from drake_tpu_torch.contact import coupled_plant
from drake_tpu_torch.geometry import shapes as sh
from drake_tpu_torch.geometry.scene import CollisionGeometry, CollisionScene
from drake_tpu_torch.mpm import coupling as cpl
from drake_tpu_torch.mpm import solver as mpm
from drake_tpu_torch.multibody.model import ModelBuilder, MultibodyParams
from drake_tpu_torch.utils.device import resolve_device
from drake_tpu_torch.utils.struct import tree_map

GOAL_X = 0.55  # goal of the blob's centroid along x
PADDLE_X0 = 0.31  # paddle joint position at the start
BLOB = ((0.35, 0.42, 0.08), (0.45, 0.58, 0.18))  # lower and upper corner


class PaddleBlob(NamedTuple):
    world: coupled_plant.CoupledWorld
    params: MultibodyParams
    state0: coupled_plant.CoupledState  # one state, no lane axis
    running_cost: Callable  # (state, u) -> (lanes,)
    final_cost: Callable  # state -> (lanes,)


def centroid_x(state: coupled_plant.CoupledState):
    """Mean particle x of each lane."""
    return torch.mean(state.particles.x[..., 0], dim=-1)


def build(device=None, dtype=torch.float32, xla_only: bool = False) -> PaddleBlob:
    """The world, its parameters, its initial state and the MPC's costs, on
    `device` (None: the current CUDA device).  ``xla_only`` takes the plain
    versions of the kernels."""
    device = resolve_device(device)
    b = ModelBuilder(gravity=(0.0, 0.0, -9.81))
    b.add_body(
        "paddle", parent=None, joint_type="prismatic", mass=2.0,
        inertia_com=np.eye(3) * 1e-3, axis=(1, 0, 0), damping=5.0,
        joint_name="slide", X_PJ_xyz=(0.0, 0.5, 0.0),
    )
    model, params = b.build(dtype, device=device)
    geoms = [
        CollisionGeometry(
            name="paddle", body=0, shape=sh.Box((0.02, 0.3, 0.3)),
            friction=0.5, stiffness=1e5, dissipation=0.1,
            p_BG=np.asarray([0.0, 0.0, 0.15]),
        ),
    ]
    scene = CollisionScene.build(geoms)
    config = mpm.MpmConfig(
        grid_size=(32, 32, 32), dx=1.0 / 32, dt=1e-3, wall_width=2,
        youngs_modulus=3e4, max_active_blocks=64, block_capacity=512,
        xla_only=xla_only,
    )
    world = coupled_plant.CoupledWorld(
        model=model, scene=scene, mpm_config=config,
        contact_params=cpl.MpmContactParams(stiffness=5e4, damping=100.0, friction=0.3),
        coupled_geometries=(0,), substeps_per_step=10, time_step=1e-2,
    )
    particles = mpm.make_particle_block(config, *BLOB, dtype=dtype, device=device)
    rigid = torch.tensor([PADDLE_X0, 0.0], dtype=dtype, device=device)
    state0 = coupled_plant.CoupledState(rigid=rigid, particles=particles)

    def running(s, u):
        cx = centroid_x(s)
        gap = cx - (s.rigid[..., 0] + 0.02)
        approach_on = torch.sigmoid((GOAL_X - 0.03 - cx) / 0.01)
        vx = torch.mean(s.particles.v[..., 0], dim=-1)
        return (
            200.0 * (cx - GOAL_X) ** 2
            + 5.0 * approach_on * gap * gap
            + 1.0 * (1.0 - approach_on) * vx * vx
            + 1e-6 * u[..., 0] ** 2
        )

    def final(s):
        return 200.0 * (centroid_x(s) - GOAL_X) ** 2

    return PaddleBlob(world=world, params=params, state0=state0,
                      running_cost=running, final_cost=final)


def lanes(state: coupled_plant.CoupledState, count: int) -> coupled_plant.CoupledState:
    """`count` copies of one state as lanes (a leading axis on every tensor)."""
    return tree_map(lambda t: t.expand((count,) + t.shape).contiguous(), state)


def shifted(state: coupled_plant.CoupledState, dx0) -> coupled_plant.CoupledState:
    """Lanes of `state` (lanes, ...) with the blob and the paddle moved by
    dx0 (lanes,) along x, as the reference bench perturbs its scenarios."""
    p = state.particles
    x = p.x.clone()
    x[..., 0] += dx0[:, None]
    rigid = state.rigid.clone()
    rigid[..., 0] += dx0
    return coupled_plant.CoupledState(rigid=rigid, particles=dataclasses.replace(p, x=x))
