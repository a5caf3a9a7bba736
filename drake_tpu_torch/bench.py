"""Benchmark: iiwa contact-implicit MPC solves per second, on one GPU.

The PyTorch counterpart of the repository's ``bench.py`` (BASELINE config 4)
and of ``build_world`` in ``examples/iiwa_push_mpc.py``: batched
receding-horizon iLQR that optimizes the 7 joint torques of an iiwa through
the SAP contact dynamics of the iiwa + free-box world (nq = 14, nv = 13, 9
contacts), with gradients by the implicit-function theorem.  Every counted
solve is a working solve: the same controller pushes the box to its goal.

    python -m drake_tpu_torch.bench [--batch 1024] [--steps 30]

prints one JSON line: the metric, its value in solves/s, how many lanes
moved their box closer to the goal, the median final box error and the card.

Differences from the reference program, by design: there is no TPU probe or
CPU re-exec; the initial box offsets are drawn from a ``torch.Generator``
seeded with `seed` (default 0), so they are not the draws of JAX's
``PRNGKey(0)``, which PyTorch cannot reproduce; the rollout runs eagerly.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from drake_tpu_torch.contact import plant as cplant
from drake_tpu_torch.contact import sap
from drake_tpu_torch.control import mpc
from drake_tpu_torch.geometry import shapes as sh
from drake_tpu_torch.geometry.scene import CollisionGeometry, CollisionScene
from drake_tpu_torch.models import iiwa
from drake_tpu_torch.multibody import dynamics as dyn
from drake_tpu_torch.multibody import kinematics as kin
from drake_tpu_torch.multibody.model import FLOATING, ModelBuilder
from drake_tpu_torch.trajopt import ilqr
from drake_tpu_torch.utils.device import card, resolve_device

H = 0.04
HORIZON = 12
SIDE = 0.12
BOX_GOAL = (0.78, 0.15)


def build_world(dtype=torch.float32, device=None):
    """(model, params, scene, side): the iiwa (joint damping 2) beside a free
    0.5 kg box of side 0.12 on the ground; contacts box-ground and ee-box."""
    b = ModelBuilder()
    iiwa.add_links(b, damping=2.0, joint_names=False)
    mass_box = 0.5
    b.add_body("box", parent=None, joint_type=FLOATING, mass=mass_box,
               inertia_com=np.eye(3) * mass_box * SIDE**2 / 6.0)
    model, params = b.build(dtype, device)
    geoms = [
        CollisionGeometry(name="ground", body=-1, shape=sh.HalfSpace(), friction=0.6),
        CollisionGeometry(name="box", body=model.body_index("box"),
                          shape=sh.Box((SIDE, SIDE, SIDE)), friction=0.6,
                          stiffness=1e5, dissipation=0.1),
        CollisionGeometry(name="ee", body=model.body_index("link7"),
                          shape=sh.Sphere(0.06), friction=0.6,
                          stiffness=1e5, dissipation=0.1),
    ]
    scene = CollisionScene.build(geoms, exclude=[("ground", "ee")])
    return model, params, scene, SIDE


def build_rollout(batch=1024, mpc_steps=30, device=None, dtype=torch.float32, seed=0):
    """The headline program: (rollout, x0s, info).  ``rollout(x0s)`` runs
    `mpc_steps` MPC steps of every lane and returns an ``MpcRolloutResult``;
    ``info`` holds the pieces (model, params, the planning and plant steps,
    the costs, the options) for callers that drive them one by one."""
    device = resolve_device(device)
    model, params, scene, side = build_world(dtype, device)
    nq, nv = model.num_positions, model.num_velocities
    dsys = cplant.make_discrete_system(model, params, scene, H)
    # Planning dynamics: a fixed 4-iteration SAP solve; the plant step keeps
    # the converged solver.
    sp_plan = sap.SapParameters(unroll_iterations=4, line_search_points=12)
    dsys_plan = cplant.make_discrete_system(model, params, scene, H, sap_params=sp_plan)

    q_arm = iiwa.home_position(dtype, device)
    q_box = torch.tensor([1, 0, 0, 0, 0.62, 0.0, side / 2], dtype=dtype, device=device)
    q0 = torch.cat([q_arm, q_box])
    x0 = torch.cat([q0, torch.zeros(nv, dtype=dtype, device=device)])
    box_goal = torch.tensor(BOX_GOAL, dtype=dtype, device=device)
    tau_g = dyn.bias_forces(model, params, q0, torch.zeros(nv, dtype=dtype, device=device))[:7]
    ee_body = model.body_index("link7")

    def running_cost(p, x, u, t):
        q_box_xy = x[..., nq - 3 : nq - 1]
        box_err = torch.sum((q_box_xy - box_goal) ** 2, dim=-1)
        _, p_WB = kin.forward_kinematics(model, p, x[..., :nq])
        p_ee = p_WB[..., ee_body, :]
        box_pos = x[..., nq - 3 : nq]
        d = box_goal - q_box_xy
        push_dir = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-6)
        push_point = box_pos - torch.cat(
            [push_dir * (side / 2 + 0.055), torch.zeros_like(push_dir[..., :1])], dim=-1)
        ee_err = torch.sum((p_ee - push_point) ** 2, dim=-1)
        # Anti-smash shaping: box momentum and box speed beyond the push's.
        box_sp2 = torch.sum(x[..., nq + 10 : nq + 12] ** 2, dim=-1)
        return (
            10.0 * box_err
            + 5.0 * ee_err
            + 0.01 * torch.sum((x[..., :7] - q_arm) ** 2, dim=-1)
            + 1e-4 * torch.sum((u - tau_g) ** 2, dim=-1)
            + 1e-4 * torch.sum(x[..., nq:] ** 2, dim=-1)
            + 0.02 * torch.sum(x[..., nq + 7 : nq + 13] ** 2, dim=-1)
            + 1.0 * torch.clamp_min(box_sp2 - 0.25**2, 0.0)
        )

    def final_cost(p, x):
        return 400.0 * torch.sum((x[..., nq - 3 : nq - 1] - box_goal) ** 2, dim=-1)

    us0 = tau_g[None].expand(HORIZON, 7)
    lim = torch.tensor(iiwa.EFFORT_LIMITS, dtype=dtype, device=device)
    # Real-time-iteration schedule: a 4-iteration, 3-alpha cold-start solve
    # plans; one always-accept RTI step per period tracks it.
    first_options = ilqr.IlqrOptions(max_iters=4, alphas=(1.0, 0.25, 0.03))
    light_options = ilqr.IlqrOptions(rti=True)

    # Event-triggered plan guard: a plan whose own predicted rollout carries
    # the box more than 10 cm past the goal along the push direction has its
    # torque deviation from gravity compensation scaled by 0.3.
    guard_gamma, guard_overshoot = 0.3, 0.10

    def plan_guard(xs_plan, us_plan):
        b0 = xs_plan[:, 0, nq - 3 : nq - 1]
        d0 = box_goal - b0
        dir0 = d0 / (torch.linalg.vector_norm(d0, dim=-1, keepdim=True) + 1e-6)
        along = torch.einsum("bti,bi->bt", xs_plan[:, :, nq - 3 : nq - 1] - box_goal, dir0)
        peak = torch.amax(along, dim=-1)
        scale = torch.where(peak > guard_overshoot, torch.full_like(peak, guard_gamma),
                            torch.ones_like(peak))
        return tau_g + scale[:, None, None] * (us_plan - tau_g)

    def rollout(x0s):
        return mpc.ilqr_mpc_rollout(
            dsys_plan.g, running_cost, final_cost, params, x0s, us0, mpc_steps,
            dt=H, u_lower=-lim, u_upper=lim, options=light_options,
            sim_dynamics=dsys.g, first_options=first_options,
            # Catches finite but diverged float32 lanes (|x| ~ 1e16).
            x_bound=50.0, plan_guard=plan_guard,
        )

    gen = torch.Generator().manual_seed(seed)
    offsets = 0.03 * torch.randn((batch, 2), generator=gen, dtype=torch.float64)
    x0s = x0.expand(batch, nq + nv).clone()
    x0s[:, nq - 3 : nq - 1] += offsets.to(dtype=dtype, device=device)
    info = {
        "nq": nq, "nv": nv, "box_goal": box_goal, "horizon": HORIZON, "h": H,
        "model": model, "params": params, "scene": scene,
        "plan_step": dsys_plan.g, "plant_step": dsys.g,
        "running_cost": running_cost, "final_cost": final_cost, "plan_guard": plan_guard,
        "us0": us0, "u_limit": lim, "first_options": first_options,
        "light_options": light_options,
    }
    return rollout, x0s, info


def quality(res: mpc.MpcRolloutResult, x0s, info) -> dict:
    """How the controller did: lanes whose box ended closer to the goal than
    it started, the median final box error, and the guards' counts."""
    nq, goal = info["nq"], info["box_goal"]
    err0 = torch.linalg.vector_norm(x0s[:, nq - 3 : nq - 1] - goal, dim=-1)
    err1 = torch.linalg.vector_norm(res.xs[:, -1, nq - 3 : nq - 1] - goal, dim=-1)
    # The median of an even count is the mean of the two middle values, as
    # numpy's (torch.median would give the lower one).
    return {
        "progressing": int(torch.sum(err1 < err0)),
        "median_err": float(torch.quantile(err1.double(), 0.5)),
        "median_err0": float(torch.quantile(err0.double(), 0.5)),
        "finite": bool(torch.isfinite(res.xs).all()),
        "frozen_lanes": int(torch.sum(res.frozen > 0)),
        "frozen_steps": int(torch.sum(res.frozen)),
        "rejected_plans": int(torch.sum(res.plans_rejected)),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("drake_tpu_torch.bench runs on the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rollout, x0s, info = build_rollout(args.batch, args.steps, seed=args.seed)
    # Warm-up: two MPC steps load the libraries and their handles.
    warm, _, _ = build_rollout(args.batch, 2, seed=args.seed)
    warm(x0s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rollout(x0s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    q = quality(res, x0s, info)
    solves_per_s = args.batch * args.steps / wall
    print(json.dumps({
        "metric": "iiwa contact-implicit MPC solves/s (SAP, 13-dof arm+box, "
                  f"horizon={info['horizon']}, batch={args.batch}, f32, "
                  f"{q['progressing']}/{args.batch} progressing, "
                  f"median err {q['median_err']:.3f})",
        "value": solves_per_s,
        "unit": "solves/s",
        "progressing": q["progressing"],
        "median_err": q["median_err"],
        "device": torch.cuda.get_device_name(0),
        "card": card(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
