"""MPM <-> rigid-body two-way coupling on the card.

The PyTorch counterpart of ``drake_tpu/mpm/coupling.py``.  Each coupled
substep runs the MPM transfers (P2G and grid update by
``solver.grid_velocity``, then G2P), then the penalty
contact of every particle against the analytic SDF of each rigid geometry:

    f_n = (k (-phi) - d vn_rel) n        (clamped >= 0, phi < 0 only)
    f_t = -mu |f_n| vt_rel / max(|vt_rel|, eps)

applied to the particle; the reaction accumulates on the rigid body as a
spatial impulse [tau; f] about its origin.  The caller divides the impulse
sum of a rigid step by its length and applies it to the SAP step as
external spatial forces (``contact/coupled_plant.py``).

Every tensor may lead with a lane axis L: particle fields ``(L, n, ...)``,
a geometry's pose and velocity ``(L, ...)``, impulses ``(L, n_geoms, 6)``.
What differs from the reference, by design: ``coupled_substep`` records the
P2G's ``dropped`` in the state (the reference keeps the incoming count),
and ``simulate_coupled`` reports the largest count of its substeps, so that
a caller can assert that no substep dropped a particle.  The particle SDFs
of capsules, ellipsoids, cylinders and meshes are not ported yet (ROADMAP.md,
slice 5).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch
from torch.profiler import record_function

from drake_tpu_torch.geometry import shapes as sh
from drake_tpu_torch.mpm import solver as mpm


@dataclasses.dataclass(frozen=True)
class MpmContactParams:
    """Mirror of MpmConfigParams' contact block (cpu_mpm_model.h:17-26)."""

    stiffness: float = 1e5  # normal penalty [N/m per unit mass-point]
    damping: float = 10.0  # normal rate damping
    friction: float = 0.5
    slip_velocity: float = 1e-3  # regularization of Coulomb friction


class RigidGeom(NamedTuple):
    """A rigid collision geometry the particles can touch: its static shape
    and, per lane, its pose and the spatial velocity of its body (world
    frame, about the body origin p_WB).  body_index < 0 is anchored."""

    shape: object
    body_index: int
    R_WG: torch.Tensor  # (..., 3, 3)
    p_WG: torch.Tensor  # (..., 3)
    p_WB: torch.Tensor  # (..., 3) body origin (for the torque)
    V_WB: torch.Tensor  # (..., 6) [w; v] spatial velocity of the body


def _particle_sdf(geom: RigidGeom, x):
    """(phi (..., n), outward normal (..., n or 1, 3)) of particle positions
    x (..., n, 3) against the geometry (its pose one per lane)."""
    R = geom.R_WG.unsqueeze(-3)  # a particle axis for the pose
    p = geom.p_WG.unsqueeze(-2)
    if isinstance(geom.shape, sh.HalfSpace):
        return sh.halfspace_sdf_point(R, p, x)
    if isinstance(geom.shape, sh.Sphere):
        d = x - p
        dist = torch.linalg.vector_norm(d, dim=-1)
        n = d / torch.clamp_min(dist[..., None], 1e-9)
        return dist - geom.shape.radius, n
    if isinstance(geom.shape, sh.Box):
        return sh.box_sdf_point(R, p, geom.shape.size, x)
    raise NotImplementedError(
        f"particle contact with a {type(geom.shape).__name__} is not ported yet: "
        "drake_tpu_torch carries halfspace, sphere and box (ROADMAP.md, slice 5)"
    )


@record_function("coupling.contact")
def particle_rigid_contact(
    params: MpmContactParams,
    state: mpm.MpmState,
    geoms: Sequence[RigidGeom],
    dt: float,
):
    """Contact velocity correction and per-geometry rigid spatial impulses
    (contact_particle_to_grid_kernel / apply_contact_impulse_to_rigid_bodies
    roles, cuda_mpm_kernels.cuh:1043, 1617).
    Returns (new particle velocities, impulses (..., n_geoms, 6) [tau; f])."""
    x, v = state.x, state.v
    mass = state.mass[..., None]
    impulses = []
    for geom in geoms:
        phi, n = _particle_sdf(geom, x)
        # Rigid surface velocity at each particle.
        w = geom.V_WB[..., None, :3].expand(x.shape)
        r = x - geom.p_WB[..., None, :]
        v_rigid = geom.V_WB[..., None, 3:] + torch.linalg.cross(w, r, dim=-1)
        v_rel = v - v_rigid
        vn = torch.sum(v_rel * n, dim=-1)
        vt = v_rel - vn[..., None] * n
        fn_mag = torch.where(
            phi < 0.0,
            torch.clamp_min(params.stiffness * (-phi) - params.damping * vn, 0.0),
            0.0,
        )
        vt_norm = torch.linalg.vector_norm(vt, dim=-1)
        ft = (
            -params.friction
            * fn_mag[..., None]
            * vt
            / torch.clamp_min(vt_norm, params.slip_velocity)[..., None]
        )
        # Force per unit particle mass, scaled by the mass (the reference's
        # mass-weighted penalty keeps the stiffness scale-free).
        f = (fn_mag[..., None] * n + ft) * mass
        v = v + dt * f / mass
        # Reaction on the rigid body: the impulse -f dt at the particles.
        imp_lin = -dt * torch.sum(f, dim=-2)
        imp_tau = -dt * torch.sum(torch.linalg.cross(r, f, dim=-1), dim=-2)
        impulses.append(torch.cat([imp_tau, imp_lin], dim=-1))
    if not impulses:
        return v, v.new_zeros(x.shape[:-2] + (0, 6))
    return v, torch.stack(impulses, dim=-2)


@record_function("coupling.substep")
def coupled_substep(
    config: mpm.MpmConfig,
    contact: MpmContactParams,
    state: mpm.MpmState,
    geoms: Sequence[RigidGeom],
):
    """One MPM substep with rigid contact: (state, rigid impulses).  The
    state's ``dropped`` is this substep's P2G count."""
    grid_vel, dropped = mpm.grid_velocity(config, state)
    state = mpm.grid_to_particle(config, state, grid_vel)
    v_new, impulses = particle_rigid_contact(contact, state, geoms, config.dt)
    return state.replace(v=v_new, dropped=dropped), impulses


def simulate_coupled(
    config: mpm.MpmConfig,
    contact: MpmContactParams,
    state: mpm.MpmState,
    geoms: Sequence[RigidGeom],
    num_substeps: int,
):
    """`num_substeps` coupled substeps; the impulses add up over them.

    The caller divides the returned impulse sum by the rigid time step to
    get the external spatial forces of the SAP step
    (FinalizeExternalContactForces role).  The state's ``dropped`` is the
    largest count of the substeps."""
    acc = state.v.new_zeros(state.x.shape[:-2] + (len(geoms), 6))
    dropped = state.dropped
    for k in range(num_substeps):
        state, imp = coupled_substep(config, contact, state, geoms)
        acc = acc + imp
        dropped = state.dropped if k == 0 else torch.maximum(dropped, state.dropped)
    return state.replace(dropped=dropped), acc
