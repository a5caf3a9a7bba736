"""Coupled rigid (SAP) + MPM world stepping.

The PyTorch counterpart of ``drake_tpu/contact/coupled_plant.py``: one
coupled step runs the MPM substeps against the current rigid poses,
accumulating the particles' contact impulses, then the rigid SAP step with
the accumulated impulses over h applied as external spatial forces (the
one-way-lagged "async" two-way coupling of arXiv:2503.05046;
FinalizeExternalContactForces, deformable_driver.h:210-218).

Every tensor of a ``CoupledState`` may lead with the same lane axes: the
rigid state ``(..., nq + nv)`` and the particles ``(..., n, ...)``.  The port
carries every branch of ``step``: the explicit penalty
(``mpm/coupling.py``); the implicit grid contact on the tile pipeline
(``mpm/tiles_contact.py``, ``contact_model="implicit"`` with the default
``tiled=True``, and so "auto" on stiff contact): one group sort at the
start of the step, then resident substeps; the dense implicit grid contact
(``mpm/grid_contact.py``, ``tiled=False``); and the codimensional cloth
(``mpm/cloth.py``, with ``cloth_config`` set: the particles are then a
``ClothState``, penalty or implicit by the resolved contact model, whatever
``tiled`` says, as in the reference).  The tiled branch's ``dropped`` is the
reference's, the sum of the step's drops (held-out particles once, stale
ones in every substep, the closure's and the contact rows' overflow); in
the other branches it is the largest P2G count of the step's substeps (the
reference keeps the last one's, and its cloth state has none).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from drake_tpu_torch.contact import plant as cplant
from drake_tpu_torch.contact import sap
from drake_tpu_torch.geometry.scene import CollisionScene
from drake_tpu_torch.mpm import cloth as clothmod
from drake_tpu_torch.mpm import coupling as cpl
from drake_tpu_torch.mpm import grid_contact as gcmod
from drake_tpu_torch.mpm import solver as mpm
from drake_tpu_torch.mpm import tiles
from drake_tpu_torch.mpm import tiles_contact as tcmod
from drake_tpu_torch.multibody import kinematics as kin
from drake_tpu_torch.multibody.model import MultibodyModel, MultibodyParams
from drake_tpu_torch.utils.device import constant


class CoupledState(NamedTuple):
    """The world state: rigid x = [q; v] plus the MPM particles (a cloth's
    vertices where the world has a ``cloth_config``)."""

    rigid: torch.Tensor
    particles: Union[mpm.MpmState, clothmod.ClothState]


@dataclasses.dataclass(frozen=True)
class CoupledWorld:
    """Static description: rigid model and scene, MPM config, and which rigid
    collision geometries the particles touch (fields as the reference's)."""

    model: MultibodyModel
    scene: CollisionScene
    mpm_config: mpm.MpmConfig
    contact_params: cpl.MpmContactParams
    coupled_geometries: Tuple[int, ...]  # indices into scene.geometries
    substeps_per_step: int
    time_step: float
    sap_params: sap.SapParameters = sap.SapParameters()
    # "penalty", "implicit", or "auto": implicit where the penalty's own
    # stability bound binds (dt sqrt(stiffness) >= 1, half the bound
    # dt < ~2/sqrt(k)), penalty otherwise -- the reference's rule.
    contact_model: str = "auto"
    # With "implicit": the solve's GridContactParams (None: built from
    # contact_params, as the reference builds them) and the solve every
    # contact_query_frequency substeps (the others take no contact).
    grid_contact_params: Optional[object] = None
    contact_query_frequency: int = 1
    # With "implicit": the solve on the tile pipeline or, False, the
    # dense-grid solve.  The cloth branch reads neither this nor the two
    # fields above (it builds its solve from contact_params every substep).
    tiled: bool = True
    # A codimensional cloth (a ClothConfig) in place of the particles: every
    # substep applies the cloth's elastic vertex forces before P2G.
    cloth_config: Optional[clothmod.ClothConfig] = None

    def resolved_contact_model(self) -> str:
        """The branch ``step`` takes: "auto" resolved as the reference does."""
        if self.contact_model != "auto":
            return self.contact_model
        stiff = self.mpm_config.dt * math.sqrt(self.contact_params.stiffness) >= 1.0
        return "implicit" if stiff else "penalty"

    def rigid_geoms(self, params: MultibodyParams, q, v):
        """Current-pose ``RigidGeom``s of the coupled geometries, with the
        lanes of q (..., nq) and v (..., nv)."""
        joints = kin.joint_transforms(self.model, params, q)
        R_WB, p_WB = kin.forward_kinematics(self.model, params, q, joints)
        V_W = kin.world_velocities(self.model, params, q, v, joints)
        batch = q.shape[:-1]
        out = []
        for gi in self.coupled_geometries:
            g = self.scene.geometries[gi]
            R_BG = constant(tuple(map(tuple, np.asarray(g.R_BG, dtype=float).tolist())), q)
            p_BG = constant(tuple(np.asarray(g.p_BG, dtype=float).tolist()), q)
            if g.body < 0:
                R_WG, p_WG = R_BG.expand(batch + (3, 3)), p_BG.expand(batch + (3,))
                p_WBo = q.new_zeros(batch + (3,))
                V = q.new_zeros(batch + (6,))
            else:
                R = R_WB[..., g.body, :, :]
                R_WG = R @ R_BG
                p_WG = p_WB[..., g.body, :] + (R @ p_BG.unsqueeze(-1)).squeeze(-1)
                p_WBo = p_WB[..., g.body, :]
                V = V_W[..., g.body, :]
            out.append(cpl.RigidGeom(
                shape=g.shape, body_index=g.body, R_WG=R_WG, p_WG=p_WG, p_WB=p_WBo, V_WB=V,
            ))
        return out

    def step(self, params: MultibodyParams, state: CoupledState, tau_applied) -> CoupledState:
        """One coupled step of ``time_step`` seconds: the MPM substeps
        against the current rigid poses, then the rigid SAP step with the
        accumulated impulses / h as external spatial forces."""
        return self.step_with_impulses(params, state, tau_applied)[0]

    def step_with_impulses(self, params: MultibodyParams, state: CoupledState, tau_applied):
        """``step``, and the impulse sum of its substeps on each coupled
        geometry, (..., n_geoms, 6) [tau; f], for a caller that reports it."""
        model = self.model
        nq = model.num_positions
        q, v = state.rigid[..., :nq], state.rigid[..., nq:]
        h = self.time_step
        contact_model = self.resolved_contact_model()
        if contact_model not in ("penalty", "implicit"):
            raise ValueError(f"unknown contact_model {self.contact_model!r}")

        geoms = self.rigid_geoms(params, q, v)
        if self.cloth_config is not None:
            particles, impulses = clothmod.simulate_cloth(
                self.mpm_config, self.cloth_config, state.particles, self.substeps_per_step,
                geoms, self.contact_params, contact_model=contact_model,
            )
        elif contact_model == "implicit" and self.tiled:
            particles, impulses = self._tiled_implicit_substeps(state.particles, geoms)
        elif contact_model == "implicit":
            particles, impulses = self._dense_implicit_substeps(state.particles, geoms)
        else:
            particles, impulses = cpl.simulate_coupled(
                self.mpm_config, self.contact_params, state.particles, geoms,
                self.substeps_per_step,
            )
        with record_function("coupled.sap_step"):
            # Impulse accumulators -> external spatial forces on the bodies.
            fext = q.new_zeros(q.shape[:-1] + (model.num_bodies, 6))
            for k, gi in enumerate(self.coupled_geometries):
                body = self.scene.geometries[gi].body
                if body >= 0:
                    fext[..., body, :] += impulses[..., k, :] / h
            data, _ = sap.assemble(
                model, params, self.scene, q, v, tau_applied, h, self.sap_params,
                external_forces_W=fext,
            )
            sol = sap.solve_sap(data, data.v_star, self.sap_params)
            q_next = cplant.advance_positions(model, params, q, sol.v, h)
        nxt = CoupledState(rigid=torch.cat([q_next, sol.v], dim=-1), particles=particles)
        return nxt, impulses

    def _grid_contact_params(self) -> gcmod.GridContactParams:
        """``grid_contact_params``, or the parameters built from
        ``contact_params`` as the reference builds them."""
        if self.grid_contact_params is not None:
            return self.grid_contact_params
        cp = self.contact_params
        return gcmod.GridContactParams(
            stiffness=cp.stiffness, damping=cp.damping, friction=cp.friction,
            slip_velocity=cp.slip_velocity,
        )

    def _tiled_implicit_substeps(self, particles: mpm.MpmState, geoms):
        """The substeps of the tiled implicit branch
        (drake_tpu/contact/coupled_plant.py:155-199): one group sort, then
        resident substeps, the contact solve on the closure on substeps k
        with k % contact_query_frequency == 0 and the free one on the
        others.  Returns (particles with the step's summed ``dropped``,
        impulse sum (..., n_geoms, 6))."""
        gc_params = self._grid_contact_params()
        freq = max(1, self.contact_query_frequency)
        acc = particles.v.new_zeros(particles.x.shape[:-2] + (len(geoms), 6))
        ss = tiles.sort_to_tiles(self.mpm_config, particles)
        for k in range(self.substeps_per_step):
            if k % freq == 0:
                ss, imp = tcmod.resident_substep_contact(self.mpm_config, gc_params, ss, geoms)
                acc = acc + imp
            else:
                ss = tiles.resident_substep(self.mpm_config, ss)
        return tiles.tiles_to_state(ss, particles), acc

    def _dense_implicit_substeps(self, particles: mpm.MpmState, geoms):
        """The substeps of the dense implicit branch: the grid contact solve
        on substeps k with k % contact_query_frequency == 0, free transfers
        on the others.  Returns (particles, impulse sum (..., n_geoms, 6))."""
        gc_params = self._grid_contact_params()
        freq = max(1, self.contact_query_frequency)
        acc = particles.v.new_zeros(particles.x.shape[:-2] + (len(geoms), 6))
        dropped = particles.dropped
        for k in range(self.substeps_per_step):
            if k % freq == 0:
                particles, imp = gcmod.coupled_substep_implicit(
                    self.mpm_config, gc_params, particles, geoms)
                acc = acc + imp
            else:
                particles = mpm.mpm_substep(self.mpm_config, particles)
            dropped = particles.dropped if k == 0 else torch.maximum(
                dropped, particles.dropped)
        return particles.replace(dropped=dropped), acc

    def simulate(self, params, state: CoupledState, num_steps: int, tau=None):
        """`num_steps` coupled steps (zero actuation by default)."""
        if tau is None:
            tau = state.rigid.new_zeros(state.rigid.shape[:-1] + (self.model.num_velocities,))
        for _ in range(num_steps):
            state = self.step(params, state, tau)
        return state
