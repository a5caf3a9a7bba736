"""Collision scene: geometries on bodies, static pair lists, batched queries.

The PyTorch counterpart of ``drake_tpu/geometry/scene.py``.  The set of
candidate pairs and the number of contact points per pair are static, decided
when the scene is built; ``query`` returns fixed-size tensors whose leading
dimensions are the lanes of ``q``.  Each contact reports phi (signed
distance), the contact point p_W, the unit normal n_W pointing from geometry
B into geometry A, and the static body indices.

The port carries the pairs of the bench scene, box-halfspace (8 corner
contacts) and sphere-box (1 contact), and sphere-halfspace (1 contact), the
ball on the ground of the cloth bagging world.  Other pairs, hydroelastic
patches, meshes and collision filter managers raise ``NotImplementedError``
(ROADMAP.md, slice 5).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from drake_tpu_torch.geometry import shapes as sh
from drake_tpu_torch.multibody import kinematics as kin
from drake_tpu_torch.multibody.model import MultibodyModel, MultibodyParams
from drake_tpu_torch.utils.device import constant

# Geometry roles (the port's copy of drake_tpu/geometry/scene_graph.py's bits):
# only geometries with the proximity role enter collision pairs.
PROXIMITY = 1
ALL_ROLES = 7  # proximity, illustration, perception


@dataclasses.dataclass(frozen=True)
class CollisionGeometry:
    """A shape rigidly attached to a body (body -1 = world/anchored)."""

    name: str
    body: int
    shape: object
    R_BG: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    p_BG: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    stiffness: float = 1e6
    dissipation: float = 0.1  # SAP relaxation time tau_d [s]
    hydroelastic_modulus: Optional[float] = None  # not carried by the port
    friction: float = 1.0
    roles: int = ALL_ROLES


class ContactData(NamedTuple):
    """Fixed-size batch of potential point contacts."""

    phi: torch.Tensor  # (..., nc)
    p_W: torch.Tensor  # (..., nc, 3) contact point (midpoint of witnesses)
    n_W: torch.Tensor  # (..., nc, 3) unit normal, from B into A
    body_a: Tuple[int, ...]  # static body index per contact
    body_b: Tuple[int, ...]
    stiffness: torch.Tensor  # (nc,) combined stiffness
    dissipation: torch.Tensor  # (nc,)
    friction: torch.Tensor  # (nc,)


def _combine_materials(ga: CollisionGeometry, gb: CollisionGeometry):
    """Series-spring stiffness k = ka kb / (ka + kb), harmonic-mean friction,
    summed dissipation (as the reference)."""
    k = ga.stiffness * gb.stiffness / (ga.stiffness + gb.stiffness)
    mu = 2.0 * ga.friction * gb.friction / (ga.friction + gb.friction)
    d = ga.dissipation + gb.dissipation
    return k, d, mu


def _check_supported(ga: CollisionGeometry, gb: CollisionGeometry):
    if ga.hydroelastic_modulus is not None or gb.hydroelastic_modulus is not None:
        raise NotImplementedError(
            "hydroelastic contact is not ported yet (ROADMAP.md, slice 5)")
    kinds = frozenset((type(ga.shape), type(gb.shape)))
    if kinds not in _CONTACTS_PER_PAIR:
        names = "-".join(sorted(type(g.shape).__name__ for g in (ga, gb)))
        raise NotImplementedError(
            f"no contact handler for {names} in drake_tpu_torch: the port "
            "carries box-halfspace, sphere-box and sphere-halfspace (ROADMAP.md, slice 5)")


_CONTACTS_PER_PAIR = {
    frozenset((sh.Box, sh.HalfSpace)): 8,
    frozenset((sh.Sphere, sh.Box)): 1,
    frozenset((sh.Sphere, sh.HalfSpace)): 1,
}


def _contacts_per_pair(ga: CollisionGeometry, gb: CollisionGeometry) -> int:
    _check_supported(ga, gb)
    return _CONTACTS_PER_PAIR[frozenset((type(ga.shape), type(gb.shape)))]


@dataclasses.dataclass(frozen=True)
class CollisionScene:
    """Static description of all geometries and candidate pairs."""

    geometries: Tuple[CollisionGeometry, ...]
    pairs: Tuple[Tuple[int, int], ...]  # indices into geometries

    @staticmethod
    def build(
        geometries: Sequence[CollisionGeometry],
        exclude_same_body: bool = True,
        exclude: Sequence[Tuple[str, str]] = (),
        model: Optional[MultibodyModel] = None,
        filter_manager=None,
    ) -> "CollisionScene":
        """Enumerate candidate pairs (static broad phase).  With ``model``,
        pairs on parent-child adjacent bodies are filtered out."""
        if filter_manager is not None:
            raise NotImplementedError(
                "collision filter managers are not ported yet (ROADMAP.md, slice 5)")
        excl = {frozenset(e) for e in exclude}

        def adjacent(ba: int, bb: int) -> bool:
            if model is None or ba < 0 or bb < 0:
                return False
            return model.parent[ba] == bb or model.parent[bb] == ba

        pairs = []
        for i, j in itertools.combinations(range(len(geometries)), 2):
            gi, gj = geometries[i], geometries[j]
            if not (gi.roles & PROXIMITY and gj.roles & PROXIMITY):
                continue
            if exclude_same_body and gi.body == gj.body:
                continue
            if adjacent(gi.body, gj.body):
                continue
            if frozenset((gi.name, gj.name)) in excl:
                continue
            if isinstance(gi.shape, sh.HalfSpace) and isinstance(gj.shape, sh.HalfSpace):
                continue
            _check_supported(gi, gj)
            pairs.append((i, j))
        return CollisionScene(geometries=tuple(geometries), pairs=tuple(pairs))

    @property
    def num_contacts(self) -> int:
        return sum(_contacts_per_pair(self.geometries[i], self.geometries[j])
                   for i, j in self.pairs)

    def query(
        self,
        model: MultibodyModel,
        params: MultibodyParams,
        q,
        poses: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> ContactData:
        """All candidate contacts at configuration q (..., nq).  ``poses``
        may pass ``forward_kinematics(model, params, q)`` when the caller
        has it already."""
        R_WB, p_WB = poses if poses is not None else kin.forward_kinematics(model, params, q)
        batch = q.shape[:-1]

        def geom_pose(g: CollisionGeometry):
            R_BG = constant(tuple(map(tuple, np.asarray(g.R_BG, dtype=float).tolist())), q)
            p_BG = constant(tuple(np.asarray(g.p_BG, dtype=float).tolist()), q)
            if g.body < 0:
                return R_BG.expand(batch + (3, 3)), p_BG.expand(batch + (3,))
            R = R_WB[..., g.body, :, :]
            return R @ R_BG, p_WB[..., g.body, :] + (R @ p_BG.unsqueeze(-1)).squeeze(-1)

        phis, pws, nws = [], [], []
        body_a, body_b, ks, ds, mus = [], [], [], [], []
        for i, j in self.pairs:
            ga, gb = self.geometries[i], self.geometries[j]
            phi, p_W, n_W = _pair_contacts(ga, *geom_pose(ga), gb, *geom_pose(gb))
            m = phi.shape[-1]
            k, d, mu = _combine_materials(ga, gb)
            phis.append(phi)
            pws.append(p_W)
            nws.append(n_W)
            body_a += [ga.body] * m
            body_b += [gb.body] * m
            ks += [k] * m
            ds += [d] * m
            mus += [mu] * m
        if not phis:
            return ContactData(
                phi=q.new_zeros(batch + (0,)), p_W=q.new_zeros(batch + (0, 3)),
                n_W=q.new_zeros(batch + (0, 3)), body_a=(), body_b=(),
                stiffness=q.new_zeros(0), dissipation=q.new_zeros(0), friction=q.new_zeros(0),
            )
        return ContactData(
            phi=torch.cat(phis, dim=-1),
            p_W=torch.cat(pws, dim=-2),
            n_W=torch.cat(nws, dim=-2),
            body_a=tuple(body_a),
            body_b=tuple(body_b),
            stiffness=constant(tuple(ks), q),
            dissipation=constant(tuple(ds), q),
            friction=constant(tuple(mus), q),
        )


def _pair_contacts(ga, Ra, pa, gb, Rb, pb):
    """(phi (..., m), p_W (..., m, 3), n_W (..., m, 3)) with n_W pointing
    from B into A.  The order is normalised as in the reference: a halfspace,
    or a box facing a sphere, is made B and the normals flipped."""
    a, b = ga.shape, gb.shape
    if isinstance(a, sh.HalfSpace) or (isinstance(a, sh.Box) and isinstance(b, sh.Sphere)):
        phi, p_W, n_W = _pair_contacts(gb, Rb, pb, ga, Ra, pa)
        return phi, p_W, -n_W

    if isinstance(a, sh.Sphere) and isinstance(b, sh.Box):
        phi_c, n_W = sh.box_sdf_point(Rb, pb, b.size, pa)
        phi = phi_c - a.radius
        p_W = pa - n_W * (a.radius + 0.5 * phi)[..., None]
        return phi[..., None], p_W[..., None, :], n_W[..., None, :]

    if isinstance(a, sh.Sphere) and isinstance(b, sh.HalfSpace):
        phi_c, n_W = sh.halfspace_sdf_point(Rb, pb, pa)
        phi = phi_c - a.radius
        p_W = pa - n_W * (a.radius + 0.5 * phi)[..., None]
        return phi[..., None], p_W[..., None, :], n_W[..., None, :]

    if isinstance(a, sh.Box) and isinstance(b, sh.HalfSpace):
        corners = sh.box_corners(Ra, pa, a.size)
        phi, n_W = sh.halfspace_sdf_point(Rb, pb, corners)
        return phi, corners, n_W.expand(corners.shape)

    raise NotImplementedError(
        f"no contact handler for {type(a).__name__}-{type(b).__name__}")


def contact_frame(n_W):
    """Orthonormal contact frame columns [t1, t2, n] from unit normal n_W
    (..., 3): (..., 3, 3)."""
    ex = constant((1.0, 0.0, 0.0), n_W)
    ey = constant((0.0, 1.0, 0.0), n_W)
    ref = torch.where(torch.abs(n_W[..., 0:1]) < 0.9, ex, ey)
    t1 = torch.linalg.cross(n_W, ref, dim=-1)
    t1 = t1 / torch.clamp_min(torch.linalg.vector_norm(t1, dim=-1, keepdim=True), 1e-9)
    t2 = torch.linalg.cross(n_W, t1, dim=-1)
    return torch.stack([t1, t2, n_W], dim=-1)
