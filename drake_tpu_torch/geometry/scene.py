"""Collision scene: geometries on bodies, static pair lists, batched queries.

The PyTorch counterpart of ``drake_tpu/geometry/scene.py``.  The set of
candidate pairs and the number of contact points per pair are static, decided
when the scene is built; ``query`` returns fixed-size tensors whose leading
dimensions are the lanes of ``q``.  Each contact reports phi (signed
distance), the contact point p_W, the unit normal n_W pointing from geometry
B into geometry A, and the static body indices.

Every pair of the primitive shapes (sphere, box, capsule, cylinder,
ellipsoid, halfspace) has its point-contact handler, and a geometry with a
``hydroelastic_modulus`` carries a quadrature patch of weighted contact
points over its contact cap instead (the stand-in for Drake's
contact-surface meshes).  Meshes and ``MeshSdf`` shapes raise
``NotImplementedError`` (ROADMAP.md, the geometry group).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from drake_tpu_torch.geometry import box_collision as bc
from drake_tpu_torch.geometry import scene_graph
from drake_tpu_torch.geometry import shapes as sh
from drake_tpu_torch.multibody import kinematics as kin
from drake_tpu_torch.multibody.model import MultibodyModel, MultibodyParams
from drake_tpu_torch.utils.device import constant


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
    # Hydroelastic modulus E (Pa): when set, the pair renders a quadrature
    # patch whose points have stiffness E * A_i / depth (see _hydro_patch).
    hydroelastic_modulus: Optional[float] = None
    hydro_rings: int = 1  # quadrature rings (points = 1 + 6 + 12 + ...)
    # Patch radius of a cylinder or ellipsoid carrier (None: 0.7 x its depth).
    hydro_patch_radius: Optional[float] = None
    friction: float = 1.0
    roles: int = scene_graph.ALL_ROLES


class ContactData(NamedTuple):
    """Fixed-size batch of potential point contacts."""

    phi: torch.Tensor  # (..., nc)
    p_W: torch.Tensor  # (..., nc, 3) contact point (midpoint of witnesses)
    n_W: torch.Tensor  # (..., nc, 3) unit normal, from B into A
    body_a: Tuple[int, ...]  # static body index per contact
    body_b: Tuple[int, ...]
    # (nc,) combined stiffness; (..., nc) where a capsule's hydro patch
    # weighs its points by the pose.
    stiffness: torch.Tensor
    dissipation: torch.Tensor  # (nc,)
    friction: torch.Tensor  # (nc,)


def _combine_materials(ga: CollisionGeometry, gb: CollisionGeometry):
    """Series-spring stiffness k = ka kb / (ka + kb), harmonic-mean friction,
    summed dissipation (as the reference)."""
    k = ga.stiffness * gb.stiffness / (ga.stiffness + gb.stiffness)
    mu = 2.0 * ga.friction * gb.friction / (ga.friction + gb.friction)
    d = ga.dissipation + gb.dissipation
    return k, d, mu


# Point contacts per pair of shape names (a one-name set: both the same shape).
_TABLE = {
    frozenset(("Sphere", "HalfSpace")): 1,
    frozenset(("Sphere",)): 1,
    frozenset(("Sphere", "Box")): 1,
    frozenset(("Capsule", "HalfSpace")): 2,
    frozenset(("Capsule", "Sphere")): 1,
    frozenset(("Capsule",)): 1,
    frozenset(("Box", "HalfSpace")): 8,
    frozenset(("Box",)): 8,
    frozenset(("Capsule", "Box")): 3,
    frozenset(("Sphere", "Cylinder")): 1,
    frozenset(("Capsule", "Cylinder")): 2,
    frozenset(("Box", "Cylinder")): 8,
    frozenset(("Cylinder", "HalfSpace")): 6,
    frozenset(("Cylinder",)): 12,
    frozenset(("Sphere", "Ellipsoid")): 1,
    frozenset(("Capsule", "Ellipsoid")): 2,
    frozenset(("Box", "Ellipsoid")): 8,
    frozenset(("Ellipsoid", "HalfSpace")): 1,
}


def _check_supported(ga: CollisionGeometry, gb: CollisionGeometry):
    for g in (ga, gb):
        if isinstance(g.shape, sh.Mesh):
            kind = "a MeshSdf" if isinstance(g.shape, sh.MeshSdf) else "a Mesh"
            hydro = " (hydroelastic patch)" if g.hydroelastic_modulus is not None else ""
            raise NotImplementedError(
                f"{kind} in contact{hydro} ('{g.name}'): meshes are not ported yet "
                "(ROADMAP.md, the geometry group)")
    if _hydro_pair(ga, gb) is None and frozenset(
            (type(ga.shape).__name__, type(gb.shape).__name__)) not in _TABLE:
        raise ValueError(f"no contact handler for {type(ga.shape).__name__}-"
                         f"{type(gb.shape).__name__}")


def _contacts_per_pair(ga: CollisionGeometry, gb: CollisionGeometry) -> int:
    _check_supported(ga, gb)
    hp = _hydro_pair(ga, gb)
    if hp is not None:  # hydro takes precedence, as in _pair_contacts
        return _hydro_count(hp[0])
    return _TABLE[frozenset((type(ga.shape).__name__, type(gb.shape).__name__))]


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
        filter_manager: Optional[scene_graph.CollisionFilterManager] = None,
    ) -> "CollisionScene":
        """Enumerate candidate pairs (static broad phase).  With ``model``,
        pairs on parent-child adjacent bodies are filtered out;
        ``filter_manager`` applies collision filter declarations, and
        geometries without the proximity role enter no pair."""
        excl = {frozenset(e) for e in exclude}

        def adjacent(ba: int, bb: int) -> bool:
            if model is None or ba < 0 or bb < 0:
                return False
            return model.parent[ba] == bb or model.parent[bb] == ba

        pairs = []
        for i, j in itertools.combinations(range(len(geometries)), 2):
            gi, gj = geometries[i], geometries[j]
            if not (scene_graph.has_role(gi, scene_graph.PROXIMITY)
                    and scene_graph.has_role(gj, scene_graph.PROXIMITY)):
                continue
            if exclude_same_body and gi.body == gj.body:
                continue
            if adjacent(gi.body, gj.body):
                continue
            if frozenset((gi.name, gj.name)) in excl:
                continue
            if filter_manager is not None and filter_manager.is_filtered(gi.name, gj.name):
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
            # A pose a pair, not one a geometry: a shared pose would sum its
            # pairs' gradients before the product with R_WB, which rounds
            # otherwise (the MPC's Jacobians, and its float32 lanes, move).
            phi, p_W, n_W, k_scale = _pair_contacts(ga, *geom_pose(ga), gb, *geom_pose(gb))
            m = phi.shape[-1]
            k, d, mu = _combine_materials(ga, gb)
            hp = _hydro_pair(ga, gb)
            if hp is not None:
                k = _hydro_modulus(*hp)  # a point's stiffness: modulus x A_i / depth
            phis.append(phi)
            pws.append(p_W)
            nws.append(n_W)
            body_a += [ga.body] * m
            body_b += [gb.body] * m
            if k_scale is None:
                ks += [k] * m
            elif isinstance(k_scale, torch.Tensor):
                ks.append(k * k_scale)
            else:
                ks += [k * w for w in k_scale]
            ds += [d] * m
            mus += [mu] * m
        if not phis:
            return ContactData(
                phi=q.new_zeros(batch + (0,)), p_W=q.new_zeros(batch + (0, 3)),
                n_W=q.new_zeros(batch + (0, 3)), body_a=(), body_b=(),
                stiffness=q.new_zeros(0), dissipation=q.new_zeros(0), friction=q.new_zeros(0),
            )
        if all(not isinstance(k, torch.Tensor) for k in ks):
            stiffness = constant(tuple(ks), q)
        else:  # pose-dependent weights: one row of stiffness a lane
            stiffness = torch.cat([k.expand(batch + k.shape[-1:]) if isinstance(k, torch.Tensor)
                                   else q.new_full(batch + (1,), k) for k in ks], dim=-1)
        return ContactData(
            phi=torch.cat(phis, dim=-1),
            p_W=torch.cat(pws, dim=-2),
            n_W=torch.cat(nws, dim=-2),
            body_a=tuple(body_a),
            body_b=tuple(body_b),
            stiffness=stiffness,
            dissipation=constant(tuple(ds), q),
            friction=constant(tuple(mus), q),
        )


# ---------------------------------------------------------------------------
# Hydroelastic quadrature patches.
# ---------------------------------------------------------------------------

_SOFT_SHAPES = (sh.Sphere, sh.Box, sh.Capsule, sh.Cylinder, sh.Ellipsoid)
_SDF_SHAPES = (sh.HalfSpace, sh.Sphere, sh.Box, sh.Capsule, sh.Cylinder, sh.Ellipsoid)


def _hydro_pair(ga, gb):
    """(g_soft, g_other) if this pair renders a hydroelastic patch: the patch
    lives on the softer compliant geometry and integrates the
    elastic-foundation pressure against the other's signed distance."""

    def soft(g):
        return g.hydroelastic_modulus is not None and isinstance(g.shape, _SOFT_SHAPES)

    ok_a = soft(ga) and isinstance(gb.shape, _SDF_SHAPES)
    ok_b = soft(gb) and isinstance(ga.shape, _SDF_SHAPES)
    if ok_a and ok_b:
        return (ga, gb) if ga.hydroelastic_modulus <= gb.hydroelastic_modulus else (gb, ga)
    if ok_a:
        return ga, gb
    if ok_b:
        return gb, ga
    return None


def _other_sdf(g_other, R_o, p_o, x):
    """phi and outward normal of the other side at point(s) x."""
    s = g_other.shape
    if isinstance(s, sh.HalfSpace):
        phi, n = sh.halfspace_sdf_point(R_o, p_o, x)
        return phi, n.expand(x.shape)
    if isinstance(s, sh.Sphere):
        return sh.sphere_sdf_point(R_o, p_o, s.radius, x)
    if isinstance(s, sh.Box):
        return sh.box_sdf_point(R_o, p_o, s.size, x)
    if isinstance(s, sh.Cylinder):
        return sh.cylinder_sdf_point(R_o, p_o, s.radius, s.length, x)
    if isinstance(s, sh.Ellipsoid):
        return sh.ellipsoid_sdf_point(R_o, p_o, s.radii, x)
    return sh.capsule_sdf_point(R_o, p_o, s.radius, s.length, x)


def _hydro_modulus(g_soft, g_other) -> float:
    """Combined modulus: the series combination when both are compliant."""
    Ea, Eb = g_soft.hydroelastic_modulus, g_other.hydroelastic_modulus
    return Ea if Eb is None else Ea * Eb / (Ea + Eb)


def _hydro_patch(g_soft, R_s, p_s, g_other, R_o, p_o):
    """Quadrature patch on the soft geometry's surface against the other's
    signed distance: (phi (..., m), x (..., m, 3), n_W (..., m, 3), k_scale),
    k_scale the m weights A_i / depth (floats, or a (..., m) tensor for a
    capsule, whose end caps are clipped by the pose).  Normals point from
    the other geometry into the soft one.

    Sphere and capsule patches face the other geometry (a pi/4 cap or band
    about the other's normal at the soft centre); box patches are full face
    grids; cylinders and ellipsoids take a tangent-disk grid projected onto
    their surface by Newton steps on their own signed distance."""
    s = g_soft.shape
    rings = g_soft.hydro_rings
    samples = []  # (x (..., 3), k_scale float or (...) tensor)

    def cap_samples(center, r, n_dir, cap_rings):
        """Hex rings with exact band areas over a pi/4 half-angle cap."""
        F = contact_frame(n_dir)
        t1, t2 = F[..., :, 0], F[..., :, 1]
        alpha_max = math.pi / 4
        denom = cap_rings + 0.5
        edges = [alpha_max * (j + 0.5) / denom for j in range(cap_rings + 1)]
        A0 = 2 * math.pi * r * r * (1 - math.cos(edges[0]))
        out = [(center - r * n_dir, A0 / r)]
        for jr in range(1, cap_rings + 1):
            alpha = alpha_max * jr / denom
            band = 2 * math.pi * r * r * (math.cos(edges[jr - 1]) - math.cos(edges[jr]))
            npts = 6 * jr
            for m in range(npts):
                beta = 2 * math.pi * m / npts
                dv = (-n_dir * math.cos(alpha)
                      + (t1 * math.cos(beta) + t2 * math.sin(beta)) * math.sin(alpha))
                out.append((center + r * dv, band / npts / r))
        return out

    if isinstance(s, sh.Sphere):
        _, n_dir = _other_sdf(g_other, R_o, p_o, p_s)
        samples += cap_samples(p_s, s.radius, n_dir, rings)

    elif isinstance(s, sh.Box):
        half = [sz / 2.0 for sz in s.size]
        n = rings + 1
        locs, weights = [], []
        for axis in range(3):
            i, j = (axis + 1) % 3, (axis + 2) % 3
            A_cell = (2 * half[i]) * (2 * half[j]) / (n * n)
            for sgn in (-1.0, 1.0):
                for mi in range(n):
                    for mj in range(n):
                        loc = [0.0, 0.0, 0.0]
                        loc[axis] = sgn * half[axis]
                        loc[i] = -half[i] + (mi + 0.5) * 2 * half[i] / n
                        loc[j] = -half[j] + (mj + 0.5) * 2 * half[j] / n
                        locs.append(tuple(loc))
                        weights.append(A_cell / half[axis])
        x = p_s.unsqueeze(-2) + constant(tuple(locs), p_s) @ R_s.mT
        samples = [(x[..., k, :], w) for k, w in enumerate(weights)]

    elif isinstance(s, sh.Capsule):
        r, L = s.radius, s.length
        _, n_dir = _other_sdf(g_other, R_o, p_o, p_s)
        axis_W = R_s[..., :, 2]
        # The cylinder contacts sideways: n_dir less its axial component.
        side = -n_dir + axis_W * torch.sum(axis_W * n_dir, dim=-1, keepdim=True)
        side = side / torch.clamp_min(torch.linalg.vector_norm(side, dim=-1, keepdim=True), 1e-9)
        t_perp = torch.linalg.cross(axis_W, side, dim=-1)
        phi_max = math.pi / 4
        n_ax, n_circ = rings + 2, 2 * rings + 1
        dphi = 2 * phi_max / n_circ
        A_cell = (L / n_ax) * (r * dphi)
        for ia in range(n_ax):
            z = -L / 2 + (ia + 0.5) * L / n_ax
            for ic in range(n_circ):
                phi_c = -phi_max + (ic + 0.5) * dphi
                dv = side * math.cos(phi_c) + t_perp * math.sin(phi_c)
                samples.append((p_s + axis_W * z + r * dv, A_cell / r))
        # End caps clipped to the axis-outward hemisphere (the band covers the
        # inward half); boundary points get half weight.
        tol = 0.05 * r
        for endsgn in (-1.0, 1.0):
            e = p_s + endsgn * axis_W * (L / 2)
            for x, k_scale in cap_samples(e, r, n_dir, max(1, rings // 2)):
                comp = torch.sum((x - e) * (endsgn * axis_W), dim=-1)
                one = torch.ones_like(comp)
                w_clip = torch.where(comp > tol, one, torch.where(comp < -tol, 0 * one, 0.5 * one))
                samples.append((x, k_scale * w_clip))

    else:  # a cylinder or an ellipsoid: the SDF-projected tangent disk
        h_depth = _hydro_depth(g_soft)
        rho = (g_soft.hydro_patch_radius if g_soft.hydro_patch_radius is not None
               else 0.7 * h_depth)

        def project(x, steps=3):
            for _ in range(steps):
                phi, nrm = _other_sdf(g_soft, R_s, p_s, x)
                x = x - phi[..., None] * nrm
            return x

        seed = project(p_o, steps=5)
        _, m_n = _other_sdf(g_soft, R_s, p_s, seed)
        F = contact_frame(m_n)
        t1, t2 = F[..., :, 0], F[..., :, 1]
        denom = rings + 0.5
        samples.append((seed, math.pi * (rho * 0.5 / denom) ** 2 / h_depth))
        for jr in range(1, rings + 1):
            r_j = rho * jr / denom
            r_lo = rho * (jr - 0.5) / denom
            r_hi = rho * (jr + 0.5) / denom if jr < rings else rho
            band = math.pi * (r_hi**2 - r_lo**2)
            npts = 6 * jr
            for mi in range(npts):
                beta = 2 * math.pi * mi / npts
                x0 = seed + r_j * (t1 * math.cos(beta) + t2 * math.sin(beta))
                samples.append((project(x0), band / npts / h_depth))

    x = torch.stack([xs for xs, _ in samples], dim=-2)
    weights = [w for _, w in samples]
    if any(isinstance(w, torch.Tensor) for w in weights):
        k_scale = torch.stack([w if isinstance(w, torch.Tensor) else torch.full_like(x[..., 0, 0], w)
                               for w in weights], dim=-1)
    else:
        k_scale = weights
    phi, n_W = _other_sdf(g_other, R_o, p_o, x)
    return phi, x, n_W, k_scale


def _hydro_depth(g_soft) -> float:
    """Foundation depth of a carrier: the elastic-foundation pressure is
    p = E * phi / depth."""
    s = g_soft.shape
    if isinstance(s, (sh.Sphere, sh.Capsule)):
        return float(s.radius)
    if isinstance(s, sh.Cylinder):
        return float(min(s.radius, s.length / 2.0))
    if isinstance(s, sh.Ellipsoid):
        return float(min(s.radii))
    if isinstance(s, sh.Box):
        return float(min(s.size) / 2.0)
    raise ValueError(f"no hydro foundation depth for {type(s).__name__}")


def _hydro_count(g_soft) -> int:
    """Static contact count of a hydro patch (must match _hydro_patch)."""
    r = g_soft.hydro_rings
    if isinstance(g_soft.shape, sh.Box):
        return 6 * (r + 1) ** 2
    if isinstance(g_soft.shape, sh.Capsule):
        rc = max(1, r // 2)
        return (r + 2) * (2 * r + 1) + 2 * (1 + 3 * rc * (rc + 1))
    return 1 + 3 * r * (r + 1)


# ---------------------------------------------------------------------------
# Point-contact handlers.
# ---------------------------------------------------------------------------


def _cylinder_rim_points(R_WG, p_WG, radius, length, toward_W):
    """6 rim points (3 a cap, at the support direction and +-120 deg about
    the axis) biased toward ``toward_W``: (..., 6, 3)."""
    axis = R_WG[..., :, 2]
    d = toward_W - torch.sum(toward_W * axis, dim=-1, keepdim=True) * axis
    nd = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    u = torch.where(nd > 1e-9, d / torch.clamp_min(nd, 1e-9), R_WG[..., :, 0])
    v = torch.linalg.cross(axis, u, dim=-1)
    pts = []
    for s in (-0.5, 0.5):
        c = p_WG + s * length * axis
        for th in (0.0, 2.0944, -2.0944):  # 0, +-120 deg
            pts.append(c + radius * (math.cos(th) * u + math.sin(th) * v))
    return torch.stack(pts, dim=-2)


def _one(phi, p_W, n_W):
    return phi[..., None], p_W[..., None, :], n_W[..., None, :]


def _inflate(phi_c, n_W, centres, radius):
    """Point contacts of a sphere (or swept sphere) of `radius` about
    `centres`, from the other side's distance phi_c and normal n_W there."""
    phi = phi_c - radius
    return phi, centres - n_W * (radius + 0.5 * phi)[..., None], n_W


def _pair_contacts(ga, Ra, pa, gb, Rb, pb):
    """(phi (..., m), p_W (..., m, 3), n_W (..., m, 3), k_scale) with n_W
    pointing from B into A; k_scale (None for point pairs) weighs a hydro
    patch's stiffness.  The order is normalised as in the reference: the
    'larger' or static shape is made B, the normals flipped."""
    a, b = ga.shape, gb.shape
    hp = _hydro_pair(ga, gb)
    if hp is not None:
        g_soft, g_other = hp
        if g_soft is ga:
            return _hydro_patch(ga, Ra, pa, gb, Rb, pb)
        # Patch normals point into the soft geometry, here B.
        phi, p_W, n_W, k_scale = _hydro_patch(gb, Rb, pb, ga, Ra, pa)
        return phi, p_W, -n_W, k_scale
    if (isinstance(a, sh.HalfSpace)
            or (isinstance(a, sh.Box) and isinstance(b, (sh.Sphere, sh.Capsule)))
            or (isinstance(a, sh.Sphere) and isinstance(b, sh.Capsule))
            or (isinstance(a, (sh.Cylinder, sh.Ellipsoid))
                and isinstance(b, (sh.Sphere, sh.Capsule, sh.Box)))):
        phi, p_W, n_W, _ = _pair_contacts(gb, Rb, pb, ga, Ra, pa)
        return phi, p_W, -n_W, None
    return (*_point_pair(a, Ra, pa, b, Rb, pb), None)


def _point_pair(a, Ra, pa, b, Rb, pb):
    if isinstance(a, sh.Box) and isinstance(b, sh.Box):
        return bc.box_box_contacts(Ra, pa, a.size, Rb, pb, b.size)
    if isinstance(a, sh.Capsule) and isinstance(b, sh.Box):
        return bc.capsule_box_contacts(Ra, pa, a.radius, a.length, Rb, pb, b.size)
    if isinstance(a, sh.Sphere) and isinstance(b, sh.HalfSpace):
        phi_c, n_W = sh.halfspace_sdf_point(Rb, pb, pa)
        return _one(*_inflate(phi_c, n_W, pa, a.radius))
    if isinstance(a, sh.Sphere) and isinstance(b, sh.Ellipsoid):
        phi_c, n_W = sh.ellipsoid_sdf_point(Rb, pb, b.radii, pa)
        return _one(*_inflate(phi_c, n_W, pa, a.radius))
    if isinstance(a, sh.Capsule) and isinstance(b, (sh.Ellipsoid, sh.Cylinder, sh.HalfSpace)):
        ends = torch.stack(sh.capsule_segment_points(Ra, pa, a.length), dim=-2)
        if isinstance(b, sh.Ellipsoid):
            phi_c, n_W = sh.ellipsoid_sdf_point(Rb, pb, b.radii, ends)
        elif isinstance(b, sh.Cylinder):
            phi_c, n_W = sh.cylinder_sdf_point(Rb, pb, b.radius, b.length, ends)
        else:
            phi_c, n_W = sh.halfspace_sdf_point(Rb, pb, ends)
            n_W = n_W.expand(ends.shape)
        return _inflate(phi_c, n_W, ends, a.radius)
    if isinstance(a, sh.Box) and isinstance(b, (sh.Ellipsoid, sh.Cylinder, sh.HalfSpace)):
        corners = sh.box_corners(Ra, pa, a.size)
        if isinstance(b, sh.Ellipsoid):
            phi, n_W = sh.ellipsoid_sdf_point(Rb, pb, b.radii, corners)
        elif isinstance(b, sh.Cylinder):
            # Curved face against a box face resolves through the corners.
            phi, n_W = sh.cylinder_sdf_point(Rb, pb, b.radius, b.length, corners)
        else:
            phi, n_W = sh.halfspace_sdf_point(Rb, pb, corners)
            n_W = n_W.expand(corners.shape)
        return phi, corners, n_W
    if isinstance(a, sh.Ellipsoid) and isinstance(b, sh.HalfSpace):
        # The exact support point against the plane.
        p_sup = sh.ellipsoid_support_point(Ra, pa, a.radii, -Rb[..., :, 2])
        phi, n_W = sh.halfspace_sdf_point(Rb, pb, p_sup)
        return _one(phi, p_sup, n_W)
    if isinstance(a, sh.Sphere) and isinstance(b, sh.Cylinder):
        phi_c, n_W = sh.cylinder_sdf_point(Rb, pb, b.radius, b.length, pa)
        return _one(*_inflate(phi_c, n_W, pa, a.radius))
    if isinstance(a, sh.Cylinder) and isinstance(b, sh.HalfSpace):
        rims = _cylinder_rim_points(Ra, pa, a.radius, a.length, -Rb[..., :, 2])
        phi, n_W = sh.halfspace_sdf_point(Rb, pb, rims)
        return phi, rims, n_W.expand(rims.shape)
    if isinstance(a, sh.Cylinder) and isinstance(b, sh.Cylinder):
        # Rim points of each against the other's distance, both ways.
        rims_a = _cylinder_rim_points(Ra, pa, a.radius, a.length, pb - pa)
        phi_a, n_a = sh.cylinder_sdf_point(Rb, pb, b.radius, b.length, rims_a)
        rims_b = _cylinder_rim_points(Rb, pb, b.radius, b.length, pa - pb)
        phi_b, n_b = sh.cylinder_sdf_point(Ra, pa, a.radius, a.length, rims_b)
        return (torch.cat([phi_a, phi_b], dim=-1), torch.cat([rims_a, rims_b], dim=-2),
                torch.cat([n_a, -n_b], dim=-2))
    if isinstance(a, sh.Sphere) and isinstance(b, sh.Sphere):
        return _one(*_sphere_sphere(pa, a.radius, pb, b.radius))
    if isinstance(a, sh.Sphere) and isinstance(b, sh.Box):
        phi_c, n_W = sh.box_sdf_point(Rb, pb, b.size, pa)
        return _one(*_inflate(phi_c, n_W, pa, a.radius))
    if isinstance(a, sh.Capsule) and isinstance(b, sh.Sphere):
        e1, e2 = sh.capsule_segment_points(Ra, pa, a.length)
        c = sh.closest_point_on_segment(e1, e2, pb)
        return _one(*_sphere_sphere(c, a.radius, pb, b.radius))
    if isinstance(a, sh.Capsule) and isinstance(b, sh.Capsule):
        a1, a2 = sh.capsule_segment_points(Ra, pa, a.length)
        b1, b2 = sh.capsule_segment_points(Rb, pb, b.length)
        # Closest points of the segments by 3 sweeps of alternating projection.
        ca = 0.5 * (a1 + a2)
        for _ in range(3):
            cb = sh.closest_point_on_segment(b1, b2, ca)
            ca = sh.closest_point_on_segment(a1, a2, cb)
        return _one(*_sphere_sphere(ca, a.radius, cb, b.radius))
    raise ValueError(f"no contact handler for {type(a).__name__}-{type(b).__name__}")


def _sphere_sphere(ca, ra, cb, rb):
    d = ca - cb
    dist = torch.linalg.vector_norm(d, dim=-1)
    n_W = d / torch.clamp_min(dist, 1e-9)[..., None]
    phi = dist - ra - rb
    return phi, cb + n_W * (rb + 0.5 * phi)[..., None], n_W


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
