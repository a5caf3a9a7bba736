"""Collision shapes with analytic signed-distance functions.

The PyTorch counterpart of ``drake_tpu/geometry/shapes.py``: sphere, box,
capsule, cylinder, ellipsoid and halfspace, each with a closed-form signed
distance.  Every function takes the shape pose (R_WG (..., 3, 3), p_WG
(..., 3)) and points p_W of the same leading dimensions, (..., 3), or with
one more, (..., m, 3) for m points per pose, and returns (phi, normal_W);
phi < 0 is penetration.  ``Mesh`` and ``MeshSdf`` are declared so that a
scene can name them, but no contact pair takes them yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from drake_tpu_torch.utils.device import constant


@dataclasses.dataclass(frozen=True)
class Sphere:
    radius: float


@dataclasses.dataclass(frozen=True)
class Box:
    size: Tuple[float, float, float]  # full extents (lx, ly, lz)


@dataclasses.dataclass(frozen=True)
class Capsule:
    radius: float
    length: float  # cylinder segment length (along local z)


@dataclasses.dataclass(frozen=True)
class Cylinder:
    radius: float
    length: float


@dataclasses.dataclass(frozen=True)
class HalfSpace:
    """The region z <= 0 in the geometry frame (normal = +z)."""


@dataclasses.dataclass(frozen=True, eq=False)
class Ellipsoid:
    """Axis-aligned ellipsoid with semi-axes (a, b, c) in the geometry frame."""

    radii: tuple  # (a, b, c)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A point-sampled mesh: ``vertices`` (n, 3) in the geometry frame.  No
    contact pair of the port takes it yet (ROADMAP.md, the geometry group)."""

    vertices: np.ndarray
    faces: "np.ndarray" = None

    @property
    def num_vertices(self):
        return int(np.asarray(self.vertices).shape[0])


@dataclasses.dataclass(frozen=True, eq=False)
class MeshSdf(Mesh):
    """A mesh with a baked signed-distance grid.  No contact pair of the
    port takes it yet (ROADMAP.md, the geometry group)."""

    grid: "np.ndarray" = None
    origin: "np.ndarray" = None
    dx: float = 0.0


def _pose_for(R_WG, p_WG, p_W):
    """The pose broadcast against points p_W (one more leading dimension
    than p_WG when there are several points per pose)."""
    if p_W.dim() > p_WG.dim():
        return R_WG.unsqueeze(-3), p_WG.unsqueeze(-2)
    return R_WG, p_WG


def _to_local(R_WG, p_WG, p_W):
    """R_WG' (p_W - p_WG)."""
    return ((p_W - p_WG).unsqueeze(-2) @ R_WG).squeeze(-2)


def _to_world(R_WG, x_G):
    return (R_WG @ x_G.unsqueeze(-1)).squeeze(-1)


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def halfspace_sdf_point(R_WG, p_WG, p_W):
    """Signed distance of point(s) p_W to the halfspace surface; normal +z_G."""
    n_W = R_WG[..., :, 2]
    if p_W.dim() > n_W.dim():  # several points per pose
        n_W = n_W.unsqueeze(-2)
        p_WG = p_WG.unsqueeze(-2)
    phi = torch.sum((p_W - p_WG) * n_W, dim=-1)
    return phi, n_W


def box_sdf_point(R_WG, p_WG, size, p_W):
    """Signed distance of point p_W to a box and its normal_W: exact outside,
    the nearest face's distance (negative) inside."""
    R_WG, p_WG = _pose_for(R_WG, p_WG, p_W)
    half = constant(tuple(float(s) / 2.0 for s in size), p_W)
    p_G = _to_local(R_WG, p_WG, p_W)
    d = torch.abs(p_G) - half
    # max(d, 0) and the norm written so that their gradients are JAX's: the
    # norm's is NaN where outside = 0 (the point inside the box), and the
    # products carry that NaN through the selects below to the caller, as in
    # the reference (torch.clamp_min and torch.linalg.vector_norm would mask
    # it to 0).  Kept for parity; see ROADMAP.md, Queue 3.
    outside = d * (d > 0).to(d.dtype)
    dist_out = torch.sqrt(torch.sum(outside * outside, dim=-1))
    dist_in = torch.amax(d, dim=-1)
    phi = torch.where(dist_in > 0, dist_out, dist_in)
    n_out = outside * torch.sign(p_G) / torch.clamp_min(dist_out[..., None], 1e-12)
    face = torch.argmax(d, dim=-1)
    one_hot = torch.arange(3, device=p_W.device) == face[..., None]
    n_in = torch.sign(p_G) * one_hot.to(p_W.dtype)
    n_G = torch.where((dist_in > 0)[..., None], n_out, n_in)
    return phi, _to_world(R_WG, n_G)


def box_corners(R_WG, p_WG, size):
    """All 8 corners of a box in the world frame: (..., 8, 3)."""
    half = np.asarray(size, dtype=np.float64) / 2.0
    signs = [(sx, sy, sz) for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    corners_G = constant(tuple(tuple(float(v) for v in np.multiply(s, half)) for s in signs), R_WG)
    return p_WG.unsqueeze(-2) + corners_G @ R_WG.mT


def capsule_segment_points(R_WG, p_WG, length):
    """Endpoints of the capsule's core segment in the world frame."""
    z = R_WG[..., :, 2]
    return p_WG - 0.5 * length * z, p_WG + 0.5 * length * z


def closest_point_on_segment(a, b, p):
    ab = b - a
    t = torch.sum((p - a) * ab, dim=-1) / torch.clamp_min(torch.sum(ab * ab, dim=-1), 1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    return a + t[..., None] * ab


def sphere_sdf_point(R_WG, p_WG, radius, p_W):
    _, p_WG = _pose_for(R_WG, p_WG, p_W)
    d = p_W - p_WG
    dist = _norm(d)
    return dist - radius, d / torch.clamp_min(dist, 1e-9)[..., None]


def capsule_sdf_point(R_WG, p_WG, radius, length, p_W):
    R_WG, p_WG = _pose_for(R_WG, p_WG, p_W)
    a, b = capsule_segment_points(R_WG, p_WG, length)
    d = p_W - closest_point_on_segment(a, b, p_W)
    dist = _norm(d)
    return dist - radius, d / torch.clamp_min(dist, 1e-9)[..., None]


def cylinder_sdf_point(R_WG, p_WG, radius, length, p_W):
    """Exact signed distance and outward unit normal of a finite cylinder
    (axis = geometry z, flat caps)."""
    R_WG, p_WG = _pose_for(R_WG, p_WG, p_W)
    p_G = _to_local(R_WG, p_WG, p_W)
    r = torch.sqrt(p_G[..., 0] ** 2 + p_G[..., 1] ** 2 + 1e-18)
    dr = r - radius
    dz = torch.abs(p_G[..., 2]) - length / 2.0
    zero = torch.zeros_like(r)
    dr_out, dz_out = torch.maximum(dr, zero), torch.maximum(dz, zero)
    outside = torch.sqrt(dr_out**2 + dz_out**2)
    phi = torch.minimum(torch.maximum(dr, dz), zero) + outside
    # Radial and axial normals weighted by the active clamps outside; inside,
    # the nearer face wins.
    r_safe = torch.clamp_min(r, 1e-9)
    n_rad_G = torch.stack([p_G[..., 0] / r_safe, p_G[..., 1] / r_safe, zero], dim=-1)
    n_ax_G = torch.stack([zero, zero, torch.sign(p_G[..., 2])], dim=-1)
    one = torch.ones_like(r)
    radial_in = dr >= dz
    w_rad = torch.where(outside > 0.0, dr_out, torch.where(radial_in, one, zero))[..., None]
    w_ax = torch.where(outside > 0.0, dz_out, torch.where(radial_in, zero, one))[..., None]
    n_G = w_rad * n_rad_G + w_ax * n_ax_G
    n_G = n_G / torch.clamp_min(_norm(n_G)[..., None], 1e-9)
    return phi, _to_world(R_WG, n_G)


def ellipsoid_sdf_point(R_WG, p_WG, radii, p_W):
    """The scaled-space first-order distance estimate phi = k0 (k0 - 1) / k1
    (exact on the axes and at the surface) and the exact surface-gradient
    direction as the normal."""
    R_WG, p_WG = _pose_for(R_WG, p_WG, p_W)
    r = constant(tuple(float(x) for x in radii), p_W)
    p_G = _to_local(R_WG, p_WG, p_W)
    k0 = _norm(p_G / r)
    k1 = _norm(p_G / (r * r))
    phi = k0 * (k0 - 1.0) / torch.clamp_min(k1, 1e-9)
    n_G = p_G / (r * r)
    n_G = n_G / torch.clamp_min(_norm(n_G)[..., None], 1e-9)
    return phi, _to_world(R_WG, n_G)


def ellipsoid_support_point(R_WG, p_WG, radii, d_W):
    """Exact support point of the ellipsoid in the world direction d_W."""
    r = constant(tuple(float(x) for x in radii), d_W)
    d_G = (d_W.unsqueeze(-2) @ R_WG).squeeze(-2)
    s_G = (r * r) * d_G
    s_G = s_G / torch.clamp_min(_norm(r * d_G)[..., None], 1e-9)
    return p_WG + _to_world(R_WG, s_G)
