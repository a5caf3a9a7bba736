"""Codimensional (cloth) MLS-MPM on PyTorch + CUDA.

The PyTorch counterpart of ``drake_tpu/mpm/cloth.py``, function for
function; the fork's cloth pipeline it re-derives is gpu_mpm/
cuda_mpm_kernels.cuh:184 calc_fem_state_and_force (per-face QR-based tangent
deformation, fixed-corotated in-plane energy after Jiang et al. 2017).

- Total-Lagrangian faces: the cloth keeps its triangle mesh; each face's
  deformation F = d_world Dm^{-1} (3x2) comes from the vertex positions every
  substep.  The elastic vertex forces are -dE/dx by ``torch.autograd.grad``
  of the total energy, the counterpart of the reference's ``jax.grad``.
- The vertices are MPM particles (F = I, volume 0: no volumetric stress)
  that take the elastic kick, then go through the grid: on the card P2G and
  grid update are K2 and K1 from block windows, with the node mass on the
  implicit branch (``grid_contact.coupled_substep_implicit``); the penalty
  branch is ``coupling.coupled_substep``.  The G2P is the 27-tap stencil.

Lanes: ``x``, ``v`` and ``C`` may lead with lane axes ``(..., nv, 3[, 3])``
and ``mass`` ``(..., nv)``; ``faces (nf, 3)``, ``Dm_inv (nf, 2, 2)`` and
``area (nf,)`` are rest data that every lane shares.  What differs from the
reference, by design: ``ClothState`` carries ``dropped``, the P2G count of
the last substep, or of the largest of a run of substeps
(``simulate_cloth``); the reference's cloth state has no such field.  The
builders make their arrays with numpy exactly as the reference does, so
both packages start from the same values; ``faces`` is int64 here (torch's
index type), int32 there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from drake_tpu_torch.mpm import coupling as cpl
from drake_tpu_torch.mpm import grid_contact as gcmod
from drake_tpu_torch.mpm import solver as mpm
from drake_tpu_torch.utils.device import resolve_device
from drake_tpu_torch.utils.struct import tensor_dataclass


@dataclasses.dataclass(frozen=True)
class ClothConfig:
    """Cloth material constants (the reference's fields and defaults,
    settings.h:71-126 values)."""

    youngs_modulus: float = 4e5
    poisson_ratio: float = 0.3
    density: float = 2000.0  # per area-thickness volume
    thickness: float = 1e-3
    normal_stiffness: float = 1e3  # K: normal-compression penalty

    @property
    def lame_2d(self):
        E, nu = self.youngs_modulus, self.poisson_ratio
        mu = E / (2 * (1 + nu))
        lam = E * nu / ((1 + nu) * (1 - nu))  # plane stress
        return mu, lam


@tensor_dataclass
class ClothState:
    """Vertex particle state plus face rest data."""

    x: torch.Tensor  # (..., nv, 3) vertex positions
    v: torch.Tensor  # (..., nv, 3) vertex velocities
    C: torch.Tensor  # (..., nv, 3, 3) APIC affine field
    mass: torch.Tensor  # (..., nv)
    faces: torch.Tensor  # (nf, 3) int64 vertex indices (static topology)
    Dm_inv: torch.Tensor  # (nf, 2, 2) rest tangent-matrix inverse
    area: torch.Tensor  # (nf,) rest areas
    # Particles dropped by the blocked P2G's static capacities (int32, one
    # per lane); left out, it is zero.
    dropped: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.dropped is None:
            zero = torch.zeros(self.x.shape[:-2], dtype=torch.int32, device=self.x.device)
            object.__setattr__(self, "dropped", zero)


def make_grid_cloth(
    config: ClothConfig,
    nx: int,
    ny: int,
    origin=(0.3, 0.3, 0.7),
    size=(0.4, 0.4),
    dtype: torch.dtype = torch.float32,
    orientation: str = "xy",
    device: Union[str, torch.device, None] = None,
) -> ClothState:
    """A regular nx x ny cloth patch (the RegisterMpmCloth sample maker),
    horizontal ("xy") or a vertical drape ("xz").  ``device=None`` is the
    current CUDA device."""
    xs = np.linspace(0, size[0], nx)
    ys = np.linspace(0, size[1], ny)
    if orientation == "xy":
        pts = np.stack(
            [np.repeat(xs, ny) + origin[0], np.tile(ys, nx) + origin[1],
             np.full(nx * ny, origin[2])],
            axis=1,
        )
    else:  # "xz" vertical drape
        pts = np.stack(
            [np.repeat(xs, ny) + origin[0], np.full(nx * ny, origin[1]),
             np.tile(ys, nx) + origin[2]],
            axis=1,
        )
    faces = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a = i * ny + j
            b = (i + 1) * ny + j
            c = i * ny + j + 1
            d = (i + 1) * ny + j + 1
            faces.append([a, b, c])
            faces.append([b, d, c])
    faces = np.asarray(faces, np.int32)
    return make_cloth_from_mesh(config, pts, faces, dtype, device=device)


def make_cloth_from_mesh(
    config: ClothConfig,
    pts,
    faces,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device, None] = None,
) -> ClothState:
    """Register an arbitrary triangle mesh as a cloth (RegisterMpmCloth,
    deformable_model.h:68): the rest tangent basis, rest areas and lumped
    vertex masses, computed in float64 by numpy as the reference computes
    them, then cast once."""
    device = resolve_device(device)
    pts = np.asarray(pts, np.float64)
    faces = np.asarray(faces, np.int32)

    # Rest tangent basis per face (2D in the face plane).
    p = pts[faces]
    d1 = p[:, 1] - p[:, 0]
    d2 = p[:, 2] - p[:, 0]
    e1 = d1 / np.linalg.norm(d1, axis=1, keepdims=True)
    n = np.cross(d1, d2)
    area = 0.5 * np.linalg.norm(n, axis=1)
    n = n / np.linalg.norm(n, axis=1, keepdims=True)
    e2 = np.cross(n, e1)
    Dm = np.stack(
        [
            np.stack([np.sum(d1 * e1, 1), np.sum(d2 * e1, 1)], axis=1),
            np.stack([np.sum(d1 * e2, 1), np.sum(d2 * e2, 1)], axis=1),
        ],
        axis=1,
    )  # (nf, 2, 2)
    Dm_inv = np.linalg.inv(Dm)

    # Lumped vertex masses from face areas.
    m_face = config.density * config.thickness * area
    mass = np.zeros(len(pts))
    for k in range(3):
        np.add.at(mass, faces[:, k], m_face / 3.0)

    nv = len(pts)
    kw = dict(dtype=dtype, device=device)
    return ClothState(
        x=torch.as_tensor(pts, **kw),
        v=torch.zeros((nv, 3), **kw),
        C=torch.zeros((nv, 3, 3), **kw),
        mass=torch.as_tensor(mass, **kw),
        faces=torch.as_tensor(faces, dtype=torch.int64, device=device),
        Dm_inv=torch.as_tensor(Dm_inv, **kw),
        area=torch.as_tensor(area, **kw),
        dropped=torch.zeros((), dtype=torch.int32, device=device),
    )


def merge_cloths(*cloths: ClothState) -> ClothState:
    """Concatenate cloth patches into one state (face indices re-offset):
    one particle set sharing the background grid, which handles their
    mutual contact."""
    offsets = np.cumsum([0] + [c.x.shape[-2] for c in cloths[:-1]])
    return ClothState(
        x=torch.cat([c.x for c in cloths], dim=-2),
        v=torch.cat([c.v for c in cloths], dim=-2),
        C=torch.cat([c.C for c in cloths], dim=-3),
        mass=torch.cat([c.mass for c in cloths], dim=-1),
        faces=torch.cat([c.faces + int(o) for c, o in zip(cloths, offsets)]),
        Dm_inv=torch.cat([c.Dm_inv for c in cloths]),
        area=torch.cat([c.area for c in cloths]),
    )


def face_deformation(x, faces, Dm_inv):
    """F (..., nf, 3, 2): world tangent matrix times rest inverse."""
    p = x[..., faces, :]  # (..., nf, 3, 3)
    ds = torch.stack([p[..., 1, :] - p[..., 0, :], p[..., 2, :] - p[..., 0, :]], dim=-1)
    return ds @ Dm_inv


def _qr_3x2(F):
    """Thin QR of (..., 3, 2) by Gram-Schmidt: (Q (..., 3, 2), R (..., 2, 2))."""
    d1 = F[..., 0]
    d2 = F[..., 1]
    r11 = torch.linalg.vector_norm(d1, dim=-1)
    q1 = d1 / torch.clamp_min(r11, 1e-12)[..., None]
    r12 = torch.sum(q1 * d2, dim=-1)
    u2 = d2 - r12[..., None] * q1
    r22 = torch.linalg.vector_norm(u2, dim=-1)
    q2 = u2 / torch.clamp_min(r22, 1e-12)[..., None]
    Q = torch.stack([q1, q2], dim=-1)
    zero = torch.zeros_like(r11)
    R = torch.stack(
        [torch.stack([r11, r12], dim=-1), torch.stack([zero, r22], dim=-1)], dim=-2
    )
    return Q, R


def elastic_energy(config: ClothConfig, x, faces, Dm_inv, area):
    """In-plane elastic energy of each lane, (...): the fixed corotated energy
    on the QR's 2x2 R factor (same singular values as F),
    mu sum (s_i - 1)^2 + lam/2 (det R - 1)^2, by invariants only:
    sum (s_i - 1)^2 = ||F||^2 - 2 (s1 + s2) + 2 with
    s1 + s2 = sqrt(||F||^2 + 2 det) (det >= 0 by QR).  The clamp under the
    sqrt keeps the gradient finite at the rest state."""
    mu, lam = config.lame_2d
    F = face_deformation(x, faces, Dm_inv)
    _, R = _qr_3x2(F)
    a, b = R[..., 0, 0], R[..., 0, 1]
    d = R[..., 1, 1]
    t1 = a * a + b * b + d * d
    det = a * d
    s_sum = torch.sqrt(torch.clamp_min(t1 + 2 * det, 1e-12))
    psi = mu * (t1 - 2.0 * s_sum + 2.0) + 0.5 * lam * (det - 1.0) ** 2
    vol = area * config.thickness
    return torch.sum(psi * vol, dim=-1)


@record_function("cloth.forces")
def vertex_forces(config: ClothConfig, state: ClothState):
    """Elastic vertex forces -dE/dx (..., nv, 3) by autograd of the energy
    summed over lanes (each lane's forces are its own energy's gradient).
    Works under a caller's ``no_grad``; no graph reaches the caller.  The
    backward runs on the calling thread rather than on autograd's thread for
    the device, so that the profiler ties its kernels to this range."""
    with torch.enable_grad(), torch.autograd.set_multithreading_enabled(False):
        x = state.x.detach().requires_grad_(True)
        energy = elastic_energy(config, x, state.faces, state.Dm_inv, state.area).sum()
        (grad,) = torch.autograd.grad(energy, x)
    return -grad


def _to_mpm_state(grid_config: mpm.MpmConfig, cloth: ClothState, f_ext) -> mpm.MpmState:
    """The cloth vertices as MPM particles, with the force kick applied:
    F = I and volume 0 (no volumetric stress for cloth)."""
    v_kicked = cloth.v + grid_config.dt * f_ext / cloth.mass[..., None]
    n = cloth.x.shape[-2]
    lead = cloth.x.shape[:-2]
    eye = torch.eye(3, dtype=cloth.x.dtype, device=cloth.x.device)
    return mpm.MpmState(
        x=cloth.x,
        v=v_kicked,
        F=eye.expand(lead + (n, 3, 3)),
        C=cloth.C,
        volume=cloth.x.new_zeros(lead + (n,)),
        mass=cloth.mass,
        dropped=cloth.dropped,
    )


@record_function("cloth.substep")
def cloth_substep(
    grid_config: mpm.MpmConfig,
    cloth_config: ClothConfig,
    state: ClothState,
    rigid_geoms: Sequence[cpl.RigidGeom] = (),
    contact_params: Optional[cpl.MpmContactParams] = None,
    contact_model: str = "penalty",
) -> Tuple[ClothState, torch.Tensor]:
    """One cloth MPM substep: elastic kick -> P2G -> grid -> G2P -> advect.

    Returns (state, rigid impulses (..., n_geoms, 6)); the state's
    ``dropped`` is this substep's P2G count.  contact_model="implicit" (with
    geometries) solves rigid contact by the implicit grid contact Newton,
    its parameters built from `contact_params` as the reference builds them
    (it reads no other solver setting, and solves every substep); anything
    else takes the explicit per-particle penalty after G2P."""
    f_el = vertex_forces(cloth_config, state)
    p = _to_mpm_state(grid_config, state, f_el)
    if rigid_geoms and contact_model == "implicit":
        kw = {}
        if contact_params is not None:
            kw = dict(stiffness=contact_params.stiffness, damping=contact_params.damping,
                      friction=contact_params.friction,
                      slip_velocity=contact_params.slip_velocity)
        p, impulses = gcmod.coupled_substep_implicit(
            grid_config, gcmod.GridContactParams(**kw), p, rigid_geoms)
    else:
        p, impulses = cpl.coupled_substep(
            grid_config, contact_params or cpl.MpmContactParams(), p, rigid_geoms)
    return state.replace(x=p.x, v=p.v, C=p.C, dropped=p.dropped), impulses


def simulate_cloth(
    grid_config: mpm.MpmConfig,
    cloth_config: ClothConfig,
    state: ClothState,
    num_substeps: int,
    rigid_geoms: Sequence[cpl.RigidGeom] = (),
    contact_params: Optional[cpl.MpmContactParams] = None,
    contact_model: str = "penalty",
):
    """`num_substeps` cloth substeps (the reference's ``lax.scan`` as a
    Python loop; no host sync inside): (state, impulse sum (..., n_geoms,
    6)).  The state's ``dropped`` is the largest count of the substeps."""
    acc = state.x.new_zeros(state.x.shape[:-2] + (len(rigid_geoms), 6))
    dropped = state.dropped
    for k in range(num_substeps):
        state, imp = cloth_substep(grid_config, cloth_config, state, rigid_geoms,
                                   contact_params, contact_model=contact_model)
        acc = acc + imp
        dropped = state.dropped if k == 0 else torch.maximum(dropped, state.dropped)
    return state.replace(dropped=dropped), acc
