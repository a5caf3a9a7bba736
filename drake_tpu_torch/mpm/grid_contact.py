"""Implicit grid-level frictional contact for MPM on PyTorch + CUDA.

The PyTorch counterpart of ``drake_tpu/mpm/grid_contact.py``, which
re-derives the fork's grid contact Newton (UpdateContact,
multibody/gpu_mpm/cuda_mpm_solver.cu:215-621).  The post-transfer grid
velocities v* become the free-motion target of an implicit minimization over
grid velocities v:

    E(v) = sum_i 1/2 m_i ||v_i - v_i*||^2  +  sum_p e_p(v_p(v))

where v_p = sum_i w_ip v_i interpolates v at each particle with the
quadratic B-spline stencil and e_p is the contact energy of particle p
against each rigid geometry (normal penalty with damping, regularized
Coulomb friction against the rigid surface velocity, the friction magnitude
lagged).  d e_p / d v_p is an impulse.  Each Newton iteration solves every
node's 3x3 block-Jacobi system in closed form and takes a global exact line
search on dE/dalpha (a two-level bracketing grid and a secant).  The solve
is implicit in the normal direction, so it stays stable at stiff k dt, where
the explicit penalty of ``mpm/coupling.py`` does not.

Every tensor may lead with lane axes, as in the rest of the port: particle
fields ``(..., n, ...)``, the grid mass ``(..., nx, ny, nz)``, the grid
velocity ``(..., nx, ny, nz, 3)``, each geometry's pose and velocity per
lane; each lane is solved on its own grid.  What differs from the
reference, by design:

- The Newton ``while_loop`` is a Python loop over all lanes with a per-lane
  mask: a lane whose own condition fails keeps its velocity, iteration count
  and residual, as under ``vmap`` of ``lax.while_loop``.  On the card the
  host asks whether any lane is still active after the first iteration
  and every ``_CHECK_EVERY`` iterations, on the CPU after every one.
- The line search takes f(alpha_max) from its first level, whose last
  point is alpha_max; the reference evaluates f there once more.  The
  pairs' gradient there is ``_contact_grad``, the same expression as
  ``_contact_grad_hess``'s without the Hessian.
- The stencil is one ``(..., n, 27)`` tensor of node indices and one of
  weights: ``torch.gather`` interpolates, and a scatter sums into a buffer
  of all lanes' nodes with one drop row for taps outside the grid, in a
  fixed order planned once a stencil (``solver.scatter_sum``): two runs of
  a solve are bit for bit the same on the card, where ``index_add_``
  would sum with atomics in no fixed order.

No gradient flows through the solve (nothing differentiates it in the
reference either).  ``solve_log`` collects each solve's iterations,
residual and impulses for a caller that reports them.  The Newton
(``newton``) and the impulses (``impulses``) take any node set and its
stencil: the dense grid here, the closure of the active blocks in
``mpm/tiles_contact.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from drake_tpu_torch.mpm import solver as mpm
from drake_tpu_torch.mpm.coupling import RigidGeom, _particle_sdf
from drake_tpu_torch.ops.mpm_kernels import device_constant

# On the card the Newton loop asks the host whether any lane is still
# active after its first iteration (a solve without contact ends there) and
# then once every this many iterations (each question waits for the
# device); on the CPU, where asking costs nothing, after every iteration.
_CHECK_EVERY = 4
_EYE = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


@dataclasses.dataclass(frozen=True)
class GridContactParams:
    """Mirror of MpmConfigParams' contact block and the solver's knobs (the
    reference's fields and defaults).  ``line_search_levels``,
    ``ext_capacity_factor``, ``unroll_iterations`` and ``max_contact_rows``
    configure the solve on the tile pipeline (``mpm/tiles_contact.py``); the
    dense solve reads none of them, as in the reference."""

    stiffness: float = 1e5  # normal penalty k [N/m]
    damping: float = 10.0  # normal rate damping d [N s/m]
    friction: float = 0.5
    slip_velocity: float = 1e-3  # friction regularization [m/s]
    margin: float = 0.0  # activation distance for candidate pairs [m]
    max_iterations: int = 20
    rel_tolerance: float = 1e-4  # ||dir|| / #movable nodes
    relax: float = 1.0
    line_search_points: int = 12
    line_search_levels: int = 2
    alpha_max: float = 1.5
    ext_capacity_factor: int = 4
    unroll_iterations: int = 0
    max_contact_rows: int = 0


class GridContactSolution(NamedTuple):
    grid_vel: torch.Tensor  # (..., nx, ny, nz, 3) post-contact grid velocities
    impulses: torch.Tensor  # (..., n_geoms, 6) [tau; f] spatial impulse per rigid
    iterations: torch.Tensor  # (...) int32 Newton iterations of each lane
    residual: torch.Tensor  # (...) each lane's last ||dir|| / #movable nodes


# While a list is set here (``solve_log``), every solve appends its solution.
_LOG: Optional[List[GridContactSolution]] = None


@contextlib.contextmanager
def solve_log():
    """Collect the ``GridContactSolution`` of every ``solve_grid_contact``
    run inside the block into the list it yields (device tensors, no host
    sync): its iterations, residual and impulses, with ``grid_vel`` None (a
    whole grid a solve, which would hold the device memory of a long run)."""
    global _LOG
    outer, _LOG = _LOG, []
    try:
        yield _LOG
    finally:
        _LOG = outer


def pair_quantities(x, geoms: Sequence[RigidGeom], lanes):
    """Per (geometry, row) of x (L, rows, 3): phi0 (L, G, rows), the outward
    normal and the rigid surface velocity (L, G, rows, 3); each geometry's
    pose and velocity lead with `lanes` (L = their product)."""
    L, rows = x.shape[:2]
    xl = x.reshape(lanes + (rows, 3))
    phis, ns, vgs = [], [], []
    for geom in geoms:
        phi, n = _particle_sdf(geom, xl)
        w = geom.V_WB[..., None, :3].expand(xl.shape)
        vo = geom.V_WB[..., None, 3:]
        phis.append(phi.reshape(L, rows))
        ns.append(n.expand(xl.shape).reshape(L, rows, 3))  # a halfspace's normal is one per lane
        vgs.append((vo + torch.linalg.cross(w, xl - geom.p_WB[..., None, :], dim=-1))
                   .reshape(L, rows, 3))
    return torch.stack(phis, dim=1), torch.stack(ns, dim=1), torch.stack(vgs, dim=1)


def _grad_and_force(p: GridContactParams, dt, phi0, n, v_rel, active):
    """The pairs' energy gradient (impulse), normal force f_n, 1 / max(|vt|,
    eps) and the contact indicator of _contact_grad_hess."""
    k, d, mu, eps = p.stiffness, p.damping, p.friction, p.slip_velocity
    vn = torch.sum(v_rel * n, dim=-1)
    vt = v_rel - vn[..., None] * n
    phi_hat = phi0 + dt * vn  # end-of-step penetration estimate
    pen = torch.clamp_min(-phi_hat, 0.0)
    actf = (active & (phi_hat < 0.0)).to(v_rel.dtype)
    f_n = actf * torch.clamp_min(k * pen - d * vn, 0.0)  # >= 0 normal force
    inv_slip = 1.0 / torch.clamp_min(torch.linalg.vector_norm(vt, dim=-1), eps)
    # Impulse units: normal penalty and damping along n, friction on vt.
    g = (-dt * f_n)[..., None] * n + (dt * mu * f_n * inv_slip)[..., None] * vt
    return g, f_n, inv_slip, actf


def _contact_grad_hess(p: GridContactParams, dt, phi0, n, v_rel, active):
    """Per-pair energy gradient (impulse) and PSD Gauss-Newton Hessian with
    respect to v_p, with the friction magnitude lagged (held constant in the
    derivatives).  Returns (g (..., 3), H (..., 3, 3), f_n (...))."""
    k, d, mu = p.stiffness, p.damping, p.friction
    g, f_n, inv_slip, actf = _grad_and_force(p, dt, phi0, n, v_rel, active)
    # dt^2 (k + d/dt) n n' + dt mu f_n/|vt| (I - n n').
    hn = actf * dt * (dt * k + d)
    hf = dt * mu * f_n * inv_slip
    eye = device_constant(_EYE, v_rel.dtype, v_rel.device)
    nnT = n[..., :, None] * n[..., None, :]
    H = hn[..., None, None] * nnT + hf[..., None, None] * (eye - nnT)
    return g, H, f_n


def _contact_grad(p: GridContactParams, dt, phi0, n, v_rel, active):
    """The gradient of _contact_grad_hess alone (the line search and the
    impulses need no Hessian)."""
    return _grad_and_force(p, dt, phi0, n, v_rel, active)[0]


class _Stencil(NamedTuple):
    """The 27 taps of every particle of L lanes."""

    index: torch.Tensor  # (L, n 27) node within the lane, out-of-grid taps clamped
    drop_index: torch.Tensor  # (L n 27,) node of all lanes, out-of-grid taps -> L nodes
    weight: torch.Tensor  # (L, n, 27), zero on out-of-grid taps
    weight_sq: torch.Tensor  # (L, n, 27)
    nodes: int  # nodes of a lane's grid
    plan: mpm.ScatterPlan  # the fixed order of scatters through drop_index


def _stencil(config: mpm.MpmConfig, x) -> _Stencil:
    """The taps of x (L, n, 3) as the reference's solve precomputes them."""
    nx, ny, nz = config.grid_size
    L, n = x.shape[:2]
    dev = x.device
    nodes = nx * ny * nz
    base, w = mpm._bspline_weights(x, config.dx)
    offsets = device_constant(tuple(mpm._stencil_iter()), torch.int64, dev)  # (27, 3)
    hi = device_constant((nx - 1, ny - 1, nz - 1), torch.int64, dev)
    idx = base[..., None, :] + offsets  # (L, n, 27, 3)
    valid = ((idx >= 0) & (idx <= hi)).all(dim=-1)
    idx_c = torch.minimum(idx.clamp_min(0), hi)
    weight = (
        w[..., 0, offsets[:, 0]] * w[..., 1, offsets[:, 1]] * w[..., 2, offsets[:, 2]]
    ) * valid.to(x.dtype)
    flat = (idx_c[..., 0] * ny + idx_c[..., 1]) * nz + idx_c[..., 2]  # (L, n, 27)
    lane = torch.arange(L, device=dev).reshape(L, 1, 1) * nodes
    drop = torch.where(valid, flat + lane, L * nodes)
    drop = drop.reshape(-1)
    return _Stencil(index=flat.reshape(L, n * 27), drop_index=drop, weight=weight,
                    weight_sq=weight**2, nodes=nodes,
                    plan=mpm.scatter_plan(drop, L * nodes + 1))


def _gather(st: _Stencil, v):
    """Interpolate a grid field v (L, nodes, c) at the particles: (L, n, c)."""
    L, n = st.weight.shape[:2]
    c = v.shape[-1]
    taps = torch.gather(v, 1, st.index[..., None].expand(L, n * 27, c)).reshape(L, n, 27, c)
    return torch.sum(st.weight[..., None] * taps, dim=-2)


def _scatter(st: _Stencil, weight, vals):
    """Scatter per-particle vals (L, n, c) with stencil weights (L, n, 27)
    to the grid: (L, nodes, c)."""
    L = vals.shape[0]
    c = vals.shape[-1]
    contrib = weight[..., None] * vals[..., None, :]  # (L, n, 27, c)
    out = mpm.scatter_sum(st.plan, contrib.reshape(-1, c))
    return out[:-1].reshape(L, st.nodes, c)


def _line_grid(K: int, dtype, device):
    """The K points of the reference's ``linspace(0, 1, K)``, as JAX makes
    it: i * (1 / (K - 1)), the last exactly 1."""
    if K == 1:
        return device_constant((0.0,), dtype, device)
    r = 1.0 / (K - 1)
    return device_constant(tuple(i * r for i in range(K - 1)) + (1.0,), dtype, device)


def solve_grid_contact(
    config: mpm.MpmConfig,
    params: GridContactParams,
    state: mpm.MpmState,
    grid_mass: torch.Tensor,
    grid_vel: torch.Tensor,
    geoms: Sequence[RigidGeom],
) -> GridContactSolution:
    """Implicit grid contact solve (the UpdateContact role) of every lane.

    grid_mass (..., nx, ny, nz) and grid_vel (..., nx, ny, nz, 3) are the
    free-motion grid after the grid update.  Returns the post-contact grid
    velocities and each geometry's accumulated spatial impulse on its body
    (apply_contact_impulse_to_rigid_bodies role)."""
    nx, ny, nz = config.grid_size
    dev = grid_vel.device
    lanes = state.x.shape[:-2]
    L = math.prod(lanes)
    n_p = state.x.shape[-2]
    G = len(geoms)
    if G == 0:
        return GridContactSolution(
            grid_vel=grid_vel,
            impulses=grid_vel.new_zeros(lanes + (0, 6)),
            iterations=torch.zeros(lanes, dtype=torch.int32, device=dev),
            residual=grid_vel.new_zeros(lanes),
        )

    x = state.x.reshape(L, n_p, 3)
    phi0, n_pg, v_g = pair_quantities(x, geoms, lanes)
    st = _stencil(config, x)
    # Domain-wall nodes stay pinned (their direction is zeroed).
    ww = config.wall_width
    ii = torch.arange(nx, device=dev)[:, None, None]
    jj = torch.arange(ny, device=dev)[None, :, None]
    kk = torch.arange(nz, device=dev)[None, None, :]
    inside = (
        (ii >= ww) & (ii < nx - ww)
        & (jj >= ww) & (jj < ny - ww)
        & (kk >= ww) & (kk < nz - ww)
    ).reshape(-1)
    v, it, res = newton(
        params, config.dt, st, grid_mass.reshape(L, st.nodes), grid_vel.reshape(L, st.nodes, 3),
        inside, phi0, n_pg, v_g, phi0 < params.margin,
    )
    sol = GridContactSolution(
        grid_vel=v.reshape(grid_vel.shape),
        impulses=impulses(params, config.dt, st, v, phi0, n_pg, v_g, phi0 < params.margin, x,
                          geoms, lanes),
        iterations=it.reshape(lanes),
        residual=res.reshape(lanes),
    )
    if _LOG is not None:
        _LOG.append(sol._replace(grid_vel=None))
    return sol


def newton(params: GridContactParams, dt, st: _Stencil, mass, v_star, inside, phi0, n_pg,
           v_g, active0, line_search_levels: int = 2, unroll_iterations: int = 0):
    """The block-Jacobi Newton of every lane on a node set: mass (L, nodes),
    v_star (L, nodes, 3), ``inside`` (nodes,) or (L, nodes) the nodes off the
    walls, the pairs' phi0 (L, G, rows), normals and rigid velocities
    (L, G, rows, 3) and candidate mask ``active0``, ``st`` the rows' taps
    into the node set.  Returns (v (L, nodes, 3), iterations (L,) int32,
    residual (L,)).

    The converged loop (``unroll_iterations == 0``) masks each lane whose
    own condition fails, as ``vmap`` of ``lax.while_loop`` does; on the card
    it asks the host after the first iteration and every ``_CHECK_EVERY``.
    ``unroll_iterations = N > 0`` runs exactly N iterations of every lane
    and asks the host nothing.  ``line_search_levels`` 1 takes one bracket
    level before the secant, 2 two."""
    dtype = v_star.dtype
    dev = v_star.device
    L = v_star.shape[0]
    movable = (inside & (mass > 0)).to(dtype)[..., None]  # (L, nodes, 1)
    n_dofs = torch.clamp_min(movable.sum(dim=(-2, -1)), 1.0)
    # + m_i I in every node's block; empty nodes get I so that the
    # closed-form inverse stays finite (their direction is zeroed anyway).
    m_eye = torch.where(mass > 0, mass, 1.0)[..., None, None] * device_constant(
        _EYE, dtype, dev)
    mass3 = mass[..., None]
    K = params.line_search_points
    lin = _line_grid(K, dtype, dev)
    amax = torch.full((L,), params.alpha_max, dtype=dtype, device=dev)
    lane_idx = torch.arange(L, device=dev)

    def f(vp0, dvp, a0, a1, alphas):
        """dE/dalpha at alphas (L, K): the grid's quadratic part and the
        pairs' gradient dotted with the direction at the particles."""
        vr = (vp0[:, None] + alphas[..., None, None] * dvp[:, None])[:, :, None]
        vr = vr - v_g[:, None]  # (L, K, G, rows, 3)
        g_a = _contact_grad(params, dt, phi0[:, None], n_pg[:, None], vr, active0[:, None])
        return a0[:, None] + alphas * a1[:, None] + torch.einsum("lkgni,lni->lk", g_a, dvp)

    def refine(args, lo, hi):
        """One level of the bracketing grid on [lo, hi] (L,): the bracket
        of the first sign change and f at its ends, and f at every point."""
        alphas = lo[:, None] + (hi - lo)[:, None] * lin
        fs = f(*args, alphas)
        i = torch.clamp_min(torch.sum(fs < 0, dim=-1) - 1, 0)
        ip = torch.clamp_max(i + 1, K - 1)
        return alphas[lane_idx, i], alphas[lane_idx, ip], fs[lane_idx, i], fs[lane_idx, ip], fs

    def step(v):
        """One Newton iteration of every lane: (v_new, residual)."""
        vp = _gather(st, v)  # (L, rows, 3)
        g, H, _ = _contact_grad_hess(params, dt, phi0, n_pg, vp[:, None] - v_g, active0)
        dv = v - v_star
        grid_g = mass3 * dv + _scatter(st, st.weight, g.sum(dim=1))
        grid_H = _scatter(st, st.weight_sq, H.sum(dim=1).reshape(L, -1, 9))
        grid_H = grid_H.reshape(L, st.nodes, 3, 3) + m_eye
        dirn = -params.relax * torch.sum(mpm._inv3(grid_H) * grid_g[..., None, :], dim=-1)
        dirn = dirn * movable

        with record_function("grid_contact.line_search"):
            args = (vp, _gather(st, dirn), torch.sum(dirn * (mass3 * dv), dim=(-2, -1)),
                    torch.sum(dirn * (mass3 * dirn), dim=(-2, -1)))
            lo, hi, flo, fhi, fs1 = refine(args, torch.zeros_like(amax), amax)
            if line_search_levels >= 2:
                lo, hi, flo, fhi, _ = refine(args, lo, hi)
            denom = fhi - flo
            alpha = lo - flo * (hi - lo) / torch.where(denom.abs() > 1e-20, denom, 1.0)
            alpha = torch.minimum(torch.maximum(alpha, lo), hi)
            # The first level's last point is alpha_max.
            alpha = torch.where(fs1[:, -1] <= 0, amax, alpha)
        v_new = v + alpha[:, None, None] * dirn
        return v_new, torch.linalg.vector_norm(dirn, dim=(-2, -1)) / n_dofs

    v = v_star
    it = torch.zeros(L, dtype=torch.int32, device=dev)
    res = torch.full((L,), math.inf, dtype=dtype, device=dev)
    with record_function("grid_contact.newton"):
        if unroll_iterations > 0:
            for _ in range(unroll_iterations):
                v, res = step(v)
            it = it + unroll_iterations
        else:
            check_every = 1 if dev.type == "cpu" else _CHECK_EVERY
            for k in range(params.max_iterations):
                active = (res > params.rel_tolerance) & (it < params.max_iterations)
                if k > 0 and (k == 1 or k % check_every == 0) and not bool(active.any()):
                    break
                v_new, res_new = step(v)
                v = torch.where(active[:, None, None], v_new, v)
                res = torch.where(active, res_new, res)
                it = it + active.to(torch.int32)
    return v, it, res


def impulses(params: GridContactParams, dt, st: _Stencil, v, phi0, n_pg, v_g, active0, x,
             geoms: Sequence[RigidGeom], lanes):
    """Rigid reaction impulses at the solution v (L, nodes, 3): +de_p/dv_p on
    the rigid body, with the torque about each geometry's body origin, of the
    rows x (L, rows, 3).  Returns (lanes..., G, 6) [tau; f]."""
    L, rows = x.shape[:2]
    G = len(geoms)
    g_final = _contact_grad(params, dt, phi0, n_pg, _gather(st, v)[:, None] - v_g, active0)
    imp_lin = torch.sum(g_final, dim=-2)  # (L, G, 3)
    p_WB = torch.stack([g.p_WB.expand(lanes + (3,)) for g in geoms], dim=-2).reshape(L, G, 1, 3)
    levers = x.reshape(L, 1, rows, 3) - p_WB
    imp_tau = torch.sum(torch.linalg.cross(levers, g_final, dim=-1), dim=-2)
    return torch.cat([imp_tau, imp_lin], dim=-1).reshape(lanes + (G, 6))


@record_function("grid_contact.substep")
def coupled_substep_implicit(
    config: mpm.MpmConfig,
    params: GridContactParams,
    state: mpm.MpmState,
    geoms: Sequence[RigidGeom],
) -> Tuple[mpm.MpmState, torch.Tensor]:
    """One MPM substep with implicit grid contact (the fork's pipeline: P2G
    -> UpdateGrid -> UpdateContact -> G2P).  On the card the P2G and grid
    update are K2 and K1 from block windows, which also writes the node
    mass.  Returns (state, rigid spatial impulses (..., n_geoms, 6)); the
    state's ``dropped`` is this substep's P2G count."""
    grid_vel, grid_mass, dropped = mpm.grid_velocity_and_mass(config, state)
    sol = solve_grid_contact(config, params, state, grid_mass, grid_vel, geoms)
    state = mpm.grid_to_particle(config, state, sol.grid_vel)
    return state.replace(dropped=dropped), sol.impulses
