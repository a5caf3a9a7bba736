"""Dense primal-dual interior-point QP solver (Mehrotra predictor-corrector),
over lanes.

The PyTorch counterpart of ``drake_tpu/solvers/ipm.py``: a batch of B
independent problems

    minimize    0.5 w'Pw + q'w
    subject to  G w = b
                lb <= w <= ub     (entries may be +-inf; handled by masks)

with ``P`` (B, n, n), ``q`` (B, n), ``G`` (B, m, n), ``b`` (B, m) and ``lb``,
``ub`` (B, n).  Each iteration factors the quasidefinite KKT matrix

    [[P + diag(zl/sl + zu/su), G'], [G, -reg I]]

by a batched LU (``torch.linalg.lu_factor_ex``/``lu_solve``), with the
reference's optional iterative refinement, and takes a predictor and a
Mehrotra corrector step.

The reference's ``lax.while_loop`` is a Python loop over all lanes with a
per-lane ``active`` mask: a lane that is done keeps its values and its
iteration count while the others iterate, as under ``vmap``.  The host asks
whether any lane is still active every ``_CHECK_EVERY`` iterations.  On the
card an iteration is captured once a solve as a CUDA graph and replayed,
and the batched LU is cuBLAS's (``_batched_lu``).  The
reference traces under full float32 matmul precision; the port never turns
TF32 on, so its float32 matmuls are full float32 too.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch
from torch.profiler import record_function

_CHECK_EVERY = 4


@dataclasses.dataclass(frozen=True)
class IpmOptions:
    max_iters: int = 30
    tol: float = 1e-9
    tau: float = 0.995  # fraction-to-boundary
    kkt_reg: float = 1e-9  # static regularization of the KKT system
    # float32 knobs: iterative refinement of each KKT solve, and a clamp of
    # the barrier diagonal z/s (keep d_max >= 1e14 for float64).
    refine_steps: int = 0
    d_max: float = 1e14
    # Ruiz equilibration sweeps on the KKT data; 0 = off.
    equilibrate: int = 0


class IpmSolution(NamedTuple):
    w: torch.Tensor  # (B, n)
    y: torch.Tensor  # (B, m) equality duals
    z_lower: torch.Tensor  # (B, n) duals for w >= lb (>= 0)
    z_upper: torch.Tensor  # (B, n) duals for w <= ub (>= 0)
    iterations: torch.Tensor  # (B,)
    residual: torch.Tensor  # (B,)
    converged: torch.Tensor  # (B,)


def _mv(M, x):
    return (M @ x.unsqueeze(-1)).squeeze(-1)


def _inf_norm(x):
    """max |x| over the last axis, and 0 over an empty one (a problem with no
    equality rows), as the reference's ``norm(., inf)``: ``torch.amax``
    raises on an empty axis."""
    if x.shape[-1] == 0:
        return x.new_zeros(x.shape[:-1])
    return torch.amax(torch.abs(x), dim=-1)


def _ruiz_equilibrate(P, q, G, b, lb, ub, sweeps: int):
    """Diagonal scaling of the QP data towards unit KKT row norms, with the
    reference's cost normalization.  Returns (P^, q^, G^, b^, lb^, ub^, d, e,
    c); unscale by w = d w^, y = e y^ / c, z = z^ / (d c)."""
    d = torch.ones_like(q)
    e = torch.ones_like(b)
    c = torch.ones_like(q[..., 0])
    P_, q_, G_ = P, q, G
    for _ in range(sweeps):
        # Row inf-norms of the scaled KKT matrix [[P, G'], [G, 0]].
        rn = torch.maximum(_inf_norm(P_), _inf_norm(G_.mT))
        rm = _inf_norm(G_)
        sd = 1.0 / torch.sqrt(torch.clamp(rn, 1e-12, 1e12))
        se = 1.0 / torch.sqrt(torch.clamp(rm, 1e-12, 1e12))
        P_ = sd[..., :, None] * P_ * sd[..., None, :]
        q_ = sd * q_
        G_ = se[..., :, None] * G_ * sd[..., None, :]
        # Cost normalization: gamma = 1/max(mean column norm of P, |q|).
        col = torch.mean(_inf_norm(P_.mT), dim=-1)
        gamma = 1.0 / torch.clamp(torch.maximum(col, _inf_norm(q_)), 1e-8, 1e8)
        P_ = gamma[..., None, None] * P_
        q_ = gamma[..., None] * q_
        d, e, c = d * sd, e * se, c * gamma
    return P_, q_, G_, e * b, lb / d, ub / d, d, e, c


@record_function("ipm.solve")
def solve_qp_ipm(P, q, G, b, lb, ub, options: IpmOptions = IpmOptions()) -> IpmSolution:
    """Solve the B box/equality QPs."""
    if not options.equilibrate:
        return _solve(P, q, G, b, lb, ub, options)
    Ps, qs, Gs, bs, lbs, ubs, d, e, c = _ruiz_equilibrate(P, q, G, b, lb, ub, options.equilibrate)
    sol = _solve(Ps, qs, Gs, bs, lbs, ubs, options)
    w = d * sol.w
    y = e * sol.y / c[..., None]
    zl = sol.z_lower / (d * c[..., None])
    zu = sol.z_upper / (d * c[..., None])
    # The residual of the unscaled problem, so that tolerances mean what
    # they say.
    rd = _mv(P, w) + q + _mv(G.mT, y) - zl + zu
    rp = _mv(G, w) - b
    scale = 1.0 + torch.maximum(_inf_norm(q), _inf_norm(b))
    res = torch.maximum(_inf_norm(rd), _inf_norm(rp)) / scale
    return IpmSolution(w=w, y=y, z_lower=zl, z_upper=zu, iterations=sol.iterations,
                       residual=res, converged=sol.converged)


@contextlib.contextmanager
def _batched_lu(device):
    """On the card, the batched LU of cuBLAS (``getrfBatched``, partial
    pivoting, one kernel for the whole batch) in place of the default
    backend's, which launches hundreds a factorization; the setting is
    process-wide, so it is restored on the way out."""
    if device.type != "cuda":
        yield
        return
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(before)


def _graphed(step, state):
    """`step` (a tuple of tensors to a tuple of tensors of the same shapes)
    captured once as a CUDA graph that reads and writes buffers of its own;
    returns ``advance(state)``, which replays it on those buffers.  An IPM
    iteration is some 300 small launches: replaying them costs the host one
    launch.  The first call of ``advance`` must pass the `state` captured
    from, and each later one what the previous returned."""
    buffers = tuple(t.clone() for t in state)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(buffers)  # a warm-up outside the capture: workspaces and handles
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for dst, src in zip(buffers, step(buffers)):
            dst.copy_(src)

    def advance(_):
        graph.replay()
        return buffers

    return advance


def _solve(P, q, G, b, lb, ub, opts: IpmOptions) -> IpmSolution:
    """The IPM proper.  The two bounds ride stacked on a middle axis of 2:
    slacks S = [sl, su], duals Z = [zl, zu], masks M, bounds [lb, ub] and
    the sign of w in each, sgn = [1, -1]; the state of a lane is the one
    row [w, y, Z, S] of X, so that a lane's update is one select."""
    B, n = q.shape
    m = b.shape[-1]
    dtype, device = q.dtype, q.device
    has = torch.isfinite(torch.stack([lb, ub], dim=1))  # (B, 2, n)
    M = has.to(dtype)
    n_bounds = torch.clamp_min(M.sum((1, 2)), 1.0)
    bnd = torch.where(has, torch.stack([lb, ub], dim=1), 0.0)
    sgn = torch.tensor([[1.0], [-1.0]], dtype=dtype, device=device)
    scale = 1.0 + torch.maximum(_inf_norm(q), _inf_norm(b))

    # Initial interior point.
    has_lb, has_ub = has[:, 0], has[:, 1]
    lb_safe, ub_safe = bnd[:, 0], bnd[:, 1]
    w = torch.zeros_like(q)
    w = torch.where(has_lb & has_ub, 0.5 * (lb_safe + ub_safe), w)
    w = torch.where(has_lb & ~has_ub, lb_safe + 1.0, w)
    w = torch.where(~has_lb & has_ub, ub_safe - 1.0, w)
    S = torch.where(has, torch.clamp_min(sgn * (w[:, None] - bnd), 1.0), 1.0)
    X = torch.cat([w, q.new_zeros((B, m)), M.flatten(1), S.flatten(1)], dim=-1)

    def unpack(X):
        return (X[:, :n], X[:, n : n + m], X[:, n + m : 3 * n + m].unflatten(-1, (2, n)),
                X[:, 3 * n + m :].unflatten(-1, (2, n)))

    # The KKT matrix but for the barrier and regularization on P's diagonal.
    K0 = torch.cat([
        torch.cat([P, G.mT], dim=-1),
        torch.cat([G, -opts.kkt_reg * torch.eye(m, dtype=dtype, device=device).expand(B, m, m)],
                  dim=-1),
    ], dim=-2)
    diag_n = torch.arange(n, device=device)

    def residuals(w, y, Z, S):
        rd = _mv(P, w) + q + _mv(G.mT, y) - (sgn * Z).sum(1)
        return rd, _mv(G, w) - b, M * (sgn * (w[:, None] - bnd) - S)

    def max_step(V, dV):
        ratio = torch.where((M > 0) & (dV < 0), -opts.tau * V / torch.clamp_max(dV, -1e-30), 1.0)
        return torch.clamp_max(torch.amin(ratio, dim=(1, 2)), 1.0)[:, None, None]

    def body(X):
        w, y, Z, S = unpack(X)
        rd, rp, R = residuals(w, y, Z, S)
        mu = (S * Z).sum((1, 2)) / n_bounds
        D = torch.clamp_max((M * Z / S).sum(1), opts.d_max)
        K = K0.clone()
        K[:, diag_n, diag_n] = K0[:, diag_n, diag_n] + D + opts.kkt_reg
        # A lane whose factors are not finite (a lane that is done iterates
        # on 0/0; float32 elimination can overflow) gets NaN, as the
        # reference's LU gives it.  LAPACK leaves such a lane's pivots out of
        # range, so they are clamped: its solve then stays in bounds.
        LU, piv, _ = torch.linalg.lu_factor_ex(K)
        finite = torch.isfinite(LU).all(dim=-1).all(dim=-1)
        piv = piv.clamp(1, n + m)

        def kkt_solve(rhs):
            sol = torch.linalg.lu_solve(LU, piv, rhs.unsqueeze(-1))
            for _ in range(opts.refine_steps):
                sol = sol + torch.linalg.lu_solve(LU, piv, rhs.unsqueeze(-1) - K @ sol)
            return torch.where(finite[:, None], sol.squeeze(-1), torch.nan)

        def solve_dir(RHS):
            rd_bar = rd - (sgn * M * (RHS - Z * R) / S).sum(1)
            sol = kkt_solve(torch.cat([-rd_bar, -rp], dim=-1))
            dw = sol[:, :n]
            dS = M * (sgn * dw[:, None] + R)
            return dw, sol[:, n:], dS, M * (RHS - Z * dS) / S

        # Predictor (affine): mu_t = 0, no second-order correction.
        _, _, dS_a, dZ_a = solve_dir(-S * Z)
        mu_aff = (M * (S + max_step(S, dS_a) * dS_a) * (Z + max_step(Z, dZ_a) * dZ_a)).sum(
            (1, 2)) / n_bounds
        sigma = torch.clamp((mu_aff / torch.clamp_min(mu, 1e-30)) ** 3, 0.0, 1.0)

        # Corrector with Mehrotra's second-order terms.
        dw, dy, dS, dZ = solve_dir((sigma * mu)[:, None, None] - S * Z - dS_a * dZ_a)
        alpha = torch.minimum(max_step(S, dS), max_step(Z, dZ))
        w = w + alpha[:, 0] * dw
        y = y + alpha[:, 0] * dy
        S = torch.where(has, S + alpha * dS, 1.0)
        Z = torch.where(has, Z + alpha * dZ, 0.0)

        rd, rp, _ = residuals(w, y, Z, S)
        mu_new = (S * Z).sum((1, 2)) / n_bounds
        res = torch.maximum(_inf_norm(rd), _inf_norm(rp)) / scale
        done = (res <= opts.tol) & (mu_new <= opts.tol * scale)
        return torch.cat([w, y, Z.flatten(1), S.flatten(1)], dim=-1), res, done

    def step(state):
        X, res, done, it = state
        active = ~done
        X_new, res_new, done_new = body(X)
        return (torch.where(active[:, None], X_new, X), torch.where(active, res_new, res),
                torch.where(active, done_new, done), it + active.long())

    state = (X, torch.full((B,), torch.inf, dtype=dtype, device=device),
             torch.zeros(B, dtype=torch.bool, device=device),
             torch.zeros(B, dtype=torch.long, device=device))
    with _batched_lu(device):
        advance = _graphed(step, state) if device.type == "cuda" else step
        for k in range(opts.max_iters):
            if k % _CHECK_EVERY == 0 and not bool((~state[2]).any()):
                break
            state = advance(state)
    X, res, done, it = state
    w, y, Z, _ = unpack(X)
    return IpmSolution(w=w, y=y, z_lower=Z[:, 0], z_upper=Z[:, 1], iterations=it,
                       residual=res, converged=done)
