"""Simulation: fixed-step rollouts in place of Simulator::AdvanceTo.

The PyTorch counterpart of the fixed-step part of
``drake_tpu/systems/simulator.py``.  The reference's ``lax.scan`` rollouts
are Python loops, the closed loop's through ``utils.scan`` (one CUDA graph
of a step, replayed, on the card); the lanes of a batch ride in the leading
dimensions of ``x0`` and of the inputs, so ``batch_simulate`` is
``simulate`` on batched tensors.  The time is carried as the reference
carries it: a tensor of the state's type to which each step adds ``dt``.

``simulate`` replays its step as ``simulate_controlled`` does, reading the
input at a step index held on the device.  The error-controlled
``simulate_adaptive`` and the hybrid ``simulate_hybrid`` run their lanes
with per-lane masks and selects, as the reference's loops under ``vmap``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.profiler import record_function

from drake_tpu_torch.systems import integrators as _integrators
from drake_tpu_torch.systems.base import ContinuousSystem, DiscreteSystem
from drake_tpu_torch.utils.scan import capture, scan


@dataclasses.dataclass(frozen=True)
class SimulatorConfig:
    """Mirror of drake::systems::SimulatorConfig."""

    integration_scheme: str = "rk4"
    max_step_size: float = 0.01
    accuracy: float = 1e-4
    use_error_control: bool = False


def _times(t0, dt, n, like):
    return t0 + dt * torch.arange(n + 1, dtype=like.dtype, device=like.device)


def simulate(system: ContinuousSystem, params, x0, u_sequence, dt, t0=0.0, method: str = "rk4"):
    """Roll out an input sequence with fixed steps (zero-order hold).

    ``x0`` (..., nx), ``u_sequence`` (..., N, nu): one input per step, read
    at a step index carried on the device, so that on the card with
    autograd off the step is replayed as one CUDA graph (``utils.scan``).
    Returns (xs (..., N+1, nx) including x0, ts (N+1,))."""
    step = _integrators.get(method)
    n = u_sequence.shape[-2]

    def body(carry):
        x, t, k = carry
        u = u_sequence.index_select(-2, k).squeeze(-2)
        x = step(system.f, params, x, u, t, dt)
        return (x, t + dt, k + 1), (x,)

    if n == 0:
        return x0.unsqueeze(-2), _times(t0, dt, 0, x0)
    t = torch.tensor(t0, dtype=x0.dtype, device=x0.device)
    k = torch.zeros(1, dtype=torch.long, device=x0.device)
    _, (xs,) = scan(body, (x0, t, k), n)
    xs = xs.movedim(0, -2)
    x0 = x0.expand(xs.shape[:-2] + x0.shape[-1:])  # the lanes the inputs add
    return torch.cat([x0.unsqueeze(-2), xs], dim=-2), _times(t0, dt, n, x0)


def simulate_controlled(system: ContinuousSystem, params, x0, policy: Callable, num_steps: int,
                        dt, t0=0.0, method: str = "rk4", policy_state=None):
    """Closed-loop rollout: u = policy(policy_state, x, t) each step.

    ``policy`` may return either ``u`` or ``(u, new_policy_state)``.  On the
    card with autograd off, the step is replayed as a CUDA graph
    (``utils.scan``): the policy must then keep to what a graph captures,
    and a policy state be a tensor.
    Returns (xs (..., N+1, nx), us (..., N, nu), ts (N+1,))."""
    step = _integrators.get(method)

    def body(carry):
        x, t, *ps = carry
        out = policy(ps[0] if ps else None, x, t)
        u, ps = (out[0], [out[1]]) if isinstance(out, tuple) else (out, ps)
        x = step(system.f, params, x, u, t, dt)
        return (x, t + dt, *ps), (x, u)

    t = torch.tensor(t0, dtype=x0.dtype, device=x0.device)
    carry = (x0, t) if policy_state is None else (x0, t, policy_state)
    _, (xs, us) = scan(body, carry, num_steps)
    return (torch.cat([x0.unsqueeze(-2), xs.movedim(0, -2)], dim=-2), us.movedim(0, -2),
            _times(t0, dt, num_steps, x0))


def simulate_discrete(system: DiscreteSystem, params, x0, u_sequence, t0=0.0,
                      steps: Optional[int] = None, record: Optional[Callable] = None):
    """Roll out a discrete system over an input sequence (..., N, nu): the
    states (..., N+1, nx) including x0.

    With ``steps`` or ``record`` the loop keeps no states: it returns (the
    state after the last step, the records or None), where ``record(x)``
    of the state after each step (a tensor or a tuple of them) is stacked
    on a new leading axis.  ``u_sequence`` may then also be None (no
    input), a tensor (..., nu) held every step, or ``callable(k, x)``; the
    number of steps is ``steps``, else the sequence's length.  The loop is
    eager (a converged SAP step asks the host whether a lane still runs,
    which a CUDA graph cannot capture); the records stay on the device
    until the end."""
    if steps is None and record is None:
        x, t = x0, torch.tensor(t0, dtype=x0.dtype, device=x0.device)
        xs = [x0]
        for k in range(u_sequence.shape[-2]):
            x = system.g(params, x, u_sequence[..., k, :], t)
            t = t + system.time_step
            xs.append(x)
        return torch.stack(xs, dim=-2)
    if callable(u_sequence):
        u_at = u_sequence
    elif u_sequence is None:
        zero = x0.new_zeros(x0.shape[:-1] + (system.num_inputs,))
        u_at = lambda k, x: zero  # noqa: E731
    elif steps is None:
        steps = u_sequence.shape[-2]
        u_at = lambda k, x: u_sequence[..., k, :]  # noqa: E731
    else:
        u_at = lambda k, x: u_sequence  # noqa: E731
    x, t = x0, torch.tensor(t0, dtype=x0.dtype, device=x0.device)
    rows = []
    for k in range(steps):
        x = system.g(params, x, u_at(k, x), t)
        t = t + system.time_step
        if record is not None:
            rows.append(record(x))
    if record is None:
        return x, None
    if isinstance(rows[0], tuple):
        return x, tuple(torch.stack(col) for col in zip(*rows))
    return x, torch.stack(rows)


def batch_simulate(system, params, x0_batch, u_batch, dt, method: str = "rk4"):
    """Batched rollouts, x0_batch (B, nx) and u_batch (B, N, nu): the
    reference's vmap of ``simulate``."""
    return simulate(system, params, x0_batch, u_batch, dt, method=method)


# The adaptive loop asks the host whether any lane is still running once
# every this many iterations (each question waits for the device).
_CHECK_EVERY = 4


def simulate_adaptive(system: ContinuousSystem, params, x0, u_fn: Callable, t_final, t0=0.0,
                      accuracy: float = 1e-6, h0: float = 1e-3, h_min: float = 1e-9,
                      h_max: float = 1.0, max_steps: int = 100_000):
    """Error-controlled Dormand-Prince 5(4) to t_final, lane by lane.

    The reference's ``while_loop`` runs here over all lanes (the leading
    dimensions of ``x0``) with a per-lane mask: a lane that has reached
    t_final (or ``max_steps``) keeps its t, x, h, steps and rejects, as under
    ``vmap``; the host asks every few iterations whether a lane still runs,
    and ``max_steps`` bounds the loop.  The step-size rule is the
    reference's (error ratio^(-1/5) with a safety factor, clipped).
    ``u_fn(t, x)`` supplies the input, t of shape (...); inside a step the
    dynamics see times of shape (..., 1).  Returns (x_final, stats)."""
    safety = 0.9
    batch = x0.shape[:-1]
    t = torch.full(batch, float(t0), dtype=x0.dtype, device=x0.device)
    h = torch.full(batch, float(h0), dtype=x0.dtype, device=x0.device)
    steps = torch.zeros(batch, dtype=torch.long, device=x0.device)
    rejects = torch.zeros_like(steps)
    x = x0
    for k in range(max_steps):
        active = (t < t_final) & (steps < max_steps)
        if k % _CHECK_EVERY == 0 and not bool(active.any()):
            break
        with record_function("adaptive.step"):
            h_eff = torch.minimum(h, t_final - t)
            x_new, err = _integrators.step_error_controlled(
                system.f, params, x, u_fn(t, x), t[..., None], h_eff[..., None])
            scale = accuracy + accuracy * torch.maximum(torch.abs(x), torch.abs(x_new))
            e = torch.sqrt(torch.mean((err / scale) ** 2, dim=-1))
            accept = e <= 1.0
            # e ** -0.2 is inf at e = 0: the power sees 1 there (and its
            # gradient no inf).
            positive = e > 0
            factor = safety * torch.where(positive, torch.where(positive, e, 1.0) ** (-0.2), 5.0)
            h_next = torch.clamp(h_eff * torch.clamp(factor, 0.2, 5.0), h_min, h_max)
            take = active & accept
            t = torch.where(take, t + h_eff, t)
            x = torch.where(take[..., None], x_new, x)
            h = torch.where(active, h_next, h)
            steps = steps + active.long()
            rejects = rejects + (active & ~accept).long()
    return x, {"num_steps": steps, "num_rejected": rejects, "final_time": t}


# ---------------------------------------------------------------------------
# Hybrid simulation: witness functions and state resets.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WitnessFunction:
    """A state-triggered event (Drake's witness_function.h and the
    simulator's isolation loop).

    ``g(params, x, t) -> (...)``: the event fires when g crosses zero in
    ``direction`` within a step; the crossing is isolated by fixed-count
    bisection and ``reset(params, x, t) -> x_new`` is applied there.

    direction: "positive_then_negative" | "negative_then_positive" |
    "crosses_zero"."""

    g: Callable
    reset: Callable
    direction: str = "positive_then_negative"

    def triggered(self, g0, g1):
        if self.direction == "positive_then_negative":
            return (g0 > 0) & (g1 <= 0)
        if self.direction == "negative_then_positive":
            return (g0 < 0) & (g1 >= 0)
        return torch.sign(g0) * torch.sign(g1) < 0


def simulate_hybrid(system: ContinuousSystem, params, x0, t_final: float, dt: float, witnesses,
                    u_fn: Optional[Callable] = None, method: str = "rk4",
                    bisection_iters: int = 24):
    """Fixed-macro-step rollout with witness isolation and resets.

    Each macro step integrates dt and checks every witness for a sign
    change; in a lane where one fired, the earliest crossing is bisected to
    dt / 2^bisection_iters, that witness's reset applied there, and the rest
    of the step integrated from the reset state.  One event per macro step,
    as the reference.  The lanes ride in the leading dimensions of ``x0``.

    The isolation runs only in a step where some lane triggered: a lane
    without a trigger takes the plain step, as under the reference's
    ``cond`` (and ``vmap``'s select), so the results are the reference's.
    On the card with autograd off the step is a CUDA graph and the
    isolation another, replayed after the host has read whether any lane
    triggered; elsewhere both run eagerly.  Times inside the isolation are
    per lane: witnesses and resets get (...), the dynamics (..., 1).
    ``u_fn(params, x, t)`` supplies the input (zero without it).

    Returns (xs (..., N+1, nx), ts (N+1,), event_counts (..., n_witness))."""
    witnesses = tuple(witnesses)
    step = _integrators.get(method)
    nstep = int(round(t_final / dt))
    nw = len(witnesses)
    batch = x0.shape[:-1]
    dev = x0.device

    def u_of(x, t):
        if u_fn is None:
            return x.new_zeros(x.shape[:-1] + (system.num_inputs,))
        return u_fn(params, x, t)

    def integrate(x, t, h):
        return step(system.f, params, x, u_of(x, t), t, h)

    def probe(x, t):
        """The plain step and the triggers: (x1, g0s (..., nw), trig)."""
        x1 = integrate(x, t, dt)
        g0s = torch.stack([w.g(params, x, t) for w in witnesses], dim=-1)
        g1s = torch.stack([w.g(params, x1, t + dt) for w in witnesses], dim=-1)
        trig = torch.stack([w.triggered(g0s[..., i], g1s[..., i])
                            for i, w in enumerate(witnesses)], dim=-1)
        return x1, g0s, trig

    def isolate(i, x, t, g0):
        """Bisect the crossing fraction of witness i in [0, 1], per lane."""
        lo = torch.zeros_like(g0)
        hi = torch.ones_like(g0)
        s0 = torch.sign(g0)
        for _ in range(bisection_iters):
            mid = 0.5 * (lo + hi)
            gm = witnesses[i].g(params, integrate(x, t, (mid * dt)[..., None]), t + mid * dt)
            crossed = s0 * torch.sign(gm) <= 0
            lo = torch.where(crossed, lo, mid)
            hi = torch.where(crossed, mid, hi)
        return hi

    def handle(x, t, x1, g0s, trig):
        """The step of the lanes that triggered: (x_next, counts' increment)."""
        with record_function("hybrid.isolate"):
            alphas = torch.stack(
                [torch.where(trig[..., i], isolate(i, x, t, g0s[..., i]), torch.inf)
                 for i in range(nw)], dim=-1)
        any_trig = trig.any(dim=-1)
        first = torch.argmin(alphas, dim=-1)
        alpha = torch.where(any_trig, alphas.min(dim=-1).values, 1.0)
        t_ev = t + alpha * dt
        x_ev = integrate(x, t, (alpha * dt)[..., None])
        # A lane without a trigger resets x1 and discards it: its gradient
        # stops at the reset's input, so a reset that is not finite away
        # from its event sends no NaN back.
        x_in = torch.where(any_trig[..., None], x_ev, x_ev.detach())
        x_reset = witnesses[0].reset(params, x_in, t_ev)
        for i in range(1, nw):
            x_reset = torch.where((first == i)[..., None],
                                  witnesses[i].reset(params, x_in, t_ev), x_reset)
        x_h = integrate(x_reset, t_ev[..., None], ((1.0 - alpha) * dt)[..., None])
        hit = (torch.arange(nw, device=dev) == first[..., None]) & any_trig[..., None]
        return torch.where(any_trig[..., None], x_h, x1), hit.to(torch.int32)

    t = torch.zeros((), dtype=x0.dtype, device=dev)
    counts = torch.zeros(batch + (nw,), dtype=torch.int32, device=dev)
    ts = _times(0.0, dt, nstep, x0)
    if nstep == 0:
        return x0.unsqueeze(-2), ts, counts
    if dev.type == "cuda" and not torch.is_grad_enabled():
        xs = _hybrid_graphed(probe, handle, x0, t, counts, nstep, dt)
        return torch.cat([x0.unsqueeze(-2), xs[0].movedim(0, -2)], dim=-2), ts, xs[1]
    x = x0
    xs = [x0]
    for _ in range(nstep):
        with record_function("hybrid.macro"):
            x1, g0s, trig = probe(x, t)
            if bool(trig.any()):
                x1, inc = handle(x, t, x1, g0s, trig)
                counts = counts + inc
        x, t = x1, t + dt
        xs.append(x)
    return torch.stack(xs, dim=-2), ts, counts


def _hybrid_graphed(probe, handle, x0, t0, counts, nstep, dt):
    """simulate_hybrid's loop on the card: the step (the plain step, its
    triggers, and its commit of x1) and the isolation (which recomputes the
    step's end from the state before it and overwrites the commit) are two
    CUDA graphs on static buffers; the host reads one flag a step and
    replays the isolation where it is set."""
    x = x0.clone()
    t = t0.clone()
    counts = counts.clone()
    x_prev, t_prev = x.clone(), t.clone()
    k = torch.zeros(1, dtype=torch.long, device=x.device)
    xs = x.new_empty((nstep,) + x.shape)
    saved = {}
    flag = torch.zeros((), dtype=torch.bool, device=x.device)

    def plain():
        x_prev.copy_(x)
        t_prev.copy_(t)
        x1, g0s, trig = probe(x_prev, t_prev)
        saved.update(x1=x1, g0s=g0s, trig=trig)
        flag.copy_(trig.any())
        x.copy_(x1)
        t.copy_(t_prev + dt)
        xs.index_copy_(0, k, x.unsqueeze(0))
        k.add_(1)

    def event():
        x_next, inc = handle(x_prev, t_prev, saved["x1"], saved["g0s"], saved["trig"])
        x.copy_(x_next)
        counts.add_(inc)
        xs.index_copy_(0, k - 1, x.unsqueeze(0))

    # The warm-up runs of the two (on a side stream) leave the buffers as
    # one plain step from x0 would; put them back before the capture.
    plain_graph = capture(plain)
    event_graph = capture(event)
    x.copy_(x0)
    t.copy_(t0)
    counts.zero_()
    k.zero_()
    for _ in range(nstep):
        with record_function("hybrid.macro"):
            plain_graph.replay()
            if bool(flag):
                with record_function("hybrid.isolate"):
                    event_graph.replay()
    return xs, counts


def dense_output(system: ContinuousSystem, params, xs, ts, us):
    """C1 Hermite interpolant of a simulation trace (Drake's
    HermitianDenseOutput role): the knot derivatives recomputed from the
    dynamics (the last input held at the final knot), then
    ``PiecewisePolynomial.cubic_hermite``.

    xs (N+1, nx), ts (N+1,), us (N, nu).  Returns a PiecewisePolynomial on
    [ts[0], ts[-1]]."""
    from drake_tpu_torch.math.trajectories import PiecewisePolynomial

    us_knots = torch.cat([us, us[-1:]], dim=0)
    xdots = system.f(params, xs, us_knots, ts)
    return PiecewisePolynomial.cubic_hermite(ts, xs, xdots)
