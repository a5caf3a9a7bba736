"""Rimless wheel: passive dynamic walking by hybrid witness simulation.

The port of ``examples/rimless_wheel.py`` (Drake's rimless_wheel.h): a wheel
of k massless spokes of length l with a point mass at the hub rolls down a
slope gamma.  Between impacts it is an inverted pendulum th'' = (g/l)
sin(th); when th reaches alpha + gamma the next spoke strikes and th' ->
cos(2 alpha) th', th -> gamma - alpha (alpha = pi / k).  Run on
``simulator.simulate_hybrid`` (witness isolation by bisection, the reset at
the event), the post-impact speed is held to the closed-form limit cycle

    w*^2 = cos^2(2a) (2g/l)(cos(g - a) - cos(g + a)) / (1 - cos^2(2a)).

Checks (the reference's): more than 10 strikes, and the last post-impact
speed within 2% of w*.

Run:  python -m drake_tpu_torch.examples.rimless_wheel [--cpu]
(float32 on the card by default; --cpu is float64 on the CPU).
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

# Drake's defaults (rimless_wheel_params): mass 1, length 1, gravity 9.81,
# 8 spokes, slope 0.08.
G, L, K, SLOPE = 9.81, 1.0, 8, 0.08
ALPHA = math.pi / K
PUSH = 1.2  # initial speed: enough to carry over the first apex
T_FINAL, DT = 20.0, 1e-3


def make_system():
    """(the ContinuousSystem, the touchdown WitnessFunction)."""
    from drake_tpu_torch.systems.base import ContinuousSystem
    from drake_tpu_torch.systems.simulator import WitnessFunction
    from drake_tpu_torch.utils.device import constant

    def f(params, x, u, t):
        return torch.stack([x[..., 1], (G / L) * torch.sin(x[..., 0])], dim=-1)

    def reset(p, x, t):
        # The reference's jnp.asarray(slope - alpha, dtype) and
        # cos(2 asarray(alpha, dtype)), as constants of the state's type.
        th = constant(SLOPE - ALPHA, x).expand(x.shape[:-1])
        return torch.stack([th, torch.cos(2 * constant(ALPHA, x)) * x[..., 1]], dim=-1)

    touchdown = WitnessFunction(g=lambda p, x, t: (SLOPE + ALPHA) - x[..., 0], reset=reset,
                                direction="positive_then_negative")
    return ContinuousSystem(f=f, num_states=2, num_inputs=0), touchdown


def w_star():
    """The analytic steady post-impact speed."""
    c2 = math.cos(2 * ALPHA) ** 2
    return math.sqrt(c2 * (2 * G / L) * (math.cos(SLOPE - ALPHA) - math.cos(SLOPE + ALPHA))
                     / (1.0 - c2))


def rollout(pushes, t_final=T_FINAL, dt=DT):
    """simulate_hybrid from th = slope - alpha at the initial speeds
    `pushes` (a tensor (...,) on the device of the run): (xs, counts)."""
    from drake_tpu_torch.systems.simulator import simulate_hybrid

    system, touchdown = make_system()
    x0 = torch.stack([torch.full_like(pushes, SLOPE - ALPHA), pushes], dim=-1)
    with torch.no_grad():
        xs, _, counts = simulate_hybrid(system, None, x0, t_final, dt, witnesses=(touchdown,))
    return xs, counts


def post_impact_speed(xs):
    """The speed just after the last reset of each lane's trace (numpy)."""
    xs = np.asarray(xs)
    th, w = xs[..., 0], xs[..., 1]
    flat_th, flat_w = th.reshape(-1, th.shape[-1]), w.reshape(-1, w.shape[-1])
    out = []
    for a, b in zip(flat_th, flat_w):
        resets = np.where(np.diff(a) < -ALPHA)[0]
        out.append(b[resets[-1] + 1] if len(resets) else float("nan"))
    return np.asarray(out).reshape(th.shape[:-1])


def run(device=None, dtype=torch.float32, t_final=T_FINAL, dt=DT, verbose: bool = True):
    """The demo: returns its readings (strikes, the measured and analytic
    post-impact speeds, ``ok``, the seconds of the rollout)."""
    from drake_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    start = time.perf_counter()
    xs, counts = rollout(torch.tensor(PUSH, dtype=dtype, device=device), t_final, dt)
    xs = xs.cpu().numpy()
    seconds = time.perf_counter() - start
    strikes = int(counts[0])
    w_meas = float(post_impact_speed(xs))
    err = abs(w_meas - w_star()) / w_star()
    ok = strikes > 10 and err < 2e-2
    if verbose:
        print(f"spokes struck: {strikes} over {t_final}s")
        print(f"steady post-impact speed: measured {w_meas:.4f}, analytic {w_star():.4f} rad/s "
              f"(rel err {err:.1e})")
        print("RIMLESS_WHEEL", "OK" if ok else "FAILURE")
    return {"strikes": strikes, "w_meas": w_meas, "w_star": w_star(), "err": err, "ok": ok,
            "xs": xs, "seconds": seconds}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="float64 on the CPU")
    args = ap.parse_args(argv)
    out = run(device="cpu" if args.cpu else None,
              dtype=torch.float64 if args.cpu else torch.float32)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
