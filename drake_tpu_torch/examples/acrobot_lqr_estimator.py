"""Acrobot output-feedback balance: LQR on a steady-state Kalman filter's
estimate.

The port of ``examples/acrobot_lqr_estimator.py`` (reference
examples/acrobot/run_lqr_w_estimator.cc): only the two joint angles are
measured (C = [I 0]), with noise 0.002 N(0, 1); a steady-state Kalman filter
(W = I, V = 0.1 I, ibid:70-72) as a Luenberger observer reconstructs the
velocities, and the upright LQR (Q = diag(10, 10, 1, 1), R = [1]) acts on
the estimate.  The plant starts at the upright plus [0.02, -0.01, 0.05,
-0.05], the observer at the upright; 5,000 rk4 steps at dt 1e-3, plant and
observer in one step loop (``utils.scan``).

    python -m drake_tpu_torch.examples.acrobot_lqr_estimator [--cpu]

Float32 on the card, float64 with ``--cpu``, as the reference example.  The
measurement noise comes from a ``torch.Generator`` seeded 0 (not the
reference's ``PRNGKey(0)`` keys).  The gates are the reference's: the final
state and estimate errors below 5e-2; prints ``SUCCESS`` or ``FAILURE`` and
exits 1 on FAILURE.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from drake_tpu_torch.control.estimators import luenberger_observer, steady_state_kalman_filter
from drake_tpu_torch.control.lqr import lqr
from drake_tpu_torch.models import acrobot
from drake_tpu_torch.systems import integrators
from drake_tpu_torch.utils.device import resolve_device
from drake_tpu_torch.utils.scan import scan

DT, STEPS = 1e-3, 5000
NOISE = 0.002
X0_OFFSET = (0.02, -0.01, 0.05, -0.05)


def draws(steps=STEPS, seed=0):
    """The measurement noise's N(0, 1) draws, (steps, 2) float64."""
    return torch.randn((steps, 2), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(seed))


def run(dtype=torch.float32, device=None, noise=None, steps=STEPS) -> dict:
    """The closed loop with the rows of `noise` ((steps, 2), default
    ``draws()``) as each step's measurement noise before scaling."""
    device = resolve_device(device)
    p = acrobot.default_params(dtype, device)
    system = acrobot.make_system(p)
    x_up = torch.tensor([math.pi, 0.0, 0.0, 0.0], dtype=dtype, device=device)
    A, B = system.linearize(p, x_up, x_up.new_zeros(1))
    eye = lambda n: torch.eye(n, dtype=dtype, device=device)  # noqa: E731
    K = lqr(A, B, torch.diag(torch.tensor([10.0, 10.0, 1.0, 1.0], dtype=dtype, device=device)),
            eye(1)).K
    C = torch.cat([eye(2), torch.zeros((2, 2), dtype=dtype, device=device)], dim=1)
    L = steady_state_kalman_filter(A, C, eye(4), 0.1 * eye(2)).L
    observe = luenberger_observer(system, p, L, C, DT)
    rk4 = integrators.get("rk4")
    noise = torch.as_tensor(draws(steps) if noise is None else noise, dtype=dtype, device=device)

    def step(carry):
        x, xhat, k = carry
        u = -((xhat - x_up) @ K.mT)
        y = x @ C.mT + NOISE * noise.index_select(0, k)
        return (rk4(system.f, p, x, u, 0.0, DT), observe(xhat, u, y), k + 1), (x, xhat, u)

    x0 = (x_up + torch.tensor(X0_OFFSET, dtype=dtype, device=device))[None]
    with torch.no_grad():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        _, (xs, xhats, us) = scan(step, (x0, x_up[None], torch.zeros(1, dtype=torch.long,
                                                                      device=device)), steps)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t
    return {"err_final": float(torch.linalg.vector_norm(xs[-1, 0] - x_up)),
            "est_err": float(torch.linalg.vector_norm(xhats[-1, 0] - xs[-1, 0])),
            "xs": xs[:, 0], "xhats": xhats[:, 0], "us": us[:, 0], "L": L, "K": K,
            "seconds": seconds}


def gates(out) -> bool:
    return out["err_final"] < 5e-2 and out["est_err"] < 5e-2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="float64 on the CPU")
    args = parser.parse_args(argv)
    out = run(torch.float64 if args.cpu else torch.float32, "cpu" if args.cpu else None)
    print(f"final state error  |x - x_up|   = {out['err_final']:.2e}")
    print(f"final estimate err |xhat - x|   = {out['est_err']:.2e} ({out['seconds']:.2f} s)")
    ok = gates(out)
    print("SUCCESS" if ok else "FAILURE")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
