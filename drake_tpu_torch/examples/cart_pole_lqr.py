"""Cart-pole: LQR balance about the upright, and its basin over 256 lanes.

The port of ``examples/cart_pole_lqr.py`` (reference
examples/multibody/cart_pole): the LQR of the linearization at the upright
(Q = diag(100, 50, 5, 5), R = [1]) recovers from [0.1, 0.15, 0, 0] off it
while the open loop falls; then 256 starts perturbed by 0.2 N(0, 1) run in
one call.  800 rk4 steps at dt 0.01.

    python -m drake_tpu_torch.examples.cart_pole_lqr [--cpu]

Float32 on the card, float64 with ``--cpu``, as the reference example.  The
perturbations come from a ``torch.Generator`` seeded 0 (not the reference's
``PRNGKey(0)`` draws).  The gates are the reference's: closed-loop error
below 1e-2, open-loop above 0.5, more than 200 of 256 starts within 5e-2;
prints ``CART-POLE LQR OK`` or ``FAILURE`` and exits 1 on FAILURE.
"""

from __future__ import annotations

import argparse
import time

import torch

from drake_tpu_torch.control import lqr
from drake_tpu_torch.models import cart_pole
from drake_tpu_torch.systems import simulator
from drake_tpu_torch.utils.device import resolve_device

DT, STEPS = 0.01, 800
LANES = 256
PERTURB = (0.1, 0.15, 0.0, 0.0)


def draws(lanes=LANES, seed=0):
    """The basin sweep's perturbations, 0.2 N(0, 1), (lanes, 4) float64."""
    return 0.2 * torch.randn((lanes, 4), dtype=torch.float64,
                             generator=torch.Generator().manual_seed(seed))


def run(dtype=torch.float32, device=None, perturb=None, steps=STEPS) -> dict:
    """The closed and open loops from one start, then the sweep over the
    rows of `perturb` ((L, 4), default ``draws()``), in one call."""
    device = resolve_device(device)
    params = cart_pole.default_params(dtype, device)
    system = cart_pole.make_system(params)
    x_star = cart_pole.upright_state(dtype, device)
    A, B = system.linearize(params, x_star, x_star.new_zeros(1))
    Q = torch.diag(torch.tensor([100.0, 50.0, 5.0, 5.0], dtype=dtype, device=device))
    K = lqr.lqr(A, B, Q, torch.eye(1, dtype=dtype, device=device)).K

    def policy(p, x, t):
        return -((x - x_star) @ K.mT)

    perturb = draws() if perturb is None else perturb
    x0 = (x_star + torch.tensor(PERTURB, dtype=dtype, device=device))[None]
    with torch.no_grad():
        xs, _, _ = simulator.simulate_controlled(system, params, x0, policy, steps, DT)
        xs_ol, _ = simulator.simulate(system, params, x0, x0.new_zeros((1, steps, 1)), DT)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        xs_b, _, _ = simulator.simulate_controlled(
            system, params, x_star + torch.as_tensor(perturb, dtype=dtype, device=device), policy,
            steps, DT)
        errs = torch.linalg.vector_norm(xs_b[:, -1] - x_star, dim=-1)
        n_stable = int(torch.sum(errs < 5e-2))
    return {"K": K, "err_cl": float(torch.linalg.vector_norm(xs[0, -1] - x_star)),
            "err_ol": float(torch.linalg.vector_norm(xs_ol[0, -1] - x_star)), "errs": errs,
            "n_stable": n_stable, "lanes": errs.shape[0], "sweep_s": time.perf_counter() - t}


def gates(out) -> bool:
    return out["err_cl"] < 1e-2 and out["err_ol"] > 0.5 and out["n_stable"] > 200


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="float64 on the CPU")
    args = parser.parse_args(argv)
    out = run(torch.float64 if args.cpu else torch.float32, "cpu" if args.cpu else None)
    print(f"LQR gain K = {[round(v, 2) for v in out['K'][0].tolist()]}")
    print(f"closed-loop final error {out['err_cl']:.2e} vs open-loop {out['err_ol']:.2f}")
    print(f"basin sweep: {out['n_stable']}/{out['lanes']} perturbed starts recovered "
          f"({out['sweep_s']:.2f} s)")
    ok = gates(out)
    print("CART-POLE LQR OK" if ok else "FAILURE")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
