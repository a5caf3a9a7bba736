"""Acrobot swing-up by Spong's controller, then the LQR balance.

The port of ``examples/acrobot_spong.py`` (reference
examples/acrobot/run_swing_up.cc with spong_controller.h): collocated
partial feedback linearization and energy shaping pump the acrobot up from
[0.1, 0, 0, 0] near hanging rest, and the LQR holds [pi, 0, 0, 0] once the
wrapped state enters its ellipse; 12,000 rk4 steps at dt 0.002.  Then 64
starts perturbed by 0.05 N(0, 1) run in one call.

    python -m drake_tpu_torch.examples.acrobot_spong [--cpu] [--batch 64]

Float32 on the card, float64 with ``--cpu``, as the reference example.  The
perturbations come from a ``torch.Generator`` seeded 0 (not the reference's
``PRNGKey(0)`` draws).  The gates are the reference's: the single swing-up
within 1e-2 of upright, and at least 90% of the lanes; prints ``SUCCESS`` or
``FAILURE`` and exits 1 on FAILURE.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from drake_tpu_torch.control.energy_shaping import acrobot_spong_controller
from drake_tpu_torch.models import acrobot
from drake_tpu_torch.systems.simulator import simulate_controlled
from drake_tpu_torch.utils.device import resolve_device

STEPS, DT = 12000, 0.002
BATCH = 64
X0 = (0.1, 0.0, 0.0, 0.0)


def draws(batch=BATCH, seed=0):
    """The batch's perturbations, 0.05 N(0, 1), (batch, 4) float64."""
    return 0.05 * torch.randn((batch, 4), dtype=torch.float64,
                              generator=torch.Generator().manual_seed(seed))


def _wrap(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def run(dtype=torch.float32, device=None, batch=BATCH, perturb=None, steps=STEPS) -> dict:
    """The single swing-up and the batch from X0 plus the rows of `perturb`
    ((batch, 4), default ``draws(batch)``), with each one's seconds."""
    device = resolve_device(device)
    p = acrobot.default_params(dtype, device)
    pol = acrobot_spong_controller(p)
    system = acrobot.make_system(p)
    x0 = torch.tensor(X0, dtype=dtype, device=device)
    perturb = draws(batch) if perturb is None else perturb
    seconds = {}

    def rollout(starts, name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        xs, us, _ = simulate_controlled(system, p, starts, lambda ps, x, tt: pol(x, tt), steps, DT)
        xf = xs[:, -1]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[name] = time.perf_counter() - t
        return xf, us

    with torch.no_grad():
        xf, us = rollout(x0[None], "single")
        xfb, _ = rollout(x0 + torch.as_tensor(perturb, dtype=dtype, device=device), "batch")
    err = float(torch.max(torch.cat([_wrap(xf[0, :1] - math.pi), _wrap(xf[0, 1:2]),
                                     xf[0, 2:]]).abs()))
    errs = torch.maximum(_wrap(xfb[:, 0] - math.pi).abs(), _wrap(xfb[:, 1]).abs())
    return {"xf": xf[0], "err": err, "u_max": float(us.abs().max()), "errs": errs,
            "n_up": int(torch.sum(errs < 1e-2)), "batch": xfb.shape[0], "seconds": seconds}


def gates(out) -> bool:
    return out["err"] < 1e-2 and out["n_up"] >= int(0.9 * out["batch"])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="float64 on the CPU")
    parser.add_argument("--batch", type=int, default=BATCH)
    args = parser.parse_args(argv)
    out = run(torch.float64 if args.cpu else torch.float32, "cpu" if args.cpu else None,
              args.batch)
    print(f"single swing-up: final state {out['xf'].tolist()}, upright err {out['err']:.2e} "
          f"({out['seconds']['single']:.2f} s)")
    print(f"batched: {out['n_up']}/{out['batch']} balanced upright (max err "
          f"{float(out['errs'].max()):.2e}, {out['seconds']['batch']:.2f} s)")
    ok = gates(out)
    print("SUCCESS" if ok else "FAILURE")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
