"""Monte-Carlo optimization of the Spong controller's gains over lanes.

The port of ``examples/acrobot_spong_optimize.py`` (reference
examples/acrobot/optimizer_demo.py, spong_sim.py and metrics.py): scenarios
are hanging starts perturbed by 0.2 N(0, 1); each candidate gain triple
(k_e, k_p, k_d) is scored by the mean over the scenarios of the final
deviation from upright (metrics.py's final_state_cost) after 6,000 rk4 steps
at dt 0.002; a cross-entropy search over the log gains replaces the
reference's Nelder-Mead.  Every scenario of every candidate is one lane of
one rollout: 32 scenarios x 8 candidates = 256 lanes.

    python -m drake_tpu_torch.examples.acrobot_spong_optimize [--cpu]
        [--scenarios 32] [--candidates 8] [--iters 4]

Float32 on the card, float64 with ``--cpu``, as the reference example.  The
scenarios and the search's draws come from one ``torch.Generator`` seeded 7
(not the reference's ``PRNGKey(7)`` stream).  The gate is the reference's:
the best ensemble cost no worse than the default gains' (5, 50, 5) and
below 1.0; prints ``SUCCESS`` or ``FAILURE`` and exits 1 on FAILURE.
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

DT, STEPS = 2e-3, 6000
SCENARIOS, CANDIDATES, ITERS = 32, 8, 4
DEFAULT_GAINS = (5.0, 50.0, 5.0)


def draws(scenarios=SCENARIOS, candidates=CANDIDATES, iters=ITERS, seed=7):
    """(x0s (scenarios, 4), eps (iters, candidates, 3)), float64: the
    scenarios' 0.2 N(0, 1) starts, then each iteration's N(0, 1) draws."""
    gen = torch.Generator().manual_seed(seed)
    x0s = 0.2 * torch.randn((scenarios, 4), dtype=torch.float64, generator=gen)
    return x0s, torch.randn((iters, candidates, 3), dtype=torch.float64, generator=gen)


def _wrap(a, lo, hi):
    return torch.remainder(a - lo, hi - lo) + lo


def final_cost(xf):
    """metrics.py's deviation_from_upright_equilibrium, its norm a lane."""
    dev = torch.stack([_wrap(xf[..., 0], 0.0, 2 * math.pi) - math.pi,
                       _wrap(xf[..., 1], -math.pi, math.pi), xf[..., 2], xf[..., 3]], dim=-1)
    return torch.linalg.vector_norm(dev, dim=-1)


def ensemble_cost(p, gains, x0s, steps=STEPS):
    """The mean final cost over the scenarios x0s (S, 4) of each gain triple
    of gains (C, 3): one rollout of C x S lanes.  Returns (C,)."""
    C, S = gains.shape[0], x0s.shape[0]
    g = gains.repeat_interleave(S, dim=0)
    pol = acrobot_spong_controller(p, k_e=g[:, 0], k_p=g[:, 1], k_d=g[:, 2])
    xs, _, _ = simulate_controlled(acrobot.make_system(p), p, x0s.repeat(C, 1),
                                   lambda ps, x, t: pol(x, t), steps, DT)
    return final_cost(xs[:, -1]).reshape(C, S).mean(dim=-1)


def run(dtype=torch.float32, device=None, scenarios=SCENARIOS, candidates=CANDIDATES,
        iters=ITERS, noise=None, steps=STEPS) -> dict:
    """The search from `noise` = (x0s, eps) (default ``draws(...)``); every
    round's costs and the host seconds of each ensemble call."""
    device = resolve_device(device)
    p = acrobot.default_params(dtype, device)
    x0s, eps = draws(scenarios, candidates, iters) if noise is None else noise
    x0s = torch.as_tensor(x0s, dtype=dtype, device=device)
    eps = torch.as_tensor(eps, dtype=dtype, device=device)
    mean = torch.log(torch.tensor(DEFAULT_GAINS, dtype=dtype, device=device))
    std = torch.full((3,), 0.4, dtype=dtype, device=device)
    n_elite = max(2, candidates // 4)
    seconds, rounds = [], []

    def ensemble(gains):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        costs = ensemble_cost(p, gains, x0s, steps)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t)
        return costs

    with torch.no_grad():
        base_cost = float(ensemble(torch.exp(mean)[None])[0])
        best_gains, best_cost = torch.exp(mean), base_cost
        for it in range(iters):
            sample = mean + std * eps[it]
            costs = ensemble(torch.exp(sample))
            i_best = int(torch.argmin(costs))
            if float(costs[i_best]) < best_cost:
                best_cost, best_gains = float(costs[i_best]), torch.exp(sample[i_best])
            elite = sample[torch.argsort(costs)[:n_elite]]
            mean = torch.mean(elite, dim=0)
            std = torch.std(elite, dim=0, correction=0) + 0.02
            rounds.append(costs)
    return {"base_cost": base_cost, "best_cost": best_cost, "best_gains": best_gains,
            "rounds": rounds, "seconds": seconds, "lanes": candidates * scenarios}


def gates(out) -> bool:
    return out["best_cost"] <= out["base_cost"] + 1e-6 and out["best_cost"] < 1.0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="float64 on the CPU")
    parser.add_argument("--scenarios", type=int, default=SCENARIOS)
    parser.add_argument("--candidates", type=int, default=CANDIDATES)
    parser.add_argument("--iters", type=int, default=ITERS)
    args = parser.parse_args(argv)
    out = run(torch.float64 if args.cpu else torch.float32, "cpu" if args.cpu else None,
              args.scenarios, args.candidates, args.iters)
    print(f"reference gains {DEFAULT_GAINS}: ensemble cost {out['base_cost']:.4f}")
    best = out["base_cost"]
    for it, costs in enumerate(out["rounds"]):
        best = min(best, float(costs.min()))
        print(f"iter {it}: round best {float(costs.min()):.4f}, incumbent {best:.4f} "
              f"({out['lanes']} lanes, {out['seconds'][it + 1]:.2f} s)")
    print(f"optimized gains {[round(v, 2) for v in out['best_gains'].tolist()]}: ensemble cost "
          f"{out['best_cost']:.4f} (reference-default {out['base_cost']:.4f})")
    ok = gates(out)
    print("SUCCESS" if ok else "FAILURE")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
