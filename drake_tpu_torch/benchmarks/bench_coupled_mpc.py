"""BASELINE config 5: MPPI through the coupled MPM + rigid world, with its
quality fields (``benchmarks/bench_coupled_mpc.py`` of the JAX package).

B perturbed scenarios of the paddle-pushes-blob task; each runs an MPPI
controller (M samples, horizon 10 coupled steps of 10 substeps) for N MPC
steps.  Every solve folds the B x M samples into B M lanes of one batched
``CoupledWorld.step``, all scenarios in one call (the reference ran one
scenario a call on its TPU).

    python -m drake_tpu_torch.benchmarks.bench_coupled_mpc [--scenarios 32]
        [--samples 8] [--steps 50] [--seed 0]

Prints one JSON line: solves/s (B N over the host-clock wall of the timed
rollout, which ends in a synchronise), scenarios that reach the goal (final
blob centroid within 6 cm of x = 0.55, all state finite), median final
error, non-finite scenarios, the largest ``dropped`` of any lane and substep
(asserted 0), peak memory and the card.

Stated differences from the reference: the blob start offsets
(0.04 (U - 0.5), U uniform) come from a ``torch.Generator`` seeded
``--seed`` and the MPPI perturbations from another seeded ``--seed + 1``,
not from JAX's ``PRNGKey(0)`` and ``PRNGKey(1)``; the warm-up is one MPC
step of the same program, not the full rollout.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from drake_tpu_torch.benchmarks import paddle_blob
from drake_tpu_torch.control import mppi
from drake_tpu_torch.utils.device import resolve_device

GOAL_TOL = 0.06  # m: a scenario reaches the goal within this error
HORIZON = 10  # coupled steps per MPPI rollout


def make_problem(scenarios: int, samples: int, seed: int, device=None):
    """(world bundle, initial states (B lanes), MPPI options, the dynamics
    and a tensor that holds the largest ``dropped`` of each scenario seen by
    any dynamics call), in float32."""
    device = resolve_device(device)
    w = paddle_blob.build(device=device)
    offsets = torch.Generator(device="cpu").manual_seed(seed)
    dx0 = 0.04 * (torch.rand(scenarios, generator=offsets, dtype=torch.float64) - 0.5)
    s0 = paddle_blob.shifted(paddle_blob.lanes(w.state0, scenarios), dx0.float().to(device))
    opts = mppi.MppiOptions(
        num_samples=samples, temperature=0.05, noise_sigma=8.0,
        u_lower=(-25.0,), u_upper=(25.0,),
    )
    dropped = torch.zeros(scenarios, dtype=torch.int32, device=device)

    def dynamics(s, u):
        out = w.world.step(w.params, s, u)
        # Lanes are scenarios, or scenario-major samples of the MPPI batch.
        per = out.particles.dropped.reshape(scenarios, -1).amax(dim=1)
        torch.maximum(dropped, per, out=dropped)
        return out

    return w, s0, opts, dynamics, dropped


def quality(states):
    """Of the states a rollout returns: each scenario's final error of the
    blob's centroid from the goal (B,), whether its state is finite (B,),
    and how many scenarios reach the goal."""
    x_end = states.particles.x[:, -1]
    cx_end = x_end[..., 0].double().mean(dim=-1)
    finite = (torch.isfinite(x_end).flatten(1).all(dim=1)
              & torch.isfinite(states.rigid).flatten(1).all(dim=1))
    err = (cx_end - paddle_blob.GOAL_X).abs()
    return err, finite, int(((err < GOAL_TOL) & finite).sum())


def run(scenarios: int = 32, samples: int = 8, steps: int = 50, seed: int = 0,
        device=None) -> dict:
    """A warm-up rollout of one MPC step, then the timed rollout."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    w, s0, opts, dynamics, dropped = make_problem(scenarios, samples, seed, device)
    u_init = torch.zeros((scenarios, HORIZON, 1), device=device)

    def rollout(n):
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        return mppi.mppi_mpc_rollout(
            dynamics, w.running_cost, w.final_cost, s0, u_init, n, options=opts,
            generator=gen)

    rollout(1)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    dropped.zero_()
    t0 = time.perf_counter()
    states, us, costs = rollout(steps)
    if cuda:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    err, finite, reached = quality(states)
    return {
        "metric": "coupled MPM+SAP MPPI solves/s",
        "scenarios": scenarios, "samples": samples, "steps": steps, "horizon": HORIZON,
        "substeps_per_step": w.world.substeps_per_step, "seed": seed,
        "solves_per_s": scenarios * steps / wall, "wall_s": wall,
        "reached": reached, "median_err": float(err.median()),
        "nonfinite": int((~finite).sum()), "dropped_max": int(dropped.max()),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "states": states, "us": us, "costs": costs,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scenarios", type=int, default=32)
    parser.add_argument("--samples", type=int, default=8)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_coupled_mpc runs on the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = run(args.scenarios, args.samples, args.steps, args.seed)
    for key in ("states", "us", "costs"):
        res.pop(key)
    print(json.dumps(res))
    assert res["dropped_max"] == 0, f"{res['dropped_max']} particles dropped"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
