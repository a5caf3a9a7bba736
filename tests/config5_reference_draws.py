"""Config 5 (MPPI through the coupled MPM + rigid world) on the reference
bench's own draws: the blob offsets of ``PRNGKey(0)`` and the MPPI
perturbations of ``split(PRNGKey(1), 32)``, taken as
benchmarks/bench_coupled_mpc.py takes them (its timed run, offsets + 1e-6),
in float32.  It says whether the port's goal count on its own
``torch.Generator`` draws differs from the JAX package's because of the
draws or because of the port.

On the CPU, the JAX package (its plain path: it takes no Pallas kernel on
the CPU) and the port (``bench_coupled_mpc``'s problem, the draws fed to
``mppi_mpc_rollout``) run the first 8 of the 32 scenarios (all 32 would be
a full-size run on a CPU), 8 samples, horizon 10, 50 MPC steps; prints
each scenario's final error for both, then one JSON line.  ``--save`` also
writes all 32 scenarios' draws to an ``.npz``:

    JAX_PLATFORMS=cpu python tests/config5_reference_draws.py \\
        [--save _chip/config5_draws.npz]

On the card, the port alone (no JAX imported) on all 32 scenarios of a
saved ``.npz``, with the kernels; prints one JSON line:

    python tests/config5_reference_draws.py --card _chip/config5_draws.npz
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

SCENARIOS = 32  # the reference bench's count, which fixes its key split
CPU_SCENARIOS = 8
SAMPLES, HORIZON, STEPS = 8, 10, 50


def reference_draws():
    """The reference bench's float32 draws of all 32 scenarios: offsets
    (32,) and standard normals (STEPS, 1, 32, SAMPLES, HORIZON, 1)."""
    import jax
    import jax.numpy as jnp

    from test_torch_mppi import rollout_noise

    offsets = 0.04 * (jax.random.uniform(jax.random.PRNGKey(0), (SCENARIOS,), jnp.float32) - 0.5)
    keys = jax.random.split(jax.random.PRNGKey(1), SCENARIOS)
    noise = rollout_noise(keys, STEPS, 1, (SAMPLES, HORIZON, 1), jnp.float32)
    return np.asarray(offsets + 1e-6), keys, noise


def run_reference(offsets, keys):
    """The JAX package's rollout of the scenarios of `offsets` and `keys`,
    as the reference bench's ``scenario``; returns each one's final
    error."""
    import jax
    import jax.numpy as jnp

    from drake_tpu.contact import coupled_plant as jcp
    from drake_tpu.control import mppi as jmppi
    from test_torch_coupled import jax_paddle_world
    from test_torch_mppi import jax_bench_costs

    f32 = jnp.float32
    world, params, particles = jax_paddle_world((32, 32, 32), 10, f32)
    running, final = jax_bench_costs()
    opts = jmppi.MppiOptions(num_samples=SAMPLES, temperature=0.05, noise_sigma=8.0,
                             u_lower=jnp.array([-25.0]), u_upper=jnp.array([25.0]))

    def scenario(dx0, key):
        p = particles.replace(x=particles.x.at[:, 0].add(dx0))
        s0 = jcp.CoupledState(rigid=jnp.asarray([0.31, 0.0], f32).at[0].add(dx0), particles=p)
        states, _, _ = jmppi.mppi_mpc_rollout(
            lambda s, u: world.step(params, s, u), running, final, s0,
            jnp.zeros((HORIZON, 1), f32), key, num_steps=STEPS, options=opts)
        x_end = states.particles.x[-1]
        return jnp.mean(x_end[:, 0]), jnp.all(jnp.isfinite(x_end))

    cx, finite = jax.jit(jax.vmap(scenario))(jnp.asarray(offsets), keys)
    err = np.abs(np.asarray(cx, np.float64) - 0.55)
    return np.where(np.asarray(finite), err, np.inf)


def run_port(offsets, noise, device):
    """The port's rollout of the scenarios of `offsets` (S,) on the draws
    `noise` (steps, 1, S, ...), in float32; returns each one's final error
    and the largest ``dropped`` of any lane."""
    import torch

    from drake_tpu_torch.benchmarks import bench_coupled_mpc, paddle_blob
    from drake_tpu_torch.control import mppi

    scenarios, steps = len(offsets), noise.shape[0]
    w, _, opts, dynamics, dropped = bench_coupled_mpc.make_problem(
        scenarios, SAMPLES, 0, device)
    s0 = paddle_blob.shifted(paddle_blob.lanes(w.state0, scenarios),
                             torch.tensor(offsets, device=device))
    states, _, _ = mppi.mppi_mpc_rollout(
        dynamics, w.running_cost, w.final_cost, s0,
        torch.zeros((scenarios, HORIZON, 1), device=device), steps, options=opts,
        noise=torch.tensor(noise, device=device))
    err, finite, _ = bench_coupled_mpc.quality(states)
    return torch.where(finite, err, torch.inf).cpu().numpy(), int(dropped.max())


def summary(err) -> dict:
    return {"reached": int(np.sum(err < 0.06)), "median_err": float(np.median(err)),
            "nonfinite": int(np.sum(~np.isfinite(err)))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--save", help="also write the 32 scenarios' draws here (.npz)")
    parser.add_argument("--card", metavar="NPZ", help="the port alone on the card, on these draws")
    args = parser.parse_args(argv)

    if args.card:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("--card needs a CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        draws = np.load(args.card)
        t0 = time.perf_counter()
        err, dropped = run_port(draws["offsets"], draws["noise"], torch.device("cuda"))
        print(json.dumps({"package": "drake_tpu_torch", "device": torch.cuda.get_device_name(0),
                          "scenarios": len(err), "steps": int(draws["noise"].shape[0]),
                          **summary(err), "dropped_max": dropped,
                          "wall_s": time.perf_counter() - t0, "err": err.tolist()}))
        return 0

    import torch

    offsets, keys, noise = reference_draws()
    if args.save:
        np.savez(args.save, offsets=offsets, noise=noise)
    S = CPU_SCENARIOS
    t0 = time.perf_counter()
    ref = run_reference(offsets[:S], keys[:S])
    t1 = time.perf_counter()
    got, dropped = run_port(offsets[:S], noise[:, :, :S], torch.device("cpu"))
    t2 = time.perf_counter()
    for b in range(S):
        print(f"scenario {b:2d}: offset {offsets[b]:+.5f} m; final error "
              f"JAX {ref[b]:.5f} m, port {got[b]:.5f} m")
    print(json.dumps({"device": "cpu", "scenarios": S, "steps": STEPS,
                      "jax": {**summary(ref), "wall_s": t1 - t0},
                      "port": {**summary(got), "dropped_max": dropped, "wall_s": t2 - t1},
                      "max_abs_err_diff": float(np.max(np.abs(ref - got)))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
