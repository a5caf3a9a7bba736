"""Batched coupled MPM + rigid substeps per second (BASELINE config 5's
inner loop): K rollouts of the paddle-and-blob world
(``benchmarks/bench_coupled_world.py`` of the JAX package), each lane a
sequence of coupled steps of 10 substeps -- MPM transfers against the live
paddle pose, impulse accumulation, the SAP rigid step -- all lanes batched
in one call.

    python -m drake_tpu_torch.benchmarks.bench_coupled_world

    python -m drake_tpu_torch.benchmarks.bench_coupled_world --implicit \
        [--max-iters 20] [--ls-points 12] [--ls-levels 2] [--ext-factor 4] [--unroll 0]

Prints one JSON line: coupled substeps/s, the largest ``dropped`` of any
lane and coupled step (asserted 0 in every lane), finite state, peak memory
and the card.  By default the contact is the explicit penalty: the
substep's P2G runs through K2 and its grid update through K1 over all lanes;
``run(xla_only=True)`` takes their plain versions (the scatter P2G).
``--implicit`` takes the reference's implicit grid contact on the tile
pipeline (``CoupledWorld``'s tiled branch: K2, K1 from block windows with
the node mass, the Newton on the closure, K3), with its solve options; the
Newton iterations of every solve are reported.  ``--ext-factor`` defaults
to 4, ``GridContactParams``' default and the reference's help, where the
reference bench passes 1 (its ``args.ext_factor or 1``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from drake_tpu_torch.benchmarks import paddle_blob
from drake_tpu_torch.mpm import grid_contact as gc
from drake_tpu_torch.utils.device import resolve_device


def controls(lanes: int, horizon: int, device):
    """The reference's open-loop paddle forces 5 sin(k), k = 0 .. K H - 1."""
    k = torch.arange(lanes * horizon, dtype=torch.float32, device=device)
    return 5.0 * torch.sin(k).reshape(lanes, horizon, 1)


def rollout(world, params, states, us):
    """The coupled steps of every lane under us (K, H, 1); returns the final
    states and the largest ``dropped`` of each lane over all substeps."""
    dropped = torch.zeros_like(states.particles.dropped)
    for t in range(us.shape[1]):
        states = world.step(params, states, us[:, t])
        dropped = torch.maximum(dropped, states.particles.dropped)
    return states, dropped


def implicit_world(world, max_iters: int = 20, ls_points: int = 12, ls_levels: int = 2,
                   ext_factor: int = 4, unroll: int = 0, tiled: bool = True):
    """`world` with the reference bench's ``--implicit`` grid contact (k
    5e4, d 100, mu 0.3; benchmarks/bench_coupled_world.py:106-121), on the
    tile pipeline (or, ``tiled=False``, the dense solve)."""
    return dataclasses.replace(
        world, contact_model="implicit", tiled=tiled,
        grid_contact_params=gc.GridContactParams(
            stiffness=5e4, damping=100.0, friction=0.3, max_iterations=max_iters,
            line_search_points=ls_points, line_search_levels=ls_levels,
            ext_capacity_factor=ext_factor, unroll_iterations=unroll,
        ),
    )


def run(lanes: int = 64, horizon: int = 10, device=None, xla_only: bool = False,
        implicit: bool = False, **implicit_options) -> dict:
    """A warm-up rollout, then the timed one (host clock ending in a
    synchronise, CUDA events beside it on the card), in float32.  With
    ``implicit``, the world of ``implicit_world(**implicit_options)``."""
    device = resolve_device(device)
    w = paddle_blob.build(device=device, xla_only=xla_only)
    world = implicit_world(w.world, **implicit_options) if implicit else w.world
    states = paddle_blob.lanes(w.state0, lanes)
    us = controls(lanes, horizon, device)
    cuda = device.type == "cuda"
    rollout(world, w.params, states, us)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    with gc.solve_log() as log:
        out, dropped = rollout(world, w.params, states, us * 1.0001)
    if cuda:
        end.record()
        end.synchronize()
    wall = time.perf_counter() - t0
    its = torch.stack([sol.iterations for sol in log]).cpu() if log else None
    substeps = lanes * horizon * world.substeps_per_step
    finite = all(bool(torch.isfinite(t).all())
                 for t in (out.rigid, out.particles.x, out.particles.v, out.particles.F))
    return {
        "metric": "coupled MPM+SAP substeps/s",
        "lanes": lanes, "horizon": horizon, "substeps_per_step": world.substeps_per_step,
        "particles": int(w.state0.particles.x.shape[0]), "xla_only": xla_only,
        "implicit": dict(implicit_options, tiled=world.tiled) if implicit else None,
        "newton_iterations_median": float(its.double().median()) if its is not None else None,
        "newton_iterations_max": int(its.max()) if its is not None else None,
        "substeps_per_s": substeps / wall, "wall_s": wall,
        "device_s": start.elapsed_time(end) / 1e3 if cuda else None,
        "dropped_max": int(dropped.max()), "dropped_lanes": int((dropped > 0).sum()),
        "finite": finite,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "final_state": out,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--implicit", action="store_true",
                        help="the implicit grid contact on the tile pipeline")
    parser.add_argument("--max-iters", type=int, default=20, help="Newton iteration cap")
    parser.add_argument("--ls-points", type=int, default=12, help="line-search points")
    parser.add_argument("--ls-levels", type=int, default=2, help="line-search levels (1 or 2)")
    parser.add_argument("--ext-factor", type=int, default=4, help="closure capacity factor")
    parser.add_argument("--unroll", type=int, default=0,
                        help="fixed Newton iteration count (0: converged)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_coupled_world runs on the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    options = dict(max_iters=args.max_iters, ls_points=args.ls_points,
                   ls_levels=args.ls_levels, ext_factor=args.ext_factor,
                   unroll=args.unroll) if args.implicit else {}
    res = run(implicit=args.implicit, **options)
    res.pop("final_state")
    print(json.dumps(res))
    assert res["finite"], "non-finite state"
    assert res["dropped_lanes"] == 0, (
        f"{res['dropped_lanes']} lanes dropped particles (at most {res['dropped_max']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
