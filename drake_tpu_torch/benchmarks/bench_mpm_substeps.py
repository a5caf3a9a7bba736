"""MPM elastic-block substeps per second (``benchmarks/bench_mpm_substeps.py``
of the JAX package, BASELINE row 3): a block of particles falling in a
64 x 64 x 128 grid (dx 1/64, dt 1e-4), the capacities sized for it by
``capacities_for``, as the reference sizes them.

    python -m drake_tpu_torch.benchmarks.bench_mpm_substeps [--scale 2]
        [--fused | --stencil] [--resort 8] [--substeps 200]

Paths: by default the tile pipeline, ``tiles.simulate_tiled`` with the
group's sort every ``--resort`` substeps (on the card every substep is K2,
K1 from block windows and K3); ``--fused`` times ``mpm_substep_blocked``,
``--stencil`` ``mpm_substep`` (K2, K1 from block windows, the stencil G2P).
``--scale`` grows the block about its centre: 1 gives 17,576 particles, 2
gives 132,651.

A warm-up rollout, then the timed one on the warm-up's output (CUDA events,
the host clock beside them).  Prints one JSON line: substeps/s, ``dropped``
(asserted 0), finite state (asserted), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from drake_tpu_torch.mpm import solver as mpm
from drake_tpu_torch.mpm import tiles
from drake_tpu_torch.utils.device import card, resolve_device

PATHS = ("tiled", "fused", "stencil")


def scene(scale: float = 1.0, device=None, xla_only: bool = False):
    """(config, state): the reference bench's block, its half-width 0.1
    scale about (0.5, 0.5, 0.6), and the capacities sized for it."""
    config = mpm.MpmConfig(grid_size=(64, 64, 128), dx=1.0 / 64, dt=1e-4, xla_only=xla_only)
    half = 0.1 * scale
    lo = (0.5 - half, 0.5 - half, 0.6 - half)
    hi = (0.5 + half, 0.5 + half, 0.6 + half)
    state = mpm.make_particle_block(config, lo, hi, device=resolve_device(device))
    return config.capacities_for(state.x.shape[0]), state


def rollout(config, state, path: str, substeps: int, resort: int = 8):
    """`substeps` substeps of one of PATHS: (final state, largest
    ``dropped`` of a substep -- for the tiled path, its sum over groups)."""
    if path == "tiled":
        out = tiles.simulate_tiled(config, state, substeps, resort_every=resort)
        return out, out.dropped
    substep = mpm.mpm_substep_blocked if path == "fused" else mpm.mpm_substep
    dropped = torch.zeros_like(state.dropped)
    for _ in range(substeps):
        state = substep(config, state)
        dropped = torch.maximum(dropped, state.dropped)
    return state, dropped


def run(scale: float = 1.0, path: str = "tiled", resort: int = 8, substeps: int = 200,
        device=None, xla_only: bool = False) -> dict:
    """The warm-up rollout, then the timed one from its output."""
    if path not in PATHS:
        raise ValueError(f"path {path!r}, expected one of {PATHS}")
    config, state = scene(scale, device, xla_only)
    dev = state.x.device
    cuda = dev.type == "cuda"
    warm, _ = rollout(config, state, path, substeps, resort)
    if cuda:
        torch.cuda.synchronize(dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    out, dropped = rollout(config, warm, path, substeps, resort)
    if cuda:
        end.record()
        end.synchronize()
    wall = time.perf_counter() - t0
    device_s = start.elapsed_time(end) / 1e3 if cuda else None
    return {
        "metric": "MPM elastic block substeps/s", "path": path, "resort_every": resort,
        "particles": int(state.x.shape[0]), "grid": list(config.grid_size),
        "max_active_blocks": config.max_active_blocks, "block_capacity": config.block_capacity,
        "substeps": substeps, "xla_only": xla_only,
        "substeps_per_s": substeps / (device_s if cuda else wall), "wall_s": wall,
        "device_s": device_s, "dropped": int(dropped.max()),
        "finite": all(bool(torch.isfinite(t).all()) for t in (out.x, out.v, out.F, out.C)),
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "card": card() if cuda else None, "final_state": out,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--fused", action="store_true", help="mpm_substep_blocked")
    parser.add_argument("--stencil", action="store_true", help="mpm_substep")
    parser.add_argument("--resort", type=int, default=8, help="the group's sort every N")
    parser.add_argument("--substeps", type=int, default=200)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_mpm_substeps runs on the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    path = "fused" if args.fused else "stencil" if args.stencil else "tiled"
    res = run(args.scale, path, args.resort, args.substeps)
    res.pop("final_state")
    print(json.dumps(res))
    assert res["finite"], "non-finite state"
    assert res["dropped"] == 0, f"{res['dropped']} particles dropped"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
