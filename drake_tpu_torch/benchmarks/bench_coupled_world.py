"""Batched coupled MPM + rigid substeps per second (BASELINE config 5's
inner loop): K rollouts of the paddle-and-blob world
(``benchmarks/bench_coupled_world.py`` of the JAX package), each lane a
sequence of coupled steps of 10 substeps -- MPM transfers against the live
paddle pose, impulse accumulation, the SAP rigid step -- all lanes batched
in one call.

    python -m drake_tpu_torch.benchmarks.bench_coupled_world

Prints one JSON line: coupled substeps/s, the largest ``dropped`` of any
lane and substep (asserted 0), finite state, peak memory and the card.  By
default the substep's P2G runs through K2 and its grid update through K1
over all lanes; ``run(xla_only=True)`` takes their plain versions (the
scatter P2G).  Not ported: the reference's ``--implicit`` grid-contact
options.
"""

from __future__ import annotations

import json
import time

import torch

from drake_tpu_torch.benchmarks import paddle_blob
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


def run(lanes: int = 64, horizon: int = 10, device=None, xla_only: bool = False) -> dict:
    """A warm-up rollout, then the timed one (host clock ending in a
    synchronise, CUDA events beside it on the card), in float32."""
    device = resolve_device(device)
    w = paddle_blob.build(device=device, xla_only=xla_only)
    states = paddle_blob.lanes(w.state0, lanes)
    us = controls(lanes, horizon, device)
    cuda = device.type == "cuda"
    rollout(w.world, w.params, states, us)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    out, dropped = rollout(w.world, w.params, states, us * 1.0001)
    if cuda:
        end.record()
        end.synchronize()
    wall = time.perf_counter() - t0
    substeps = lanes * horizon * w.world.substeps_per_step
    finite = all(bool(torch.isfinite(t).all())
                 for t in (out.rigid, out.particles.x, out.particles.v, out.particles.F))
    return {
        "metric": "coupled MPM+SAP substeps/s",
        "lanes": lanes, "horizon": horizon, "substeps_per_step": w.world.substeps_per_step,
        "particles": int(w.state0.particles.x.shape[0]), "xla_only": xla_only,
        "substeps_per_s": substeps / wall, "wall_s": wall,
        "device_s": start.elapsed_time(end) / 1e3 if cuda else None,
        "dropped_max": int(dropped.max()), "finite": finite,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "final_state": out,
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_coupled_world runs on the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = run()
    res.pop("final_state")
    print(json.dumps(res))
    assert res["finite"], "non-finite state"
    assert res["dropped_max"] == 0, f"{res['dropped_max']} particles dropped"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
