"""The CPU figures behind chip_smoke.py's phase 16 bounds: the spread of
float32 against float64 of the implicit world on the tile pipeline, the
port alone, on the CPU.

    python tests/tiled_world_spread.py [--lanes 64] [--skip-rollout] [--dense]

1. Phase 16a's quantities (``implicit_parity_values(..., tiled=True)``: 4
   lanes, one coupled step) in float32 against float64, as a share of the
   float64 answer's scale: TILED_PARITY_CPU, of which TILED_PARITY is 100x.
2. Phase 16b's rollout (``--lanes`` lanes, 10 coupled steps from the
   paddle's start of phase 13, the bench's controls + 10 N) in float32 and
   float64 on the tile pipeline, and in float32 on the dense solve: max
   |difference| in the particles' x and v, the paddle's position q and its
   velocity, the figures behind TILED_MAX_DIFF's velocity bounds.  Minutes
   at 64 lanes.
3. With ``--dense``, phase 13c's floor instead: the same rollout on the
   dense solve in float32 against float64, the figures behind
   IMPLICIT_MAX_DIFF's velocity bounds (1. and 2. are skipped).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from drake_tpu_torch.benchmarks import bench_coupled_world as bw  # noqa: E402
from drake_tpu_torch.benchmarks import paddle_blob  # noqa: E402
from drake_tpu_torch.mpm import grid_contact as gc  # noqa: E402


def rollout(lanes, dtype, tiled):
    """Phase 16b's timed rollout (``chip_smoke.implicit_rollout``'s inputs)
    on the CPU: the final state."""
    cpu = torch.device("cpu")
    w, world = cs.implicit_world(paddle_blob, gc, cpu, dtype=dtype, tiled=tiled)
    states = paddle_blob.lanes(w.state0, lanes)
    rigid = states.rigid.clone()
    rigid[:, 0] = cs.IMPLICIT_PADDLE_X0
    states = states._replace(rigid=rigid)
    us = (bw.controls(lanes, cs.COUPLED_HORIZON, cpu) + cs.IMPLICIT_PUSH).to(dtype)
    out, dropped = bw.rollout(world, w.params, states, us * 1.0001)
    assert int(dropped.max()) == 0
    return out


def differences(a, b):
    d = {"x": a.particles.x.double() - b.particles.x.double(),
         "q": a.rigid[:, 0].double() - b.rigid[:, 0].double(),
         "v": a.particles.v.double() - b.particles.v.double(),
         "paddle v": a.rigid[:, 1].double() - b.rigid[:, 1].double()}
    return {name: f"{float(t.abs().max()):.3e}" for name, t in d.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--lanes", type=int, default=cs.IMPLICIT_LANES[0])
    parser.add_argument("--skip-rollout", action="store_true")
    parser.add_argument("--dense", action="store_true")
    args = parser.parse_args()
    cpu = torch.device("cpu")
    if args.dense:
        runs = {}
        for name, dtype in (("dense float64", torch.float64), ("dense float32", torch.float32)):
            t0 = time.perf_counter()
            runs[name] = rollout(args.lanes, dtype, False)
            print(f"{name}: {args.lanes} lanes in {time.perf_counter() - t0:.1f} s", flush=True)
        print("13c, dense float32 against dense float64:",
              differences(runs["dense float32"], runs["dense float64"]))
        return 0
    ref, _ = cs.implicit_parity_values(torch, paddle_blob, gc, cpu, torch.float64, tiled=True)
    got, _ = cs.implicit_parity_values(torch, paddle_blob, gc, cpu, torch.float32, tiled=True)
    print("16a, float32 against float64 / scale:",
          {name: f"{rel:.2e}" for name, (rel, _) in cs.coupled_parity_errors(ref, got).items()})
    if args.skip_rollout:
        return 0
    runs = {}
    for name, dtype, tiled in (("tiled float64", torch.float64, True),
                               ("tiled float32", torch.float32, True),
                               ("dense float32", torch.float32, False)):
        t0 = time.perf_counter()
        runs[name] = rollout(args.lanes, dtype, tiled)
        print(f"{name}: {args.lanes} lanes in {time.perf_counter() - t0:.1f} s", flush=True)
    print("16d, tiled float32 against tiled float64:",
          differences(runs["tiled float32"], runs["tiled float64"]))
    print("16d, tiled float32 against dense float32:",
          differences(runs["tiled float32"], runs["dense float32"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
