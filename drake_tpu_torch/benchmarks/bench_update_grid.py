"""Device time of the dense K1 grid update (``update_grid_cuda``) on the
grid of chip_smoke.py's 132,651-particle MPM scene (64 x 64 x 128 nodes),
to compare the kernel of two checkouts on one card:

    python drake_tpu_torch/benchmarks/bench_update_grid.py [--root DIR]

``--root DIR`` imports ``drake_tpu_torch`` from another checkout (for
example a parent commit unpacked by ``git archive``), whose kernels are then
built there; the timing code is always this checkout's ``chip_smoke.py``.
Run the two in turns within one call (A, B, B, A): times from two calls may
come from two cards.  Prints one JSON line: the checkout, warm ms (two means
of back-to-back calls), cold ms (each call after the L2 cache was
overwritten), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=REPO, help="checkout to import drake_tpu_torch from")
    root = os.path.abspath(parser.parse_args().root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from drake_tpu_torch.mpm import solver as mpm
    from drake_tpu_torch.ops import mpm_kernels as mk

    if not torch.cuda.is_available():
        print("bench_update_grid: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    config, state = cs.scene(mpm, 2, dev)
    grid = mpm.particle_to_grid_scatter(config, state)
    args = (grid.mass.contiguous(), grid.momentum.movedim(-1, 0).contiguous(), config.dt,
            config.gravity, config.wall_width)
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    kernel = lambda: mk.update_grid_cuda(*args)  # noqa: E731
    warm = [cs.time_ms(torch, kernel, cs.KERNEL_REPS) for _ in range(2)]
    cold = cs.time_cold_ms(torch, kernel, cs.KERNEL_REPS, flush)
    print(json.dumps({"root": root, "grid": list(config.grid_size), "warm_ms": warm,
                      "cold_ms": cold, "card": cs.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
