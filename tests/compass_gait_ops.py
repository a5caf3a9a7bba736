"""The figures behind the compass gait's closed forms
(drake_tpu_torch/examples/compass_gait.py): the operations that one
evaluation of the dynamics traces to (``make_fx``) and its CPU time, by the
Lagrangian's autodiff (``torch.func``, the reference's construction) and by
the closed forms the rollout uses, and the largest difference of the two on
seeded states.

    python tests/compass_gait_ops.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from drake_tpu_torch.examples.compass_gait import X0, Walker  # noqa: E402


def main():
    torch.set_num_threads(1)
    w = Walker(torch.float64, "cpu")
    x = torch.tensor([X0], dtype=torch.float64)
    states = torch.randn((6, 4), generator=torch.Generator().manual_seed(0),
                         dtype=torch.float64) * 0.5
    for name, f in (("autodiff", w.autodiff_dynamics), ("closed form", w.dynamics)):
        graph = make_fx(lambda y: f(None, y, None, 0.0))(x)
        ops = sum(1 for n in graph.graph.nodes if n.op == "call_function")
        f(None, x, None, 0.0)
        t0 = time.perf_counter()
        for _ in range(20):
            f(None, x, None, 0.0)
        ms = (time.perf_counter() - t0) / 20 * 1e3
        print(f"{name}: {ops} operations traced, {ms:.3f} ms an evaluation on one CPU thread")
    d = (w.dynamics(None, states, None, 0.0) - w.autodiff_dynamics(None, states, None, 0.0))
    print(f"max |closed form - autodiff| on 6 seeded states: {float(d.abs().max()):.2e}")


if __name__ == "__main__":
    main()
