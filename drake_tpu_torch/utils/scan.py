"""``lax.scan`` over a fixed number of steps.

The JAX package rolls its closed loops out with ``lax.scan``.  Here a step
is a Python function of a tuple of tensors, run ``num_steps`` times: on the
CPU (or wherever autograd records) as an eager loop, and on the card, with
autograd off, as one CUDA graph of the step that is captured once and
replayed, so that the host pays one launch a step instead of the step's
hundreds of small kernels (as ``solvers/ipm.py`` replays an IPM iteration).
The step must then keep to what a graph can capture: no host sync, no copy
from the host, the same shapes every step.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

Tensors = Tuple[torch.Tensor, ...]


def scan(step: Callable[[Tensors], Tuple[Tensors, Tensors]], carry: Tensors, num_steps: int):
    """Apply ``step(carry) -> (carry, out)`` `num_steps` times from `carry`.

    Returns the last carry and each output stacked over the steps on a new
    leading axis, as ``lax.scan(..., length=num_steps)``."""
    if carry[0].device.type != "cuda" or torch.is_grad_enabled() or num_steps < 2:
        outs = []
        for _ in range(num_steps):
            carry, out = step(carry)
            outs.append(out)
        return carry, tuple(torch.stack(o) for o in zip(*outs))
    return _replayed(step, carry, num_steps)


def _replayed(step, carry, num_steps):
    """The card's loop: the first step runs eagerly on a side stream (it
    warms up workspaces and gives the outputs' shapes), the second is
    captured as a CUDA graph that reads and writes buffers of its own and
    writes its outputs into the stacks at a step index on the device, and
    every later step replays it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        carry, out = step(tuple(carry))
        buffers = tuple(c.clone() for c in carry)
        stacks = tuple(o.new_empty((num_steps,) + o.shape) for o in out)
        for s, o in zip(stacks, out):
            s[0] = o
        index = torch.ones(1, dtype=torch.long, device=carry[0].device)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        new, out = step(buffers)
        for dst, src in zip(buffers, new):
            dst.copy_(src)
        for s, o in zip(stacks, out):
            s.index_copy_(0, index, o.unsqueeze(0))
        index.add_(1)
    for _ in range(num_steps - 1):
        graph.replay()
    return buffers, stacks


def capture(fn: Callable[[], None]) -> "torch.cuda.CUDAGraph":
    """One CUDA graph of `fn()`, a function that reads and writes tensors of
    its own (static buffers) on the card.  `fn` first runs once eagerly on a
    side stream (it warms up workspaces and memoized constants, which a
    capture may not copy from the host), so it must be harmless to run
    twice.  Replay the graph with ``.replay()``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph
