"""Where an entry point places the tensors it makes.

The port runs on the card unless the caller asks for the CPU: ``device=None``
means the current CUDA device, and where there is none it is an error, never
a silent CPU tensor.
"""

from __future__ import annotations

import subprocess
from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """`device` as a ``torch.device``; ``None`` is the current CUDA device.

    Raises ``RuntimeError`` for ``None`` on a machine without CUDA: pass
    ``device="cpu"`` to compute on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: drake_tpu_torch places tensors on the card by "
            'default; pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda", torch.cuda.current_device())


_CONSTANTS: dict = {}


def constant(values, like: torch.Tensor) -> torch.Tensor:
    """`values` (a float, or nested tuples of floats) as a tensor of `like`'s
    dtype on `like`'s device, made once per (values, dtype, device).

    A tensor copied from the host to the card waits for the card's stream to
    drain first; the hot loops take their constants from here instead.  The
    memo holds immutable values only; callers must not write to the result."""
    key = (values, like.dtype, like.device)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, dtype=like.dtype, device=like.device)
    return t


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
