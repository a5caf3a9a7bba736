"""Where an entry point places the tensors it makes.

The port runs on the card unless the caller asks for the CPU: ``device=None``
means the current CUDA device, and where there is none it is an error, never
a silent CPU tensor.
"""

from __future__ import annotations

import subprocess
from typing import Union

import numpy as np
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


def tensors_on(arrays, device=None):
    """`arrays` (tensors, array-likes or None) as tensors on one device and
    of one floating dtype, for a solver's entry point.

    The device is `device` where given, else that of the first tensor among
    `arrays`, else ``resolve_device(None)``: arrays from the host go to the
    card unless the caller asks for the CPU.  The dtype is that of the first
    tensor, else float64 (the reference's numpy inputs under x64).  None
    entries stay None."""
    first = next((a for a in arrays if isinstance(a, torch.Tensor)), None)
    if device is not None or first is None:
        device = resolve_device(device)
    else:
        device = first.device
    dtype = first.dtype if first is not None else torch.float64
    return tuple(None if a is None
                 else a.to(dtype=dtype, device=device) if isinstance(a, torch.Tensor)
                 else torch.as_tensor(np.array(a), dtype=dtype, device=device)
                 for a in arrays)


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
