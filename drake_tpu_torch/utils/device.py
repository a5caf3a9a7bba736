"""Where an entry point places the tensors it makes.

The port runs on the card unless the caller asks for the CPU: ``device=None``
means the current CUDA device, and where there is none it is an error, never
a silent CPU tensor.
"""

from __future__ import annotations

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
