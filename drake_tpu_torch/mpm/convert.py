"""Conversion between the JAX package's MPM and cloth states and configs (as
numpy arrays and plain dicts) and the port's, so that both packages compute
on the same state.

The port never imports JAX: the caller turns a ``drake_tpu`` ``MpmState`` or
``ClothState`` into numpy (``{f.name: np.asarray(getattr(s, f.name)) for f in
fields(s)}``) and a config into a dict (``dataclasses.asdict(config)``).  A
``ClothConfig`` holds only scalars, so ``ClothConfig(**dict)`` takes such a
dict as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from drake_tpu_torch.mpm.cloth import ClothState
from drake_tpu_torch.mpm.solver import MpmConfig, MpmState
from drake_tpu_torch.utils.device import resolve_device

_FLOAT_FIELDS = ("x", "v", "F", "C", "volume", "mass")
_CLOTH_FLOAT_FIELDS = ("x", "v", "C", "mass", "Dm_inv", "area")


def state_from_numpy(
    arrays: Mapping[str, np.ndarray], device=None, dtype: torch.dtype = None
) -> MpmState:
    """MpmState from numpy arrays of the JAX ``MpmState`` fields (copied).
    Float fields take `dtype` (default: keep the array's); ``dropped`` is
    int32 and defaults to 0 when absent.  The state lies on `device`;
    ``None`` is the current CUDA device (an error without one)."""
    device = resolve_device(device)
    floats = {
        name: torch.tensor(np.asarray(arrays[name]), dtype=dtype, device=device)
        for name in _FLOAT_FIELDS
    }
    dropped = torch.tensor(
        np.asarray(arrays.get("dropped", 0)), dtype=torch.int32, device=device
    )
    return MpmState(**floats, dropped=dropped)


def cloth_state_from_numpy(
    arrays: Mapping[str, np.ndarray], device=None, dtype: torch.dtype = None
) -> ClothState:
    """ClothState from numpy arrays of the JAX ``ClothState`` fields
    (copied).  Float fields take `dtype` (default: keep the array's);
    ``faces`` becomes int64 and ``dropped``, which the JAX state lacks, is
    0 in every lane.  ``device=None`` is the current CUDA device."""
    device = resolve_device(device)
    floats = {
        name: torch.tensor(np.asarray(arrays[name]), dtype=dtype, device=device)
        for name in _CLOTH_FLOAT_FIELDS
    }
    faces = torch.tensor(np.asarray(arrays["faces"]), dtype=torch.int64, device=device)
    return ClothState(**floats, faces=faces)


def state_to_numpy(state: MpmState) -> dict:
    """The inverse of ``state_from_numpy``: every field as a numpy array."""
    return {
        f.name: getattr(state, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(state)
    }


def config_from_reference(fields: Mapping) -> MpmConfig:
    """MpmConfig from ``dataclasses.asdict`` of a JAX ``MpmConfig``."""
    kw = dict(fields)
    for name in ("grid_size", "gravity"):
        if name in kw:
            kw[name] = tuple(kw[name])
    return MpmConfig(**kw)
