"""Carry a multibody model and its parameters across from the JAX package, so
that both packages compute with identical parameters.

The port never imports JAX: the caller hands over the JAX ``MultibodyParams``
as numpy arrays (``{f.name: np.asarray(getattr(p, f.name)) for f in
dataclasses.fields(p)}``) and the ``MultibodyModel`` as a dict of its fields
(``dataclasses.asdict(model)``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from drake_tpu_torch.multibody.model import MultibodyModel, MultibodyParams
from drake_tpu_torch.utils.struct import from_numpy, to_numpy


def params_from_numpy(arrays: Mapping[str, np.ndarray], device=None,
                      dtype: torch.dtype = None) -> MultibodyParams:
    """MultibodyParams from numpy arrays of the JAX fields (copied), as
    `dtype` (default: keep the arrays') on `device` (None: the current CUDA
    device, an error without one).  A missing or None ``reflected_inertia``
    stays None, as in the reference."""
    return from_numpy(MultibodyParams, arrays, device, dtype)


def params_to_numpy(params: MultibodyParams) -> dict:
    """The inverse of ``params_from_numpy``."""
    return to_numpy(params)


def model_from_fields(fields: Mapping) -> MultibodyModel:
    """MultibodyModel from ``dataclasses.asdict`` of a JAX ``MultibodyModel``
    (joint types the port does not carry raise)."""
    return MultibodyModel(**{k: tuple(v) for k, v in fields.items()})
