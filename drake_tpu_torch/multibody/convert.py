"""Carry a multibody model and its parameters, and trajectories, across
from the JAX package, so that both packages compute with identical data.

The port never imports JAX: the caller hands over the JAX ``MultibodyParams``
as numpy arrays (``{f.name: np.asarray(getattr(p, f.name)) for f in
dataclasses.fields(p)}``), the ``MultibodyModel`` as a dict of its fields
(``dataclasses.asdict(model)``), and a trajectory as the dict of its fields,
numpy arrays, with a nested dict for a trajectory field (PiecewisePose's
position and orientation).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from drake_tpu_torch.math import trajectories

from drake_tpu_torch.multibody.model import MultibodyModel, MultibodyParams
from drake_tpu_torch.utils.device import resolve_device
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


# The trajectory type of each field that holds a trajectory.
_NESTED = {"position": "PiecewisePolynomial", "orientation": "PiecewiseQuaternionSlerp"}


def trajectory_from_numpy(kind: str, fields: Mapping, device=None, dtype: torch.dtype = None):
    """The port's trajectory `kind` ("PiecewisePolynomial",
    "BsplineTrajectory", "BezierCurve", "PiecewiseQuaternionSlerp" or
    "PiecewisePose") from the fields of the JAX one as numpy arrays (copied),
    as `dtype` (default: keep the arrays') on `device` (None: the current
    CUDA device, an error without one)."""
    device = resolve_device(device)
    cls = getattr(trajectories, kind)
    kwargs = {}
    for f in dataclasses.fields(cls):
        value = fields[f.name]
        if isinstance(value, Mapping):
            kwargs[f.name] = trajectory_from_numpy(_NESTED[f.name], value, device, dtype)
        elif f.metadata.get("static", False):
            kwargs[f.name] = int(value)
        else:
            kwargs[f.name] = torch.tensor(np.asarray(value), dtype=dtype, device=device)
    return cls(**kwargs)


def trajectory_to_numpy(traj) -> dict:
    """The inverse of ``trajectory_from_numpy``: its fields as numpy arrays."""
    out = {}
    for f in dataclasses.fields(traj):
        value = getattr(traj, f.name)
        if dataclasses.is_dataclass(value):
            out[f.name] = trajectory_to_numpy(value)
        elif isinstance(value, torch.Tensor):
            out[f.name] = value.detach().cpu().numpy()
        else:
            out[f.name] = value
    return out


def force_elements_from_numpy(element_set: Mapping, arrays: Mapping[str, np.ndarray],
                              device=None, dtype: torch.dtype = None):
    """(ForceElementSet, ForceElementParams) from ``dataclasses.asdict`` of a
    JAX ``ForceElementSet`` and the JAX ``ForceElementParams``' fields as
    numpy arrays (copied), as `dtype` on `device` (None: the current CUDA
    device)."""
    from drake_tpu_torch.multibody.force_elements import ForceElementParams, ForceElementSet

    fe = ForceElementSet(**{k: tuple(tuple(x) if isinstance(x, (list, tuple)) else int(x)
                                     for x in v) for k, v in element_set.items()})
    return fe, from_numpy(ForceElementParams, arrays, device, dtype)


def constraints_from_numpy(ball_constraints=(), weld_constraints=()):
    """The ball (body_a, p_AP, body_b, p_BQ) and weld (body_a, R_AP, p_AP,
    body_b, R_BQ, p_BQ) constraint tuples of the JAX topology (or any with
    numpy entries) as plain Python numbers, ready for ``sap.assemble``."""

    def plain(x):
        if isinstance(x, (int, np.integer)):
            return int(x)
        return np.asarray(x, np.float64).tolist()

    return ([tuple(plain(x) for x in c) for c in ball_constraints],
            [tuple(plain(x) for x in c) for c in weld_constraints])


def collision_geometry_from_fields(fields: Mapping):
    """A port ``CollisionGeometry`` from the fields of a JAX one, its shape
    given as ``(shape class name, {shape field: value})`` (the hydroelastic
    fields are carried like the others)."""
    from drake_tpu_torch.geometry import shapes
    from drake_tpu_torch.geometry.scene import CollisionGeometry

    kind, shape_fields = fields["shape"]
    shape = getattr(shapes, kind)(**{k: (tuple(v) if isinstance(v, (list, tuple, np.ndarray))
                                         else v) for k, v in shape_fields.items()})
    rest = {k: (np.asarray(v, np.float64) if k in ("R_BG", "p_BG") else v)
            for k, v in fields.items() if k != "shape"}
    return CollisionGeometry(shape=shape, **rest)
