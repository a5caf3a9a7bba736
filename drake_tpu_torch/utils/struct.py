"""Frozen tensor dataclasses: the PyTorch counterpart of drake_tpu.utils.struct.

The JAX package registers frozen dataclasses as pytrees so that state flows
through jitted functions.  PyTorch runs eagerly, so the port needs no pytree
registration: a frozen dataclass whose fields are tensors, with ``.replace()``
for functional updates and ``.to(device)`` to move every tensor field at once.
Fields marked ``static_field()`` are plain Python metadata and are never moved.
"""

from __future__ import annotations

import dataclasses
from typing import TypeVar

import numpy as np
import torch

_T = TypeVar("_T")


def tensor_dataclass(cls: type[_T]) -> type[_T]:
    """Decorator: frozen dataclass with ``replace`` and ``to`` methods."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def _replace(self, **updates):
        return dataclasses.replace(self, **updates)

    def _to(self, device=None, dtype=None):
        """Move every tensor field to `device`; floating fields also take
        `dtype` (integer fields such as counters keep theirs)."""
        updates = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if f.metadata.get("static", False) or not isinstance(value, torch.Tensor):
                continue
            cast = dtype if value.is_floating_point() else None
            updates[f.name] = value.to(device=device, dtype=cast)
        return dataclasses.replace(self, **updates)

    cls.replace = _replace
    cls.to = _to
    return cls


def static_field(**kwargs):
    """A dataclass field that ``to()`` leaves alone (Python metadata)."""
    metadata = dict(kwargs.pop("metadata", {}))
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def tree_map(fn, *trees):
    """`fn` over the tensor leaves of equally shaped state trees (tuples and
    NamedTuples, tensor dataclasses, tensors), as ``jax.tree_util.tree_map``
    over the JAX package's pytrees.  Other leaves are taken from the first
    tree; a ``static_field()`` is never mapped."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(first):
        updates = {}
        for f in dataclasses.fields(first):
            if f.metadata.get("static", False):
                continue
            updates[f.name] = tree_map(fn, *(getattr(t, f.name) for t in trees))
        return dataclasses.replace(first, **updates)
    if isinstance(first, tuple):
        items = [tree_map(fn, *parts) for parts in zip(*trees)]
        return type(first)(*items) if hasattr(first, "_fields") else tuple(items)
    return first


def from_numpy(cls, arrays, device=None, dtype: torch.dtype = None):
    """A tensor dataclass `cls` from numpy arrays of its fields (copied), as
    `dtype` (default: keep the arrays') on `device` (None: the current CUDA
    device, an error without one).  A missing or None field stays None."""
    from drake_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    return cls(**{
        f.name: None if arrays.get(f.name) is None
        else torch.tensor(np.asarray(arrays[f.name]), dtype=dtype, device=device)
        for f in dataclasses.fields(cls)
    })


def to_numpy(obj) -> dict:
    """The inverse of ``from_numpy``: {field: numpy array or None}."""
    return {
        f.name: None if getattr(obj, f.name) is None else getattr(obj, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(obj)
    }
