"""Carry solver state between numpy, the JAX package's pytrees and torch.

:func:`from_numpy` builds a port dataclass through its ``create()`` with
the JAX package's defaults; :func:`from_jax` copies every field of an
object with the same field names (a ``koordinator_tpu`` pytree) through
``np.asarray``, so it needs no import of the JAX package; :func:`to_numpy`
goes the other way. Tests feed both sides from the same arrays this way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device


def from_numpy(cls, device=None, **arrays):
    """``cls.create(**arrays, device=device)`` with numpy inputs
    (``NodeState``, ``PodBatch`` or ``SolverParams``)."""
    tensors = {
        k: None if v is None else torch.from_numpy(np.ascontiguousarray(v))
        for k, v in arrays.items()
    }
    return cls.create(**tensors, device=device)


def from_jax(cls, tree, device=None):
    """A ``cls`` holding copies of ``tree``'s same-named fields (fields the
    tree lacks or holds as None stay None)."""
    dev = resolve_device(device)
    values = {}
    for f in dataclasses.fields(cls):
        leaf = getattr(tree, f.name, None)
        values[f.name] = (
            None if leaf is None else torch.from_numpy(np.array(leaf)).to(dev)
        )
    return cls(**values)


def to_numpy(obj) -> dict:
    """Field name → numpy array (None stays None) of a port dataclass."""
    return {
        f.name: (
            None
            if getattr(obj, f.name) is None
            else getattr(obj, f.name).detach().cpu().numpy()
        )
        for f in dataclasses.fields(obj)
    }
