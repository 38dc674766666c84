"""Small tree helpers (port of ``mpc_verde_tpu.utils.tree``)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def tree_where(pred, a, b):
    """Select between two trees elementwise on a scalar or broadcastable
    predicate: ``torch.where(pred, x, y)`` at every tensor leaf.

    The trees are tensors, ``None``, and tuples (named tuples too), lists,
    dicts and dataclass instances of them, with the same structure in ``a``
    and ``b``.
    """
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return torch.where(pred, a, b)
    if isinstance(a, dict):
        return {k: tree_where(pred, v, b[k]) for k, v in a.items()}
    if isinstance(a, (tuple, list)):
        out = [tree_where(pred, x, y) for x, y in zip(a, b, strict=True)]
        return type(a)(*out) if hasattr(a, "_fields") else type(a)(out)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return dataclasses.replace(a, **{
            f.name: tree_where(pred, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a) if f.init})
    raise TypeError(f"tree_where: unsupported leaf {type(a).__name__}")


def to_numpy(a):
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)
