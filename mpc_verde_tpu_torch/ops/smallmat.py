"""Closed-form solves for tiny matrices (port of ``mpc_verde_tpu.ops.smallmat``).

Batched over any leading dimensions.  n <= 3 use adjugate formulas; n = 4
goes to ``torch.linalg``, as the JAX package does.
"""
from __future__ import annotations

import torch


def small_inv(A):
    """Closed-form inverse for n in {1, 2, 3}; ``torch.linalg.inv`` above."""
    n = A.shape[-1]
    if n == 1:
        return 1.0 / A
    if n == 2:
        a, b = A[..., 0, 0], A[..., 0, 1]
        c, d = A[..., 1, 0], A[..., 1, 1]
        det = a * d - b * c
        inv = torch.stack([
            torch.stack([d, -b], dim=-1),
            torch.stack([-c, a], dim=-1),
        ], dim=-2)
        return inv / det[..., None, None]
    if n == 3:
        m = A
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
        adj = torch.stack([
            torch.stack([c00, c10, c20], dim=-1),
            torch.stack([c01, c11, c21], dim=-1),
            torch.stack([c02, c12, c22], dim=-1),
        ], dim=-2)
        return adj / det[..., None, None]
    return torch.linalg.inv(A)


def small_solve(A, b):
    """Solve ``A x = b``; ``b`` is a vector (..., n) or a matrix (..., n, m)."""
    n = A.shape[-1]
    if n <= 3:
        Ainv = small_inv(A)
        if b.ndim == A.ndim - 1:
            return torch.einsum("...ij,...j->...i", Ainv, b)
        return Ainv @ b
    if b.ndim == A.ndim - 1:
        return torch.linalg.solve(A, b[..., None])[..., 0]
    return torch.linalg.solve(A, b)
