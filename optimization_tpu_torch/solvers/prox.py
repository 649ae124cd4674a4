"""Proximal-operator library.

Counterpart of ``optimization_tpu/solvers/prox.py``.  The reference injects
prox operators as ``std::function``s (``Convex/Concepts.h:46-70``); here the
common ones ship as closed-form maps on tensors.  All operators follow the
convention

    prox_g(x, lam) = argmin_v  g(v) + (1 / (2 lam)) |x - v|^2

``lam`` may be a number or a 0-d tensor on x's device.
"""

from __future__ import annotations

import torch

__all__ = [
    "soft_threshold",
    "group_soft_threshold",
    "prox_l2_squared",
    "project_box",
    "project_nonnegative",
    "prox_zero",
]


def soft_threshold(x, lam):
    """prox of g(x) = |x|_1 (elementwise soft thresholding)."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - lam, min=0.0)


def group_soft_threshold(x, lam, axis=None):
    """prox of g(x) = |x|_2 (block/group soft thresholding).

    With ``axis=None`` the whole vector is one group (the group-LASSO prox of
    the reference's proximal-gradient example,
    ``examples/proximal_gradient_example.cpp:40-55``).

    The guard 1e-300 under the division underflows to 0 in f32 and bf16, as
    it does in the JAX package: a zero group then has lam / 0 = inf, a scale
    of max(1 - inf, 0) = 0, and the result is 0, not NaN.
    """
    if axis is None:
        norm = torch.sqrt(torch.sum(x * x))
    else:
        norm = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    scale = torch.clamp(1.0 - lam / torch.clamp(norm, min=1e-300), min=0.0)
    return scale * x


def prox_l2_squared(x, lam, mu=1.0):
    """prox of g(x) = (mu/2) |x|_2^2."""
    return x / (1.0 + lam * mu)


def project_box(x, lam, lo=0.0, hi=1.0):
    """prox of the indicator of [lo, hi]^n (projection; lam-independent)."""
    return torch.clamp(x, lo, hi)


def project_nonnegative(x, lam):
    """prox of the indicator of the nonnegative orthant."""
    return torch.clamp(x, min=0.0)


def prox_zero(x, lam):
    """prox of g = 0 (identity): recovers plain gradient descent."""
    return x
