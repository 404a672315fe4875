"""Relative and absolute Lp losses (``molecular_dynamics_neural_operator_tpu/models/losses.py``).

Per-example Lp norms of the flattened examples, reduced by mean
(``size_average=True``) or sum over the batch. The training loop asks for
the sum of relative errors.
"""

from __future__ import annotations

import torch


def _flatten(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _reduce(values, size_average: bool, reduction: bool):
    if not reduction:
        return values
    return values.mean() if size_average else values.sum()


def lp_rel(x, y, p: int = 2, size_average: bool = True,
           reduction: bool = True):
    """Sum or mean over the batch of ||x - y||_p / ||y||_p."""
    xf, yf = _flatten(x), _flatten(y)
    ratios = (torch.linalg.vector_norm(xf - yf, ord=p, dim=1)
              / torch.linalg.vector_norm(yf, ord=p, dim=1))
    return _reduce(ratios, size_average, reduction)


def lp_abs(x, y, d: int = 2, p: int = 2, size_average: bool = True,
           reduction: bool = True):
    """Mesh-scaled absolute Lp norm: h^(d/p) * ||x - y||_p per example,
    h = 1 / (x.shape[1] - 1)."""
    xf, yf = _flatten(x), _flatten(y)
    h = 1.0 / (x.shape[1] - 1.0)
    norms = (h ** (d / p)) * torch.linalg.vector_norm(xf - yf, ord=p, dim=1)
    return _reduce(norms, size_average, reduction)


def mse(x, y):
    """Plain mean-squared error."""
    return ((x - y) ** 2).mean()
