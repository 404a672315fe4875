"""Trivial forecasters that a learned rollout must beat
(``molecular_dynamics_neural_operator_tpu/rollout/baseline.py``).

On slowly varying trajectories freezing the last observed frame already
scores a high contact accuracy; constant-velocity extrapolation wins short
horizons wherever motion is locally linear; a damped prior alone lies
between the two. Each baseline returns the per-step coordinate MSE and
contact-map accuracy of its forecast against a true continuation, in
numpy, with the contact maps from ``geometry.contact_map`` on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from molecular_dynamics_neural_operator_tpu_torch.geometry.contact import (
    contact_map,
)


def _score(pred: np.ndarray, truth: np.ndarray, threshold: float):
    """(coord_mse, contact_accuracy), each (T,), of pred against truth, both
    (T, R, 3); contact maps in f32, self-loops included."""
    def cmap(x):
        return contact_map(torch.as_tensor(x, dtype=torch.float32),
                           threshold).numpy()

    mse = np.mean((pred - truth) ** 2, axis=(1, 2))
    acc = np.mean(cmap(pred) == cmap(truth), axis=(1, 2))
    return mse, acc


def copy_last_baseline(last_frame, truth, threshold: float = 8.0):
    """The zero-motion forecast: last_frame (R, 3) held for every step of
    truth (T, R, 3). Returns (coord_mse, contact_accuracy), each (T,)."""
    truth_np = np.asarray(truth)
    frozen = np.repeat(np.asarray(last_frame)[None], len(truth_np), axis=0)
    return _score(frozen, truth_np, threshold)


def linear_extrapolation_baseline(prev_frame, last_frame, truth,
                                  threshold: float = 8.0):
    """The constant-velocity forecast ``last + t (last - prev)`` from the
    window's last two frames (R, 3) against truth (T, R, 3). Returns
    (coord_mse, contact_accuracy), each (T,)."""
    prev, last = np.asarray(prev_frame), np.asarray(last_frame)
    truth_np = np.asarray(truth)
    ahead = np.arange(1, truth_np.shape[0] + 1,
                      dtype=truth_np.dtype)[:, None, None]
    return _score(last[None] + (last - prev)[None] * ahead, truth_np,
                  threshold)


def damped_extrapolation_baseline(prev_frame, last_frame, truth,
                                  gamma: float, threshold: float = 8.0):
    """The damped constant-velocity forecast, the headless rollout of a
    ``predict_prior="extrapolate"``, ``prior_damping=gamma`` model:
    ``x_k = last + v gamma (1 - gamma^k) / (1 - gamma)`` with
    ``v = last - prev`` (gamma 1 is the linear forecast, 0 copy-last).
    Returns (coord_mse, contact_accuracy), each (T,)."""
    prev, last = np.asarray(prev_frame), np.asarray(last_frame)
    truth_np = np.asarray(truth)
    k = np.arange(1, truth_np.shape[0] + 1, dtype=np.float64)
    if gamma == 1.0:
        coef = k
    else:
        coef = gamma * (1.0 - gamma ** k) / (1.0 - gamma)
    coef = coef.astype(truth_np.dtype)[:, None, None]
    return _score(last[None] + (last - prev)[None] * coef, truth_np,
                  threshold)
