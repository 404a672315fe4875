"""Propagation movie: forecast against real contact maps, step by step
(``molecular_dynamics_neural_operator_tpu/utils/movie.py``).

Roll out from chosen validation windows with ``make_rollout_fn(...,
collect="contact_maps")`` (the maps are made on the device), and render
each step's forecast beside the real map as PNG frames stitched to an mp4
or gif. matplotlib and imageio are imported inside: without matplotlib
the maps are saved as ``epoch<k>_maps.npz`` (``forecast`` and ``real``),
as the JAX package does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from molecular_dynamics_neural_operator_tpu_torch.device import device_of


def select_starting_points(num_valid: int, window_size: int,
                           num_points: int = 3):
    """First / middle / last starting windows of the validation span
    (the reference's choice)."""
    total_steps = num_valid - 10
    potential = list(range(0, max(total_steps, 1), window_size))
    if len(potential) < num_points:
        return potential
    return [potential[0], potential[len(potential) // 2], potential[-1]]


def render_propagation_movie(
    run_dir,
    epoch: int,
    forecast_maps: Sequence[np.ndarray],
    real_maps: Sequence[np.ndarray],
    fps: int = 2,
):
    """Render pairs of (R, R) contact maps to PNG frames + movie file.

    forecast_maps / real_maps: same length lists of dense 0/1 matrices.
    Returns the movie path (or the directory of .npy dumps if matplotlib /
    imageio are unavailable).
    """
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        out = run_dir / f"epoch{epoch}_maps.npz"
        np.savez(out, forecast=np.stack(forecast_maps), real=np.stack(real_maps))
        return out

    filenames = []
    for i, (fc, re) in enumerate(zip(forecast_maps, real_maps)):
        fig, ax = plt.subplots(ncols=2, figsize=(10, 4))
        ax[0].imshow(fc, cmap="cividis")
        ax[1].imshow(re, cmap="cividis")
        fig.suptitle(f"Time Step {i + 1}")
        ax[0].set_title("Forecast")
        ax[1].set_title("Real")
        fn = run_dir / f"epoch{epoch}_gno_movie_frame{i + 1}.png"
        fig.savefig(fn, dpi=150)
        plt.close(fig)
        filenames.append(fn)

    try:
        import imageio.v2 as imageio

        frames = [imageio.imread(f) for f in filenames]
        # mp4 first; it needs an ffmpeg backend, so gif without one
        try:
            movie = run_dir / f"epoch{epoch}_gno_movie.mp4"
            imageio.mimsave(movie, frames, fps=fps)
            return movie
        except Exception:
            movie = run_dir / f"epoch{epoch}_gno_movie.gif"
            imageio.mimsave(movie, frames, fps=fps)
            return movie
    except Exception:
        return run_dir


def make_propagation_movie(
    params,
    cfg,
    dataset,
    run_dir,
    epoch: int,
    starting_points: Sequence[int],
    num_steps: int = 5,
    threshold: float = 8.0,
):
    """Roll out from each starting window (contact maps collected on the
    parameters' device) and render forecast-vs-real frames."""
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )
    dev = device_of(params)
    roll = make_rollout_fn(cfg, num_steps=num_steps, threshold=threshold,
                           collect="contact_maps", device=dev)
    aa = torch.as_tensor(dataset.traj.aminoacids, device=dev)
    forecast, real = [], []
    with torch.no_grad():
        for start in starting_points:
            window0 = dataset.traj.positions[start : start + cfg.window_size]
            cms, *_ = roll(params, aa, window0)
            cms = cms.cpu().numpy()
            for i in range(num_steps):
                forecast.append(cms[i])
                truth_idx = min(start + i + 1, len(dataset) - 1)
                real.append(dataset.dense_adj(truth_idx))
    return render_propagation_movie(run_dir, epoch, forecast, real)
