"""3-D backbone rendering (``molecular_dynamics_neural_operator_tpu/utils/backbone.py``).

The predicted Cα chain as a 3-D line-and-marker plot, one PNG per rollout
step (matplotlib, imported inside), stitched to a gif/mp4 when imageio is
present, plus an HTML page embedding the frames; without matplotlib the
coordinates are dumped as ``.npy``. Used by ``cli/rollout.py --backbone``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def render_backbone_3d(
    coords: np.ndarray,
    out_path,
    title: str = "predicted backbone",
    compare: Optional[np.ndarray] = None,
    elev: float = 20.0,
    azim: float = -60.0,
):
    """Render one (R, 3) Calpha chain (optionally vs a reference chain).

    Returns the written path: ``.png`` normally, ``.npy`` if matplotlib is
    unavailable.
    """
    coords = np.asarray(coords)
    out_path = Path(out_path)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        alt = out_path.with_suffix(".npy")
        np.save(alt, coords)
        return alt

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    ax.plot(coords[:, 0], coords[:, 1], coords[:, 2], "-o",
            color="#1f77b4", markersize=4, linewidth=2, label="forecast")
    if compare is not None:
        compare = np.asarray(compare)
        ax.plot(compare[:, 0], compare[:, 1], compare[:, 2], "-o",
                color="#ff7f0e", markersize=3, linewidth=1.2, alpha=0.7,
                label="real")
        ax.legend()
    ax.set_title(title)
    ax.view_init(elev=elev, azim=azim)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def render_backbone_trajectory(
    run_dir,
    coords_seq: Sequence[np.ndarray],
    real_seq: Optional[Sequence[np.ndarray]] = None,
    prefix: str = "backbone",
    fps: int = 2,
):
    """Render a rollout's backbones: one PNG per step, stitched to a
    gif/mp4 when imageio is available, plus an HTML page embedding the
    frames (wandb.Html-compatible). Returns {"frames", "movie", "html"}
    (keys present when producible)."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    frames = []
    for i, c in enumerate(coords_seq):
        cmp_c = None if real_seq is None else np.asarray(real_seq[i])
        p = render_backbone_3d(
            np.asarray(c), run_dir / f"{prefix}_frame{i + 1}.png",
            title=f"backbone, step {i + 1}", compare=cmp_c,
        )
        frames.append(p)
    out = {"frames": frames}
    pngs = [p for p in frames if p.suffix == ".png"]
    if pngs:
        try:
            import imageio.v2 as imageio

            imgs = [imageio.imread(p) for p in pngs]
            try:
                movie = run_dir / f"{prefix}.mp4"
                imageio.mimsave(movie, imgs, fps=fps)
            except Exception:
                movie = run_dir / f"{prefix}.gif"
                imageio.mimsave(movie, imgs, fps=fps)
            out["movie"] = movie
        except Exception:
            pass
        import base64

        body = "".join(
            f"<figure><img src='data:image/png;base64,"
            f"{base64.b64encode(p.read_bytes()).decode('ascii')}'/>"
            f"<figcaption>step {i + 1}</figcaption></figure>"
            for i, p in enumerate(pngs)
        )
        html = run_dir / f"{prefix}.html"
        html.write_text(f"<html><body>{body}</body></html>")
        out["html"] = html
    return out
