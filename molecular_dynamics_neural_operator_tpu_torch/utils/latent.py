"""Latent-space visualization (``molecular_dynamics_neural_operator_tpu/utils/latent.py``).

Collect the pre-head latent vectors of a span of frames in batches
(``featurize_batch`` then ``gkn_apply(..., return_latent=True)`` on the
parameters' device), save them as ``.npy``, and render 2-D PCA (numpy
SVD) and t-SNE (scikit-learn, imported inside) embeddings colored by
per-frame RMSD. matplotlib is imported inside as well: without it the
embeddings are saved as ``.npy``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from molecular_dynamics_neural_operator_tpu_torch.device import device_of


def collect_latents(params, cfg, dataset, start_frame: int, num_frames: int,
                    batch_size: int = 256):
    """Batched latent sweep over ``[start_frame, start_frame + num_frames)``:
    (num_frames, R * width), each frame's latent flattened."""
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_apply
    from molecular_dynamics_neural_operator_tpu_torch.train.loop import (
        featurize_batch,
    )

    dev = device_of(params)
    outs = []
    end = min(start_frame + num_frames, len(dataset))
    with torch.no_grad():
        for lo in range(start_frame, end, batch_size):
            idx = np.arange(lo, min(lo + batch_size, end))
            batch = to_device(dataset.get_batch(idx), dev)
            _, latent = gkn_apply(params, cfg, featurize_batch(cfg, batch),
                                  return_latent=True)
            outs.append(latent.float().cpu().numpy().reshape(len(idx), -1))
    return np.concatenate(outs, axis=0)


def pca_embed(latents: np.ndarray, dim: int = 2) -> np.ndarray:
    """2-D PCA via numpy SVD (no sklearn dependency)."""
    x = latents - latents.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:dim].T


def degenerate_latents_reason(latents: np.ndarray) -> Optional[str]:
    """Why these latents cannot be meaningfully embedded, or None if fine.

    Non-finite or zero-variance latents (an early/diverged model) must be
    caught BEFORE the embedding math: ``np.linalg.svd`` raises on NaN, and
    sklearn's Barnes-Hut t-SNE normalizes its init by a std that is 0/NaN
    for degenerate input, feeding NaN coordinates into the C quad tree —
    which recurses until it overflows the stack and kills the whole
    training process. A plot helper must never take down a training run.
    """
    if not np.isfinite(latents).all():
        return "non-finite values"
    # Variance must exist ACROSS FRAMES: a collapsed model that emits the
    # same non-constant vector for every frame has nonzero global ptp but
    # zero per-feature spread — PCA then yields all-zero columns and
    # t-SNE's init-normalization still divides by 0.
    if float(np.ptp(latents, axis=0).max()) == 0.0:
        return "zero variance (all frames identical)"
    return None


def tsne_embed(latents: np.ndarray, dim: int = 2,
               perplexity: float = 30.0) -> Optional[np.ndarray]:
    reason = degenerate_latents_reason(latents)
    if reason is not None:
        print(f"WARNING: skipping t-SNE embedding: latents have {reason}",
              flush=True)
        return None
    try:
        from sklearn.manifold import TSNE
    except Exception:
        return None
    per = min(perplexity, max(2.0, (len(latents) - 1) / 3.0))
    return TSNE(n_components=dim, perplexity=per, init="pca").fit_transform(
        latents
    )


def log_latent_visualization(
    latents: np.ndarray,
    colors: dict,
    run_dir,
    epoch: int,
    method: str = "PCA",
):
    """Save the latents and a colored scatter per color key. Returns
    {color_key: png_path} (and "html")."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    np.save(run_dir / f"latent_space_epoch{epoch}.npy", latents)

    reason = degenerate_latents_reason(latents)
    if reason is not None:
        # latents are still saved above for post-mortem; only the
        # embedding/scatter is skipped (see degenerate_latents_reason).
        print(f"WARNING: skipping {method} latent plot at epoch {epoch}: "
              f"latents have {reason}", flush=True)
        return {}
    emb = pca_embed(latents) if method.upper() == "PCA" else tsne_embed(latents)
    if emb is None:
        return {}
    out = {}
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        for key in colors:
            path = run_dir / f"latent_{method}_{key}_epoch{epoch}.npy"
            np.save(path, emb)
            out[key] = path
        return out

    for key, vals in colors.items():
        vals = np.asarray(vals)[: len(emb)]
        fig, ax = plt.subplots(figsize=(6, 5))
        sc = ax.scatter(emb[:, 0], emb[:, 1], c=vals, s=4, cmap="viridis")
        fig.colorbar(sc, ax=ax, label=key)
        ax.set_title(f"{method} latent space, epoch {epoch}")
        path = run_dir / f"latent_{method}_{key}_epoch{epoch}.png"
        fig.savefig(path, dpi=150)
        plt.close(fig)
        out[key] = path
    html = write_latent_html(run_dir, epoch, method, out)
    if html is not None:
        out["html"] = html
    return out


def write_latent_html(run_dir, epoch: int, method: str, png_paths: dict):
    """Standalone HTML page embedding the latent scatter PNGs (base64),
    which ``MetricLogger`` logs as ``wandb.Html``."""
    import base64

    run_dir = Path(run_dir)
    imgs = []
    for key, path in png_paths.items():
        p = Path(path)
        if p.suffix != ".png" or not p.exists():
            continue
        b64 = base64.b64encode(p.read_bytes()).decode("ascii")
        imgs.append(
            f"<figure><img src='data:image/png;base64,{b64}' "
            f"alt='{key}'/><figcaption>{key}</figcaption></figure>"
        )
    if not imgs:
        return None
    html_path = run_dir / f"latent_{method}_epoch{epoch}.html"
    html_path.write_text(
        "<html><head><title>"
        f"{method} latent space, epoch {epoch}</title></head>"
        "<body>" + "".join(imgs) + "</body></html>"
    )
    return html_path
