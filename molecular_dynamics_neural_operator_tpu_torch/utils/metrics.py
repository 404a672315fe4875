"""Metric sinks (``molecular_dynamics_neural_operator_tpu/utils/metrics.py``).

Per-epoch ``Epoch:\\tTime:\\ttrain_loss:\\tvalid_loss:`` stdout lines in
the tab-separated format the reference's notebook parses, a JSONL file
per run (``metrics.jsonl``) and an optional wandb sink: ``wandb`` is
imported only when asked for, and without it the logger writes JSONL
only, as the JAX package's does."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


def format_epoch_line(epoch: int, seconds: float, train_loss: float,
                      valid_loss: float) -> str:
    """The reference's stdout epoch format."""
    return (
        f"Epoch: {epoch}"
        f"\tTime: {seconds}"
        f"\ttrain_loss: {train_loss}"
        f"\tvalid_loss: {valid_loss}"
    )


def parse_loss_log(text: str):
    """Inverse of ``format_epoch_line``, the analysis notebook's
    ``parse_loss_log``. Returns a list of dicts."""
    rows = []
    for line in text.splitlines():
        if not line.startswith("Epoch:"):
            continue
        parts = line.split("\t")
        try:
            rows.append({
                "epoch": int(parts[0].split(":")[1]),
                "time": float(parts[1].split(":")[1]),
                "train_loss": float(parts[2].split(":")[1]),
                "valid_loss": float(parts[3].split(":")[1]),
            })
        except (IndexError, ValueError):
            continue
    return rows


class MetricLogger:
    def __init__(self, run_dir, use_wandb: bool = False,
                 wandb_project: str = "bba_gno", config: Optional[dict] = None):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.run_dir / "metrics.jsonl", "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=wandb_project, config=config or {})
            except Exception as e:  # wandb not installed / offline
                print(f"[metrics] wandb unavailable ({e}); JSONL only")
                self._wandb = None

    def _rich(self, value):
        """Promote artifact paths to wandb media objects: Video for the
        propagation movie, Image/Html for the latent plots. Non-path
        values pass through."""
        if not isinstance(value, (str, Path)):
            return value
        p = Path(value)
        try:
            if p.suffix in (".mp4", ".gif") and p.exists():
                return self._wandb.Video(str(p))
            if p.suffix == ".png" and p.exists():
                return self._wandb.Image(str(p))
            if p.suffix == ".html" and p.exists():
                with open(p) as f:
                    return self._wandb.Html(f)
        except Exception:
            pass
        return str(value)

    def log(self, step: int, metrics: dict) -> None:
        record = {
            "step": step, "time": time.time(),
            **{k: (str(v) if isinstance(v, Path) else v)
               for k, v in metrics.items()},
        }
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(
                {k: self._rich(v) for k, v in metrics.items()}, step=step
            )

    def log_epoch(self, epoch: int, seconds: float, train_loss: float,
                  valid_loss: float, extra: Optional[dict] = None) -> None:
        print(format_epoch_line(epoch, seconds, train_loss, valid_loss))
        payload = {
            "epoch": epoch,
            "seconds": seconds,
            "avg_train_loss": train_loss,
            "avg_valid_loss": valid_loss,
        }
        if extra:
            payload.update(extra)
        self.log(epoch, payload)

    def close(self) -> None:
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
