"""Train/valid index splits (``molecular_dynamics_neural_operator_tpu/train/split.py``).

"random" is a uniform shuffle split, "partition" a contiguous prefix and
suffix. ``data.batch_iterator`` streams batches from the index arrays.
"""

from __future__ import annotations

import numpy as np


def train_valid_split(num_examples: int, split_pct: float = 0.8,
                      method: str = "partition", seed: int = 0):
    train_len = int(num_examples * split_pct)
    indices = np.arange(num_examples)
    if method == "random":
        indices = np.random.default_rng(seed).permutation(indices)
    elif method != "partition":
        raise ValueError(f"Invalid method: {method}.")
    return indices[:train_len], indices[train_len:]
