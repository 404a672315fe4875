"""PyTorch and CUDA port of the GKN neural operator for protein MD.

A second package beside the JAX reference
(``molecular_dynamics_neural_operator_tpu``), laid out like it so each
counterpart is easy to find:

- ``data``      HDF5 ingestion and writers (h5py imported inside),
                synthetic trajectories, the sliding-window dataset with
                its native packer (``csrc/packing.cpp``, a host helper
                built by g++), the batch stream and host -> device
                staging from a producer thread.
- ``geometry``  contact maps, padded edge lists and edge features.
- ``ops``       linear/MLP, LSTM, edge-conditioned conv and the tied conv
                stack with its hand-written backward in plain PyTorch;
                ``ops/cuda`` holds the hand-written Hopper kernels
                (``csrc/*.cu``) that replace the TPU's Pallas kernels.
- ``models``    the GKN forward (sparse one-hot path, with the optional
                Debye-Hückel node feature), single and batched, and the
                losses.
- ``preprocess`` the Debye-Hückel potential at the residue sites and on
                grids (on the device), and the pdb2pqr/APBS pipeline.
- ``rollout``   the autoregressive free rollout with the contact graph
                rebuilt from the predicted coordinates every step.
- ``train``     teacher-forced training: optimizer, train state, input
                noise, train/eval steps and the epoch loops.
- ``serving``   the continuous-batching rollout server: concurrent
                requests share the stream axis of one segment after
                another; serving bundles (``torch.export`` of one rollout
                step, weights and config).
- ``cli``       ``cli/train.py``, ``cli/rollout.py``, ``cli/export.py``
                and ``cli/preprocess.py``, flag for flag the JAX
                package's, and ``cli/serve.py``, the server behind a TCP
                socket.
- ``utils``     checkpoints in the JAX package's flat npz format (whole
                TrainStates included), the reference KernelNN's
                state_dict converters, metric logging, profiling, the
                propagation movie, latent plots and backbone renders.
- ``configs``, ``presets`` the JAX package's configurations and presets.

The package imports torch and numpy; h5py, matplotlib, imageio,
scikit-learn, wandb, jinja2 and MDAnalysis only inside the functions that
use them. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
