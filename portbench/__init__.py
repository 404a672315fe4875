"""The benchmark of the PyTorch and CUDA port
(``molecular_dynamics_neural_operator_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. Everything a
cell needs is found by name: its configuration under ``configs/``, its
traffic mix under ``traffic/``, the program entry the mix names under
``entries/``, and each per-layer metric's reader under ``metrics/``.
"""
