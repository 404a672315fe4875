from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import (
    edge_conv_dense,
    edge_conv_init,
    edge_conv_sparse,
    edge_kernel_matrices,
    masked_dense_kernels,
    quantize_kernels_int8,
    sparse_inv_degree,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.lstm import (
    lstm_apply,
    lstm_init,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.mlp import (
    linear_apply,
    linear_init,
    mlp_apply,
    mlp_init,
)

__all__ = [
    "edge_conv_dense",
    "edge_conv_init",
    "edge_conv_sparse",
    "edge_kernel_matrices",
    "masked_dense_kernels",
    "quantize_kernels_int8",
    "sparse_inv_degree",
    "lstm_apply",
    "lstm_init",
    "linear_apply",
    "linear_init",
    "mlp_apply",
    "mlp_init",
]
