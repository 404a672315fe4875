from molecular_dynamics_neural_operator_tpu_torch.data.h5 import (
    TrajectoryData,
)
from molecular_dynamics_neural_operator_tpu_torch.data.synthetic import (
    langevin_trajectory,
    synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.data.windows import (
    WindowDataset,
    batch_iterator,
)

__all__ = ["TrajectoryData", "WindowDataset", "batch_iterator",
           "langevin_trajectory", "synthetic_trajectory"]
