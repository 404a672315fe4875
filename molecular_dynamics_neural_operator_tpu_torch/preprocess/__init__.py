from molecular_dynamics_neural_operator_tpu_torch.preprocess.electrostatics import (  # noqa: E501
    parallel_trajectory_to_electrostatic_grid,
    parse_dx_grid,
    render_apbs_input,
    trajectory_to_electrostatic_grid,
)
from molecular_dynamics_neural_operator_tpu_torch.preprocess.grid import (
    AMINO_ACID_CHARGES,
    DH_MIN_DIST,
    batched_debye_huckel_grids,
    debye_huckel_at_atoms,
    debye_huckel_grid,
    debye_kappa,
    make_grid,
    sample_grid_trilinear,
)

__all__ = ["AMINO_ACID_CHARGES", "DH_MIN_DIST", "batched_debye_huckel_grids",
           "debye_huckel_at_atoms", "debye_huckel_grid", "debye_kappa",
           "make_grid", "parallel_trajectory_to_electrostatic_grid",
           "parse_dx_grid", "render_apbs_input", "sample_grid_trilinear",
           "trajectory_to_electrostatic_grid"]
