from molecular_dynamics_neural_operator_tpu_torch.preprocess.grid import (
    AMINO_ACID_CHARGES,
    DH_MIN_DIST,
    debye_huckel_at_atoms,
    debye_kappa,
)

__all__ = ["AMINO_ACID_CHARGES", "DH_MIN_DIST", "debye_huckel_at_atoms",
           "debye_kappa"]
