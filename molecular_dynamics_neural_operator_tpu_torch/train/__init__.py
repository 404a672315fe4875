from molecular_dynamics_neural_operator_tpu_torch.train.curriculum import (
    curriculum_loss_batched,
    curriculum_loss_single,
    make_curriculum_train_step,
)
from molecular_dynamics_neural_operator_tpu_torch.train.loop import (
    eval_epoch,
    featurize_batch,
    make_eval_step,
    make_train_step,
    train_epoch,
)
from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
    make_optimizer,
    step_lr_schedule,
)
from molecular_dynamics_neural_operator_tpu_torch.train.recipe import (
    train_curriculum_recipe,
)
from molecular_dynamics_neural_operator_tpu_torch.train.split import (
    train_valid_split,
)
from molecular_dynamics_neural_operator_tpu_torch.train.state import (
    TrainState,
    apply_update,
    create_train_state,
)

__all__ = ["TrainState", "apply_update", "create_train_state",
           "curriculum_loss_batched", "curriculum_loss_single", "eval_epoch",
           "featurize_batch", "make_curriculum_train_step", "make_eval_step",
           "make_optimizer", "make_train_step", "step_lr_schedule",
           "train_curriculum_recipe", "train_epoch", "train_valid_split"]
