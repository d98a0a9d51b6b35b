"""Training: the step, its state, the optimizers, the loop and its
checkpoints (``detjax/train``)."""

from detjax_torch.train.loop import FitResult, ReduceLROnPlateau, fit
from detjax_torch.train.step import (
    TrainState,
    apply_gradients,
    compute_gradients,
    ema_variables,
    get_learning_rate,
    make_optimizer,
    make_train_state,
    set_learning_rate,
    train_step,
)

__all__ = [
    "FitResult",
    "ReduceLROnPlateau",
    "TrainState",
    "apply_gradients",
    "compute_gradients",
    "ema_variables",
    "fit",
    "get_learning_rate",
    "make_optimizer",
    "make_train_state",
    "set_learning_rate",
    "train_step",
]
