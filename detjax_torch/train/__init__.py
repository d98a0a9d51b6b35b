"""Training: the step, its state and the optimizers (``detjax/train``)."""

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
    "TrainState",
    "apply_gradients",
    "compute_gradients",
    "ema_variables",
    "get_learning_rate",
    "make_optimizer",
    "make_train_state",
    "set_learning_rate",
    "train_step",
]
