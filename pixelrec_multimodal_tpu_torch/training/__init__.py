"""Training of the port: optimizers and schedules, the frozen-feature
train and eval steps (``make_step_fns``) and the ``Trainer`` that drives
them over a dataset."""
from .optimizers import (  # noqa: F401
    LRScheduler,
    build_optimizer,
    get_learning_rate,
    set_learning_rate,
    with_frozen,
)
from .steps import TrainState, init_train_state, make_step_fns  # noqa: F401
from .trainer import Trainer  # noqa: F401
