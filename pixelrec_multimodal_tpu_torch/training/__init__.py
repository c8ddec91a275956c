"""Training of the port: optimizers and schedules, and the frozen-feature
train and eval steps (``make_step_fns``)."""
from .optimizers import (  # noqa: F401
    LRScheduler,
    build_optimizer,
    get_learning_rate,
    set_learning_rate,
    with_frozen,
)
from .steps import TrainState, init_train_state, make_step_fns  # noqa: F401
