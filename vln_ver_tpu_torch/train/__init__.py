"""Training: objective, optimizer and schedule, train step, batch feed."""

from .feed import staged_batches, to_device  # noqa: F401
from .objective import compute_losses  # noqa: F401
from .state import (TrainConfig, TrainState,  # noqa: F401
                    create_train_state, make_lr_schedule)
from .step import make_train_step  # noqa: F401
