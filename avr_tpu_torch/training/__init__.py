"""Training (port of ``avr_tpu/training``): loss, optimizer and train state,
the train step."""

from avr_tpu_torch.training.loss import LossParams, loss_fn  # noqa: F401
from avr_tpu_torch.training.state import (  # noqa: F401
    AdamState,
    Optimizer,
    TrainState,
    create_train_state,
    ema_update,
    make_optimizer,
)
from avr_tpu_torch.training.step import apply_gradients, make_train_step  # noqa: F401
