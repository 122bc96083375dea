"""Training (port of ``avr_tpu/training``): loss, optimizer and train state,
the train and eval steps, checkpoints and the ``fit`` loop."""

from avr_tpu_torch.training.checkpoint import (  # noqa: F401
    checkpoint_path,
    restore_checkpoint,
    save_checkpoint,
)
from avr_tpu_torch.training.loss import LossParams, loss_fn  # noqa: F401
from avr_tpu_torch.training.state import (  # noqa: F401
    AdamState,
    Optimizer,
    TrainState,
    create_train_state,
    ema_update,
    make_optimizer,
)
from avr_tpu_torch.training.step import (  # noqa: F401
    apply_gradients,
    make_eval_step,
    make_train_step,
)
from avr_tpu_torch.training.loop import (  # noqa: F401
    FitConfig,
    fit,
    render_full_image,
    validate,
    validate_scenes,
)
