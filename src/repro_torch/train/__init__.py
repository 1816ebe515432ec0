"""Training substrate: optimizer, train step, fault-tolerant trainer."""

from .optimizer import OptConfig, init_opt_state, adamw_update, lr_at  # noqa: F401
from .train_step import TrainConfig, make_train_step, make_eval_step  # noqa: F401
from .trainer import Trainer, TrainerConfig  # noqa: F401
