"""Training: the losses, the per-family optimisers and schedules, the train
and eval steps, and ``fit``."""
from .losses import cal_loss, cross_entropy, smooth_cross_entropy
from .trainer import (balanced_accuracy, eval_step, fit, lr_schedule_for,
                      make_optimizer, make_train_step)

__all__ = ["cal_loss", "cross_entropy", "smooth_cross_entropy",
           "balanced_accuracy", "eval_step", "fit", "lr_schedule_for",
           "make_optimizer", "make_train_step"]
