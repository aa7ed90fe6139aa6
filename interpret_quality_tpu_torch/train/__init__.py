"""Training: the losses, the per-family optimisers and schedules, the train
and eval steps, ``fit``, and adversarial (BIM) training."""
from .adversarial import (bim_rotation_attack, bim_translation_attack,
                          fit_adversarial, make_adv_batch_fn, make_adv_step,
                          random_rotation_eval_batch)
from .losses import cal_loss, cross_entropy, smooth_cross_entropy
from .trainer import (balanced_accuracy, eval_step, fit, lr_schedule_for,
                      make_optimizer, make_train_step)

__all__ = ["bim_rotation_attack", "bim_translation_attack",
           "fit_adversarial", "make_adv_batch_fn", "make_adv_step",
           "random_rotation_eval_batch", "cal_loss", "cross_entropy",
           "smooth_cross_entropy", "balanced_accuracy", "eval_step", "fit",
           "lr_schedule_for", "make_optimizer", "make_train_step"]
