"""Training (counterpart of ``interpret_quality_tpu/train/trainer.py``): the
per-family optimisers and schedules, the train and eval steps, and ``fit``.

Reference policy (main_cls_seed.py:78-101, 224), as the JAX package runs it:
  * pointnet / pointnet2: Adam lr 1e-3, L2 1e-4, x0.7 every 20 epochs, 200 epochs
  * pointconv:            SGD lr 1e-2, momentum 0.9, L2 1e-4, x0.7 every 30
                          epochs, 400 epochs
  * dgcnn / gcnn:         SGD lr 0.1, momentum 0.9, L2 1e-4, cosine to 1e-3,
                          250 epochs
The L2 term is added to the gradient before the moments (torch's coupled
``weight_decay``, optax's ``add_decayed_weights`` before ``scale_by_adam`` /
``trace``).  Every schedule is a function of the optimiser step, as optax
counts it: the staircases drop on epoch boundaries, the cosine moves every
step.  Label smoothing is for the edge-conv family only; PointNet adds the
feature-transform regulariser x 1e-3.  A padded tail batch is masked out of
the loss by its validity weights, while BatchNorm still sees its pad rows.

A train step runs the model in training mode, un-fused (``train_forward``);
the kNN and FPS kernels still give its graphs and centres on the card.  The
eval pass runs the fused eval forward through every kernel of the family.
Checkpoints are state dicts in the reference's naming (``.t7``).
"""
from __future__ import annotations

import math
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..models import feature_transform_regularizer, train_forward
from ..models.registry import _logits
from ..utils.io import IOStream, mkdir
from .losses import cal_loss

EPOCHS_BY_MODEL = {"pointnet": 200, "pointnet2": 200, "pointconv": 400,
                   "dgcnn": 250, "gcnn": 250, "gcnn_adv": 400}
SMOOTHED = ("dgcnn", "gcnn", "gcnn_adv")
FT_REG_WEIGHT = 1e-3
MOMENTUM, WEIGHT_DECAY = 0.9, 1e-4
CHECKPOINT_EVERY = 10
PREFETCH_DEPTH = 2


def balanced_accuracy(y_true, y_pred) -> float:
    """Mean per-class recall (sklearn ``balanced_accuracy_score``, reference
    main_cls_seed.py:155-158) without sklearn."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    recalls = [float((y_pred[y_true == c] == c).mean())
               for c in np.unique(y_true)]
    return float(np.mean(recalls))


def prefetch(iterator):
    """Run ``iterator`` in a producer thread that keeps ``PREFETCH_DEPTH``
    items ahead of the consumer (the batches' numpy augmentations overlap the
    device's step).  An exception in the producer is raised on the consumer
    side; a consumer that abandons the generator sets the stop event, so the
    producer never blocks for ever on a full queue."""
    q: queue.Queue = queue.Queue(maxsize=PREFETCH_DEPTH)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in iterator:
                if not put((None, item)):
                    return
            put((done, None))
        except BaseException as e:           # re-raised on the consumer side
            put((e, None))

    threading.Thread(target=produce, daemon=True).start()
    try:
        while True:
            err, item = q.get()
            if err is done:
                return
            if err is not None:
                raise err
            yield item
    finally:
        stop.set()


def lr_schedule_for(model_name: str, steps_per_epoch: int, epochs: int,
                    base_lr: float = 1e-3) -> Callable[[int], float]:
    """The family's learning rate as a function of the optimiser step
    (optax's ``exponential_decay(staircase=True)`` and
    ``cosine_decay_schedule``, reference main_cls_seed.py:80-96).  The
    staircase is evaluated in float32, as optax evaluates it from its int32
    step count even where JAX runs in float64."""
    if model_name in ("pointnet", "pointnet2", "pointconv"):
        init, every = ((base_lr, 20) if model_name != "pointconv"
                       else (base_lr * 10, 30))
        every *= steps_per_epoch
        return lambda step: float(np.float32(init) * np.float32(0.7) ** (
            np.float32(step // every)))
    init = base_lr * 100                        # dgcnn / gcnn / gcnn_adv
    decay_steps = epochs * steps_per_epoch
    alpha = 1e-3 / init

    def cosine(step: int) -> float:
        c = min(step, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c
                                                         / decay_steps))
                       + alpha)
    return cosine


def make_optimizer(model: torch.nn.Module, model_name: str,
                   steps_per_epoch: int, epochs: Optional[int] = None,
                   base_lr: float = 1e-3):
    """The family's optimiser and its ``LambdaLR`` schedule, stepped once
    per optimiser step: Adam for PointNet and PointNet++, SGD with momentum
    otherwise, L2 added to the gradient.  The optimiser's own lr is 1, so
    each step's lr is the schedule's value itself, lr(0) at the first.
    Returns (optimizer, scheduler, epochs)."""
    epochs = epochs or EPOCHS_BY_MODEL[model_name]
    schedule = lr_schedule_for(model_name, steps_per_epoch, epochs, base_lr)
    if model_name in ("pointnet", "pointnet2"):
        optimizer = torch.optim.Adam(model.parameters(), lr=1.0,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=WEIGHT_DECAY)
    else:
        optimizer = torch.optim.SGD(model.parameters(), lr=1.0,
                                    momentum=MOMENTUM,
                                    weight_decay=WEIGHT_DECAY)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)
    return optimizer, scheduler, epochs


def valid_weights(batch: int, valid: int, device) -> torch.Tensor:
    """The padded tail's mask: rows below ``valid`` are real."""
    return torch.arange(batch, device=device) < valid


def train_loss(model: torch.nn.Module, model_name: str, data: torch.Tensor,
               labels: torch.Tensor, weights: torch.Tensor,
               generator: Optional[torch.Generator] = None):
    """(loss, logits) of the train forward: the family's loss, the pad rows
    masked out by ``weights``, plus PointNet's regulariser."""
    logits, trans_feat = train_forward(model, data, generator)
    loss = cal_loss(logits, labels, smoothing=model_name in SMOOTHED,
                    weights=weights)
    if trans_feat is not None:                      # PointNet's
        reg = feature_transform_regularizer(trans_feat)
        loss = loss + reg * FT_REG_WEIGHT
    return loss, logits


def make_train_step(model: torch.nn.Module, optimizer, scheduler,
                    model_name: str,
                    generator: Optional[torch.Generator] = None):
    """(data, labels, valid) -> (loss, preds), a step of the optimiser on
    the model in the mode its caller set (training: batch statistics,
    dropout from ``generator``).  The loss and the predictions (of the
    logits before the step) stay on the device."""

    def step(data: torch.Tensor, labels: torch.Tensor, valid: int):
        weights = valid_weights(data.shape[0], valid, data.device)
        loss, logits = train_loss(model, model_name, data, labels, weights,
                                  generator)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        scheduler.step()
        return loss.detach(), logits.detach().argmax(dim=-1)

    return step


def eval_step(model: torch.nn.Module, data: torch.Tensor,
              labels: torch.Tensor, valid: Optional[int], smoothing: bool):
    """(loss, preds) of the model's eval forward (fused: every kernel of
    the family on the card), the pad rows masked out of the loss."""
    with torch.no_grad():
        logits = _logits(model.eval()(data))
        weights = (None if valid is None
                   else valid_weights(data.shape[0], valid, data.device))
        loss = cal_loss(logits, labels, smoothing=smoothing, weights=weights)
    return loss, logits.argmax(dim=-1)


def evaluate(model: torch.nn.Module, test_ds, batch_size: int,
             smoothing: bool, device):
    """The eval pass over ``test_ds`` in order: (mean loss, labels, preds)."""
    losses, valids, true, pred = [], [], [], []
    for data, labels, valid in test_ds.batches(batch_size, shuffle=False):
        loss, preds = eval_step(model, torch.from_numpy(data).to(device),
                                torch.from_numpy(labels).to(device), valid,
                                smoothing)
        losses.append(loss)
        valids.append(valid)
        true.append(labels[:valid])
        pred.append(preds[:valid])
    return (_weighted_sum(losses, valids) / sum(valids), np.concatenate(true),
            torch.cat(pred).cpu().numpy())


def _weighted_sum(losses, valids) -> float:
    """sum of loss * valid in float64, one host copy for the whole list."""
    values = torch.stack(losses).double().cpu().numpy()
    return float(sum(v * n for v, n in zip(values, valids)))


def save_state(model: torch.nn.Module, path: str) -> None:
    """The model's state dict, on the CPU, in the reference's naming."""
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)


def fit(model: torch.nn.Module, model_name: str, train_ds, test_ds, *,
        exp_dir: str, io: IOStream, batch_size: int = 32,
        test_batch_size: int = 16, epochs: Optional[int] = None,
        seed: int = 1, best_acc_gate: float = 0.80, base_lr: float = 1e-3):
    """Train the model in place on its own device; a checkpoint every 10
    epochs (``models/model_{epoch}.t7``) and ``models/model_best.t7`` when
    the test accuracy reaches the best so far, starting from
    ``best_acc_gate`` (reference main_cls_seed.py:108, 202-209).  Dropout
    masks come from a generator seeded with ``seed``; the batches' shuffle
    and augmentations from numpy's global stream, in the prefetch thread.
    Lines go to ``io`` in the JAX package's run.log format.  Returns
    (model, best test accuracy)."""
    mkdir(exp_dir + "/models")
    device = next(model.parameters()).device
    # ceil: the padded tail runs ceil(len / bs) steps, and the staircases
    # must drop on true epoch boundaries
    steps_per_epoch = max(1, -(-len(train_ds) // batch_size))
    smoothing = model_name in SMOOTHED
    optimizer, scheduler, epochs = make_optimizer(
        model, model_name, steps_per_epoch, epochs, base_lr)
    generator = torch.Generator(device=device).manual_seed(seed)
    train_step = make_train_step(model, optimizer, scheduler, model_name,
                                 generator)

    best_test_acc = best_acc_gate
    for epoch in range(epochs):
        t0 = time.time()
        model.train()
        losses, valids, tr_true, tr_pred = [], [], [], []
        for data, labels, valid in prefetch(train_ds.batches(batch_size)):
            loss, preds = train_step(torch.from_numpy(data).to(device),
                                     torch.from_numpy(labels).to(device),
                                     valid)
            losses.append(loss)
            valids.append(valid)
            tr_true.append(labels[:valid])
            tr_pred.append(preds[:valid])
        train_loss = _weighted_sum(losses, valids) / sum(valids)
        tr_true = np.concatenate(tr_true)
        tr_pred = torch.cat(tr_pred).cpu().numpy()
        io.cprint("Train %d, loss: %.6f, train acc: %.6f, train avg acc: "
                  "%.6f (%.1fs)"
                  % (epoch, train_loss, float((tr_true == tr_pred).mean()),
                     balanced_accuracy(tr_true, tr_pred), time.time() - t0))

        test_loss, te_true, te_pred = evaluate(model, test_ds,
                                               test_batch_size, smoothing,
                                               device)
        test_acc = float((te_true == te_pred).mean())
        io.cprint("Test %d, loss: %.6f, test acc: %.6f, test avg acc: %.6f"
                  % (epoch, test_loss, test_acc,
                     balanced_accuracy(te_true, te_pred)))

        if epoch % CHECKPOINT_EVERY == CHECKPOINT_EVERY - 1:
            save_state(model, f"{exp_dir}/models/model_{epoch}.t7")
        if test_acc >= best_test_acc:
            best_test_acc = test_acc
            save_state(model, f"{exp_dir}/models/model_best.t7")
            io.cprint("#### new best ####")
    model.eval()
    return model, best_test_acc
