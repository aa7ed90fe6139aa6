"""Adversarial (BIM) training of adv-GCNN (counterpart of
``interpret_quality_tpu/train/adversarial.py``; reference main_cls_adv.py).

Both attacks are plain Python loops of ``torch.autograd.grad`` steps with
respect to the attack's own variables (the angles, or the translation)
through the differentiable axis-angle rotation (``ops.transforms``):

  * rotation BIM, 7 steps: alpha += step * sign(g_alpha), clipped to
    [-threshold, threshold]; (theta, phi) move along their jointly
    normalised gradient (a zero norm read as 1);
  * translation BIM, 3 steps on top of the rotated cloud: t += step * g/|g|
    per cloud, then projected onto the threshold ball.

The attack runs the model in eval mode (running statistics, no dropout) on
its un-fused, differentiable forward, and never calls ``backward``: the
parameters' gradients and the running statistics stay as the train step
left them.  The train step then fits both adversarial variants from the
same parameters, their gradients summed into one optimiser step.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Optional

import torch

from ..models import PointNetCls, train_forward
from ..models.registry import _logits
from ..ops.transforms import rot_angle_axis
from ..utils.io import IOStream, mkdir
from .losses import cal_loss
from .trainer import (CHECKPOINT_EVERY, _weighted_sum, balanced_accuracy,
                      eval_step, evaluate, make_optimizer, prefetch,
                      save_state, valid_weights)

# BIM attack schedule: reference main_cls_adv.py:312-317 argparse defaults,
# which scripts/train_models.sh uses verbatim for the adv-GCNN recipe.
ROT_ADV_ITER = 7
ROT_ADV_STEP = math.pi / 10
ROT_ADV_THRESHOLD = math.pi / 2
TRANS_ADV_ITER = 3
TRANS_ADV_STEP = 0.4
TRANS_ADV_THRESHOLD = 1.0


def bim_rotation_attack(loss_of_cloud: Callable, data: torch.Tensor,
                        labels: torch.Tensor, iterations: int = ROT_ADV_ITER,
                        step: float = ROT_ADV_STEP,
                        threshold: float = ROT_ADV_THRESHOLD) -> torch.Tensor:
    """BIM over (alpha, theta, phi) from 0; returns the rotated clouds
    (B, N, 3), detached.

    Args:
      loss_of_cloud: (clouds (B, N, 3), labels) -> scalar loss.
    """
    data = data.detach()
    zeros = torch.zeros(data.shape[0], dtype=data.dtype, device=data.device)
    alphas, thetas, phis = zeros, zeros, zeros
    with torch.enable_grad():
        for _ in range(iterations):
            angles = [a.detach().requires_grad_() for a in
                      (alphas, thetas, phis)]
            loss = loss_of_cloud(rot_angle_axis(data, *angles), labels)
            g_a, g_t, g_p = torch.autograd.grad(loss, angles)
            norm = torch.sqrt(g_t ** 2 + g_p ** 2)
            norm = torch.where(norm == 0, torch.ones_like(norm), norm)
            alphas = torch.clamp(alphas + step * torch.sign(g_a), -threshold,
                                 threshold)
            thetas = thetas + step * g_t / norm
            phis = phis + step * g_p / norm
    return rot_angle_axis(data, alphas.detach(), thetas.detach(),
                          phis.detach())


def bim_translation_attack(loss_of_cloud: Callable, data: torch.Tensor,
                           labels: torch.Tensor,
                           iterations: int = TRANS_ADV_ITER,
                           step: float = TRANS_ADV_STEP,
                           threshold: float = TRANS_ADV_THRESHOLD
                           ) -> torch.Tensor:
    """BIM over one (B, 1, 3) translation per cloud with projection onto
    the L2 ball of ``threshold``; returns the translated clouds, detached."""
    data = data.detach()
    trans = torch.zeros(data.shape[0], 1, 3, dtype=data.dtype,
                        device=data.device)
    with torch.enable_grad():
        for _ in range(iterations):
            t = trans.detach().requires_grad_()
            (g,) = torch.autograd.grad(loss_of_cloud(data + t, labels), [t])
            gnorm = torch.linalg.vector_norm(g, dim=2, keepdim=True)
            trans = trans + step * g / torch.clamp(gnorm, min=1e-30)
            tnorm = torch.linalg.vector_norm(trans, dim=2, keepdim=True)
            trans = threshold * trans / torch.clamp(tnorm, min=threshold)
    return data + trans.detach()


def make_adv_batch_fn(model: torch.nn.Module,
                      rot_kwargs: Optional[dict] = None,
                      trans_kwargs: Optional[dict] = None):
    """(data, labels) -> (data_rot, data_rot_trans): the two adversarial
    variants the adv trainer fits on (main_cls_adv.py:170-192), both
    detached.  The attack's loss is the unweighted smoothed cross entropy
    over the whole (padded) batch, of the model in eval mode on its
    un-fused forward; every module's mode is restored afterwards."""
    rot_kwargs = rot_kwargs or {}
    trans_kwargs = trans_kwargs or {}
    # the fused eval paths run kernels without a backward; PointNet has none
    unfused = {} if isinstance(model, PointNetCls) else {"fused": False}

    def loss_of_cloud(clouds, labels):
        return cal_loss(_logits(model(clouds, **unfused)), labels,
                        smoothing=True)

    def gen(data: torch.Tensor, labels: torch.Tensor):
        modes = [(m, m.training) for m in model.modules()]
        model.eval()
        try:
            data_rot = bim_rotation_attack(loss_of_cloud, data, labels,
                                           **rot_kwargs)
            data_disturb = bim_translation_attack(loss_of_cloud, data_rot,
                                                  labels, **trans_kwargs)
        finally:
            for m, training in modes:       # each module's own mode back
                m.training = training
        return data_rot, data_disturb

    return gen


def make_adv_step(model: torch.nn.Module, optimizer, scheduler,
                  generator: Optional[torch.Generator] = None):
    """(data, labels, valid) -> (l1 + l2, preds1, preds2): the BIM variants
    of the batch, then two train-mode forwards and backwards from the same
    parameters (the second on the running statistics the first left), the
    gradients summed into one optimiser and one schedule step.  The losses
    weight the valid rows; the predictions are of the logits before the
    step.  Everything stays on the device."""
    gen_adv = make_adv_batch_fn(model)

    def variant_loss(data, labels, weights):
        logits, _ = train_forward(model, data, generator)
        loss = cal_loss(logits, labels, smoothing=True, weights=weights)
        loss.backward()
        return loss.detach(), logits.detach().argmax(dim=-1)

    def step(data: torch.Tensor, labels: torch.Tensor, valid: int):
        weights = valid_weights(data.shape[0], valid, data.device)
        data_rot, data_disturb = gen_adv(data, labels)
        optimizer.zero_grad(set_to_none=True)
        l1, preds1 = variant_loss(data_rot, labels, weights)
        l2, preds2 = variant_loss(data_disturb, labels, weights)
        optimizer.step()
        scheduler.step()
        return l1 + l2, preds1, preds2

    return step


def random_rotation_eval_batch(generator: torch.Generator,
                               data: torch.Tensor) -> torch.Tensor:
    """A random axis-angle rotation of each cloud for the per-epoch
    robustness eval (main_cls_adv.py:253-258): alpha in [-pi/2, pi/2),
    theta in [0, pi), phi in [0, 2 pi), drawn from ``generator`` (on the
    data's device)."""
    def uniform():
        return torch.rand(data.shape[0], generator=generator,
                          dtype=data.dtype, device=data.device)
    alphas = uniform() * math.pi - math.pi / 2
    thetas = uniform() * math.pi
    phis = uniform() * 2 * math.pi
    return rot_angle_axis(data, alphas, thetas, phis)


def fit_adversarial(model: torch.nn.Module, model_name: str, train_ds,
                    test_ds, *, exp_dir: str, io: IOStream,
                    batch_size: int = 16, test_batch_size: int = 16,
                    epochs: int = 400, seed: int = 1,
                    best_acc_gate: float = 0.80, base_lr: float = 1e-3):
    """Adversarial training of the model in place on its own device (the
    reference's two backward passes into one opt.step(),
    main_cls_adv.py:109-192), with the per-epoch clean and random-rotation
    evals (:242-277).  ``models/model_{epoch}.t7`` every 10 epochs and
    ``models/model_best.t7`` when the clean test accuracy reaches the best
    so far, from ``best_acc_gate``.  Dropout masks come from a generator
    seeded with ``seed``, the eval rotations from one seeded with
    ``seed + 1``; the batches' shuffle and augmentations from numpy's
    global stream.  Lines go to ``io`` in the JAX package's run.log format.
    Returns (model, best test accuracy)."""
    mkdir(exp_dir + "/models")
    device = next(model.parameters()).device
    steps_per_epoch = max(1, -(-len(train_ds) // batch_size))  # see fit
    optimizer, scheduler, epochs = make_optimizer(
        model, model_name, steps_per_epoch, epochs, base_lr)
    dropout_gen = torch.Generator(device=device).manual_seed(seed)
    rotation_gen = torch.Generator(device=device).manual_seed(seed + 1)
    adv_step = make_adv_step(model, optimizer, scheduler, dropout_gen)

    best_test_acc = best_acc_gate
    for epoch in range(epochs):
        t0 = time.time()
        model.train()
        losses, valids, hits = [], [], []
        for data, labels, valid in prefetch(train_ds.batches(batch_size)):
            labels_d = torch.from_numpy(labels).to(device)
            loss, p1, p2 = adv_step(torch.from_numpy(data).to(device),
                                    labels_d, valid)
            losses.append(loss)
            valids.append(valid)
            hits.append((p1[:valid] == labels_d[:valid]).sum()
                        + (p2[:valid] == labels_d[:valid]).sum())
        count = 2 * sum(valids)                 # two variants a cloud
        io.cprint("Train %d, loss: %.6f, train acc: %.6f (%.1fs)"
                  % (epoch, _weighted_sum(losses, valids) / count,
                     int(torch.stack(hits).sum()) / count, time.time() - t0))

        test_loss, te_true, te_pred = evaluate(model, test_ds,
                                               test_batch_size, True, device)
        test_acc = float((te_true == te_pred).mean())
        io.cprint("Test %d, loss: %.6f, test acc: %.6f, test avg acc: %.6f"
                  % (epoch, test_loss, test_acc,
                     balanced_accuracy(te_true, te_pred)))

        rot_hits, rot_count = 0, 0
        for data, labels, valid in test_ds.batches(test_batch_size,
                                                   shuffle=False):
            rot = random_rotation_eval_batch(
                rotation_gen, torch.from_numpy(data).to(device))
            labels_d = torch.from_numpy(labels).to(device)
            _, preds = eval_step(model, rot, labels_d, None, True)
            rot_hits += int((preds[:valid] == labels_d[:valid]).sum())
            rot_count += valid
        io.cprint("Test adv %d, rot-robust acc: %.6f"
                  % (epoch, rot_hits / rot_count))

        if epoch % CHECKPOINT_EVERY == CHECKPOINT_EVERY - 1:
            save_state(model, f"{exp_dir}/models/model_{epoch}.t7")
        if test_acc >= best_test_acc:
            best_test_acc = test_acc
            save_state(model, f"{exp_dir}/models/model_best.t7")
    model.eval()
    return model, best_test_acc
