"""One step of each multi-device path, at tiny sizes (counterpart of
``__graft_entry__.dryrun_multichip`` in the JAX package).

    python -m interpret_quality_tpu_torch.parallel.dryrun --devices N [--device cpu]

On PointNet with clouds of N_POINTS points and R regions, over n devices:
  1. one data-parallel train step (``data_parallel.make_dp_train_step``) on
     a batch of 2n clouds, one process per device (``spawn``);
  2. the Shapley engine on the trained weights, its coalition batch split
     over the n devices (``parallel.coalition_split``);
  3. Shapley init and a 4-pose scale enumeration, then gen_pair and the
     interaction logits, then a 2-epoch smoothness run, all through the
     stages with the split, their artifacts in a temporary folder;
  4. the interaction engine over the split.
Each step checks the shapes and finiteness the JAX dryrun checks.  On
``cuda`` (the default) each rank takes its own card and the ranks meet
through NCCL; asking for more cards than are visible raises.  With
``--device cpu`` the ranks meet through gloo and the split is the virtual
one over n CPU "devices".
"""
from __future__ import annotations

import argparse
import copy
import os
import tempfile
from typing import List, Optional

import numpy as np
import torch

from ..attrib.interactions import (InteractionEngine, run_gen_pair,
                                   run_interaction_logits)
from ..attrib.shapley import ShapleyEngine
from ..attrib.smoothness import run_smoothness
from ..attrib.stages import run_enum, run_shapley_init
from ..config import ExperimentConfig
from ..models import build_model, make_forward_fn
from ..models.common import Dropout, resolve_device
from ..pipeline import resolve_dataset
from ..train.trainer import make_optimizer
from .data_parallel import DPGroup, make_dp_train_step, spawn
from .mesh import coalition_split, make_mesh

MODEL = "pointnet"
N_POINTS, REGIONS, K = 64, 32, 20


def dp_step_rank(group: DPGroup, model_name: str, state: dict,
                 data: np.ndarray, labels: np.ndarray, valid: int,
                 seed: int = 1, dropout: bool = True,
                 dtype: torch.dtype = torch.float32) -> dict:
    """One data-parallel train step on this rank from the state dict
    ``state``, in ``dtype``, the dropout masks
    from a generator seeded with ``seed`` (or the dropouts off): the global
    loss, the predictions of the whole batch, every parameter's gradient
    (summed over the ranks) and the state dict after the step, on the
    CPU."""
    model = build_model(model_name, 10, K)
    model.load_state_dict(state, strict=True)
    model = model.to(group.device, dtype).train()
    if not dropout:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.eval()
    optimizer, scheduler, _ = make_optimizer(model, model_name,
                                             steps_per_epoch=1, epochs=1)
    generator = torch.Generator(device=group.device).manual_seed(seed)
    step = make_dp_train_step(model, optimizer, scheduler, model_name, group,
                              generator)
    loss, preds = step(torch.as_tensor(data, dtype=dtype).to(group.device),
                       torch.as_tensor(labels, dtype=torch.int64
                                       ).to(group.device), valid)
    return {"loss": loss.cpu(), "preds": preds.cpu(),
            "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
            "state": {k: v.cpu() for k, v in model.state_dict().items()}}


def dryrun_devices(n_devices: int, device: str) -> List[torch.device]:
    """The n devices of the run: the first n visible cards (raises when
    fewer are visible), or n times the CPU."""
    if device == "cuda":
        resolve_device("cuda")
        return make_mesh(n_devices)
    if device != "cpu":
        raise ValueError(f"unknown device {device!r}")
    return [torch.device("cpu")] * n_devices


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    devices = dryrun_devices(n_devices, device)
    backend = "nccl" if device == "cuda" else "gloo"
    n, N, R = n_devices, N_POINTS, REGIONS

    # ---- 1. data-parallel training step --------------------------------
    torch.manual_seed(0)
    model = build_model(MODEL, 10)
    B = 2 * n
    rng = np.random.RandomState(0)
    data = rng.randn(B, N, 3).astype(np.float32)
    labels = rng.randint(0, 10, B).astype(np.int64)
    ranks = spawn(dp_step_rank, n, backend, devices,
                  args=(MODEL, model.state_dict(), data, labels, B))
    loss = float(ranks[0]["loss"])
    assert np.isfinite(loss) and ranks[0]["preds"].shape == (B,)
    assert all(torch.equal(r["loss"], ranks[0]["loss"]) for r in ranks)
    print(f"[dryrun] dp training step ok on {n} devices, loss={loss:.4f}")

    # ---- 2. coalition-split Shapley step -------------------------------
    model.load_state_dict(ranks[0]["state"])
    model.eval()
    split = coalition_split(
        lambda d: make_forward_fn(copy.deepcopy(model).to(d)), devices)
    engine = ShapleyEngine(split, num_regions=R, softmax_type="modified",
                           batch_orders=n, device=split.device)
    cloud = rng.randn(N, 3).astype(np.float32)
    region_id = rng.randint(0, R, N)
    region_id[:R] = np.arange(R)
    orders = np.stack([rng.permutation(R) for _ in range(n)])
    sv = engine.shapley_for_pose(cloud, 3, region_id, orders)
    assert sv.shape == (R,) and np.isfinite(sv).all()
    print(f"[dryrun] coalition-split shapley ok: {n} orders x {R + 1} rows "
          f"over {n} devices")

    # ---- 3. the stages over the split, end to end ----------------------
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)                   # the fps index path is cwd-relative
        try:
            _dryrun_stages(n, devices, device, tmp)
        finally:
            os.chdir(cwd)

    # ---- 4. coalition-split interaction engine -------------------------
    ieng = InteractionEngine(split, num_regions=R, batch_contexts=n,
                             device=split.device)
    pairs = np.array([[0, 1], [2, 3]])
    ctx = np.stack([np.stack([rng.choice(
        [r for r in range(R) if r not in p], 3, replace=False)
        for _ in range(n)]) for p in pairs])            # (2, n, 3)
    logits = ieng.logits_for_pairs(cloud, region_id, pairs, ctx)
    assert logits.shape == (2, 4 * n, 10) and np.isfinite(logits).all()
    print(f"[dryrun] coalition-split interaction engine ok: {2 * n} (pair, "
          f"context) rows x 4 over {n} devices")


def _dryrun_stages(n: int, devices, device: str, tmp: str) -> None:
    N, R = N_POINTS, REGIONS
    cfg = ExperimentConfig(model=MODEL, dataset="modelnet10", seed=1,
                           num_points=N, num_samples_save=n, num_samples=n,
                           shapley_batch_size=n,
                           checkpoints_root=tmp + "/checkpoints",
                           device=device)
    run_shapley_init(cfg, synthetic=True, allow_random_init=True,
                     coalition_devices=devices, sample_indices=[0])
    run_enum(cfg, "scale", synthetic=True, allow_random_init=True,
             sample_indices=[0], max_poses=4, coalition_devices=devices)
    _, names = resolve_dataset(cfg, synthetic=True)
    sv = np.load(cfg.exp_folder
                 + f"{names[0]}/scale_all/region_shapley_value.npy")
    assert sv.shape == (4, R) and np.isfinite(sv).all()
    print(f"[dryrun] split enum stage ok: 4 poses x {n} orders over {n} "
          f"devices, artifacts written")

    run_gen_pair(cfg, "scale", synthetic=True, allow_random_init=True,
                 ratios=(0.25,), num_pairs_random=4, num_save_context_max=4,
                 sample_indices=[0])
    run_interaction_logits(cfg, "scale", synthetic=True,
                           allow_random_init=True, ratios=(0.25,),
                           coalition_devices=devices, sample_indices=[0])
    inter = cfg.exp_folder + f"{names[0]}/interaction_seed1/"
    for sub in ("normal", "scale_adv"):
        lg = torch.load(f"{inter}{sub}/ratio25_all_logits.pt")
        assert lg.ndim == 3 and tuple(lg.shape[1:]) == (4 * 4, 10)
        assert torch.isfinite(torch.as_tensor(lg)).all()
    print(f"[dryrun] split interaction-logits stage ok: "
          f"ratio25_all_logits.pt written for normal + adv poses over {n} "
          f"devices")

    run_smoothness(cfg, modes=("linearity",), synthetic=True,
                   allow_random_init=True, sample_indices=[0], max_epochs=2,
                   coalition_devices=devices)
    sm = np.load(cfg.exp_folder + f"{names[0]}/linearity_all/"
                 "allregion_inc/region_shapley_value.npy")
    assert sm.shape[1] == R and np.isfinite(sm).all()
    print(f"[dryrun] split smoothness stage ok: 2 epochs x {n} orders over "
          f"{n} devices, artifacts written")


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", type=int, required=True)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    dryrun_multichip(args.devices, args.device)


if __name__ == "__main__":
    main()
