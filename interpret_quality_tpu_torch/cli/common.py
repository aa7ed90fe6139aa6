"""Shared CLI argument surface: the reference flags (e.g.
final_shapley_value.py:178-188) plus ``--synthetic``, ``--allow_random_init``,
``--samples``, ``--resume``, ``--mesh_devices``, ``--trace_dir``,
``--device`` and the JAX package's ``--matmul_precision`` and
``--gather_precision`` with its choices.  The port's defaults for those two
are the exact settings, ``highest`` and ``hilo`` (f32 products and gathers),
where the JAX package's are ``default`` and ``bf16``; they govern the card
only, as XLA:CPU computes f32 at every setting."""
from __future__ import annotations

import argparse

from ..config import (DEVICES, GATHER_PRECISIONS, MATMUL_PRECISIONS,
                      PORT_MODEL_NAMES, ExperimentConfig,
                      set_gather_value_parts, set_matmul_precision)


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--model", type=str, default="pointnet",
                   choices=PORT_MODEL_NAMES)
    p.add_argument("--dataset", type=str, default="modelnet10",
                   choices=["modelnet10", "shapenet"])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--softmax_type", type=str, default="modified",
                   choices=["normal", "modified"])
    p.add_argument("--model_path", type=str, default=None,
                   help="reference-layout .t7/.pth/.pt state dict, or a "
                        "flax .msgpack of the JAX package (needs msgpack)")
    p.add_argument("--data_root", type=str, default="./data")
    p.add_argument("--checkpoints_root", type=str, default="./checkpoints")
    p.add_argument("--shapley_batch_size", type=int, default=None)
    p.add_argument("--interaction_batch_size", type=int, default=None,
                   help="(pair, context) cells per interaction forward "
                        "(4 clouds each)")
    p.add_argument("--num_points", type=int, default=None,
                   help="points per cloud (default: config NUM_POINTS=1024)")
    p.add_argument("--num_regions", type=int, default=None,
                   help="FPS regions per cloud (default: config NUM_REGIONS=32)")
    p.add_argument("--num_samples_save", type=int, default=None,
                   help="permutations saved by shapley init (default 1000)")
    p.add_argument("--num_samples", type=int, default=None,
                   help="permutations used per pose (default 100)")
    p.add_argument("--synthetic", action="store_true",
                   help="run on the deterministic synthetic eval set")
    p.add_argument("--allow_random_init", action="store_true",
                   help="fall back to random-init weights when no checkpoint")
    p.add_argument("--samples", type=str, default=None,
                   help="comma-separated eval-sample indices to process")
    p.add_argument("--resume", action="store_true",
                   help="skip samples whose stage artifacts already exist")
    p.add_argument("--mesh_devices", type=int, default=0,
                   help="split the coalition batches over this many devices "
                        "(0 = one device; with --device cpu a virtual split "
                        "on the CPU)")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="write a torch.profiler (Chrome) trace of each "
                        "stage call's device work to this directory")
    p.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                   help="where the model runs; 'cuda' raises when no card is "
                        "present")
    p.add_argument("--matmul_precision", type=str, default="highest",
                   choices=MATMUL_PRECISIONS,
                   help="products of the models on the card: 'highest' f32 "
                        "(the reference's numerics), 'high' one TF32 "
                        "product, 'default' one product of bf16-rounded "
                        "operands with f32 accumulation (the JAX package's "
                        "default); the CPU computes f32 at every setting")
    p.add_argument("--gather_precision", type=str, default="hilo",
                   choices=GATHER_PRECISIONS,
                   help="values of the neighbour kernels' gathers on the "
                        "card: 'hilo' exact f32, 'bf16' each value rounded "
                        "to bf16 (the JAX package's default); the CPU "
                        "gathers exactly at every setting")
    return p


def config_from_args(args) -> ExperimentConfig:
    # set unconditionally: both are process-global and must not leak from
    # an earlier call in the same process
    set_matmul_precision(getattr(args, "matmul_precision", "highest"))
    set_gather_value_parts(
        1 if getattr(args, "gather_precision", "hilo") == "bf16" else 2)
    extra = {k: v for k, v in (
        ("num_points", args.num_points),
        ("num_regions", args.num_regions),
        ("num_samples_save", args.num_samples_save),
        ("num_samples", args.num_samples),
    ) if v is not None}
    return ExperimentConfig(
        model=args.model, dataset=args.dataset, seed=args.seed,
        softmax_type=args.softmax_type, model_path=args.model_path,
        data_root=args.data_root, checkpoints_root=args.checkpoints_root,
        shapley_batch_size=args.shapley_batch_size,
        interaction_batch_size=args.interaction_batch_size,
        device=args.device, **extra)


def sample_indices_from_args(args):
    if args.samples is None:
        return None
    return [int(s) for s in args.samples.split(",") if s != ""]


def split_from_args(args):
    """The devices of the coalition split (``parallel.make_mesh``), or None
    for one device.  With ``--device cpu`` the split is virtual: the CPU
    named ``--mesh_devices`` times."""
    if not args.mesh_devices:
        return None
    from ..parallel import make_mesh
    if args.device == "cpu":
        return make_mesh(devices=["cpu"] * args.mesh_devices)
    return make_mesh(args.mesh_devices)
