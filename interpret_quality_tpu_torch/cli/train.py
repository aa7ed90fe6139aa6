"""CLI: train a classifier (replaces reference main_cls_seed.py; the
counterpart of ``interpret_quality_tpu/cli/train.py``).  Writes run.log,
``models/model_{epoch}.t7`` every 10 epochs and ``models/model_best.t7``
under ``<checkpoints_root>/exp_MODEL_<m>_DATA_<d>_POINTNUM_<n>_clean<suffix>``,
where the shapley and enumeration stages read it by default."""
from ..config import MODEL_NAMES
from .common import base_parser, config_from_args


def main(argv=None):
    p = base_parser("Train a point-cloud classifier")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--test_batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=None,
                   help="default: the family's (EPOCHS_BY_MODEL)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--drop_point", action="store_true")
    p.add_argument("--train_rot_y_perturbation", action="store_true")
    p.add_argument("--train_rot_all_perturbation", action="store_true")
    p.add_argument("--train_samples", type=int, default=512,
                   help="synthetic-set size (only with --synthetic)")
    p.add_argument("--test_samples", type=int, default=128,
                   help="synthetic eval-set size (only with --synthetic)")
    p.add_argument("--best_acc_gate", type=float, default=0.80,
                   help="min test acc before model_best is written "
                        "(reference main_cls_seed.py:108); 0 = always save")
    args = p.parse_args(argv)
    if args.model not in MODEL_NAMES:
        p.error(f"training {args.model} is not ported: cli.train takes "
                f"{', '.join(MODEL_NAMES)}")
    cfg = config_from_args(args)

    from .. import config as _config
    from ..data import datasets as _datasets
    from ..data.datasets import ModelNetTrain, ShapeNetTrain, SyntheticClouds
    from ..models import build_model
    from ..models import registry as _registry
    from ..models.common import resolve_device
    from ..train import trainer as _trainer
    from ..utils.io import IOStream, mkdir, snapshot_sources
    from ..utils.rng import set_random

    device = resolve_device(cfg.device)
    set_random(cfg.seed)
    aug = dict(drop_point=args.drop_point,
               rot_y=args.train_rot_y_perturbation,
               rot_all=args.train_rot_all_perturbation)
    if args.synthetic:
        train_ds = SyntheticClouds(num_samples=args.train_samples,
                                   num_points=cfg.num_points, seed=cfg.seed,
                                   train=True, **aug)
        test_ds = SyntheticClouds(num_samples=args.test_samples,
                                  num_points=cfg.num_points, seed=cfg.seed + 1)
    elif cfg.dataset == "modelnet10":
        kw = dict(data_root=cfg.data_root, num_points=cfg.num_points, **aug)
        train_ds = ModelNetTrain(partition="train", **kw)
        test_ds = ModelNetTrain(partition="test", **kw)
    else:
        kw = dict(data_root=cfg.data_root, num_points=cfg.num_points, **aug)
        train_ds = ShapeNetTrain(split="train", **kw)
        test_ds = ShapeNetTrain(split="test", **kw)

    suffix = ""
    if args.train_rot_y_perturbation:
        suffix = "_with_y_rot_da"
    elif args.train_rot_all_perturbation:
        suffix = "_with_all_rot_da"
    exp_dir = f"{cfg.checkpoints_root}/{cfg.train_exp_name}{suffix}"
    mkdir(exp_dir)
    snapshot_sources(exp_dir, [_trainer, _registry, _datasets, _config])
    with IOStream(exp_dir + "/run.log") as io:
        io.cprint(str(args))
        # torch's default init from the seed, as the reference's
        model = build_model(cfg.model, cfg.num_classes, cfg.k).to(device)
        _trainer.fit(model, cfg.model, train_ds, test_ds,
                     batch_size=args.batch_size,
                     test_batch_size=args.test_batch_size, epochs=args.epochs,
                     exp_dir=exp_dir, io=io, seed=cfg.seed,
                     best_acc_gate=args.best_acc_gate, base_lr=args.lr)


if __name__ == "__main__":
    main()
