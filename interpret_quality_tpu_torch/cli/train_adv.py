"""CLI: adversarial (BIM) training of adv-GCNN, resumed from a GCNN
checkpoint (replaces reference main_cls_adv.py; the counterpart of
``interpret_quality_tpu/cli/train_adv.py``).  Writes run.log,
``models/model_{epoch}.t7`` every 10 epochs and ``models/model_best.t7``
under ``<checkpoints_root>/exp_MODEL_gcnn_adv_DATA_<d>_POINTNUM_<n>_clean_with_all_rot_da``,
where the attribution stages read adv-GCNN by default."""
from .common import base_parser, config_from_args


def main(argv=None):
    p = base_parser("Adversarial training (adv-GCNN)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--test_batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--resume_path", type=str, default=None,
                   help="checkpoint to resume from: a .t7 that cli.train "
                        "wrote or a flax .msgpack of the JAX package (the "
                        "reference resumes GCNN at epoch 100, "
                        "main_cls_adv.py:66,328-329)")
    p.add_argument("--train_rot_all_perturbation", action="store_true")
    p.add_argument("--best_acc_gate", type=float, default=0.80,
                   help="min test acc before model_best is written; "
                        "0 = always save")
    args = p.parse_args(argv)
    args.model = "gcnn"
    cfg = config_from_args(args)

    from .. import config as _config
    from ..data.datasets import ModelNetTrain, ShapeNetTrain, SyntheticClouds
    from ..models import build_model
    from ..models import registry as _registry
    from ..models.checkpoint import load_checkpoint
    from ..models.common import resolve_device
    from ..train import adversarial as _adversarial
    from ..utils.io import IOStream, mkdir, snapshot_sources
    from ..utils.rng import set_random

    device = resolve_device(cfg.device)
    if not (args.resume_path or args.allow_random_init):
        raise SystemExit("pass --resume_path (or --allow_random_init)")
    set_random(cfg.seed)
    if args.synthetic:
        train_ds = SyntheticClouds(num_samples=64, num_points=cfg.num_points,
                                   seed=cfg.seed, train=True,
                                   rot_all=args.train_rot_all_perturbation)
        test_ds = SyntheticClouds(num_samples=16, num_points=cfg.num_points,
                                  seed=cfg.seed + 1)
    elif cfg.dataset == "modelnet10":
        kw = dict(data_root=cfg.data_root, num_points=cfg.num_points,
                  rot_all=args.train_rot_all_perturbation)
        train_ds = ModelNetTrain(partition="train", **kw)
        test_ds = ModelNetTrain(partition="test", **kw)
    else:
        kw = dict(data_root=cfg.data_root, num_points=cfg.num_points,
                  rot_all=args.train_rot_all_perturbation)
        train_ds = ShapeNetTrain(split="train", **kw)
        test_ds = ShapeNetTrain(split="test", **kw)

    exp_name = ("exp_MODEL_gcnn_adv_DATA_%s_POINTNUM_%d_clean_with_all_rot_da"
                % (cfg.dataset, cfg.num_points))
    exp_dir = f"{cfg.checkpoints_root}/{exp_name}"
    mkdir(exp_dir)
    # source provenance (reference main_cls_adv.py:28-31 .backup copies)
    snapshot_sources(exp_dir, [_adversarial, _registry, _config])
    with IOStream(exp_dir + "/run.log") as io:
        io.cprint(str(args))
        # torch's default init from the seed, as the reference's
        model = build_model("gcnn", cfg.num_classes, cfg.k)
        if args.resume_path:
            model.load_state_dict(load_checkpoint("gcnn", args.resume_path),
                                  strict=True)
            io.cprint("resumed from %s" % args.resume_path)
        _adversarial.fit_adversarial(
            model.to(device), "gcnn_adv", train_ds, test_ds,
            batch_size=args.batch_size, test_batch_size=args.test_batch_size,
            epochs=args.epochs, exp_dir=exp_dir, io=io, seed=cfg.seed,
            best_acc_gate=args.best_acc_gate, base_lr=args.lr)


if __name__ == "__main__":
    main()
