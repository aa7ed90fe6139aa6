"""Export a flax ``.msgpack`` checkpoint of the JAX package as a
reference-loadable torch ``.t7`` state dict, on the PyTorch port
(counterpart of ``scripts/export_t7.py``).

The port's modules carry the reference's parameter names and shapes, so the
layout is the port module's own ``state_dict()``: the checkpoint is read by
``models.checkpoint.load_checkpoint`` (no flax), loaded into the module with
``strict=True`` and saved as it is.  No template and no reference tree are
needed.  ``--template`` (a torch checkpoint) stays as a layout check: its
keys (``module.`` prefixes stripped) and shapes must be the export's, and a
template with ``module.`` prefixes gets them in the output too.  Host only.

Usage:
    python scripts/export_t7_torch.py --model gcnn \\
        --ckpt checkpoints/exp_.../models/model_best.msgpack \\
        --out gcnn_export.t7 [--template ref.t7]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from interpret_quality_tpu_torch.models import build_model  # noqa: E402
from interpret_quality_tpu_torch.models.checkpoint import \
    load_checkpoint  # noqa: E402
from interpret_quality_tpu_torch.models.convert import \
    load_reference_state_dict  # noqa: E402


def export_state(model_name: str, ckpt: str, num_classes: int = 10) -> dict:
    """The port module's state dict holding the checkpoint's values."""
    base = "gcnn" if model_name == "gcnn_adv" else model_name
    model = build_model(base, num_classes=num_classes)
    model.load_state_dict(load_checkpoint(base, ckpt), strict=True)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def check_layout(state: dict, template_path: str) -> bool:
    """Raise unless the template's keys and shapes are the export's;
    True where the template's keys carry ``module.`` prefixes."""
    raw = torch.load(template_path, map_location="cpu")
    template = load_reference_state_dict(template_path)
    if set(template) != set(state):
        raise SystemExit(
            f"template layout differs: only in the template "
            f"{sorted(set(template) - set(state))}, only in the export "
            f"{sorted(set(state) - set(template))}")
    bad = [k for k in state if tuple(template[k].shape) != tuple(state[k].shape)]
    if bad:
        raise SystemExit(f"template shapes differ for {bad}")
    return any(k.startswith("module.") for k in raw)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True)
    p.add_argument("--ckpt", required=True, help=".msgpack checkpoint")
    p.add_argument("--out", required=True, help="output .t7 path")
    p.add_argument("--template", default=None,
                   help="torch checkpoint whose layout the export must have")
    p.add_argument("--num_classes", type=int, default=10)
    args = p.parse_args(argv)

    state = export_state(args.model, args.ckpt, args.num_classes)
    if args.template and check_layout(state, args.template):
        state = {"module." + k: v for k, v in state.items()}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    torch.save(state, args.out)
    print(f"exported {args.ckpt} -> {args.out} "
          f"({len(state)} tensors, reference-loadable)")


if __name__ == "__main__":
    main()
