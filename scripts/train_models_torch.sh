#!/bin/bash
# Train all 14 model x dataset configs through the PyTorch port
# (interpret_quality_tpu_torch; reference scripts/train_models.sh).
# Usage: scripts/train_models_torch.sh [extra flags...]   (e.g. --device cpu)
set -e
cd "$(dirname "$0")/.."
for dataset in modelnet10 shapenet; do
  for model in pointnet pointnet2 pointconv dgcnn gcnn; do
    python -m interpret_quality_tpu_torch.cli.train --model=$model --dataset=$dataset "$@"
  done
  # adv-GCNN: rot-augmented GCNN first, then BIM adversarial fine-tuning
  # from its epoch-100 checkpoint
  python -m interpret_quality_tpu_torch.cli.train --model=gcnn --dataset=$dataset --train_rot_all_perturbation "$@"
  python -m interpret_quality_tpu_torch.cli.train_adv --dataset=$dataset --train_rot_all_perturbation \
    --resume_path=checkpoints/exp_MODEL_gcnn_DATA_${dataset}_POINTNUM_1024_clean_with_all_rot_da/models/model_99.t7 "$@"
done
