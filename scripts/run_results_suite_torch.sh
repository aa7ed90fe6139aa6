#!/bin/bash
# Full results suite from a persisted checkpoint through the PyTorch port
# (interpret_quality_tpu_torch; reference scripts/exp_shapley.sh +
# exp_interaction.sh + plot_inter.sh in one pass).
#
# Usage: scripts/run_results_suite_torch.sh [model] [extra flags...]
#   e.g. scripts/run_results_suite_torch.sh dgcnn --synthetic --allow_random_init
# Stages: save_fps -> shapley_value -> enum{trans,rotate,scale} ->
#         smoothness -> gen_pair -> interaction_logits -> cal_interactions ->
#         result{sensitivity,correlation,smoothness} -> plot_interaction.
set -e
cd "$(dirname "$0")/.."
MODEL=${1:-pointnet}
shift || true
FLAGS=("$@")

run() { echo "==== $* ===="; python -u -m "interpret_quality_tpu_torch.cli.$@"; }

run save_fps --model "$MODEL" "${FLAGS[@]}"
run shapley_value --model "$MODEL" "${FLAGS[@]}" --resume
for MODE in trans rotate scale; do
  run enum --model "$MODEL" --mode "$MODE" "${FLAGS[@]}" --resume
done
run smoothness_enum --model "$MODEL" "${FLAGS[@]}"
run gen_pair --model "$MODEL" "${FLAGS[@]}"
run interaction_logits --model "$MODEL" "${FLAGS[@]}" --resume
run cal_interactions --model "$MODEL" "${FLAGS[@]}"
for RMODE in sensitivity correlation smoothness; do
  run result --model "$MODEL" --result_mode "$RMODE" "${FLAGS[@]}"
done
run plot_interaction --model "$MODEL" --plot_mode normal_vs_adv "${FLAGS[@]}"
echo "==== suite complete ===="
