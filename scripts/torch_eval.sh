#!/bin/bash
# Render + metrics over a directory of trained models (reference eval.sh).
MODELS_DIR=${1:-output}
for M in "$MODELS_DIR"/*/; do
  python -m gsplat_tpu_torch.eval.render -m "$M" --skip_train
  python -m gsplat_tpu_torch.eval.metrics -m "$M"
done
