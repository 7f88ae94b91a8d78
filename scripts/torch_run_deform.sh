#!/bin/bash
# Rigid-motion LR grid (reference _SCRIPTS/run_deform.sh).
DATA=${DATA:-data/scene}
OUT=${OUT:-output/deform}
for VLR in 1e-5 1e-4 1e-3; do
  for RLR in 1e-5 1e-4 1e-3; do
    python -m gsplat_tpu_torch.train.train_swin \
      -s "$DATA" -m "$OUT/v${VLR}_r${RLR}" --deform \
      --rigid_v_lr $VLR --rigid_rotvec_lr $RLR --rigid_rotcen_lr $RLR \
      --cap_max 100000 --swin_size 10
  done
done
