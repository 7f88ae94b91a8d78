#!/bin/bash
# MCMC hyperparameter grid (reference _SCRIPTS/run_hyperTuning.sh:
# DyNeRF cook_spinach, cap 100k-400k, reg/noise sweeps, window 1, 8k iters).
DATA=${DATA:-data/cook_spinach}
OUT=${OUT:-output/hyper}
for CAP in 100000 200000 400000; do
  for REG in 0.01 0.001; do
    for NOISE in 50000 500000; do
      python -m gsplat_tpu_torch.train.train_swin \
        -s "$DATA" -m "$OUT/cap${CAP}_reg${REG}_noise${NOISE}" \
        --cap_max $CAP --swin_size 1 --iterations 8000 \
        --scale_reg $REG --opacity_reg $REG --noise_lr $NOISE
    done
  done
done
