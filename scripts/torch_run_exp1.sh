#!/bin/bash
# SwinGS experiment grid (cap_max x swin_size) — the gsplat_tpu_torch equivalent of
# the reference run_exp1.sh (actorshq_02: cap 40k-200k, window 4-20,
# frames 160-220, sh_degree 1, 20k+30k iters).
DATA=${DATA:-data/actorshq_02}
OUT=${OUT:-output/exp1}
for CAP in 40000 100000 200000; do
  for SWIN in 4 10 20; do
    python -m gsplat_tpu_torch.train.train_swin \
      -s "$DATA" -m "$OUT/cap${CAP}_swin${SWIN}" \
      --cap_max $CAP --swin_size $SWIN --sh_degree 1 \
      --min_frame 160 --max_frame 220 --deform \
      --iterations 20000 --genesis_iterations 30000
  done
done
