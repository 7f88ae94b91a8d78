#!/bin/bash
# Per-frame static training over a video (reference _SCRIPTS/run_swin.sh).
DATA=${DATA:-data/scene}
OUT=${OUT:-output/per_frame}
FRAMES=${FRAMES:-10}
for ((F=0; F<FRAMES; F++)); do
  python -m gsplat_tpu_torch.train.train_static \
    -s "$DATA" -m "$OUT/frame_$F" --frame $F --cap_max 100000
done
