#!/bin/bash
# Tanks&Temples advanced on the port (scripts/test_tt_adv.sh's flags), one
# scene per run.
set -e
TESTPATH=${1:-./MVS_data/tanksandtemples/advanced}
CKPT=${2:-saved/checkpoints}
OUT=${3:-outputs/tt_adv}
LIST=$(mktemp)
trap 'rm -f "$LIST"' EXIT
for scene in Auditorium Ballroom Courtroom Museum Palace Temple; do
  echo "$scene" > "$LIST"
  python -m mvsformerplusplus_tpu_torch.eval --config configs/mvsformerplusplus.json \
    --dataset tt --testpath "$TESTPATH" --testlist "$LIST" --ckpt "$CKPT" \
    --outdir "$OUT" --num_view 20 --max_h 1088 --max_w 1920 --numdepth 192 \
    --interval_scale 1.0 --filter_method dpcd --conf 0.3 --fusion_view 10 \
    --conf_choose stage4
done
