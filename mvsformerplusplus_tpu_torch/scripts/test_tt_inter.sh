#!/bin/bash
# Tanks&Temples intermediate on the port (scripts/test_tt_inter.sh's flags):
# 20 views, 1088x1920, the per-scene filter settings below.
set -e
TESTPATH=${1:-./MVS_data/tanksandtemples/intermediate}
CKPT=${2:-saved/checkpoints}
OUT=${3:-outputs/tt_inter}
LIST=$(mktemp)
trap 'rm -f "$LIST"' EXIT
run_scene () {  # scene filter conf fusion_view extra...
  scene=$1; shift
  echo "$scene" > "$LIST"
  python -m mvsformerplusplus_tpu_torch.eval --config configs/mvsformerplusplus.json \
    --dataset tt --testpath "$TESTPATH" --testlist "$LIST" --ckpt "$CKPT" \
    --outdir "$OUT" --num_view 20 --max_h 1088 --max_w 1920 --numdepth 192 \
    --interval_scale 1.0 --conf_choose stage4 "$@"
}
run_scene Family     --filter_method dpcd --conf 0.3 --fusion_view 10
run_scene Francis    --filter_method dpcd --conf 0.6 --fusion_view 15
run_scene Horse      --filter_method dpcd --conf 0.3 --fusion_view 10
run_scene Lighthouse --filter_method dpcd --conf 0.6 --fusion_view 15
run_scene M60        --filter_method dpcd --conf 0.3 --fusion_view 15
run_scene Panther    --filter_method dpcd --conf 0.3 --fusion_view 15
run_scene Playground --filter_method dpcd --conf 0.3 --fusion_view 15
run_scene Train      --filter_method dpcd --conf 0.3 --fusion_view 15
