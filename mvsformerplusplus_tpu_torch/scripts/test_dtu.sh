#!/bin/bash
# DTU evaluation on the port (scripts/test_dtu.sh's flags): 5 views,
# 1152x1536, 192 depths, interval_scale 1.06, gipuma fusion (disp 0.1,
# num_consistent 2, prob 0.5).
set -e
TESTPATH=${1:-./MVS_data/dtu_test}
CKPT=${2:-saved/checkpoints}
OUT=${3:-outputs/dtu}
python -m mvsformerplusplus_tpu_torch.eval --config configs/mvsformerplusplus.json \
  --dataset dtu --testpath "$TESTPATH" --testlist lists/dtu/test.txt --ckpt "$CKPT" \
  --outdir "$OUT" --num_view 5 --max_h 1152 --max_w 1536 --numdepth 192 \
  --interval_scale 1.06 --filter_method gipuma --conf 0.5 \
  --disp_threshold 0.1 --num_consistent 2
