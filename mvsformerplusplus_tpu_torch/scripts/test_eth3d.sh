#!/bin/bash
# ETH3D high-res evaluation on the port (scripts/test_eth3d.sh's flags):
# the cams carry each view's depth range, rescaled to --numdepth; scenes
# are claimed one at a time (--schedule queue), so start this script once
# per worker.
set -e
CKPT=${1:?usage: test_eth3d.sh <ckpt_npz> <datapath> [outdir]}
DATA=${2:?usage: test_eth3d.sh <ckpt_npz> <datapath> [outdir]}
OUT=${3:-outputs/eth3d}
python -m mvsformerplusplus_tpu_torch.eval --config configs/mvsformerplusplus.json \
  --dataset eth3d --testpath "$DATA" --testlist lists/eth3d/test.txt --outdir "$OUT" \
  --ckpt_npz "$CKPT" --num_view 7 --numdepth 192 --interval_scale 1.0 \
  --max_h 1088 --max_w 1600 --schedule queue \
  --filter_method dpcd --conf 0.5 --fusion_view 10
