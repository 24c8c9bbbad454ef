#!/bin/bash
# DTU training on the port (scripts/train_dtu.sh's flags): the config's
# global batch, epochs and bf16 on one card.
set -e
python -m mvsformerplusplus_tpu_torch.train -c configs/mvsformerplusplus.json \
  --data_path "${1:-./MVS_data/DTU/mvs_training}"
