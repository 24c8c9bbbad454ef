#!/bin/bash
# BlendedMVS fine-tune on the port (scripts/finetune_blended.sh's flags):
# resumes the run in the config's save directory.
set -e
python -m mvsformerplusplus_tpu_torch.train -c configs/mvsformerplusplus_ft.json \
  --data_path "${1:-./MVS_data/BlendedMVS}" --resume
