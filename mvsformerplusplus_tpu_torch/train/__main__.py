"""python -m mvsformerplusplus_tpu_torch.train: the training command line
(train/cli.py)."""
import sys

from .cli import main

if __name__ == "__main__":
    main(sys.argv[1:])
