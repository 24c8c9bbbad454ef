"""python -m mvsformerplusplus_tpu_torch.eval: the evaluation command line
(eval/cli.py)."""
import sys

from .cli import main

if __name__ == "__main__":
    main(sys.argv[1:])
