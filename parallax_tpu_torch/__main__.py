"""``python -m parallax_tpu_torch``: the command line interface (``cli.py``)."""

import sys

from parallax_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
