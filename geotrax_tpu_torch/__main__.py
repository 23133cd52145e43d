"""``python -m geotrax_tpu_torch <command> ...``: see ``cli.py``."""

import sys

from geotrax_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
