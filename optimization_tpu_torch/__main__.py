"""``python -m optimization_tpu_torch`` — see :mod:`optimization_tpu_torch.cli`."""

import sys

from .cli import main

sys.exit(main())
