"""``python -m repro_torch.collect`` entry point (see
:mod:`repro_torch.collect.cli`)."""
import sys

from repro_torch.collect.cli import main

if __name__ == "__main__":
    sys.exit(main())
