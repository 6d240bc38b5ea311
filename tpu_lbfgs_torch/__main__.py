"""``python -m tpu_lbfgs_torch ...`` runs the command line (``cli.main``)."""
from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
