"""`python -m repro_torch` — the port's CLI (see repro_torch/cli.py)."""
from repro_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
