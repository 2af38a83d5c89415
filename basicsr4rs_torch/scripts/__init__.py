"""Command-line scripts of the port (counterparts of the repository's
``scripts/``), run as ``python -m basicsr4rs_torch.scripts.<group>.<name>``."""
