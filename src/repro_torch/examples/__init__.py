"""The JAX package's four example scripts as modules of the port, each
run as ``python -m repro_torch.examples.<name>`` with the script's flags
plus ``--device cuda|cpu`` (the card by default)."""
