"""Data-prep scripts of the PyTorch package, run with ``python -m``."""
