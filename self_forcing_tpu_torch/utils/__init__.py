"""Training utilities of the port."""
