"""Utilities of the port: parameter trees, losses, checkpoint files,
video files."""
