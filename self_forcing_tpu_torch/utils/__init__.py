"""Utilities of the port: parameter trees, losses, checkpoint files,
video files, the trainers' draws, metrics logging and seeding, and the
phase timer and profiler trace (``profiling``)."""
