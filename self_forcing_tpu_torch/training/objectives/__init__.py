"""Distillation objectives (port of ``self_forcing_tpu/training/objectives``)."""
