"""The score-distillation trainer and its optimizer (port of ``self_forcing_tpu/training``)."""
