"""PyTorch/CUDA port of self_forcing_tpu for NVIDIA Hopper (H100).

Module paths mirror the JAX package.  The port imports ``torch`` and never
``jax`` or ``self_forcing_tpu``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on the CPU every kernel wrapper runs its
plain PyTorch version.
"""
