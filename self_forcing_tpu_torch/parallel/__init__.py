"""Parallel inference over ``torch.distributed`` (port of
``self_forcing_tpu/parallel/``): tensor parallelism of the DiT and its
few-step sampler (``tensor.py``), sequence-parallel ring attention for
the bidirectional forward (``sequence.py``), the collectives both use
(``comm.py``), the per-rank memory estimate (``fit.py``) and the process
launch (``launch.py``).  The modules are imported by name; this package
imports none of them."""
