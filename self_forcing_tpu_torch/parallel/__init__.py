"""Parallelism over ``torch.distributed`` (port of
``self_forcing_tpu/parallel/``): tensor parallelism of the DiT, its
few-step sampler and its training forward (``tensor.py``),
sequence-parallel ring attention for the bidirectional forward and the
ZeRO-3-over-sp teacher (``sequence.py``), the ``("dp", "fsdp", "sp")``
mesh and the layouts of parameters, batches and the rollout's KV cache
(``mesh.py``), ZeRO-3 of the trainers (``fsdp.py``), the collectives
they use (``comm.py``), the per-rank memory estimates (``fit.py``) and
the process launch (``launch.py``).  The modules are imported by name;
this package imports none of them."""
