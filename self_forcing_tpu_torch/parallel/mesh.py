"""The ``("dp", "fsdp", "sp")`` device mesh (port of ``create_mesh`` in
``self_forcing_tpu/parallel/mesh.py``): one process a device, the
world's ranks laid out dp-major, sp innermost, so that an sp group is a
run of consecutive ranks."""
from __future__ import annotations

import torch
import torch.distributed as dist


def create_mesh(fsdp: int | None = None, dp: int = 1, sp: int = 1,
                device_type: str = "cuda"):
    """The ``("dp", "fsdp", "sp")`` ``DeviceMesh`` over the initialised
    world (``fsdp`` defaults to what dp and sp leave).  Every rank calls
    it."""
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size()
    if fsdp is None:
        fsdp = n // (dp * sp)
    if dp * fsdp * sp != n:
        raise ValueError(f"dp {dp} x fsdp {fsdp} x sp {sp} != world {n}")
    return DeviceMesh(device_type, torch.arange(n).reshape(dp, fsdp, sp),
                      mesh_dim_names=("dp", "fsdp", "sp"))
