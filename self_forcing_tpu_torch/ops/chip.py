"""Card-aware kernel variant defaults (port of
``self_forcing_tpu/ops/chip.py``).

One registry keyed by the CUDA device name
(``torch.cuda.get_device_name()``, prefix-matched, first hit wins) picks
the decode softmax, the demo configuration's attention quantization and
its linears' quantization, as the JAX package's registry does by TPU
device kind.  ``chip_defaults()`` only picks defaults: the config fields
(``WanConfig.attn_quant`` / ``attn_softmax``) stay explicit, and
``set_chip_override`` forces a device name for tests and A/B runs.
"""
from __future__ import annotations

from typing import Optional

import torch

_OVERRIDE: Optional[str] = None

# device name prefix -> kernel defaults
REGISTRY: dict[str, dict] = {
    # Measured on the H100 (PERF.md section 5, chip_smoke.py, NVIDIA H100
    # 80GB HBM3, 700 W): the int8-QK attention on int8 wgmma
    # (decode_fresh.cu's INT8QK mode) takes 1.503 ms at the demo's global
    # window, the bf16 decode kernel 1.494: int8 halves QK^T's tensor
    # time, but the per-score dequantisation lengthens the softmax that
    # bounds both.  With its pre-pass a demo forward is busy 78.0 ms
    # against 76.4 with the bf16 attention, and 89.5 with the full-int8
    # attention ('int8': its softmax bounds it).  int8qk stays the demo
    # pick, as bench.py runs the demo; 'int8' is opt-in; fp8 linears are
    # not ported.
    "NVIDIA H100": {
        "attn_softmax": "free",
        "demo_attn_quant": "int8qk",
        "matmul_quant": "w8a8",
    },
}

_FALLBACK = {
    "attn_softmax": "free",
    "demo_attn_quant": "int8qk",
    "matmul_quant": "w8a8",
}


def set_chip_override(kind: Optional[str]) -> None:
    """Force a device name for selection (tests / A-B benchmarks)."""
    global _OVERRIDE
    _OVERRIDE = kind


def device_kind() -> str:
    """The overriding name, else CUDA device 0's name, else 'cpu'."""
    if _OVERRIDE is not None:
        return _OVERRIDE
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def chip_defaults(kind: Optional[str] = None) -> dict:
    """Kernel-variant defaults for the (detected) card."""
    kind = device_kind() if kind is None else kind
    for prefix, entry in REGISTRY.items():
        if kind.startswith(prefix):
            return dict(entry)
    return dict(_FALLBACK)
