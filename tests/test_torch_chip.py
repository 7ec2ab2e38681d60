"""The port's card-aware defaults (``self_forcing_tpu_torch/ops/chip.py``)
against the JAX registry: the H100 entry, the fallback the JAX package
uses for a device it does not know, and the override."""
import pytest

from self_forcing_tpu.ops import chip as jchip
from self_forcing_tpu_torch.ops import chip as tchip

H100 = {"attn_softmax": "free", "demo_attn_quant": "int8qk",
        "matmul_quant": "w8a8"}


@pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3",
                                  "NVIDIA H100 PCIe"])
def test_h100_entry(name):
    assert tchip.chip_defaults(name) == H100


@pytest.mark.parametrize("name", ["cpu", "NVIDIA A100-SXM4-80GB"])
def test_unknown_card_takes_the_jax_fallback(name):
    assert tchip.chip_defaults(name) == jchip.chip_defaults(name)
    assert tchip.chip_defaults(name) == jchip._FALLBACK


def test_override_and_explicit_name():
    try:
        tchip.set_chip_override("NVIDIA H100 80GB HBM3")
        assert tchip.device_kind() == "NVIDIA H100 80GB HBM3"
        assert tchip.chip_defaults() == H100
        # an explicit name wins over the override
        assert tchip.chip_defaults("cpu") == jchip._FALLBACK
        # the returned dict is a copy: editing it leaves the registry be
        tchip.chip_defaults()["demo_attn_quant"] = "int8"
        assert tchip.chip_defaults() == H100
    finally:
        tchip.set_chip_override(None)
