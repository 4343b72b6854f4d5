"""The published-peak table: H100 kinds resolve, anything else raises."""

import types

import pytest

from perception.utils.roofline import device_peaks


@pytest.mark.parametrize("kind,bf16,hbm", [
    ("NVIDIA H100 80GB HBM3", 989.0, 3350.0),
    ("NVIDIA H100 PCIe", 756.0, 2000.0),
])
def test_h100_kinds_resolve_to_their_rows(kind, bf16, hbm):
    peaks = device_peaks(types.SimpleNamespace(device_kind=kind))
    assert (peaks.bf16_tflops, peaks.hbm_gbps) == (bf16, hbm)
    assert peaks.f32_tflops < peaks.tf32_tflops < peaks.bf16_tflops
    assert "data sheet" in peaks.source


def test_unknown_kind_raises():
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(types.SimpleNamespace(device_kind="cpu"))
