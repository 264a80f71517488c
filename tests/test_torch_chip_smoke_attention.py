"""``chip_smoke.py``'s phase 6 (flash attention and flash decode against
their plain versions) rehearsed on the CPU at small shapes.  Kept apart
from ``tests/test_torch_chip_smoke.py``, whose other rehearsals it would
lengthen on one test worker."""

import pytest
import torch

import chip_smoke


@pytest.fixture
def small_attention(monkeypatch):
    monkeypatch.setattr(chip_smoke, "FLASH_PATH_CASES", [
        ((2, 4, 2, 64, 16), torch.bfloat16), ((1, 4, 2, 40, 16),
                                              torch.float32)])
    monkeypatch.setattr(chip_smoke, "DECODE_PATH_CASES", [
        ((4, 2, 2, 48, 16), torch.bfloat16), ((4, 2, 2, 33, 16),
                                              torch.float32)])
    monkeypatch.setattr(chip_smoke, "DECODE_LIVE", {(4, 2, 2, 48, 16): 20})
    monkeypatch.setattr(chip_smoke, "FLASH_MASK_PATH_CASES", [
        ((2, 10, 2, 70, 70, 16), torch.bfloat16, True, 24),
        ((1, 6, 6, 30, 50, 16), torch.float32, False, 0)])


def test_attention_checks_rehearse_on_cpu(small_attention):
    """Phase 6 on the CPU: the plain version against itself, through the
    same dispatch and the same layouts."""
    assert chip_smoke.check_attention(torch.device("cpu")) == {
        "flash_attention": 0.0, "flash_decode": 0.0}
