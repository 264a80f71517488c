"""``chip_smoke.py`` rehearsed on the CPU: it refuses to run without a card
or without the rest of the repo, its phases run end to end at a small size
on the kernels' plain versions, and its bound is the one ``PERF.md``
states."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]


def _run(cwd):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture
def small(monkeypatch):
    for name, value in dict(B=6, H=20, W=18, C=3, OH=12, OW=10).items():
        monkeypatch.setattr(chip_smoke, name, value)


def test_kernel_checks_rehearse_on_cpu(small):
    worst = chip_smoke.check_kernel(torch.device("cpu"))
    assert worst == {"f32_max_abs_err": 0.0, "bf16_max_ulps": 0,
                     "main_f32_max_abs_err": 0.0}


def test_main_path_rehearses_on_cpu():
    run = chip_smoke.drive_main_path(torch.device("cpu"), n_samples=96, b=8,
                                     h=16, w=16, c=3, oh=12, ow=12,
                                     n_batches=4)
    assert run["batches_formed"] == 4 + 2        # prefetch depth 2
    assert run["launches"] == 0                  # the CPU never launches
    assert run["arena_vs_materialize_max_abs_diff"] == 0.0
    assert run["arena_loader_MBps_virtual"] == \
        run["materialize_loader_MBps_virtual"] > 0
    assert run["arena_stats"]["acquires"] == 6


def test_bound_of_the_main_path():
    nbytes, ms, by = chip_smoke.bound("NVIDIA H100 80GB HBM3", 4)
    assert nbytes == 385_357_848 and by == "bytes"
    assert ms == pytest.approx(0.11503, abs=1e-5)
    nbytes, ms, by = chip_smoke.bound("NVIDIA H100 80GB HBM3", 2)
    assert nbytes == 231_217_176 and ms == pytest.approx(0.06902, abs=1e-5)
    assert chip_smoke.bound("NVIDIA A100-SXM4-80GB", 4)[1] is None


def test_bf16_ulps():
    a = torch.tensor([1.0, -1.0, 0.0, -0.0, 3.0]).bfloat16()
    b = torch.tensor([1.0078125, -0.99609375, -0.0, 0.0, 3.0]).bfloat16()
    assert chip_smoke.bf16_ulps(a, a) == 0
    assert chip_smoke.bf16_ulps(a, b) == 1


@pytest.fixture
def small_attention(monkeypatch):
    monkeypatch.setattr(chip_smoke, "FLASH_PATH_CASES", [
        ((2, 4, 2, 64, 16), torch.bfloat16), ((1, 4, 2, 40, 16),
                                              torch.float32)])
    monkeypatch.setattr(chip_smoke, "DECODE_PATH_CASES", [
        ((4, 2, 2, 48, 16), torch.bfloat16), ((4, 2, 2, 33, 16),
                                              torch.float32)])


def test_attention_checks_rehearse_on_cpu(small_attention):
    """Phase 6 on the CPU: the plain version against itself, through the
    same dispatch and the same layouts."""
    assert chip_smoke.check_attention(torch.device("cpu")) == {
        "flash_attention": 0.0, "flash_decode": 0.0}


def test_compare_raises_on_disagreement():
    a = torch.zeros(4)
    assert chip_smoke.compare("same", a, a, torch.float32) == 0.0
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare("off", a + 1e-4, a, torch.float32)
    with pytest.raises(AssertionError, match="bad output"):
        chip_smoke.compare("nan", a / 0, a, torch.float32)


def test_serving_path_rehearses_on_cpu():
    """Phases 7 and 8 on the CPU at the smoke config's size: prompts over
    the simulated WAN, prefill, two waves of continuous batching, no kernel
    launched, and the f32 check (CPU against CPU) at zero."""
    cpu = torch.device("cpu")
    cfg = chip_smoke.get_arch(chip_smoke.ARCH).smoke_config()
    run, prompts = chip_smoke.drive_serving(
        cpu, cfg, n_prompts=6, prompt_len=10, prefill_b=2, prefill_s=40,
        slots=4, max_seq=16, new_tokens=5, n_prefill=2)
    chip_smoke.check_serving_launches(run, cfg.n_layers, on_card=False)
    assert run["engine_steps"] == 2 * (10 + 5 - 1)
    assert run["tokens"] == 6 * 5 and len(prompts) == 6
    assert run["prompt_loader_MBps_virtual"] > 0
    assert chip_smoke.check_f32_path(
        cpu, cfg, prompts, prefill_len=24, n_steps=4, slots=4,
        max_seq=16) == {"prefill_max_abs_diff": 0.0,
                        "decode_max_abs_diff": 0.0}


def test_serving_launch_check():
    run = {"prefill_calls": 3, "engine_steps": 10,
           "after_prefill": {"crop_mirror_normalize": 0,
                             "flash_attention": 108, "flash_decode": 0},
           "launches": {"crop_mirror_normalize": 0, "flash_attention": 108,
                        "flash_decode": 360}}
    chip_smoke.check_serving_launches(run, 36, on_card=True)
    for bad in ({"flash_decode": 359}, {"crop_mirror_normalize": 1},
                {"flash_attention": 109}):
        with pytest.raises(AssertionError, match="launches"):
            chip_smoke.check_serving_launches(
                dict(run, launches=dict(run["launches"], **bad)), 36,
                on_card=True)


@pytest.mark.parametrize("S,T,window", [(5, 5, 0), (64, 64, 0), (40, 70, 0),
                                        (64, 64, 16), (100, 100, 7)])
def test_causal_pairs(S, T, window):
    i, j = np.meshgrid(np.arange(S), np.arange(T), indexing="ij")
    keep = (j <= i) & ((i - j < window) if window else True)
    assert chip_smoke.causal_pairs(S, T, window) == int(keep.sum())


def test_bounds_of_the_attention_kernels():
    """The bounds of the timed shapes: prefill 137.4
    GFLOP at 989.4 TFLOP/s (bf16) and 67 TFLOP/s (f32); decode 2.147 GB
    of KV at 3.35 TB/s."""
    kind = "NVIDIA H100 80GB HBM3"
    nbytes, flops, ms, by = chip_smoke.attention_bound(
        kind, 4, 32, 8, 2048, 2048, 128, 2)
    assert nbytes == 167_772_160 and flops == 137_506_062_336
    assert by == "operations" and ms == pytest.approx(0.13898, abs=1e-5)
    assert chip_smoke.attention_bound(kind, 4, 32, 8, 2048, 2048, 128,
                                      4)[2] == pytest.approx(2.0523, abs=1e-4)
    nbytes, flops, ms, by = chip_smoke.decode_bound(kind, [32768] * 16, 8, 4,
                                                    128, 2)
    assert nbytes == pytest.approx(2.147e9, rel=1e-3) and by == "bytes"
    assert ms == pytest.approx(0.6411, abs=1e-4)
    assert chip_smoke.decode_bound("NVIDIA A100-SXM4-80GB", [8], 8, 4, 128,
                                   2)[2] is None


def test_kernels_line_names_every_kernel():
    assert set(chip_smoke.KERNELS) == {"crop_mirror_normalize",
                                       "flash_attention", "flash_decode"}
    for module, source, replaces in chip_smoke.KERNELS.values():
        assert (ROOT / source).is_file()
        path, line = replaces.split(":")
        assert "pallas" in (ROOT / path).read_text()
        assert int(line) > 0
