"""``chip_smoke.py`` rehearsed on the CPU: it refuses to run without a card
or without the rest of the repo, its phases run end to end at a small size
on the kernels' plain versions, and its bound is the one ``PERF.md``
states."""

import math
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
    run = {"is_moe": False, "prefill_calls": 3, "prefill_s": 2048,
           "engine_steps": 10,
           "after_prefill": {"crop_mirror_normalize": 0,
                             "flash_attention": 108, "flash_decode": 0,
                             "grouped_matmul": 0},
           "launches": {"crop_mirror_normalize": 0, "flash_attention": 108,
                        "flash_decode": 360, "grouped_matmul": 0}}
    chip_smoke.check_serving_launches(run, 36, on_card=True)
    for bad in ({"flash_decode": 359}, {"crop_mirror_normalize": 1},
                {"flash_attention": 109}, {"grouped_matmul": 1}):
        with pytest.raises(AssertionError, match="launches"):
            chip_smoke.check_serving_launches(
                dict(run, launches=dict(run["launches"], **bad)), 36,
                on_card=True)


def test_moe_serving_launch_check():
    """Grok-1 at 4 layers: per 2 x 2048 prefill call 4 flash-attention and
    3 * 4 * (2048 / 512) = 48 grouped-matmul launches; per engine step 4
    flash-decode and 12 grouped-matmul launches."""
    run = {"is_moe": True, "prefill_calls": 2, "prefill_s": 2048,
           "engine_steps": 158,
           "after_prefill": {"crop_mirror_normalize": 0,
                             "flash_attention": 8, "flash_decode": 0,
                             "grouped_matmul": 96},
           "launches": {"crop_mirror_normalize": 0, "flash_attention": 8,
                        "flash_decode": 632,
                        "grouped_matmul": 96 + 12 * 158}}
    chip_smoke.check_serving_launches(run, 4, on_card=True)
    with pytest.raises(AssertionError, match="launches"):
        chip_smoke.check_serving_launches(dict(run, is_moe=False), 4,
                                          on_card=True)
    for bad in ({"grouped_matmul": 96 + 12 * 158 - 1},
                {"flash_decode": 633}):
        with pytest.raises(AssertionError, match="launches"):
            chip_smoke.check_serving_launches(
                dict(run, launches=dict(run["launches"], **bad)), 4,
                on_card=True)
    one_chunk = dict(run, prefill_s=512, after_prefill=dict(
        run["after_prefill"], grouped_matmul=24), launches=dict(
        run["launches"], grouped_matmul=24 + 12 * 158))
    chip_smoke.check_serving_launches(one_chunk, 4, on_card=True)


def test_moe_serving_path_rehearses_on_cpu():
    """Phases 11 and 12 on the CPU at Grok-1's smoke config: a prefill of
    2 x 1024 (two MoE chunks), two waves of continuous batching, the
    prefill's MoE metrics, no kernel launched, and the f32 check (CPU
    against CPU) at zero with d_ff cut as on the card."""
    cpu = torch.device("cpu")
    cfg = chip_smoke.get_arch(chip_smoke.MOE_ARCH).smoke_config()
    run, prompts = chip_smoke.drive_serving(
        cpu, cfg, n_prompts=6, prompt_len=10, prefill_b=2, prefill_s=1024,
        slots=4, max_seq=16, new_tokens=5, n_prefill=2)
    assert run["is_moe"]
    chip_smoke.check_serving_launches(run, cfg.n_layers, on_card=False)
    assert run["engine_steps"] == 2 * (10 + 5 - 1) and run["tokens"] == 30
    assert set(run["prefill_aux"]) == {"moe_aux_loss", "moe_z_loss",
                                       "moe_dropped_frac"}
    assert 0.0 <= run["prefill_aux"]["moe_dropped_frac"] < 1.0
    assert chip_smoke.check_f32_path(
        cpu, cfg.scaled(d_ff=96), prompts, prefill_len=24, n_steps=4,
        slots=4, max_seq=16) == {"prefill_max_abs_diff": 0.0,
                                 "decode_max_abs_diff": 0.0}


def test_moe_path_config_is_grok_at_full_width():
    cfg = chip_smoke.get_arch(chip_smoke.MOE_ARCH).scaled(
        n_layers=chip_smoke.MOE_LAYERS)
    assert (cfg.family, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.n_experts, cfg.top_k,
            cfg.vocab, cfg.n_layers) == ("moe", 6144, 48, 8, 128, 32768, 8,
                                         2, 131072, 4)
    serve = chip_smoke.MOE_SERVE
    E, C, d, f = chip_smoke.GMM_DECODE
    assert (E, d, f) == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert C == serve["slots"] * 1           # S=1: C = ceil(2*1.25/8) = 1
    E, C, d, f = chip_smoke.GMM_PREFILL
    assert C == serve["prefill_b"] * -(-512 * 2 * 1.25 // 8)
    # Every shape the path gives the kernel (gate/up and down, at decode
    # and in a prefill chunk) is checked in bf16 and timed.
    shapes = {(E, rows, a, b) for rows in (serve["slots"], C)
              for a, b in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model))}
    assert {s for s, dtype in chip_smoke.GMM_PATH_CASES
            if dtype == torch.bfloat16} == shapes
    assert {s for _, s, _, _ in chip_smoke.TIME_GMM} == shapes


@pytest.fixture
def small_gmm(monkeypatch):
    monkeypatch.setattr(chip_smoke, "GMM_DECODE", (4, 8, 64, 96))
    monkeypatch.setattr(chip_smoke, "GMM_PREFILL", (4, 40, 64, 96))
    monkeypatch.setattr(chip_smoke, "GMM_PATH_CASES", [
        ((4, 8, 64, 96), torch.bfloat16), ((4, 8, 96, 64), torch.bfloat16),
        ((4, 40, 64, 96), torch.bfloat16), ((4, 40, 96, 64), torch.bfloat16),
        ((4, 8, 64, 96), torch.float32), ((4, 40, 64, 96), torch.float32)])


def test_gmm_checks_rehearse_on_cpu(small_gmm):
    """Phase 10 on the CPU: the plain version against itself, through the
    same dispatch, the same views and the same tolerances."""
    assert chip_smoke.check_gmm(torch.device("cpu")) == {
        (shape, dtype): 0.0 for shape, dtype in chip_smoke.GMM_PATH_CASES}


def test_compare_takes_the_gmm_tolerances():
    a = torch.full((4,), 10.0)
    rtol, atol = chip_smoke.GMM_TOL[torch.bfloat16]
    assert chip_smoke.compare("bf16", (a + 0.9).bfloat16(), a.bfloat16(),
                              torch.bfloat16, (rtol, atol)) > 0.5
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare("f32", a + 2e-3, a, torch.float32,
                           chip_smoke.GMM_TOL[torch.float32])
    # At the path's shapes: one bf16 ulp passes at any magnitude, an error
    # of 0.05 at outputs below 1 (one 16-deep slice of d left out) fails.
    path = chip_smoke.GMM_PATH_TOL[torch.bfloat16]
    for v in (1e-5, 0.3, 1.0, 3.0, 7.5):
        want = torch.full((4,), v).bfloat16()
        ulp = 2.0 ** (math.floor(math.log2(v)) - 7)
        assert chip_smoke.compare("1 ulp", (want.float() + ulp).bfloat16(),
                                  want, torch.bfloat16, path) == ulp
    for v in (0.1, 0.5, 0.9):
        want = torch.full((4,), v).bfloat16()
        with pytest.raises(AssertionError, match="disagrees"):
            chip_smoke.compare("off", (want.float() + 0.05).bfloat16(), want,
                               torch.bfloat16, path)


def test_bounds_of_the_grouped_matmul():
    """Decode: 3.226 GB of weights at 3.35 TB/s, 0.963 ms, set by bytes;
    a prefill chunk: 1.031 TFLOP at 989.4 TFLOP/s, 1.042 ms, set by
    operations (its 3.42 GB would take 1.02 ms)."""
    kind = "NVIDIA H100 80GB HBM3"
    nbytes, flops, ms, by = chip_smoke.gmm_bound(kind, *chip_smoke.GMM_DECODE,
                                                 2)
    assert nbytes == 3_226_206_208 and by == "bytes"
    assert nbytes / 1e9 == pytest.approx(3.226, abs=5e-4)
    assert ms == pytest.approx(0.963, abs=5e-4)
    nbytes, flops, ms, by = chip_smoke.gmm_bound(kind,
                                                 *chip_smoke.GMM_PREFILL, 2)
    assert flops == 1_030_792_151_040 and by == "operations"
    assert flops / 1e12 == pytest.approx(1.031, abs=5e-4)
    assert ms == pytest.approx(1.042, abs=5e-4)
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(1.02, abs=5e-3)
    assert chip_smoke.gmm_bound("NVIDIA A100-SXM4-80GB", 1, 8, 64, 64,
                                2)[2] is None


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
                                       "flash_attention", "flash_decode",
                                       "grouped_matmul"}
    for module, source, replaces in chip_smoke.KERNELS.values():
        assert (ROOT / source).is_file()
        path, line = replaces.split(":")
        assert "pallas" in (ROOT / path).read_text()
        assert int(line) > 0
