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
from repro_torch.train.optimizer import CHUNK_ELEMS

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


def test_step_ab_exits_nonzero_without_a_card():
    """tools/torch_step_ab.py, which times two checkouts' serving step in
    turns on one card, refuses to run without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "tools/torch_step_ab.py", ".",
                          "."], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and "RESULT" not in out.stdout


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
    # and in a prefill chunk, and in its prefill_32k and decode_32k cells:
    # a one-row chunk and a step of DECODE_32K_BATCH slots) is checked in
    # bf16 and timed, beside Kimi-K2's (test_kimi_path_config_at_full_width)
    # and those of Kimi-K2's cells (test_kimi_cells_gmm_shapes_are_derived
    # in tests/test_torch_chip_smoke_family_cells.py).
    cells = (C // serve["prefill_b"], chip_smoke.DECODE_32K_BATCH["11"])
    shapes = {(E, rows, a, b) for rows in (serve["slots"], C) + cells
              for a, b in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model))}
    kimi = _kimi_gmm_shapes() | _kimi_gmm_shapes(cells=True)
    assert {s for s, dtype in chip_smoke.GMM_PATH_CASES
            if dtype == torch.bfloat16} == shapes | kimi
    assert {s for _, s, _, _ in chip_smoke.TIME_GMM} == shapes | kimi
    # Its attention shapes (G = 6) are checked and timed in bf16 too.
    prefill = (serve["prefill_b"], cfg.n_heads, cfg.n_kv_heads,
               serve["prefill_s"], cfg.resolved_head_dim)
    decode = (serve["slots"], cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
              serve["max_seq"], cfg.resolved_head_dim)
    assert (prefill, torch.bfloat16) in chip_smoke.FLASH_PATH_CASES
    assert (decode, torch.bfloat16) in chip_smoke.DECODE_PATH_CASES
    assert prefill in dict(chip_smoke.TIME_ATTENTION).values()
    assert decode in dict(chip_smoke.TIME_DECODES).values()


def _kimi_gmm_shapes(cells=False):
    """Kimi-K2's four grouped-matmul shapes on its serving path, from its
    config and the phase's sizes: C = ceil(S * top_k * 1.25 / E) per row
    (1 at decode, 14 in a 512-token chunk) times the rows; with ``cells``
    those of its prefill_32k (one row) and decode_32k (its batch of
    slots) cells."""
    cfg = chip_smoke.get_arch(chip_smoke.KIMI_ARCH)
    serve = chip_smoke.KIMI_SERVE
    slots, rows = serve["slots"], serve["prefill_b"]
    if cells:
        slots, rows = chip_smoke.FAMILY_CELL_BATCH["13"], 1
    E = cfg.n_experts
    decode = slots * -(-cfg.top_k * 1.25 // E)
    chunk = rows * -(-512 * cfg.top_k * 1.25 // E)
    return {(E, int(rows), a, b) for rows in (decode, chunk)
            for a, b in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model))}


def test_kimi_path_config_at_full_width():
    """Kimi-K2 at its published widths, cut to 1 of 61 layers: 64 query
    heads over 8 kv heads at head dim 112, 384 experts top-8 with d_ff
    2048, vocab 163,840 (one embedding, which the unembedding reuses, as in
    the reference): 18.2 B parameters, 36.4 GB in bf16.  The
    attention kernels are checked and timed at its prefill and decode
    shapes, the grouped matmul at its four."""
    cfg = chip_smoke.get_arch(chip_smoke.KIMI_ARCH).scaled(
        n_layers=chip_smoke.KIMI_LAYERS)
    assert (cfg.family, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.n_experts, cfg.top_k,
            cfg.vocab, cfg.n_layers, cfg.dtype) == (
        "moe", 7168, 64, 8, 112, 2048, 384, 8, 163840, 1, "bfloat16")
    n = sum(math.prod(shape) for shape in _leaf_shapes(
        chip_smoke.build_model(cfg, device="cpu").param_specs()))
    assert n == 18_204_218_368
    serve = chip_smoke.KIMI_SERVE
    assert ((serve["prefill_b"], 64, 8, serve["prefill_s"], 112),
            torch.bfloat16) in chip_smoke.FLASH_PATH_CASES
    assert ((serve["slots"], 8, 8, serve["max_seq"], 112),
            torch.bfloat16) in chip_smoke.DECODE_PATH_CASES
    assert (serve["prefill_b"], 64, 8, serve["prefill_s"], 112) in \
        dict(chip_smoke.TIME_ATTENTION).values()
    assert (serve["slots"], 8, 8, serve["max_seq"], 112) in \
        dict(chip_smoke.TIME_DECODES).values()
    assert _kimi_gmm_shapes() == {
        chip_smoke.KIMI_GMM_DECODE, chip_smoke.KIMI_GMM_DECODE_DOWN,
        chip_smoke.KIMI_GMM_PREFILL, chip_smoke.KIMI_GMM_PREFILL_DOWN}
    # f32 phases stay on f32 shapes of their own; D=112 is in the sweeps.
    assert {D for *_, D in chip_smoke.FLASH_CASES} >= {112}
    assert {D for *_, D in chip_smoke.DECODE_CASES} >= {112}


def _leaf_shapes(spec):
    for v in spec.values():
        if isinstance(v, dict):
            yield from _leaf_shapes(v)
        else:
            yield v.shape


def test_kimi_serving_path_rehearses_on_cpu():
    """Phase 13 on the CPU at Kimi-K2's smoke config with its head dim 112:
    a prefill of 2 x 1024 (two MoE chunks), one wave of continuous
    batching, the prefill's MoE metrics, no kernel launched, and the f32
    check (CPU against CPU) at zero with d_ff cut as on the card."""
    cpu = torch.device("cpu")
    cfg = chip_smoke.get_arch(chip_smoke.KIMI_ARCH).smoke_config().scaled(
        head_dim=112, n_layers=chip_smoke.KIMI_LAYERS)
    run, prompts = chip_smoke.drive_serving(
        cpu, cfg, n_prompts=4, prompt_len=10, prefill_b=2, prefill_s=1024,
        slots=4, max_seq=16, new_tokens=5, n_prefill=2)
    assert run["is_moe"]
    chip_smoke.check_serving_launches(run, cfg.n_layers, on_card=False)
    assert run["engine_steps"] == 10 + 5 - 1 and run["tokens"] == 20
    assert 0.0 <= run["prefill_aux"]["moe_dropped_frac"] < 1.0
    assert chip_smoke.check_f32_path(
        cpu, cfg.scaled(d_ff=chip_smoke.KIMI_CHECK_D_FF // 4), prompts,
        prefill_len=24, n_steps=4, slots=4, max_seq=16) == {
            "prefill_max_abs_diff": 0.0, "decode_max_abs_diff": 0.0}


@pytest.fixture
def small_gmm(monkeypatch):
    monkeypatch.setattr(chip_smoke, "GMM_DECODE", (4, 8, 64, 96))
    monkeypatch.setattr(chip_smoke, "GMM_PREFILL", (4, 40, 64, 96))
    monkeypatch.setattr(chip_smoke, "GMM_PATH_CASES", [
        ((4, 8, 64, 96), torch.bfloat16), ((4, 8, 96, 64), torch.bfloat16),
        ((4, 40, 64, 96), torch.bfloat16), ((4, 40, 96, 64), torch.bfloat16),
        ((4, 8, 64, 96), torch.float32), ((4, 40, 64, 96), torch.float32)])
    monkeypatch.setattr(chip_smoke, "GMM_OFF_PATH", [
        ("off", (4, 20, 64, 96), 1, 1)])
    monkeypatch.setattr(chip_smoke, "GMM_REPEAT_CASES", [(4, 8, 96, 64)])


def test_gmm_checks_rehearse_on_cpu(small_gmm):
    """Phase 10 on the CPU: the plain version against itself, through the
    same dispatch, the same views and the same tolerances."""
    assert chip_smoke.check_gmm(torch.device("cpu")) == {
        (shape, dtype): 0.0 for shape, dtype in chip_smoke.GMM_PATH_CASES
        + [((4, 20, 64, 96), torch.bfloat16)]}


def test_every_bf16_gmm_tile_is_checked_on_the_card():
    """Phase 10's bf16 shapes reach every tile of the tensor-core kernel,
    and the path's and off-path prefill chunks reach the 64-, 160- and
    320-row ones (the sweep reaches some by chance)."""
    def variant(shape):
        return chip_smoke.grouped_matmul.plan(*shape, torch.bfloat16).variant

    sweep = {variant(s) for s in chip_smoke.GMM_CASES
             + chip_smoke.GMM_EDGE_CASES}
    path = {variant(s) for s, dtype in chip_smoke.GMM_PATH_CASES
            if dtype == torch.bfloat16}
    off = {variant(s) for _, s, _, _ in chip_smoke.GMM_OFF_PATH}
    assert sweep | path | off == set(
        range(len(chip_smoke.grouped_matmul.TC_VARIANTS)))
    assert path | off == set(range(len(
        chip_smoke.grouped_matmul.TC_VARIANTS)))
    assert not off & path                    # off the path: other tiles


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


def _tc_attention(q, k, v, *, skip=None):
    """The bf16 tensor-core flash kernel's arithmetic, emulated on the CPU
    (causal, K = 1): 64-key tiles, an f32 online softmax, each weight P
    rounded to bf16 before P V, l summed from the rounded P.  ``skip``
    (head, row, key, n) leaves keys key .. key + n - 1 (within one tile)
    out of that row's P V but not out of its l."""
    B, H, S, D = q.shape
    s = torch.einsum("bhsd,btd->bhst", q.float(), k[:, 0].float())
    s = s * (D ** -0.5) * math.log2(math.e)
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(causal, s, torch.tensor(-1e30))
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros(B, H, S, 1)
    acc = torch.zeros(B, H, S, D)
    for t in range(S // 64):
        st = s[..., t * 64:(t + 1) * 64]
        new = torch.maximum(m, st.amax(-1, keepdim=True))
        corr, m = torch.exp2(m - new), new
        p = torch.exp2(st - m).bfloat16().float()
        l = l * corr + p.sum(-1, keepdim=True)
        if skip is not None and t == skip[2] // 64:
            head, row, key, n = skip
            p[:, head, row, key % 64:key % 64 + n] = 0
        acc = acc * corr + p @ v[:, 0, t * 64:(t + 1) * 64].float()
    return (acc / l).bfloat16()


def test_flash_path_tolerance_admits_bf16_weights_and_catches_a_lost_tile():
    """The attention path limit (2**-6 rtol plus 2**-5 of the row's RMS)
    passes the tensor-core kernel's rounding of P to bf16 at under half
    of the limit, and fails a kernel that leaves one mma's 8 keys out of
    one late row's P V, an error that the reference's 2e-2 passes."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               .bfloat16() for s in ((1, 4, 1024, 64), (1, 1, 1024, 64),
                                     (1, 1, 1024, 64)))
    want = chip_smoke.ref.mha_reference(q, k, v)
    tol = chip_smoke.path_tol(want, torch.bfloat16)
    rtol, atol = tol
    got = _tc_attention(q, k, v)
    diff = (got.float() - want.float()).abs()
    assert float((diff / (atol + rtol * want.float().abs())).max()) < 0.5
    chip_smoke.compare("emulated", got, want, torch.bfloat16, tol)
    lost = _tc_attention(q, k, v, skip=(0, 1000, 192, 8))
    chip_smoke.compare("lost, reference limit", lost, want, torch.bfloat16)
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare("lost", lost, want, torch.bfloat16, tol)
    # f32 keeps TOL.
    assert chip_smoke.path_tol(want.float(), torch.float32) == (2e-5, 2e-5)


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


def _tc_decode(q, k, v, length, split, *, lose=None):
    """The bf16 tensor-core decode kernel's arithmetic, emulated on the CPU
    for rows that share one ``length``: each of the row's ``split`` CTAs
    takes ``decode_attention.tc_chunk``'s keys in 64-key tiles, each warp 16
    keys of a tile with an f32 online softmax of its own, each weight P
    rounded to bf16 before P V and l summed from the rounded P; the warps'
    parts fold in the CTA, the CTAs' parts in rank 0.  ``lose`` (head,
    key, n) leaves keys key .. key + n - 1 out of that head's P V in every
    row, but not out of its l."""
    da = chip_smoke.decode_attention
    B, K, G, D = q.shape
    T = k.shape[2]
    warps, kw = da.TC_WARPS, da.TC_TILE // da.TC_WARPS
    scale2 = torch.tensor(D ** -0.5) * torch.tensor(math.log2(math.e))
    s = torch.einsum("bkgd,bktd->bkgt", q.float(), k.float()) * scale2
    parts = []
    for rank in range(split):
        lo, hi = da.tc_chunk(rank, split, length)
        m = torch.full((B, K, G, warps), -1e30)
        l = torch.zeros(B, K, G, warps)
        acc = torch.zeros(B, K, G, warps, D)
        for t0 in range(lo, hi, da.TC_TILE):
            keys = (t0 + torch.arange(da.TC_TILE)).reshape(warps, kw)
            valid = keys < hi
            idx = keys.clamp(max=T - 1)
            st = torch.where(valid, s[..., idx], torch.tensor(-1e30))
            vt = v[:, :, idx].float() * valid[..., None]
            new = torch.maximum(m, st.amax(-1))
            corr, m = torch.exp2(m - new), new
            p = torch.exp2(st - m[..., None]).bfloat16().float()
            l = l * corr + p.sum(-1)
            if lose is not None:
                head, key, n = lose
                p[:, :, head] *= ~((keys >= key) & (keys < key + n))
            acc = acc * corr[..., None] + torch.einsum("bkgwj,bkwjd->bkgwd",
                                                       p, vt)
        mw = m.amax(-1, keepdim=True)
        e = torch.exp2(m - mw)
        parts.append((mw[..., 0], (e * l).sum(-1),
                      (e[..., None] * acc).sum(-2)))
    mc = torch.stack([p[0] for p in parts]).amax(0)
    num = sum(torch.exp2(pm - mc)[..., None] * pa for pm, _, pa in parts)
    den = sum(torch.exp2(pm - mc) * pl for pm, pl, _ in parts)
    return (num / den[..., None]).bfloat16()


@pytest.mark.parametrize("length", [160, 4096])
def test_decode_path_tolerance_admits_bf16_weights(length):
    """The decode path limit (2**-6 rtol plus 2**-5 of the row's RMS)
    passes the tensor-core decode kernel's rounding of P to bf16 at
    Qwen3-4B's decode shape, at the live and at the full length, and
    fails a kernel that leaves one mma's 8 keys out of one head's P V."""
    B, K, G, T, D = chip_smoke.TIME_DECODES[1][1]
    split = chip_smoke.decode_attention.plan(B, K, G, T, D,
                                             torch.bfloat16).split
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               .bfloat16() for s in ((B, K, G, D), (B, K, T, D),
                                     (B, K, T, D)))
    lengths = torch.full((B,), length)
    want = chip_smoke.ref.decode_reference(
        q.reshape(B, K * G, D), k, v, lengths).reshape(B, K, G, D)
    rtol, atol = tol = chip_smoke.path_tol(want, torch.bfloat16)
    got = _tc_decode(q, k, v, length, split)
    diff = (got.float() - want.float()).abs()
    assert float((diff / (atol + rtol * want.float().abs())).max()) < 1
    chip_smoke.compare("emulated", got, want, torch.bfloat16, tol)
    lost = _tc_decode(q, k, v, length, split, lose=(1, length // 2, 8))
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare("lost", lost, want, torch.bfloat16, tol)


@pytest.mark.parametrize("length", [160, 4096])
def test_decode_fold_order_is_fixed(length):
    """The emulated kernel, whose warps fold in the CTA and whose CTAs fold
    in rank 0 in a fixed order, gives the same bits twice at the dense
    serving shape, at the live and at the full length, within the path
    tolerance of the reference."""
    B, K, G, T, D = chip_smoke.TIME_DECODES[1][1]
    split = chip_smoke.decode_attention.plan(B, K, G, T, D,
                                             torch.bfloat16).split
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               .bfloat16() for s in ((B, K, G, D), (B, K, T, D),
                                     (B, K, T, D)))
    first = _tc_decode(q, k, v, length, split)
    assert torch.equal(first, _tc_decode(q, k, v, length, split))
    want = chip_smoke.ref.decode_reference(
        q.reshape(B, K * G, D), k, v, torch.full((B,), length)).reshape(
            B, K, G, D)
    chip_smoke.compare("emulated twice", first, want, torch.bfloat16,
                       chip_smoke.path_tol(want, torch.bfloat16))


def test_decode_is_checked_and_timed_at_live_and_ragged_lengths():
    """Every bf16 decode path shape has a live length, the cache's length
    half way through its engine run (every slot attends to the shared
    position + 1, which grows by one per step over the whole run), is timed
    there, and its ragged batch hits 1, each tile and split boundary of the
    tensor-core kernel, T - 1 and T."""
    bf16 = {shape for shape, dtype in chip_smoke.DECODE_PATH_CASES
            if dtype == torch.bfloat16}
    assert set(chip_smoke.DECODE_LIVE) == bf16
    qwen = dict(n_prompts=chip_smoke.N_PROMPTS,
                prompt_len=chip_smoke.PROMPT_LEN, slots=chip_smoke.SLOTS,
                max_seq=chip_smoke.MAX_SEQ, new_tokens=chip_smoke.NEW_TOKENS)
    for serve, shape in ((qwen, (chip_smoke.SLOTS, 8, 4,
                                 chip_smoke.MAX_SEQ, 128)),
                         (chip_smoke.MOE_SERVE, (8, 8, 6, 1024, 128)),
                         (chip_smoke.KIMI_SERVE, (8, 8, 8, 1024, 112))):
        steps = -(-serve["n_prompts"] // serve["slots"]) * (
            serve["prompt_len"] + serve["new_tokens"] - 1)
        assert shape[3] == serve["max_seq"] > steps
        assert abs(chip_smoke.DECODE_LIVE[shape] - steps / 2) <= 1
    timed = {shape for _, shape in chip_smoke.TIME_DECODES}
    assert bf16 <= timed
    for B, K, G, T, D in bf16:
        p = chip_smoke.decode_attention.plan(B, K, G, T, D, torch.bfloat16)
        n = chip_smoke.ragged_lengths(B, K, G, T, D)
        assert len(n) == B and all(1 <= x <= T for x in n)
        assert {1, p.tile - 1, p.tile, p.tile + 1, p.split * p.tile,
                p.split * p.tile + 1, T - 1, T} <= set(n)


def test_moe_training_config_is_grok_at_full_width():
    """Phase C trains Grok-1 at its published widths, all 8 experts top-2
    and its vocabulary, cut to 1 of 64 layers: 5.73e9 parameters, 68.7 GB
    at 12 B each (bf16 parameters and gradients, f32 moments), under the
    card's 80 GB; the derived flops count 2 of the 8 experts a token.
    Its f32 check cuts d_ff and the vocabulary, to 0.33e9 parameters,
    whose embedding still takes the update's row blocks."""
    cfg = chip_smoke.get_arch(chip_smoke.MOE_ARCH).scaled(
        n_layers=chip_smoke.MOE_TRAIN_LAYERS)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.n_experts, cfg.top_k, cfg.vocab, cfg.n_layers, cfg.dtype,
            cfg.remat) == (6144, 48, 8, 32768, 8, 2, 131072, 1, "bfloat16",
                           True)
    specs = chip_smoke.build_model(cfg, device="cpu").param_specs()
    n = sum(math.prod(shape) for shape in _leaf_shapes(specs))
    assert n == 5_725_292_544 and 12 * n < 68.71e9
    assert chip_smoke.MOE_TRAIN_S == 4 * 512              # four chunks a row
    check = cfg.scaled(d_ff=chip_smoke.MOE_TRAIN_CHECK_D_FF,
                       vocab=chip_smoke.MOE_TRAIN_CHECK_VOCAB)
    n_check = sum(math.prod(shape) for shape in _leaf_shapes(
        chip_smoke.build_model(check, device="cpu").param_specs()))
    assert n_check == 327_223_296
    assert check.vocab * check.d_model > CHUNK_ELEMS
    assert chip_smoke.n_chunks(chip_smoke.MOE_TRAIN_CHECK_S) == 2


# ---- phases D, E and F: the hybrid, ssm and audio families --------------

FAMILY_SMOKE = {
    "D": (dict(n_prompts=5, prompt_len=10, prefill_b=2, prefill_s=40,
               slots=4, max_seq=64, new_tokens=4, n_prefill=2),
          dict(prompt=30, prefill_len=30, n_steps=30 + 4 - 1, slots=1,
               max_seq=64, new_tokens=4)),
    "E": (dict(n_prompts=5, prompt_len=10, prefill_b=2, prefill_s=300,
               slots=4, max_seq=16, new_tokens=4, n_prefill=2),
          dict(n_layers=2, prefill_len=24, n_steps=4, slots=4, max_seq=16)),
    "F": (dict(n_prompts=5, prompt_len=10, prefill_b=2, prefill_s=20,
               slots=4, max_seq=32, new_tokens=4, n_prefill=3),
          dict(prefill_len=20, n_steps=4, slots=4, max_seq=32)),
}


@pytest.mark.parametrize("phase", sorted(FAMILY_SMOKE))
def test_family_serving_paths_rehearse_on_cpu(phase):
    """Phases D, E and F on the CPU at each family's smoke config: prompts
    over the simulated WAN, the prefill (Whisper's with make_batch's
    frames), two waves of continuous batching, no kernel launched, and the
    f32 check (CPU against CPU) at zero; Hymba's check decodes one slot
    past its 16-token window."""
    arch = chip_smoke.FAMILY_PHASES[phase][0]
    serve, check = FAMILY_SMOKE[phase]
    cfg = chip_smoke.get_arch(arch).smoke_config()
    out = chip_smoke.drive_family(torch.device("cpu"), cfg, serve, check)
    run = out["run"]
    assert run["engine_steps"] == 2 * (10 + 4 - 1) and run["tokens"] == 20
    assert not any(run["launches"].values()) and not run["is_moe"]
    assert out["f32"] == {"prefill_max_abs_diff": 0.0,
                          "decode_max_abs_diff": 0.0}
    assert out["seconds"] > 0


def test_family_launch_counts_are_exact():
    """Per prefill call and per engine step: Hymba one flash attention and
    one flash decode a layer (32, 32); Whisper-tiny 4 encoder + 2 x 4
    decoder flash attentions (12) and 2 x 4 flash decodes (8); xLSTM
    none, and any launch fails its phase."""
    per = {phase: chip_smoke.launches_per_call(chip_smoke.get_arch(arch))
           for phase, (arch, _, _) in chip_smoke.FAMILY_PHASES.items()}
    assert per == {"D": (32, 32), "E": (0, 0), "F": (12, 8)}
    zero = {name: 0 for name in chip_smoke.KERNELS}
    for phase, (attn, dec) in per.items():
        run = {"is_moe": False, "prefill_calls": 3, "prefill_s": 448,
               "engine_steps": 190,
               "after_prefill": dict(zero, flash_attention=3 * attn),
               "launches": dict(zero, flash_attention=3 * attn,
                                flash_decode=190 * dec)}
        cfg = chip_smoke.get_arch(chip_smoke.FAMILY_PHASES[phase][0])
        chip_smoke.check_serving_launches(run, cfg.n_layers, True,
                                          per[phase])
        for bad in ({"flash_decode": 190 * dec + 1},
                    {"grouped_matmul": 1}, {"crop_mirror_normalize": 1}):
            with pytest.raises(AssertionError, match="launches"):
                chip_smoke.check_serving_launches(
                    dict(run, launches=dict(run["launches"], **bad)),
                    cfg.n_layers, True, per[phase])


def test_family_phases_run_each_config_at_full_width_and_depth():
    """Each phase serves its config file's model whole: widths, heads,
    window, state and vocabulary as published, every layer, bf16; with
    Hymba's 1.424e9, xLSTM's 1.90e8 and Whisper-tiny's 3.65e7 parameters.
    Its kernels' path shapes are checked in both dtypes and timed in
    bf16."""
    fields = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "resolved_head_dim", "vocab", "dtype")
    want = {"D": ("hybrid", 32, 1600, 25, 5, 64, 32001, "bfloat16"),
            "E": ("ssm", 24, 1024, 4, 4, 256, 50304, "bfloat16"),
            "F": ("audio", 4, 384, 6, 6, 64, 51865, "bfloat16")}
    params = {"D": 1_423_772_832, "E": 190_096_480, "F": 36_477_312}
    for phase, (arch, serve, check) in chip_smoke.FAMILY_PHASES.items():
        cfg = chip_smoke.get_arch(arch)
        assert tuple(getattr(cfg, f) for f in fields) == want[phase]
        n = sum(math.prod(shape) for shape in _leaf_shapes(
            chip_smoke.build_model(cfg, device="cpu").param_specs()))
        assert n == params[phase]
        assert serve["new_tokens"] == 32 and serve["n_prompts"] == 16
    hymba = chip_smoke.get_arch("hymba_1_5b")
    assert (hymba.window, hymba.ssm_state) == (1024, 16)
    serve, check = chip_smoke.FAMILY_PHASES["D"][1:]
    assert serve["prefill_s"] > hymba.window            # past the window
    assert check["n_steps"] == check["prompt"] + check["new_tokens"] - 1
    assert check["prompt"] > hymba.window and check["slots"] == 1
    whisper = chip_smoke.get_arch("whisper_tiny")
    assert (whisper.enc_layers, whisper.enc_frames) == (4, 1500)
    assert chip_smoke.FAMILY_PHASES["F"][1]["prefill_s"] == 448
    # The path shapes: Hymba's windowed prefill and ring, Whisper's
    # encoder, decoder and cross-attention and its two decode caches.
    H, K, D = hymba.n_heads, hymba.n_kv_heads, 64
    serve = chip_smoke.FAMILY_PHASES["D"][1]
    masked = {(c[0], c[2], c[3]) for c in chip_smoke.FLASH_MASK_PATH_CASES
              if c[1] == torch.bfloat16}
    S = serve["prefill_s"]
    assert ((serve["prefill_b"], H, K, S, S, D), True, 1024) in masked
    serve = chip_smoke.FAMILY_PHASES["F"][1]
    B, S, F = serve["prefill_b"], serve["prefill_s"], whisper.enc_frames
    assert {((B, 6, 6, F, F, D), False, 0), ((B, 6, 6, S, S, D), True, 0),
            ((B, 6, 6, S, F, D), False, 0)} <= masked
    assert {s for _, s, _, _ in chip_smoke.TIME_MASKED_ATTENTION} == {
        c[0] for c in chip_smoke.FLASH_MASK_PATH_CASES
        if c[1] == torch.bfloat16}
    decode = {s for s, dtype in chip_smoke.DECODE_PATH_CASES
              if dtype == torch.bfloat16}
    assert {(8, K, H // K, 1024, D), (8, 6, 1, S, D),
            (8, 6, 1, F, D)} <= decode
    assert chip_smoke.DECODE_LIVE[(8, 6, 1, F, D)] == F
    # G = 5 and S != T are in the sweeps.
    assert any(H // K == 5 for _, H, K, _, _ in chip_smoke.FLASH_CASES)
    assert any(G == 5 for _, _, G, _, _ in chip_smoke.DECODE_CASES)
    assert all(S != T for _, _, _, S, T, _ in chip_smoke.FLASH_CROSS_CASES)


def test_f32_attention_is_checked_on_its_tile_edges_and_timed_on_its_paths():
    """Phase 6 holds the f32 kernel (128-key tiles, 64- and 128-row
    blocks) at S = 127, 128 and 129, under windows that straddle a
    128-key tile and with one key against 130 queries; phase 9 times it
    at Qwen3-4B's prefill, a full-width D = 64 shape with a 1024-key
    window, and every f32 shape of the serving paths' checks."""
    edges = chip_smoke.FLASH_F32_EDGES
    assert {S for (_, _, _, S, _, _), _, _ in edges} >= {127, 128, 129}
    assert ((1, 4, 2, 130, 1, 64), False, 0) in edges

    def straddles(S, window):
        return any(i - window + 1 < t <= i for i in range(S)
                   for t in range(128, S, 128))
    assert any(window and straddles(S, window)
               for (_, _, _, S, _, _), _, window in edges)
    assert {D for (*_, D), _, _ in edges} == set(
        chip_smoke.flash_attention.HEAD_DIMS)
    timed = {(shape, causal, window)
             for _, shape, causal, window in chip_smoke.TIME_ATTENTION_F32}
    assert ((4, 32, 8, 2048, 2048, 128), True, 0) in timed
    assert ((4, 25, 5, 2048, 2048, 64), True, 1024) in timed
    path = {((B, H, K, S, S, D), True, 0) for (B, H, K, S, D), dt
            in chip_smoke.FLASH_PATH_CASES if dt == torch.float32}
    path |= {(shape, causal, window) for shape, dt, causal, window
             in chip_smoke.FLASH_MASK_PATH_CASES if dt == torch.float32}
    assert len(path) == 6 and path <= timed
    assert len(timed) == len(chip_smoke.TIME_ATTENTION_F32) == 8


def test_bounds_of_the_masked_attention_shapes():
    """Hymba's prefill keeps 1024 keys a row past the window: 4 x 25 x 64
    x 4 flops for each of 1,573,376 pairs; Whisper's encoder all 1500^2,
    its cross-attention 448 x 1500."""
    kind = "NVIDIA H100 80GB HBM3"
    assert chip_smoke.causal_pairs(2048, 2048, 1024) == 1_573_376
    assert chip_smoke.causal_pairs(448, 1500, 0, causal=False) == 448 * 1500
    i, j = np.meshgrid(np.arange(10), np.arange(12), indexing="ij")
    assert chip_smoke.causal_pairs(10, 12, 3, causal=False) == int(
        (i - j < 3).sum())
    nbytes, flops, ms, by = chip_smoke.attention_bound(
        kind, 4, 25, 5, 2048, 2048, 64, 2, True, 1024)
    assert flops == 4 * 4 * 25 * 64 * 1_573_376 and by == "operations"
    nbytes, flops, ms, by = chip_smoke.attention_bound(
        kind, 8, 6, 6, 448, 1500, 64, 2, False, 0)
    assert nbytes == 2 * 64 * (2 * 8 * 6 * 448 + 2 * 8 * 6 * 1500)
    assert flops == 4 * 8 * 6 * 64 * 448 * 1500


# ---- phase G: Grok-1 on int8 AdamW moments --------------------------------

def test_int8_training_config_is_grok_at_full_width():
    """Phase G trains Grok-1 at its published widths, all 8 experts top-2
    and its vocabulary, cut to 2 of 64 layers, on ``int8`` moments (the
    reference's memory policy for Grok-1): 10.64e9 parameters, at 6 B
    each (bf16 parameters and gradients, int8 m and v) 63.9 GB, where
    phase C's 12 B a parameter fit only 1 layer; its checks cover both
    quantized state dtypes at phase C's check model on one chunk."""
    cfg = chip_smoke.int8_train_config()
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.n_experts, cfg.top_k, cfg.vocab, cfg.n_layers, cfg.dtype,
            cfg.remat) == (6144, 48, 8, 32768, 8, 2, 131072, 2, "bfloat16",
                           True)
    assert chip_smoke.INT8_STATE == "int8"
    assert chip_smoke.INT8_CHECK_STATES == ("int8", "int8_factored")
    n = sum(math.prod(shape) for shape in _leaf_shapes(
        chip_smoke.build_model(cfg, device="cpu").param_specs()))
    assert n == 10_645_272_576 and 6 * n < 63.9e9
    assert 12 * n > 80e9                    # f32 moments would not fit
    assert (chip_smoke.MOE_TRAIN_B, chip_smoke.MOE_TRAIN_S) == (2, 2048)
    assert chip_smoke.n_chunks(chip_smoke.INT8_CHECK_S) == 1
    # the check's embedding still takes the update's row blocks
    vocab = chip_smoke.MOE_TRAIN_CHECK_VOCAB
    assert vocab * cfg.d_model > CHUNK_ELEMS


def test_moment_err_counts_quantization_steps():
    a = {"m": {"w": {"q": torch.tensor([[3, -2]], dtype=torch.int8),
                     "scale": torch.tensor([[0.4]])}},
         "v": {"w": {"vr": torch.tensor([[1.0]]),
                     "vc": torch.tensor([[2.0, 4.0]])}}}
    b = {"m": {"w": {"q": torch.tensor([[2, -2]], dtype=torch.int8),
                     "scale": torch.tensor([[0.5]])}},
         "v": {"w": {"vr": torch.tensor([[1.0]]),
                     "vc": torch.tensor([[2.0, 3.0]])}}}
    err = chip_smoke.moment_err(a, b)
    # 3 * 0.4 - 2 * 0.5 = 0.2, under one step (0.5): no excess
    assert err["int8_codes"] == 1 and err["int8_excess"] == 0.0
    assert err["f32_rel"] == pytest.approx(1 / 3, rel=1e-6)
    a["m"]["w"]["q"][0, 0] = 5                   # 2.0 - 1.0 = 1.0: 0.5 over
    err = chip_smoke.moment_err(a, b)
    assert err["int8_codes"] == 3
    assert err["int8_excess"] == pytest.approx(0.5, rel=1e-6)


def test_phase_h_calls_match_only_exact_multiples():
    """Phase H holds the dry run's kernel calls per call (or step), times
    the calls, equal to the launches the card counted: a stray or missing
    launch that floor division would hide is a miss."""
    calls = {"flash_decode": 4, "grouped_matmul": 12}
    assert chip_smoke.calls_match(calls, {"flash_attention": 0,
                                          "flash_decode": 28,
                                          "grouped_matmul": 84}, 7)
    assert not chip_smoke.calls_match(calls, {"flash_decode": 28,
                                              "grouped_matmul": 85}, 7)
    assert not chip_smoke.calls_match(calls, {"flash_decode": 28}, 7)
    assert not chip_smoke.calls_match(calls, {"flash_decode": 28,
                                              "grouped_matmul": 84,
                                              "flash_attention": 1}, 7)


def test_phase_h_roofline_is_the_twins_terms():
    """``roofline_ms`` is ``bench_torch_roofline.time_terms`` in ms with
    its largest term as the bound."""
    from benchmarks import bench_torch_roofline as roof
    rec = roof.load_results()[0]
    got = chip_smoke.roofline_ms(rec)
    want = {k: v * 1e3 for k, v in roof.time_terms(rec).items()}
    assert {k: got[k] for k in want} == want
    assert got["bound"] == max(want.values())
    assert got["dominant"] == max(want, key=want.get)


# ---- phases I, J and K: training the hybrid, ssm and audio families -----

def test_family_training_phases_run_each_config_at_full_width_and_depth():
    """Phase K trains its config file's model whole (as phase F serves
    it), I Hymba and J xLSTM at full width and 16 of 32 and 4 of 24
    layers (Hymba's step is launch-bound, about 10 s at 32; xLSTM's loop
    host-bound, about 150 s a step on the H100 at 24), with
    remat on phase 14's 2 x 4096 tokens and its 3 steps, 8 for Whisper, 1
    for xLSTM (timed, not counted); the f32 checks
    keep the width and cut only depth and length: Hymba 2 layers on 2080
    tokens (past 2048, so attention goes chunked, past the window, 9 Mamba
    chunks, the last ragged), xLSTM one pair on 544 (three mLSTM chunks,
    the last ragged), Whisper whole on 2080."""
    fields = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "resolved_head_dim", "d_ff", "vocab", "dtype", "remat")
    want = {"I": ("hybrid", 16, 1600, 25, 5, 64, 5504, 32001, "bfloat16",
                  True),
            "J": ("ssm", 4, 1024, 4, 4, 256, 0, 50304, "bfloat16", True),
            "K": ("audio", 4, 384, 6, 6, 64, 1536, 51865, "bfloat16", True)}
    for phase, (arch, sizes, check) in chip_smoke.FAMILY_TRAIN.items():
        cfg = chip_smoke.family_train_config(arch)
        assert tuple(getattr(cfg, f) for f in fields) == want[phase]
        assert sizes.get("batch", chip_smoke.TRAIN_B) == 2
        assert sizes.get("seq", chip_smoke.TRAIN_S) == 4096
        assert sizes["steps"] == {"I": 3, "J": 1, "K": 8}[phase]
        assert sizes.get("count_flops", True) == (phase != "J")
    assert chip_smoke.TRAIN_STEPS == 3
    hymba = chip_smoke.family_train_config("hymba_1_5b")
    assert (hymba.window, hymba.ssm_state, hymba.rope_theta > 0) == (
        1024, 16, True)
    assert chip_smoke.build_model(hymba, device="cpu").d_inner == 1600
    whisper = chip_smoke.family_train_config("whisper_tiny")
    assert (whisper.enc_layers, whisper.enc_frames) == (4, 1500)
    checks = {p: c for p, (_, _, c) in chip_smoke.FAMILY_TRAIN.items()}
    assert checks == {"I": {"n_layers": 2, "seq": 2080},
                      "J": {"n_layers": 2, "seq": 544},
                      "K": {"seq": 2080}}
    from repro_torch.models import attention, ssm
    assert 2080 > attention.DENSE_ATTN_MAX_SEQ > hymba.window
    assert -(-2080 // ssm.CHUNK) == 9 and 2080 % ssm.CHUNK
    assert -(-544 // ssm.CHUNK) == 3 and 544 % ssm.CHUNK


def _abstract(arch):
    cfg = chip_smoke.family_train_config(arch)
    return cfg, chip_smoke.build_model(cfg, device="cpu").abstract_params()


def test_train_flops_by_family():
    """The derived flops of a train step at 2 x 4096, written out by hand:
    6 per parameter and row plus 3 x 4 x D per kept (query, key) pair and
    head.  Qwen3-4B (phase 14) as before: causal attention in 36 layers.
    Hymba and xLSTM at phases I's and J's 16 and 4 layers.
    Hymba: every layer causal within its 1024-token window, 1024 x 1025 /
    2 + 3072 x 1024 = 3,670,528 pairs a row and head.  xLSTM: no
    attention.  Whisper-tiny: its encoder (4 layers of 1,774,080
    parameters and a 768-parameter LayerNorm) and the cross-attention's
    wk, wv and bv (4 x 295,296) see 1500 frames a row, the rest 4096
    tokens; attention over 4 x 1500^2 encoder pairs, 4 x 4096 x 4097 / 2
    causal and 4 x 4096 x 1500 cross pairs."""
    B, S = 2, 4096
    cfg = chip_smoke.get_arch(chip_smoke.ARCH).scaled(remat=True)
    params = chip_smoke.build_model(cfg, device="cpu").abstract_params()
    n = chip_smoke.count_params(params)
    assert chip_smoke.train_flops(cfg, params, B, S) == (
        6 * n * B * S + 36 * 3 * 4 * B * 32 * 128 * (S * (S + 1) // 2))
    cfg, params = _abstract("hymba_1_5b")
    assert chip_smoke.causal_pairs(S, S, 1024) == 3_670_528
    assert chip_smoke.train_flops(cfg, params, B, S) == (
        6 * 737_488_016 * B * S + 16 * 3 * 4 * B * 25 * 64 * 3_670_528)
    cfg, params = _abstract("xlstm_350m")
    assert chip_smoke.train_flops(cfg, params, B, S) == (
        6 * 74_609_680 * B * S)
    cfg, params = _abstract("whisper_tiny")
    framed = 4 * 1_774_080 + 768 + 4 * 295_296
    pairs = 4 * 1500 ** 2 + 4 * (S * (S + 1) // 2) + 4 * S * 1500
    assert chip_smoke.train_flops(cfg, params, B, S) == (
        6 * (36_477_312 - framed) * B * S + 6 * framed * B * 1500
        + 3 * 4 * B * 6 * 64 * pairs)


def test_phase_h_records_every_counted_training_phase(monkeypatch):
    """Phase H's records: the train steps of phases 14, C, G, I and K at
    their configs and sizes, none for J, phases 7's and 11's prefill
    calls and engine steps, and the prefill_32k and decode_32k cells of
    phases 7, 11 and L-O (``tests/test_torch_chip_smoke_cells.py`` holds
    their sizes)."""
    calls = []

    def dry_cell(cfg, kind, seq, batch, **kw):
        calls.append((cfg.name, cfg.n_layers, kind, seq, batch))
        return kind

    monkeypatch.setattr(chip_smoke, "dry_cell", dry_cell)
    recs = chip_smoke.dry_records()
    assert set(recs) == {f"phase {p} train step"
                         for p in ("14", "C", "G", "I", "K")} | {
        f"phase {p} {what}" for p in ("7", "11")
        for what in ("prefill call", "engine step")} | {
        f"phase {p} {what}" for p in chip_smoke.DECODE_32K_BATCH
        for what in ("prefill_32k call", "decode_32k step")}
    assert ("hymba-1.5b", 16, "train", 4096, 2) in calls
    assert ("whisper-tiny", 4, "train", 4096, 2) in calls
    assert not any(name.startswith("xlstm") for name, *_ in calls)


def _rec(flops, peak, calls=None):
    return {"flops_per_device": float(flops), "bytes_per_device": 3.35e9,
            "collective_bytes_per_device": {"total": 0.0},
            "memory": {"argument_bytes": peak, "temp_bytes": 0,
                       "output_bytes": 0, "alias_bytes": 0},
            "kernel_calls": calls or {}, "lower_s": 0.5, "compile_s": 1.0}


def test_phase_h_holds_each_counted_training_phase():
    """``check_dryrun`` on made-up runs and records: equal flops and peaks
    pass, phase J is reported as skipped, and a flop count or a peak off
    in phase I or K is a miss."""
    train = {"step_flops": 100, "peak_GB": 10.0, "ms_per_step": 2.0,
             "seq": 4096}
    serve = {"after_prefill": {"flash_attention": 2, "flash_decode": 0},
             "launches": {"flash_attention": 2, "flash_decode": 6},
             "prefill_calls": 2, "engine_steps": 3,
             "prefill_ms_per_call": 1.0, "ms_per_engine_step": 1.0}
    recs = {name: _rec(100, 10 ** 10) for name in (
        "phase 14 train step", "phase C train step", "phase G train step",
        "phase I train step", "phase K train step")}
    for p in ("7", "11"):
        recs[f"phase {p} prefill call"] = _rec(1, 1, {"flash_attention": 1})
        recs[f"phase {p} engine step"] = _rec(1, 1, {"flash_decode": 2})
    family = {p: {"run": dict(train)} for p in ("I", "J", "K")}
    out = chip_smoke.check_dryrun(serve, serve, train, {"run": train},
                                  {"run": train}, family, recs)
    assert out["phase J train step"] == "not counted"
    assert out["phase I train step"]["peak_ratio"] == 1.0
    assert out["phase K train step roofline"]["share_of_bound"] == (
        pytest.approx(0.5))
    assert out["count_s"] == pytest.approx(1.5 * len(recs))
    for bad in ({"step_flops": 101}, {"peak_GB": 13.0}):
        for p in ("I", "K"):
            runs = dict(family, **{p: {"run": dict(train, **bad)}})
            with pytest.raises(AssertionError, match=f"phase {p}"):
                chip_smoke.check_dryrun(serve, serve, train, {"run": train},
                                        {"run": train}, runs, recs)
