"""``chip_smoke.py``'s phases L-O and its prefill_32k and decode_32k cells,
rehearsed on the CPU (the kernels' plain versions, so no launch): the
serving drivers on each config's narrow twin (``tests/_torch_cells.py``)
with the cells at a small sequence; the launches each cell must make on
the card against the committed dry run's ``kernel_calls``
(``results/dryrun_torch.jsonl``) scaled to the depth run; the decode_32k
batches against the card's memory; the new path shapes in phases 6, 9,
10 and 16; phase H's records and checks of the cells; and every phase,
size and tolerance that was there before, unchanged."""

import json
import math
from pathlib import Path

import pytest
import torch

import chip_smoke
from _torch_cells import NARROW, narrow
from repro_torch.models.params import count_params

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# phase -> the reference config whose cells it runs
CELL_ARCHS = {"7": "qwen3_4b", "11": "grok_1_314b",
              **{p: arch for p, (arch, _, _) in
                 chip_smoke.CONFIG_PHASES.items()}}
SERVE = dict(n_prompts=5, prompt_len=10, prefill_b=2, prefill_s=40,
             slots=4, max_seq=16, new_tokens=4, n_prefill=2)


def _committed(arch, shape):
    recs = [json.loads(line) for line in
            (ROOT / "results" / "dryrun_torch.jsonl").read_text().splitlines()
            if line.strip()]
    found = [r for r in recs if r["arch"] == arch and r["shape"] == shape]
    assert {r["mesh"] for r in found} == {"16x16", "2x16x16"}
    assert all(r["kernel_calls"] == found[0]["kernel_calls"] for r in found)
    return found[0]["kernel_calls"]


@pytest.mark.parametrize("phase", sorted(chip_smoke.CONFIG_PHASES))
def test_config_phases_rehearse_on_cpu(phase):
    """Phases L-O on the CPU at each config's narrow twin: prompts over the
    simulated WAN, the prefill (InternVL2's with its patches), two waves of
    continuous batching, both 32k cells at a 48-token sequence, no kernel
    launched, and the f32 check (CPU against CPU) at zero."""
    arch = chip_smoke.CONFIG_PHASES[phase][0]
    cfg = narrow(chip_smoke.get_arch(arch))
    check = dict(n_layers=2, prefill_len=24, n_steps=4, slots=4, max_seq=16)
    out = chip_smoke.drive_family(CPU, cfg, SERVE, check,
                                  cells=dict(decode_batch=2, seq=48))
    run = out["run"]
    assert run["engine_steps"] == 2 * (10 + 4 - 1) and run["tokens"] == 20
    assert not any(run["launches"].values())
    assert out["f32"] == {"prefill_max_abs_diff": 0.0,
                          "decode_max_abs_diff": 0.0}
    prefill, decode = run["cells"]["prefill_32k"], run["cells"]["decode_32k"]
    assert (prefill["runs"], prefill["batch"], prefill["seq"]) == (2, 1, 48)
    assert (decode["runs"], decode["batch"], decode["first_pos"]) == (4, 2,
                                                                      44)
    for cell in (prefill, decode):
        assert not any(cell["launches"].values()) and cell["ms"] > 0
        assert cell["cuts"]["layers"] == \
            f"2 of {chip_smoke.get_arch(arch).n_layers} layers"
    assert prefill["cuts"]["batch"] == "32 -> 1"
    assert decode["cuts"]["batch"] == "128 -> 2"


def test_moe_cells_rehearse_on_cpu():
    """Grok-1's cells at its smoke config: a 1024-token prefill_32k (two
    MoE chunks) and decode_32k at a batch of 3, through ``drive_cells``."""
    cfg = chip_smoke.get_arch("grok_1_314b").smoke_config()
    model = chip_smoke.build_model(cfg, device=CPU)
    params = model.init(torch.Generator().manual_seed(0))
    out = chip_smoke.drive_cells(model, params, decode_batch=3, seq=1024)
    assert out["prefill_32k"]["runs"] == 2 and out["decode_32k"]["runs"] == 4
    assert len(out["decode_32k"]["ms_all"]) == 4
    assert not any(n for cell in out.values()
                   for n in cell["launches"].values())


def test_32k_kernel_checks_rehearse_on_cpu(monkeypatch):
    """Phase 6's 32k checks on the CPU at small shapes of the same head
    layouts: the plain version against itself one kv group at a time (G
    = 7, and one over four kv heads), and decode at lengths 1, T // 3, T
    and ragged."""
    monkeypatch.setattr(chip_smoke, "FLASH_32K_CASES", [
        (1, 14, 2, 96, 16), (1, 4, 4, 80, 32)])
    monkeypatch.setattr(chip_smoke, "DECODE_32K_CASES", [
        (2, 2, 7, 200, 16), (8, 4, 1, 130, 32)])
    assert chip_smoke.check_attention_32k(CPU) == {"flash_attention": 0.0,
                                                   "flash_decode": 0.0}


@pytest.mark.parametrize("shape", chip_smoke.FLASH_32K_CASES)
def test_32k_attention_grid_takes_every_item_once(shape):
    """At 32k the bf16 attention kernel's persistent grid (256 query
    blocks a head) covers every (query block, head) item once, each CTA
    heaviest first and within one heaviest item of the others' causal
    work; its item count and the tensors' element counts fit the 32-bit
    ints the kernel indexes with, and its tensor maps take the model's
    (B, S, H, D) layout in place."""
    fa = chip_smoke.flash_attention
    B, H, K, S, D = shape
    ctas = fa.plan(B, H, S, D, torch.bfloat16).grid[0]
    per_cta = fa.work_items(S, B * H, ctas)
    n_qb = S // fa.BLOCK_Q
    assert n_qb == 256 and ctas == fa.SMS and all(per_cta)
    assert sorted(it for items in per_cta for it in items) == [
        (qb, bh) for qb in range(n_qb) for bh in range(B * H)]
    for items in per_cta:
        assert [qb for qb, _ in items] == sorted(
            (qb for qb, _ in items), reverse=True)
    work = [sum(qb + 1 for qb, _ in items) for items in per_cta]
    assert max(work) - min(work) <= n_qb
    assert n_qb * B * H < 2 ** 31 and B * S * H * D < 2 ** 31
    for N, rows in ((H, fa.BLOCK_Q), (K, fa.BLOCK_KV)):
        x = torch.empty((B, S, N, D), dtype=torch.bfloat16,
                        device="meta").transpose(1, 2)
        layout = fa.tma_layout(x, rows)
        assert tuple(layout[:4]) == (D, S, N, B)
        assert tuple(layout[4:7]) == (N * D * 2, D * 2, S * N * D * 2)


def test_config_phases_serve_each_config_at_full_width():
    """Qwen3-14B, StableLM and InternVL2 whole, Yi-34B at 30 of 60 layers,
    each at its published widths, bf16, through phase 13's sizes; their
    f32 checks at 2 layers, InternVL2's past its 256 patches."""
    want = {"L": ("dense", 40, 40, 5120, 40, 8, 128, 151936),
            "M": ("dense", 30, 60, 7168, 56, 8, 128, 64000),
            "N": ("dense", 24, 24, 2048, 32, 32, 64, 100352),
            "O": ("vlm", 24, 24, 2048, 16, 8, 128, 92553)}
    for phase, (arch, layers, check) in chip_smoke.CONFIG_PHASES.items():
        cfg = chip_smoke.serving_config(phase)
        full = chip_smoke.get_arch(arch)
        assert (cfg.family, cfg.n_layers, full.n_layers, cfg.d_model,
                cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                cfg.vocab) == want[phase]
        assert cfg.dtype == "bfloat16" and check["n_layers"] == \
            chip_smoke.CHECK_LAYERS
    # Yi-34B whole would not leave room for a cache (derived)
    yi = chip_smoke.get_arch("yi_34b")
    whole = 2 * count_params(chip_smoke.build_model(
        yi, device=CPU).param_specs())
    assert whole / 1e9 == pytest.approx(67.9, abs=0.1)
    assert whole > (1 - chip_smoke.CARD_FREE) * chip_smoke.CARD_GB * 1e9
    vlm = chip_smoke.serving_config("O")
    check = chip_smoke.CONFIG_PHASES["O"][2]
    serve = chip_smoke.KIMI_SERVE
    assert vlm.n_patches == 256 < check["prefill_len"] <= (
        serve["n_prompts"] * serve["prompt_len"])


@pytest.mark.parametrize("phase", sorted(CELL_ARCHS))
def test_cell_launches_are_the_committed_dry_runs(phase):
    """Per prefill_32k call and decode_32k step: at full depth, exactly the
    committed records' kernel calls; at the depth run, those scaled by
    its share of the layers (Grok-1's prefill_32k {64, 12288} -> {4,
    768} at 4 of 64 layers)."""
    arch = CELL_ARCHS[phase]
    full, run = chip_smoke.get_arch(arch), chip_smoke.serving_config(phase)
    for kind, shape in (("prefill", "prefill_32k"), ("decode", "decode_32k")):
        committed = _committed(arch, shape)
        assert chip_smoke.cell_launches(full, kind, 32768) == committed
        scaled = {k: n * run.n_layers // full.n_layers
                  for k, n in committed.items()}
        assert all(n * run.n_layers % full.n_layers == 0
                   for n in committed.values())
        assert chip_smoke.cell_launches(run, kind, 32768) == scaled
    if phase == "11":
        assert chip_smoke.cell_launches(run, "prefill", 32768) == {
            "flash_attention": 4, "grouped_matmul": 768}


@pytest.mark.parametrize("phase", sorted(CELL_ARCHS))
def test_decode_32k_batches_leave_a_fifth_of_the_card(phase):
    """The reference's 128 halved until bf16 weights and one 32k cache a
    slot leave 20% of 80 GB free: 8 for Qwen3-4B (4.8 GB a slot) and 4
    for Qwen3-14B (5.4 GB a slot), derived."""
    cfg = chip_smoke.serving_config(phase)
    batch = chip_smoke.DECODE_32K_BATCH[phase]
    assert chip_smoke.decode_32k_batch(cfg) == batch
    weights = 2 * count_params(chip_smoke.build_model(
        cfg, device=CPU).param_specs())
    slot = 4 * cfg.n_layers * 32768 * cfg.n_kv_heads * cfg.resolved_head_dim
    budget = 0.8 * 80e9
    assert weights + batch * slot <= budget < weights + 2 * batch * slot
    assert 128 % batch == 0
    if phase in ("7", "L"):
        assert (batch, round(slot / 1e9, 1)) == {"7": (8, 4.8),
                                                 "L": (4, 5.4)}[phase]


def test_new_path_shapes_are_checked_and_timed():
    """Phase 6 checks, and phase 9 times, each cell's attention at 32k
    (B = 1) and decode at 32k and its batch, and phases L-O's serving and
    f32 check shapes (G = 5, 7, 1 over 32 kv heads at D = 64, and 2);
    phases 10 and 16 take Grok-1's prefill_32k chunk (C = 160) and its
    decode_32k step (C = 32), each with its down projection."""
    bf16, f32 = torch.bfloat16, torch.float32
    decode_timed = {s for _, s in chip_smoke.TIME_DECODES}
    attn_timed = {s for _, s in chip_smoke.TIME_ATTENTION}
    flash_path = set(chip_smoke.FLASH_PATH_CASES)
    decode_path = set(chip_smoke.DECODE_PATH_CASES)
    for phase, batch in chip_smoke.DECODE_32K_BATCH.items():
        c = chip_smoke.serving_config(phase)
        H, K, D = c.n_heads, c.n_kv_heads, c.resolved_head_dim
        assert (1, H, K, 32768, D) in chip_smoke.FLASH_32K_CASES
        assert (batch, K, H // K, 32768, D) in chip_smoke.DECODE_32K_CASES
        assert (batch, K, H // K, 32768, D) in decode_timed
    assert len(chip_smoke.FLASH_32K_CASES) == len(
        chip_smoke.DECODE_32K_CASES) == 6
    assert {s for _, s in chip_smoke.TIME_ATTENTION_32K} == {
        (1, 32, 8, 32768, 128), (1, 56, 8, 32768, 128),
        (1, 32, 32, 32768, 64)}
    serve = chip_smoke.KIMI_SERVE
    steps = serve["prompt_len"] + serve["new_tokens"] - 1
    for phase, (_, _, check) in chip_smoke.CONFIG_PHASES.items():
        c = chip_smoke.serving_config(phase)
        H, K, D = c.n_heads, c.n_kv_heads, c.resolved_head_dim
        prefill = (serve["prefill_b"], H, K, serve["prefill_s"], D)
        assert (prefill, bf16) in flash_path and prefill in attn_timed
        decode = (serve["slots"], K, H // K, serve["max_seq"], D)
        assert (decode, bf16) in decode_path and decode in decode_timed
        assert abs(chip_smoke.DECODE_LIVE[decode] - steps / 2) <= 1
        assert ((chip_smoke.SLOTS, K, H // K, chip_smoke.CHECK_MAX_SEQ, D),
                f32) in decode_path
        assert (1, H, K, check.get("prefill_len", chip_smoke.CHECK_PREFILL),
                D) in chip_smoke.FLASH_CONFIG_F32_CASES
    assert {G for (_, _, G, _, _), dt in chip_smoke.DECODE_PATH_CASES
            if dt == bf16} >= {5, 7, 1, 2}
    assert (8, 32, 1, 1024, 64) in {s for s, _ in
                                    chip_smoke.DECODE_PATH_CASES}
    grok = chip_smoke.serving_config("11")
    E, d, f = grok.n_experts, grok.d_model, grok.d_ff
    C = math.ceil(512 * grok.top_k * grok.capacity_factor / E)
    slots = chip_smoke.DECODE_32K_BATCH["11"]
    gmm_path = {s for s, dt in chip_smoke.GMM_PATH_CASES if dt == bf16}
    gmm_timed = {s for _, s, _, _ in chip_smoke.TIME_GMM}
    for shape in ((E, C, d, f), (E, C, f, d), (E, slots, d, f),
                  (E, slots, f, d)):
        assert shape in gmm_path and shape in gmm_timed
    assert C == 160 and chip_smoke.n_chunks(32768) == 64


def test_existing_phases_and_tolerances_are_unchanged():
    """The tolerances, sizes and case lists phases 1-17 and A-K had before
    phases L-O and the 32k cells, and those the six cells had before the
    cells of phases 13, D, E and F: the new cases only add to them."""
    c = chip_smoke
    assert c.TOL == {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    assert c.FLASH_PATH_TOL == (2 ** -6, 2 ** -5)
    assert c.GMM_TOL == {torch.float32: (1e-4, 1e-4),
                         torch.bfloat16: (5e-2, 5e-1)}
    assert c.GMM_PATH_TOL == {torch.float32: (1e-4, 1e-4),
                              torch.bfloat16: (2 ** -6, 1e-3)}
    assert (c.CHECK_TOL, c.PEAK_TOL) == (1e-3, 0.2)
    assert (c.CHECK_LAYERS, c.CHECK_PREFILL, c.CHECK_STEPS,
            c.CHECK_MAX_SEQ) == (2, 256, 8, 256)
    assert (c.N_PROMPTS, c.PROMPT_LEN, c.PREFILL_B, c.PREFILL_S, c.SLOTS,
            c.MAX_SEQ, c.NEW_TOKENS, c.N_PREFILL) == (16, 128, 4, 2048, 8,
                                                      4096, 32, 3)
    assert c.KIMI_SERVE == dict(n_prompts=8, prompt_len=64, prefill_b=2,
                                prefill_s=2048, slots=8, max_seq=1024,
                                new_tokens=16, n_prefill=2)
    assert c.MOE_SERVE == dict(c.KIMI_SERVE, n_prompts=16)
    assert (c.MOE_LAYERS, c.KIMI_LAYERS, c.MOE_CHECK_D_FF,
            c.KIMI_CHECK_D_FF) == (4, 1, 2048, 256)
    assert list(c.FAMILY_PHASES) == ["D", "E", "F"]
    assert list(c.FAMILY_TRAIN) == ["I", "J", "K"]
    assert c.FAMILY_TRAIN_LAYERS == {"hymba_1_5b": 16, "xlstm_350m": 4}
    assert (c.TRAIN_B, c.TRAIN_S, c.TRAIN_STEPS) == (2, 4096, 3)
    assert c.FLASH_PATH_CASES[:5] == [
        ((4, 32, 8, 2048, 128), torch.bfloat16),
        ((1, 32, 8, 256, 128), torch.float32),
        ((2, 48, 8, 2048, 128), torch.bfloat16),
        ((2, 64, 8, 2048, 112), torch.bfloat16),
        ((1, 64, 8, 256, 112), torch.float32)]
    assert len(c.FLASH_CASES) == 8 and len(c.FLASH_CROSS_CASES) == 4
    assert len(c.FLASH_F32_EDGES) == 8 and len(c.DECODE_CASES) == 7
    assert len(c.FLASH_MASK_PATH_CASES) == 8
    assert [s for s, _ in c.DECODE_PATH_CASES[:11]] == [
        (8, 8, 4, 4096, 128), (8, 8, 4, 256, 128), (8, 8, 6, 1024, 128),
        (8, 8, 8, 1024, 112), (8, 8, 8, 256, 112), (8, 5, 5, 1024, 64),
        (1, 5, 5, 1024, 64), (8, 6, 1, 448, 64), (8, 6, 1, 1500, 64),
        (8, 6, 1, 448, 64), (8, 6, 1, 1500, 64)]
    assert {s: n for s, n in c.DECODE_LIVE.items() if s[2] in (4, 6, 8)
            or s[1] in (5, 6)} == {
        (8, 8, 4, 4096, 128): 160, (8, 8, 6, 1024, 128): 80,
        (8, 8, 8, 1024, 112): 40, (8, 5, 5, 1024, 64): 160,
        (8, 6, 1, 448, 64): 95, (8, 6, 1, 1500, 64): 1500}
    assert c.DECODE_REPEAT_CASES == [(16, 8, 4, 32768, 128),
                                     (8, 8, 4, 4096, 128)]
    assert [s for s, _ in c.GMM_PATH_CASES[:11]] == [
        c.GMM_DECODE, c.GMM_DECODE_DOWN, c.GMM_PREFILL, c.GMM_PREFILL_DOWN,
        c.KIMI_GMM_DECODE, c.KIMI_GMM_DECODE_DOWN, c.KIMI_GMM_PREFILL,
        c.KIMI_GMM_PREFILL_DOWN, c.GMM_DECODE, c.GMM_PREFILL,
        c.GMM_PREFILL_DOWN]
    assert [name for name, *_ in c.TIME_GMM[:8]] == [
        "decode", "decode down", "prefill", "prefill down", "kimi decode",
        "kimi decode down", "kimi prefill", "kimi prefill down"]
    # Grok-1's one-row chunk moved onto the path (prefill_32k), still
    # checked and timed; Kimi-K2's four rows stay off it.
    assert c.GMM_OFF_PATH == [("kimi prefill b4", (384, 56, 7168, 2048),
                               3, 3)]
    assert ("prefill b1", (8, 160, 6144, 32768), 5, 5) in c.TIME_GMM
    assert c.GMM_REPEAT_CASES == [(8, 8, 32768, 6144), (384, 8, 2048, 7168)]
    assert [name for name, _ in c.TIME_ATTENTION[:3]] == [
        "flash_attention", "flash_attention grok", "flash_attention kimi"]
    assert [name for name, _ in c.TIME_DECODES[:7]] == [
        "flash_decode", "flash_decode serving", "flash_decode grok",
        "flash_decode kimi", "flash_decode hymba",
        "flash_decode whisper self", "flash_decode whisper cross"]
    assert len(c.TIME_ATTENTION_F32) == 8
    # The cells of phases 13, D, E and F, their shapes and the f32 workers
    # add only to what the six cells had.
    assert c.DECODE_32K_BATCH == {"7": 8, "11": 32, "L": 4, "M": 4, "N": 8,
                                  "O": 16}
    assert (c.SEQ_32K, c.PREFILL_32K_CALLS, c.DECODE_32K_STEPS, c.CARD_GB,
            c.CARD_FREE) == (32768, 2, 4, 80, 0.2)
    assert c.FAMILY_CELL_BATCH == {"13": 128, "D": 128, "E": 128, "F": 128}
    assert (c.LONG_500K, c.LONG_CELL_PHASES, c.CELL_PREFILL_LAYERS,
            c.WARM_STEPS) == (524288, ("D", "E"), {"E": 2}, 32)
    assert (c.PLAIN_SCORES_BYTES, c.DECODE_TIME_BIG, c.F32_QUEUED) == (
        32e9, 5e9, 8)
    assert len(c.FLASH_32K_CASES) == len(c.DECODE_32K_CASES) == 6
    assert (len(c.FLASH_32K_FAMILY_CASES),
            len(c.DECODE_32K_FAMILY_CASES)) == (4, 5)
    assert [s for s, _ in c.GMM_PATH_CASES[11:15]] == [
        c.GMM_PREFILL_B1, c.GMM_PREFILL_B1_DOWN, c.GMM_DECODE_32K,
        c.GMM_DECODE_32K_DOWN]
    assert [s for s, _ in c.GMM_PATH_CASES[15:]] == [
        c.KIMI_GMM_PREFILL_B1, c.KIMI_GMM_PREFILL_B1_DOWN,
        c.KIMI_GMM_DECODE_32K, c.KIMI_GMM_DECODE_32K_DOWN]
    assert [name for name, *_ in c.TIME_GMM[8:]] == [
        "prefill b1", "prefill b1 down", "decode 32k", "decode 32k down",
        "kimi prefill b1", "kimi prefill b1 down", "kimi decode 32k",
        "kimi decode 32k down"]
    assert [name for name, _ in c.TIME_DECODES[7:]] == [
        "flash_decode qwen3-14b", "flash_decode yi", "flash_decode stablelm",
        "flash_decode internvl2"] + [
        f"flash_decode 32k {n}" for n in ("qwen3-4b", "grok", "qwen3-14b",
                                          "yi", "stablelm", "internvl2",
                                          "kimi", "hymba")] + [
        "flash_decode long_500k hymba", "flash_decode 32k whisper self",
        "flash_decode 32k whisper cross"]
    assert [name for name, _ in c.TIME_ATTENTION_32K] == [
        "flash_attention 32k", "flash_attention 32k yi",
        "flash_attention 32k stablelm"]


def test_phase_h_records_the_cells(monkeypatch):
    """Phase H's dry run counts each cell at the depth and batch the card
    runs: prefill_32k at one row, decode_32k at its batch and pos
    32767."""
    calls = []

    def dry_cell(cfg, kind, seq, batch, **kw):
        calls.append((cfg.name, cfg.n_layers, kind, seq, batch,
                      kw.get("decode_pos")))
        return kind

    monkeypatch.setattr(chip_smoke, "dry_cell", dry_cell)
    recs = chip_smoke.dry_records()
    for phase, batch in chip_smoke.DECODE_32K_BATCH.items():
        cfg = chip_smoke.serving_config(phase)
        assert recs[f"phase {phase} prefill_32k call"] == "prefill"
        assert recs[f"phase {phase} decode_32k step"] == "decode"
        assert (cfg.name, cfg.n_layers, "prefill", 32768, 1, None) in calls
        assert (cfg.name, cfg.n_layers, "decode", 32768, batch,
                32767) in calls
    assert ("yi-34b", 30, "decode", 32768, 4, 32767) in calls


def _rec(calls):
    return {"flops_per_device": 100.0, "bytes_per_device": 3.35e9,
            "collective_bytes_per_device": {"total": 0.0},
            "memory": {"argument_bytes": 1, "temp_bytes": 0,
                       "output_bytes": 0, "alias_bytes": 0},
            "kernel_calls": calls, "lower_s": 0.5, "compile_s": 1.0}


def test_phase_h_holds_each_cell():
    """``check_dryrun`` on made-up cells: launches equal to the record's
    calls times the runs pass and are timed against the roofline; a
    stray launch is a miss that names the cell."""
    train = {"step_flops": 100, "peak_GB": 1e-9, "ms_per_step": 2.0,
             "seq": 4096}
    serve = {"after_prefill": {"flash_attention": 2, "flash_decode": 0},
             "launches": {"flash_attention": 2, "flash_decode": 6},
             "prefill_calls": 2, "engine_steps": 3,
             "prefill_ms_per_call": 1.0, "ms_per_engine_step": 1.0}
    recs = {name: _rec({}) for name in (
        "phase 14 train step", "phase C train step", "phase G train step",
        "phase I train step", "phase K train step")}
    for p in ("7", "11"):
        recs[f"phase {p} prefill call"] = _rec({"flash_attention": 1})
        recs[f"phase {p} engine step"] = _rec({"flash_decode": 2})
    recs["phase L prefill_32k call"] = _rec({"flash_attention": 40})
    recs["phase L decode_32k step"] = _rec({"flash_decode": 40})
    cell = {"prefill_32k": {"launches": {"flash_attention": 80,
                                         "flash_decode": 0},
                            "runs": 2, "batch": 1, "ms": 4.0,
                            "cuts": {"batch": "32 -> 1"}},
            "decode_32k": {"launches": {"flash_decode": 160}, "runs": 4,
                           "batch": 4, "ms": 2.0,
                           "cuts": {"batch": "128 -> 4"}}}
    family = {p: {"run": dict(train)} for p in ("I", "J", "K")}
    args = (serve, serve, train, {"run": train}, {"run": train}, family,
            recs)
    out = chip_smoke.check_dryrun(*args, {"L": cell})
    assert out["phase L decode_32k step"]["runs"] == 4
    assert out["phase L prefill_32k call roofline"]["share_of_bound"] == \
        pytest.approx(1.0 / 4.0)
    bad = dict(cell, decode_32k=dict(cell["decode_32k"], launches={
        "flash_decode": 161}))
    with pytest.raises(AssertionError, match="phase L decode_32k step"):
        chip_smoke.check_dryrun(*args, {"L": bad})


def test_narrow_twins_cover_the_four_configs():
    assert set(NARROW) == {arch for arch, _, _ in
                           chip_smoke.CONFIG_PHASES.values()}
