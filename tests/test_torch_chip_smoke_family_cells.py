"""``chip_smoke.py``'s cells of Kimi-K2, Hymba-1.5B, xLSTM-350M and
Whisper-tiny (phases 13, D, E and F: prefill_32k, decode_32k, and
long_500k for Hymba and xLSTM) and its f32 workers, rehearsed on the CPU
(the kernels' plain versions, so no launch): the generalised
``drive_cells`` on each config's narrow twin (``tests/_torch_cells.py``)
at a small sequence, each family's position at its end; the launches each
cell must make on the card against the committed dry run's
``kernel_calls`` (``results/dryrun_torch.jsonl``) scaled to the depth run;
the decode_32k batches from each family's own cache; the new shapes in
phases 6, 9, 10 and 16, and the plain attention cut into pieces of heads
equal to the whole; phase H's records and checks of the cells, with
xLSTM's prefill_32k not counted; and the f32 checks' CPU sides in a
worker process: the in-line results, and a worker that raises, dies or
misses ``CHECK_TOL`` failing the check."""

import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from _torch_cells import FAMILY_NARROW, narrow_family
from repro_torch.models.params import count_params

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# phase -> the reference config whose cells it runs
FAMILY_ARCHS = {"13": "kimi_k2_1t_a32b", "D": "hymba_1_5b",
                "E": "xlstm_350m", "F": "whisper_tiny"}
SERVE = dict(n_prompts=5, prompt_len=10, prefill_b=2, prefill_s=40,
             slots=4, max_seq=64, new_tokens=4, n_prefill=2)


def _committed(arch, shape):
    recs = [json.loads(line) for line in
            (ROOT / "results" / "dryrun_torch.jsonl").read_text().splitlines()
            if line.strip()]
    found = [r for r in recs if r["arch"] == arch and r["shape"] == shape]
    assert {r["mesh"] for r in found} == {"16x16", "2x16x16"}
    assert all(r["kernel_calls"] == found[0]["kernel_calls"] for r in found)
    return found[0]["kernel_calls"]


def _twin(phase, n_layers=2):
    cfg = narrow_family(chip_smoke.get_arch(FAMILY_ARCHS[phase]))
    return cfg.scaled(n_layers=n_layers)


@pytest.mark.parametrize("phase", sorted(FAMILY_ARCHS))
def test_family_phases_with_their_cells_rehearse_on_cpu(phase):
    """Phases 13, D, E and F on the CPU at each config's narrow twin
    (xLSTM's at two pairs, so that its prefill_32k runs the first):
    prompts over the simulated WAN, the prefill (Whisper's with its
    frames), two waves of continuous batching, the cells at a 96-token
    sequence (long_500k at 4096 for Hymba and xLSTM), no kernel
    launched, each decode cell ending at its family's own position, and
    the f32 check (CPU against CPU) at zero."""
    cfg = _twin(phase, 4 if phase == "E" else 2)
    sizes = dict(chip_smoke.cell_sizes(phase), decode_batch=2, seq=96,
                 warm_steps=3)
    if "long_seq" in sizes:
        sizes["long_seq"] = 4096
    check = dict(n_layers=2, prefill_len=24, n_steps=4, slots=4, max_seq=64)
    out = chip_smoke.drive_family(CPU, cfg, SERVE, check, cells=sizes)
    run = out["run"]
    assert run["engine_steps"] == 2 * (10 + 4 - 1) and run["tokens"] == 20
    assert not any(run["launches"].values())
    assert out["f32"] == {"prefill_max_abs_diff": 0.0,
                          "decode_max_abs_diff": 0.0}
    cells = run["cells"]
    full = chip_smoke.get_arch(FAMILY_ARCHS[phase]).n_layers
    assert set(cells) == {"prefill_32k", "decode_32k"} | (
        {"long_500k"} if phase in chip_smoke.LONG_CELL_PHASES else set())
    prefill = cells["prefill_32k"]
    assert (prefill["runs"], prefill["batch"], prefill["seq"]) == (2, 1, 96)
    layers = 2 if phase == "E" else cfg.n_layers
    assert prefill["cuts"] == {"batch": "32 -> 1",
                               "layers": f"{layers} of {full} layers"}
    position = None if phase == "E" else 96
    decode = cells["decode_32k"]
    assert (decode["runs"], decode["batch"], decode["first_pos"],
            decode["position"]) == (4, 2, 92, position)
    assert decode["cuts"] == {"batch": "128 -> 2",
                              "layers": f"{cfg.n_layers} of {full} layers"}
    if phase in chip_smoke.LONG_CELL_PHASES:
        long = cells["long_500k"]
        assert (long["runs"], long["batch"], long["first_pos"],
                long["position"]) == (4, 1, 4092,
                                      None if phase == "E" else 4096)
        assert long["cuts"] == {"layers": f"{cfg.n_layers} of {full} layers"}
    for cell in cells.values():
        assert not any(cell["launches"].values()) and cell["ms"] > 0


def test_seed_cache_brings_recurrent_states_through_the_model():
    """Hymba's Mamba state and xLSTM's states come from serve steps
    (nonzero, finite), K and V from the generator (Whisper's cross cache
    too), each position at seq - steps; a dense cache takes no warm
    step."""
    gen = torch.Generator().manual_seed(0)
    for phase, state_keys in (("D", {"mamba"}), ("E", {"mlstm", "slstm"}),
                              ("F", set()), ("13", set())):
        model = chip_smoke.build_model(_twin(phase), device=CPU)
        params = model.init(torch.Generator().manual_seed(0))
        cache = chip_smoke.seed_cache(model, params, 2, 64, 4, 3, gen)
        assert chip_smoke.cache_positions(cache) in ([], [60])
        states = chip_smoke.recurrent_state(cache)
        assert bool(states) == bool(state_keys)
        assert all(torch.isfinite(t).all() and t.abs().max() > 0
                   for t in states)
        kv = chip_smoke.kv_caches(cache)
        assert len(kv) == {"D": 1, "E": 0, "F": 2, "13": 1}[phase]
        assert all(float(d[n].std()) > 0.5 for d in kv for n in "kv")


def test_cut_depth_takes_the_first_layers_in_place():
    model = chip_smoke.build_model(_twin("E", 4), device=CPU)
    params = model.init(torch.Generator().manual_seed(0))
    cut, cut_params = chip_smoke.cut_depth(model, params, 2)
    assert cut.cfg.n_layers == 2 and cut.n_pairs == 1
    leaf = params["pairs"]["mlstm"]["wq"]
    assert cut_params["pairs"]["mlstm"]["wq"].shape[0] == 1
    assert cut_params["pairs"]["mlstm"]["wq"].data_ptr() == leaf.data_ptr()
    assert cut_params["embed"]["embedding"] is params["embed"]["embedding"]


@pytest.mark.parametrize("phase", sorted(FAMILY_ARCHS))
def test_family_cell_launches_are_the_committed_dry_runs(phase):
    """Per prefill_32k call and decode_32k or long_500k step: at full
    depth, exactly the committed records' kernel calls; at the depth run,
    those scaled by its share of the layers (Kimi-K2's prefill_32k {61,
    11712} -> {1, 192} at 1 of 61 layers; xLSTM none at any depth)."""
    arch = FAMILY_ARCHS[phase]
    full, run = chip_smoke.get_arch(arch), chip_smoke.serving_config(phase)
    shapes = [("prefill", "prefill_32k", 32768),
              ("decode", "decode_32k", 32768)]
    if phase in chip_smoke.LONG_CELL_PHASES:
        shapes.append(("decode", "long_500k", chip_smoke.LONG_500K))
    for kind, shape, seq in shapes:
        committed = _committed(arch, shape)
        assert chip_smoke.cell_launches(full, kind, seq) == committed
        assert chip_smoke.cell_launches(run, kind, seq) == {
            k: n * run.n_layers // full.n_layers for k, n in committed.items()}
    if phase == "13":
        assert chip_smoke.cell_launches(run, "prefill", 32768) == {
            "flash_attention": 1, "grouped_matmul": 192}
        assert chip_smoke.cell_launches(run, "decode", 32768) == {
            "flash_decode": 1, "grouped_matmul": 3}
    if phase == "E":
        cut = run.scaled(n_layers=chip_smoke.CELL_PREFILL_LAYERS["E"])
        assert chip_smoke.cell_launches(cut, "prefill", 32768) == {}
    if phase == "F":
        assert chip_smoke.cell_launches(run, "prefill", 32768) == {
            "flash_attention": 4 + 2 * 4}


@pytest.mark.parametrize("phase", sorted(FAMILY_ARCHS))
def test_family_decode_32k_batches_from_their_caches(phase):
    """decode_32k_batch reads each family's own cache: Kimi-K2's 117 MB a
    slot beside 36.4 GB of weights, Hymba's 1024-slot ring and its Mamba
    state (45.5 MB), xLSTM's states (12.8 MB), Whisper's 32,768-token
    self cache and 1500-frame cross cache (210.5 MB): the reference's 128
    for all four, under 80% of the card (derived)."""
    cfg = chip_smoke.serving_config(phase)
    model = chip_smoke.build_model(cfg, device=CPU)
    weights = 2 * count_params(model.param_specs())
    slot = chip_smoke.cache_bytes(model.cache_specs(1, 32768))
    assert round(slot / 1e6, 1) == {"13": 117.4, "D": 45.5, "E": 12.8,
                                    "F": 210.5}[phase]
    batch = chip_smoke.FAMILY_CELL_BATCH[phase]
    assert chip_smoke.decode_32k_batch(cfg) == batch == 128
    assert weights + batch * slot <= 0.8 * 80e9
    if phase == "13":
        assert round(weights / 1e9, 1) == 36.4
        assert round((weights + batch * slot) / 1e9, 1) == 51.4
    if phase == "D":
        c = cfg
        ring = 4 * c.n_layers * c.window * c.n_kv_heads * c.resolved_head_dim
        mamba = c.n_layers * c.d_model * (4 * c.ssm_state + 2 * 3)
        assert slot == ring + mamba


def test_family_shapes_are_checked_and_timed():
    """Phase 6 checks, and phase 9 times, each family cell's attention at
    32k (Kimi-K2 at G = 8 and D = 112, Hymba's window, Whisper's decoder
    and its cross-attention over 1500 frames) and its decode at its batch
    (Hymba's ring at 128 slots and at long_500k's one); phases 10 and 16
    take Kimi-K2's one-row prefill chunk and its 128-slot step, each with
    its down projection, C from ``models/moe.py``'s capacity."""
    attention = set()
    decode = set()
    for phase, batch in chip_smoke.FAMILY_CELL_BATCH.items():
        c = chip_smoke.serving_config(phase)
        if c.family == "ssm":
            continue
        H, K, D = c.n_heads, c.n_kv_heads, c.resolved_head_dim
        attention.add(((1, H, K, 32768, 32768, D), True, c.window))
        T = min(c.window or 32768, 32768)
        decode.add((batch, K, H // K, T, D))
        if c.family == "audio":
            attention.add(((1, H, K, 32768, c.enc_frames, D), False, 0))
            decode.add((batch, K, H // K, c.enc_frames, D))
        if phase in chip_smoke.LONG_CELL_PHASES:
            decode.add((1, K, H // K, T, D))
    assert attention == set(chip_smoke.FLASH_32K_FAMILY_CASES)
    assert decode == set(chip_smoke.DECODE_32K_FAMILY_CASES)
    assert [(s, c, w) for _, s, c, w in
            chip_smoke.TIME_ATTENTION_32K_FAMILY] == \
        chip_smoke.FLASH_32K_FAMILY_CASES
    assert decode <= {s for _, s in chip_smoke.TIME_DECODES}
    kimi = chip_smoke.serving_config("13")
    E, d, f = kimi.n_experts, kimi.d_model, kimi.d_ff
    chunk = math.ceil(512 * kimi.top_k * kimi.capacity_factor / E)
    step = chip_smoke.FAMILY_CELL_BATCH["13"] * math.ceil(
        kimi.top_k * kimi.capacity_factor / E)
    assert (chunk, step) == (14, 128)
    gmm_path = {s for s, dt in chip_smoke.GMM_PATH_CASES
                if dt == torch.bfloat16}
    gmm_timed = {s for _, s, _, _ in chip_smoke.TIME_GMM}
    for shape in ((E, chunk, d, f), (E, chunk, f, d), (E, step, d, f),
                  (E, step, f, d)):
        assert shape in gmm_path and shape in gmm_timed


def test_plain_attention_in_pieces_of_heads_equals_the_whole():
    """Phase 6 holds Kimi-K2's 32k attention one kv group at a time in
    pieces of 4 of its 8 query heads (34.4 GB of f32 scores a group,
    derived): the pieces side by side are the group's slice of the whole
    plain version; the other groups stay whole."""
    S = 32768
    assert chip_smoke.plain_heads(8, S, S) == 4
    assert [chip_smoke.plain_heads(G, S, S) for G in (1, 2, 4, 5, 6, 7)] \
        == [1, 2, 4, 5, 6, 7]
    assert chip_smoke.plain_heads(1, S, 1500) == 1
    gen = torch.Generator().manual_seed(4)
    for (B, H, K, S, T, D), causal, window in (
            ((1, 16, 2, 40, 40, 16), True, 0), ((1, 10, 2, 50, 50, 16),
                                                True, 8),
            ((2, 6, 6, 30, 12, 16), False, 0)):
        q = torch.randn((B, H, S, D), generator=gen)
        k, v = (torch.randn((B, K, T, D), generator=gen) for _ in "kv")
        whole = chip_smoke.ref.mha_reference(q, k, v, causal=causal,
                                             window=window)
        G = H // K
        for heads in [h for h in range(1, G + 1) if G % h == 0]:
            groups = dict(chip_smoke.grouped_reference(
                q, k, v, range(K), causal=causal, window=window,
                heads=heads))
            for g, out in groups.items():
                torch.testing.assert_close(out, whole[:, g * G:(g + 1) * G],
                                           rtol=1e-6, atol=1e-6)


def test_family_32k_kernel_checks_rehearse_on_cpu(monkeypatch):
    """Phase 6's family checks on the CPU at small shapes of the same
    layouts and masks (G = 8 in pieces of heads, a window, S != T), the
    plain version against itself, and decode at lengths 1, T // 3, T and
    ragged."""
    monkeypatch.setattr(chip_smoke, "PLAIN_SCORES_BYTES", 4 * 96 * 96 * 4)
    out = chip_smoke.check_attention_32k(
        CPU, [((1, 16, 2, 96, 96, 16), True, 0),
              ((1, 10, 2, 96, 96, 16), True, 24),
              ((1, 6, 6, 96, 30, 16), False, 0)],
        [(3, 2, 8, 130, 16), (1, 2, 5, 32, 16), (3, 6, 1, 30, 16)])
    assert out == {"flash_attention": 0.0, "flash_decode": 0.0}


def test_phase_h_records_the_family_cells(monkeypatch):
    """Phase H's dry run counts each family cell at the depth and batch
    the card runs: prefill_32k at one row (not xLSTM's), decode_32k at its
    batch and pos 32767, long_500k at one row and pos 524,287."""
    calls = []

    def dry_cell(cfg, kind, seq, batch, **kw):
        calls.append((cfg.name, cfg.n_layers, kind, seq, batch,
                      kw.get("decode_pos")))
        return kind

    monkeypatch.setattr(chip_smoke, "dry_cell", dry_cell)
    recs = chip_smoke.dry_family_cells()
    assert set(recs) == {
        "phase 13 prefill_32k call", "phase 13 decode_32k step",
        "phase D prefill_32k call", "phase D decode_32k step",
        "phase D long_500k step", "phase E decode_32k step",
        "phase E long_500k step", "phase F prefill_32k call",
        "phase F decode_32k step"}
    assert set(calls) == {
        ("kimi-k2-1t-a32b", 1, "prefill", 32768, 1, None),
        ("kimi-k2-1t-a32b", 1, "decode", 32768, 128, 32767),
        ("hymba-1.5b", 32, "prefill", 32768, 1, None),
        ("hymba-1.5b", 32, "decode", 32768, 128, 32767),
        ("hymba-1.5b", 32, "decode", 524288, 1, 524287),
        ("xlstm-350m", 24, "decode", 32768, 128, 32767),
        ("xlstm-350m", 24, "decode", 524288, 1, 524287),
        ("whisper-tiny", 4, "prefill", 32768, 1, None),
        ("whisper-tiny", 4, "decode", 32768, 128, 32767)}
    assert set(chip_smoke.DRY_NOT_COUNTED) == {"phase E prefill_32k call"}


def _rec(calls):
    return {"flops_per_device": 100.0, "bytes_per_device": 3.35e9,
            "collective_bytes_per_device": {"total": 0.0},
            "memory": {"argument_bytes": 1, "temp_bytes": 0,
                       "output_bytes": 0, "alias_bytes": 0},
            "kernel_calls": calls, "lower_s": 0.5, "compile_s": 1.0}


def test_phase_h_holds_the_family_cells():
    """``check_dryrun`` on made-up family cells: long_500k is held and
    timed as a step, xLSTM's prefill_32k is reported as not counted, and
    a stray launch or a missing record is a miss."""
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
    recs["phase D prefill_32k call"] = _rec({"flash_attention": 32})
    recs["phase D decode_32k step"] = _rec({"flash_decode": 32})
    recs["phase D long_500k step"] = _rec({"flash_decode": 32})
    recs["phase E decode_32k step"] = _rec({})

    def res(launches, runs, batch, ms):
        return {"launches": launches, "runs": runs, "batch": batch,
                "seq": 32768, "ms": ms, "cuts": {}}

    cells = {"D": {"prefill_32k": res({"flash_attention": 64}, 2, 1, 4.0),
                   "decode_32k": res({"flash_decode": 128}, 4, 128, 2.0),
                   "long_500k": res({"flash_decode": 128}, 4, 1, 0.5)},
             "E": {"prefill_32k": res({}, 2, 1, 9.0),
                   "decode_32k": res({}, 4, 128, 1.0)}}
    family = {p: {"run": dict(train)} for p in ("I", "J", "K")}
    args = (serve, serve, train, {"run": train}, {"run": train}, family,
            recs)
    out = chip_smoke.check_dryrun(*args, cells)
    assert out["phase E prefill_32k call"] == "not counted"
    assert out["phase D long_500k step"]["runs"] == 4
    assert out["phase D long_500k step roofline"]["share_of_bound"] == \
        pytest.approx(1.0 / 0.5)
    assert out["phase E decode_32k step roofline"]["ms"] == 1.0
    bad = dict(cells["D"], long_500k=res({"flash_decode": 129}, 4, 1, 0.5))
    with pytest.raises(AssertionError, match="phase D long_500k step"):
        chip_smoke.check_dryrun(*args, dict(cells, D=bad))
    missing = {k: v for k, v in recs.items() if "long_500k" not in k}
    with pytest.raises(KeyError, match="phase D long_500k step"):
        chip_smoke.check_dryrun(*args[:-1], missing, cells)


# ---- the f32 checks' CPU sides in worker processes -----------------------

@pytest.fixture(scope="module")
def pool():
    """One spawned worker of this process's threads, so that its CPU side
    computes what the in-line check does."""
    workers = chip_smoke.worker(torch.get_num_threads())
    yield workers
    chip_smoke.stop(workers)


def _serving(arch="qwen3_4b"):
    cfg = chip_smoke.get_arch(arch).smoke_config()
    prompts = [np.arange(i, i + 10, dtype=np.int32) for i in range(6)]
    sizes = dict(prefill_len=24, n_steps=4, slots=4, max_seq=16)
    return cfg, prompts, sizes


def test_f32_path_in_the_worker_gives_the_in_line_result(pool):
    cfg, prompts, sizes = _serving()
    inline = chip_smoke.check_f32_path(CPU, cfg, prompts, **sizes)
    check = chip_smoke.check_f32_path(CPU, cfg, prompts, **sizes, pool=pool)
    assert isinstance(check, chip_smoke.Pending)
    assert check.collect() == inline == {"prefill_max_abs_diff": 0.0,
                                         "decode_max_abs_diff": 0.0}
    assert check.ready() and check.collect() is check.collect()


def test_f32_training_in_the_worker_gives_the_in_line_result(pool):
    cfg = chip_smoke.get_arch("hymba_1_5b").smoke_config().scaled(
        remat=True)
    kw = dict(batch=1, seq=40, restart=False)
    inline = chip_smoke.check_f32_training(CPU, cfg, **kw)
    kept = {}
    check = chip_smoke.check_f32_training(CPU, cfg, **kw, keep=kept,
                                          pool=pool)
    assert set(kept) == {"state", "grads"}
    out = check.collect()
    for key in ("card_losses", "cpu_losses", "loss_max_abs_diff",
                "grad_max_rel_diff"):
        assert out[key] == inline[key]
    assert out["loss_max_abs_diff"] == 0.0 and out["grad_max_rel_diff"] == 0


def test_a_missed_bound_in_the_worker_fails_the_check(pool, monkeypatch):
    """The card side's logits moved by 2e-3 (patched in this process
    only): the worker's CPU side is right, and collecting the check
    raises."""
    cfg, prompts, sizes = _serving()
    side = chip_smoke.f32_path_side

    def off(*args, **kw):
        prefill, steps, launches = side(*args, **kw)
        return prefill + 2e-3, steps, launches

    monkeypatch.setattr(chip_smoke, "f32_path_side", off)
    check = chip_smoke.check_f32_path(CPU, cfg, prompts, **sizes, pool=pool)
    with pytest.raises(AssertionError, match="differ from the CPU port"):
        check.collect()


def test_a_worker_that_raises_or_dies_fails_the_check(pool):
    """A CPU side that raises re-raises where it is collected; a worker
    process that dies breaks its pool, and every pending check raises."""
    cfg, prompts, _ = _serving()
    sizes = dict(n_steps=4, slots=4, max_seq=16, new_tokens=5)
    broken = chip_smoke.submit(pool, chip_smoke.f32_path_cpu, cfg, {},
                               {}, prompts, sizes)
    check = chip_smoke.Pending("broken", broken, lambda r: r)
    with pytest.raises(KeyError):
        check.collect()
    dying = chip_smoke.worker(1)
    try:
        died = chip_smoke.Pending("died", dying.submit(os._exit, 3),
                                  lambda r: r)
        with pytest.raises(Exception, match="terminated abruptly"):
            died.collect()
    finally:
        chip_smoke.stop(dying)


def test_f32_workers_leave_room_for_the_card_and_the_counts():
    """Two f32 workers, the serving checks' with a third of the spare
    cores and the training checks' with the rest, and one core each for
    the card's phases and phase H's counts."""
    assert chip_smoke.F32_QUEUED == 8 > len(chip_smoke.f32_train_checks())
    serve, train = chip_smoke.f32_threads()
    spare = max(2, (os.cpu_count() or 1) - 2)
    assert serve + train == spare and 1 <= serve <= train


def test_training_checks_submitted_ahead_are_taken_by_their_card_side(
        pool, monkeypatch):
    """``submit_f32_training`` ships each training check's state at the
    start; the check's card side draws it again, finds it equal, and
    takes that CPU side (the same result as in line); a state that is not
    the one shipped fails the check."""
    cfg = chip_smoke.get_arch("xlstm_350m").smoke_config()
    sizes = dict(batch=1, seq=40)
    monkeypatch.setattr(chip_smoke, "f32_train_checks",
                        lambda: [(cfg, sizes)])
    monkeypatch.setattr(chip_smoke, "_AHEAD", {})
    chip_smoke.submit_f32_training(CPU, pool)
    assert len(chip_smoke._AHEAD) == 1
    inline = chip_smoke.check_f32_training(CPU, cfg, **sizes, restart=False)
    check = chip_smoke.check_f32_training(CPU, cfg, **sizes, restart=False,
                                          pool=pool)
    assert chip_smoke._AHEAD == {}
    out = check.collect()
    assert out["cpu_losses"] == inline["cpu_losses"]
    assert out["loss_max_abs_diff"] == 0.0 and out["grad_max_rel_diff"] == 0
    chip_smoke.submit_f32_training(CPU, pool)
    (key, (future, drawn)), = chip_smoke._AHEAD.items()
    chip_smoke._AHEAD[key] = (future, [t + 1 for t in drawn])
    with pytest.raises(AssertionError, match="not the one its CPU side"):
        chip_smoke.check_f32_training(CPU, cfg, **sizes, restart=False,
                                      pool=pool)


def test_every_f32_training_check_is_submitted_ahead():
    """The checks of phases 15, C, G (both quantized states) and I-K, at
    the configs and sizes their phases use."""
    checks = chip_smoke.f32_train_checks()
    names = [(cfg.name, cfg.n_layers, s.get("seq", 256),
              s.get("state_dtype", "float32")) for cfg, s in checks]
    assert names == [("qwen3-4b", 2, 256, "float32"),
                     ("grok-1-314b", 1, 1024, "float32"),
                     ("grok-1-314b", 1, 512, "int8"),
                     ("grok-1-314b", 1, 512, "int8_factored"),
                     ("hymba-1.5b", 2, 2080, "float32"),
                     ("xlstm-350m", 2, 544, "float32"),
                     ("whisper-tiny", 4, 2080, "float32")]
    assert all(cfg.dtype == "float32" for cfg, _ in checks)
    assert checks[2][0] == chip_smoke.moe_check_config(
        chip_smoke.int8_train_config())


def test_narrow_family_twins_cover_the_four_configs():
    assert set(FAMILY_NARROW) == set(FAMILY_ARCHS.values())
