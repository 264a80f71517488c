"""Each driver runs a tiny cell on the CPU and gives the result's keys."""

from __future__ import annotations

import copy
import json
import shutil

import numpy as np
import pytest

from .conftest import SEED, SERVE_CELLS, TRAIN_CELLS, execute, mixes

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", SERVE_CELLS + TRAIN_CELLS)
def test_driver_runs_a_tiny_cell(tiny_root, cell, trace):
    out = execute(tiny_root, cell, trace=trace, seconds=3.0 if trace else 2.0)
    assert list(out)[:5] == KEYS
    assert list(out)[-2] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    if not trace:
        e2e = {m["name"] for m in bench["end_to_end"]
               if cell in m.get("workloads", [cell])}
        assert set(out["metrics"]) == e2e
    else:
        assert "busy_s" in out["device"] and "window_s" in out["device"]
        assert out["device"]["window_s"] > 0
        # the CPU has no device trace and no peaks: no per-layer metric
        # of the card is made up from it
        assert not any(k.endswith(("roofline", "mfu")) or
                       k.startswith("device_idle")
                       for k in out["metrics"])
        if cell in SERVE_CELLS:
            assert out["metrics"]["token_gap_p95_ms"]["value"] > 0
    json.dumps(out)


def test_a_cell_reports_what_the_window_did(tiny_root):
    out = execute(tiny_root, "tiny-moe.tchat", seconds=2.0)
    m = out["metrics"]
    assert m["gen_tokens_per_s"]["value"] > 0
    assert m["ttft_p95_ms"]["value"] > 0
    assert "token_gap_p95_ms" not in m
    assert out["_detail"]["served_tokens_checked"] > 0


def test_every_seed_gets_the_same_lengths_in_the_same_order():
    from perfbench.drivers.serve_closed_loop import fetch_prompts
    mix = mixes()["tchat"]
    a = fetch_prompts(mix, 512, SEED)
    b = fetch_prompts(mix, 512, SEED + 1)
    assert [len(p) for p in a] == [len(p) for p in b]
    assert any(not np.array_equal(x, y) for x, y in zip(a, b))
    lo, hi = mix["prompt_len"]
    assert {len(p) for p in a} <= set(range(lo, hi + 1))


def test_the_window_closes_where_the_cache_ends(tiny_root, tmp_path):
    """A program fast enough to fill the cache before ``--seconds`` is
    measured over the shorter window, and its run stays correct."""
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    path = root / "perfbench/configs/tiny-moe.json"
    config = json.loads(path.read_text())
    config["max_seq"] = 80                 # 16 positions after start_pos 64
    path.write_text(json.dumps(config))
    out = execute(root, "tiny-moe.tsess", seconds=30.0)
    assert out["correct"] is True, out["checks"]
    assert out["_detail"]["cache_full"] is True
    assert out["_detail"]["steps"] == 16
    assert out["_detail"]["window_s"] < 30.0


def test_the_train_check_reads_the_state_the_step_returns(tiny_root,
                                                          monkeypatch):
    """A train step that leaves the state it was given as it was and
    returns a new one is read by what it returns."""
    from repro_torch.train import loop
    make = loop.make_train_step

    def functional(*a, **kw):
        step = make(*a, **kw)

        def fresh(state, batch):
            return step(copy.deepcopy(state), batch)
        return fresh

    monkeypatch.setattr(loop, "make_train_step", functional)
    out = execute(tiny_root, TRAIN_CELLS[0])
    assert out["correct"] is True, out["checks"]


def test_a_cell_compares_the_numbers_its_limits_name(tiny_root, tmp_path):
    """A number left out of a cell's limits is reported and not compared."""
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    cell = TRAIN_CELLS[0]
    path = root / "perfbench/workloads" / f"{cell}.json"
    limits = json.loads(path.read_text())
    del limits["limits"]["loss_gap"]
    path.write_text(json.dumps(limits))
    out = execute(root, cell)
    assert out["correct"] is True, out["checks"]
    assert "loss_gap" not in out["checks"]
    assert "loss_gap" in out["_detail"]["program"]
