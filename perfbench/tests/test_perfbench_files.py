"""The benchmark's files: names, units, the limits of their format, and that
cells, mixes, drivers and metric readers are found by name alone."""

from __future__ import annotations

import json
import re

import pytest

from perfbench import run

from .conftest import REPO, execute

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            yield e["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(names())))
def test_names_use_only_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert callable(run.reader(metric["name"]))
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        if "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


def test_the_file_shape():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells, each run at run_seconds, fits 12 hours
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_with_its_files(cell):
    found = run.load_cell(REPO, cell)
    assert found["config"]["name"] == found["entry"]["config"]
    assert (REPO / "perfbench" / "drivers"
            / f"{found['mix']['driver']}.py").exists()
    assert found["cell"]["limits"]
    reported = run.metrics_of(BENCH, cell, trace=True)
    assert reported, "every cell reports a per-layer metric"
    e2e = {m["name"] for m in run.metrics_of(BENCH, cell, trace=False)}
    assert "setup_s" in e2e and len(e2e) >= 2


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(config):
    body = json.loads((REPO / config["file"]).read_text())
    assert body["name"] == config["name"]
    assert body["source"] == config["source"]
    assert set(body["reduced"]) == set(config["reduced"])
    widths = ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
              "vocab", "top_k")
    assert not set(config["reduced"]) & set(widths)
    for k in ("assumed", "deployment", "departures"):
        assert body[k]


def test_a_cell_added_in_a_new_file_is_found(tiny_root, tmp_path):
    """A later change adds a cell with a mix file, a limits file and an
    entry, and edits no file of the harness."""
    import shutil
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    mix = json.loads((root / "perfbench/traffic/tchat.json").read_text())
    mix.update(slots=2, max_new_tokens=4)
    (root / "perfbench/traffic/tchat2.json").write_text(json.dumps(mix))
    (root / "perfbench/workloads/tiny-moe.tchat2.json").write_text(
        (root / "perfbench/workloads/tiny-moe.tchat.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-moe.tchat2",
                               "config": "tiny-moe", "traffic": "tchat2",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-moe.tchat" in m.get("workloads", []):
            m["workloads"].append("tiny-moe.tchat2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = execute(root, "tiny-moe.tchat2")
    assert out["correct"] is True
    assert "gen_tokens_per_s" in out["metrics"]


def test_a_metric_without_a_cell_list_goes_to_every_cell_of_its_moves():
    bench = {"end_to_end": [{"name": "a", "workloads": ["x"]},
                            {"name": "setup_s"}],
             "per_layer": [{"name": "m", "moves": "a"},
                           {"name": "n", "moves": "a", "workloads": []}]}
    assert [m["name"] for m in run.metrics_of(bench, "x", True)] == ["m"]
    assert run.metrics_of(bench, "y", True) == []
