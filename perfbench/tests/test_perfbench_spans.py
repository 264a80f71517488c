"""The readings of the program's spans and counters (``perfbench/spans.py``,
the readers of ``perfbench/span_metrics.json``) and the tool that runs a
cell with spans on (``tools/torch_span_trace.py``), on the tiny cells."""

from __future__ import annotations

import importlib.util
import json
from collections import namedtuple
from pathlib import Path

import pytest
import torch

from perfbench import run, spans

from . import test_perfbench_files as files
from .conftest import REPO, SEED, SERVE_CELLS, TRAIN_CELLS

ENTRIES = json.loads((REPO / "perfbench" / "span_metrics.json").read_text())
DEVICE = {"moe_dispatch_ms", "unembed_ms", "train_forward_ms",
          "train_backward_ms", "train_optimizer_ms"}


def tool():
    path = REPO / "tools" / "torch_span_trace.py"
    spec = importlib.util.spec_from_file_location("torch_span_trace", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def span_root(tiny_root) -> Path:
    """The tiny checkout with the span metrics listed for its cells."""
    serve = {"gen_tokens_per_s", "ttft_p95_ms"}
    entries = [dict(m, workloads=SERVE_CELLS if m["moves"] in serve
                    else TRAIN_CELLS) for m in ENTRIES]
    (tiny_root / "perfbench" / "span_metrics.json").write_text(
        json.dumps(entries))
    return tiny_root


@pytest.mark.parametrize("metric", ENTRIES, ids=lambda m: m["name"])
def test_span_metric_entries(metric):
    files.test_metric_entries(metric)
    assert files.NAME.match(metric["name"])
    assert metric["name"] not in {m["name"] for m in files.BENCH["per_layer"]}
    cells = {w["name"] for w in files.BENCH["workloads"]}
    assert metric["workloads"] and set(metric["workloads"]) <= cells
    assert (metric["source"] == "device_trace") == (metric["name"] in DEVICE)


def test_the_eight_metrics_and_their_cells():
    by_cell = {}
    for m in ENTRIES:
        for w in m["workloads"]:
            by_cell.setdefault(w, set()).add(m["name"])
    assert by_cell == {
        "grok-1.4of64.chat": {"engine_host_ms", "serve_launch_ms",
                              "moe_dispatch_ms", "unembed_ms", "slot_yield"},
        "stablelm-2-1.6b.train_4k": {"train_forward_ms", "train_backward_ms",
                                     "train_optimizer_ms"}}


class FakeProfile:
    """What ``device_by_span`` and ``idle_by_span`` read of a Profile."""

    def __init__(self, annotations, launches, window):
        self.annotations = annotations
        self.window_ns = window
        self.launched = [(t, s, e, "k") for t, (s, e) in launches]
        self.device_ops = [(s, e, "k", 0) for _, (s, e) in launches]


class FakeEvent:
    def __init__(self, name, device, corr, linked=0, start=0, end=0,
                 annotation=False):
        self._v = (name, device, corr, linked, start, end, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[1]
                else torch.autograd.DeviceType.CPU)

    def correlation_id(self):
        return self._v[2]

    def linked_correlation_id(self):
        return self._v[3]

    def start_ns(self):
        return self._v[4]

    def end_ns(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def test_a_kernel_is_tied_to_the_call_that_launched_it():
    """By the CUPTI correlation id that the kernel and its launch share,
    not by ``linked_correlation_id`` (the id of the PyTorch op it ran
    under, which may equal another launch's correlation id)."""
    events = [
        FakeEvent("aten::mm", False, 3, start=40, end=120),
        FakeEvent("cudaLaunchKernel", False, 3, linked=3, start=50, end=52),
        FakeEvent("cudaLaunchKernel", False, 7, linked=3, start=100,
                  end=102),
        FakeEvent("gemm", True, 7, linked=3, start=200, end=260),
        FakeEvent("orphan", True, 9, linked=3, start=300, end=310),
        FakeEvent("x", False, 11, start=0, end=500, annotation=True),
        FakeEvent("x", True, 12, start=200, end=260),    # its device copy
    ]
    assert spans.launches(events) == [(100, 200, 260, "gemm")]


def test_device_time_by_span_and_idle_by_span():
    prof = FakeProfile(
        [(0, 100, "engine.step"), (10, 60, "engine.forward"), (20, 40, "moe"),
         (25, 35, "moe.experts"), (45, 55, "unembed"),
         (26, 34, "perfbench.grouped_matmul"), (0, 200, "perfbench.window")],
        [(5, (100, 110)), (22, (110, 120)), (30, (120, 140)),
         (50, (140, 150)), (70, (150, 155)), (250, (300, 310))],
        (0, 200))
    names = {"engine.step", "engine.forward", "moe", "moe.experts", "unembed"}
    dev = spans.device_by_span(prof, names, prof.launched)
    got = {n: (d["device_s"] * 1e9, d["self_device_s"] * 1e9, d["calls"])
           for n, d in dev.items()}
    assert got == {"engine.step": (pytest.approx(55), pytest.approx(15), 1),
                   "engine.forward": (pytest.approx(40), 0, 1),
                   "moe": (pytest.approx(30), pytest.approx(10), 1),
                   "moe.experts": (pytest.approx(20), pytest.approx(20), 1),
                   "unembed": (pytest.approx(10), pytest.approx(10), 1)}
    layer = {"kind": "serve", "device_kind": "NVIDIA H100 80GB HBM3",
             "span_device": dev}
    assert run.reader("moe_dispatch_ms")(layer) == pytest.approx(1e-5)
    assert run.reader("unembed_ms")(layer) == pytest.approx(1e-5)
    assert run.reader("unembed_ms")(dict(layer, device_kind="cpu")) is None
    idle = spans.idle_by_span(prof, names)
    assert idle == {"unembed": pytest.approx(1e-7),
                    spans.OUTSIDE: pytest.approx(4.5e-8)}


R = namedtuple("R", "name start_ns end_ns parent thread")


def test_host_readings_of_the_records():
    recs = [R("engine.step", 0, 1000, -1, 1),
            R("engine.admit", 0, 100, 0, 1),
            R("engine.forward", 100, 600, 0, 1),
            R("attn", 150, 250, 2, 1),
            R("engine.emit", 700, 900, 0, 1),
            R("engine.step", 1500, 2500, -1, 1),
            R("engine.admit", 1500, 1700, 5, 1),
            R("engine.forward", 1700, 2400, 5, 1),
            R("engine.step", 3000, 4000, -1, 1)]
    layer = {"kind": "serve", "spans": recs, "step_s": [1e-6, 1e-6]}
    tops = spans.steps_before(layer, None)
    assert tops == [0, 5]
    assert run.reader("engine_host_ms")(layer) == pytest.approx(250 / 1e6)
    assert run.reader("serve_launch_ms")(layer) == pytest.approx(600 / 1e6)
    assert spans.host_self_ms(recs, tops) == pytest.approx(
        {"engine.step": 150 / 1e6, "engine.admit": 150 / 1e6,
         "engine.forward": 550 / 1e6, "attn": 50 / 1e6,
         "engine.emit": 100 / 1e6})
    assert spans.between_ms(recs, tops) == pytest.approx(500 / 1e6)
    layer["counters"] = {"slot_steps": 8, "tokens_out": 6}
    assert run.reader("slot_yield")(layer) == 75.0
    layer["counters"]["prompt_tokens_fed"] = 3
    assert spans.fed_share(layer) == 37.5
    for m in ENTRIES:                   # a program without spans
        assert run.reader(m["name"])({"kind": "serve", "step_s": [1.0],
                                      "device_kind": "cpu"}) is None


@pytest.mark.parametrize("cell", SERVE_CELLS[:1] + TRAIN_CELLS)
def test_a_traced_tiny_cell_with_spans_on(span_root, cell):
    mod = tool()
    out = mod.traced_run(span_root, cell, SEED, 3.0, torch.device("cpu"))
    assert out["correct"] is True
    reported = set(out["metrics"])
    assert not reported & DEVICE          # no device trace on the CPU
    assert out["span_device"]             # the annotations were found
    host = out["detail"]["span_host_ms"]
    if cell in SERVE_CELLS:
        assert reported == {"engine_host_ms", "serve_launch_ms",
                            "slot_yield"}
        assert all(out["metrics"][m]["value"] > 0 for m in reported)
        acc = out["accounting"]
        assert acc["tokens_out"] == acc["tokens_served_by_the_driver"] > 0
        assert 0.5 < acc["children_of_step"] <= 1.0
        c = out["counters"]
        assert c["slot_steps"] == c["steps"] * 4
        assert out["metrics"]["slot_yield"]["value"] == pytest.approx(
            100.0 * c["tokens_out"] / c["slot_steps"])
        assert out["detail"]["slot_fed_share"] == pytest.approx(
            100.0 * c["prompt_tokens_fed"] / c["slot_steps"])
        assert {"engine.step", "engine.forward", "moe", "moe.experts",
                "unembed"} <= set(host)
        assert out["detail"]["harness_ms"] > 0
        assert set(out["span_device"]) >= {"engine.step", "moe", "unembed"}
    else:
        assert reported == set()
        assert {"train.step", "train.forward", "train.backward",
                "train.optimizer", "feed.next"} <= set(host)
        assert out["span_device"]["train.step"]["calls"] == 2
    json.dumps(out)


def test_the_cost_runs_turn_spans_off_and_on(span_root):
    mod = tool()
    off = mod.cost_run(span_root, SERVE_CELLS[0], SEED, 1.5,
                       torch.device("cpu"), False)
    on = mod.cost_run(span_root, SERVE_CELLS[0], SEED, 1.5,
                      torch.device("cpu"), True)
    assert off["correct"] and on["correct"]
    assert off["records"] == 0 and "detail" not in off
    assert on["records"] > 0 and on["detail"]["span_host_ms"]
    assert on["steps"] > 0 and on["step_ms"] > 0


def test_the_toggled_run_times_each_state(span_root):
    mod = tool()
    out = mod.toggled_run(span_root, SERVE_CELLS[0], SEED, 1.5,
                          torch.device("cpu"), 2)
    assert out["correct"]
    assert out["steps_on"] > 0 and out["steps_off"] > 0
    assert out["step_ms_on"] > 0 and out["step_ms_off"] > 0
    assert {"on", "off"} <= set(out["gc"])
    assert out["records"] > 0


def test_the_accounting_names_what_misses():
    mod = tool()
    good = {"children_of_step": 0.999, "tokens_out": 5,
            "tokens_served_by_the_driver": 5, "step_device_share": 0.995,
            "unembed_ms": 4.5, "unembed_kernel_names_ms_per_step": 4.6}
    assert mod.misses(good) == []
    bad = dict(good, children_of_step=0.9, tokens_out=4,
               step_device_share=0.7, unembed_ms=0.0014)
    assert mod.misses(bad) == ["children_of_step", "tokens_out",
                               "step_device_share", "unembed_vs_kernels"]
    assert mod.misses({"parts_over_busy": 0.09, "step_device_share": 0.1,
                       "tokens_out": None,
                       "tokens_served_by_the_driver": None}) == \
        ["parts_over_busy"]
    assert mod.misses({"parts_over_busy": 0.98, "tokens_out": None,
                       "tokens_served_by_the_driver": None}) == []
