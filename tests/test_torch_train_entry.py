"""The port's training entry points on the CPU: the goodput bench twin
reproduces the reference's committed baseline exactly, the quickstart
twin and the training launcher run end to end, with or without
``--demo``, for a dense and a MoE config."""

import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest

from benchmarks import bench_torch_training as bench
from repro_torch.launch import train as launch_train

ROOT = Path(__file__).resolve().parents[1]
BASELINE = ROOT / "benchmarks" / "baselines" / "training_goodput.json"


@pytest.fixture(scope="module")
def goodput_store():
    return bench._token_store(bench._goodput_sizes(quick=True)["n_samples"])


def test_goodput_high_static_cell_equals_baseline(goodput_store):
    """The quick sweep's one cell that stalls: 150 ms route, static flow
    control, 60 steps charged 50 ms each on the virtual clock."""
    store, uuids = goodput_store
    cell = bench.run_goodput_cell(bench._tiny_model("cpu"), store, uuids,
                                  "high", "static", n_steps=60)
    baseline = json.loads(BASELINE.read_text())
    assert baseline["context"]["n_steps"] == 60
    assert cell["goodput_sps"] == \
        baseline["metrics"]["cells.high.static.goodput_sps"] == \
        638.0373349747985
    assert cell["steps"] == 60 and 0.0 < cell["stall_frac"] < bench.STALL_BOUND


def test_goodput_restore_is_exactly_once(goodput_store):
    store, uuids = goodput_store
    assert bench.check_exactly_once(store, uuids, device="cpu")


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_twin_runs_on_cpu(capsys):
    _load_example("torch_quickstart").main(["--device", "cpu", "--steps",
                                            "3"])
    out = capsys.readouterr().out
    assert "ingested 2048 samples" in out
    assert "step   3 loss" in out and "train steps on cpu" in out


def test_train_launcher_demo_runs_on_cpu(capsys):
    launch_train.main(["--demo", "--device", "cpu", "--steps", "2",
                       "--batch-size", "4", "--seq-len", "16",
                       "--arch", "qwen3_4b"])
    assert "over 2 steps on cpu" in capsys.readouterr().out


def _launcher_lines(capsys, argv):
    """The launcher's printed lines, without the samples/s beside each
    step's loss (wall clock)."""
    launch_train.main(argv)
    return re.sub(r" \S+ samples/s", "", capsys.readouterr().out
                  ).splitlines()


def test_train_launcher_needs_demo(capsys):
    """``--demo`` is no longer needed: a call without it trains, as the
    reference's launcher does, and prints the losses of a ``--demo``
    call."""
    argv = ["--device", "cpu", "--steps", "2", "--batch-size", "4",
            "--seq-len", "16"]
    plain = _launcher_lines(capsys, argv)
    assert plain == _launcher_lines(capsys, ["--demo"] + argv)
    assert plain[0].startswith("step     1 loss ")
    assert plain[-1].endswith("over 2 steps on cpu")


def test_train_launcher_trains_a_moe_smoke_config(capsys):
    """``--arch grok_1_314b`` trains its smoke config with no flag."""
    lines = _launcher_lines(
        capsys, ["--arch", "grok_1_314b", "--device", "cpu", "--steps", "2",
                 "--batch-size", "4", "--seq-len", "16"])
    first, last = re.fullmatch(r"loss (\S+) -> (\S+) over 2 steps on cpu",
                               lines[-1]).groups()
    assert np.isfinite(float(first)) and np.isfinite(float(last))
