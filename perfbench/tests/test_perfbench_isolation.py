"""A run loads no JAX and no JAX package; the reference and the yardstick
import nothing of the program; without a card the run prints nothing."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from perfbench import run

from .conftest import REPO

PURE = ["reference/model.py", "reference/adamw.py", "cost.py", "trace.py",
        "weights.py"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("name", PURE)
def test_the_yardstick_imports_nothing_of_the_program(name):
    tops = {m.split(".")[0] for m in _imports(REPO / "perfbench" / name)}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_the_reference_loads_nothing_of_the_program_when_imported():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.reference.model, perfbench.reference.adamw, "
            "perfbench.cost, perfbench.weights; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(REPO))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_a_tiny_run_loads_no_jax_and_no_jax_package(tiny_root):
    code = ("import sys, time, json; sys.path.insert(0, %r); "
            "import torch; from pathlib import Path; "
            "from perfbench import run; "
            "out = run.execute(Path(%r), 'tiny-moe.tchat', 5, 2.0, False, "
            "torch.device('cpu'), time.perf_counter()); "
            "print(json.dumps([out['correct'], run.forbidden_modules()]))"
            % (str(REPO), str(tiny_root)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, check=True)
    correct, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct is True and bad == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake",
                        types.ModuleType("repro_torch_fake"))
    assert "repro_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake",
                        types.ModuleType("repro.fake"))
    assert "repro.fake" in run.forbidden_modules()


def test_without_a_card_the_run_fails_and_prints_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "grok-1.4of64.chat", "--seed",
                   str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_without_the_program_the_run_fails(tmp_path):
    """A checkout that holds only ``BENCHMARK.json`` and the benchmark's
    own files cannot run a cell."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, %r); import torch; "
            "from pathlib import Path; from perfbench import run; "
            "run.execute(Path(%r), 'grok-1.4of64.chat', 5, 0.3, False, "
            "torch.device('cpu'), time.perf_counter())"
            % (str(tmp_path), str(tmp_path)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert "repro_torch" in out.stderr
