"""The port's bench twins reproduce the reference's committed baselines
exactly, on the CPU: ``bench_torch_competitors`` and ``bench_torch_multihost
--scale`` whole, and one cell each of the scenario matrix, tenancy,
replication, flow control and the wirefmt codec section, each equal to a
number its baseline gates.  The wirefmt arena section runs at its quick
size on the CPU, where equal tensors and slab reuse are asserted but not
its host-CPU ratio: that check times the host's wall clock, and on the CPU
the "device" work is host work, so it means nothing here (``chip_smoke.py``
holds it on the card).  No wall-clock check is asserted here.  Each twin's
checks are also held, as source, to the reference bench's: the same names,
the same expressions and the same module constants."""

import ast
import copy
import json
from pathlib import Path

import numpy as np
import pytest

from benchmarks import (bench_torch_competitors, bench_torch_multihost,
                        bench_torch_ramp, bench_torch_scenarios,
                        bench_torch_tenancy, bench_torch_wirefmt, torch_gate)
from benchmarks.torch_common import make_store

ROOT = Path(__file__).resolve().parents[1]


def metric(name: str, path: str) -> float:
    return json.loads((ROOT / "benchmarks" / "baselines" / name)
                      .read_text())["metrics"][path]


def test_competitors_twin_equals_baseline():
    results = bench_torch_competitors.run_table(quick=True)
    assert torch_gate.baseline_problems("competitors.json", results) == []
    assert all(results["checks"].values())


def test_multihost_scale_twin_equals_baseline():
    """1,000 hosts over three federated clusters: every gated metric,
    ``events_total`` included; the wall-clock checks are not asserted."""
    results = bench_torch_multihost.run_scale(quick=True)
    assert torch_gate.baseline_problems("multihost_scale.json", results) \
        == []
    assert results["events_total"] == \
        metric("multihost_scale.json", "events_total") == 146037
    virtual = {k: ok for k, ok in results["checks"].items()
               if k not in bench_torch_multihost.SCALE_WALL_CLOCK_CHECKS}
    assert virtual and all(virtual.values())


def test_scenarios_steady_cell_equals_baseline():
    from repro_torch.core import SCENARIOS, run_cell

    store, uuids = make_store(n_samples=bench_torch_scenarios.n_samples(True))
    oracle, adaptive = (run_cell(store, uuids, SCENARIOS["steady"], mode,
                                 seed=2)["MBps"]
                        for mode in ("oracle", "adaptive"))
    assert oracle == metric("scenarios.json",
                            "matrix.cells.steady.oracle_MBps")
    assert adaptive / oracle == metric(
        "scenarios.json", "matrix.cells.steady.ratios.adaptive")


def test_tenancy_solo_cell_equals_baseline():
    sz = bench_torch_tenancy.tenancy_sizes(quick=True)
    store, uuids = make_store(n_samples=sz["n_samples"], seed=0)
    solo = bench_torch_tenancy.measure(store, uuids, "solo", sz["rounds"])
    assert solo["p99_ms"] == metric("tenancy.json", "solo.p99_ms")


def test_replication_uniform_cell_equals_baseline():
    sz = bench_torch_multihost.replication_sizes(quick=True)
    store, uuids = make_store(n_samples=sz["n_samples"])
    rep = bench_torch_multihost.run_replication_cell(store, uuids, "uniform",
                                                     sz["rounds"])
    assert rep["aggregate_Bps"] / 1e6 == \
        metric("multihost_replication.json", "uniform_MBps")


def test_flowctl_high_adaptive_cell_equals_baseline():
    sz = bench_torch_ramp.flowctl_sizes(quick=True)
    store, uuids = make_store(n_samples=sz["n_samples"])
    cell = bench_torch_ramp.flow_run(
        store, uuids, "high", "adaptive", 8, batch=sz["batch"],
        io_threads=sz["io_threads"], n_batches=sz["n_batches"])
    assert cell["MBps"] == metric("flowctl_ramp.json",
                                  "routes.high.adaptive.MBps")


def test_wirefmt_local_codec_cell_equals_baseline():
    sz = bench_torch_wirefmt.codec_sizes(quick=True)
    store, uuids = make_store(n_samples=sz["n_samples"], seed=3)
    cell = bench_torch_wirefmt.run_codec_cell(
        store, uuids, bench_torch_wirefmt.codec_cfg("local", "none", 1),
        sz["local_batches"], 2)
    assert cell["MBps"] == metric("wirefmt.json",
                                  "codec.cells.local.none.MBps")


def test_wirefmt_arena_section_on_cpu():
    """Equal tensors and slab reuse; the host-CPU ratio is not asserted
    (wall clock, host-bound on the CPU).  The CPU runs the plain version,
    so the kernel is never launched."""
    arena = bench_torch_wirefmt.run_arena_section(quick=True, device="cpu")
    assert arena["checks"]["arena_matches_materialize"]
    assert arena["checks"]["arena_reuses_slabs"]
    assert arena["max_abs_diff"] <= 1e-5
    modes = arena["modes"]
    assert modes["arena"]["batches_formed"] == \
        bench_torch_wirefmt.arena_sizes(True)["n_batches"] + 2
    assert modes["arena"]["crop_launches"] == 0
    assert "arena_kernel_launch_per_batch" not in arena["checks"]


def _nested(flat: dict) -> dict:
    out: dict = {}
    for path, value in flat.items():
        node = out
        *parents, leaf = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


@pytest.mark.parametrize("name", ["wirefmt.json", "multihost_scale.json"])
def test_gate_holds_twins_to_equality(name):
    """A results file built from the baseline passes; one ulp off on one
    gated metric fails (``bench_check`` would pass it within its ±15%), and
    so does another sizing."""
    base = json.loads((ROOT / "benchmarks" / "baselines" / name).read_text())
    results = {**base["context"], **_nested(base["metrics"]), "checks": {}}
    assert torch_gate.baseline_problems(name, results) == []
    path, value = sorted(base["metrics"].items())[0]
    nudged = copy.deepcopy(results)
    *parents, leaf = path.split(".")
    node = nudged
    for part in parents:
        node = node[part]
    node[leaf] = float(np.nextafter(value, np.inf))
    assert len(torch_gate.baseline_problems(name, nudged)) == 1
    resized = {**results, "quick": False}
    assert any("context" in p
               for p in torch_gate.baseline_problems(name, resized))


def _checks_in(tree: ast.AST) -> dict:
    """Every ``checks`` entry a bench builds: its name -> its expression as
    source, from ``{"checks": {...}}``, ``checks = {...}``,
    ``x["checks"] = {...}`` and ``checks[name] = ...``."""
    def is_checks(node):
        return (isinstance(node, ast.Name) and node.id == "checks") or (
            isinstance(node, ast.Subscript)
            and isinstance(node.slice, ast.Constant)
            and node.slice.value == "checks")

    out = {}

    def put(dict_node):
        for key, value in zip(dict_node.keys, dict_node.values):
            if isinstance(key, ast.Constant) and isinstance(key.value, str):
                out[key.value] = ast.unparse(value)

    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for key, value in zip(node.keys, node.values):
                if isinstance(key, ast.Constant) and key.value == "checks" \
                        and isinstance(value, ast.Dict):
                    put(value)
        elif isinstance(node, ast.Assign):
            target = node.targets[0]
            if is_checks(target) and isinstance(node.value, ast.Dict):
                put(node.value)
            elif isinstance(target, ast.Subscript) \
                    and is_checks(target.value) \
                    and isinstance(target.slice, ast.Constant):
                out[target.slice.value] = ast.unparse(node.value)
    return out


def _constants_in(tree: ast.Module) -> dict:
    return {node.targets[0].id: ast.unparse(node.value)
            for node in tree.body
            if isinstance(node, ast.Assign) and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id.isupper()}


# The one check a twin adds: on a card, one crop launch per arena batch.
TWIN_ONLY_CHECKS = {"wirefmt": {"arena_kernel_launch_per_batch"}}


@pytest.mark.parametrize("name", ["wirefmt", "ramp", "multihost",
                                  "scenarios", "tenancy", "competitors"])
def test_twin_checks_match_the_reference(name):
    """The twins are rewrites of the reference benches, not copies, and the
    gate compares only gated metrics: so a twin's checks are held to the
    reference's here.  The same check names (save the twin's own), each
    the same expression, and every module constant both define equal."""
    ref, twin = (ast.parse((ROOT / "benchmarks" / f"{stem}.py").read_text())
                 for stem in (f"bench_{name}", f"bench_torch_{name}"))
    ref_checks, twin_checks = _checks_in(ref), _checks_in(twin)
    assert ref_checks
    assert set(twin_checks) - set(ref_checks) == \
        TWIN_ONLY_CHECKS.get(name, set())
    assert {k: twin_checks.get(k) for k in ref_checks} == ref_checks
    ref_consts, twin_consts = _constants_in(ref), _constants_in(twin)
    shared = set(ref_consts) & set(twin_consts)
    assert {k: twin_consts[k] for k in shared} == \
        {k: ref_consts[k] for k in shared}
    used = {n.id for expr in ref_checks.values()
            for n in ast.walk(ast.parse(expr)) if isinstance(n, ast.Name)}
    assert used & set(ref_consts) <= set(twin_consts)
