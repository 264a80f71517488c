"""The bench twins' gate: a twin's results against the reference's
committed baseline, for equality.

``repro_torch.core`` runs the reference's loader, clock and accounting, so
a twin's virtual-clock numbers equal the committed baselines in
``benchmarks/baselines/`` bit for bit.  ``tools/bench_check.py`` holds the
reference's results within ±15%; a twin is held to more:

* the sizing context equals the baseline's (a ``--quick`` run; a
  full-size run is judged by its checks alone);
* every metric that ``bench_check.SPECS`` gates for that baseline equals
  the committed value;
* the bench's own boolean checks pass, save those a caller names as
  reported only (a wall-clock check on a machine it does not judge).

Wall-clock numbers are never compared with a baseline: only the bench's
own boolean checks judge them.  The results land in
``results/<name>_torch.json``, beside the reference's ``results/<name>.json``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path
from typing import Iterable, List

from .torch_common import RESULTS_DIR

ROOT = Path(__file__).resolve().parent.parent
BASELINE_DIR = ROOT / "benchmarks" / "baselines"


def _bench_check():
    """``tools/bench_check.py``, loaded from its file: ``tools`` is not a
    package, and an installed one of that name must not shadow it."""
    spec = importlib.util.spec_from_file_location(
        "_bench_check", ROOT / "tools" / "bench_check.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gated(name: str, results: dict) -> dict:
    """The context and gated metrics of ``results`` for baseline ``name``
    (e.g. ``"wirefmt.json"``), as ``bench_check`` extracts them."""
    return _bench_check().extract(name, results)


def baseline(name: str) -> dict:
    return json.loads((BASELINE_DIR / name).read_text())


def baseline_problems(name: str, results: dict) -> List[str]:
    """Every way ``results`` differs from the committed baseline: the
    context, and each gated metric compared for equality."""
    want = baseline(name)
    got = gated(name, results)
    problems = []
    if got["context"] != want["context"]:
        problems.append(f"context {got['context']} != baseline "
                        f"{want['context']}")
    for path, value in want["metrics"].items():
        cur = got["metrics"].get(path)
        if cur != value:
            problems.append(f"{path}: {cur!r} != baseline {value!r}")
    return problems


def write_results(name: str, results: dict) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR,
                        name.removesuffix(".json") + "_torch.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=2, sort_keys=True)
    return path


def finish(name: str, results: dict, *, quick: bool,
           reported_only: Iterable[str] = ()) -> int:
    """Write ``results``, then judge the written file: print each gated
    metric beside its baseline and each check, and return 1 on any
    mismatch or failed check (those in ``reported_only`` are printed and
    not judged), else 0.  The baselines are quick runs: a full-size run
    is judged by its checks alone."""
    path = write_results(name, results)
    with open(path) as f:                      # judge the artifact
        written = json.load(f)
    problems = []
    if quick:
        want = baseline(name)["metrics"]
        got = gated(name, written)["metrics"]
        for metric, value in want.items():
            mark = "equal" if got.get(metric) == value else "DIFFERS"
            print(f"  {metric:45s} {got.get(metric)!r:>22s} "
                  f"baseline {value!r:>22s} {mark}")
        problems = baseline_problems(name, written)
    reported_only = set(reported_only)
    for check, ok in written["checks"].items():
        note = " (reported, not judged here)" if check in reported_only \
            else ""
        print(f"  check {check}: {'PASS' if ok else 'FAIL'}{note}")
        if not ok and check not in reported_only:
            problems.append(f"check {check} failed")
    if problems:
        print(f"{name} twin FAILED ({os.path.relpath(path)}):")
        for p in problems:
            print(f"  - {p}")
        return 1
    print(f"{name} twin: {'equal to the baseline, ' if quick else ''}"
          f"checks passed -> {os.path.relpath(path)}")
    return 0
