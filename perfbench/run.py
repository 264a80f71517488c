"""One run of one benchmark cell of the PyTorch port, on the card it starts on.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell is found by name in ``BENCHMARK.json``; its configuration, its
traffic mix (``perfbench/traffic/<traffic>.json``, which names the
driver in ``perfbench/drivers/``) and its limits
(``perfbench/workloads/<name>.json``) are files of their own, and so is
each per-layer metric's reader (``perfbench/metrics/<name>.py``).  The
driver sets up, measures for ``--seconds`` and checks the timed path's
outputs against the plain reference; this file prints the result: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones.  The last line of standard output is one JSON object;
the numbers compared, each beside its limit, are the last lines of
standard error and the result's last key.

Exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), when the run loaded JAX or the JAX package, and
on any error.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def pin_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    and one CPU thread a library: the run's load is one process whose
    host work is one Python thread."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    build = root / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda")


def load_cell(root: Path, name: str) -> Dict:
    """The cell ``name`` with its configuration, mix and limits."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    mix = json.loads((root / "perfbench" / "traffic"
                      / f"{entry['traffic']}.json").read_text())
    limits = json.loads((root / "perfbench" / "workloads"
                         / f"{name}.json").read_text())
    return {"bench": bench, "entry": entry, "config": config, "mix": mix,
            "cell": limits}


def metrics_of(bench: Dict, name: str, trace: bool) -> List[Dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end ones, or
    with ``trace`` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in moved
                             else [])]


def reader(metric: str):
    """The ``read(layer)`` of ``perfbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def execute(root: Path, name: str, seed: int, seconds: float, trace: bool,
            device, t0: float, control: bool = False) -> Dict:
    """Run the cell's driver and turn what it returns into the result."""
    cell = load_cell(root, name)
    driver = importlib.import_module(
        f"perfbench.drivers.{cell['mix']['driver']}")
    got = driver.run(cell["config"], cell["mix"], cell["cell"], seed,
                     seconds, trace, device, t0, control=control)
    metrics = {}
    for m in metrics_of(cell["bench"], name, trace):
        if m["name"] == "setup_s":
            value = got["setup_s"]
        elif trace:
            value = reader(m["name"])(got["layer"])
        else:
            value = got["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": lim}
              for k, (v, lim) in got["checks"].items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (_card(device)), "count": 1,
           "memory_peak_bytes": got["memory_peak_bytes"]}
    if trace:
        dev["busy_s"] = got.get("busy_s", 0.0)
        dev["window_s"] = got.get("window_s", 0.0)
    out = {"correct": correct, "attempted": got["attempted"],
           "failed": got["failed"], "metrics": metrics, "device": dev}
    if trace and "breakdown" in got:
        out["breakdown"] = got["breakdown"]
    out["checks"] = checks
    out["_detail"] = got.get("detail", {})
    return out


def _card(device) -> str:
    import torch
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else device.type


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches(ROOT)
    sys.path.insert(0, str(ROOT))
    chips = load_cell(ROOT, args.workload)["entry"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 1
    out = execute(ROOT, args.workload, args.seed, args.seconds,
                  bool(args.trace), torch.device("cuda", 0), T0)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    detail = out.pop("_detail")
    print("perfbench: " + json.dumps(detail), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
