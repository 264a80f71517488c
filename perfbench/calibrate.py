"""Readings that set and test a cell's limits, several seeds in one process.

    python3 perfbench/calibrate.py --workload NAME --seconds S SEED [SEED ...]
        [--control] [--fault KIND] [--config KEY=VALUE] ... [--mix KEY=VALUE] ...

Each seed is one run of the cell as ``run.py`` makes it (set-up, a window
of ``--seconds``, the check against the plain reference); ``--control``
puts the reference, in fp8, in the program's place, so that the numbers
compared and ``correct`` are the control's (the program's own readings
are printed beside them); ``--fault`` plants one of ``faults.KINDS``
under the timed path.  ``--config`` and ``--mix`` change a key of the
configuration or the mix for this process only (for a witness at another
precision or size).  Prints one JSON line a seed: ``correct``, the
numbers compared, and the run's end-to-end metrics.  Needs a CUDA card.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from perfbench import faults  # noqa: E402


def _set(d: dict, pairs) -> None:
    for kv in pairs or []:
        k, v = kv.split("=", 1)
        d[k] = json.loads(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--config", action="append")
    ap.add_argument("--mix", action="append")
    ap.add_argument("--fault", choices=faults.KINDS)
    ap.add_argument("seeds", type=int, nargs="+")
    args = ap.parse_args(argv)
    from perfbench import run
    run.pin_caches(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 1
    load = run.load_cell

    def patched(root, name):
        cell = load(root, name)
        _set(cell["config"], args.config)
        _set(cell["mix"], args.mix)
        return cell

    run.load_cell = patched
    t0 = T0
    for seed in args.seeds:
        with (faults.plant(args.fault) if args.fault
              else contextlib.nullcontext()):
            out = run.execute(ROOT, args.workload, seed, args.seconds, False,
                              torch.device("cuda", 0), t0,
                              control=args.control)
        line = {"seed": seed, "correct": out["correct"],
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "peak_gb": out["device"]["memory_peak_bytes"] / 1e9}
        line.update(out["_detail"])
        print(json.dumps(line), flush=True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
