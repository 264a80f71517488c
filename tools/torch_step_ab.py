#!/usr/bin/env python3
"""Qwen3-4B's serving step in two checkouts of the repo, in turns, on one
card: chip_smoke.py's phase 7 (full width, 36 layers, bf16, 16 prompts
through ServingEngine over a 4096-token cache) run once per turn, each in a
process of its own that imports that checkout's ``chip_smoke``.  With
``--moe``, phase 11's Grok-1 instead (full width, 4 of 64 layers, 16
prompts over a 1024-token cache, its 12 grouped matmuls a step).

    python3 tools/torch_step_ab.py PARENT_DIR CHANGE_DIR [--rounds N] [--moe]

Runs parent, change, change, parent per round and prints, per run, the
ms per engine step, the tokens/s and the kernels' launches, then the
medians of each checkout.  Comparing two versions is only meaningful within
one such call: the host's speed, which sets the dense step, differs from
machine to machine.  Needs a CUDA card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

RUN = """
import json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke
torch.zeros(1, device="cuda")       # start CUDA, as chip_smoke's phases do
if {moe}:
    cfg = chip_smoke.get_arch(chip_smoke.MOE_ARCH).scaled(
        n_layers=chip_smoke.MOE_LAYERS)
    kw = dict(chip_smoke.MOE_SERVE, n_prefill=1)
else:
    cfg, kw = chip_smoke.get_arch(chip_smoke.ARCH), dict(n_prefill=1)
run, _ = chip_smoke.drive_serving(torch.device("cuda", 0), cfg, **kw)
print("RESULT " + json.dumps({{k: run[k] for k in (
    "ms_per_engine_step", "prefill_ms_per_call", "tokens_per_s",
    "engine_steps", "launches")}}))
"""


def one(root: Path, moe: bool) -> dict:
    proc = subprocess.run([sys.executable, "-c",
                           RUN.format(root=str(root), moe=moe)],
                          cwd=root, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the run in {root} failed:\n{proc.stderr[-4000:]}")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--moe", action="store_true",
                    help="Grok-1's serving step (phase 11) instead")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_step_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    steps = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            run = one(getattr(args, name).resolve(), args.moe)
            steps[name].append(run["ms_per_engine_step"])
            print(name, json.dumps(run), flush=True)
    print(json.dumps({name: {"median_ms_per_engine_step":
                             statistics.median(ms), "runs": ms}
                      for name, ms in steps.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
