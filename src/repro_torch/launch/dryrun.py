"""Multi-pod dry run: count every (arch x shape) cell on the production
mesh, per device, and dump the roofline inputs: the port of
``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID]
        [--shape NAME] [--multi-pod | --both-meshes] [--out FILE]

It needs no card: each cell's step runs once on ``meta`` tensors over a
fake process group of the mesh's size (``launch.dryrun_lib``), as the
reference compiles for forced host devices.  A failing cell is listed and
the exit code is 1.  A cell takes seconds to minutes (Kimi-K2's train
step unrolls 61 layers of 384 experts in Python).
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.configs.base import ARCH_IDS, applicable_shapes, get_arch
from repro_torch.launch.dryrun_lib import run_cell
from repro_torch.launch.mesh import destroy, make_production_mesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Multi-pod dry-run: count every (arch x shape) cell's "
                    "step per device on the production mesh and dump "
                    "roofline inputs.")
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="shape name or 'all' (applicable shapes only)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 multi-pod mesh (default 16x16)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run each cell on single-pod AND multi-pod meshes")
    ap.add_argument("--out", default="",
                    help="append JSON-lines results to this file")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    pods = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    results = []
    try:
        for arch_id in archs:
            cfg = get_arch(arch_id)
            shapes = (applicable_shapes(cfg) if args.shape == "all"
                      else [args.shape])
            for shape_name in shapes:
                for multi_pod in pods:
                    # one fake group at a time: each mesh is made anew
                    mesh = make_production_mesh(multi_pod=multi_pod)
                    try:
                        results.append(run_cell(arch_id, shape_name, mesh))
                    except Exception as e:  # a failure here is a port bug
                        failures.append((arch_id, shape_name,
                                         "x".join(map(str, mesh.shape)),
                                         repr(e)[:500]))
                        print(f"[dryrun] FAIL {arch_id} {shape_name}: {e!r}",
                              file=sys.stderr, flush=True)
    finally:
        destroy()
    if args.out:
        with open(args.out, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    print(f"[dryrun] {len(results)} cells OK, {len(failures)} failed")
    for f_ in failures:
        print("  FAIL:", *f_[:3])
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
