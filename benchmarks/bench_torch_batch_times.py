# The twin of benchmarks/bench_batch_times.py for repro_torch: the reference
# file with its imports rewritten and its CSV named
# results/fig4_batch_times_torch.csv.  tests/test_torch_isolation.py holds it
# equal to the original, tests/test_torch_bench_figures.py its rows.
"""Paper Fig. 4: batch loading times, in-order vs out-of-order (high RTT).

The in-order series shows cyclical multi-hundred-ms stalls when a congested
connection gates a batch; OOO stays flat.  Emits the full time series CSV
and prints summary stats.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import tight_loop
from .torch_common import make_loader, make_store, write_csv


def run(n_batches: int = 300, seed: int = 2) -> str:
    store, uuids = make_store()
    lines = [f"{'mode':10s} {'mean(ms)':>9s} {'p50':>7s} {'p99':>8s} "
             f"{'max':>8s}"]
    rows = []
    for ooo in (False, True):
        ld = make_loader(store, uuids, "high", out_of_order=ooo, seed=seed)
        res = tight_loop(ld, n_batches=n_batches)
        bt = res["batch_times"][20:] * 1e3
        mode = "ooo" if ooo else "in-order"
        lines.append(f"{mode:10s} {bt.mean():9.1f} "
                     f"{np.percentile(bt, 50):7.1f} "
                     f"{np.percentile(bt, 99):8.1f} {bt.max():8.1f}")
        for i, v in enumerate(bt):
            rows.append(f"{mode},{i},{v:.3f}")
    write_csv("fig4_batch_times_torch.csv", "mode,batch,gap_ms", rows)
    return "\n".join(lines)


def main() -> None:
    print("# Fig. 4 — batch loading time, in-order vs out-of-order (high)")
    print(run())


if __name__ == "__main__":
    main()
