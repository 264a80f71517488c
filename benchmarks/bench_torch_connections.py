# The twin of benchmarks/bench_connections.py for repro_torch: the reference
# file with its imports rewritten and its CSV named
# results/fig56_connections_torch.csv.  tests/test_torch_isolation.py holds it
# equal to the original, tests/test_torch_bench_figures.py its rows.
"""Paper Figs. 5/6: per-connection transfer rates, in-order vs OOO.

In-order: per-connection throughputs correlate (everything waits for the
slowest) and the aggregate oscillates.  OOO: connections proceed
independently; aggregate is high and steady.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import tight_loop
from .torch_common import make_loader, make_store, write_csv


def run(n_batches: int = 300, seed: int = 2, window: float = 0.5) -> str:
    store, uuids = make_store()
    lines = [f"{'mode':9s} {'agg mean':>9s} {'agg min':>9s} {'agg max':>9s} "
             f"{'conn spread(max/min)':>21s}  (MB/s)"]
    rows = []
    for ooo in (False, True):
        ld = make_loader(store, uuids, "high", out_of_order=ooo, seed=seed)
        tight_loop(ld, n_batches=n_batches)
        mode = "ooo" if ooo else "in-order"
        traces = ld.pool.throughput_traces(window)
        # aggregate per window
        n_windows = max(len(t) for t in traces.values() if t)
        agg = np.zeros(n_windows)
        per_conn_mean = []
        for cid, series in traces.items():
            vals = np.zeros(n_windows)
            for i, (t, bps) in enumerate(series):
                vals[i] = bps / 1e6
                rows.append(f"{mode},{cid},{t:.1f},{bps/1e6:.1f}")
            agg[:len(vals)] += vals
            if vals[2:-2].size:
                per_conn_mean.append(vals[2:-2].mean())
        steady = agg[3:-2] if agg.size > 6 else agg
        spread = (max(per_conn_mean) / max(min(per_conn_mean), 1e-9)
                  if per_conn_mean else 0)
        lines.append(f"{mode:9s} {steady.mean():9.0f} {steady.min():9.0f} "
                     f"{steady.max():9.0f} {spread:21.1f}")
    write_csv("fig56_connections_torch.csv", "mode,conn,t,MBps", rows)
    return "\n".join(lines)


def main() -> None:
    print("# Figs. 5/6 — 32 connection transfer rates (high latency)")
    print(run())


if __name__ == "__main__":
    main()
