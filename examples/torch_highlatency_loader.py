# The twin of examples/highlatency_loader.py for repro_torch: the
# reference file with its imports rewritten; it runs only the copied
# loader on the virtual clock and touches no device.
# tests/test_torch_isolation.py holds it equal to the original, and
# tests/test_torch_bench_figures.py holds its output equal.
"""The paper's core result as a demo: out-of-order vs in-order prefetching
over a simulated intercontinental (150 ms RTT) link — Fig. 4 / Sec. 4.3.1.

Run: PYTHONPATH=src python examples/torch_highlatency_loader.py
"""

import numpy as np

from repro_torch.core import KVStore, LoaderConfig, build_stack, tight_loop
from repro_torch.data.datasets import SyntheticImageDataset, ingest


def main() -> None:
    store = KVStore()
    uuids = ingest(store, SyntheticImageDataset(n_samples=120_000, seed=0))
    print(f"dataset: {len(uuids)} images, {store.total_bytes()/1e9:.1f} GB "
          "(ImageNet-1k statistics), stored in the Cassandra-model KV store\n")

    print(f"{'strategy':26s} {'throughput':>12s} {'batch gap p50/p99/max (ms)':>28s}")
    for ooo, ramp, flow, label in [
        (False, False, "static", "in-order, eager fill"),
        (False, True, "static", "in-order, incremental"),
        (True, True, "static", "OOO + incremental (paper)"),
        (True, True, "adaptive", "OOO + adaptive flow ctl"),
    ]:
        cfg = LoaderConfig(batch_size=512, prefetch_buffers=16, io_threads=16,
                           out_of_order=ooo, incremental_ramp=ramp,
                           route="high", backend="scylla", seed=2,
                           flow_control=flow)
        ld = build_stack(store=store, uuids=uuids, config=cfg).loader
        res = tight_loop(ld, n_batches=200)
        bt = res["batch_times"][20:] * 1e3
        extra = ""
        if ld.flow_controller is not None:
            peak = max(b for _, b in ld.flow_controller.budget_trace)
            extra = (f"   (BDP-driven window: peak {peak} samples, "
                     f"{ld.flow_controller.backoffs} congestion backoffs — "
                     "no hand-tuned k)")
        print(f"{label:26s} {res['throughput_Bps']/1e9:9.2f} GB/s "
              f"{np.percentile(bt,50):8.0f} /{np.percentile(bt,99):5.0f} "
              f"/{bt.max():5.0f}{extra}")
    print("\nOOO assembles batches from whichever samples arrive first, so a "
          "congested route never gates the pipeline (labels travel with "
          "features — any sample is self-contained).  The adaptive row "
          "measures the 150 ms route's bandwidth-delay product and sizes the "
          "in-flight window itself (core/flowctl.py).")


if __name__ == "__main__":
    main()
