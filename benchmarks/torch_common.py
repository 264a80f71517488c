"""Shared benchmark scaffolding: dataset, loader factory, CSV helpers."""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import (CassandraLoader, KVStore, LoaderConfig,
                              tight_loop)
from repro_torch.data.datasets import SyntheticImageDataset, ingest

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "results")

# paper test parameters (Table 1): ImageNet-1k-like, batch 512
BATCH_SIZE = 512
IO_THREADS = 16          # 32 TCP connections, as in Figs. 5/6
PREFETCH_BUFFERS = 16

_STORE_CACHE: Dict[int, tuple] = {}


def make_store(n_samples: int = 200_000, seed: int = 0):
    key = (n_samples, seed)
    if key not in _STORE_CACHE:
        store = KVStore()
        uuids = ingest(store, SyntheticImageDataset(n_samples=n_samples,
                                                    seed=seed))
        _STORE_CACHE[key] = (store, uuids)
    return _STORE_CACHE[key]


def make_loader(store, uuids, route: str, *, out_of_order=True,
                incremental_ramp=True, backend="scylla", seed=1,
                batch_size=BATCH_SIZE, prefetch_buffers=PREFETCH_BUFFERS,
                io_threads=IO_THREADS) -> CassandraLoader:
    cfg = LoaderConfig(batch_size=batch_size, prefetch_buffers=prefetch_buffers,
                       io_threads=io_threads, out_of_order=out_of_order,
                       incremental_ramp=incremental_ramp, route=route,
                       backend=backend, seed=seed)
    return CassandraLoader(store, uuids, cfg)


def write_csv(name: str, header: str, rows: List[str]) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, name)
    with open(path, "w") as f:
        f.write(header + "\n")
        for r in rows:
            f.write(r + "\n")
    return path


def mean_std(values: List[float]) -> str:
    a = np.asarray(values)
    if len(a) > 1:
        return f"{a.mean():.0f} ± {a.std():.0f}"
    return f"{a.mean():.0f}"
