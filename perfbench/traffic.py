"""The general traffic generator: every mix is a data file it reads.

A mix (``perfbench/traffic/<name>.json``) gives sizes and counts; the
generator turns them and a seed into inputs.  Every seed gets the same
lengths (quantiles of the mix's distribution) in the same order, so that
a seed changes the tokens and the weights, and neither how much work a
run holds nor how a closed loop schedules it.  Token contents are
uniform draws over the vocabulary.  Rows reach the program as records in its data store, read
back through its loader.
"""

from __future__ import annotations

import math
from typing import Iterator, Tuple

import numpy as np

from perfbench import weights


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(weights.subseed(seed, tag))


def log_uniform_lengths(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` integer lengths at the quantiles (i + 0.5) / n of a
    log-uniform distribution over [lo, hi], in one fixed shuffled order
    that no seed changes."""
    q = (np.arange(n) + 0.5) / n
    lens = np.floor(np.exp(math.log(lo) + q * (math.log(hi + 1)
                                                 - math.log(lo))))
    lens = np.clip(lens, lo, hi).astype(np.int64)
    return rng(0, "lengths").permutation(lens)


def token_rows(n: int, length: int, vocab: int, seed: int) -> np.ndarray:
    """(n, length) int32 token ids, uniform over the vocabulary."""
    return rng(seed, "tokens").integers(0, vocab, size=(n, length),
                                        dtype=np.int32)


class Records:
    """Rows as the program's data store holds them: one token record each,
    its label the row's index, with seeded ids; duck-types the datasets
    that ``repro_torch.data.datasets.ingest`` takes."""

    def __init__(self, rows: np.ndarray, seed: int):
        self.rows_ = rows
        self.seed = seed

    def rows(self) -> Iterator[Tuple[object, object]]:
        from repro_torch.core.kvstore import DataRow, MetaRow, make_uuid
        from repro_torch.data.datasets import encode_token_record
        ids = rng(self.seed, "uuids")
        for i, row in enumerate(self.rows_):
            u = make_uuid(ids)
            blob = encode_token_record(row, i)
            yield (DataRow(u, i, len(blob), payload=blob),
                   MetaRow(u, f"ent{i % 64:04d}", i, {}))


def store_of(rows: np.ndarray, seed: int):
    """A data store holding ``rows``, and their ids in row order."""
    from repro_torch.core import KVStore
    from repro_torch.data.datasets import ingest
    store = KVStore()
    return store, ingest(store, Records(rows, seed))


__all__ = ["log_uniform_lengths", "token_rows", "Records",
           "store_of", "rng"]
