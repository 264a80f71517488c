"""Quickstart on the PyTorch port: the paper's full data path in about a
minute.  The twin of ``examples/quickstart.py`` for ``repro_torch``.

1. ingest a synthetic dataset (data + metadata, atomic inserts) into the
   Cassandra-model KV store;
2. create entity-independent train/val splits from metadata (Sec. 3.2);
3. load batches over a simulated 150 ms-RTT intercontinental link with
   out-of-order, incremental prefetching (Sec. 3.4);
4. feed train steps of a tiny LM through the PyTorch device feed.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(``--device`` defaults to ``cuda`` and needs a card.)
"""

import argparse

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import (KVStore, LoaderConfig, SplitSpec, build_stack,
                              create_splits)
from repro_torch.data.datasets import SyntheticTokenDataset, ingest
from repro_torch.models import build_model
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import init_state, make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)

    # 1. ingest ------------------------------------------------------------
    store = KVStore()
    uuids = ingest(store, SyntheticTokenDataset(n_samples=2048, seq_len=64,
                                                vocab=2048, seed=0))
    print(f"ingested {len(uuids)} samples "
          f"({store.total_bytes() / 1e6:.1f} MB, data+metadata atomic)")

    # 2. automatic splits ----------------------------------------------------
    splits = create_splits(store.scan_metadata(),
                           SplitSpec(fractions=(0.9, 0.1), seed=0))
    print({k: len(v) for k, v in splits.items()}, "(entity-independent)")

    # 3+4a. one call builds the whole data stack: cluster -> pool -> loader
    #       -> DeviceFeed, over a simulated 150 ms RTT route with
    #       out-of-order + incremental prefetch
    stack = build_stack(store=store, uuids=splits["train"],
                        config=LoaderConfig(
                            batch_size=32, prefetch_buffers=8, io_threads=4,
                            route="high", out_of_order=True,
                            incremental_ramp=True, materialize=True, seed=0),
                        feed="device", seq_len=64, device=args.device)
    loader = stack.loader

    # 4. train a tiny LM from the stream ------------------------------------
    cfg = ArchConfig(name="quickstart-lm", family="dense", n_layers=2,
                     d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                     vocab=2048, head_dim=32, dtype="float32", remat=False)
    model = build_model(cfg, device=args.device)
    opt = OptimizerConfig(peak_lr=3e-3, warmup_steps=5,
                          total_steps=args.steps)
    state = init_state(model, opt,
                       torch.Generator(model.device).manual_seed(0))
    step = make_train_step(model, opt)

    feed = stack.feed
    for i in range(args.steps):
        batch, _ = next(feed)
        state, metrics = step(state, {"tokens": batch["tokens"],
                                      "loss_mask": batch["loss_mask"]})
        if (i + 1) % 10 == 0 or i + 1 == args.steps:
            print(f"step {i+1:3d} loss {float(metrics['loss']):.4f} "
                  f"(loader: {loader.prefetcher.describe()})")
    st = loader.stats
    print(f"loader throughput {st.throughput(skip=2)/1e6:.1f} MB/s over a "
          f"simulated 150 ms-RTT link; batch-gap p99 "
          f"{1e3 * float(np.percentile(st.batch_times(1), 99)):.0f} ms "
          f"(train steps on {model.device})")
    stack.close()


if __name__ == "__main__":
    main()
