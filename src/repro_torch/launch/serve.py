"""Serving launcher: continuous-batching decode fed by the network loader.

The port of ``repro.launch.serve``: prompts are fetched over the simulated
WAN by the port's ``CassandraLoader`` and served by ``ServingEngine`` on
one card (``--device cuda``, the default) or on the CPU with the kernels'
plain versions (``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="demo")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--route", default="med")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.base import ArchConfig, get_arch
    from repro_torch.core import CassandraLoader, KVStore, LoaderConfig
    from repro_torch.data.datasets import (SyntheticTokenDataset,
                                           decode_token_record, ingest)
    from repro_torch.data.pipeline import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, ServingEngine

    device = resolve_device(args.device)
    if args.arch == "demo":
        cfg = ArchConfig(name="serve-demo", family="dense", n_layers=2,
                         d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                         vocab=2048, head_dim=32, dtype="float32",
                         remat=False)
    else:
        cfg = get_arch(args.arch).smoke_config()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device).manual_seed(args.seed))

    store = KVStore()
    uuids = ingest(store, SyntheticTokenDataset(
        n_samples=max(args.requests * 4, 256), seq_len=12, vocab=cfg.vocab,
        seed=args.seed))
    loader = CassandraLoader(store, uuids, LoaderConfig(
        batch_size=args.requests, prefetch_buffers=2, io_threads=2,
        route=args.route, materialize=True, seed=args.seed)).start()
    try:
        batch = loader.next_batch()
        prompts = [decode_token_record(s.payload)[0] for s in batch.samples]
        engine = ServingEngine(model, params,
                               ServeConfig(batch_slots=args.slots,
                                           max_seq=64,
                                           max_new_tokens=args.max_new_tokens))
        t0 = time.time()
        reqs = engine.run(prompts)
        dt = time.time() - t0
    finally:
        loader.close()
    n_tok = sum(len(r.out_tokens) for r in reqs)
    print(f"served {len(reqs)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.0f} tok/s, {engine.steps} engine steps, "
          f"{args.slots} slots, {device})")


if __name__ == "__main__":
    main()
