"""Serving on the PyTorch port: continuous-batching decode with prompts
fetched from the KV store over the network loader (the paper's
Triton-inference analogue: clients request inference on samples that live
in a remote Cassandra).  The twin of ``examples/serve_decode.py`` for
``repro_torch``.

Run: PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]
(``--device`` defaults to ``cuda``: decode attention then runs the
flash-decode kernel.)
"""

import argparse
import time

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import KVStore, LoaderConfig, build_stack
from repro_torch.data.datasets import (SyntheticTokenDataset,
                                       decode_token_record, ingest)
from repro_torch.models import build_model
from repro_torch.serve import ServeConfig, ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ArchConfig(name="serve-demo", family="dense", n_layers=2,
                     d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                     vocab=2048, head_dim=32, dtype="float32", remat=False)
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator(model.device).manual_seed(0))

    # prompts live in the remote store; fetch them with the OOO loader
    store = KVStore()
    uuids = ingest(store, SyntheticTokenDataset(n_samples=256, seq_len=12,
                                                vocab=cfg.vocab, seed=1))
    loader = build_stack(store=store, uuids=uuids, config=LoaderConfig(
        batch_size=16, prefetch_buffers=2, io_threads=2, route="med",
        materialize=True, seed=1), start=True,
        device=model.device).loader
    try:
        batch = loader.next_batch()
        prompts = [decode_token_record(s.payload)[0] for s in batch.samples]
        engine = ServingEngine(model, params,
                               ServeConfig(batch_slots=8, max_seq=64,
                                           max_new_tokens=16))
        t0 = time.time()
        reqs = engine.run(prompts)
        dt = time.time() - t0
    finally:
        loader.close()
    n_tokens = sum(len(r.out_tokens) for r in reqs)
    print(f"served {len(reqs)} requests / {n_tokens} tokens in {dt:.2f}s "
          f"({n_tokens/dt:.0f} tok/s on {model.device}) over {engine.steps} "
          f"engine steps (continuous batching, 8 slots)")
    r = reqs[0]
    print(f"request 0: prompt={list(prompts[0][:6])}... -> "
          f"out={r.out_tokens[:8]}...")


if __name__ == "__main__":
    main()
