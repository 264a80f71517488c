"""Training launcher: the port of ``repro.launch.train``.

Runs end to end on one host: ingest a synthetic token dataset into the KV
store and train the demo model (``--arch demo``) or a config's
``smoke_config()`` (``--arch grok_1_314b``, ...) for N steps from the
network loader (virtual-clock WAN), with checkpoint/restart when
``--checkpoint-dir`` is given, on one card (``--device cuda``, the
default) or on the CPU (``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu

``--demo`` is accepted and changes nothing: this is the only mode, as in
the reference.  ``--arch whisper_tiny`` raises ``KeyError('frames')``, as
the reference's launcher does: the training loop feeds each step tokens
and a loss mask only, and Whisper's forward needs frame embeddings.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--demo", action="store_true",
                    help="accepted for older command lines; the single-host "
                         "end-to-end run is the only mode")
    ap.add_argument("--arch", default="demo",
                    help="'demo' (a 4-layer, d=256 LM) or a config id, "
                         "run at its smoke_config()")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--route", default="high")
    ap.add_argument("--out-of-order", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import ArchConfig, get_arch
    from repro_torch.core import KVStore, LoaderConfig
    from repro_torch.data.datasets import SyntheticTokenDataset, ingest
    from repro_torch.data.pipeline import resolve_device
    from repro_torch.models import build_model
    from repro_torch.train.loop import TrainLoopConfig, run_training

    device = resolve_device(args.device)
    if args.arch == "demo":
        cfg = ArchConfig(name="demo-120m", family="dense", n_layers=4,
                         d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
                         vocab=32000, head_dim=32, dtype="float32",
                         remat=False)
    else:
        cfg = get_arch(args.arch).smoke_config()
    model = build_model(cfg, device=device)

    store = KVStore()
    uuids = ingest(store, SyntheticTokenDataset(
        n_samples=max(args.batch_size * 64, 2048), seq_len=args.seq_len,
        vocab=cfg.vocab, seed=args.seed))
    loader_cfg = LoaderConfig(batch_size=args.batch_size, prefetch_buffers=8,
                              io_threads=8, route=args.route,
                              out_of_order=bool(args.out_of_order),
                              materialize=True, seed=args.seed)
    loop_cfg = TrainLoopConfig(total_steps=args.steps, seq_len=args.seq_len,
                               checkpoint_dir=args.checkpoint_dir or None,
                               seed=args.seed)
    result = run_training(model, store, uuids, loader_cfg, loop_cfg,
                          on_metrics=lambda m: print(
                              f"step {m['step']:5d} loss {m['loss']:.4f} "
                              f"{m['sps']:.0f} samples/s", flush=True))
    first, last = result["history"][0], result["history"][-1]
    print(f"loss {first['loss']:.4f} -> {last['loss']:.4f} over "
          f"{args.steps} steps on {device}")


if __name__ == "__main__":
    main()
