"""End-to-end training driver on the PyTorch port: an LM trained from the
network loader with checkpoint/restart, OOO prefetching and throughput
accounting.  The twin of ``examples/train_lm.py`` for ``repro_torch``.

The default config is laptop-sized; ``--preset 100m --steps 300`` is the
full-size run for a card (a ~100M-param model; the loop and loader code
are the same).

Run: PYTHONPATH=src python examples/torch_train_lm.py [--steps 120]
     [--device cpu]     (``--device`` defaults to ``cuda``)
"""

import argparse
import os
import tempfile

from repro_torch.configs.base import ArchConfig
from repro_torch.core import KVStore, LoaderConfig
from repro_torch.data.datasets import SyntheticTokenDataset, ingest
from repro_torch.models import build_model
from repro_torch.models.params import count_params
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.optimizer import OptimizerConfig

PRESETS = {
    "tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
                 vocab=4096, head_dim=32, seq=64, batch=16),
    "20m": dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
                vocab=16000, head_dim=32, seq=128, batch=16),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
                 d_ff=3072, vocab=32000, head_dim=64, seq=512, batch=32),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--route", default="high")
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    p = PRESETS[args.preset]
    cfg = ArchConfig(name=f"lm-{args.preset}", family="dense",
                     n_layers=p["n_layers"], d_model=p["d_model"],
                     n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"],
                     d_ff=p["d_ff"], vocab=p["vocab"], head_dim=p["head_dim"],
                     dtype="float32", remat=False)
    model = build_model(cfg, device=args.device)
    n_params = count_params(model.param_specs())
    print(f"model: {n_params/1e6:.1f}M params on {model.device}")

    store = KVStore()
    uuids = ingest(store, SyntheticTokenDataset(
        n_samples=4096, seq_len=p["seq"], vocab=p["vocab"], seed=0))
    loader_cfg = LoaderConfig(batch_size=p["batch"], prefetch_buffers=8,
                              io_threads=4, route=args.route,
                              materialize=True, seed=0)
    loop_cfg = TrainLoopConfig(total_steps=args.steps, seq_len=p["seq"],
                               log_every=10, checkpoint_every=50,
                               checkpoint_dir=args.checkpoint_dir)
    res = run_training(model, store, uuids, loader_cfg, loop_cfg,
                       OptimizerConfig(peak_lr=3e-3, warmup_steps=10,
                                       total_steps=args.steps),
                       on_metrics=lambda m: print(
                           f"step {m['step']:4d} loss {m['loss']:.4f} "
                           f"{m['sps']:.0f} samples/s", flush=True))
    h = res["history"]
    print(f"\nloss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}; checkpoints in "
          f"{args.checkpoint_dir} (restart resumes mid-epoch, batch-exact)")


if __name__ == "__main__":
    main()
