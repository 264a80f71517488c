"""Shared fixtures of the benchmark's CPU tests: a tiny checkout of the
benchmark (configurations, mixes, limits and a ``BENCHMARK.json`` of
their own) that the real harness runs on the CPU with the kernels' plain
versions."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

# One CPU thread, as a run on the card takes (``run.pin_caches``): the
# tiny ops of these runs otherwise wait on the thread pool.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[2]
for p in (REPO, REPO / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

SEED = 2 ** 33 + 7

CONFIGS = {
    "tiny-moe": {"name": "tiny-moe", "source": "test", "family": "moe",
                 "n_layers": 2, "d_model": 64, "n_heads": 4,
                 "n_kv_heads": 2, "head_dim": 16, "d_ff": 128,
                 "vocab": 512, "n_experts": 4, "top_k": 2,
                 "capacity_factor": 1.25, "rope_theta": 10000.0,
                 "norm_eps": 1e-5, "max_seq": 4096, "dtype": "float32",
                 "remat": False},
    "tiny-dense": {"name": "tiny-dense", "source": "test",
                   "family": "dense", "n_layers": 2, "d_model": 64,
                   "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
                   "d_ff": 128, "vocab": 512, "rope_theta": 10000.0,
                   "norm_eps": 1e-5, "max_seq": 64, "dtype": "float32",
                   "remat": True},
}

SERVE_LIMITS = {"check_slots": 4, "off_gap": 1e-3,
                "limits": {"off_share_worst_request": 0.05}}
TRAIN_LIMITS = {"limits": {"loss_gap": 1e-4, "grad_norm_gap": 1e-3,
                           "change_norm_gap": 1e-3}}
SERVE_CELLS = ["tiny-moe.tchat", "tiny-moe.tsess"]
TRAIN_CELLS = ["tiny-dense.ttrain"]


def mixes() -> dict:
    traffic = REPO / "perfbench" / "traffic"
    chat = json.loads((traffic / "chat.json").read_text())
    chat.update(slots=4, prompts=64, prompt_len=[2, 6], max_new_tokens=4,
                warmup_steps=2, warmup_cache=32,
                trace={"after_s": 0.5, "steps": 6})
    sess = dict(chat, prompt_len=[2, 5], max_new_tokens=3, start_pos=64)
    train = json.loads((traffic / "train_4k.json").read_text())
    train.update(rows=2, seq_len=64, dataset_rows=64,
                 trace={"after_steps": 1, "steps": 2})
    return {"tchat": chat, "tsess": sess, "ttrain": train}


def write_root(root: Path) -> Path:
    """A checkout of the tiny benchmark at ``root``."""
    pb = root / "perfbench"
    for d in ("configs", "traffic", "workloads"):
        (pb / d).mkdir(parents=True, exist_ok=True)
    for name, c in CONFIGS.items():
        (pb / "configs" / f"{name}.json").write_text(json.dumps(c))
    for name, m in mixes().items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(m))
    for cell in SERVE_CELLS:
        (pb / "workloads" / f"{cell}.json").write_text(
            json.dumps(SERVE_LIMITS))
    for cell in TRAIN_CELLS:
        (pb / "workloads" / f"{cell}.json").write_text(
            json.dumps(TRAIN_LIMITS))
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    serve_e2e = ["gen_tokens_per_s", "ttft_p95_ms"]
    bench = {
        "command": real["command"], "paths": real["paths"],
        "run_seconds": real["run_seconds"],
        "configs": [{"name": n, "source": "test",
                     "file": f"perfbench/configs/{n}.json", "reduced": [],
                     "why": "test"} for n in CONFIGS],
        "workloads": [{"name": c, "config": c.rsplit(".", 1)[0],
                       "traffic": c.rsplit(".", 1)[1], "chips": 1,
                       "why": "test"} for c in SERVE_CELLS + TRAIN_CELLS],
        "end_to_end": [
            dict(m, workloads=SERVE_CELLS if m["name"] in serve_e2e
                 else TRAIN_CELLS) if "workloads" in m else m
            for m in real["end_to_end"]],
        "per_layer": [
            dict(m, workloads=SERVE_CELLS if m["moves"] in serve_e2e
                 else TRAIN_CELLS) for m in real["per_layer"]],
    }
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return write_root(tmp_path_factory.mktemp("tiny"))


def execute(root: Path, name: str, trace: bool = False,
            control: bool = False, seconds: float = 2.0) -> dict:
    import time

    import torch

    from perfbench import run
    return run.execute(root, name, SEED, seconds, trace,
                       torch.device("cpu"), time.perf_counter(),
                       control=control)
