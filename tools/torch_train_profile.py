"""Where the time of the port's train step goes, on one card.

Builds ``--arch`` (Qwen3-4B, ``configs/qwen3_4b.py``, by default; any
dense, MoE, VLM or hybrid config; full width, bf16, remat, seeded random
weights) with ``--layers`` of its layers (all by default), runs
``--warmup`` train steps on a seeded (``--batch`` x ``--seq``) token
batch, then:

* times the step's two halves with the host clock around synchronised
  work, as medians over ``--repeats``: the forward and backward
  (``train_loss`` + ``torch.autograd.grad``) and the AdamW update;
* times one whole step the same way (``step_ms``);
* profiles one more step with ``torch.profiler`` (CPU and CUDA
  activities) and prints the kernels with the most device time, the
  matrix-multiply kernels' time (cuBLAS, cuBLASLt and CUTLASS GEMMs)
  against the rest (elementwise, copies, reductions), and the device's
  busy and idle share of the profiled step (busy = the union of the
  kernels' device intervals).  The profiler slows the host, so the idle
  share of an unprofiled step is also given, derived as 1 - busy time
  / ``step_ms``;
* splits the profiled step's kernel time by where it was launched
  (``scope_times``): AdamW (the port's ``train.optimizer`` span, with
  ``core.spans`` on for the profiled step), and for Hymba the Mamba scan
  (``ssm._ssm_scan_chunked``: its forward, remat's recompute of it and
  the backward autograd runs for it).

    python3 tools/torch_train_profile.py [--arch qwen3_4b] [--layers 36]
        [--batch 2] [--seq 4096]
    python3 tools/torch_train_profile.py --arch grok_1_314b --layers 1 \\
        --seq 2048             # chip_smoke.py's phase C
    python3 tools/torch_train_profile.py --arch hymba_1_5b  # phase I

Needs a CUDA card.  Prints the card's name and power limit first and one
JSON line of results last.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.params import (tree_leaves,  # noqa: E402
                                      tree_unflatten)
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         adamw_update)
from repro_torch.train.step import init_state, make_train_step  # noqa: E402


GEMM_MARKS = ("gemm", "xmma", "cutlass", "nvjet")
# Profiler markers that carry device timestamps but are not kernels.
NOT_KERNELS = ("Command Buffer Full",)
# the annotations whose work ``scope_times`` splits out
SCOPES = ("mamba_scan", "train.optimizer")


def _kernels(prof) -> list:
    """(name, start_us, end_us) of every kernel the profile saw."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in NOT_KERNELS
            and not getattr(e, "is_user_annotation", False)]


def annotated(label: str, fn):
    """``fn`` run under the profiler annotation ``label``."""
    def run(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return run


@contextlib.contextmanager
def spans_on():
    """The port's spans on within the block (so that a profiler running
    there sees them as annotations), off and cleared after."""
    spans.enable()
    try:
        yield
    finally:
        spans.disable()
        spans.take()


def scope_times(events, labels, time_of) -> dict:
    """{label: time} of the work launched under each CPU annotation in
    ``labels``, ``time_of(event)`` being an event's own time (its own
    kernels' device time on the card).  An op counts for a label if its
    nearest enclosing annotation or backward function is that label's
    annotation, or a backward function that autograd ran for an op under
    it (the backward function's sequence number and forward thread name
    that op); ops that an enclosing backward function ran with autograd
    recording (remat's recompute of other code) count for none."""
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    seqs = {}
    for e in cpu:
        if e.name in labels:
            stack = list(e.cpu_children)
            while stack:
                c = stack.pop()
                if c.sequence_nr >= 0:
                    seqs[c.sequence_nr, c.thread] = e.name
                stack.extend(c.cpu_children)
    out = {label: 0.0 for label in labels}
    for e in cpu:
        t = time_of(e)
        if not t:
            continue
        recording = False
        p = e
        while p is not None:
            if p.name in labels:
                out[p.name] += t
                break
            if p.scope == 1:                        # a backward function
                if not recording and (p.sequence_nr, p.fwd_thread) in seqs:
                    out[seqs[p.sequence_nr, p.fwd_thread]] += t
                break
            recording = recording or p.sequence_nr >= 0
            p = p.cpu_parent
    return out


def _union_us(spans) -> float:
    total, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    cfg = get_arch(args.arch)
    cfg = cfg.scaled(n_layers=args.layers or cfg.n_layers, remat=True)
    model = build_model(cfg, device=dev)
    opt = OptimizerConfig(peak_lr=3e-4, warmup_steps=2, total_steps=100)
    gen = torch.Generator(dev).manual_seed(0)
    state = init_state(model, opt, gen)
    batch = {"tokens": torch.randint(0, cfg.vocab, (args.batch, args.seq),
                                     generator=gen, device=dev,
                                     dtype=torch.int32),
             "loss_mask": torch.ones((args.batch, args.seq), device=dev)}
    step = make_train_step(model, opt)
    for _ in range(args.warmup):
        state, _ = step(state, batch)
    torch.cuda.synchronize(dev)

    params = state["params"]
    leaves = tree_leaves(params)
    halves = {"forward_backward_ms": [], "adamw_ms": []}
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        loss, _ = model.train_loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        grads = tree_unflatten(params, list(grads))
        _, state["opt"], _ = adamw_update(grads, state["opt"], params, opt)
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        halves["forward_backward_ms"].append((t1 - t0) * 1e3)
        halves["adamw_ms"].append((t2 - t1) * 1e3)
        del loss, grads

    t0 = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize(dev)
    step_ms = (time.perf_counter() - t0) * 1e3

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with mock.patch.object(ssm, "_ssm_scan_chunked", annotated(
            "mamba_scan", ssm._ssm_scan_chunked)), spans_on(), \
            torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _kernels(prof)
    busy_ms = _union_us([(a, b) for _, a, b in kernels]) / 1e3
    by_name: dict = {}
    for name, a, b in kernels:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (b - a) / 1e3, n + 1)
    gemm_ms = sum(ms for name, (ms, _) in by_name.items()
                  if any(m in name.lower() for m in GEMM_MARKS))
    kernel_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    scopes = {k: us / 1e3 for k, us in scope_times(
        prof.events(), SCOPES,
        lambda e: e.self_device_time_total).items()}
    print(f"{'kernel':72s} {'calls':>7s} {'device ms':>11s} {'share':>7s}")
    for name, (ms, n) in top:
        print(f"{name[:72]:72s} {n:7d} {ms:11.3f} {ms / wall_ms:7.3f}")
    out = {"device": torch.cuda.get_device_name(0), "arch": args.arch,
           "layers": args.layers,
           "batch": args.batch, "seq": args.seq,
           **{k: statistics.median(v) for k, v in halves.items()},
           "step_ms": step_ms,
           "profiled_step_wall_ms": wall_ms, "kernels": len(kernels),
           "kernel_ms": kernel_ms, "gemm_kernel_ms": gemm_ms,
           "scope_kernel_ms": scopes,
           "scope_share_of_kernel_time": {k: ms / kernel_ms
                                          for k, ms in scopes.items()},
           "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "unprofiled_idle_share_derived": 1.0 - busy_ms / step_ms,
           "peak_GB": torch.cuda.max_memory_allocated(dev) / 1e9,
           "top_kernels": [{"kernel": name[:160], "calls": n,
                            "device_ms": ms} for name, (ms, n) in top]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
