"""End-to-end training loop: loader -> device feed -> train step ->
checkpoint, with mid-epoch fault-tolerant restart.  The port of
``repro.train.loop``.

The loader stack comes from ``build_stack`` (the same chain the reference
wires by hand: ``CassandraLoader`` -> ``DeviceFeed``), on the model's
device.  On a cluster the same loop runs per host with
``LoaderConfig.shard_id`` / ``num_shards`` set from the process rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import KVStore, LoaderConfig, VirtualClock, build_stack
from repro_torch.core.spans import span
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import init_state, make_train_step


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    seq_len: int = 128
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    seed: int = 0
    # Compute seconds charged to the timeline per step instead of the
    # measured wall time of the step.  With a virtual-clock loader this
    # pins the consumer side of the simulation (deterministic stall /
    # goodput numbers — what the goodput bench gates on); None (default)
    # charges the measured step time.
    charge_step_time: Optional[float] = None


def run_training(model, store: KVStore, uuids, loader_cfg: LoaderConfig,
                 loop_cfg: TrainLoopConfig,
                 opt_cfg: Optional[OptimizerConfig] = None,
                 state: Optional[Dict] = None,
                 on_metrics: Optional[Callable] = None) -> Dict:
    """Train ``model`` from the network loader.

    Returns ``{"state", "history", "stats", "step_stats",
    "loader_stats"}`` — history records carry ``loss``/``sps`` plus
    per-step data-stall accounting (``stall_frac``, ``goodput_sps``),
    ``stats`` is the ``StepStats.summary`` at skip=1 (the first, warm-up
    step excluded) and ``step_stats`` the raw ``core.stats.StepStats`` for
    custom skips.  Beyond the reference's result, each record also carries
    the step's ``grad_norm`` (and a MoE model's ``moe_aux_loss``,
    ``moe_z_loss`` and ``moe_dropped_frac``), and ``loader_stats`` is the
    loader's ``LoaderStats``.
    """
    opt_cfg = opt_cfg or OptimizerConfig(total_steps=loop_cfg.total_steps)
    step_fn = make_train_step(model, opt_cfg)
    device = model.device

    def fresh_state() -> Dict:
        return init_state(model, opt_cfg,
                          torch.Generator(device).manual_seed(loop_cfg.seed))

    ckpt = (CheckpointManager(loop_cfg.checkpoint_dir)
            if loop_cfg.checkpoint_dir else None)
    start_step = 0
    loader_pos = {"epoch": 0, "cursor": 0}
    if state is None:
        if ckpt and ckpt.latest_step() is not None:
            state, manifest = ckpt.restore(fresh_state())
            start_step = manifest["step"]
            loader_pos = manifest["extra"].get("loader", loader_pos)
        else:
            state = fresh_state()

    stack = build_stack(store=store, uuids=uuids, config=loader_cfg,
                        feed="device", seq_len=loop_cfg.seq_len,
                        device=device)
    loader, feed = stack.loader, stack.feed
    loader.start(epoch=loader_pos["epoch"], cursor=loader_pos["cursor"])
    # adaptive runs resume at the checkpointed operating point instead of
    # re-slow-starting from scratch (no-op in static mode / old checkpoints)
    loader.restore_flow(loader_pos.get("flow"))
    ss = feed.step_stats
    clk = loader.clock
    virtual = isinstance(clk, VirtualClock)
    B = loader_cfg.batch_size

    def ckpt_extra() -> Dict:
        # the *feed's* position (loader cursor rewound by device-queued
        # batches) — checkpointing loader.state() directly would skip the
        # in-flight batches on restore
        pos = feed.state()
        flow = loader.flow_snapshot()
        if flow is not None:
            pos["flow"] = flow
        return {"loader": pos}

    history = []
    t0 = None                 # set after the first step: sps excludes the
    #                           warm-up baked into step one
    for step in range(start_step, loop_cfg.total_steps):
        dev_batch, _meta = next(feed)
        batch = {"tokens": dev_batch["tokens"],
                 "loss_mask": dev_batch["loss_mask"]}
        with span("train.step"):         # the interval ``compute`` times
            c0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            compute = time.perf_counter() - c0
        if loop_cfg.charge_step_time is not None:
            compute = loop_cfg.charge_step_time
        if virtual:
            # charge compute to the sim timeline: in-flight transfers
            # progress during the step, and wait/compute share one clock
            clk.sleep(compute)
        ss.on_compute(compute, t_end=clk.now())
        if t0 is None:
            t0 = time.time()
        if (step + 1) % loop_cfg.log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            rec = {"step": step + 1, "loss": loss,
                   "grad_norm": float(metrics["grad_norm"]),
                   "sps": (step - start_step) * B
                   / max(time.time() - t0, 1e-9),
                   "stall_frac": ss.stall_frac(skip=1),
                   "goodput_sps": ss.goodput_sps(B, skip=1)}
            rec.update((k, float(v)) for k, v in metrics.items()
                       if k.startswith("moe_"))
            history.append(rec)
            if on_metrics:
                on_metrics(rec)
        if ckpt and (step + 1) % loop_cfg.checkpoint_every == 0:
            ckpt.save(step + 1, state, extra=ckpt_extra(), blocking=False)
    if ckpt:
        ckpt.save(loop_cfg.total_steps, state, extra=ckpt_extra(),
                  blocking=True)
    loader.close()
    return {"state": state, "history": history,
            "stats": ss.summary(B, skip=1), "step_stats": ss,
            "loader_stats": loader.stats}


__all__ = ["TrainLoopConfig", "run_training"]
