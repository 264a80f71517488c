"""Loader -> PyTorch device feeds.

Bridges the paper's loader (AssembledBatch of token-record or pixel blobs)
to tensors on one device:
  * ``DeviceFeed`` decodes token records on host (numpy) and uploads them;
  * ``ImageFeed`` uploads uint8 frames and runs the fused
    crop/mirror/normalize kernel on the device;
  * both keep a device-side prefetch queue of depth 2 (double buffering) —
    the on-device mirror of the paper's host-side prefetching — and report
    per-step waits to ``StepStats`` on the loader's clock;
  * with ``core.spans`` on, each ``__next__`` is the span ``feed.next``,
    over ``feed.wait`` (the loader's ``next_batch``) and ``feed.form``.

``device`` defaults to ``"cuda"`` and raises without a card; ``"cpu"``
runs the kernels' plain versions.  ``DeviceFeed`` also lays batches out
on a device mesh (``shardings``, ``mesh``) as DTensors: the whole global
batch in a world of one process, each process's own rows in a larger
one.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.core.loader import CassandraLoader
from repro_torch.core.spans import span
from repro_torch.core.stats import StepStats
from repro_torch.data.datasets import decode_token_record
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import crop_mirror_normalize_np
from repro_torch.sharding.rules import shard_batch_spec


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when no
    card is present, and for any device type other than cpu, cuda and
    meta (shapes only: the dry run's models)."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"device must be cpu, cuda or meta, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} needs a CUDA device and "
                           "none is available; pass device='cpu' to run the "
                           "kernels' plain versions on the CPU")
    return dev


def batch_to_numpy(batch, seq_len: int, pad_id: int = 0) -> Dict[str, np.ndarray]:
    """Decode an AssembledBatch of token records into dense arrays.

    Reads through ``batch.payloads()`` so arena-backed batches (whose
    per-sample ``payload`` refs were dropped at assembly) decode from
    zero-copy slab views, and legacy batches keep decoding their bytes.
    """
    B = len(batch.samples)
    tokens = np.full((B, seq_len), pad_id, dtype=np.int32)
    mask = np.zeros((B, seq_len), dtype=np.float32)
    labels = np.zeros((B,), dtype=np.int32)
    for i, payload in enumerate(batch.payloads()):
        if payload is None:
            raise ValueError("pipeline requires materialized payloads "
                             "(LoaderConfig.materialize=True)")
        toks, label = decode_token_record(payload)
        n = min(len(toks), seq_len)
        tokens[i, :n] = toks[:n]
        mask[i, :n] = 1.0
        labels[i] = label
    return {"tokens": tokens, "loss_mask": mask, "labels": labels}


class _DoubleBufferedFeed:
    """The device-side prefetch queue both feeds share.

    Every ``__next__`` reports to ``step_stats`` how long it blocked on the
    loader — on the *loader's* clock — and whether the batch was served
    straight from an already-assembled buffer.  ``state()`` is the loader
    position rewound by the batches sitting in the device queue, so a
    restore from it is exactly-once.  Subclasses turn an AssembledBatch into
    device tensors in ``_form``.
    """

    def __init__(self, loader: CassandraLoader, prefetch: int,
                 step_stats: Optional[StepStats], device) -> None:
        self.device = resolve_device(device)
        self.loader = loader
        self.prefetch = prefetch
        self.step_stats = step_stats or StepStats(loader.clock)
        self._queue: collections.deque = collections.deque()
        self._started = False

    def _form(self, batch) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _pull_one(self) -> tuple:
        """Pull one batch from the loader onto the device queue.  Returns
        ``(wait_seconds, buffer_hit)`` on the loader's clock."""
        hit = self.loader.ready_batches > 0
        clk = self.loader.clock
        t0 = clk.now()
        with span("feed.wait"):
            batch = self.loader.next_batch()
        wait = clk.now() - t0
        with span("feed.form"):
            formed = self._form(batch)
        self._queue.append((formed, batch))
        return wait, hit

    def state(self) -> dict:
        """Consumer-facing loader position: the loader cursor rewound by the
        device-queue batches the consumer has not taken yet."""
        return self.loader.state(rewind_batches=len(self._queue))

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        with span("feed.next"):
            wait, hit = 0.0, True
            if not self._started:
                if not self.loader.started:
                    self.loader.start()
                self._started = True
                for _ in range(self.prefetch):
                    w, h = self._pull_one()
                    wait += w
                    hit = hit and h
            dev_batch, meta = self._queue.popleft()
            w, h = self._pull_one()          # refill behind the consumer
            self.step_stats.on_wait(wait + w, blocked=not (hit and h))
            return dev_batch, meta


class DeviceFeed(_DoubleBufferedFeed):
    """Iterator of device-resident token batches with double buffering.

    ``shardings`` (optional) maps a batch key (``tokens``, ``loss_mask``,
    ``labels``) to a ``sharding.rules.NamedSharding``; with ``mesh``, a
    key it does not name gets ``shard_batch_spec(mesh, ndim)``, the
    data-parallel default.  Such a key comes as a DTensor: in a world of
    one process the loader's batch is the global batch, placed with
    ``distribute_tensor`` (the reference's ``jax.device_put(v, sh)``); in
    a larger world it is this process's rows, and ``DTensor.from_local``
    joins them (``jax.make_array_from_process_local_data``)."""

    def __init__(self, loader: CassandraLoader, seq_len: int,
                 prefetch: int = 2,
                 step_stats: Optional[StepStats] = None,
                 device="cuda", shardings: Optional[Dict] = None,
                 mesh=None) -> None:
        super().__init__(loader, prefetch, step_stats, device)
        self.seq_len = seq_len
        self.shardings = shardings or {}
        self.mesh = mesh

    def _put(self, key: str, value: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(value).to(self.device)
        sh = self.shardings.get(key)
        if sh is None and self.mesh is not None:
            sh = shard_batch_spec(self.mesh, t.dim())
        if sh is None:
            return t
        if dist.get_world_size() > 1:
            return DTensor.from_local(t, sh.mesh, sh.placements)
        return distribute_tensor(t, sh.mesh, sh.placements)

    def _form(self, batch) -> Dict[str, torch.Tensor]:
        host = batch_to_numpy(batch, self.seq_len)
        # The decoded arrays own their bytes: recycle the arena slab (no-op
        # without one).
        batch.release()
        return {k: self._put(k, v) for k, v in host.items()}


class ImageFeed(_DoubleBufferedFeed):
    """Loader -> device feed for fixed-size pixel rows (e.g.
    ``SyntheticPixelDataset``) with fused on-device crop/mirror/normalize.

    Two host paths, selected by whether the loader carries a pinned arena
    (``LoaderConfig.use_arena=True``):

    * **arena**: ``batch.pixels()`` views the slab as one contiguous
      ``(B, h, w, c)`` uint8 array, a *single* copy puts it on the device,
      and ``kernels.ops.crop_mirror_normalize`` does the crop + mirror +
      uint8->f32 + normalize + HWC->CHW in one kernel.
    * **materialize** (baseline): per-sample ``np.frombuffer`` -> stack ->
      the NumPy transform -> upload of the float output.

    Both paths draw crop offsets / mirror flags from the same seeded numpy
    stream (one draw per batch, in pull order, oy -> ox -> mirror), so two
    runs that differ only in the path — or a run of this feed and one of
    ``repro``'s with equal seeds — produce identical augmentations.
    Per-batch host prep wall time (everything up to and including the
    host-to-device copy, *not* device compute) accumulates in
    ``host_prep_s``.
    """

    def __init__(self, loader: CassandraLoader, h: int, w: int, c: int,
                 out_h: int, out_w: int,
                 mean=None, std=None, seed: int = 0, prefetch: int = 2,
                 step_stats: Optional[StepStats] = None,
                 device="cuda") -> None:
        super().__init__(loader, prefetch, step_stats, device)
        self.h, self.w, self.c = h, w, c
        self.out_h, self.out_w = out_h, out_w
        self.mean = np.asarray(
            mean if mean is not None else [127.5] * c, dtype=np.float32)
        self.std = np.asarray(
            std if std is not None else [64.0] * c, dtype=np.float32)
        self._mean_t = torch.from_numpy(self.mean).to(self.device)
        self._std_t = torch.from_numpy(self.std).to(self.device)
        self.mode = "arena" if getattr(loader, "arena", None) else "materialize"
        self.host_prep_s = 0.0
        self.batches = 0
        self._rng = np.random.default_rng(seed)

    def _augment_draws(self, B: int):
        oy = self._rng.integers(0, self.h - self.out_h + 1, size=B)
        ox = self._rng.integers(0, self.w - self.out_w + 1, size=B)
        mirror = self._rng.integers(0, 2, size=B)
        return (oy.astype(np.int32), ox.astype(np.int32),
                mirror.astype(np.int32))

    def _form(self, batch) -> Dict[str, torch.Tensor]:
        B = len(batch.samples)
        oy, ox, mirror = self._augment_draws(B)
        labels = batch.labels
        if self.mode == "arena":
            t0 = time.perf_counter()
            pix = batch.pixels(self.h, self.w, self.c)   # zero-copy view
            # ONE uint8 copy of the slab.  To the card it is a synchronous
            # copy from pageable memory; on the CPU copy=True makes a private
            # copy (torch.from_numpy alone would alias the slab).  Either
            # way the slab is no longer read once this returns, so it is
            # released right after and the arena may recycle it.
            img = torch.from_numpy(pix).to(self.device, copy=True)
            self.host_prep_s += time.perf_counter() - t0
            batch.release()
            aug = torch.from_numpy(np.stack([oy, ox, mirror])).to(self.device)
            images = kernel_ops.crop_mirror_normalize(
                img, aug[0], aug[1], aug[2], self._mean_t, self._std_t,
                out_h=self.out_h, out_w=self.out_w)
        else:
            t0 = time.perf_counter()
            n = self.h * self.w * self.c
            imgs = np.stack([
                np.frombuffer(p, dtype=np.uint8,
                              count=n).reshape(self.h, self.w, self.c)
                for p in batch.payloads()])
            host = crop_mirror_normalize_np(
                imgs, oy, ox, mirror, self.mean, self.std,
                self.out_h, self.out_w)
            images = torch.from_numpy(host).to(self.device)
            self.host_prep_s += time.perf_counter() - t0
        self.batches += 1
        return {"images": images,
                "labels": torch.from_numpy(labels).to(self.device)}


__all__ = ["DeviceFeed", "ImageFeed", "batch_to_numpy", "resolve_device"]
