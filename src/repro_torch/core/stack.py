"""One-call stack construction: config object -> running data stack.

The port of ``repro.core.stack``.  The config object decides the shape of
the stack:

* a :class:`~repro_torch.core.loader.LoaderConfig` builds the single-host
  chain ``Cluster`` -> ``ConnectionPool`` -> ``CassandraLoader`` ->
  ``DeviceFeed`` / ``ImageFeed``;
* a :class:`~repro_torch.core.multihost.MultiHostConfig` builds a
  :class:`~repro_torch.core.multihost.MultiHostRun`: N sharded loaders
  against one shared cluster or a federation (``clusters=``).  Per-host
  feeds over it are not built here, as in the reference.

    from repro_torch.core import LoaderConfig, build_stack

    stack = build_stack(store=store, uuids=uuids,
                        config=LoaderConfig(route="high", materialize=True),
                        feed="image", image_shape=(256, 256, 3),
                        out_shape=(224, 224), device="cuda")
    batch, meta = next(stack.feed)
    ...
    stack.close()

A ``LoaderConfig`` builds the chain with the loader's own defaulting, so a
``build_stack`` stack is bit-identical to the hand-wired one.

Everything is keyword-only and validated up front: unknown feed kinds,
missing feed parameters, feed requests the config cannot serve and a
``device`` without a card raise at construction, not inside the first
``next_batch``.
"""

from __future__ import annotations

import uuid as _uuid
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from .kvstore import KVStore
from .loader import CassandraLoader, LoaderConfig
from .multihost import MultiHostConfig, MultiHostRun
from .netsim import Clock

FEED_KINDS = (None, "device", "image")


@dataclass
class Stack:
    """What :func:`build_stack` returns — every layer, individually usable.

    ``loader``/``feed`` are populated for a ``LoaderConfig`` stack, ``run``
    for a ``MultiHostConfig`` stack; the rest are always present (for a
    multi-host stack, ``loaders`` lists every per-host loader and
    ``cluster``/``pool`` refer to host 0's view).
    """

    config: "LoaderConfig | MultiHostConfig"
    clock: Clock
    cluster: object
    pool: object
    loader: Optional[CassandraLoader] = None
    feed: Optional[object] = None
    run: Optional[MultiHostRun] = None
    loaders: List[CassandraLoader] = field(default_factory=list)

    def next_batch(self, timeout: float = 600.0):
        """Single-host convenience passthrough to the loader."""
        if self.loader is None:
            raise RuntimeError("next_batch() is a single-host convenience; "
                               "use stack.run for a MultiHostConfig stack")
        return self.loader.next_batch(timeout=timeout)

    def close(self) -> None:
        for ld in (self.loaders or
                   ([self.loader] if self.loader is not None else [])):
            ld.close()


def _build_feed(kind: str, loader: CassandraLoader, *,
                seq_len: Optional[int],
                image_shape: Optional[Tuple[int, int, int]],
                out_shape: Optional[Tuple[int, int]],
                feed_prefetch: int, step_stats, mean, std, feed_seed: int,
                device):
    from repro_torch.data.pipeline import DeviceFeed, ImageFeed
    if kind == "device":
        if seq_len is None:
            raise ValueError("feed='device' needs seq_len=")
        return DeviceFeed(loader, seq_len, prefetch=feed_prefetch,
                          step_stats=step_stats, device=device)
    if seq_len is not None:
        raise ValueError("seq_len= only applies to feed='device'")
    if image_shape is None or out_shape is None:
        raise ValueError("feed='image' needs image_shape=(h, w, c) and "
                         "out_shape=(out_h, out_w)")
    h, w, c = image_shape
    out_h, out_w = out_shape
    return ImageFeed(loader, h, w, c, out_h, out_w, mean=mean, std=std,
                     seed=feed_seed, prefetch=feed_prefetch,
                     step_stats=step_stats, device=device)


def build_stack(*, store: KVStore, uuids: Sequence[_uuid.UUID],
                config: "LoaderConfig | MultiHostConfig",
                clock: Optional[Clock] = None,
                cluster: Optional[object] = None,
                ingress: Optional[object] = None,
                start: bool = False,
                feed: Optional[str] = None,
                seq_len: Optional[int] = None,
                image_shape: Optional[Tuple[int, int, int]] = None,
                out_shape: Optional[Tuple[int, int]] = None,
                feed_prefetch: int = 2,
                step_stats=None,
                mean=None, std=None, feed_seed: int = 0,
                device="cuda") -> Stack:
    """Assemble the data stack from one config object.

    Parameters are those of ``repro.core.build_stack`` plus ``device``,
    where the feed puts its tensors: ``"cuda"`` (default) needs a card and
    raises without one; ``"cpu"`` runs the kernels' plain versions.  A
    ``MultiHostConfig`` stack builds no feed, so it does not use
    ``device``.
    """
    from repro_torch.data.pipeline import resolve_device

    if feed not in FEED_KINDS:
        raise ValueError(f"unknown feed kind {feed!r} "
                         f"(choose from {FEED_KINDS})")
    if isinstance(config, MultiHostConfig):
        if feed is not None:
            raise ValueError("per-host feeds over a MultiHostConfig are not "
                             "built here — build the MultiHostRun stack and "
                             "wrap stack.loaders[i] yourself")
        if clock is not None or cluster is not None or ingress is not None:
            raise ValueError("MultiHostRun owns its clock/cluster/ingress; "
                             "clock=/cluster=/ingress= are single-host only")
        run = MultiHostRun(store, list(uuids), config)
        if start:
            run.start()
        host0 = run.loaders[0]
        return Stack(config=config, clock=run.clock, cluster=run.cluster,
                     pool=host0.pool, run=run, loaders=list(run.loaders))

    if not isinstance(config, LoaderConfig):
        raise TypeError(f"config must be a LoaderConfig or MultiHostConfig, "
                        f"got {type(config).__name__}")
    device = resolve_device(device)
    if feed is not None and not config.materialize:
        raise ValueError(f"feed={feed!r} consumes real payload bytes — set "
                         "materialize=True on the LoaderConfig")

    loader = CassandraLoader(store, list(uuids), config, clock=clock,
                             cluster=cluster, ingress=ingress)
    feed_obj = None
    if feed is not None:
        feed_obj = _build_feed(feed, loader, seq_len=seq_len,
                               image_shape=image_shape, out_shape=out_shape,
                               feed_prefetch=feed_prefetch,
                               step_stats=step_stats, mean=mean, std=std,
                               feed_seed=feed_seed, device=device)
    if start:
        loader.start()
    return Stack(config=config, clock=loader.clock, cluster=loader.cluster,
                 pool=loader.pool, loader=loader, feed=feed_obj,
                 loaders=[loader])


__all__ = ["FEED_KINDS", "Stack", "build_stack"]
