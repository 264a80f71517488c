"""Baseline loader models the paper compares against (Table 2).

Both run against the *same* network/storage simulator as our loader, so the
comparison isolates loader strategy from environment:

``RecordShardLoader`` — MosaicML StreamingDataset model: the dataset is
pre-packed into record-file shards; the client keeps ``predownload`` shard
downloads in flight, each over a *fresh* connection (S3-style GET: 2-RTT
setup + AIMD ramp from half rate — short-lived connections never reach
capacity at high RTT, which is exactly why SD degrades intercontinentally).
Samples are then served from completed shards with a window shuffle (the
non-uniform shuffle the paper criticizes).

``SyncWindowLoader`` — tf.data service model: a synchronous request/response
stream with a bounded in-flight window; throughput ~ window/(RTT + overhead),
collapsing with distance as in Table 3.

Both baselines are deliberately **codec-free**: neither system ships a wire
codec in the configuration the paper measures, so their requests take the
node ``serve()`` / ``SimConnection.request`` default path (``wire_bytes =
payload bytes``, ``encode_seconds = 0``).  Our stack is allowed to enable
codecs in the comparison — that asymmetry is part of the result, not a bug.
``benchmarks/bench_competitors.py`` runs both against the adaptive stack on
the same scenario cells.
"""

from __future__ import annotations

import dataclasses
import uuid as _uuid
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from .cluster import Cluster
from .kvstore import KVStore
from .netsim import (Clock, RateResource, RouteProfile, SimConnection, TIERS,
                     NIC_BANDWIDTH)


@dataclass
class ShardSpec:
    uuids: List[_uuid.UUID]
    nbytes: int


def build_shards(store: KVStore, uuids: List[_uuid.UUID],
                 shard_bytes: int = 64 * 2 ** 20) -> List[ShardSpec]:
    """Pack samples into record-file shards in *storage* order (rigid)."""
    shards: List[ShardSpec] = []
    cur: List[_uuid.UUID] = []
    acc = 0
    for u in uuids:
        row = store.get_data(u)
        cur.append(u)
        acc += row.size
        if acc >= shard_bytes:
            shards.append(ShardSpec(cur, acc))
            cur, acc = [], 0
    if cur:
        shards.append(ShardSpec(cur, acc))
    return shards


class RecordShardLoader:
    """MosaicML-SD-style shard streaming over the simulated network.

    Codec-free by design: StreamingDataset's shard GETs carry the packed
    record bytes as-is, so every ``SimConnection.request`` here uses the
    default ``wire_bytes``/``encode_seconds`` path (wire == payload, no
    node-side encode CPU).  Time-varying routes are honoured: the capped
    route is derived with ``dataclasses.replace``, keeping burst/schedule/
    outage fields, and the AIMD model samples them at event time.
    """

    S3_SETUP_RTTS = 2.0             # TCP+TLS handshake per GET
    S3_STREAM_CAP = 45.0e6          # per-object GET throughput ceiling, B/s
    S3_FIRST_BYTE = 0.030           # request processing at the gateway
    S3_PIECE = 4 * 2 ** 20          # stream shards in pieces so TCP ramps

    def __init__(self, clock: Clock, cluster: Cluster, route: str | RouteProfile,
                 shards: List[ShardSpec], batch_size: int = 512,
                 predownload: int = 8, seed: int = 0) -> None:
        self.clock = clock
        self.cluster = cluster
        self.route = TIERS[route] if isinstance(route, str) else route
        self.batch_size = batch_size
        self.predownload = predownload
        self._rng = np.random.default_rng(seed)
        order = self._rng.permutation(len(shards))  # shard-level shuffle only
        self._shards = [shards[i] for i in order]
        self._next_shard = 0
        self._ready_samples: List[tuple] = []   # (uuid, size)
        self._downloading = 0
        self._consumed_batches = 0
        self.bytes_received = 0
        self.batch_consume_t: List[float] = []
        self._ingress = RateResource("sd/ingress", NIC_BANDWIDTH)
        self._conn_seq = 0
        self._node = list(cluster.nodes.values())[0]

    # -- shard downloads -----------------------------------------------------
    def _start_downloads(self) -> None:
        while (self._downloading < self.predownload
               and self._next_shard < len(self._shards)):
            shard = self._shards[self._next_shard]
            self._next_shard += 1
            self._downloading += 1
            # fresh connection per GET: setup + AIMD ramp from half rate.
            # replace() keeps every other RouteProfile field (burst model,
            # schedules, outages) — a positional rebuild here once silently
            # dropped them, pinning competitor runs to a static network.
            cap_route = dataclasses.replace(
                self.route,
                conn_capacity=min(self.route.conn_capacity,
                                  self.S3_STREAM_CAP))
            conn = SimConnection(self._conn_seq, self.clock, self._node, cap_route,
                                 np.random.default_rng(1000 + self._conn_seq),
                                 self._ingress)
            self._conn_seq += 1
            setup = self.S3_SETUP_RTTS * self.route.rtt + self.S3_FIRST_BYTE

            def fire(sh=shard, cn=conn):
                # stream the shard in pieces so the fresh connection's AIMD
                # rate actually ramps during the transfer
                n_pieces = max(sh.nbytes // self.S3_PIECE, 1)
                state = {"left": n_pieces}

                def piece_done(t, sh=sh):
                    state["left"] -= 1
                    if state["left"] == 0:
                        self._shard_done(sh)

                per = sh.nbytes // n_pieces
                for _ in range(n_pieces):
                    cn.request(per, piece_done)

            self.clock.schedule(setup, fire)

    def _shard_done(self, shard: ShardSpec) -> None:
        self._downloading -= 1
        self.bytes_received += shard.nbytes
        sizes = [self.cluster.store.get_data(u).size for u in shard.uuids]
        samples = list(zip(shard.uuids, sizes))
        self._ready_samples.extend(samples)
        # window shuffle inside the download buffer (non-uniform by design)
        self._rng.shuffle(self._ready_samples)
        self._start_downloads()

    # -- consumption ---------------------------------------------------------
    def start(self) -> "RecordShardLoader":
        self._start_downloads()
        return self

    def next_batch(self, timeout: float = 600.0) -> List[tuple]:
        ok = self.clock.run_until(
            lambda: len(self._ready_samples) >= self.batch_size, timeout=timeout)
        if not ok:
            raise TimeoutError("RecordShardLoader starved")
        batch = self._ready_samples[:self.batch_size]
        del self._ready_samples[:self.batch_size]
        self._consumed_batches += 1
        self.batch_consume_t.append(self.clock.now())
        self._start_downloads()
        return batch

    def throughput(self, skip: int = 2) -> float:
        if len(self.batch_consume_t) <= skip + 1:
            return 0.0
        t0, t1 = self.batch_consume_t[skip], self.batch_consume_t[-1]
        n = len(self.batch_consume_t) - skip - 1
        avg_b = self.bytes_received / max(self._consumed_batches, 1)
        return n * avg_b / max(t1 - t0, 1e-9)


class SyncWindowLoader:
    """tf.data-service-style synchronous streaming: bounded window per RTT.

    Codec-free by design: the tf.data service protocol streams serialized
    elements uncompressed, so the modelled round-trip carries raw payload
    bytes — no wire codec, no node-side encode CPU.  The analytic window
    model only samples route RTT/capacity, so it is insensitive to the
    schedule-aware route extensions by construction.
    """

    WINDOW_BYTES = 1.3e6            # in-flight element window
    OVERHEAD = 0.0012               # serialization + dispatcher overhead, s
    STREAM_BW = 1.3e9               # worker->client stream rate, B/s

    def __init__(self, clock: Clock, cluster: Cluster, route: str | RouteProfile,
                 avg_sample_bytes: int, batch_size: int = 512, seed: int = 0) -> None:
        self.clock = clock
        self.route = TIERS[route] if isinstance(route, str) else route
        self.batch_size = batch_size
        self.avg_sample_bytes = avg_sample_bytes
        self._rng = np.random.default_rng(seed)
        self.bytes_received = 0
        self.batch_consume_t: List[float] = []
        self._buffered = 0.0        # samples available client-side
        self._round_pending = False

    def _round_trip(self) -> None:
        if self._round_pending:
            return
        self._round_pending = True
        transfer = self.WINDOW_BYTES / min(self.route.conn_capacity * 2,
                                           self.STREAM_BW)
        dt = self.route.rtt + self.OVERHEAD + transfer
        jitter = 1.0 + 0.05 * float(self._rng.uniform(-1, 1))

        def done() -> None:
            self._round_pending = False
            self.bytes_received += self.WINDOW_BYTES
            self._buffered += self.WINDOW_BYTES / self.avg_sample_bytes
            if self._buffered < 4 * self.batch_size:
                self._round_trip()

        self.clock.schedule(dt * jitter, done)

    def start(self) -> "SyncWindowLoader":
        self._round_trip()
        return self

    def next_batch(self, timeout: float = 3000.0) -> int:
        def ready() -> bool:
            if self._buffered < self.batch_size and not self._round_pending:
                self._round_trip()
            return self._buffered >= self.batch_size

        ok = self.clock.run_until(ready, timeout=timeout)
        if not ok:
            raise TimeoutError("SyncWindowLoader starved")
        self._buffered -= self.batch_size
        self.batch_consume_t.append(self.clock.now())
        self._round_trip()
        return self.batch_size

    def throughput(self, skip: int = 2) -> float:
        if len(self.batch_consume_t) <= skip + 1:
            return 0.0
        t0, t1 = self.batch_consume_t[skip], self.batch_consume_t[-1]
        n = len(self.batch_consume_t) - skip - 1
        return n * self.batch_size * self.avg_sample_bytes / max(t1 - t0, 1e-9)


__all__ = ["ShardSpec", "build_shards", "RecordShardLoader", "SyncWindowLoader"]
