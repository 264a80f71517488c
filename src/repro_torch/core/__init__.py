"""repro_torch.core — the paper's loader: out-of-order, incremental
prefetching over NoSQL storage, copied from ``repro.core``.

Only the single-host stack and the splits are ported; multi-host,
federation, replication, tenancy, scenarios and competitors are queued
(see ROADMAP.md).
"""

from .arena import ArenaSlab, PinnedArena
from .batch_loader import AssembledBatch, BatchAssembler
from .cluster import Cluster, TokenRing
from .connection import ConnectionPool, FetchResult
from .flowctl import (FlowControlConfig, FlowController,
                      FlowControllerGroup, SharedIngressLimiter,
                      merge_snapshots)
from .kvstore import DataRow, KVStore, MetaRow, make_uuid, token_of
from .loader import CassandraLoader, LoaderConfig, consume_with_step_time, tight_loop
from .netsim import (BACKENDS, CASSANDRA, SCYLLA, TIERS, Clock, EventHandle,
                     RealClock, RouteProfile, RouteSchedule, VirtualClock,
                     route_bdp_samples)
from .placement import (PLACEMENT_POLICIES, global_order,
                        preferred_node_subsets, replica_local_fraction,
                        split_strips)
from .prefetcher import (EpochPlan, InOrderPrefetcher, OutOfOrderPrefetcher,
                         PrefetchConfig, compute_reflow, make_prefetcher)
from .splits import SplitSpec, check_entity_independence, create_splits
from .stack import FEED_KINDS, Stack, build_stack
from .stats import LoaderStats, StepStats
from .wirefmt import (WIRE_CODECS, ByteShuffleCodec, Int8QuantCodec,
                      NoneCodec, WireCodec, get_codec)

__all__ = [
    "ArenaSlab", "PinnedArena",
    "WIRE_CODECS", "WireCodec", "NoneCodec", "ByteShuffleCodec",
    "Int8QuantCodec", "get_codec",
    "AssembledBatch", "BatchAssembler", "Cluster", "TokenRing",
    "ConnectionPool", "FetchResult", "FlowControlConfig", "FlowController",
    "FlowControllerGroup", "SharedIngressLimiter", "merge_snapshots",
    "DataRow", "KVStore", "MetaRow", "make_uuid", "token_of",
    "CassandraLoader", "LoaderConfig", "consume_with_step_time", "tight_loop",
    "BACKENDS", "CASSANDRA", "SCYLLA", "TIERS", "Clock", "RealClock",
    "RouteProfile", "RouteSchedule", "route_bdp_samples", "VirtualClock",
    "EventHandle", "EpochPlan", "FEED_KINDS", "Stack", "build_stack",
    "compute_reflow", "PLACEMENT_POLICIES", "global_order",
    "preferred_node_subsets", "replica_local_fraction", "split_strips",
    "InOrderPrefetcher", "OutOfOrderPrefetcher", "PrefetchConfig",
    "make_prefetcher", "LoaderStats", "StepStats", "SplitSpec",
    "check_entity_independence", "create_splits",
]
