"""Wire codecs and the zero-copy arena on the port: the row hot path, end to
end.  The twin of ``benchmarks/bench_wirefmt.py`` for ``repro_torch``.

**A. codec x route** (virtual clock, over the copied ``core/wirefmt.py``).
Lazy rows stream through the adaptive flow controller on the 150 ms
``high`` route and the ``local`` route.  The checks are the reference's:
byteshuffle gains >= 1.3x on the high route, the controller's budget
deepens >= 1.1x under it, the codec buys <= 10% on the local route, and
``wire_codec="none"`` is bit-identical to a pool built with no codec.  The
gated metrics equal ``benchmarks/baselines/wirefmt.json`` exactly
(``torch_gate``).

**B. arena + fused device decode** (wall clock).  Real pixel rows go
through ``build_stack``'s ``ImageFeed`` on ``--device``: the arena
path uploads each batch as one uint8 slab and runs the crop/mirror/
normalize kernel (``csrc/crop_norm.cu`` on a card, its plain version on
the CPU); the materialize path is the classic host pipeline.  A warm-up
builds and launches the kernel before the timed window.  The reference's
three checks: equal tensors (1e-5, here on every batch, over the same rows
and labels), host prep on the arena path <= 0.5x the materialize path, and
slab reuse.  On a card the kernel's launches must also equal the arena
batches formed.  On the CPU the "device" work is host work, so the
host-prep check is reported there and not judged.  ``chip_smoke.py``
drives the image lane's main path through the same ``compare_paths``.

Results land in ``results/wirefmt_torch.json``.

    PYTHONPATH=src python -m benchmarks.bench_torch_wirefmt [--quick] \\
        [--device cpu]

``--device`` defaults to ``cuda`` (a card is needed).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core import (CassandraLoader, Cluster, ConnectionPool,
                              KVStore, LoaderConfig, build_stack)
from repro_torch.core.netsim import VirtualClock
from repro_torch.data.datasets import SyntheticPixelDataset, ingest
from repro_torch.data.pipeline import resolve_device
from repro_torch.kernels import crop_norm
from repro_torch.kernels import ops as kernel_ops

from . import torch_gate
from .torch_common import make_store

SEED = 13
BATCH = 256
# The arena check that times the host: judged on a card only.
HOST_CPU_CHECK = "arena.arena_halves_host_cpu"


# ---------------------------------------------------------------------------
# Section A: codec x route
# ---------------------------------------------------------------------------


def codec_sizes(quick: bool) -> dict:
    n_batches = 150 if quick else 300
    return {"n_samples": 20_000 if quick else 50_000, "n_batches": n_batches,
            "skip": 100 if quick else 200,
            "local_batches": max(40, n_batches // 3)}


def codec_cfg(route: str, codec: str, n_nodes: int) -> LoaderConfig:
    return LoaderConfig(batch_size=BATCH, route=route, wire_codec=codec,
                        flow_control="adaptive", seed=SEED, n_nodes=n_nodes,
                        replication_factor=min(2, n_nodes))


def run_codec_cell(store, uuids, cfg: LoaderConfig, n_batches: int,
                   skip: int) -> dict:
    loader = CassandraLoader(store, uuids, cfg)
    loader.start()
    for _ in range(n_batches):
        loader.next_batch()
    st = loader.stats
    pool = loader.pool
    return {
        "MBps": st.throughput(skip=skip) / 1e6,
        "wire_MB": pool.bytes_received / 1e6,
        "payload_MB": pool.payload_bytes_received / 1e6,
        "budget_samples": loader.flow_controller.budget(),
        "encode_cpu_s": sum(n.encode_cpu_seconds
                            for n in loader.cluster.nodes.values()),
        "decode_cpu_s": pool.decode_cpu_seconds,
    }


def _identity_cell(store, uuids, n_batches: int) -> dict:
    """wire_codec="none" vs a pool constructed with NO codec argument:
    identical batch timeline, wire == payload, zero codec CPU."""
    runs = {}
    for tag in ("explicit_none", "default"):
        cfg = LoaderConfig(batch_size=BATCH, route="high",
                           flow_control="adaptive", seed=SEED, n_nodes=2,
                           replication_factor=2)
        if tag == "explicit_none":
            cfg.wire_codec = "none"
            loader = CassandraLoader(store, uuids, cfg)
        else:
            # the pool exactly as pre-codec callers build it
            clock = VirtualClock()
            cluster = Cluster(clock, store, backend=cfg.backend,
                              n_nodes=cfg.n_nodes, rf=cfg.replication_factor,
                              seed=cfg.seed + 5)
            pool = ConnectionPool(clock, cluster, cfg.route,
                                  io_threads=cfg.io_threads,
                                  conns_per_thread=cfg.conns_per_thread,
                                  seed=cfg.seed + 11)
            loader = CassandraLoader(store, uuids, cfg, clock=clock,
                                     cluster=cluster, pool=pool)
        loader.start()
        for _ in range(n_batches):
            loader.next_batch()
        runs[tag] = {
            "ready_t": list(loader.stats.batch_ready_t),
            "wire": loader.pool.bytes_received,
            "payload": loader.pool.payload_bytes_received,
            "encode_cpu_s": sum(n.encode_cpu_seconds
                                for n in loader.cluster.nodes.values()),
            "decode_cpu_s": loader.pool.decode_cpu_seconds,
        }
    a, b = runs["explicit_none"], runs["default"]
    return {
        "timeline_equal": a["ready_t"] == b["ready_t"],
        "wire_eq_payload": (a["wire"] == a["payload"]
                            and b["wire"] == b["payload"]),
        "zero_codec_cpu": (a["encode_cpu_s"] == 0.0 == a["decode_cpu_s"]
                           and b["encode_cpu_s"] == 0.0 == b["decode_cpu_s"]),
    }


def run_codec_section(quick: bool) -> dict:
    sz = codec_sizes(quick)
    store, uuids = make_store(n_samples=sz["n_samples"], seed=3)
    cells = {"high": {}, "local": {}}
    codecs = ["none", "byteshuffle"] if quick else ["none", "byteshuffle",
                                                    "int8"]
    for codec in codecs:
        # high: 4 nodes — the AIMD wire is the only bottleneck
        cells["high"][codec] = run_codec_cell(
            store, uuids, codec_cfg("high", codec, n_nodes=4),
            sz["n_batches"], sz["skip"])
    for codec in ("none", "byteshuffle"):
        # local: ONE node — its encode pool sits just below the NIC rate
        cells["local"][codec] = run_codec_cell(
            store, uuids, codec_cfg("local", codec, n_nodes=1),
            sz["local_batches"], 2)
    identity = _identity_cell(store, uuids, n_batches=40)
    gain_high = (cells["high"]["byteshuffle"]["MBps"]
                 / cells["high"]["none"]["MBps"])
    gain_local = (cells["local"]["byteshuffle"]["MBps"]
                  / cells["local"]["none"]["MBps"])
    budget_ratio = (cells["high"]["byteshuffle"]["budget_samples"]
                    / cells["high"]["none"]["budget_samples"])
    return {
        "cells": cells,
        "gain_high": gain_high,
        "gain_local": gain_local,
        "budget_ratio": budget_ratio,
        "identity": identity,
        "checks": {
            "high_codec_gain": gain_high >= 1.3,
            "codec_deepens_budget": budget_ratio >= 1.1,
            "local_codec_no_gain": gain_local <= 1.1,
            "none_bit_identical": all(identity.values()),
        },
    }


# ---------------------------------------------------------------------------
# Section B: pinned arena + fused on-device decode
# ---------------------------------------------------------------------------


def arena_sizes(quick: bool) -> dict:
    return {"batch_size": 32 if quick else 64,
            "n_batches": 8 if quick else 24,
            "n_samples": 1024 if quick else 4096, "hw": 64, "out_hw": 56}


def _pixel_stack(store, uuids, ds, use_arena: bool, batch_size: int,
                 out_hw: int, device, route: str, mean, std):
    cfg = LoaderConfig(batch_size=batch_size, route=route,
                       materialize=True, use_arena=use_arena,
                       arena_slot_bytes=ds.nbytes, seed=SEED)
    return build_stack(store=store, uuids=uuids, config=cfg, feed="image",
                       image_shape=(ds.h, ds.w, ds.c),
                       out_shape=(out_hw, out_hw), mean=mean, std=std,
                       feed_seed=SEED + 1, device=device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_up(device, batch_size: int, hw: int, out_hw: int) -> None:
    """Build and launch the crop kernel and make the device's first copy,
    so neither path's timed window pays first-call costs."""
    zero = torch.zeros(batch_size, dtype=torch.int32, device=device)
    kernel_ops.crop_mirror_normalize(
        torch.zeros((batch_size, hw, hw, 3), dtype=torch.uint8,
                    device=device), zero, zero, zero,
        torch.zeros(3, device=device), torch.ones(3, device=device),
        out_h=out_hw, out_w=out_hw)
    torch.from_numpy(np.zeros((batch_size, 3, out_hw, out_hw),
                              np.float32)).to(device)
    _sync(device)


def compare_paths(store, uuids, ds, *, device, batch_size: int,
                  n_batches: int, out_hw: int, route: str = "local",
                  mean=None, std=None) -> dict:
    """The materialize path, then the arena path, over the same rows: each
    path's host prep, wall time, loader rate, batches formed and crop
    launches (the kernel's counter read before and after the path), every
    batch's images held against the other path's, and the reference's
    checks.  Raises if the paths fetch different rows or labels."""
    out = {}
    ref_batches = []
    diffs = []
    for mode, use_arena in (("materialize", False), ("arena", True)):
        stack = _pixel_stack(store, uuids, ds, use_arena, batch_size,
                             out_hw, device, route, mean, std)
        launches0 = crop_norm.launches
        t0 = time.perf_counter()
        for i in range(n_batches):
            dev, meta = next(stack.feed)
            if not use_arena:
                ref_batches.append((meta.uuids, dev))
                continue
            want_uuids, want = ref_batches[i]
            if meta.uuids != want_uuids or not torch.equal(dev["labels"],
                                                           want["labels"]):
                raise AssertionError(f"batch {i}: the two paths fetched "
                                     "different rows or labels")
            diffs.append((dev["images"] - want["images"]).abs().max())
        _sync(device)
        wall = time.perf_counter() - t0
        feed = stack.feed
        out[mode] = {
            "host_prep_s": feed.host_prep_s,
            "host_prep_ms_per_batch": feed.host_prep_s / feed.batches * 1e3,
            "wall_s": wall,
            "loader_MBps": stack.loader.stats.throughput(skip=2) / 1e6,
            "batches_formed": feed.batches,
            "crop_launches": crop_norm.launches - launches0,
        }
        if use_arena:
            out[mode]["arena"] = stack.loader.arena.stats()
            out[mode]["images"] = {"shape": list(dev["images"].shape),
                                   "dtype": str(dev["images"].dtype)}
        stack.close()

    ratio = out["arena"]["host_prep_s"] / out["materialize"]["host_prep_s"]
    max_diff = float(torch.stack(diffs).max())     # a NaN stays a NaN
    stats = out["arena"]["arena"]
    checks = {
        "arena_matches_materialize": max_diff <= 1e-5,
        "arena_halves_host_cpu": ratio <= 0.5,
        "arena_reuses_slabs": (stats["slabs_created"] <= 3
                               and stats["reuses"] > 0),
    }
    if device.type == "cuda":
        checks["arena_kernel_launch_per_batch"] = (
            out["arena"]["crop_launches"] == out["arena"]["batches_formed"]
            and out["materialize"]["crop_launches"] == 0)
    return {
        "device": str(device),
        "batch_size": batch_size,
        "modes": out,
        "host_cpu_ratio": ratio,
        "max_abs_diff": max_diff,
        "checks": checks,
    }


def run_arena_section(quick: bool, device="cuda") -> dict:
    device = resolve_device(device)
    sz = arena_sizes(quick)
    ds = SyntheticPixelDataset(n_samples=sz["n_samples"], h=sz["hw"],
                               w=sz["hw"], c=3, seed=5)
    store = KVStore()
    uuids = ingest(store, ds)
    warm_up(device, sz["batch_size"], sz["hw"], sz["out_hw"])
    return compare_paths(store, uuids, ds, device=device,
                         batch_size=sz["batch_size"],
                         n_batches=sz["n_batches"], out_hw=sz["out_hw"])


# ---------------------------------------------------------------------------


def run_all(quick: bool, device="cuda") -> dict:
    device = resolve_device(device)
    codec = run_codec_section(quick)
    arena = run_arena_section(quick, device)
    sz = codec_sizes(quick)
    return {
        "quick": quick,
        "batch_size": BATCH,
        "n_samples": sz["n_samples"],
        "n_batches": sz["n_batches"],
        "seed": SEED,
        "device": str(device),
        "codec": codec,
        "arena": arena,
        "checks": {**{f"codec.{k}": v for k, v in codec["checks"].items()},
                   **{f"arena.{k}": v for k, v in arena["checks"].items()}},
    }


def print_arena(arena: dict) -> None:
    m = arena["modes"]
    print(f"  arena on {arena['device']} (B={arena['batch_size']}): host "
          f"prep {m['arena']['host_prep_ms_per_batch']!r} ms/batch against "
          f"{m['materialize']['host_prep_ms_per_batch']!r} materialize, "
          f"ratio {arena['host_cpu_ratio']!r}, max|diff| "
          f"{arena['max_abs_diff']!r}, crop launches "
          f"{m['arena']['crop_launches']} for "
          f"{m['arena']['batches_formed']} batches formed, slabs "
          f"{m['arena']['arena']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="CI sizing (smaller dataset, fewer batches)")
    ap.add_argument("--device", default="cuda",
                    help="where the arena section's feed runs (default cuda)")
    args = ap.parse_args(argv)
    print(f"== bench_torch_wirefmt ({'quick' if args.quick else 'full'}, "
          f"{args.device}) ==")
    results = run_all(args.quick, args.device)
    codec = results["codec"]
    print(f"  codec: high gain {codec['gain_high']!r}x (budget "
          f"{codec['budget_ratio']!r}x deeper), local gain "
          f"{codec['gain_local']!r}x")
    print_arena(results["arena"])
    reported = () if results["device"].startswith("cuda") \
        else (HOST_CPU_CHECK,)
    return torch_gate.finish("wirefmt.json", results, quick=args.quick,
                             reported_only=reported)


if __name__ == "__main__":
    sys.exit(main())
