"""The port's multi-host loader is the reference's, bit for bit: the same
small store and config go through ``repro.core`` and ``repro_torch.core``
(each run built by its package's ``build_stack(MultiHostConfig)``), and the
run reports, the ``checkpoint()`` dicts and the delivered batches are equal
on every case below; ``build_stack`` makes the reference's refusals.  The
scenario cells, the competitor loaders and the multi-host example are held
the same way."""

import contextlib
import dataclasses
import importlib.util
import inspect
import io
import math
import uuid as _uuid
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref_core
import repro.core.competitors as ref_competitors
import repro_torch.core as port_core
import repro_torch.core.competitors as port_competitors
from repro.data import datasets as ref_datasets
from repro_torch.data import datasets as port_datasets

ROOT = Path(__file__).resolve().parents[1]
N_SAMPLES = 2400
COMPETITORS = {ref_core: ref_competitors, port_core: port_competitors}


@pytest.fixture(scope="module")
def stores():
    out = {}
    for core, datasets in ((ref_core, ref_datasets),
                           (port_core, port_datasets)):
        store = core.KVStore()
        uuids = datasets.ingest(store, datasets.SyntheticImageDataset(
            n_samples=N_SAMPLES, seed=5))
        out[core] = (store, uuids)
    return out


def canon(x):
    """A report as plain, comparable values: numpy scalars and arrays as
    Python ones, uuids as strings, NaN as a string (NaN != NaN)."""
    if isinstance(x, dict):
        return {str(k): canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, np.ndarray):
        return canon(x.tolist())
    if isinstance(x, np.generic):
        return canon(x.item())
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, _uuid.UUID):
        return str(x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"no canonical form for {type(x).__name__}")


def collector(trace):
    def on_batch(host_id, batch):
        trace.append((host_id, batch.epoch, [str(u) for u in batch.uuids]))
    return on_batch


def cfg(core, n_hosts, **kw):
    defaults = dict(n_hosts=n_hosts, batch_size=64, prefetch_buffers=4,
                    io_threads=4, route="high", backend="scylla", n_nodes=4,
                    replication_factor=2, hedge_after=1.0, seed=13,
                    node_egress_bandwidth=1.2e8)
    defaults.update(kw)
    return core.MultiHostConfig(**defaults)


def specs(core, far="high", **kw):
    return (core.ClusterSpec("us", route="local", n_nodes=3,
                             replication_factor=2, **kw),
            core.ClusterSpec("eu", route=far, n_nodes=3,
                             replication_factor=2, **kw))


def build_run(core, store, uuids, config, start=True):
    return core.build_stack(store=store, uuids=uuids, config=config,
                            start=start).run


def drive(core, store, uuids, config, rounds, between=None,
          after_rounds=0, step_time=0.0):
    """Run ``rounds`` rounds, call ``between(run)``, run ``after_rounds``
    more; returns everything the run reports and checkpoints."""
    trace = []
    run = build_run(core, store, uuids, config)
    out = {"describe": run.describe(), "shards": run.shard_sizes(),
           "rep": run.run(rounds, step_time=step_time,
                          on_batch=collector(trace)),
           "ck": run.checkpoint()}
    if between is not None:
        between(run)
        out["rep2"] = run.run(after_rounds, step_time=step_time,
                              on_batch=collector(trace))
        out["ck2"] = run.checkpoint()
    out["trace"] = trace
    return canon(out)


def outage(run):
    run.inject_cluster_outage("eu", after=0.0)


def node_failure(run):
    run.inject_failure("node1", after=0.2)


CASES = {
    "contiguous": lambda core: dict(config=cfg(core, 3), rounds=6),
    "token_aware": lambda core: dict(
        config=cfg(core, 3, placement="token_aware"), rounds=6),
    "adaptive_shared_ingress": lambda core: dict(
        config=cfg(core, 2, flow_control="adaptive",
                   shared_client_ingress=True,
                   client_ingress_bandwidth=2e9,
                   node_egress_bandwidth=6.25e9), rounds=10),
    "federated_region_outage": lambda core: dict(
        config=cfg(core, 2, placement="cluster_aware",
                   clusters=specs(core), prefetch_buffers=8, ramp_every=1),
        rounds=2, between=outage, after_rounds=4),
    "zipf_replication_aware": lambda core: dict(
        config=cfg(core, 2, placement="replication_aware",
                   clusters=specs(core, weight=1), sampling="zipf",
                   zipf_s=1.3), rounds=8),
    "node_failure_hedged": lambda core: dict(
        config=cfg(core, 3, hedge_after=0.5), rounds=2,
        between=node_failure, after_rounds=5),
    "tenanted": lambda core: dict(
        config=cfg(core, 2, route="med", hedge_after=None,
                   flow_control="adaptive", shared_client_ingress=True,
                   client_ingress_bandwidth=2e9, route_admission=True,
                   tenants=(core.TenantSpec("serve", qos="latency",
                                            weight=3.0),
                            core.TenantSpec("train", qos="batch",
                                            weight=1.0, sampling="zipf",
                                            zipf_s=1.2)),
                   tenant_of_host=("serve", "train")),
        rounds=8, step_time=0.02),
}


# What shows that each case went through the feature it names.
EXERCISED = {
    "contiguous": lambda o: o["rep"]["placement"] == "contiguous",
    "token_aware": lambda o: o["rep"]["placement"] == "token_aware",
    "adaptive_shared_ingress": lambda o: len(o["rep"]["flow"]) == 2,
    "federated_region_outage": lambda o: o["rep2"]["cluster_failovers"] > 0,
    "zipf_replication_aware": lambda o: o["rep"]["replica_hit_frac"] > 0.0,
    "node_failure_hedged": lambda o: o["rep2"]["failovers"] > 0,
    "tenanted": lambda o: sorted(o["rep"]["tenants"]) == ["serve", "train"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_multihost_run_equals_reference(case, stores):
    ref, port = (drive(core, *stores[core], **CASES[case](core))
                 for core in (ref_core, port_core))
    assert port["trace"], "the run delivered nothing"
    assert EXERCISED[case](port)
    assert port == ref


def _elastic(core, store, uuids):
    small = uuids[:1200]
    fast = dict(node_egress_bandwidth=6.25e9, route="low", hedge_after=None,
                out_of_order=False, batch_size=100)
    delivered = []
    run4 = build_run(core, store, small, cfg(core, 4, **fast))
    rep4 = run4.run(2, on_batch=collector(delivered))    # 800 of epoch 0
    ck = run4.checkpoint()
    run2 = build_run(core, store, small, cfg(core, 2, **fast),
                     start=False).start(ck)
    # the last 400 of epoch 0, then all of epoch 1, on 2 hosts
    rep2 = run2.run(2 + 6, on_batch=collector(delivered))
    return canon({"ck": ck, "shards": run2.shard_sizes(), "rep4": rep4,
                  "rep2": rep2, "ck2": run2.checkpoint(),
                  "trace": delivered}), {str(u) for u in small}


def test_elastic_restore_4_to_2_equals_reference_exactly_once(stores):
    ref, universe = _elastic(ref_core, *stores[ref_core])
    port, port_universe = _elastic(port_core, *stores[port_core])
    assert port == ref and port_universe == universe
    for epoch in (0, 1):
        got = [u for _, e, uuids in port["trace"] if e == epoch
               for u in uuids]
        assert len(got) == len(set(got)) == 1200 and set(got) == universe


@pytest.mark.parametrize("mode", ref_core.MODES)
def test_scenario_cell_equals_reference(mode, stores):
    """lat_spike at a tenth of its length (the spike at t=2s still lands)
    under each mode."""
    assert tuple(port_core.MODES) == tuple(ref_core.MODES)
    ref, port = (canon(core.run_cell(
        *stores[core], dataclasses.replace(core.SCENARIOS["lat_spike"],
                                           n_batches=40), mode, seed=2))
                 for core in (ref_core, port_core))
    assert port["MBps"] > 0.0
    assert port == ref


def _competitor(core, kind, store, uuids):
    comp = COMPETITORS[core]
    clock = core.VirtualClock()
    cluster = core.Cluster(clock, store, backend="scylla", n_nodes=1,
                           seed=12)
    if kind == "sd":
        shards = comp.build_shards(store, uuids, shard_bytes=8 * 2 ** 20)
        ld = comp.RecordShardLoader(clock, cluster, "high", shards,
                                    batch_size=64, predownload=4,
                                    seed=7).start()
    else:
        avg = int(sum(store.get_data(u).size for u in uuids) / len(uuids))
        ld = comp.SyncWindowLoader(clock, cluster, "med",
                                   avg_sample_bytes=avg, batch_size=64,
                                   seed=7).start()
    for _ in range(12):
        ld.next_batch(timeout=3000.0)
    return canon({"throughput": ld.throughput(skip=2),
                  "consume_t": ld.batch_consume_t,
                  "bytes": ld.bytes_received})


@pytest.mark.parametrize("kind", ["sd", "sync"])
def test_competitor_loader_equals_reference(kind, stores):
    ref, port = (_competitor(core, kind, *stores[core])
                 for core in (ref_core, port_core))
    assert port["throughput"] > 0.0
    assert port == ref


REFUSALS = {
    "feed": (dict(feed="device", seq_len=16), ValueError,
             "per-host feeds over a MultiHostConfig are not built here"),
    "clock": (lambda core: dict(clock=core.VirtualClock()), ValueError,
              "MultiHostRun owns its clock/cluster/ingress"),
    "cluster": (dict(cluster=object()), ValueError,
                "MultiHostRun owns its clock/cluster/ingress"),
    "ingress": (dict(ingress=object()), ValueError,
                "MultiHostRun owns its clock/cluster/ingress"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_build_stack_multihost_refusals_match_reference(case, stores):
    kw, exc, pattern = REFUSALS[case]
    for core in (ref_core, port_core):
        store, uuids = stores[core]
        extra = kw(core) if callable(kw) else kw
        with pytest.raises(exc, match=pattern):
            core.build_stack(store=store, uuids=uuids, config=cfg(core, 2),
                             **extra)


def test_build_stack_multihost_stack_matches_reference(stores):
    """The stack's layers: ``run``, every host's loader, host 0's pool;
    ``next_batch`` refuses a multi-host stack, as the reference does.  No
    feed is built, so the port needs no card for it, whatever ``device``
    says."""
    views = {}
    for core in (ref_core, port_core):
        store, uuids = stores[core]
        stack = core.build_stack(store=store, uuids=uuids,
                                 config=cfg(core, 3), start=True)
        assert isinstance(stack.run, core.MultiHostRun)
        assert stack.loaders == list(stack.run.loaders)
        assert stack.pool is stack.loaders[0].pool
        assert stack.clock is stack.run.clock and stack.feed is None
        with pytest.raises(RuntimeError, match="single-host convenience"):
            stack.next_batch()
        views[core] = canon({"rep": stack.run.run(2),
                             "ck": stack.run.checkpoint()})
        stack.close()
    assert views[port_core] == views[ref_core]


def test_port_core_exports_the_reference_names():
    """The same names, each the port's own object."""
    assert port_core.__all__ == ref_core.__all__
    for name in port_core.__all__:
        obj = getattr(port_core, name)
        if inspect.isclass(obj) or inspect.isfunction(obj):
            assert obj.__module__.startswith("repro_torch.core."), name


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_multihost_example_twin_prints_the_reference_numbers(monkeypatch):
    """``examples/torch_multihost_train.py`` at 4 steps a phase prints what
    ``examples/multihost_train.py`` prints at 4 steps a phase: 4 hosts, a
    checkpoint, an elastic restore onto 2 hosts with a node dark, then the
    federated phase with a region outage."""
    outputs = []
    for name in ("multihost_train", "torch_multihost_train"):
        example = _load_example(name)
        monkeypatch.setattr(example, "STEPS_PER_PHASE", 4)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            example.main()
        outputs.append(buf.getvalue())
    assert "elastic restore 4 -> 2 hosts" in outputs[1]
    assert "overseas region dark" in outputs[1]
    assert outputs[1] == outputs[0]
