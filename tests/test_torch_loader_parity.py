"""The port's loader is the reference loader, bit for bit: ``repro.core``
and ``repro_torch.core`` ingest the same seeded dataset and deliver the same
uuids, batch order, labels, payload bytes, event times and stats on every
configuration below; and ``build_stack`` rejects what the reference
rejects for a single host, and a ``repro`` config object."""

import itertools

import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from repro.data import datasets as ref_datasets
from repro_torch.data import datasets as port_datasets

N_BATCHES = 6
BATCH = 16
H = W = 8
C = 3


def _trace(core, datasets, **cfg_kw):
    store = core.KVStore()
    uuids = datasets.ingest(store, datasets.SyntheticPixelDataset(
        n_samples=160, h=H, w=W, c=C, seed=3))
    cfg = core.LoaderConfig(batch_size=BATCH, prefetch_buffers=4,
                            io_threads=4, materialize=True, seed=5, **cfg_kw)
    kw = {"device": "cpu"} if core is port_core else {}
    stack = core.build_stack(store=store, uuids=uuids, config=cfg,
                             start=True, **kw)
    batches = []
    for _ in range(N_BATCHES):
        b = stack.next_batch()
        pix = (b.pixels(H, W, C).copy() if b.slab is not None else
               np.stack([np.frombuffer(p, np.uint8) for p in b.payloads()]))
        batches.append((b.seq, b.epoch, b.uuids, b.labels.tolist(),
                        b.t_first_issue, b.t_last_arrival, b.t_ready,
                        pix.tobytes()))
        b.release()
    st = stack.loader.stats
    out = {"uuids": uuids, "batches": batches,
           "throughput": st.throughput(skip=2),
           "batch_times": np.asarray(st.batch_times(skip=0)).tolist(),
           "now": stack.clock.now(), "state": stack.loader.state(),
           "flow": stack.loader.flow_snapshot(),
           "bytes": (stack.pool.bytes_received,
                     stack.pool.payload_bytes_received)}
    stack.close()
    return out


CONFIGS = list(itertools.product(["local", "high"], [True, False],
                                 ["static", "adaptive"],
                                 ["none", "byteshuffle"], [True, False]))


@pytest.mark.parametrize("route,ooo,flow,codec,arena", CONFIGS)
def test_loader_bit_identical(route, ooo, flow, codec, arena):
    kw = dict(route=route, out_of_order=ooo, flow_control=flow,
              wire_codec=codec, use_arena=arena)
    ref = _trace(ref_core, ref_datasets, **kw)
    port = _trace(port_core, port_datasets, **kw)
    assert port["uuids"] == ref["uuids"]
    for i, (p, r) in enumerate(zip(port["batches"], ref["batches"])):
        assert p == r, f"batch {i} differs"
    for key in ("throughput", "batch_times", "now", "state", "flow",
                "bytes"):
        assert port[key] == ref[key], key


# The single-host validation errors of tests/test_stack.py: (build_stack
# kwargs, exception, message pattern shared by both packages).
VALIDATION = {
    "unknown_feed_kind": (dict(feed="tfrecord"), ValueError,
                          "unknown feed kind"),
    "feed_needs_materialize": (dict(feed="device", seq_len=16), ValueError,
                               "materialize=True"),
    "device_feed_needs_seq_len": (dict(materialize=True, feed="device"),
                                  ValueError, "seq_len"),
    "image_feed_needs_shapes": (dict(materialize=True, feed="image"),
                                ValueError, "image_shape"),
    "seq_len_only_for_device_feed": (dict(materialize=True, feed="image",
                                          seq_len=16), ValueError,
                                     "only applies"),
    "unknown_config_type": (dict(config={"route": "high"}), TypeError,
                            "config must be a LoaderConfig"),
}


@pytest.fixture(scope="module")
def stores():
    out = {}
    for core, datasets in ((ref_core, ref_datasets),
                           (port_core, port_datasets)):
        store = core.KVStore()
        uuids = datasets.ingest(store, datasets.SyntheticImageDataset(
            n_samples=200, seed=0))
        out[core] = (store, uuids)
    return out


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_build_stack_validation_matches_reference(case, stores):
    kw, exc, pattern = VALIDATION[case]
    kw = dict(kw)
    materialize = kw.pop("materialize", False)
    for core in (ref_core, port_core):
        store, uuids = stores[core]
        call = dict(store=store, uuids=uuids,
                    config=core.LoaderConfig(batch_size=64, route="low",
                                             materialize=materialize))
        call.update(kw)
        if core is port_core:
            call["device"] = "cpu"
        with pytest.raises(exc, match=pattern):
            core.build_stack(**call)


def test_port_rejects_multihost_config(stores):
    """The port shares no types with ``repro``: a reference
    ``MultiHostConfig`` is not the port's, and is refused as any other
    foreign config is."""
    store, uuids = stores[port_core]
    cfg = ref_core.MultiHostConfig(n_hosts=2, batch_size=64, route="low",
                                   n_nodes=2)
    assert not isinstance(cfg, port_core.MultiHostConfig)
    with pytest.raises(TypeError, match="LoaderConfig or MultiHostConfig, "
                                        "got MultiHostConfig"):
        port_core.build_stack(store=store, uuids=uuids, config=cfg,
                              device="cpu")
