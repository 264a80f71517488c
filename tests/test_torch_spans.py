"""``repro_torch.core.spans`` and the spans and counters the port opens: off
by default and free there, nesting and parents per thread, the profiler's
annotations, the serving engine's counters, and the same tokens and losses
with spans on and off."""

from __future__ import annotations

import itertools
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.core import KVStore, LoaderConfig
from repro_torch.core import spans
from repro_torch.core.spans import span
from repro_torch.data.datasets import SyntheticTokenDataset, ingest
from repro_torch.kernels import build
from repro_torch.models import build_model
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.optimizer import OptimizerConfig

ENGINE_CHILDREN = ["engine.admit", "engine.upload", "engine.forward",
                   "engine.readback", "engine.emit"]


@pytest.fixture(autouse=True)
def spans_off():
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


def children(records, i):
    return [r.name for r in records if r.parent == i]


def self_ns(records):
    """Each record's duration less its children's."""
    own = [r.end_ns - r.start_ns for r in records]
    for r in records:
        if r.parent >= 0:
            own[r.parent] -= r.end_ns - r.start_ns
    return own


def test_off_records_nothing_reads_no_clock_and_allocates_nothing(
        monkeypatch):
    assert span("a") is spans.OFF and span("b") is spans.OFF

    def refuse(*a, **kw):
        raise AssertionError("the off path called it")

    monkeypatch.setattr(spans, "_clock", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)

    def spans_in_a_loop(n):
        for _ in itertools.repeat(None, n):
            with span("x"):
                with span("y"):
                    pass

    spans_in_a_loop(10)
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        spans_in_a_loop(10)
        few = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        spans_in_a_loop(10_000)
        many = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert many == few                  # nothing allocated per span
    assert spans.take() == []


def test_nesting_parents_threads_and_self_time():
    spans.enable()
    with span("a"):
        with span("b"):
            with span("c"):
                time.sleep(0.002)
            time.sleep(0.001)
        seen = []

        def other():
            with span("t"):
                with span("u"):
                    seen.append(threading.get_ident())

        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
        with span("d"):
            time.sleep(0.001)
    recs = spans.take()
    assert [r.name for r in recs] == ["a", "b", "c", "t", "u", "d"]
    assert [r.parent for r in recs] == [-1, 0, 1, -1, 3, 0]
    me = threading.get_ident()
    assert [r.thread for r in recs] == [me, me, me, seen[0], seen[0], me]
    for r in recs:
        assert r.end_ns >= r.start_ns
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    own = self_ns(recs)
    dur = [r.end_ns - r.start_ns for r in recs]
    assert own[0] == dur[0] - dur[1] - dur[5]
    assert own[1] == dur[1] - dur[2]
    assert own[2] == dur[2] and own[5] == dur[5]
    assert own[3] == dur[3] - dur[4]
    assert own[1] >= 1e6 and own[2] >= 2e6
    assert spans.take() == []


def test_a_span_closes_when_its_block_raises():
    spans.enable()
    with pytest.raises(ValueError):
        with span("a"):
            with span("b"):
                raise ValueError
    with span("c"):
        pass
    recs = spans.take()
    assert [(r.name, r.parent) for r in recs] == [("a", -1), ("b", 0),
                                                   ("c", -1)]
    assert all(r.end_ns >= r.start_ns for r in recs)


def test_spans_are_annotations_of_a_running_profiler(monkeypatch):
    spans.enable()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with span("outer"):
            with span("inner"):
                torch.ones(8) + 1
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    assert "outer" in names and "inner" in names
    assert [r.name for r in spans.take()] == ["outer", "inner"]

    def refuse(*a, **kw):
        raise AssertionError("no profiler runs: no range is opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with span("alone"):
        pass
    assert [r.name for r in spans.take()] == ["alone"]


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

SLOTS = 3


@pytest.fixture(scope="module")
def moe_model():
    cfg = get_arch("grok_1_314b").smoke_config()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    return cfg, model, params


def serve(moe_model, on: bool):
    """Seven prompts through a 3-slot engine to completion; also the
    slot-steps that held a request, counted from outside the engine."""
    cfg, model, params = moe_model
    (spans.enable if on else spans.disable)()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (1, 4, 2, 7, 3, 5, 1)]
    engine = ServingEngine(model, params, ServeConfig(
        batch_slots=SLOTS, max_seq=64, max_new_tokens=4))
    reqs = [engine.submit(p) for p in prompts]
    held = 0
    while engine.queue or any(s is not None for s in engine.slots):
        done = sum(r.done for r in reqs)
        engine.step()
        held += (sum(s is not None for s in engine.slots)
                 + sum(r.done for r in reqs) - done)
    spans.disable()
    return engine, reqs, prompts, spans.take(), held


@pytest.mark.parametrize("on", [False, True])
def test_engine_counters(moe_model, on):
    engine, reqs, prompts, _, held = serve(moe_model, on)
    assert all(r.done for r in reqs)
    assert engine.slot_steps == engine.steps * SLOTS
    assert engine.tokens_out == sum(len(r.out_tokens) for r in reqs)
    assert engine.prompt_tokens_fed == sum(len(p) for p in prompts)
    # a request holds its slot for its prompt's steps and one a token but
    # the first, which the step feeding its prompt's last token serves
    assert held == engine.prompt_tokens_fed + engine.tokens_out - len(reqs)
    assert held < engine.slot_steps


def test_engine_spans_nest_and_leave_the_tokens_as_they_were(moe_model):
    off, off_reqs, _, none, _ = serve(moe_model, False)
    on, on_reqs, _, recs, _ = serve(moe_model, True)
    assert none == []
    assert [r.out_tokens for r in on_reqs] == [r.out_tokens for r in off_reqs]
    cfg = moe_model[0]
    steps = [i for i, r in enumerate(recs) if r.name == "engine.step"]
    assert len(steps) == on.steps
    for i in steps:
        assert recs[i].parent == -1
        assert children(recs, i) == ENGINE_CHILDREN
        fwd = next(j for j in range(i, len(recs))
                   if recs[j].name == "engine.forward")
        assert children(recs, fwd) == ["moe"] * cfg.n_layers + ["unembed"]
        for m in (j for j in range(len(recs)) if recs[j].parent == fwd
                  and recs[j].name == "moe"):
            assert children(recs, m) == ["moe.experts"]
    own = self_ns(recs)          # what the children leave over
    for i in steps:
        assert 0 <= own[i] <= recs[i].end_ns - recs[i].start_ns


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

TINY = dict(name="spans-test-lm", family="moe", n_layers=2, d_model=32,
            n_heads=2, n_kv_heads=1, d_ff=64, vocab=512, head_dim=16,
            n_experts=4, top_k=2, dtype="float32", remat=True)


def train(on: bool):
    store = KVStore()
    uuids = ingest(store, SyntheticTokenDataset(n_samples=64, seq_len=24,
                                                vocab=512, seed=7))
    model = build_model(ArchConfig(**TINY), device="cpu")
    (spans.enable if on else spans.disable)()
    res = run_training(
        model, store, uuids,
        LoaderConfig(batch_size=4, prefetch_buffers=2, io_threads=2,
                     route="med", materialize=True, seed=3),
        TrainLoopConfig(total_steps=3, seq_len=24, log_every=1,
                        charge_step_time=0.01),
        OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=3))
    spans.disable()
    return [h["loss"] for h in res["history"]], spans.take()


def test_train_step_spans_nest_and_leave_the_loss_as_it_was():
    off, none = train(False)
    on, recs = train(True)
    assert none == []
    assert on == off
    steps = [i for i, r in enumerate(recs) if r.name == "train.step"]
    assert len(steps) == 3
    for i in steps:
        assert recs[i].parent == -1
        assert children(recs, i) == ["train.forward", "train.backward",
                                     "train.optimizer"]
    feeds = [i for i, r in enumerate(recs) if r.name == "feed.next"]
    assert len(feeds) == 3
    first = children(recs, feeds[0])
    assert first == ["feed.wait", "feed.form"] * 3     # two prefetched
    for i in feeds[1:]:
        assert children(recs, i) == ["feed.wait", "feed.form"]
    # the remat recompute reopens each layer's MoE in the backward (on the
    # CPU, autograd runs it on the calling thread)
    under = {p: sum(r.name == "moe" and recs[r.parent].name == p
                    for r in recs)
             for p in ("train.forward", "train.backward")}
    assert under == {"train.forward": 3 * TINY["n_layers"],
                     "train.backward": 3 * TINY["n_layers"]}


# ---------------------------------------------------------------------------
# kernel builds
# ---------------------------------------------------------------------------

def test_builds_are_counted_and_the_compile_is_a_span(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "counts", {"compiled": 0, "cached": 0})
    ran = []

    def nvcc(cmd, check):
        ran.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "w") as f:
            f.write("lib")

    monkeypatch.setattr(build.subprocess, "run", nvcc)
    spans.enable()
    lib = build.build(src)
    assert build.build(src) == lib and lib.exists()
    assert len(ran) == 1
    assert build.counts == {"compiled": 1, "cached": 1}
    assert [r.name for r in spans.take()] == ["kernels.build"]
