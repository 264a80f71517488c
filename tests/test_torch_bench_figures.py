"""The twins of the paper's figures and tables against the reference's
benches on the CPU: Table 3 (``bench_torch_tightloop``), Fig. 4
(``bench_torch_batch_times``), Figs. 5/6 (``bench_torch_connections``),
Fig. 7 (``bench_torch_backends``), Table 4 (``bench_torch_training``), the
eager/incremental ramp table (``bench_torch_ramp``), the multi-host
scaling, placement, elastic and federation tables
(``bench_torch_multihost``) and the core-result demo
(``examples/torch_highlatency_loader.py``).

None of these has a committed baseline.  Each twin runs the reference's
code over ``repro_torch.core``, the reference's loader on its virtual
clock, so at the same (small) sizes its printed table and every row of
its CSV must equal the reference's, character for character.  The sizes
are cut through the benches' own parameters and module names, the same in
both packages: a 20,000-sample store, batches of 64 (32 for the
multi-host hosts), few batches, one seed.  Both packages' results
directories point at ``tmp_path``."""

import functools
import importlib.util
from pathlib import Path

import pytest

from benchmarks import (bench_backends, bench_batch_times, bench_connections,
                        bench_multihost, bench_ramp, bench_tightloop,
                        bench_torch_backends, bench_torch_batch_times,
                        bench_torch_connections, bench_torch_multihost,
                        bench_torch_ramp, bench_torch_tightloop,
                        bench_torch_training, bench_training, common,
                        torch_common)

ROOT = Path(__file__).resolve().parents[1]
N_SAMPLES = 20_000
BATCH = 64
# (reference module, twin module), for each bench with a twin here.
PAIRS = {"tightloop": (bench_tightloop, bench_torch_tightloop),
         "batch_times": (bench_batch_times, bench_torch_batch_times),
         "connections": (bench_connections, bench_torch_connections),
         "backends": (bench_backends, bench_torch_backends),
         "training": (bench_training, bench_torch_training),
         "ramp": (bench_ramp, bench_torch_ramp),
         "multihost": (bench_multihost, bench_torch_multihost)}


@pytest.fixture(scope="module")
def stores():
    """One small image store per package (the reference's ``make_store``
    at 200,000 samples, cut)."""
    return (common.make_store(n_samples=N_SAMPLES),
            torch_common.make_store(n_samples=N_SAMPLES))


@pytest.fixture
def small(stores, tmp_path, monkeypatch):
    """Every bench of both packages on its package's small store, writing
    into ``tmp_path`` (the twins' files have names of their own)."""
    (ref_store, port_store) = stores
    for (ref, twin) in PAIRS.values():
        monkeypatch.setattr(ref, "make_store",
                            lambda *a, _s=ref_store, **k: _s)
        monkeypatch.setattr(twin, "make_store",
                            lambda *a, _s=port_store, **k: _s)
        for mod in (ref, twin):
            if hasattr(mod, "make_loader"):
                monkeypatch.setattr(mod, "make_loader", functools.partial(
                    mod.make_loader, batch_size=BATCH))
            if hasattr(mod, "BATCH_SIZE"):
                monkeypatch.setattr(mod, "BATCH_SIZE", BATCH)
    for mod in (common, bench_multihost, torch_common,
                bench_torch_multihost):
        monkeypatch.setattr(mod, "RESULTS_DIR", str(tmp_path))
    return tmp_path


def _both(name, monkeypatch, call, **constants):
    """``call(module)`` on the reference bench and on its twin, with
    ``constants`` set on both modules; returns both results."""
    out = []
    for mod in PAIRS[name]:
        for key, value in constants.items():
            monkeypatch.setattr(mod, key, value)
        out.append(call(mod))
    return out


def _csv_equal(tmp_path, name):
    """The reference's ``results/<name>`` and the twin's ``_torch`` file:
    equal rows."""
    ref = (tmp_path / name).read_text()
    stem, ext = name.rsplit(".", 1)
    port = (tmp_path / f"{stem}_torch.{ext}").read_text()
    assert port == ref
    return ref


def test_table3_tightloop_equals_reference(small, monkeypatch):
    """Table 3: ours, MosaicML SD and tf.data at low, med and high
    latency."""
    def call(mod):
        for fn, n in (("run_ours", 6), ("run_sd", 6), ("run_tfdata", 4)):
            monkeypatch.setattr(mod, fn, functools.partial(
                getattr(mod, fn), seeds=(1,), n_batches=n))
        return mod.run()

    ref, port = _both("tightloop", monkeypatch, call)
    assert port == ref
    rows = _csv_equal(small, "table3_tightloop.csv").splitlines()
    assert len(rows) == 1 + 9


@pytest.mark.parametrize("name,csv", [
    ("batch_times", "fig4_batch_times.csv"),
    ("connections", "fig56_connections.csv"),
    ("backends", "fig7_backends.csv")])
def test_figure_equals_reference(small, monkeypatch, name, csv):
    """Fig. 4 (in-order against out-of-order batch times), Figs. 5/6
    (per-connection rates) and Fig. 7 (Cassandra against ScyllaDB), at 24
    batches (the first 20 are warm-up in Fig. 4)."""
    ref, port = _both(name, monkeypatch, lambda mod: mod.run(n_batches=24))
    assert port == ref
    assert len(_csv_equal(small, csv).splitlines()) > 2


def test_table4_training_equals_reference(small, monkeypatch):
    """Table 4: 8 consumers on one NIC, ours against MosaicML SD."""
    def call(mod):
        for fn in ("run_ours", "run_sd"):
            monkeypatch.setattr(mod, fn, functools.partial(
                getattr(mod, fn), n_batches=3))
        return mod.run_table4()

    ref, port = _both("training", monkeypatch, call, BATCH=BATCH)
    assert port == ref
    assert len(_csv_equal(small, "table4_training.csv").splitlines()) == 7


def test_ramp_table_equals_reference(small, monkeypatch):
    """The Sec. 3.4 ablation, eager against incremental ramp, at 4
    warm-up batches a consumer."""
    ref, port = _both("ramp", monkeypatch, lambda mod: mod.run(),
                      BATCH=BATCH, WARMUP_BATCHES=4)
    assert port == ref
    assert len(_csv_equal(small, "ramp_ablation.csv").splitlines()) == 3


def test_multihost_tables_equal_reference(small, monkeypatch):
    """Scaling over 1-8 clients, placement policies, elastic restores, the
    federation with its outage, and a node failure, at 4 rounds; the
    federation's full reports too."""
    def call(mod):
        config = mod.MultiHostConfig
        monkeypatch.setattr(mod, "MultiHostConfig", lambda **kw: config(
            **dict(kw, batch_size=BATCH // 2)))
        return mod.run()

    ref, port = _both("multihost", monkeypatch, call, ROUNDS=4)
    assert port == ref.replace("multihost_federation.json",
                               "multihost_federation_torch.json")
    _csv_equal(small, "multihost_scaling.csv")
    _csv_equal(small, "multihost_federation.json")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_highlatency_example_equals_reference(monkeypatch, capsys):
    """The core-result demo at a 20,000-image store and 30 batches of 64
    a strategy: the same table from both packages."""
    out = []
    for name in ("highlatency_loader", "torch_highlatency_loader"):
        mod = _example(name)
        data, loop, config = (mod.SyntheticImageDataset, mod.tight_loop,
                              mod.LoaderConfig)
        monkeypatch.setattr(mod, "SyntheticImageDataset",
                            lambda n_samples, seed, _d=data: _d(
                                n_samples=N_SAMPLES, seed=seed))
        monkeypatch.setattr(mod, "LoaderConfig", lambda _c=config, **kw: _c(
            **dict(kw, batch_size=BATCH)))
        monkeypatch.setattr(mod, "tight_loop",
                            lambda ld, n_batches, _l=loop: _l(ld,
                                                              n_batches=30))
        mod.main()
        out.append(capsys.readouterr().out)
    assert out[1] == out[0]
    assert "OOO + incremental (paper)" in out[0]
