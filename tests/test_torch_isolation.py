"""The port stands alone: ``repro_torch``, its benches and ``chip_smoke``
import neither JAX nor ``repro``, its entry points refuse a CUDA device when
there is no card, and the modules it copied from ``repro`` are the originals
with only their imports rewritten."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import KVStore, LoaderConfig, build_stack
from repro_torch.data.datasets import SyntheticPixelDataset, ingest
from repro_torch.data.pipeline import DeviceFeed, ImageFeed
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.configs.base import get_arch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

COPIED = ["core/stats.py", "core/netsim.py", "core/kvstore.py",
          "core/cluster.py", "core/wirefmt.py", "core/flowctl.py",
          "core/arena.py", "core/connection.py", "core/batch_loader.py",
          "core/placement.py", "core/prefetcher.py", "core/loader.py",
          "core/splits.py", "core/replication.py", "core/federation.py",
          "core/tenancy.py", "core/multihost.py", "core/scenarios.py",
          "core/competitors.py", "data/datasets.py"] + sorted(
              str(p.relative_to(REF)) for p in (REF / "configs").glob("*.py"))
# The one string a copy may change: get_arch imports the port's configs.
RENAMED = {"repro.configs.{arch_id}": "repro_torch.configs.{arch_id}"}
# Copies outside the package: (the port's file, the original), from the root.
COPIED_PAIRS = [("benchmarks/torch_common.py", "benchmarks/common.py")]
COPIED_FUNCTIONS = [("kernels/ref.py", "crop_mirror_normalize_np"),
                    ("data/pipeline.py", "batch_to_numpy")]


def _port_modules():
    return sorted("repro_torch." + ".".join(p.relative_to(PORT)
                                            .with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def _bench_modules():
    return sorted(f"benchmarks.{p.stem}" for p in
                  (ROOT / "benchmarks").glob("*.py")
                  if p.stem.startswith(("bench_torch_", "torch_")))


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    benches = _bench_modules()
    assert {"benchmarks.torch_common", "benchmarks.torch_gate",
            "benchmarks.bench_torch_wirefmt",
            "benchmarks.bench_torch_multihost"} <= set(benches)
    mods = _port_modules() + benches + ["chip_smoke"]
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(n for n in sys.modules if n == 'jax' "
            "or n.startswith(('jax.', 'jaxlib')) or n == 'repro' "
            "or n.startswith('repro.'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) > 20
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what the dispatcher sees
    when it is handed a CUDA tensor."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _small_store():
    store = KVStore()
    uuids = ingest(store, SyntheticPixelDataset(n_samples=64, h=8, w=8, c=3))
    return store, uuids


def _refuse(fn):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        fn()


def test_build_stack_refuses_cuda_without_card():
    store, uuids = _small_store()
    _refuse(lambda: build_stack(store=store, uuids=uuids,
                                config=LoaderConfig(materialize=True)))
    _refuse(lambda: build_stack(store=store, uuids=uuids,
                                config=LoaderConfig(materialize=True),
                                feed="image", image_shape=(8, 8, 3),
                                out_shape=(4, 4), device="cuda"))


@pytest.mark.parametrize("feed", ["image", "device"])
def test_feeds_refuse_cuda_without_card(feed):
    store, uuids = _small_store()
    loader = build_stack(store=store, uuids=uuids, device="cpu",
                         config=LoaderConfig(batch_size=8,
                                             materialize=True)).loader
    if feed == "image":
        _refuse(lambda: ImageFeed(loader, 8, 8, 3, 4, 4))
    else:
        _refuse(lambda: DeviceFeed(loader, 16, device="cuda:0"))


def test_kernel_refuses_cuda_tensor_without_card():
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a) for a in (
        rng.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8),
        np.zeros(2, np.int32), np.zeros(2, np.int32), np.zeros(2, np.int32),
        np.zeros(3, np.float32), np.ones(3, np.float32))]
    fake = [t.as_subclass(_FakeCuda) for t in args]
    _refuse(lambda: ops.crop_mirror_normalize(*fake, out_h=4, out_w=4))


def _attention_args(requires_grad=False):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 8, 16, generator=g, requires_grad=requires_grad)
    k = torch.randn(1, 2, 8, 16, generator=g)
    return [t.as_subclass(_FakeCuda) for t in (q, k, k.clone())]


def test_flash_attention_refuses_cuda_tensor_without_card():
    _refuse(lambda: ops.flash_attention(*_attention_args()))


def test_flash_decode_refuses_cuda_tensor_without_card():
    q, k, v = _attention_args()
    q = torch.zeros(1, 2, 2, 16).as_subclass(_FakeCuda)
    lengths = torch.tensor([3]).as_subclass(_FakeCuda)
    _refuse(lambda: ops.flash_decode(q, k, v, lengths))


def test_flash_attention_refuses_gradients_on_cuda():
    """No backward kernel yet: a CUDA call that would need a gradient
    raises (before the card is even looked for) instead of taking the
    plain path."""
    args = _attention_args(requires_grad=True)
    assert args[0].requires_grad
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ops.flash_attention(*args)


def test_model_and_engine_refuse_cuda_without_card():
    cfg = get_arch("qwen3_4b").smoke_config()
    _refuse(lambda: build_model(cfg))
    _refuse(lambda: build_model(cfg, device="cuda:0"))


def test_train_launcher_refuses_cuda_without_card():
    from repro_torch.launch import train as launch_train
    _refuse(lambda: launch_train.main(["--demo", "--steps", "1"]))


def _strip_imports(tree: ast.AST) -> str:
    class Strip(ast.NodeTransformer):
        def visit_Import(self, node):
            return None

        def visit_ImportFrom(self, node):
            return None

    return ast.dump(Strip().visit(tree))


def _renamed(source: str) -> str:
    for old, new in RENAMED.items():
        source = source.replace(old, new)
    return source


@pytest.mark.parametrize("port_path,ref_path",
                         [(PORT / rel, REF / rel) for rel in COPIED]
                         + [(ROOT / a, ROOT / b) for a, b in COPIED_PAIRS],
                         ids=COPIED + [a for a, _ in COPIED_PAIRS])
def test_copied_module_equals_original(port_path, ref_path):
    port = ast.parse(port_path.read_text())
    ref = ast.parse(_renamed(ref_path.read_text()))
    assert _strip_imports(port) == _strip_imports(ref)


def test_copied_configs_are_all_there_and_renamed_once():
    assert len([r for r in COPIED if r.startswith("configs/")]) == 12
    assert _renamed((REF / "configs/base.py").read_text()) != \
        (REF / "configs/base.py").read_text()
    for rel in COPIED:
        assert "repro.configs" not in (PORT / rel).read_text()


@pytest.mark.parametrize("rel,name", COPIED_FUNCTIONS)
def test_copied_function_equals_original(rel, name):
    def find(path):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.FunctionDef) and node.name == name:
                return ast.dump(node)
        raise AssertionError(f"{name} not in {path}")

    assert find(PORT / rel) == find(REF / rel)
