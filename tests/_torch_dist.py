"""Multi-rank helpers for the port's distributed tests: a gloo group of
``world`` spawned processes rendezvousing through a ``FileStore`` under a
test's ``tmp_path`` (never a fixed TCP port: test files run in parallel),
each running one worker below and writing its arrays to
``<out>/<rank>.npz``; and the reference's side, run in a subprocess with
8 forced host devices under ``jax.set_mesh``.

Workers live here, not in the test files, so that a spawned rank imports
torch and the port only."""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
JAX_ENV = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))


def _entry(rank, world, store_dir, out_dir, timeout, worker, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store_dir}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        out = worker(rank, world, *args)
        np.savez(os.path.join(out_dir, f"{rank}.npz"), **(out or {}))
    finally:
        dist.destroy_process_group()


def run_ranks(tmp_path, world: int, worker, *args, timeout: float = 240.0):
    """Run ``worker(rank, world, *args)`` on ``world`` gloo ranks; returns
    each rank's arrays.  Fails (and stops every rank) past ``timeout``
    seconds, so that a hang fails the test."""
    store_dir = tmp_path / f"store_{worker.__name__}"
    out_dir = tmp_path / f"out_{worker.__name__}"
    store_dir.mkdir()
    out_dir.mkdir()
    ctx = mp.start_processes(
        _entry, args=(world, str(store_dir), str(out_dir), timeout, worker,
                      args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{worker.__name__} on {world} ranks did "
                                   f"not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    results = []
    for r in range(world):
        with np.load(out_dir / f"{r}.npz") as z:
            results.append({k: z[k] for k in z.files})
    return results


def run_jax(code: str, timeout: float = 300.0) -> str:
    """Run ``code`` with 8 forced host devices; returns its stdout."""
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         env=JAX_ENV, capture_output=True, text=True,
                         timeout=timeout, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


# ---------------------------------------------------------------------------
# Workers (each runs on every rank of a gloo group)
# ---------------------------------------------------------------------------

def layout_worker(rank, world, mesh_shape, shape, specs):
    """Each spec's DTensor local slice on this rank, for a tensor of
    ``shape`` holding 0..n-1, over a ``("data", "model")`` mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding.rules import NamedSharding, PartitionSpec
    mesh = init_device_mesh("cpu", mesh_shape,
                            mesh_dim_names=("data", "model"))
    full = torch.arange(int(np.prod(shape)), dtype=torch.int64).reshape(shape)
    out = {}
    for i, spec in enumerate(specs):
        sh = NamedSharding(mesh, PartitionSpec(*spec))
        out[str(i)] = distribute_tensor(full, mesh,
                                        sh.placements).to_local().numpy()
    return out


def compress_worker(rank, world, grads, steps):
    """``compressed_psum_grads`` for ``steps`` rounds on this rank's row
    of ``grads`` (world, ...), with error feedback carried."""
    from repro_torch.train.compression import (compressed_psum_grads,
                                               init_error_feedback)
    g = {"w": torch.from_numpy(grads[rank:rank + 1])}
    e = init_error_feedback(g)
    outs = []
    for _ in range(steps):
        out, e = compressed_psum_grads(g, e)
        outs.append(out["w"].numpy().copy())
    return {"outs": np.stack(outs), "err": e["w"].numpy()}


def tanh_stage(params, h):
    """A stage of tanh(h @ w) layers: params (L/S, d, d)."""
    for w in params:
        h = torch.tanh(h @ w)
    return h


def pipeline_worker(rank, world, w, x):
    """This rank's stage of ``w`` (L, d, d) through ``pipeline_forward``
    on the microbatches ``x`` (M, mb, d)."""
    from repro_torch.train.pipeline_parallel import (pipeline_forward,
                                                     stack_stage_params)
    staged = stack_stage_params(torch.from_numpy(w), world)[rank]
    fn = pipeline_forward(tanh_stage, world, x.shape[0])
    return {"y": fn(staged, torch.from_numpy(x)).numpy()}


def _walk(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}{k}/")
    else:
        yield path[:-1], tree


def restore_worker(rank, world, ckpt_dir, cfg_kw, state_dtype, profile):
    """Restore the checkpoint onto a (2, 2) ``("data", "model")`` mesh
    with ``tree_shardings`` of ``abstract_state`` under ``profile``:
    each leaf's whole tensor, local shard and placements."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import tree_shardings
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.step import abstract_state, state_logical_axes
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    model = build_model(ArchConfig(**cfg_kw), device="cpu")
    opt_cfg = OptimizerConfig(state_dtype=state_dtype)
    template = abstract_state(model, opt_cfg)
    shardings = tree_shardings(template, state_logical_axes(model, opt_cfg),
                               mesh, profile)
    state, manifest = CheckpointManager(ckpt_dir).restore(
        template, shardings=shardings)
    out = {"step": np.asarray(manifest["step"])}
    for key, leaf in _walk(state):
        assert isinstance(leaf, DTensor), key
        assert leaf.placements == _at(shardings, key).placements, key
        out["full/" + key] = leaf.full_tensor().numpy()
        out["local/" + key] = leaf.to_local().numpy()
        out["spec/" + key] = np.asarray(repr(tuple(_at(shardings,
                                                       key).spec)))
    return out


def _at(tree, key):
    for k in key.split("/"):
        tree = tree[k]
    return tree


def feed_worker(rank, world, seq_len):
    """Two batches of this rank's shard (``LoaderConfig.shard_id``)
    through ``DeviceFeed(..., mesh=)`` over a ("data",) mesh, and the same
    shard's batches through a plain feed: the DTensors' local rows and
    whole batches, and the plain rows."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.core import KVStore, LoaderConfig, build_stack
    from repro_torch.data.datasets import SyntheticTokenDataset, ingest
    from repro_torch.data.pipeline import DeviceFeed
    from repro_torch.sharding.rules import shard_batch_spec
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    store = KVStore()
    uuids = ingest(store, SyntheticTokenDataset(n_samples=64,
                                                seq_len=seq_len, vocab=97,
                                                seed=4))
    out = {}
    for name, kw in (("plain", {}),
                     ("mesh", {"mesh": mesh}),
                     ("shardings", {"shardings": {
                         "tokens": shard_batch_spec(mesh, 2)}})):
        stack = build_stack(store=store, uuids=uuids, config=LoaderConfig(
            batch_size=4, route="local", materialize=True, seed=4,
            out_of_order=False, shard_id=rank, num_shards=world))
        feed = DeviceFeed(stack.loader, seq_len, device="cpu", **kw)
        try:
            for i in range(2):
                batch = next(feed)[0]
                for k, v in batch.items():
                    if isinstance(v, DTensor):
                        assert v.placements == (Shard(0),), (name, k)
                        out[f"{name}/{i}/{k}/whole"] = v.full_tensor().numpy()
                        v = v.to_local()
                    out[f"{name}/{i}/{k}"] = v.numpy()
        finally:
            stack.close()
    return out
