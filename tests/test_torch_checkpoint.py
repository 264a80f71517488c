"""The port's checkpoints, in ``repro``'s on-disk format: the two
packages read each other's f32 checkpoints, bf16 leaves round-trip through
the raw 2-byte records numpy keeps for them, and the manager publishes
atomically, keeps the newest three and saves asynchronously."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
from repro_torch import convert
from repro_torch.train.checkpoint import CheckpointManager


def _jax_state(seed=0, dtype=jnp.float32):
    k = jax.random.PRNGKey(seed)
    params = {"w": jax.random.normal(k, (4, 8)).astype(dtype),
              "blocks": {"b": jnp.arange(6.0).reshape(2, 3).astype(dtype)}}
    return {"params": params,
            "opt": {"m": jax.tree.map(lambda p: jnp.full(p.shape, 0.5),
                                      params),
                    "v": jax.tree.map(lambda p: jnp.full(p.shape, 0.25),
                                      params),
                    "step": jnp.asarray(7, jnp.int32)}}


def _port_state(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(4, 8, generator=g).to(dtype),
              "blocks": {"b": torch.arange(6.0).reshape(2, 3).to(dtype)}}
    zeros = {"w": torch.zeros(4, 8), "blocks": {"b": torch.zeros(2, 3)}}
    return {"params": params,
            "opt": {"m": {"w": torch.full((4, 8), 0.5),
                          "blocks": {"b": torch.full((2, 3), 0.5)}},
                    "v": zeros,
                    "step": torch.tensor(3, dtype=torch.int32)}}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def test_reference_writes_port_restores(tmp_path):
    state = _jax_state()
    JaxCheckpointManager(str(tmp_path)).save(
        10, state, extra={"loader": {"epoch": 1, "cursor": 320}})
    template = convert.state_from_reference(
        jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), state),
        device="cpu")
    restored, manifest = CheckpointManager(str(tmp_path)).restore(template)
    assert manifest["step"] == 10
    assert manifest["extra"]["loader"] == {"epoch": 1, "cursor": 320}
    want, got = _flat(jax.tree.map(np.asarray, state)), _flat(restored)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == _flat(template)[key].dtype
        np.testing.assert_array_equal(got[key].numpy(), want[key])


def test_port_writes_reference_restores(tmp_path):
    state = _port_state()
    CheckpointManager(str(tmp_path)).save(4, state, extra={"x": 1})
    template = jax.tree.map(jnp.zeros_like, jax.tree.map(
        np.asarray, convert.state_to_numpy(state)))
    restored, manifest = JaxCheckpointManager(str(tmp_path)).restore(
        template)
    assert manifest["step"] == 4 and manifest["extra"] == {"x": 1}
    assert sorted(manifest["keys"]) == manifest["keys"] == sorted(
        _flat(state))
    want = _flat(state)
    for key, leaf in _flat(restored).items():
        np.testing.assert_array_equal(np.asarray(leaf), want[key].numpy())
    assert restored["opt"]["step"].dtype == jnp.int32


def test_bf16_round_trip_through_raw_records(tmp_path):
    """A bf16 leaf is written as the reference writes one (2-byte void
    records, no ml_dtypes needed to read it) and comes back bit-exact."""
    state = _port_state(dtype=torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(2, state)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        assert data["params/w"].dtype == np.dtype("V2")
        assert data["opt/m/w"].dtype == np.float32
    template = _port_state(seed=1, dtype=torch.bfloat16)
    restored, _ = mgr.restore(template)
    for key, leaf in _flat(state).items():
        got = _flat(restored)[key]
        assert got.dtype == leaf.dtype
        assert torch.equal(got, leaf)


def test_reference_bf16_checkpoint_restores_in_port(tmp_path):
    state = _jax_state(dtype=jnp.bfloat16)
    JaxCheckpointManager(str(tmp_path)).save(5, state)
    template = _port_state(dtype=torch.bfloat16)
    restored, _ = CheckpointManager(str(tmp_path)).restore(template)
    want = np.asarray(state["params"]["w"]).astype(np.float32)
    np.testing.assert_array_equal(
        restored["params"]["w"].float().numpy(), want)
    assert restored["params"]["w"].dtype == torch.bfloat16


def test_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    for s in (10, 20, 30, 40):
        mgr.save(s, _port_state())
    assert mgr.latest_step() == 40
    assert mgr.all_steps() == [20, 30, 40]        # keep=3 by default
    mgr2 = CheckpointManager(str(tmp_path / "two"), keep=2)
    for s in (1, 2, 3):
        mgr2.save(s, _port_state())
    assert mgr2.all_steps() == [2, 3]


def test_async_save_snapshots_before_returning(tmp_path):
    """The state is copied to host memory before ``save`` returns, so an
    in-place update right after does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    state = _port_state()
    want = state["params"]["w"].clone()
    mgr.save(5, state, blocking=False)
    state["params"]["w"].add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 5
    restored, _ = mgr.restore(_port_state(seed=2))
    assert torch.equal(restored["params"]["w"], want)


def test_tmp_dirs_are_never_published(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_00000009.tmp")     # a save cut short
    assert mgr.latest_step() is None
    mgr.save(9, _port_state())
    assert mgr.all_steps() == [9]
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_restore_rejects_shape_mismatch_and_missing_keys(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _port_state())
    bad = _port_state()
    bad["params"]["w"] = torch.zeros(5, 8)
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(bad)
    extra = _port_state()
    extra["params"]["new"] = torch.zeros(2)
    with pytest.raises(KeyError, match="params/new"):
        mgr.restore(extra)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_port_state())


def test_state_converters_round_trip():
    state = _port_state(dtype=torch.bfloat16)
    as_np = convert.state_to_numpy(state)
    assert as_np["params"]["w"].dtype == np.float32        # widened exactly
    back = convert.state_from_reference(as_np, device="cpu")
    assert torch.equal(back["params"]["w"].to(torch.bfloat16),
                       state["params"]["w"])
    assert back["opt"]["step"].dtype == torch.int32
    with pytest.raises(ValueError, match="params"):
        convert.state_to_numpy({"params": {}})
    with pytest.raises(ValueError, match="moment f32"):
        convert.state_from_reference(
            {"params": {}, "opt": {"m": {}, "v": {}}}, device="cpu")
