"""The port's int8 optimizer states against ``repro.train.optimizer``:
``adamw_update`` with ``int8`` and ``int8_factored`` moments over five
steps (0-d, 1-D, 2-D and 4-D leaves, with ``CHUNK_ELEMS`` lowered so that
the row blocks and the leading-axis cuts run), ``abstract_state`` and
``state_logical_axes`` for every registered arch at full width, and the
int8 states through ``convert`` and both packages' checkpoints.

Tolerances.  The update is the reference's op for op (division, not a
reciprocal; round half to even; the same order of f32 operations), but
the global norm and the factored means are sums in another order, so
clip, ``vr`` and ``vc`` may differ in their last bits.  An int8 code may
then differ by one, and only where the reference's own f32 value lies
within ``BOUNDARY`` of a rounding boundary; scales agree within 1e-5
relative, ``vr``/``vc`` within 1e-5, and parameters within the f32
update's parity tolerance (``tests/test_torch_train_parity.py``'s
clipped update, 1e-6 relative and 1e-7 absolute)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.train import optimizer as jax_opt
from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.train.step import abstract_state as jax_abstract_state
from repro.train.step import state_logical_axes as jax_state_logical_axes
from repro_torch import convert
from repro_torch.configs.base import get_arch
from repro_torch.models import build_model
from repro_torch.train import optimizer
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.step import abstract_state, state_logical_axes

QUANTIZED = ("int8", "int8_factored")
BOUNDARY = 1e-3          # of a code step, around a half-integer
PARAM_TOL = dict(rtol=1e-6, atol=1e-7)
KW = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=1.0)
# With CHUNK_ELEMS at 24: "m" (40, 6) in row blocks of 4; "e" (2, 3, 8, 6)
# cut to (8, 6) matrices, each in row blocks (int8) or read twice in row
# blocks (factored); "w" (3, 4, 2) whole.
CHUNK = 24


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"s": draw(), "b": draw(6), "m": draw(40, 6), "w": draw(3, 4, 2),
            "blocks": {"e": draw(2, 3, 8, 6)}}


def _walk(tree, path=()):
    """(path, leaf) of a tree of nested dicts, in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _port_update(params, grads, state_dtype, chunk, monkeypatch, steps=5):
    monkeypatch.setattr(optimizer, "CHUNK_ELEMS", chunk)
    cfg = optimizer.OptimizerConfig(state_dtype=state_dtype, **KW)
    p = convert.params_from_reference(params, device="cpu")
    opt = optimizer.adamw_init(p, cfg)
    out = []
    for g in grads[:steps]:
        p, opt, stats = optimizer.adamw_update(
            convert.params_from_reference(g, device="cpu"), opt, p, cfg)
        # copies: on the CPU the arrays share the tensors' memory, which
        # the next update writes in place
        out.append(jax.tree.map(np.copy, convert.state_to_numpy(
            {"params": p, "opt": opt})))
    return out


def _jax_update(params, grads, state_dtype, steps=5):
    cfg = jax_opt.OptimizerConfig(state_dtype=state_dtype, **KW)
    p = jax.tree.map(jnp.asarray, params)
    opt = jax_opt.adamw_init(p, cfg)
    out, norms = [jax.tree.map(np.asarray, {"params": p, "opt": opt})], []
    for g in grads[:steps]:
        p, opt, stats = jax_opt.adamw_update(jax.tree.map(jnp.asarray, g),
                                             opt, p, cfg)
        out.append(jax.tree.map(np.asarray, {"params": p, "opt": opt}))
        norms.append(float(stats["grad_norm"]))
    return out, norms


def _check_codes(got_q, want_q, want_scale, f32_value):
    """Codes equal, or one apart where the reference's f32 value over its
    scale lies within BOUNDARY of a half-integer."""
    diff = np.abs(got_q.astype(np.int32) - want_q.astype(np.int32))
    assert diff.max(initial=0) <= 1
    where = diff > 0
    if where.any():
        z = np.broadcast_to(f32_value / want_scale.astype(np.float64),
                            want_q.shape)[where]
        assert np.all(np.abs(np.abs(z - np.floor(z)) - 0.5) < BOUNDARY), z
    return int(where.sum())


@pytest.mark.parametrize("state_dtype", QUANTIZED)
def test_five_updates_match_reference(state_dtype, monkeypatch):
    """Five clipped AdamW updates from one state: every code within one
    (and only at a rounding boundary), scales, the factored moments and
    the parameters within the stated tolerances; the step count equal."""
    params = _tree(0)
    grads = [_tree(10 + i, scale=0.5) for i in range(5)]
    want, norms = _jax_update(params, grads, state_dtype)
    got = _port_update(params, grads, state_dtype, CHUNK, monkeypatch)
    cfg = jax_opt.OptimizerConfig(state_dtype=state_dtype, **KW)
    flips = 0
    for k in range(5):
        prev, ref, port = want[k], want[k + 1], got[k]
        clip = min(1.0, cfg.clip_norm / max(norms[k], 1e-9))
        assert int(port["opt"]["step"]) == int(ref["opt"]["step"]) == k + 1
        for path, p_ref in _walk(ref["params"]):
            np.testing.assert_allclose(_at(port["params"], path), p_ref,
                                       **PARAM_TOL, err_msg=str(path))
            g = _at(grads[k], path).astype(np.float64) * clip
            for moment, beta, term in (("m", cfg.b1, g),
                                       ("v", cfg.b2, g * g)):
                r, o = _at(ref["opt"][moment], path), \
                    _at(port["opt"][moment], path)
                before = _at(prev["opt"][moment], path)
                kind = set(r) if isinstance(r, dict) else None
                if kind == {"q", "scale"}:
                    value = beta * (before["q"] * before["scale"].astype(
                        np.float64)) + (1 - beta) * term
                    np.testing.assert_allclose(o["scale"], r["scale"],
                                               rtol=1e-5, atol=0)
                    assert o["q"].dtype == np.int8
                    flips += _check_codes(o["q"], r["q"], r["scale"], value)
                elif kind == {"vr", "vc"}:
                    for key in ("vr", "vc"):
                        np.testing.assert_allclose(o[key], r[key],
                                                   rtol=1e-5, atol=0)
                else:
                    np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-12)
    # The count of codes one apart over the five steps: a handful at most.
    assert flips <= 5


def test_int8_update_is_row_local(monkeypatch):
    """``int8``: the leaves updated in row blocks and leading-axis cuts
    give the bits of the whole-leaf update; ``int8_factored`` reads a
    matrix twice in blocks and agrees within rounding.  The gradients'
    norm stays under ``clip_norm``: the global norm sums its parts in the
    cut's order, so a clip would differ in its last bits."""
    params = _tree(1)
    grads = [_tree(20 + i, scale=0.01) for i in range(3)]
    for state_dtype in QUANTIZED:
        whole = _port_update(params, grads, state_dtype, 1 << 27,
                             monkeypatch, steps=3)[-1]
        cut = _port_update(params, grads, state_dtype, CHUNK, monkeypatch,
                           steps=3)[-1]
        for path, a in _walk(whole):
            b = _at(cut, path)
            if state_dtype == "int8":
                np.testing.assert_array_equal(a, b, err_msg=str(path))
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7,
                                           err_msg=str(path))


def test_views_cover_each_leaf_once(monkeypatch):
    """``_index`` cuts a leaf into views of at most ``CHUNK_ELEMS``
    elements (or single rows) that tile it; ``_lead_index`` cuts only
    leading axes, down to matrices."""
    monkeypatch.setattr(optimizer, "CHUNK_ELEMS", CHUNK)
    t = torch.arange(2 * 3 * 8 * 6).reshape(2, 3, 8, 6)
    parts = [t[i] for i in optimizer._index(t.shape)]
    assert len(parts) == 12 and all(p.numel() <= CHUNK for p in parts)
    assert torch.equal(torch.cat([p.reshape(-1) for p in parts]),
                       t.reshape(-1))
    lead = optimizer._lead_index(t.shape)
    assert lead == [(i, j) for i in range(2) for j in range(3)]
    assert optimizer._lead_index((40, 6)) == [()]
    assert optimizer._index((40, 6))[0] == (slice(0, 4),)
    assert optimizer._index(()) == [()] and optimizer._index((100,)) == [()]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_state_matches_reference(arch):
    """Leaf for leaf (path, shape, dtype, logical axes) for each state
    dtype at full width; ``meta`` tensors, so nothing is allocated."""
    model = build_model(get_arch(arch), device="cpu")
    jmodel = jax_build_model(jax_get_arch(arch))
    for state_dtype in optimizer.STATE_DTYPES:
        cfg = optimizer.OptimizerConfig(state_dtype=state_dtype)
        jcfg = jax_opt.OptimizerConfig(state_dtype=state_dtype)
        state = abstract_state(model, cfg)
        axes = state_logical_axes(model, cfg)
        jstate = jax_abstract_state(jmodel, jcfg)
        jaxes = jax_state_logical_axes(jmodel, jcfg)
        got = dict(_walk(state))
        want = {tuple(p.key for p in path): leaf for path, leaf in
                jax.tree_util.tree_flatten_with_path(jstate)[0]}
        assert set(got) == set(want)
        for path, leaf in got.items():
            ref = want[path]
            assert leaf.is_meta
            assert tuple(leaf.shape) == tuple(ref.shape), path
            assert str(leaf.dtype).removeprefix("torch.") == \
                np.dtype(ref.dtype).name, path
            assert tuple(_at(axes, path)) == tuple(_at(jaxes, path)), path
            assert len(_at(axes, path)) == leaf.dim()


def _ref_state(state_dtype, steps=2):
    """The reference's state after ``steps`` updates, as numpy."""
    params = _tree(2)
    return _jax_update(params, [_tree(30 + i) for i in range(steps)],
                       state_dtype, steps)[0][-1]


@pytest.mark.parametrize("state_dtype", QUANTIZED)
def test_int8_states_convert_and_checkpoint_both_ways(state_dtype,
                                                      tmp_path):
    """``convert`` round trips (int8 codes stay int8), and each package
    restores the other's checkpoint of an int8 state bit for bit."""
    state = _ref_state(state_dtype)
    port = convert.state_from_reference(state, device="cpu")
    assert port["opt"]["m"]["m"]["q"].dtype == torch.int8
    back = convert.state_to_numpy(port)
    for path, want in _walk(state):
        got = _at(back, path)
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    # reference writes, port restores (template: meta tensors)
    JaxCheckpointManager(str(tmp_path / "ref")).save(
        3, jax.tree.map(jnp.asarray, state))
    template = jax.tree.map(lambda a: torch.empty(
        a.shape, dtype=port_dtype(a.dtype), device="meta"), state)
    restored, manifest = CheckpointManager(str(tmp_path / "ref")).restore(
        _as_dicts(template))
    assert manifest["step"] == 3
    for path, want in _walk(state):
        got = _at(restored, path)
        assert got.device.type == "cpu" and not got.is_meta
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(path))
    # port writes, reference restores
    CheckpointManager(str(tmp_path / "port")).save(4, port)
    jrestored, _ = JaxCheckpointManager(str(tmp_path / "port")).restore(
        jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, state)))
    for path, want in _walk(state):
        got = np.asarray(_at(jrestored, path))
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))


def port_dtype(dtype):
    return getattr(torch, np.dtype(dtype).name)


def _as_dicts(tree):
    return {k: _as_dicts(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree


def test_unknown_state_dtype_is_refused():
    with pytest.raises(ValueError, match="state_dtype"):
        optimizer.adamw_init({"w": torch.zeros(3)},
                             optimizer.OptimizerConfig(state_dtype="fp8"))
