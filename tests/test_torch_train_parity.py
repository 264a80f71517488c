"""The port's training path against ``repro`` on the CPU: chunked attention
(forward and its recompute backward), ``DecoderLM.train_loss`` and every
gradient leaf, the AdamW schedule and update, microbatching, and
``run_training``'s history from one converted state.

Both packages run float32 configs on the same weights: the reference's
random tree, converted leaf by leaf (``convert.state_from_reference``);
the two packages' init RNGs differ, so parity never goes through seeds.
Tolerances are the reference tests': 2e-5 for attention outputs, 5e-4 for
attention gradients (``tests/test_attention.py``), 2e-4 for losses and
logits (``tests/test_torch_serve_parity.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.configs.base import get_arch as jax_get_arch
from repro.core import KVStore as JaxKVStore
from repro.core import LoaderConfig as JaxLoaderConfig
from repro.data.datasets import SyntheticTokenDataset as JaxTokenDataset
from repro.data.datasets import ingest as jax_ingest
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build_model
from repro.train import optimizer as jax_opt
from repro.train.loop import TrainLoopConfig as JaxTrainLoopConfig
from repro.train.loop import run_training as jax_run_training
from repro.train.step import init_state as jax_init_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.core import KVStore, LoaderConfig
from repro_torch.data.datasets import SyntheticTokenDataset, ingest
from repro_torch.kernels import ops
from repro_torch.models import attention, build_model
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.train import optimizer
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.step import make_train_step

TOL = dict(rtol=2e-4, atol=2e-4)
QUICKSTART = dict(name="quickstart-lm", family="dense", n_layers=2,
                  d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                  vocab=2048, head_dim=32, dtype="float32", remat=False)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _assert_trees_close(port, ref, **tol):
    """Every leaf of the reference's tree (nested dicts) against the
    port's, by key path."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        got = port
        for p in path:
            got = got[p.key]
        np.testing.assert_allclose(_np(got), np.asarray(leaf), **tol,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# chunked attention
# ---------------------------------------------------------------------------

def _qkv(seed, B, S, H, K, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 19), (False, 0)])
@pytest.mark.parametrize("S,qc,kc", [(128, 32, 32), (96, 64, 32)])
def test_chunked_forward_matches_reference(causal, window, S, qc, kc):
    q, k, v = _qkv(0, 2, S, 4, 2, 16)
    want = jax_attn.chunked_attention(q, k, v, causal=causal, window=window,
                                      q_chunk=qc, kv_chunk=kc)
    got = attention.chunked_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal, window=window,
        q_chunk=qc, kv_chunk=kc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal,window,S", [(True, 0, 96), (True, 23, 96),
                                             (True, 0, 100), (True, 7, 70)])
def test_chunked_gradients_match_reference(causal, window, S):
    """The recompute backward against ``jax.grad`` through the reference's
    custom VJP, with S a multiple of the 32-row chunks and not (100, 70:
    padded queries and keys)."""
    q, k, v = _qkv(1, 2, S, 4, 2, 16)

    def loss(q, k, v):
        o = jax_attn.chunked_attention(q, k, v, causal=causal, window=window,
                                       q_chunk=32, kv_chunk=32)
        return jnp.sum(o * o)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = attention.chunked_attention(tq, tk, tv, causal=causal, window=window,
                                    q_chunk=32, kv_chunk=32)
    (o * o).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=5e-4,
                                   atol=5e-4)


def test_chunked_equals_dense_and_skips_masked_blocks():
    """The port's chunked and plain attention agree in value and gradient,
    and a window narrower than a chunk leaves whole blocks out."""
    q, k, v = _qkv(2, 1, 128, 4, 2, 16)
    pos = torch.arange(128)
    grads = []
    for fn in (lambda a, b, c: attention.chunked_attention(
                   a, b, c, window=16, q_chunk=32, kv_chunk=32),
               lambda a, b, c: attention.dense_attention(
                   a, b, c, pos, pos, window=16)):
        t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        o = fn(*t)
        o.square().sum().backward()
        grads.append([o.detach()] + [x.grad for x in t])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=5e-5, atol=5e-5)
    live = [attention._block_live(slice(i, i + 32), slice(j, j + 32), True,
                                  16)
            for i in range(0, 128, 32) for j in range(0, 128, 32)]
    assert sum(live) == 7          # the diagonal and the one below it


# ---------------------------------------------------------------------------
# train_loss and its gradients
# ---------------------------------------------------------------------------

def _pair(name, **kw):
    if name == "quickstart":
        return (jax_build_model(JaxArchConfig(**dict(QUICKSTART, **kw))),
                build_model(ArchConfig(**dict(QUICKSTART, **kw)),
                            device="cpu"))
    return (jax_build_model(jax_get_arch(name).smoke_config().scaled(**kw)),
            build_model(get_arch(name).smoke_config().scaled(**kw),
                        device="cpu"))


def _batch(vocab, B, S, seed=1, mask=True):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32)}
    if mask:
        batch["loss_mask"] = (rng.random((B, S)) > 0.2).astype(np.float32)
    return batch


def _port_grads(pm, params, batch):
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, metrics = pm.train_loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, tree_unflatten(params, list(grads))


@pytest.mark.parametrize("name,S,kw", [
    ("qwen3_4b", 32, {}),
    ("quickstart", 64, {}),
    ("qwen3_4b", 2080, {"remat": True}),
    ("internvl2_2b", 32, {}),
])
def test_train_loss_and_every_gradient_match_reference(name, S, kw):
    """Loss, metrics and each gradient leaf against ``jax.value_and_grad``:
    dense attention with and without a loss mask, chunked attention with
    remat above ``DENSE_ATTN_MAX_SEQ`` (S=2080), and the VLM's text-only
    loss with patch embeddings."""
    jm, pm = _pair(name, **kw)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    vlm = jm.is_vlm
    batch = _batch(jm.cfg.vocab, 2, S, mask=not vlm)
    if vlm:
        rng = np.random.default_rng(3)
        batch["patch_embeds"] = 0.02 * rng.standard_normal(
            (2, jm.cfg.n_patches, jm.cfg.d_model)).astype(np.float32)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jm.train_loss(p, batch), has_aux=True)(params)
    p_loss, p_metrics, p_grads = _port_grads(
        pm, convert.params_from_reference(params, device="cpu"), batch)
    assert set(p_metrics) == set(metrics) == {"xent", "loss"}
    for key in metrics:
        np.testing.assert_allclose(float(p_metrics[key].detach()),
                                   float(metrics[key]), **TOL)
    np.testing.assert_allclose(float(p_loss), float(loss), **TOL)
    _assert_trees_close(p_grads, jax.tree.map(np.asarray, grads),
                        rtol=5e-4, atol=1e-6)


def test_moe_training_is_queued(monkeypatch):
    """MoE training is ported: Grok-1's smoke ``train_loss`` matches
    ``repro``'s loss and its five metrics, and it runs the expert einsums,
    never the serving kernel's dispatcher.  (The gradients, Kimi-K2 and
    the chunked case: ``tests/test_torch_moe_train_parity.py``.)"""
    jm, pm = _pair("grok_1_314b")
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    batch = _batch(jm.cfg.vocab, 2, 16)
    loss, metrics = jm.train_loss(params, batch)

    def refuse(*args, **kwargs):
        raise AssertionError("the MoE train path called grouped_matmul")

    monkeypatch.setattr(ops, "grouped_matmul", refuse)
    p_loss, p_metrics = pm.train_loss(
        convert.params_from_reference(params, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(p_metrics) == set(metrics) == {
        "xent", "loss", "moe_aux_loss", "moe_z_loss", "moe_dropped_frac"}
    for key in metrics:
        np.testing.assert_allclose(float(p_metrics[key].detach()),
                                   float(metrics[key]), **TOL, err_msg=key)
    np.testing.assert_allclose(float(p_loss.detach()), float(loss), **TOL)


def test_forward_for_prefill_is_unchanged_by_train_path():
    """``train=False`` (the prefill path, the kernels' plain versions on
    the CPU) and ``train=True`` give the same logits."""
    _, pm = _pair("qwen3_4b")
    params = pm.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_batch(pm.cfg.vocab, 2, 24)["tokens"])
    with torch.no_grad():
        a, _ = pm.forward(params, tokens)
        b, _ = pm.forward(params, tokens, train=True)
    torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_lr_at_every_step_matches_reference():
    cfg = dict(peak_lr=1e-3, warmup_steps=10, total_steps=100,
               min_lr_ratio=0.1)
    jcfg = jax_opt.OptimizerConfig(**cfg)
    pcfg = optimizer.OptimizerConfig(**cfg)
    for step in range(0, 106):
        np.testing.assert_allclose(
            float(optimizer.lr_at(pcfg, torch.tensor(step,
                                                     dtype=torch.int32))),
            float(jax_opt.lr_at(jcfg, jnp.asarray(step, jnp.int32))),
            rtol=1e-6, atol=0)


def _small_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((3, 4, 5))).astype(np.float32),
            "b": {"c": (scale * rng.standard_normal((6,))).astype(np.float32)}}


def _state_both(params_np, cfg_kw):
    jcfg = jax_opt.OptimizerConfig(**cfg_kw)
    pcfg = optimizer.OptimizerConfig(**cfg_kw)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jopt = jax_opt.adamw_init(jparams, jcfg)
    pstate = convert.state_from_reference(
        {"params": params_np, "opt": jax.tree.map(np.asarray, jopt)},
        device="cpu")
    return jcfg, pcfg, jparams, jopt, pstate


def test_clipped_update_matches_reference():
    """Gradients far above ``clip_norm``: the clip, moments, bias
    correction, weight decay and the new parameters."""
    kw = dict(peak_lr=1e-2, warmup_steps=0, total_steps=10, clip_norm=1.0,
              weight_decay=0.1)
    params = _small_tree(0)
    grads = _small_tree(1, scale=1e4)
    jcfg, pcfg, jparams, jopt, pstate = _state_both(params, kw)
    jp, jo, jstats = jax_opt.adamw_update(jax.tree.map(jnp.asarray, grads),
                                          jopt, jparams, jcfg)
    pgrads = convert.params_from_reference(grads, device="cpu")
    pp, po, pstats = optimizer.adamw_update(pgrads, pstate["opt"],
                                            pstate["params"], pcfg)
    assert float(jstats["grad_norm"]) > 1e4
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(pstats[key]), float(jstats[key]),
                                   rtol=1e-6)
    _assert_trees_close(pp, jax.tree.map(np.asarray, jp), rtol=1e-6,
                        atol=1e-7)
    _assert_trees_close(po, jax.tree.map(np.asarray, jo), rtol=1e-6,
                        atol=1e-9)
    assert po["step"].dtype == torch.int32 and int(po["step"]) == 1


def _stacked_tree(seed, scale=1.0):
    """``_small_tree`` with a 4-D leaf, stacked experts as Grok-1's
    (layers, experts, d, f), and a matrix."""
    rng = np.random.default_rng(seed)
    tree = _small_tree(seed, scale)
    tree["experts"] = (scale * rng.standard_normal((2, 3, 4, 6))
                       ).astype(np.float32)
    tree["embed"] = (scale * rng.standard_normal((7, 5))).astype(np.float32)
    return tree


def test_per_layer_update_equals_whole_leaf_update(monkeypatch):
    """A stacked leaf updated one layer slice at a time (as at Qwen3-4B's
    width), a 4-D leaf cut down to one expert's matrix and below (as at
    Grok-1's), and a matrix in blocks of rows, give the bits of the
    whole-leaf update; the views cover each leaf once, each within
    ``CHUNK_ELEMS`` or a single row."""
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    params = _stacked_tree(4)
    grads = _stacked_tree(5, scale=0.1)
    for chunk, n_parts in ((1 << 27, 1), (24, 6), (12, 12), (0, 24)):
        monkeypatch.setattr(optimizer, "CHUNK_ELEMS", chunk)
        leaf = torch.from_numpy(params["experts"])
        parts = optimizer._parts(leaf)
        assert len(parts) == n_parts
        assert sum(p.numel() for p in parts) == leaf.numel()
        assert all(p.numel() <= max(chunk, 6) for p in parts)
        assert torch.equal(torch.cat([p.reshape(-1) for p in parts]),
                           leaf.reshape(-1))
    outs = []
    for chunk in (1 << 27, 24, 0):
        monkeypatch.setattr(optimizer, "CHUNK_ELEMS", chunk)
        _, pcfg, _, _, pstate = _state_both(params, kw)
        pgrads = convert.params_from_reference(grads, device="cpu")
        for _ in range(3):
            out = optimizer.adamw_update(pgrads, pstate["opt"],
                                         pstate["params"], pcfg)
            pstate = {"params": out[0], "opt": out[1]}
        outs.append(convert.state_to_numpy(pstate))
    for other in outs[1:]:
        for a, b in zip(jax.tree.leaves(outs[0]), jax.tree.leaves(other)):
            np.testing.assert_array_equal(a, b)


def test_int8_state_is_queued():
    """The int8 states, queued until the port had them, now train on the
    quickstart config against ``repro``: each step's metrics, and the
    parameters, within ``TOL`` while the two runs stay comparable
    (``tests/test_torch_optimizer_int8.py`` holds the update itself on
    equal gradients).

    ``int8_factored``: three steps.  ``int8``: two steps' metrics and the
    parameters after one update.  Its second update is ill-conditioned
    in both packages: where an element's v code rounds to 0 while its m
    code does not, and its new gradient is near 0, the step nears
    ``lr * m_hat / eps``, so a code one apart (the gradients differ in
    their last bits) moves a parameter by far more than ``TOL``.  Both
    runs take such steps: the third step's gradient norm is above 50 in
    each."""
    jstate, pstate, jmet, pmet = _steps_both("quickstart", 3,
                                             state_dtype="int8_factored")
    for j, p in zip(jmet, pmet):
        for key in j:
            np.testing.assert_allclose(p[key], j[key], **TOL)
    _assert_trees_close(pstate["params"], jstate["params"], **TOL)
    v = pstate["opt"]["v"]["embed"]["embedding"]
    assert set(v) == {"vr", "vc"} and v["vr"].dtype == torch.float32
    jstate, pstate, jmet, pmet = _steps_both("quickstart", 1,
                                             state_dtype="int8")
    _assert_trees_close(pstate["params"], jstate["params"], **TOL)
    m, want = (s["opt"]["m"]["embed"]["embedding"] for s in (pstate, jstate))
    assert m["q"].dtype == torch.int8
    assert np.abs(m["q"].numpy().astype(int)
                  - want["q"].astype(int)).max() <= 1
    jstate, pstate, jmet, pmet = _steps_both("quickstart", 3,
                                             state_dtype="int8")
    for j, p in zip(jmet[:2], pmet[:2]):
        for key in j:
            np.testing.assert_allclose(p[key], j[key], **TOL)
    assert jmet[2]["grad_norm"] > 50 and pmet[2]["grad_norm"] > 50


# ---------------------------------------------------------------------------
# train step: 5 AdamW steps, microbatches
# ---------------------------------------------------------------------------

def _steps_both(name, n_steps, microbatches=1, B=4, S=32,
                state_dtype="float32"):
    jm, pm = _pair(name)
    kw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=20,
              state_dtype=state_dtype)
    jcfg = jax_opt.OptimizerConfig(**kw)
    pcfg = optimizer.OptimizerConfig(**kw)
    jstate = jax_init_state(jm, jcfg, jax.random.PRNGKey(0))
    pstate = convert.state_from_reference(jax.tree.map(np.asarray, jstate),
                                          device="cpu")
    jstep = jax.jit(jax_make_train_step(jm, jcfg, microbatches=microbatches))
    pstep = make_train_step(pm, pcfg, microbatches=microbatches)
    jmet, pmet = [], []
    for i in range(n_steps):
        batch = _batch(jm.cfg.vocab, B, S, seed=10 + i)
        jstate, m = jstep(jstate, batch)
        jmet.append(jax.tree.map(float, m))
        pstate, m = pstep(pstate, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
        pmet.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, jstate), pstate, jmet, pmet


def test_five_adamw_steps_match_reference():
    """Parameters, moments and step after 5 train steps on the quickstart
    config, and each step's loss, grad norm and learning rate."""
    jstate, pstate, jmet, pmet = _steps_both("quickstart", 5)
    for j, p in zip(jmet, pmet):
        assert set(p) == set(j) == {"xent", "loss", "grad_norm", "lr"}
        for key in j:
            np.testing.assert_allclose(p[key], j[key], **TOL)
    assert int(pstate["opt"]["step"]) == int(jstate["opt"]["step"]) == 5
    _assert_trees_close(pstate["params"], jstate["params"], **TOL)
    _assert_trees_close(pstate["opt"]["m"], jstate["opt"]["m"], rtol=2e-3,
                        atol=1e-7)
    _assert_trees_close(pstate["opt"]["v"], jstate["opt"]["v"], rtol=2e-3,
                        atol=1e-10)


def test_microbatches_match_reference():
    """Two microbatches: gradients accumulated in f32, metrics averaged."""
    jstate, pstate, jmet, pmet = _steps_both("qwen3_4b", 2, microbatches=2)
    for j, p in zip(jmet, pmet):
        for key in j:
            np.testing.assert_allclose(p[key], j[key], **TOL)
    _assert_trees_close(pstate["params"], jstate["params"], **TOL)


# ---------------------------------------------------------------------------
# run_training
# ---------------------------------------------------------------------------

SEQ, B = 24, 8


@pytest.fixture(scope="module")
def stores():
    """The same token records in each package's store."""
    ds = dict(n_samples=256, seq_len=SEQ, vocab=512, seed=7)
    jstore, pstore = JaxKVStore(), KVStore()
    ju = jax_ingest(jstore, JaxTokenDataset(**ds))
    pu = ingest(pstore, SyntheticTokenDataset(**ds))
    assert [str(u) for u in ju] == [str(u) for u in pu]
    return (jstore, ju), (pstore, pu)


TINY = dict(name="loop-test-lm", family="dense", n_layers=1, d_model=32,
            n_heads=2, n_kv_heads=1, d_ff=64, vocab=512, head_dim=16,
            dtype="float32", remat=False)
LOADER = dict(batch_size=B, prefetch_buffers=2, io_threads=2, route="med",
              materialize=True, flow_control="adaptive", seed=3)


def test_run_training_matches_reference(stores):
    """One converted state through both packages' ``run_training``: the
    same logged losses, and identical stall and goodput accounting under
    ``charge_step_time`` (the loader and clock are the reference's)."""
    (jstore, ju), (pstore, pu) = stores
    jm = jax_build_model(JaxArchConfig(**TINY))
    pm = build_model(ArchConfig(**TINY), device="cpu")
    opt_kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=8)
    jstate = jax_init_state(jm, jax_opt.OptimizerConfig(**opt_kw),
                            jax.random.PRNGKey(0))
    pstate = convert.state_from_reference(jax.tree.map(np.asarray, jstate),
                                          device="cpu")
    loop = dict(total_steps=8, seq_len=SEQ, log_every=1,
                charge_step_time=0.01)
    jres = jax_run_training(jm, jstore, ju, JaxLoaderConfig(**LOADER),
                            JaxTrainLoopConfig(**loop),
                            jax_opt.OptimizerConfig(**opt_kw), state=jstate)
    pres = run_training(pm, pstore, pu, LoaderConfig(**LOADER),
                        TrainLoopConfig(**loop),
                        optimizer.OptimizerConfig(**opt_kw), state=pstate)
    assert len(pres["history"]) == len(jres["history"]) == 8
    for p, j in zip(pres["history"], jres["history"]):
        assert p["step"] == j["step"]
        np.testing.assert_allclose(p["loss"], j["loss"], **TOL)
        assert p["stall_frac"] == j["stall_frac"]
        assert p["goodput_sps"] == j["goodput_sps"]
        assert np.isfinite(p["grad_norm"]) and p["grad_norm"] > 0
    for key in ("steps", "stall_frac", "goodput_sps", "buffer_hits",
                "blocked"):
        assert pres["stats"][key] == jres["stats"][key]


def test_checkpoint_restore_bit_exact_loss_curve(stores, tmp_path):
    """The twin of ``tests/test_training_loop.py``'s: interrupting at a
    checkpoint and restoring replays the identical sample stream through
    DeviceFeed, and the loss curve is bit-exact."""
    _, (store, uuids) = stores
    loader_cfg = LoaderConfig(batch_size=B, prefetch_buffers=2, io_threads=2,
                              route="low", out_of_order=False,
                              materialize=True, seed=5)
    opt = optimizer.OptimizerConfig(peak_lr=1e-3, warmup_steps=2,
                                    total_steps=8)
    model = build_model(ArchConfig(**TINY), device="cpu")

    def run(total, ckpt=None):
        losses = []
        run_training(model, store, uuids, loader_cfg,
                     TrainLoopConfig(total_steps=total, seq_len=SEQ,
                                     log_every=1, checkpoint_every=4,
                                     checkpoint_dir=ckpt,
                                     charge_step_time=0.01),
                     opt, on_metrics=lambda m: losses.append(m["loss"]))
        return losses

    want = run(8)
    ckpt = str(tmp_path / "ckpt")
    got = run(4, ckpt) + run(8, ckpt)
    assert got == want
