"""The port's MoE training path against ``repro`` on the CPU: the MoE
layer's training mode (value and gradients, one chunk and several under
the per-chunk checkpoint), ``DecoderLM.train_loss`` with its MoE metrics
and every gradient leaf for Grok-1's and Kimi-K2's smoke configs, five
AdamW steps, and ``run_training`` through the loader.

Both packages run float32 configs on the same weights: the reference's
random tree, converted leaf by leaf; the init RNGs differ, so parity never
goes through seeds.  Tolerances are the dense training tests'
(``tests/test_torch_train_parity.py``): 2e-4 for losses, metrics and
outputs, rtol 5e-4 / atol 1e-6 for gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.core import KVStore as JaxKVStore
from repro.core import LoaderConfig as JaxLoaderConfig
from repro.data.datasets import SyntheticTokenDataset as JaxTokenDataset
from repro.data.datasets import ingest as jax_ingest
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.models.params import init_params as jax_init_params
from repro.train import optimizer as jax_opt
from repro.train.loop import TrainLoopConfig as JaxTrainLoopConfig
from repro.train.loop import run_training as jax_run_training
from repro.train.step import init_state as jax_init_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs.base import get_arch
from repro_torch.core import KVStore, LoaderConfig
from repro_torch.data.datasets import SyntheticTokenDataset, ingest
from repro_torch.kernels import ops
from repro_torch.models import build_model, moe
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.train import optimizer
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.step import make_train_step

TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-4, atol=1e-6)
METRICS = {"xent", "loss", "moe_aux_loss", "moe_z_loss", "moe_dropped_frac"}
MOE_ARCHS = ("grok_1_314b", "kimi_k2_1t_a32b")


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


def _pair(name, **kw):
    return (jax_build_model(jax_get_arch(name).smoke_config().scaled(**kw)),
            build_model(get_arch(name).smoke_config().scaled(**kw),
                        device="cpu"))


def _batch(vocab, B, S, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}


@pytest.fixture
def no_kernel(monkeypatch):
    """Training must run the einsums: the serving kernel's dispatcher
    raises if the train path reaches it."""
    def refuse(*args, **kwargs):
        raise AssertionError("the MoE train path called grouped_matmul")
    monkeypatch.setattr(ops, "grouped_matmul", refuse)


# ---------------------------------------------------------------------------
# the MoE layer's training mode
# ---------------------------------------------------------------------------

def _layer(seed, d=16, f=32, E=4):
    p = jax_init_params(jax_moe.moe_spec(d, f, E), jax.random.PRNGKey(seed),
                        jnp.float32)
    p = jax.tree.map(lambda a: np.array(a), p)
    return p, convert.params_from_reference(p, device="cpu")


@pytest.mark.parametrize("S,n_chunks", [(600, 1), (1024, 2), (40, 1)])
def test_moe_apply_train_mode_matches_reference(S, n_chunks, no_kernel):
    """Output, metrics and the gradients of x and of every parameter
    against ``jax.grad`` of the reference's ``moe_apply``: at S = 600, not
    a multiple of 512, where the reference runs one chunk; at S = 1024,
    two chunks under the reference's ``jax.checkpoint`` and the port's
    ``torch.utils.checkpoint``; and at S = 40 with capacity drops.  The
    loss weighs the output by a fixed tensor and adds the aux losses, so
    the router's gradient has a share through the gates."""
    assert moe.n_chunks(S) == n_chunks
    jp, tp = _layer(0)
    rng = np.random.default_rng(S)
    x = (0.5 * rng.standard_normal((2, S, 16))).astype(np.float32)
    r = rng.standard_normal((2, S, 16)).astype(np.float32)
    kw = dict(top_k=2, capacity_factor=1.0 if S == 40 else 1.25)

    def jloss(p, x):
        out, aux = jax_moe.moe_apply(p, x, **kw)
        return (jnp.sum(out * r) + aux["moe_aux_loss"]
                + aux["moe_z_loss"]), (out, aux)

    (_, (want, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    out, aux = moe.moe_apply(tp, tx, train=True, **kw)
    loss = (out * torch.from_numpy(r)).sum() + aux["moe_aux_loss"] \
        + aux["moe_z_loss"]
    grads = torch.autograd.grad(loss, [tx] + leaves)
    np.testing.assert_allclose(_np(out), np.asarray(want), **TOL)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                   **TOL, err_msg=k)
    if S == 40:
        assert float(aux["moe_dropped_frac"]) > 0
    np.testing.assert_allclose(_np(grads[0]), np.asarray(jgx), **GRAD_TOL)
    _assert_trees_close(tree_unflatten(tp, list(grads[1:])),
                        jax.tree.map(np.asarray, jgp), **GRAD_TOL)


def test_gates_carry_the_routers_gradient(no_kernel):
    """With no aux loss the router is reached through the gate values
    alone (``gate_slot``): its gradient is not zero and matches the
    reference's."""
    jp, tp = _layer(1)
    x = (0.5 * np.random.default_rng(2).standard_normal((2, 24, 16))
         ).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(jax_moe.moe_apply(
        p, jnp.asarray(x), top_k=2)[0] ** 2))(jax.tree.map(jnp.asarray,
                                                           jp))["router"]
    tp["router"].requires_grad_(True)
    out, _ = moe.moe_apply(tp, torch.from_numpy(x), top_k=2, train=True)
    (got,) = torch.autograd.grad(out.square().sum(), [tp["router"]])
    assert float(got.abs().max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("S", [600, 1024])
def test_moe_apply_serving_and_training_modes_agree(S):
    """The kernel's plain version (serving) and the einsums (training)
    give the same output and metrics, for one chunk and for two."""
    _, tp = _layer(3)
    x = torch.from_numpy((0.5 * np.random.default_rng(4).standard_normal(
        (2, S, 16))).astype(np.float32))
    with torch.no_grad():
        a, aux_a = moe.moe_apply(tp, x, top_k=2)
        b, aux_b = moe.moe_apply(tp, x, top_k=2, train=True)
    torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
    for k in aux_a:
        assert float(aux_a[k]) == float(aux_b[k])


# ---------------------------------------------------------------------------
# train_loss and every gradient leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("S,kw", [(32, {}), (1024, {"remat": True})])
def test_moe_train_loss_and_every_gradient_match_reference(name, S, kw,
                                                           no_kernel):
    """Loss, the five metrics and each gradient leaf against
    ``jax.value_and_grad``, at S = 32 and at S = 1024 with remat, where
    two 512-token chunks run under the per-chunk checkpoint inside each
    layer's."""
    jm, pm = _pair(name, **kw)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    batch = _batch(jm.cfg.vocab, 2, S)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jm.train_loss(p, batch), has_aux=True)(params)
    pparams = convert.params_from_reference(params, device="cpu")
    leaves = tree_leaves(pparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    p_loss, p_metrics = pm.train_loss(
        pparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    p_grads = torch.autograd.grad(p_loss, leaves)
    assert set(p_metrics) == set(metrics) == METRICS
    for key in metrics:
        np.testing.assert_allclose(float(p_metrics[key].detach()),
                                   float(metrics[key]), **TOL, err_msg=key)
    np.testing.assert_allclose(float(p_loss), float(loss), **TOL)
    _assert_trees_close(tree_unflatten(pparams, list(p_grads)),
                        jax.tree.map(np.asarray, grads), **GRAD_TOL)


# ---------------------------------------------------------------------------
# five AdamW steps, run_training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_five_adamw_steps_match_reference(name, no_kernel):
    """Each step's metrics (the MoE ones included), and the parameters and
    step after 5 train steps."""
    jm, pm = _pair(name)
    kw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=20)
    jcfg = jax_opt.OptimizerConfig(**kw)
    jstate = jax_init_state(jm, jcfg, jax.random.PRNGKey(0))
    pstate = convert.state_from_reference(jax.tree.map(np.asarray, jstate),
                                          device="cpu")
    jstep = jax.jit(jax_make_train_step(jm, jcfg))
    pstep = make_train_step(pm, optimizer.OptimizerConfig(**kw))
    for i in range(5):
        batch = _batch(jm.cfg.vocab, 4, 32, seed=10 + i)
        jstate, jm_ = jstep(jstate, batch)
        pstate, pm_ = pstep(pstate, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
        assert set(pm_) == set(jm_) == METRICS | {"grad_norm", "lr"}
        for key in jm_:
            np.testing.assert_allclose(float(pm_[key]), float(jm_[key]),
                                       **TOL, err_msg=f"step {i} {key}")
    assert int(pstate["opt"]["step"]) == 5
    _assert_trees_close(pstate["params"],
                        jax.tree.map(np.asarray, jstate["params"]), **TOL)


def test_moe_run_training_matches_reference(no_kernel):
    """One converted Grok-1 smoke state through both packages'
    ``run_training`` over the loader: the same logged losses, the same
    stall and goodput accounting, and the MoE metrics in each record."""
    seq, batch = 24, 8
    ds = dict(n_samples=256, seq_len=seq, vocab=512, seed=7)
    jstore, pstore = JaxKVStore(), KVStore()
    ju = jax_ingest(jstore, JaxTokenDataset(**ds))
    pu = ingest(pstore, SyntheticTokenDataset(**ds))
    jm, pm = _pair("grok_1_314b", n_layers=1)
    opt_kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=6)
    jstate = jax_init_state(jm, jax_opt.OptimizerConfig(**opt_kw),
                            jax.random.PRNGKey(0))
    pstate = convert.state_from_reference(jax.tree.map(np.asarray, jstate),
                                          device="cpu")
    loader = dict(batch_size=batch, prefetch_buffers=2, io_threads=2,
                  route="med", materialize=True, seed=3)
    loop = dict(total_steps=6, seq_len=seq, log_every=1,
                charge_step_time=0.01)
    jres = jax_run_training(jm, jstore, ju, JaxLoaderConfig(**loader),
                            JaxTrainLoopConfig(**loop),
                            jax_opt.OptimizerConfig(**opt_kw), state=jstate)
    pres = run_training(pm, pstore, pu, LoaderConfig(**loader),
                        TrainLoopConfig(**loop),
                        optimizer.OptimizerConfig(**opt_kw), state=pstate)
    assert len(pres["history"]) == len(jres["history"]) == 6
    for p, j in zip(pres["history"], jres["history"]):
        np.testing.assert_allclose(p["loss"], j["loss"], **TOL)
        assert p["stall_frac"] == j["stall_frac"]
        assert p["goodput_sps"] == j["goodput_sps"]
        assert {"moe_aux_loss", "moe_z_loss", "moe_dropped_frac"} <= set(p)
        assert p["moe_aux_loss"] > 0 and np.isfinite(p["moe_z_loss"])
