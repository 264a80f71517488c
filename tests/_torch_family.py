"""Shared checks of the per-family parity files
(``tests/test_torch_{hybrid,xlstm,whisper}_parity.py``): one family's
``smoke_config()`` in ``repro`` and in the port, on the same weights (the
reference's random tree, converted leaf by leaf with
``convert.params_from_reference``; the init RNGs differ, so parity never
goes through seeds).  Inputs come from numpy seeds.

Tolerances are ``tests/test_torch_train_parity.py``'s: 2e-4 for logits and
losses, 5e-4 relative (1e-6 absolute) for gradient leaves."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServingEngine as JaxServingEngine
from repro.train.step import make_prefill_step as jax_make_prefill_step
from repro.train.step import make_serve_step as jax_make_serve_step
from repro_torch import convert
from repro_torch.configs.base import get_arch
from repro_torch.models import build_model
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.train.step import make_prefill_step, make_serve_step

TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-4, atol=1e-6)


def models(arch, **kw):
    """(reference model, port model on the CPU) of ``arch``'s smoke
    config, scaled by ``kw``."""
    return (jax_build_model(jax_get_arch(arch).smoke_config().scaled(**kw)),
            build_model(get_arch(arch).smoke_config().scaled(**kw),
                        device="cpu"))


def weights(jax_model, seed=0):
    """The reference's random parameters as a numpy tree."""
    return jax.tree.map(np.asarray, jax_model.init(jax.random.PRNGKey(seed)))


def flat_specs(spec):
    """{"a/b/c": (shape, axes, init, scale)} of a spec tree (nested dicts of
    ``P``), in either package."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + [k])
            else:
                out["/".join(prefix + [k])] = (tuple(v.shape), tuple(v.axes),
                                               v.init, v.scale)

    walk(spec, [])
    return out


def check_specs_and_weights(jm, pm, w):
    """The same parameter specs, and every leaf converts exactly."""
    assert flat_specs(pm.param_specs()) == flat_specs(jm.param_specs())
    params = convert.params_from_reference(w, device="cpu")
    back = jax.tree_util.tree_flatten_with_path(
        convert.params_to_numpy(params))[0]
    want = jax.tree_util.tree_flatten_with_path(w)[0]
    assert [p for p, _ in back] == [p for p, _ in want]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(back, want))


def check_prefill(jm, pm, w, batch):
    """``make_prefill_step`` of both on ``batch`` (numpy): logits within
    ``TOL``; the port's training forward gives the same logits."""
    want = jax_make_prefill_step(jm)(w, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    params = convert.params_from_reference(w, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = make_prefill_step(pm)(params, tbatch)
    B, S = batch["tokens"].shape
    assert got.dtype == torch.float32 and got.shape == (B, S, pm.cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with torch.no_grad():
        train, _ = pm.forward(params, tbatch["tokens"], tbatch, train=True)
    np.testing.assert_allclose(train.numpy(), np.asarray(want), **TOL)


def check_decode_steps(jm, pm, w, tokens, max_seq):
    """One-token serve steps of both over ``tokens`` (B, n) from fresh
    caches of ``max_seq``: logits within ``TOL`` at every step."""
    step = jax.jit(jax_make_serve_step(jm))
    jcache = jm.init_cache(tokens.shape[0], max_seq)
    params = convert.params_from_reference(w, device="cpu")
    pstep = make_serve_step(pm)
    pcache = pm.init_cache(tokens.shape[0], max_seq)
    for s in range(tokens.shape[1]):
        want, jcache = step(w, jcache, jnp.asarray(tokens[:, s:s + 1]))
        got, pcache = pstep(params, pcache,
                            torch.from_numpy(tokens[:, s:s + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {s}")
    return pcache, jcache


def check_engine(jm, pm, w, prompts, slots, max_seq, new_tokens):
    """Both ``ServingEngine``s on the same prompts: the same steps and the
    same greedy tokens."""
    jeng = JaxServingEngine(jm, w, JaxServeConfig(
        batch_slots=slots, max_seq=max_seq, max_new_tokens=new_tokens))
    peng = ServingEngine(pm, convert.params_from_reference(w, device="cpu"),
                         ServeConfig(batch_slots=slots, max_seq=max_seq,
                                     max_new_tokens=new_tokens))
    want = jeng.run(prompts)
    got = peng.run(prompts)
    assert peng.steps == jeng.steps
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done and len(r.out_tokens) == new_tokens for r in got)
    return peng


def check_train_loss(jm, pm, w, batch, grad_tol=GRAD_TOL, ref_nan=()):
    """``train_loss`` of both on ``batch`` (numpy): loss and metrics within
    ``TOL``, each gradient leaf finite on both sides and against
    ``jax.grad`` within ``grad_tol``.  ``ref_nan`` names the leaves (key
    paths) where the reference's gradient holds a NaN, a fault of the
    reference the port repairs (ROADMAP Queue C): there the reference's
    must hold one and the port's must be finite."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.train_loss(p, jbatch), has_aux=True))(w)
    params = convert.params_from_reference(w, device="cpu")
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    p_loss, p_metrics = pm.train_loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    p_grads = tree_unflatten(params, list(torch.autograd.grad(p_loss,
                                                              leaves)))
    assert set(p_metrics) == set(metrics) == {"loss", "xent"}
    for key in metrics:
        np.testing.assert_allclose(float(p_metrics[key].detach()),
                                   float(metrics[key]), **TOL)
    ref, port = ({jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf
                  in jax.tree_util.tree_flatten_with_path(tree)[0]}
                 for tree in (grads, convert.params_to_numpy(p_grads)))
    assert set(port) == set(ref)
    nan = {k for k, v in ref.items() if not np.isfinite(v).all()}
    assert nan == set(ref_nan), f"reference gradients not finite: {nan}"
    for name, leaf in port.items():
        assert np.isfinite(leaf).all(), f"port gradient {name} not finite"
        if name not in nan:
            np.testing.assert_allclose(leaf, ref[name], **grad_tol,
                                       err_msg=name)


def token_batch(vocab, B, S, seed, mask=True):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32)}
    if mask:
        batch["loss_mask"] = (rng.random((B, S)) > 0.2).astype(np.float32)
    return batch


def prompts(vocab, n, seed, lo=4, hi=10):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(k)).astype(np.int32)
            for k in rng.integers(lo, hi, n)]
