"""The port's Hymba (``models/hybrid.py``) against ``repro`` on the CPU, at
``get_arch("hymba_1_5b").smoke_config()`` (f32, 2 layers, d=64, 4 query
heads over 2 kv heads, a 16-token window, SSM state 8): parameter specs,
prefill logits below and past the window, decode steps past the window
(the ring cache wraps), the engine's greedy tokens, and ``train_loss``
with every gradient leaf against ``jax.grad``; and which attention each
path dispatches to.  Tolerances and helpers: ``tests/_torch_family.py``."""

import numpy as np
import pytest
import torch

import _torch_family as fam
from repro_torch.kernels import ops

ARCH = "hymba_1_5b"


@pytest.fixture(scope="module")
def pair():
    jm, pm = fam.models(ARCH)
    return jm, pm, fam.weights(jm)


def test_smoke_config_and_specs(pair):
    jm, pm, w = pair
    c = pm.cfg
    assert (c.family, c.n_layers, c.d_model, c.n_heads, c.n_kv_heads,
            c.window, c.ssm_state, c.dtype) == ("hybrid", 2, 64, 4, 2, 16, 8,
                                                "float32")
    fam.check_specs_and_weights(jm, pm, w)


@pytest.mark.parametrize("S", [12, 40])
def test_prefill_logits_match(pair, S):
    """S = 40 is past the 16-token window."""
    jm, pm, w = pair
    fam.check_prefill(jm, pm, w, {"tokens": fam.token_batch(
        512, 2, S, seed=S, mask=False)["tokens"]})


def test_decode_steps_past_the_window_match(pair):
    """24 steps over a ring of min(16, 32) = 16 slots: the last 8 overwrite
    the oldest keys; the Mamba states carry every step."""
    jm, pm, w = pair
    tokens = fam.token_batch(512, 3, 24, seed=2, mask=False)["tokens"]
    pcache, jcache = fam.check_decode_steps(jm, pm, w, tokens, max_seq=32)
    assert pcache["kv"]["pos"] == int(jcache["kv"]["pos"][0]) == 24
    assert pcache["kv"]["k"].shape == (2, 3, 16, 2, 16)
    assert pcache["mamba"]["h"].dtype == torch.float32
    for k in ("h", "conv"):
        np.testing.assert_allclose(pcache["mamba"][k].numpy(),
                                   np.asarray(jcache["mamba"][k]), **fam.TOL)


def test_engine_greedy_tokens_identical(pair):
    """12 prompts through 4 slots of a 32-token cache (a 16-slot ring): the
    shared position passes the window in the first wave."""
    jm, pm, w = pair
    eng = fam.check_engine(jm, pm, w, fam.prompts(512, 12, seed=3), slots=4,
                           max_seq=32, new_tokens=8)
    assert eng.steps > 16


@pytest.mark.parametrize("remat,S", [
    pytest.param(False, 32, id="False"), pytest.param(True, 32, id="True"),
    pytest.param(True, 2080, id="True-2080")])
def test_train_loss_and_every_gradient_match(remat, S):
    """With a loss mask over S tokens (past the window); ``remat`` runs
    each layer under ``torch.utils.checkpoint``.  The Mamba path rounds its
    scan elements to bf16 in this f32 config in both packages, and the
    gradient flows through those casts in bf16 in both.  S = 2080 is the
    length of the chip's f32 training check: past ``DENSE_ATTN_MAX_SEQ``,
    so attention goes chunked with the window, and 9 Mamba chunks, the
    last one ragged."""
    jm, pm = fam.models(ARCH, remat=remat)
    fam.check_train_loss(jm, pm, fam.weights(jm),
                         fam.token_batch(512, 2, S, seed=4))


def test_each_path_dispatches_to_its_attention(pair, monkeypatch):
    """Prefill calls the flash-attention entry point once a layer with the
    window, each decode step the flash-decode one once a layer, and the
    train path neither (on the CPU both run their plain versions)."""
    _, pm, w = pair
    calls = []
    fa, fd = ops.flash_attention, ops.flash_decode

    def flash_attention(*a, **kw):
        calls.append(("flash_attention", kw["causal"], kw["window"]))
        return fa(*a, **kw)

    def flash_decode(*a, **kw):
        calls.append(("flash_decode",))
        return fd(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", flash_attention)
    monkeypatch.setattr(ops, "flash_decode", flash_decode)
    params = fam.convert.params_from_reference(w, device="cpu")
    tokens = torch.from_numpy(fam.token_batch(512, 2, 20, seed=5,
                                              mask=False)["tokens"])
    with torch.no_grad():
        pm.forward(params, tokens)
        assert calls == [("flash_attention", True, 16)] * 2
        calls.clear()
        pm.decode_step(params, pm.init_cache(2, 32), tokens[:, :1])
        assert calls == [("flash_decode",)] * 2
        calls.clear()
    pm.train_loss(params, {"tokens": tokens})
    assert calls == []
