"""The port's Whisper (``models/whisper.py``) against ``repro`` on the CPU,
at ``get_arch("whisper_tiny").smoke_config()`` (f32, 2 encoder and 2
decoder layers, d=64, 4 heads of 16, 24 frames): parameter specs with the
biased projections, prefill logits (encoder, causal decoder and
cross-attention), decode steps (unrotated self-attention, sinusoidal step
positions, cross-attention over the zero cross cache), the engine's greedy
tokens, and ``train_loss`` with every gradient leaf against ``jax.grad``;
and which attention each path dispatches to.  The layers the family adds
(LayerNorm, sinusoidal positions, the GELU MLP, the output head) are held
against ``repro.models.layers`` one by one.  Tolerances and helpers:
``tests/_torch_family.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_family as fam
from repro.models import layers as jax_layers
from repro_torch.kernels import ops
from repro_torch.models import layers

ARCH = "whisper_tiny"


@pytest.fixture(scope="module")
def pair():
    jm, pm = fam.models(ARCH)
    return jm, pm, fam.weights(jm)


def _batch(pm, B, S, seed):
    rng = np.random.default_rng(seed)
    c = pm.cfg
    return {"tokens": rng.integers(0, c.vocab, (B, S)).astype(np.int32),
            "frames": (0.02 * rng.standard_normal(
                (B, c.enc_frames, c.d_model))).astype(np.float32)}


def test_smoke_config_and_specs(pair):
    jm, pm, w = pair
    c = pm.cfg
    assert (c.family, c.n_layers, c.enc_layers, c.d_model, c.n_heads,
            c.n_kv_heads, c.enc_frames, c.dtype) == ("audio", 2, 2, 64, 4, 4,
                                                     24, "float32")
    attn = pm.param_specs()["dec_blocks"]["cross_attn"]
    assert {"bq", "bv", "bo"} <= set(attn) and "bk" not in attn
    fam.check_specs_and_weights(jm, pm, w)


@pytest.mark.parametrize("S", [10, 40])
def test_prefill_logits_match(pair, S):
    """S decoder tokens against 24 frames: fewer and more queries than
    keys in cross-attention."""
    jm, pm, w = pair
    # Biases of zero would hide a bias left out: give each a value.
    rng = np.random.default_rng(S)
    w = fam.jax.tree_util.tree_map_with_path(
        lambda p, a: (a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
                      if p[-1].key in ("bq", "bv", "bo", "b_in", "b_out",
                                       "bias") else a), w)
    fam.check_prefill(jm, pm, w, _batch(pm, 2, S, seed=S))


def test_decode_steps_match(pair):
    """20 steps over a 12-token linear cache: past its end the writes clamp
    to the last slot, while the sinusoidal position keeps counting."""
    jm, pm, w = pair
    tokens = fam.token_batch(512, 3, 20, seed=2, mask=False)["tokens"]
    pcache, jcache = fam.check_decode_steps(jm, pm, w, tokens, max_seq=12)
    assert pcache["self"]["pos"] == int(jcache["self"]["pos"][0]) == 20
    assert pcache["cross"]["k"].shape == (2, 3, 24, 4, 16)


def test_engine_greedy_tokens_identical(pair):
    jm, pm, w = pair
    fam.check_engine(jm, pm, w, fam.prompts(512, 10, seed=3), slots=4,
                     max_seq=32, new_tokens=6)


@pytest.mark.parametrize("remat,S", [
    pytest.param(False, 32, id="False"), pytest.param(True, 32, id="True"),
    pytest.param(True, 2080, id="True-2080")])
def test_train_loss_and_every_gradient_match(remat, S):
    """S = 2080 is the length of the chip's f32 training check: the
    decoder's causal self-attention goes chunked past
    ``DENSE_ATTN_MAX_SEQ``; cross-attention stays dense over the
    frames."""
    jm, pm = fam.models(ARCH, remat=remat)
    fam.check_train_loss(jm, pm, fam.weights(jm), _batch(pm, 2, S, seed=4))


def test_each_path_dispatches_to_its_attention(pair, monkeypatch):
    """Prefill: the encoder's non-causal attention, then per decoder layer
    causal self-attention and non-causal cross-attention, all through the
    flash-attention entry point (2 + 2 x 2 calls); each decode step two
    flash-decode calls a layer, the cross one over all 24 frames; the
    train path neither."""
    _, pm, w = pair
    calls = []
    fa, fd = ops.flash_attention, ops.flash_decode

    def flash_attention(q, k, v, **kw):
        calls.append(("flash_attention", kw["causal"], q.shape[2],
                      k.shape[2]))
        return fa(q, k, v, **kw)

    def flash_decode(q, k, v, lengths):
        calls.append(("flash_decode", k.shape[2], int(lengths[0])))
        return fd(q, k, v, lengths)

    monkeypatch.setattr(ops, "flash_attention", flash_attention)
    monkeypatch.setattr(ops, "flash_decode", flash_decode)
    params = fam.convert.params_from_reference(w, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(pm, 2, 10, 5).items()}
    with torch.no_grad():
        pm.forward(params, batch["tokens"], batch)
        assert calls == [("flash_attention", False, 24, 24)] * 2 + [
            ("flash_attention", True, 10, 10),
            ("flash_attention", False, 10, 24)] * 2
        calls.clear()
        pm.decode_step(params, pm.init_cache(2, 32), batch["tokens"][:, :1])
        assert calls == [("flash_decode", 32, 1),
                         ("flash_decode", 24, 24)] * 2
        calls.clear()
    pm.train_loss(params, batch)
    assert calls == []


@pytest.mark.parametrize("name", ["layernorm", "sinusoidal_positions",
                                  "gelu_mlp", "output_head"])
def test_layers_match_reference(name):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    if name == "layernorm":
        args = ({"scale": rng.standard_normal(16).astype(np.float32),
                 "bias": rng.standard_normal(16).astype(np.float32)}, x)
    elif name == "sinusoidal_positions":
        args = (1500, 384)
    elif name == "gelu_mlp":
        args = ({k: rng.standard_normal(s).astype(np.float32) for k, s in
                 (("w_in", (16, 24)), ("b_in", (24,)), ("w_out", (24, 16)),
                  ("b_out", (16,)))}, x)
    else:
        args = ({"w_out": rng.standard_normal((16, 40)).astype(np.float32)},
                x)

    def to(fn, a):
        if isinstance(a, dict):
            return {k: fn(v) for k, v in a.items()}
        return fn(a) if isinstance(a, np.ndarray) else a

    want = getattr(jax_layers, name)(*(to(jnp.asarray, a) for a in args))
    got = getattr(layers, name)(*(to(torch.from_numpy, a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
