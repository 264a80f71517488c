"""The port's xLSTM (``models/xlstm.py``) against ``repro`` on the CPU, at
``get_arch("xlstm_350m").smoke_config()`` (f32, 2 layers = 1 (mLSTM,
sLSTM) pair, d=64, 4 heads of 16; the cells carry their own projections): parameter specs, prefill logits over
one and over two mLSTM chunks, decode steps with their carried states,
the engine's greedy tokens, and ``train_loss`` with every gradient leaf
against ``jax.grad``; and that no path reaches a kernel.  Tolerances and
helpers: ``tests/_torch_family.py``."""

import numpy as np
import pytest
import torch

import _torch_family as fam
from repro_torch.kernels import ops

ARCH = "xlstm_350m"


@pytest.fixture(scope="module")
def pair():
    jm, pm = fam.models(ARCH)
    return jm, pm, fam.weights(jm)


def test_smoke_config_and_specs(pair):
    jm, pm, w = pair
    c = pm.cfg
    assert (c.family, c.n_layers, c.d_model, c.n_heads,
            c.resolved_head_dim, c.dtype) == ("ssm", 2, 64, 4, 16, "float32")
    assert pm.n_pairs == 1                # d_ff sizes nothing: no MLP
    fam.check_specs_and_weights(jm, pm, w)


@pytest.mark.parametrize("S", [24, 300])
def test_prefill_logits_match(pair, S):
    """S = 300 runs two 256-step mLSTM chunks, the second padded."""
    jm, pm, w = pair
    fam.check_prefill(jm, pm, w, {"tokens": fam.token_batch(
        512, 2, S, seed=S, mask=False)["tokens"]})


def test_decode_steps_match(pair):
    jm, pm, w = pair
    tokens = fam.token_batch(512, 3, 20, seed=2, mask=False)["tokens"]
    pcache, jcache = fam.check_decode_steps(jm, pm, w, tokens, max_seq=32)
    for cell in ("mlstm", "slstm"):
        assert set(pcache[cell]) == set(jcache[cell])
        for k, v in pcache[cell].items():
            assert v.dtype == torch.float32
            np.testing.assert_allclose(v.numpy(), np.asarray(jcache[cell][k]),
                                       **fam.TOL, err_msg=f"{cell} {k}")


def test_engine_greedy_tokens_identical(pair):
    jm, pm, w = pair
    fam.check_engine(jm, pm, w, fam.prompts(512, 10, seed=3), slots=4,
                     max_seq=32, new_tokens=6)


# The reference's mLSTM weights its chunk by where(mask, exp(w_log), 0):
# over a whole 256-step chunk the masked exps overflow and its gradient is
# NaN in these leaves (ROADMAP Queue C); the port masks before the exp.
REF_NAN = {"['embed']['embedding']", "['pairs']['ln_m']['scale']",
           "['pairs']['mlstm']['if_bias']", "['pairs']['mlstm']['w_if']"}


@pytest.mark.parametrize("remat,S", [
    pytest.param(False, 32, id="False"), pytest.param(True, 32, id="True"),
    pytest.param(True, 544, id="True-544")])
def test_train_loss_and_every_gradient_match(remat, S):
    """S = 544 is the length of the chip's f32 training check: three
    mLSTM chunks, the last one ragged, and 544 sLSTM steps; there the
    reference's gradient is NaN in ``REF_NAN`` and the port's finite."""
    jm, pm = fam.models(ARCH, remat=remat)
    fam.check_train_loss(jm, pm, fam.weights(jm),
                         fam.token_batch(512, 2, S, seed=4),
                         ref_nan=REF_NAN if S > 256 else ())


def test_mlstm_repair_keeps_every_finite_gradient():
    """With the forget gates held open (a bias of 5: a decay of 0.007 a
    step), the reference's masked exps stay finite over 544 steps, and
    every gradient leaf matches it: masking before the exp changes no
    finite value or gradient."""
    jm, pm = fam.models(ARCH, remat=True)
    w = fam.weights(jm)
    bias = w["pairs"]["mlstm"]["if_bias"].copy()
    bias[:, pm.cfg.n_heads:] = 5.0                 # the forget gates' half
    w["pairs"]["mlstm"]["if_bias"] = bias
    fam.check_train_loss(jm, pm, w, fam.token_batch(512, 2, 544, seed=4))


def test_no_path_reaches_a_kernel(pair, monkeypatch):
    """Prefill, decode and training run plain torch: every kernel entry
    point raises if called."""
    _, pm, w = pair

    def refuse(*a, **kw):
        raise AssertionError("xLSTM reached a kernel")

    for name in ("flash_attention", "flash_decode", "grouped_matmul",
                 "crop_mirror_normalize"):
        monkeypatch.setattr(ops, name, refuse)
    params = fam.convert.params_from_reference(w, device="cpu")
    tokens = torch.from_numpy(fam.token_batch(512, 2, 20, seed=5,
                                              mask=False)["tokens"])
    with torch.no_grad():
        pm.forward(params, tokens)
        pm.decode_step(params, pm.init_cache(2, 32), tokens[:, :1])
    pm.train_loss(params, {"tokens": tokens})
