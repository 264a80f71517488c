"""The port's ``models/ssm.py`` (Mamba's selective scan, mLSTM, sLSTM) on
the CPU: every case of ``tests/test_ssm.py`` on the port's functions at
that file's tolerances, and each ``*_apply`` against ``repro.models.ssm``
on the same inputs and converted weights, in f32 and bf16, with a fresh
and a carried state.

Inputs come from numpy seeds.  f32 parity holds within
``tests/test_torch_train_parity.py``'s 2e-4; bf16 parity within the
reference's bf16 kernel tolerance, 2e-2 (``tests/test_kernels.py``): both
packages round the same values to bf16, but an f32 sum that lands on the
other side of a rounding boundary moves a bf16 output by one ulp, 2**-7
of its value (Mamba's output of about 1.4 moves by 0.0078)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jax_ssm
from repro.models.params import init_params as jax_init_params
from repro_torch import convert
from repro_torch.models import ssm
from repro_torch.models.params import init_params

TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _params(spec, seed=0):
    return init_params(spec, torch.Generator().manual_seed(seed),
                       torch.float32, device="cpu")


def _x(seed, shape, scale=0.5):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((scale * rng.standard_normal(shape))
                            .astype(np.float32))


# ---- tests/test_ssm.py's cases on the port -------------------------------

def test_ssm_scan_chunked_matches_naive():
    rng = np.random.default_rng(0)
    B, S, D, N = 2, 100, 8, 4
    da = 1 / (1 + np.exp(-rng.standard_normal((B, S, D, N))))
    dbx = 0.1 * rng.standard_normal((B, S, D, N))
    h_seq, h_last = ssm._ssm_scan_chunked(
        torch.from_numpy(da.astype(np.float32)),
        torch.from_numpy(dbx.astype(np.float32)), torch.zeros(B, D, N),
        chunk=16)
    h = np.zeros((B, D, N))
    hs = []
    for t in range(S):
        h = da[:, t].astype(np.float32) * h + dbx[:, t].astype(np.float32)
        hs.append(h.copy())
    np.testing.assert_allclose(h_seq.numpy(), np.stack(hs, 1), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(h_last.numpy(), h, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("S", [17, 64])
def test_mamba_train_equals_decode(S):
    d, d_inner, state = 16, 32, 4
    params = _params(ssm.mamba_spec(d, d_inner, state))
    x = _x(2, (2, S, d))
    full, _ = ssm.mamba_apply(params, x)
    st = ssm.mamba_init_state(2, d_inner, state, dtype=torch.float32,
                              device="cpu")
    outs = []
    for t in range(S):
        o, st = ssm.mamba_apply(params, x[:, t:t + 1], st)
        outs.append(o)
    np.testing.assert_allclose(full.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("S,chunk", [(33, 8), (64, 16)])
def test_mlstm_train_equals_decode(S, chunk):
    d, H, Dh = 16, 2, 8
    params = _params(ssm.mlstm_spec(d, H, Dh))
    x = _x(3, (2, S, d))
    full, _ = ssm.mlstm_apply(params, x, chunk=chunk)
    st = ssm.mlstm_init_state(2, H, Dh, device="cpu")
    outs = []
    for t in range(S):
        o, st = ssm.mlstm_apply(params, x[:, t:t + 1], st, chunk=1)
        outs.append(o)
    np.testing.assert_allclose(full.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=5e-3, atol=5e-4)


def test_mlstm_chunk_size_invariance():
    d, H, Dh = 16, 2, 8
    params = _params(ssm.mlstm_spec(d, H, Dh))
    x = _x(4, (1, 48, d))
    a, _ = ssm.mlstm_apply(params, x, chunk=48)
    b, _ = ssm.mlstm_apply(params, x, chunk=8)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3, atol=5e-4)


def test_slstm_train_equals_decode():
    d, H = 16, 4
    params = _params(ssm.slstm_spec(d, H))
    x = _x(5, (2, 20, d))
    full, _ = ssm.slstm_apply(params, x)
    st = ssm.slstm_init_state(2, d, device="cpu")
    outs = []
    for t in range(20):
        o, st = ssm.slstm_apply(params, x[:, t:t + 1], st)
        outs.append(o)
    np.testing.assert_allclose(full.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_mamba_states_finite_long_seq():
    d, d_inner, state = 8, 16, 4
    params = _params(ssm.mamba_spec(d, d_inner, state))
    out, st = ssm.mamba_apply(params, _x(6, (1, 512, d), 1.0))
    assert torch.isfinite(out).all() and torch.isfinite(st["h"]).all()


# ---- against repro.models.ssm --------------------------------------------

def test_associative_scan_is_the_references_tree():
    """The within-chunk scan takes jax.lax.associative_scan's tree of
    combines, so in f32 it matches the reference's scan over odd and even
    lengths, including the chunk's 256."""
    rng = np.random.default_rng(7)
    for n in (1, 2, 5, 37, 256):
        a = (1 / (1 + np.exp(-rng.standard_normal((2, n, 3, 4))))).astype(
            np.float32)
        b = (0.1 * rng.standard_normal((2, n, 3, 4))).astype(np.float32)
        want = jax.lax.associative_scan(
            lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]),
            (jnp.asarray(a), jnp.asarray(b)), axis=1)
        got = ssm._associative_scan((torch.from_numpy(a),
                                     torch.from_numpy(b)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7, err_msg=f"n={n}")


CELLS = {
    "mamba": (lambda: jax_ssm.mamba_spec(16, 32, 4), jax_ssm.mamba_apply,
              ssm.mamba_apply),
    "mlstm": (lambda: jax_ssm.mlstm_spec(16, 2, 8), jax_ssm.mlstm_apply,
              ssm.mlstm_apply),
    "slstm": (lambda: jax_ssm.slstm_spec(16, 4), jax_ssm.slstm_apply,
              ssm.slstm_apply),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_matches_reference(cell, dtype):
    """Each cell on converted weights: a 300-step sequence (two Mamba and
    mLSTM chunks), then the same sequence again from the carried state,
    then one decode step from it; outputs and every state leaf."""
    spec, jax_apply, apply = CELLS[cell]
    weights = jax.tree.map(np.asarray, jax_init_params(
        spec(), jax.random.PRNGKey(1), JAX_DTYPE[dtype]))
    params = convert.params_from_reference(weights, device="cpu")
    x = _x(8, (2, 300, 16)).numpy()
    jx = jnp.asarray(x, JAX_DTYPE[dtype])
    tx = torch.from_numpy(x).to(dtype)
    jstate = state = None
    for step, sl in enumerate((slice(None), slice(None), slice(0, 1))):
        want, jstate = jax_apply(weights, jx[:, sl], jstate)
        got, state = apply(params, tx[:, sl], state)
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   **TOL[dtype], err_msg=f"call {step}")
        assert set(state) == set(jstate)
        for k in state:
            assert state[k].dtype == {jnp.float32: torch.float32,
                                      jnp.bfloat16: torch.bfloat16}[
                jnp.dtype(jstate[k].dtype).type]
            np.testing.assert_allclose(
                state[k].float().numpy(), np.asarray(jstate[k], np.float32),
                **TOL[dtype], err_msg=f"call {step} state {k}")


def test_mamba_rounds_scan_elements_to_bf16_in_f32():
    """In an f32 model the scan elements are bf16 all the same (the
    reference's rounding): the per-step states differ from an all-f32 scan
    by bf16 rounding, and the output matches the reference's."""
    spec = jax_ssm.mamba_spec(16, 32, 4)
    weights = jax.tree.map(np.asarray, jax_init_params(
        spec, jax.random.PRNGKey(2), jnp.float32))
    params = convert.params_from_reference(weights, device="cpu")
    x = _x(9, (1, 64, 16)).numpy()
    want, _ = jax_ssm.mamba_apply(weights, jnp.asarray(x))
    got, _ = ssm.mamba_apply(params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL[torch.float32])
    da = torch.rand(1, 64, 4, 2)
    dbx = torch.randn(1, 64, 4, 2)
    h_bf16, _ = ssm._ssm_scan_chunked(da.bfloat16(), dbx.bfloat16(),
                                      torch.zeros(1, 4, 2))
    h_f32, _ = ssm._ssm_scan_chunked(da, dbx, torch.zeros(1, 4, 2))
    assert h_bf16.dtype == torch.bfloat16 and h_f32.dtype == torch.float32
    assert not torch.equal(h_bf16.float(), h_f32)
