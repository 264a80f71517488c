"""The four configs that chip phases L-O serve (Qwen3-14B, Yi-34B,
StableLM-2-1.6B, InternVL2-2B) against ``repro`` on the CPU, each at its
narrow twin (``tests/_torch_cells.py``: its family and query heads per kv
head, G = 5, 7, 1 and 2, at 2 layers and d_model 128).

Both packages run the same weights: the reference's random tree converted
leaf by leaf (``convert.params_from_reference``).  Prefill logits (with
InternVL2's patch embeddings), decode-step logits from an empty cache, and
decode steps at a nearly full cache (the same seeded K and V on both
sides, ``pos`` three short of its end, so the last step reads every key,
as the chip's decode_32k cell does) agree within the serve-parity
tolerance, 2e-4.  Phase 6's check one kv group at a time
(``chip_smoke.grouped_reference``) equals the whole plain version."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_cells import NARROW, narrow
from repro.configs.base import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.train.step import make_prefill_step as jax_make_prefill_step
from repro.train.step import make_serve_step as jax_make_serve_step
from repro_torch import convert
from repro_torch.configs.base import get_arch
from repro_torch.kernels import ref
from repro_torch.models import build_model
from repro_torch.train.step import make_prefill_step, make_serve_step

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = sorted(NARROW)


@pytest.fixture(scope="module")
def models():
    """arch -> (reference model, port model, reference weights as numpy,
    the port's converted weights)."""
    out = {}
    for arch in ARCHS:
        jm = jax_build_model(narrow(jax_get_arch(arch)))
        weights = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        out[arch] = (jm, build_model(narrow(get_arch(arch)), device="cpu"),
                     weights, convert.params_from_reference(weights,
                                                            device="cpu"))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_narrow_twin_keeps_the_configs_head_layout(arch):
    full, cfg = get_arch(arch), narrow(get_arch(arch))
    assert cfg.family == full.family and cfg.qk_norm == full.qk_norm
    assert cfg.rope_theta == full.rope_theta and cfg.n_layers == 2
    assert (cfg.n_heads // cfg.n_kv_heads
            == full.n_heads // full.n_kv_heads)
    assert full.n_heads * full.resolved_head_dim == full.d_model
    # d_model / heads kept where it is one of the kernels' head dims
    assert (cfg.n_heads * cfg.resolved_head_dim == cfg.d_model
            or cfg.head_dim == 16)
    assert bool(cfg.n_patches) == bool(full.n_patches)
    assert dataclasses.asdict(narrow(jax_get_arch(arch))) == \
        dataclasses.asdict(cfg)


def _batch(model, rng, B, S):
    batch = {"tokens": rng.integers(0, 512, (B, S)).astype(np.int32)}
    if model.cfg.n_patches:
        batch["patch_embeds"] = (0.02 * rng.standard_normal(
            (B, model.cfg.n_patches, model.cfg.d_model))).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match(models, arch):
    jm, pm, weights, params = models[arch]
    batch = _batch(pm, np.random.default_rng(1), 2, 24)
    want = jax_make_prefill_step(jm)(weights, {k: jnp.asarray(v) for k, v
                                               in batch.items()})
    got = make_prefill_step(pm)(params, {k: torch.from_numpy(v) for k, v
                                         in batch.items()})
    assert got.dtype == torch.float32 and got.shape == (2, 24, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _steps(jm, pm, weights, params, jcache, pcache, tokens):
    step, pstep = jax.jit(jax_make_serve_step(jm)), make_serve_step(pm)
    for s in range(tokens.shape[1]):
        want, jcache = step(weights, jcache, jnp.asarray(tokens[:, s:s + 1]))
        got, pcache = pstep(params, pcache,
                            torch.from_numpy(tokens[:, s:s + 1]))
        assert got.shape == (tokens.shape[0], 1, 512)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {s}")
    return jcache, pcache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match(models, arch):
    """Six one-token steps of three slots from an empty 16-token cache."""
    jm, pm, weights, params = models[arch]
    tokens = np.random.default_rng(2).integers(0, 512, (3, 6)).astype(
        np.int32)
    jcache, pcache = _steps(jm, pm, weights, params, jm.init_cache(3, 16),
                            pm.init_cache(3, 16), tokens)
    assert pcache["pos"] == int(jcache["pos"][0]) == 6


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_at_a_nearly_full_cache_matches(models, arch):
    """decode_32k's cell in small: a 40-token cache whose K and V are drawn
    from one seed on both sides and whose pos starts 3 short of its end;
    the last of 3 steps reads all 40 keys."""
    jm, pm, weights, params = models[arch]
    T, steps, B = 40, 3, 2
    c = pm.cfg
    rng = np.random.default_rng(3)
    kv = {name: rng.standard_normal((c.n_layers, B, T, c.n_kv_heads,
                                     c.resolved_head_dim)).astype(np.float32)
          for name in ("k", "v")}
    jcache = {**{k: jnp.asarray(v) for k, v in kv.items()},
              "pos": jnp.full((c.n_layers,), T - steps, jnp.int32)}
    assert jax.tree.map(lambda a: (a.shape, a.dtype), jcache) == jax.tree.map(
        lambda a: (a.shape, a.dtype), jm.init_cache(B, T))
    pcache = {**{k: torch.from_numpy(v.copy()) for k, v in kv.items()},
              "pos": T - steps}
    tokens = rng.integers(0, 512, (B, steps)).astype(np.int32)
    jcache, pcache = _steps(jm, pm, weights, params, jcache, pcache, tokens)
    assert pcache["pos"] == int(jcache["pos"][0]) == T
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL)


@pytest.mark.parametrize("B,H,K,S,D,causal,window", [
    (1, 8, 2, 33, 16, True, 0), (2, 14, 2, 40, 16, True, 0),
    (1, 10, 2, 24, 16, False, 0), (2, 4, 4, 30, 32, True, 0),
    (1, 4, 2, 50, 32, True, 16)])
def test_check_one_kv_group_at_a_time_equals_the_whole_plain_version(
        B, H, K, S, D, causal, window):
    """Phase 6 holds each 32k attention output one kv group at a time: the
    groups' plain outputs, side by side, are the whole plain version's."""
    gen = torch.Generator().manual_seed(4)
    q = torch.randn((B, H, S, D), generator=gen)
    k, v = (torch.randn((B, K, S, D), generator=gen) for _ in "kv")
    groups = list(chip_smoke.grouped_reference(q, k, v, range(K),
                                               causal=causal, window=window))
    assert [g for g, _ in groups] == list(range(K))
    whole = ref.mha_reference(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(torch.cat([o for _, o in groups], dim=1),
                               whole, rtol=1e-6, atol=1e-6)
    last = dict(chip_smoke.grouped_reference(q, k, v, [K - 1],
                                             causal=causal, window=window))
    G = H // K
    torch.testing.assert_close(last[K - 1], whole[:, (K - 1) * G:],
                               rtol=1e-6, atol=1e-6)
