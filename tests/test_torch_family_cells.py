"""The four configs whose reference cells chip phases 13, D, E and F run
(Kimi-K2, Hymba-1.5B, xLSTM-350M, Whisper-tiny) against ``repro`` on the
CPU, each at its narrow twin (``tests/_torch_cells.py``: Kimi-K2 at head
dim 112 with G = 8 and several MoE chunks a row, Hymba at G = 5 with a
window shorter than the prefill, xLSTM as one mLSTM/sLSTM pair, Whisper
with its encoder over 1500 frames).

Both packages run the same weights: the reference's random tree converted
leaf by leaf (``convert.params_from_reference``).  Prefill logits (past
Hymba's window, past Whisper's 448 positions), decode steps from a state
that decode steps reached, Hymba's ring at positions 524,284-524,287 (the
end of long_500k) and Whisper's decoder at positions 32,764-32,767 (the
end of decode_32k) agree within the serve-parity tolerance, 2e-4.  At
those two large positions the port is held against the reference's step
run op by op: the reference's jitted step differs from its own op-by-op
step there by up to 3.6e-4 (``_record``; ROADMAP, "Not port faults")."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_cells import FAMILY_NARROW, narrow_family
from repro.configs.base import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.train.step import make_prefill_step as jax_make_prefill_step
from repro.train.step import make_serve_step as jax_make_serve_step
from repro_torch import convert
from repro_torch.configs.base import get_arch
from repro_torch.models import build_model
from repro_torch.models.moe import n_chunks
from repro_torch.train.step import make_prefill_step, make_serve_step

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = sorted(FAMILY_NARROW)
# Prefill lengths: Kimi-K2 four 512-token MoE chunks, Hymba past its
# 32-token window, xLSTM past one 256-step mLSTM chunk, Whisper past its
# 448 positions.
PREFILL_S = {"kimi_k2_1t_a32b": 2048, "hymba_1_5b": 80, "xlstm_350m": 300,
             "whisper_tiny": 480}


@pytest.fixture(scope="module")
def models():
    """arch -> (reference model, port model, reference weights as numpy,
    the port's converted weights)."""
    out = {}
    for arch in ARCHS:
        jm = jax_build_model(narrow_family(jax_get_arch(arch)))
        weights = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        out[arch] = (jm, build_model(narrow_family(get_arch(arch)),
                                     device="cpu"),
                     weights, convert.params_from_reference(weights,
                                                            device="cpu"))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_narrow_twin_keeps_the_familys_layout(arch):
    full, cfg = get_arch(arch), narrow_family(get_arch(arch))
    assert cfg.family == full.family and cfg.n_layers == 2
    assert (cfg.n_heads // cfg.n_kv_heads
            == full.n_heads // full.n_kv_heads)
    assert dataclasses.asdict(narrow_family(jax_get_arch(arch))) == \
        dataclasses.asdict(cfg)
    if arch == "kimi_k2_1t_a32b":
        assert (cfg.resolved_head_dim, cfg.top_k) == (112, full.top_k)
        assert n_chunks(PREFILL_S[arch]) == 4
    if arch == "hymba_1_5b":
        assert 0 < cfg.window < PREFILL_S[arch] and cfg.ssm_state == 16
    if arch == "whisper_tiny":
        assert cfg.enc_frames == full.enc_frames == 1500
        assert PREFILL_S[arch] > 448


def _batch(model, rng, B, S):
    batch = {"tokens": rng.integers(0, 512, (B, S)).astype(np.int32)}
    if model.cfg.family == "audio":
        batch["frames"] = (0.02 * rng.standard_normal(
            (B, model.cfg.enc_frames, model.cfg.d_model))).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match(models, arch):
    jm, pm, weights, params = models[arch]
    S = PREFILL_S[arch]
    batch = _batch(pm, np.random.default_rng(1), 1, S)
    want = jax_make_prefill_step(jm)(weights, {k: jnp.asarray(v) for k, v
                                               in batch.items()})
    got = make_prefill_step(pm)(params, {k: torch.from_numpy(v) for k, v
                                         in batch.items()})
    assert got.dtype == torch.float32 and got.shape == (1, S, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _steps(jm, pm, weights, params, jcache, pcache, tokens, gap=None):
    """One-token serve steps of both over ``tokens`` (B, n), logits within
    ``TOL`` at every step.  With ``gap`` (a list), the reference's step
    runs op by op (``jax.disable_jit``) and, beside it, jitted from the
    same cache; each step's largest difference between the two goes into
    ``gap``."""
    step, pstep = jax.jit(jax_make_serve_step(jm)), make_serve_step(pm)
    for s in range(tokens.shape[1]):
        tok = jnp.asarray(tokens[:, s:s + 1])
        if gap is None:
            want, jcache = step(weights, jcache, tok)
        else:
            jitted, _ = step(weights, jcache, tok)
            with jax.disable_jit():
                want, jcache = jax_make_serve_step(jm)(weights, jcache, tok)
            gap.append(float(np.abs(np.asarray(jitted)
                                    - np.asarray(want)).max()))
        got, pcache = pstep(params, pcache,
                            torch.from_numpy(tokens[:, s:s + 1]))
        assert got.shape == (tokens.shape[0], 1, 512)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {s}")
    return jcache, pcache


def _set_kv(jcache, pcache, rng, pos):
    """The same seeded K and V in every K/V cache of both caches (a dense
    cache, Hymba's ring, Whisper's self and cross caches) and each
    position at ``pos``; returns both caches."""
    for holder in chip_smoke.kv_caches(pcache):
        for name in ("k", "v"):
            holder[name].copy_(torch.from_numpy(rng.standard_normal(
                tuple(holder[name].shape)).astype(np.float32)))

    def kv_paths(tree, path=()):
        if isinstance(tree, dict):
            if "k" in tree and "v" in tree:
                yield path
            for k, v in tree.items():
                yield from kv_paths(v, path + (k,))

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    jcache = jax.tree.map(lambda a: a, jcache)
    for path in kv_paths(pcache):
        src, dst = at(pcache, path), at(jcache, path)
        for name in ("k", "v"):
            dst[name] = jnp.asarray(src[name].numpy())
        if "pos" in src:
            src["pos"] = pos
            dst["pos"] = jnp.full(dst["pos"].shape, pos, jnp.int32)
    return jcache, pcache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_from_a_state_reached_by_decode_steps_match(models,
                                                                 arch):
    """Four one-token steps of two slots after eight from an empty
    64-token cache (Hymba's 32-slot ring, its Mamba state and xLSTM's
    states as the model made them), each step's logits held."""
    jm, pm, weights, params = models[arch]
    tokens = np.random.default_rng(2).integers(0, 512, (2, 12)).astype(
        np.int32)
    jcache, pcache = _steps(jm, pm, weights, params, jm.init_cache(2, 64),
                            pm.init_cache(2, 64), tokens)
    assert chip_smoke.cache_positions(pcache) in ([], [12])


def test_kimi_decode_at_a_nearly_full_cache_matches(models):
    """decode_32k's cell in small at Kimi-K2's layout (G = 8, D = 112, its
    MoE on one token a slot): a 40-token cache whose K and V are drawn
    from one seed on both sides and whose pos starts 3 short of its end;
    the last of 3 steps reads all 40 keys."""
    jm, pm, weights, params = models["kimi_k2_1t_a32b"]
    rng = np.random.default_rng(3)
    jcache, pcache = _set_kv(jm.init_cache(2, 40), pm.init_cache(2, 40),
                             rng, 40 - 3)
    tokens = rng.integers(0, 512, (2, 3)).astype(np.int32)
    jcache, pcache = _steps(jm, pm, weights, params, jcache, pcache, tokens)
    assert pcache["pos"] == int(jcache["pos"][0]) == 40


def test_hymba_ring_at_the_end_of_long_500k_matches(models):
    """long_500k's last steps at Hymba's layout: a cache for 524,288
    tokens (a ring of its 32-token window), its Mamba state brought by six
    steps, then the same seeded K and V on both sides and the position at
    524,284; steps at positions 524,284-524,287 write ring slots 28-31
    (``cache_slot``) and rotate q and k by RoPE angles near 5.2e5 rad.
    The reference's step runs op by op there (``_record``)."""
    jm, pm, weights, params = models["hymba_1_5b"]
    seq = chip_smoke.LONG_500K
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 512, (1, 10)).astype(np.int32)
    jcache, pcache = _steps(jm, pm, weights, params, jm.init_cache(1, seq),
                            pm.init_cache(1, seq), tokens[:, :6])
    assert pcache["kv"]["k"].shape[2] == 32
    jcache, pcache = _set_kv(jcache, pcache, rng, seq - 4)
    gap = []
    jcache, pcache = _steps(jm, pm, weights, params, jcache, pcache,
                            tokens[:, 6:], gap)
    _record(gap)
    assert pcache["kv"]["pos"] == int(jcache["kv"]["pos"][0]) == seq
    for name in ("k", "v"):
        np.testing.assert_allclose(pcache["kv"][name].numpy(),
                                   np.asarray(jcache["kv"][name]), **TOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(pcache["mamba"][name].numpy(),
                                   np.asarray(jcache["mamba"][name]), **TOL)


def test_whisper_decoder_near_32767_matches(models):
    """decode_32k's last steps at Whisper's layout: a 32,768-token self
    cache and the 1500-frame cross cache, the same seeded K and V on both
    sides and the position at 32,764; each step adds the sinusoidal
    position of 32,764-32,767 (its angles computed on each side, whose
    powers of 10000 may differ by an ulp: some 6e-5 rad of an angle
    there).  The reference's step runs op by op there (``_record``)."""
    jm, pm, weights, params = models["whisper_tiny"]
    seq = chip_smoke.SEQ_32K
    rng = np.random.default_rng(6)
    jcache, pcache = _set_kv(jm.init_cache(1, seq), pm.init_cache(1, seq),
                             rng, seq - 4)
    tokens = rng.integers(0, 512, (1, 4)).astype(np.int32)
    gap = []
    jcache, pcache = _steps(jm, pm, weights, params, jcache, pcache, tokens,
                            gap)
    _record(gap)
    assert pcache["self"]["pos"] == int(jcache["self"]["pos"][0]) == seq


def _record(gap):
    """The reference's own gap at a large position, between its jitted
    step and the same step op by op (ROADMAP, "Not port faults"): XLA
    fuses the f32 position angles (RoPE's ``positions * freqs``, Whisper's
    ``pos / 10000**(2i/d)``), whose rounding at 5.2e5 or 3.3e4 is some
    1e-2 or 1e-3 rad, and rounds them otherwise than the ops one by one,
    which the port computes as the reference's op-by-op step does (held
    above within ``TOL``).  1.1e-4 to 3.6e-4 of the logits at these
    twins; recorded under 1e-3, the end-to-end f32 bound."""
    print(f"reference, jitted vs op by op, each step: {gap}")
    assert len(gap) == 4 and max(gap) < 1e-3
