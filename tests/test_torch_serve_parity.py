"""The port's serving path against ``repro`` on the CPU: the dense, MoE
and VLM families, and the other three families' build and prefill (their
own parity files hold the rest).

Both packages run ``get_arch("qwen3_4b").smoke_config()`` (f32, 2 layers,
d=64, H=4, K=2, Dh=16, qk_norm) on the same weights: the reference's
random tree, converted leaf by leaf with ``convert.params_from_reference``
(the two packages' init RNGs differ, so parity never goes through seeds).
``forward`` and ``decode_step`` logits agree within 2e-4, including decode
steps past the end of a linear cache (the reference's write clamps to the
last slot) and a ring cache; ``ServingEngine`` gives identical greedy
tokens.  Grok-1's smoke config (4 experts, top-2) is held the same way,
with the MoE metrics of the forward; InternVL2-2B's smoke config runs its
forward with patch embeddings through ``make_prefill_step``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServingEngine as JaxServingEngine
from repro.train.step import make_prefill_step as jax_make_prefill_step
from repro.train.step import make_serve_step as jax_make_serve_step
from repro_torch import convert
from repro_torch.configs.base import get_arch
from repro_torch.models import build_model, layers
from repro_torch.models.params import P, init_params, stack_layer_specs
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.train.step import make_prefill_step, make_serve_step

TOL = dict(rtol=2e-4, atol=2e-4)


def _cfgs(**kw):
    return (jax_get_arch("qwen3_4b").smoke_config().scaled(**kw),
            get_arch("qwen3_4b").smoke_config().scaled(**kw))


@pytest.fixture(scope="module")
def weights():
    """The reference's random parameters as a numpy tree."""
    jcfg, _ = _cfgs()
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _models(window=0):
    jcfg, pcfg = _cfgs(window=window)
    return jax_build_model(jcfg), build_model(pcfg, device="cpu")


def test_smoke_config_shape():
    _, cfg = _cfgs()
    assert (cfg.dtype, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.resolved_head_dim, cfg.qk_norm) == \
        ("float32", 2, 64, 4, 2, 16, True)


def test_param_specs_match_reference():
    jm, pm = _models()
    flat = lambda spec: {  # noqa: E731
        "/".join(map(str, (getattr(k, "key", k) for k in path))):
        (leaf.shape, leaf.axes, leaf.init, leaf.scale)
        for path, leaf in jax.tree_util.tree_flatten_with_path(
            spec, is_leaf=lambda x: hasattr(x, "axes"))[0]}
    port = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + [k])
            else:
                port["/".join(prefix + [k])] = (v.shape, v.axes, v.init,
                                                v.scale)

    walk(pm.param_specs(), [])
    assert port == flat(jm.param_specs())


def test_converted_weights_keep_every_leaf(weights):
    params = convert.params_from_reference(weights, device="cpu")
    jax_leaves = jax.tree_util.tree_flatten_with_path(weights)[0]
    back = convert.params_to_numpy(params)
    back_leaves = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in back_leaves] == [p for p, _ in jax_leaves]
    for (_, a), (_, b) in zip(jax_leaves, back_leaves):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_bf16_weights_convert_exactly():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)),
                    jnp.bfloat16)
    t = convert.params_from_reference({"w": np.asarray(x)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), np.asarray(x, np.float32))
    assert convert.params_to_numpy({"w": t})["w"].dtype == np.float32


def test_params_from_reference_refuses_cuda_without_card(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        convert.params_from_reference(weights)


@pytest.mark.parametrize("window", [0, 8])
def test_forward_logits_match(weights, window):
    jm, pm = _models(window)
    tokens = np.random.default_rng(1).integers(0, 512, (2, 24)).astype(
        np.int32)
    want, _ = jm.forward(weights, jnp.asarray(tokens))
    params = convert.params_from_reference(weights, device="cpu")
    got = make_prefill_step(pm)(params, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.float32 and got.shape == (2, 24, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window,max_seq", [(0, 12), (0, 32), (8, 32)])
def test_decode_steps_match(weights, window, max_seq):
    """20 one-token steps: with max_seq=12 the linear cache is full after
    12 and later writes clamp to its last slot; window=8 makes an 8-slot
    ring."""
    jm, pm = _models(window)
    tokens = np.random.default_rng(2).integers(0, 512, (3, 20)).astype(
        np.int32)
    step = jax.jit(jax_make_serve_step(jm))
    jcache = jm.init_cache(3, max_seq)
    params = convert.params_from_reference(weights, device="cpu")
    pstep = make_serve_step(pm)
    pcache = pm.init_cache(3, max_seq)
    for s in range(20):
        want, jcache = step(weights, jcache, jnp.asarray(tokens[:, s:s + 1]))
        got, pcache = pstep(params, pcache,
                            torch.from_numpy(tokens[:, s:s + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {s}")
    assert pcache["pos"] == int(jcache["pos"][0]) == 20


def test_engine_greedy_tokens_identical(weights):
    """16 prompts through 4 slots of a 32-token cache: the shared pos
    passes the cache's end, so later waves attend over a clamped cache."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, int(n)).astype(np.int32)
               for n in rng.integers(4, 10, 16)]
    jm, pm = _models()
    jeng = JaxServingEngine(jm, weights, JaxServeConfig(
        batch_slots=4, max_seq=32, max_new_tokens=8))
    peng = ServingEngine(pm, convert.params_from_reference(weights,
                                                           device="cpu"),
                         ServeConfig(batch_slots=4, max_seq=32,
                                     max_new_tokens=8))
    want = jeng.run(prompts)
    got = peng.run(prompts)
    assert peng.steps == jeng.steps > 32
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done and len(r.out_tokens) == 8 for r in got)
    assert peng.last_logits.shape == (4, 1, 512)


@pytest.mark.parametrize("name", ["rmsnorm", "apply_rope", "swiglu",
                                  "unembed", "softmax_xent"])
def test_layers_match_reference(name):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    if name == "rmsnorm":
        p = {"scale": rng.standard_normal(16).astype(np.float32)}
        args = (p, x)
    elif name == "apply_rope":
        args = (x, np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5)), 1e6)
    elif name == "swiglu":
        p = {k: rng.standard_normal(s).astype(np.float32) for k, s in
             (("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16)))}
        args = (p, x)
    elif name == "unembed":
        args = ({"embedding": rng.standard_normal((40, 16)).astype(
            np.float32)}, x)
    else:
        mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
        args = (x[:, :, 0], rng.integers(0, 16, (2, 5)).astype(np.int32),
                mask)

    def to(fn, a):
        if isinstance(a, dict):
            return {k: fn(v) for k, v in a.items()}
        return fn(a) if isinstance(a, np.ndarray) else a

    want = getattr(jax_layers, name)(*(to(jnp.asarray, a) for a in args))
    got = getattr(layers, name)(*(to(lambda v: torch.from_numpy(
        np.ascontiguousarray(v)), a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_init_keeps_the_reference_fan_in_rule():
    """std = scale / sqrt(prod(shape[:-1])), the stacked layers axis
    included; embeddings N(0, 0.02); norms ones."""
    spec = {"w": stack_layer_specs({"w": P((64, 8, 32), ("a", "b", "c"))},
                                   4)["w"],
            "e": P((256, 64), ("v", "d"), init="embed"),
            "n": P((64,), ("d",), init="ones")}
    t = init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    assert t["w"].shape == (4, 64, 8, 32)
    assert float(t["w"].std()) == pytest.approx((4 * 64 * 8) ** -0.5,
                                                rel=0.03)
    assert float(t["e"].std()) == pytest.approx(0.02, rel=0.03)
    assert torch.equal(t["n"], torch.ones(64))
    again = init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(t[k], again[k]) for k in t)


@pytest.mark.parametrize("arch,item", [("whisper_tiny", "A7"),
                                       ("hymba_1_5b", "A7"),
                                       ("xlstm_350m", "A7")])
def test_other_families_are_queued(arch, item):
    """Named for what it held until ROADMAP A7 ported these families (each
    raised naming A7): now each builds, full and smoke, and the smoke
    config's prefill logits match ``repro``'s on converted weights (their
    own files, ``tests/test_torch_{hybrid,xlstm,whisper}_parity.py``, hold
    the rest)."""
    full = build_model(get_arch(arch), device="cpu")
    assert full.cfg.family == jax_get_arch(arch).family
    jm = jax_build_model(jax_get_arch(arch).smoke_config())
    pm = build_model(get_arch(arch).smoke_config(), device="cpu")
    weights = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(12)
    batch = {"tokens": rng.integers(0, 512, (2, 20)).astype(np.int32)}
    if pm.cfg.family == "audio":
        batch["frames"] = (0.02 * rng.standard_normal(
            (2, pm.cfg.enc_frames, pm.cfg.d_model))).astype(np.float32)
    want = jax_make_prefill_step(jm)(weights, {k: jnp.asarray(v) for k, v
                                               in batch.items()})
    got = make_prefill_step(pm)(
        convert.params_from_reference(weights, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                               err_msg=f"{arch} ({item})")


@pytest.mark.parametrize("arch,moe,vlm", [("grok_1_314b", True, False),
                                          ("kimi_k2_1t_a32b", True, False),
                                          ("internvl2_2b", False, True)])
def test_moe_and_vlm_families_build(arch, moe, vlm):
    """Full configs build (nothing is allocated until ``init``), Kimi-K2's
    at its head_dim 112 too; ``test_kimi_head_dim_112_*`` below run it."""
    for cfg in (get_arch(arch), get_arch(arch).smoke_config()):
        model = build_model(cfg, device="cpu")
        assert (model.is_moe, model.is_vlm) == (moe, vlm)
        blocks = model.param_specs()["blocks"]
        assert ("moe" in blocks) == moe and ("mlp" in blocks) != moe
        assert ("mm_proj" in model.param_specs()) == vlm


# ---- the MoE and VLM families ------------------------------------------

FAMILY_ARCHS = ("grok_1_314b", "internvl2_2b")
# Kimi-K2's smoke config sets head_dim 16; its own is 112.
KIMI = "kimi_k2_1t_a32b"
KIMI_HEAD_DIM = 112


@pytest.fixture(scope="module")
def family_weights():
    """The reference's random smoke parameters of each family's model, as
    numpy trees."""
    return {arch: jax.tree.map(np.asarray, jax_build_model(
        jax_get_arch(arch).smoke_config()).init(jax.random.PRNGKey(0)))
        for arch in FAMILY_ARCHS}


def _family_models(arch):
    return (jax_build_model(jax_get_arch(arch).smoke_config()),
            build_model(get_arch(arch).smoke_config(), device="cpu"))


def _flat_specs(spec):
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + [k])
            else:
                out["/".join(prefix + [k])] = (v.shape, v.axes, v.init,
                                               v.scale)

    walk(spec, [])
    return out


@pytest.fixture(scope="module")
def kimi_weights():
    """The reference's random parameters of Kimi-K2's smoke config at head
    dim 112, as a numpy tree."""
    return jax.tree.map(np.asarray, jax_build_model(_kimi_cfgs()[0]).init(
        jax.random.PRNGKey(0)))


def _kimi_cfgs():
    return tuple(g(KIMI).smoke_config().scaled(head_dim=KIMI_HEAD_DIM)
                 for g in (jax_get_arch, get_arch))


def _kimi_models():
    jcfg, pcfg = _kimi_cfgs()
    return jax_build_model(jcfg), build_model(pcfg, device="cpu")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_param_specs_match_reference(arch):
    jm, pm = _family_models(arch)
    assert _flat_specs(pm.param_specs()) == _flat_specs(jm.param_specs())


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_weights_convert_with_every_leaf(family_weights, arch):
    weights = family_weights[arch]
    params = convert.params_from_reference(weights, device="cpu")
    want = jax.tree_util.tree_flatten_with_path(weights)[0]
    got = jax.tree_util.tree_flatten_with_path(
        convert.params_to_numpy(params))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_moe_forward_logits_and_aux_match(family_weights):
    weights = family_weights["grok_1_314b"]
    jm, pm = _family_models("grok_1_314b")
    tokens = np.random.default_rng(5).integers(0, 512, (2, 24)).astype(
        np.int32)
    want, want_aux = jm.forward(weights, jnp.asarray(tokens))
    got, aux = pm.forward(convert.params_from_reference(weights,
                                                        device="cpu"),
                          torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(aux) == set(want_aux) == {"moe_aux_loss", "moe_z_loss",
                                         "moe_dropped_frac"}
    for k, v in aux.items():
        np.testing.assert_allclose(float(v), float(want_aux[k]), **TOL,
                                   err_msg=k)


def test_moe_decode_steps_match(family_weights):
    weights = family_weights["grok_1_314b"]
    jm, pm = _family_models("grok_1_314b")
    tokens = np.random.default_rng(6).integers(0, 512, (3, 20)).astype(
        np.int32)
    step = jax.jit(jax_make_serve_step(jm))
    jcache = jm.init_cache(3, 32)
    params = convert.params_from_reference(weights, device="cpu")
    pstep = make_serve_step(pm)
    pcache = pm.init_cache(3, 32)
    for s in range(20):
        want, jcache = step(weights, jcache, jnp.asarray(tokens[:, s:s + 1]))
        got, pcache = pstep(params, pcache,
                            torch.from_numpy(tokens[:, s:s + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {s}")


def test_moe_engine_greedy_tokens_identical(family_weights):
    weights = family_weights["grok_1_314b"]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, int(n)).astype(np.int32)
               for n in rng.integers(4, 10, 10)]
    jm, pm = _family_models("grok_1_314b")
    jeng = JaxServingEngine(jm, weights, JaxServeConfig(
        batch_slots=4, max_seq=32, max_new_tokens=6))
    peng = ServingEngine(pm, convert.params_from_reference(weights,
                                                           device="cpu"),
                         ServeConfig(batch_slots=4, max_seq=32,
                                     max_new_tokens=6))
    want = jeng.run(prompts)
    got = peng.run(prompts)
    assert peng.steps == jeng.steps
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done and len(r.out_tokens) == 6 for r in got)


def test_kimi_head_dim_112_forward_and_aux_match(kimi_weights):
    """Kimi-K2's smoke config at its real head dim (7 x 16): the port's
    attention takes 112 on the CPU, and logits and MoE metrics match
    ``repro``'s."""
    jm, pm = _kimi_models()
    assert pm.cfg.resolved_head_dim == KIMI_HEAD_DIM and pm.is_moe
    tokens = np.random.default_rng(9).integers(0, 512, (2, 24)).astype(
        np.int32)
    want, want_aux = jm.forward(kimi_weights, jnp.asarray(tokens))
    got, aux = pm.forward(convert.params_from_reference(kimi_weights,
                                                        device="cpu"),
                          torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(aux) == set(want_aux)
    for k, v in aux.items():
        np.testing.assert_allclose(float(v), float(want_aux[k]), **TOL,
                                   err_msg=k)


def test_kimi_head_dim_112_decode_steps_match(kimi_weights):
    jm, pm = _kimi_models()
    tokens = np.random.default_rng(10).integers(0, 512, (3, 20)).astype(
        np.int32)
    step = jax.jit(jax_make_serve_step(jm))
    jcache = jm.init_cache(3, 32)
    params = convert.params_from_reference(kimi_weights, device="cpu")
    pstep = make_serve_step(pm)
    pcache = pm.init_cache(3, 32)
    for s in range(20):
        want, jcache = step(kimi_weights, jcache,
                            jnp.asarray(tokens[:, s:s + 1]))
        got, pcache = pstep(params, pcache,
                            torch.from_numpy(tokens[:, s:s + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {s}")


def test_kimi_head_dim_112_engine_greedy_tokens_identical(kimi_weights):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, int(n)).astype(np.int32)
               for n in rng.integers(4, 10, 10)]
    jm, pm = _kimi_models()
    jeng = JaxServingEngine(jm, kimi_weights, JaxServeConfig(
        batch_slots=4, max_seq=32, max_new_tokens=6))
    peng = ServingEngine(pm, convert.params_from_reference(kimi_weights,
                                                           device="cpu"),
                         ServeConfig(batch_slots=4, max_seq=32,
                                     max_new_tokens=6))
    want = jeng.run(prompts)
    got = peng.run(prompts)
    assert peng.steps == jeng.steps
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done and len(r.out_tokens) == 6 for r in got)


def test_vlm_forward_with_patches_matches(family_weights):
    """The projected patch embeddings replace the first n_patches
    positions, through ``make_prefill_step``'s batch as the extras."""
    weights = family_weights["internvl2_2b"]
    jm, pm = _family_models("internvl2_2b")
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, 512, (2, 24)).astype(np.int32)
    patches = (0.02 * rng.standard_normal(
        (2, pm.cfg.n_patches, pm.cfg.d_model))).astype(np.float32)
    want = jax_make_prefill_step(jm)(weights, {
        "tokens": jnp.asarray(tokens), "patch_embeds": jnp.asarray(patches)})
    got = make_prefill_step(pm)(
        convert.params_from_reference(weights, device="cpu"),
        {"tokens": torch.from_numpy(tokens),
         "patch_embeds": torch.from_numpy(patches)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = make_prefill_step(pm)(
        convert.params_from_reference(weights, device="cpu"),
        {"tokens": torch.from_numpy(tokens),
         "patch_embeds": torch.zeros_like(torch.from_numpy(patches))})
    assert not torch.allclose(got, plain)


def test_launcher_serves_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--requests", "4", "--slots", "2",
                "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert "served 4 requests, 12 tokens" in out and "cpu" in out


def test_launcher_refuses_cuda_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve.main(["--requests", "2"])


def test_serve_config_takes_greedy_and_seed_in_both_packages():
    """``greedy`` and ``seed`` are fields of both packages' ``ServeConfig``
    with the same defaults (both select nothing: decoding is greedy)."""
    kw = dict(batch_slots=8, greedy=True, seed=0)
    ref, port = JaxServeConfig(**kw), ServeConfig(**kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(ServeConfig()) == \
        dataclasses.asdict(JaxServeConfig())
