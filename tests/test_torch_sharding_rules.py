"""``repro_torch.sharding.rules`` against ``repro.sharding.rules``: the
reference's eleven cases, every parameter and optimizer-state leaf of
every registered arch at full width, the constrainers' choice of spec,
and the DTensor layout each rank of a gloo group holds against the slice
JAX's ``NamedSharding`` puts on the device at the same mesh position."""

import json

import jax
import numpy as np
import pytest
import torch

from _torch_dist import layout_worker, run_jax, run_ranks
from repro.configs.base import ARCH_IDS
from repro.configs.base import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.sharding import rules as jax_rules
from repro.train import optimizer as jax_opt
from repro.train.step import abstract_state as jax_abstract_state
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.models import build_model
from repro_torch.sharding import rules
from repro_torch.sharding.rules import NamedSharding, PartitionSpec
from repro_torch.train import optimizer
from repro_torch.train.step import abstract_state, state_logical_axes


class StubMesh:
    """Axis names and sizes, in both packages' spellings."""

    def __init__(self, shape, names):
        self.axis_names = self.mesh_dim_names = names
        self.devices = np.empty(shape)
        self.shape = shape


MESH = StubMesh((16, 16), ("data", "model"))
POD_MESH = StubMesh((2, 16, 16), ("pod", "data", "model"))
PROFILES = ("tp", "fsdp_tp")


def _both(axes, shape, mesh, profile):
    got = rules.spec_for(axes, shape, mesh, rules.rules_for_profile(profile))
    want = jax_rules.spec_for(axes, shape, mesh,
                              jax_rules.rules_for_profile(profile))
    assert isinstance(got, PartitionSpec)
    assert tuple(got) == tuple(want), (axes, shape, got, want)
    return got


# The reference's cases (tests/test_sharding_rules.py), with its expected
# specs, through the port and the reference both.
REFERENCE_CASES = {
    "embedding_vocab_sharded": (("vocab", "d_model"), (151936, 2560), MESH,
                                "tp", ("model", None)),
    "embedding_fsdp_both_axes": (("vocab", "d_model"), (151936, 5120), MESH,
                                 "fsdp_tp", ("model", "data")),
    "heads_sharded_when_divisible": (("d_model", "heads", "head_dim"),
                                     (2560, 32, 128), MESH, "tp",
                                     (None, "model", None)),
    "nondivisible_heads_fall_back": (("d_model", "heads", "head_dim"),
                                     (1600, 25, 64), MESH, "tp",
                                     (None, None, "model")),
    "batch_over_pod_and_data": (("batch", "seq"), (256, 4096), POD_MESH,
                                "tp", (("pod", "data"), None)),
    "batch_fallback_to_data_only": (("batch", "d_model"), (8, 64), POD_MESH,
                                    "tp", (None, None)),
    "kv_cache_prefers_heads": (("layers", "batch", "kv_seq", "kv_heads",
                                "head_dim"), (24, 128, 32768, 32, 64), MESH,
                               "tp", (None, "data", None, "model", None)),
    "kv_cache_falls_back_to_seq": (("layers", "batch", "kv_seq", "kv_heads",
                                    "head_dim"), (60, 128, 32768, 8, 128),
                                   MESH, "tp",
                                   (None, "data", "model", None, None)),
    "experts_shard_model": (("experts", "d_model", "d_ff"), (384, 7168, 2048),
                            MESH, "fsdp_tp", ("model", "data", None)),
    "experts_nondivisible_dff_takes_model": (
        ("experts", "d_model", "d_ff"), (8, 6144, 32768), MESH, "fsdp_tp",
        (None, "data", "model")),
    "no_axis_used_twice": (("heads", "d_ff"), (32, 9728), MESH, "tp",
                           ("model", None)),
    "scalar_spec": ((), (), MESH, "tp", ()),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_cases(case):
    axes, shape, mesh, profile, want = REFERENCE_CASES[case]
    assert tuple(_both(axes, shape, mesh, profile)) == want


def _leaves(tree, axes, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], axes[k], path + (k,))
    else:
        yield path, tree, axes


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_state_leaf_of_every_arch(arch):
    """``spec_for`` of every parameter and optimizer-state leaf (all
    three state dtypes) at full width, on a (16,16) and a (2,16,16) stub
    mesh under both profiles, equal to the reference's; and
    ``tree_shardings`` gives the same specs as NamedShardings."""
    model = build_model(get_arch(arch), device="cpu")
    jmodel = jax_build_model(jax_get_arch(arch))
    n = 0
    for state_dtype in optimizer.STATE_DTYPES:
        cfg = optimizer.OptimizerConfig(state_dtype=state_dtype)
        jcfg = jax_opt.OptimizerConfig(state_dtype=state_dtype)
        state = abstract_state(model, cfg)
        axes = state_logical_axes(model, cfg)
        jstate = jax_abstract_state(jmodel, jcfg)
        for mesh in (MESH, POD_MESH):
            for profile in PROFILES:
                shardings = rules.tree_shardings(state, axes, mesh, profile)
                jsh = jax_rules.rules_for_profile(profile)
                for path, leaf, ax in _leaves(state, axes):
                    want = jax_rules.spec_for(ax, leaf.shape, mesh, jsh)
                    got = shardings
                    for k in path:
                        got = got[k]
                    assert tuple(got.spec) == tuple(want), (path, got, want)
                    n += 1
        # the reference's trees hold the same leaves
        jleaves = jax.tree_util.tree_flatten_with_path(jstate)[0]
        assert len(jleaves) == len(list(_leaves(state, axes)))
    assert n > 0


@pytest.mark.parametrize("mesh", [MESH, POD_MESH,
                                  StubMesh((4, 1), ("data", "model")),
                                  StubMesh((1, 8), ("data", "model"))],
                         ids=["16x16", "2x16x16", "4x1", "1x8"])
def test_constrainers_choose_the_reference_spec(mesh, monkeypatch):
    """The spec each constrainer picks, at the shapes its checks gate
    (divisible or not by the batch and model axes), against the spec the
    reference's constrainer passes to ``with_sharding_constraint`` (or
    its leaving the tensor alone).  The reference runs on a stub mesh,
    its ``NamedSharding`` and ``with_sharding_constraint`` replaced by a
    recorder of the spec."""
    seen = []

    def capture(x, spec):
        seen.append(tuple(spec))
        return x

    monkeypatch.setattr(jax_rules, "NamedSharding", lambda m, spec: spec)
    monkeypatch.setattr(jax_rules.jax.lax, "with_sharding_constraint",
                        capture)
    jact = jax_rules.make_act_constrainer(mesh)
    jq, jkv = jax_rules.make_attn_constrainers(mesh)
    jmoe = jax_rules.make_moe_constrainer(mesh)
    sizes = rules.mesh_sizes(mesh)
    cases = [
        (jact, lambda s: rules.act_spec(s, sizes),
         [(32, 64, 8), (3, 64, 8), (32, 7, 8), (3, 7, 8), (4, 4),
          (32, 16, 4, 8)]),
        (jq, lambda s: rules.attn_spec(s, sizes, True, True),
         [(32, 64, 16, 8), (32, 64, 25, 8), (3, 7, 25, 8),
          (32, 64, 8, 128), (32, 64, 8)]),
        (jkv, lambda s: rules.attn_spec(s, sizes, True, False),
         [(32, 64, 16, 8), (32, 64, 25, 8), (3, 7, 25, 8),
          (32, 64, 8, 128)]),
        (jmoe, lambda s: rules.moe_buffer_spec(s, sizes),
         [(32, 16, 10, 64), (32, 8, 10, 64), (3, 8, 10, 7),
          (32, 384, 4, 7168), (8, 64)]),
    ]
    n_sharded = 0
    for jfn, choose, shapes in cases:
        for shape in shapes:
            seen.clear()
            jfn(np.zeros(shape, np.float32))
            want = seen[0] if seen else None
            got = choose(shape)
            assert (tuple(got) if got is not None else None) == want, \
                (shape, got, want)
            n_sharded += want is not None
    assert n_sharded > 0


def test_constrainers_leave_plain_tensors_alone():
    mesh = MESH
    x = torch.zeros(32, 64, 8)
    for fn in (rules.make_act_constrainer(mesh),
               *rules.make_attn_constrainers(mesh),
               rules.make_moe_constrainer(mesh)):
        assert fn(x) is x


def test_named_sharding_placements_and_refusals():
    from torch.distributed.tensor import Replicate, Shard
    mesh = POD_MESH
    sh = NamedSharding(mesh, PartitionSpec(("pod", "data"), None, "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert NamedSharding(mesh, PartitionSpec()).placements == \
        (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        NamedSharding(mesh, PartitionSpec(("data", "pod")))
    with pytest.raises(ValueError, match="not in the mesh"):
        NamedSharding(mesh, PartitionSpec("stage"))
    assert tuple(rules.shard_batch_spec(POD_MESH, 3).spec) == \
        (("pod", "data"), None, None)
    assert tuple(rules.shard_batch_spec(MESH, 2).spec) == ("data", None)


# Specs over a (2, 4) ("data", "model") mesh, a dim over both axes among
# them, and a tensor whose dims each divide every split.
LAYOUT_SHAPE = (8, 12, 16)
LAYOUT_SPECS = [("data", "model", None), ("model", None, "data"),
                (("data", "model"), None, None), (None, None, ("data",
                                                               "model")),
                (None, "model", None), (), (None, None, None)]


def test_dtensor_layout_matches_jax_named_sharding(tmp_path):
    """Each of 8 gloo ranks' local DTensor slice equals the slice that
    JAX's ``NamedSharding(...).devices_indices_map`` gives the device at
    the same position of the (2, 4) mesh (device id == rank)."""
    out = run_jax(f"""
        import json
        import jax, numpy as np
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        mesh = Mesh(np.array(jax.devices()).reshape(2, 4),
                    ("data", "model"))
        res = []
        for spec in {LAYOUT_SPECS!r}:
            m = NamedSharding(mesh, P(*spec)).devices_indices_map(
                {LAYOUT_SHAPE!r})
            res.append({{str(d.id): [[s.start, s.stop] for s in idx]
                         for d, idx in m.items()}})
        print(json.dumps(res))
    """)
    want = json.loads(out.strip().splitlines()[-1])
    got = run_ranks(tmp_path, 8, layout_worker, (2, 4), LAYOUT_SHAPE,
                    LAYOUT_SPECS)
    full = np.arange(np.prod(LAYOUT_SHAPE)).reshape(LAYOUT_SHAPE)
    for i, spec in enumerate(LAYOUT_SPECS):
        for rank in range(8):
            idx = tuple(slice(a, b) for a, b in want[i][str(rank)])
            np.testing.assert_array_equal(got[rank][str(i)], full[idx],
                                          err_msg=f"{spec} rank {rank}")


@pytest.mark.parametrize("arch", ["grok_1_314b", "hymba_1_5b", "xlstm_350m",
                                  "whisper_tiny"])
def test_model_hooks_see_the_reference_layouts(arch):
    """The models' ``constrain_*`` hooks at the reference's call sites:
    the residual stream (B, S, d) once on entry and after each layer, q
    (B, S, H, D) and the unexpanded k and v (B, S, K, D) in each attention
    layer, and the MoE buffers in the reference's (B, E, C, X) layout,
    four a chunk and layer; with the real constrainers (a plain tensor
    passes through) the logits are the hook-free ones."""
    cfg = get_arch(arch).smoke_config()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = model.make_batch(torch.Generator().manual_seed(1),
                             _prefill_shape(cfg))
    want, _ = model.forward(params, batch["tokens"], batch)
    seen = {}

    def record(name):
        def hook(x):
            seen.setdefault(name, []).append(tuple(x.shape))
            return x
        return hook

    hooks = [h for h in ("constrain_act", "constrain_q", "constrain_kv",
                         "constrain_moe") if hasattr(model, h)]
    for h in hooks:
        setattr(model, h, record(h))
    got, _ = model.forward(params, batch["tokens"], batch)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    B, S = batch["tokens"].shape
    L = cfg.n_layers // 2 if arch == "xlstm_350m" else cfg.n_layers
    assert seen["constrain_act"] == [(B, S, cfg.d_model)] * (L + 1)
    if arch in ("grok_1_314b", "hymba_1_5b"):
        H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        assert seen["constrain_q"] == [(B, S, H, D)] * L
        assert seen["constrain_kv"] == [(B, S, K, D)] * (2 * L)
    else:
        assert "constrain_q" not in seen
    if arch == "grok_1_314b":
        moe = seen["constrain_moe"]
        assert len(moe) == 4 * L and all(len(s) == 4 and s[:2] ==
                                         (B, cfg.n_experts) for s in moe)
        assert {s[3] for s in moe} == {cfg.d_model, cfg.d_ff}
    mesh = StubMesh((1, 2), ("data", "model"))
    model.constrain_act = rules.make_act_constrainer(mesh)
    model.constrain_q, model.constrain_kv = \
        rules.make_attn_constrainers(mesh)
    if hasattr(model, "constrain_moe"):
        model.constrain_moe = rules.make_moe_constrainer(mesh)
    got, _ = model.forward(params, batch["tokens"], batch)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _prefill_shape(cfg):
    return ShapeConfig(name="prefill", kind="prefill", seq_len=16,
                       global_batch=2)
